"""Trial builds of the fold (K7), the one-hot merges (K11) and the kernel
benchmark's bf16_native, given_kron and weight_sums deposits (K13), timed
beside the package's own build: ``python -m pinc_tpu_torch.kernel_trials
DIR [DIR ...]``.

Each DIR holds edited copies of ``csrc`` sources (``field.cu``,
``onehot_exchange.cu`` and/or ``kbench.cu``; a header it does not hold is
taken from the package's ``csrc``).  Each is compiled with the package's
nvcc flags into a library of its own (under the git-ignored
``_build/trials/``), and its ``pinc_field_fold``, ``pinc_ox_merge`` and
``pinc_kb_deposit`` (and ``pinc_ox_merge_ranked``,
``pinc_ox_extract_ranked``) run in one process
beside the package's build, on the same inputs, for each source some DIR
holds (all three without a DIR):

* K7 at 128^3, T = 8, M = 1 and 2, on normal tiles;
* the merge calls of one electron exchange of the one-hot decks (4096
  tiles, 6144 particles a tile, velocities N(0, 0.1) moved by one 4-step
  cadence): B = 7680 takes the fused row exchange (``merge_kernel<8>``),
  B = 6528 the per-tile sweeps (``merge_kernel<1>``); the ranked extract
  and merge (``extract_ranked_kernel``, ``merge_ranked_kernel``) on
  ``chip_smoke.py``'s ranked case at B = 6524 (``ranked_case``: K = 256,
  the merge with ``active``);
* bf16_native (at vmax = 1), given_kron and weight_sums at the kernel
  benchmark's K13 shape (4096 tiles, B = 9216, 90% live, M = 1, a random
  bf16 plane).

The fold, the merges and the ranked extract are compared with the
plain version bit for bit, the
deposits within ``kbench.DEPOSIT_RTOL`` of max|plain| (a trial that
leaves work out is reported as differing, not refused); each is timed in
a CUDA graph (the merges write in place: ``kbench.graph_ms_inplace``),
the fold and the deposits also by CUDA events.  ptxas's registers and
spills are printed for each trial's fold, merge and deposit kernels.  It
raises without a card.  ``PERF.md`` names the edits of the trials it
quotes.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from . import kbench
from .ops import _cuda_build, exchange as ex, field_kernels as fk
from .ops import kbench_kernels as kb
from .ops import onehot_exchange as ox, tiled_kernels as tk
from .ops.tiled import TileSpec, bucket

SOURCES = ("field.cu", "onehot_exchange.cu", "kbench.cu")
#: the kernels whose ptxas lines a trial prints
KERNELS = ("fold_kernel", "merge_kernel", "merge_ranked", "extract_ranked",
           "given_kron", "weight_sums", "deposit_variant")
ONEHOT_B = {"rows": 7680, "tile": 6528}


def build(src_dir: Path, name: str):
    """(library, ptxas lines of the KERNELS) of a trial."""
    out_dir = _cuda_build.BUILD_DIR / "trials"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}.so"
    srcs = [str(src_dir / f) for f in SOURCES if (src_dir / f).exists()]
    if not srcs:
        raise ValueError(f"{src_dir} holds none of {SOURCES}")
    cmd = [_cuda_build.nvcc_path(), "--ptxas-options=-v",
           *_cuda_build.NVCC_FLAGS, "-shared", "-I", str(src_dir),
           "-I", str(_cuda_build.CSRC), "-o", str(out), *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src_dir}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    regs = [f"{lines[i].split('for ')[-1][:70]}: {lines[i + 2].strip()}"
            for i in range(len(lines) - 2)
            if "Function properties" in lines[i]
            and any(k in lines[i] for k in KERNELS)]
    lib = ctypes.CDLL(str(out))
    for fn, args in _cuda_build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib, regs


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _species(ts: TileSpec, gen, dev):
    """A bucketed electron species of the one-hot decks, moved by one
    4-step drift: (alive, 6 planes)."""
    n = 12 * 8 ** 3 * ts.NT
    pos = torch.rand((n, 3), generator=gen, device=dev) * ts.grid[0]
    vel = torch.randn((n, 3), generator=gen, device=dev) * 0.1
    lp, lv, la, dropped = bucket(pos, vel, torch.ones(n, dtype=torch.bool,
                                                      device=dev), ts)
    if int(dropped):
        raise RuntimeError("bucketing the trial state dropped particles")
    xyz = lp.permute(2, 0, 1).contiguous()
    v = lv.permute(2, 0, 1).contiguous()
    alive = la.float()
    _, moved, _ = tk.deposit_move(xyz, v * 4.0, alive, -1.0 / 12, ts,
                                  mxu_dtype=torch.bfloat16)
    return alive, tuple(moved) + tuple(v)


def _merge_calls(route: str, gen, dev) -> list:
    """The (alive, inc, planes, blocks) of each merge call of one
    exchange on the route's deck."""
    ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=ONEHOT_B[route])
    alive, planes = _species(ts, gen, dev)
    name = "merge_all_rows" if route == "rows" else "merge_fused"
    orig, calls = getattr(ox, name), []

    def spy(a, inc, pl, arg):
        blocks = arg if route == "rows" else ((0, arg), (arg, arg))
        calls.append((a.clone(), inc.clone(), tuple(p.clone() for p in pl),
                      tuple(blocks)))
        return orig(a, inc, pl, arg)
    setattr(ox, name, spy)
    try:
        ex.rebucket_exchange_planes(planes, alive, ts.ntiles, ts.T, K=256,
                                    rows=route == "rows")
    finally:
        setattr(ox, name, orig)
    return calls


def ranked_case(alive, planes, T: int, K: int):
    """K11's ranked modes on one z sweep of (alive, planes): the extract's
    ranks as pinc_tpu's exchange_dim computes them at face cap K (a
    leaver past the cap ranked 2K: killed, not copied), its buffer and
    alive (by ``ox.extract``), and the merge's free ranks and ``active``
    flags on that output: the arrivals are the leavers themselves, placed
    into the slots they left and the others free.  Returns (rank, buf,
    alive2, frank, active)."""
    al = alive > 0.5
    lm, lp = al & (planes[2] < 0), al & (planes[2] >= T)
    rm = torch.cumsum(lm, 1, dtype=torch.int32) - 1
    rp = torch.cumsum(lp, 1, dtype=torch.int32) - 1
    none = torch.full_like(rm, -1)
    rank = torch.where(lm & (rm < K), rm,
                       torch.where(lp & (rp < K), K + rp, none))
    rank = torch.where((lm & (rm >= K)) | (lp & (rp >= K)),
                       torch.full_like(rm, 2 * K), rank)
    del al, lm, lp, rm, rp, none
    buf, alive2 = ox.extract(rank, alive, planes, 2 * K)
    free = alive2 <= 0.5
    fr_incl = torch.cumsum(free, 1, dtype=torch.int32)
    frank = torch.where(free, fr_incl - 1, torch.full_like(fr_incl, -1))
    CB = ox._chunk(alive.shape[1])
    ends = fr_incl[:, CB - 1::CB]
    base = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    act = ((base < buf[:, 6].sum((-2, -1))[:, None]) & (ends > base)).to(
        torch.int32)
    return rank, buf, alive2, frank, act


def _ranked_trials(libs: dict, gen, dev) -> None:
    """The ranked extract and merge of each library on
    check_ranked_bench's inputs (chip_smoke.py: 4096 tiles x 6524 slots,
    K = 256, the merge with active)."""
    ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=6524)
    alive, planes = _species(ts, gen, dev)
    rank, buf, alive2, frank, act = ranked_case(alive, planes, ts.T, 256)
    K2 = buf.shape[-1]
    pbuf, palive2 = ox.extract_plain(rank, alive, planes, K2)
    for name, lib in libs.items():
        if not hasattr(lib, "pinc_ox_extract_ranked"):
            continue
        out = torch.empty_like(buf)
        out2 = torch.empty_like(alive2)

        def call(lib=lib, out=out, out2=out2):
            if lib.pinc_ox_extract_ranked(
                    _ptr(rank), _ptr(alive), *[_ptr(p) for p in planes],
                    _ptr(out), _ptr(out2), ts.NT, ts.B, K2, _stream()):
                raise RuntimeError(f"{name}: ranked extract launch failed")
        call()
        ok = _same_bits(out, pbuf) and _same_bits(out2, palive2)
        print(f"extract ranked {name}: graph "
              f"{kbench.graph_ms(call, 20):.4f} ms, events "
              f"{kbench.cuda_ms(call, 20):.4f} ms, bit-equal {ok}",
              flush=True)
        del out, out2
    del alive, rank, pbuf, palive2
    wp, wa = ox.merge_plain(frank, alive2.clone(), buf,
                            tuple(p.clone() for p in planes), active=act)
    for name, lib in libs.items():
        if not hasattr(lib, "pinc_ox_merge_ranked"):
            continue

        def call(a, *pl, lib=lib):
            if lib.pinc_ox_merge_ranked(
                    _ptr(frank), _ptr(a), _ptr(buf), _ptr(act),
                    *[_ptr(p) for p in pl], ts.NT, ts.B, buf.shape[-1],
                    ox._chunk(ts.B), act.shape[1], _stream()):
                raise RuntimeError(f"{name}: ranked merge launch failed")
        got = [alive2.clone()] + [p.clone() for p in planes]
        call(*got)
        ok = _same_bits(got[0], wa) and all(map(_same_bits, got[1:], wp))
        print(f"merge ranked {name}: graph "
              f"{kbench.graph_ms_inplace(call, (alive2, *planes)):.4f} ms, "
              f"bit-equal {ok}", flush=True)
    torch.cuda.empty_cache()


def _deposit_trials(libs: dict, gen, dev) -> None:
    """bf16_native, given_kron and weight_sums of each library at the K13
    shape."""
    ts = TileSpec(grid=kbench.K13["grid"], T=kbench.K13["T"],
                  M=kbench.K13["M"], B=kbench.K13["B"])
    xyz, val, _, kron = kbench._k13_inputs(ts, kbench.K13["live"], gen, dev)
    for mode in ("bf16_native", "given_kron", "weight_sums"):
        # bf16_native's grid at vmax = 1, as the kernel benchmark's
        k, j = (tk.deposit_scale((1.0,), ts.B) if mode == "bf16_native"
                else kb.weight_sums_scale(ts.B))
        want = kb.deposit_variant_plain(xyz, val, ts, mode, kron=kron)
        tol = kbench.DEPOSIT_RTOL * want.abs().max().item()
        for name, lib in libs.items():
            if not hasattr(lib, "pinc_kb_deposit"):
                continue
            out = torch.empty_like(want)

            def call(lib=lib, out=out, mode=mode):
                if lib.pinc_kb_deposit(
                        _ptr(xyz), _ptr(val), _ptr(kron), _ptr(out), ts.NT,
                        ts.B, ts.P, ts.M, kb.DEPOSIT_MODES.index(mode),
                        kb.INV_127SQ, _stream(), k, j):
                    raise RuntimeError(f"{name}: {mode} launch failed")
            call()
            err = (out - want).abs().max().item()
            print(f"{mode} {name}: graph {kbench.graph_ms(call, 20):.4f} "
                  f"ms, events {kbench.cuda_ms(call, 20):.4f} ms, max err "
                  f"{err:.3e} (tol {tol:.3e}, "
                  f"{'ok' if err <= tol else 'DIFFERS'})", flush=True)
        del want
    torch.cuda.empty_cache()


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main(argv=None) -> int:
    dirs = [Path(d) for d in (sys.argv[1:] if argv is None else argv)]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trials needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(kbench.card_line(), flush=True)
    libs = {"package": _cuda_build.load()}
    for d in dirs:
        libs[d.name], regs = build(d, d.name)
        for r in regs:
            print(f"  {d.name} {r}", flush=True)
    held = {f for d in dirs for f in SOURCES if (d / f).exists()}
    if not dirs:
        held = set(SOURCES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    if "kbench.cu" in held:
        _deposit_trials(libs, gen, dev)
    for M in (1, 2) if "field.cu" in held else ():
        ts = TileSpec(grid=(128, 128, 128), T=8, M=M, B=17408)
        tiles = torch.randn((ts.NT, ts.P, ts.P * ts.P), generator=gen,
                            device=dev)
        want = fk.fold_global_plain(tiles, ts)
        for name, lib in libs.items():
            if not hasattr(lib, "pinc_field_fold"):
                continue
            rho = torch.empty(ts.grid, device=dev)

            def call(lib=lib, rho=rho):
                if lib.pinc_field_fold(_ptr(tiles), _ptr(rho), *ts.grid, 8,
                                       M, _stream()):
                    raise RuntimeError(f"{name}: fold launch failed")
            call()
            ok = _same_bits(rho, want)
            print(f"fold M={M} {name}: graph {kbench.graph_ms(call, 20):.4f}"
                  f" ms, events {kbench.cuda_ms(call, 20):.4f} ms, "
                  f"bit-equal {ok}", flush=True)
        del tiles, want
    if "onehot_exchange.cu" in held:
        _ranked_trials(libs, gen, dev)
    for route in ("rows", "tile") if "onehot_exchange.cu" in held else ():
        calls = _merge_calls(route, gen, dev)
        for name, lib in libs.items():
            if not hasattr(lib, "pinc_ox_merge"):
                continue
            graph = 0.0
            ok = True
            for alive, inc, planes, blocks in calls:
                R, KT = inc.shape[2], inc.shape[3]
                table = (ctypes.c_int * 16)(*[v for b in blocks for v in b])

                def call(a, inc, *pl, lib=lib, table=table, n=len(blocks)):
                    if lib.pinc_ox_merge(_ptr(a), _ptr(inc),
                                         *[_ptr(p) for p in pl], table, n,
                                         a.shape[0], a.shape[1], R, KT,
                                         _stream()):
                        raise RuntimeError(f"{name}: merge launch failed")
                got = [alive.clone(), inc] + [p.clone() for p in planes]
                call(*got)
                wp, wa = ox._merge_plain(alive.clone(), inc,
                                         tuple(p.clone() for p in planes),
                                         blocks)
                ok &= _same_bits(got[0], wa) and all(
                    map(_same_bits, got[2:], wp))
                graph += kbench.graph_ms_inplace(call, (alive, inc, *planes))
            n = len(calls)
            print(f"merge {route} {name}: graph {graph / n:.4f} ms, "
                  f"bit-equal {ok} (mean of {n} call(s))", flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
