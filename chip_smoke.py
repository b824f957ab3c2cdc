#!/usr/bin/env python3
"""Smoke run of pinc_tpu_torch on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Builds the CUDA kernels from pinc_tpu_torch/csrc with nvcc (one nvcc
   per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card and
   times both by CUDA events: deposit, deposit_move, gather, gather_kick at
   the test fixture's size and at the bench deck's production shape (128^3
   grid: 4096 tiles of 8^3 cells, margin 1, 17,408 slots), with f32 and
   bf16 weights; pic_step at the fixture (f32/bf16, CIC/NGP, leapfrog,
   Boris, e_ext, and tests/test_margin_schedule.py's margin sets at M = 2)
   and at the production shape at M = 1 and M = 2; efield_tiles and
   fold_global at M = 1, 2 and a T <= 2M+1 layout, and at 128^3 (bit for
   bit); the exchange kernels extract, cleanup and merge at the fixture
   size (with forced overflow, spill and drops) and at the production
   shape, on the calls one whole exchange makes on a bucketed state moved
   by one K2 drift of bench-like velocities (bit for bit).  It also times
   one whole exchange re-bucket per species, and the electrons' through
   the one-hot exchange (tiles:exchangeImpl=onehot) in turns with the
   gather.  The one-hot exchange kernels (K11: extract, cleanup and merge
   in each of their modes) are held bit pattern for bit pattern against
   their plain versions at the fixture (leaver caps, edge caps and free
   slots overflowing; B % 8 != 0 for the ranked modes; the drivers against
   the CPU) and on the calls of one exchange at the one-hot decks'
   production shapes (4096 tiles, B = 7680 for the fused row exchange, B =
   6528 for the per-tile sweeps), each timed with its bound, then the
   whole exchange.
3. Runs the CLI entry point, pinc_tpu_torch.__main__.main, on bench.py's
   deck (128^3, 2 x 67,108,864 particles, sSolve, puAcc3D1KE, puDistr3D1,
   tiles 8 / bf16 / slack 1.0625) with methods:layout=tiled: 20 steps with
   the default re-bucket (the gather exchange), then 10 steps with
   tiles:rebucket=sort; then 20 steps on each one-hot deck (the headline
   deck of phase 5 at 12 per cell, 2 x 25,165,824 particles: the default
   slack gives B = 7680 and the fused one-hot row exchange, slack 1.0625
   B = 6528 and, the row gate false, the per-tile one-hot sweeps).  For
   each run it checks that every exchange kernel of its path ran and no
   other (the launch counts are set to 0 just before the run and read just
   after), that the state stayed on the card, that no particle was
   dropped, and that the energies are finite and conserved; particles
   reaching the margin (re-bucketed early) are allowed on the one-hot
   decks only.
4. Times each part of one step of the exchange run (the two kernel pairs,
   the K7 fold, FFT solve, gradient, E padding, state stacking, and each
   species' exchange and sort re-bucket of a state moved by one cadence)
   with CUDA events, and the device time of one electron exchange by
   operation with torch.profiler.
5. Runs the window bench.py times, TiledSimulation.make_scan_steps(n,
   donate=True, fresh=True) (the mega-fused scan: K5 pic_step, K7, FFT,
   K6 a step), on three decks: bench.py's headline deck (vth 0.1/0.0023:
   margin 2, the per-step margin schedule, the window sized to the slow
   cadence), its margin-1 aux deck (phase 3's deck with
   tiles:rebucketEvery = 10, a 40-step window) and the fused one-hot
   deck of phase 3.  Per deck one untimed
   window, then a timed one, each checked as phase 3's runs (launches,
   state on the card, drops, alive count, energy); then a CUDA-event split
   of one mega step and each species' exchange.

Every phase that fails exits non-zero.  Without a CUDA card the script
exits non-zero before printing any result.  The line before the last is a
JSON object with each kernel's numbers (launches on the path that runs
it: phase 3's exchange run, its one-hot runs for the one-hot kernels (the
row kernels the B = 7680 run, the per-tile ones the B = 6528 run), or for
pic_step, efield_tiles and fold_global the headline scan window of phase
5; max error against the plain version;
kernel and plain ms; and bound_ms: the bytes the call must move at 3.35
TB/s, from this run's inputs); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# tolerances, kernel vs plain version on the same inputs (sums are taken in
# another order, with atomics in the deposits); the exchange kernels copy
# bits and add +-T in f32 like their plain versions, so their buffers,
# planes, alive and drop counts must be bit-equal
DEPOSIT_RTOL = 1e-5    # max |tiles - plain| <= 1e-5 * max |plain|
FIELD_ATOL = 1e-5      # gathered fields and kicked velocities, absolute
VDOT_RTOL = 1e-5       # the kick's sum of alive * vdot
ENERGY_DRIFT = 0.01    # |E_tot(end) - E_tot(0)| / |E_tot(0)| on the main path
MAIN_STEPS = 20        # two electron re-bucket events (cadence 10) on the
                       # bench deck, five (cadence 4) on the one-hot decks
SORT_STEPS = 10        # one electron event with tiles:rebucket=sort
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
SCAN_STEPS = 40        # bench.py:281, then sized to the slow cadence (:97-101)
HEADLINE_VTH = "0.1,0.0023"   # bench.py:294-295, the Debye-resolved deck
AUX_REBUCKET = 10      # bench.py:307-308, the margin-1 aux deck
# the one-hot decks: the headline deck at 12 particles per cell per species
# (B % 1024 != 0); the default slack 1.25 gives B = 7680 with the row gate
# true (the fused row exchange, v5), slack 1.0625 B = 6528 with the gate
# false (the per-tile sweeps, v3)
ONEHOT_PC = 12
ONEHOT_SLACK = {"onehot_rows": None, "onehot_tile": 1.0625}
ONEHOT_B = {"onehot_rows": 7680, "onehot_tile": 6528}

# exchange kernel launches per species event, by route
ROUTE_CALLS = {
    "sort": {},
    "gather": {"extract": 1, "cleanup": 3, "merge": 1},
    "onehot_rows": {"onehot_extract_rows": 1, "onehot_cleanup": 2,
                    "onehot_merge_rows": 1},
    "onehot_tile": {"onehot_extract_tile": 3, "onehot_merge_tile": 3},
}
EXCHANGE_KERNELS = sorted({k for v in ROUTE_CALLS.values() for k in v})

BENCH_DECK = """
[time]
nTimeSteps = 20
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 128,128,128
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 32 pc
nAlloc = 32 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.02,0.0005
drift = 0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[tiles]
tileSize = 8
mxuDtype = bf16
slack = 1.0625
"""


def fail(text: str) -> None:
    print(f"FAIL: {text}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(ok: bool, text: str) -> None:
    if not ok:
        fail(text)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / reps


def cuda_ms_fresh(setup, fn, reps: int) -> float:
    """Mean device time of fn(*setup()) over reps calls, each on fresh
    arguments (for calls that update their inputs in place); setup is not
    timed."""
    import torch
    fn(*setup())
    total = 0.0
    for _ in range(reps):
        args = setup()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += begin.elapsed_time(end)
        del args
    return total / reps


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def inputs(ts, gen, dev, vth: float, live: float):
    """Slots in the layout of the main path: live slots anywhere in the
    wander envelope [-M, T+M), dead ones parked at -2M-2, a random field."""
    import torch
    NT, B, P = ts.NT, ts.B, ts.P
    alive = (torch.rand((NT, B), generator=gen, device=dev) < live).float()
    xyz = (torch.rand((3, NT, B), generator=gen, device=dev)
           * (ts.T + 2 * ts.M) - ts.M)
    xyz = torch.where(alive.bool(), xyz,
                      torch.full((), -2.0 * ts.M - 2.0, device=dev))
    vel = vth * torch.randn((3, NT, B), generator=gen, device=dev)
    field = torch.randn((NT, P, P, P, 3), generator=gen, device=dev)
    return xyz.contiguous(), vel, alive, field


def compare(tk, ts, d, mdt, order: int, q: float, qm: float, kicks,
            errs: dict, label: str) -> None:
    """Each kernel against its plain version on the same CUDA tensors."""
    import torch
    value = d["alive"] * q
    t = tk.deposit(d["xyz"], value, ts, mxu_dtype=mdt, order=order)
    tr = tk.deposit_plain(d["xyz"], value, ts, mxu_dtype=mdt, order=order)
    e = (t - tr).abs().max().item()
    check(e <= DEPOSIT_RTOL * tr.abs().max().item(),
          f"deposit {label}: max err {e} > {DEPOSIT_RTOL} * max|tiles|")
    errs["deposit"] = max(errs["deposit"], e)

    t, x, n = tk.deposit_move(d["xyz"], d["vel"], d["alive"], q, ts,
                              mxu_dtype=mdt, order=order)
    tr, xr, nr = tk.deposit_move_plain(d["xyz"], d["vel"], d["alive"], q,
                                       ts, mxu_dtype=mdt, order=order)
    e = (t - tr).abs().max().item()
    check(e <= DEPOSIT_RTOL * tr.abs().max().item(),
          f"deposit_move {label}: tiles max err {e}")
    check(torch.equal(x, xr), f"deposit_move {label}: moved planes differ")
    check(float(n) == float(nr),
          f"deposit_move {label}: n_out {float(n)} != {float(nr)}")
    errs["deposit_move"] = max(errs["deposit_move"], e)

    g = tk.gather(d["field"], d["xyz"], ts, mxu_dtype=mdt, order=order)
    gr = tk.gather_plain(d["field"], d["xyz"], ts, mxu_dtype=mdt, order=order)
    e = (g - gr).abs().max().item()
    check(e <= FIELD_ATOL, f"gather {label}: max err {e} > {FIELD_ATOL}")
    errs["gather"] = max(errs["gather"], e)

    for name, kw in kicks.items():
        v, vd = tk.gather_kick(d["field"], d["xyz"], d["vel"], d["alive"],
                               qm, ts, mxu_dtype=mdt, order=order, **kw)
        vr, vdr = tk.gather_kick_plain(d["field"], d["xyz"], d["vel"],
                                       d["alive"], qm, ts, mxu_dtype=mdt,
                                       order=order, **kw)
        e = (v - vr).abs().max().item()
        check(e <= FIELD_ATOL,
              f"gather_kick {label} {name}: velocity max err {e}")
        rel = abs(float(vd) - float(vdr)) / abs(float(vdr))
        check(rel <= VDOT_RTOL, f"gather_kick {label} {name}: vdot rel err "
              f"{rel} > {VDOT_RTOL}")
        errs["gather_kick"] = max(errs["gather_kick"], e)
    torch.cuda.synchronize()
    print(f"  {label}: ok", flush=True)


STEP_KICKS = {
    "leapfrog": dict(),
    "boris": dict(boris_T=((0.01, -0.02, 0.03), (0.001, 0.002, 0.003)),
                  boris_S=((0.0199, -0.0398, 0.0597), (0.002, 0.004, 0.006))),
    "e_ext": dict(e_ext=(0.05, 0.0, -0.02)),
}
# tests/test_margin_schedule.py:38's margin sets (M = 2)
MARGIN_SETS = (((1, 1), (1, 1)), ((1, 2), (2, 2)), ((0, 1), (1, 1)))


def step_inputs(ts, gen, dev, vth: float, live: float, wander=None):
    """Two species in the layout of the scan: live slots anywhere in the
    wander envelope [-M, T+M) (or [-w, T+w) for a given wander w), dead
    ones parked at -2M-2; velocities N(0, vth); random E tiles."""
    import torch
    NT, B, P = ts.NT, ts.B, ts.P
    w = ts.M if wander is None else wander
    alive = (torch.rand((2, NT, B), generator=gen, device=dev) < live).float()
    lpos = torch.rand((2, 3, NT, B), generator=gen, device=dev) * (
        ts.T + 2 * w - 1e-3) - w
    lpos = torch.where(alive.bool()[:, None], lpos,
                       torch.full((), -2.0 * ts.M - 2.0, device=dev))
    vel = vth * torch.randn((2, 3, NT, B), generator=gen, device=dev)
    E = torch.randn((NT, 3 * P, P * P), generator=gen, device=dev)
    return dict(lpos=lpos.contiguous(), vel=vel, alive=alive, E=E)


def compare_step(tk, ts, d, mdt, orders, kicks, margin_sets, charge, qm,
                 errs: dict, label: str) -> None:
    """K5 against its plain version on the same CUDA tensors: positions,
    velocities and n_out exact, tiles and vdot within the deposit and
    kick tolerances."""
    import torch
    E = d["E"].to(mdt)
    for oa, od in orders:
        for name, kw in kicks.items():
            for margins in margin_sets:
                args = (E, d["lpos"], d["vel"], d["alive"], charge, qm, ts)
                opts = dict(mxu_dtype=mdt, order_acc=oa, order_distr=od,
                            margins=margins, **kw)
                t, x, v, vd, n = tk.pic_step(*args, **opts)
                tr, xr, vr, vdr, nr = tk.pic_step_plain(*args, **opts)
                e = (t - tr).abs().max().item()
                what = f"pic_step {label} order {oa}{od} {name} {margins}"
                check(e <= DEPOSIT_RTOL * tr.abs().max().item(),
                      f"{what}: tiles max err {e}")
                check(torch.equal(x, xr) and torch.equal(v, vr),
                      f"{what}: new positions or velocities differ")
                check(torch.equal(n, nr), f"{what}: n_out {n} != {nr}")
                rel = ((vd - vdr).abs() / vdr.abs()).max().item()
                check(rel <= VDOT_RTOL, f"{what}: vdot rel err {rel}")
                errs["pic_step"] = max(errs["pic_step"], e)
                del t, x, v, tr, xr, vr
    torch.cuda.synchronize()
    print(f"  pic_step {label}: ok", flush=True)


def compare_field(fk, ts, gen, dev, errs: dict, label: str):
    """K6 (f32 and bf16 out) and K7 against their plain versions, bit for
    bit.  Returns the phi and tiles used."""
    import torch
    phi = torch.randn(ts.grid, generator=gen, device=dev)
    tiles = torch.randn((ts.NT, ts.P, ts.P * ts.P), generator=gen, device=dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fk.efield_tiles(phi, ts, out_dtype=out_dtype)
        want = fk.efield_tiles_plain(phi, ts, out_dtype=out_dtype)
        check(same(got, want), f"efield_tiles {label} {out_dtype}: differs "
              f"from its plain version")
    check(same(fk.fold_global(tiles, ts), fk.fold_global_plain(tiles, ts)),
          f"fold_global {label}: differs from its plain version")
    errs["efield_tiles"] = errs["fold_global"] = 0.0
    torch.cuda.synchronize()
    print(f"  efield_tiles, fold_global {label}: ok (bit-equal)", flush=True)
    return phi, tiles


def step_bytes(ts, S: int, e_bytes: int) -> float:
    """Bytes K5 must move: per slot and species x, v, alive read (28 B)
    and x, v written (24 B); the E tiles read, the density blocks and the
    (S, NT) partials written."""
    return (S * ts.NT * ts.B * 52.0 + ts.NT * 3 * ts.P ** 3 * e_bytes
            + ts.NT * ts.P ** 3 * 4.0 + 2 * S * ts.NT * 4.0)


def time_step_and_field(tk, fk, ts, gen, dev, card: str, charge, qm,
                        errs: dict):
    """Phase 2 at a production shape: K5 (bf16, two species), K6 and K7
    against their plain versions, then timed.  Returns {name: (ms,
    plain_ms, bound_ms)}."""
    import torch
    mdt = torch.bfloat16
    d = step_inputs(ts, gen, dev, 0.05, 16384 / 17408)
    compare_step(tk, ts, d, mdt, [(1, 1)], {"leapfrog": dict()},
                 [None] + ([((1, 2), (2, 2))] if ts.M == 2 else []),
                 charge, qm, errs, f"production {ts.NT}x{ts.B} M={ts.M}")
    phi, tiles = compare_field(fk, ts, gen, dev, errs,
                               f"production {ts.grid} M={ts.M}")
    E = d["E"].to(mdt)
    args = (E, d["lpos"], d["vel"], d["alive"], charge, qm, ts)
    grid_bytes = float(math.prod(ts.grid)) * 4
    blk = ts.NT * ts.P ** 3
    out = {
        "pic_step": (lambda: tk.pic_step(*args, mxu_dtype=mdt),
                     lambda: tk.pic_step_plain(*args, mxu_dtype=mdt),
                     step_bytes(ts, 2, 2)),
        "efield_tiles": (lambda: fk.efield_tiles(phi, ts, out_dtype=mdt),
                         lambda: fk.efield_tiles_plain(phi, ts,
                                                       out_dtype=mdt),
                         grid_bytes + 3 * blk * 2.0),
        "fold_global": (lambda: fk.fold_global(tiles, ts),
                        lambda: fk.fold_global_plain(tiles, ts),
                        blk * 4.0 + grid_bytes),
    }
    res = {}
    for name, (kern, plain, nbytes) in out.items():
        ms = cuda_ms(kern, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        res[name] = (ms, plain_ms, bound_ms(nbytes))
        print(f"  time {name} at {ts.NT}x{ts.B}, M={ts.M} (P={ts.P}) bf16: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{res[name][2]:.4f} ms ({card})", flush=True)
    del d, E, args, out, phi, tiles
    torch.cuda.empty_cache()
    return res


def same(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a, b)


def same_bits(a, b) -> bool:
    """Same shape and bits (float32 compared as int32: -0.0 != +0.0)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def leaves(x) -> list:
    """The tensors of a nested tuple, in order."""
    return ([t for y in x for t in leaves(y)] if isinstance(x, tuple)
            else [x])


def fresh_copy(x):
    """A copy of a nested tuple's tensors (other values as they are)."""
    if isinstance(x, tuple):
        return tuple(fresh_copy(y) for y in x)
    return x.clone() if hasattr(x, "clone") else x


def exchange_fixture(gen, dev):
    """tests/test_torch_cuda.py's exchange fixture: 8 tiles (2x2x2 of 4^3
    cells), B = 2048 (rows of 256 slots), 80% alive over [-1.5, 5.5); in
    tile 0 the first 200 slots of every row leave through -x, past the
    128-wide row caps."""
    import torch
    NT, B = 8, 2048
    alive = (torch.rand((NT, B), generator=gen, device=dev) < 0.8).float()
    planes = [torch.rand((NT, B), generator=gen, device=dev) * 7.0 - 1.5
              for _ in range(3)]
    planes += [torch.randn((NT, B), generator=gen, device=dev)
               for _ in range(3)]
    planes[0][0].view(8, 256)[:, :200] = -0.5
    alive[0].view(8, 256)[:, :200] = 1.0
    return alive, tuple(planes)


def check_exchange_fixture(gx, ex, gen, dev) -> None:
    """Phase 2, fixture size: each exchange kernel against its plain
    version (forced overflow, spill and drops included), and both drivers
    on the card against the same drivers on the CPU, bit for bit."""
    import torch
    alive, planes = exchange_fixture(gen, dev)
    extracts = {
        "dim0": (lambda: gx.extract_rows_g(0, alive, planes, 128, 4),
                 lambda: gx.extract_rows_g_plain(0, alive, planes, 128, 4)),
        "dim1": (lambda: gx.extract_rows_g(1, alive, planes, 128, 4),
                 lambda: gx.extract_rows_g_plain(1, alive, planes, 128, 4)),
        "dim2": (lambda: gx.extract_rows_g(2, alive, planes, 128, 4),
                 lambda: gx.extract_rows_g_plain(2, alive, planes, 128, 4)),
        "all": (lambda: gx.extract_all_rows_g(alive, planes, 128, 4),
                lambda: gx.extract_all_rows_g_plain(alive, planes, 128, 4)),
        "compact": (lambda: gx.extract_compact_rows_g(alive, planes, 128, 4),
                    lambda: gx.extract_compact_rows_g_plain(alive, planes,
                                                            128, 4)),
    }
    for name, (kern, plain) in extracts.items():
        (b, a2), (br, a2r) = kern(), plain()
        check(same(b, br) and same(a2, a2r),
              f"extract {name}, fixture: differs from its plain version")
        if name in ("dim0", "all", "compact"):
            check(float(b[0, 6, :, :128].sum()) == 8 * 128,
                  f"extract {name}, fixture: the forced overflow did not "
                  f"fill the row caps")
    buf, _ = gx.extract_compact_rows_g(alive, planes, 384, 4)
    for axes in ((0, 1, 2), (1, 2), (2,)):
        (st, e), (sr, er) = (gx.cleanup_rows_g(buf, 128, 4, axes),
                             gx.cleanup_rows_g_plain(buf, 128, 4, axes))
        check(same(st, sr) and all(map(same, e, er)),
              f"cleanup {axes}, fixture: differs from its plain version")
    _, faces = gx.cleanup_rows_g(buf, 128, 4, (0, 1, 2))
    inc = torch.cat(faces, -1)
    blocks = tuple((128 * i, 128) for i in range(6))
    room = torch.zeros((8, 8, 256), device=dev)
    room[:, :4] = 1.0                 # rows 0-3 full: spill, then drops
    outs = []
    for merge in (gx.merge_rows_g, gx.merge_rows_g_plain):
        a = room.reshape(8, 2048).clone()
        p = tuple(q.clone() for q in planes)
        merge(a, inc, p, blocks)
        outs.append((a, p))
    (a_k, p_k), (a_p, p_p) = outs
    check(same(a_k, a_p) and all(map(same, p_k, p_p)),
          "merge, fixture: differs from its plain version")
    placed = a_k.reshape(8, 8, 256)[:, 4:].sum(-1)
    check(float(placed.sum()) < float(inc[:, 6].sum())
          and bool((placed > inc[:, 6, 4:].sum(-1)).any()),
          "merge, fixture: the case did not exercise spill and drops")
    for fused in (True, False):
        res = []
        for d in (dev, "cpu"):
            a = alive.to(d).clone()
            p = tuple(q.to(d).clone() for q in planes)
            res.append(ex.rebucket_exchange_planes(p, a, (2, 2, 2), 4, K=256,
                                                   rows=True, fused=fused))
        (pg, ag, dg), (pc, ac, dc) = res
        check(int(dg) == int(dc) > 0 and same(ag.cpu(), ac)
              and all(same(g.cpu(), c) for g, c in zip(pg, pc)),
              f"exchange driver fused={fused}, fixture: card and CPU differ")
    torch.cuda.synchronize()
    print("  exchange fixture (8 tiles x 2048, forced overflow): ok",
          flush=True)


def bench_species(prod, gen, dev, vth: float, cadence: int, q: float,
                  per_tile: int = 16384):
    """A bucketed species at a production layout, moved by one K2 drift
    of cadence x its velocities: per_tile uniform particles per tile on
    average, velocities N(0, vth).  Returns (alive, 6 planes)."""
    import torch
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.ops.tiled import bucket
    n = per_tile * prod.NT
    pos = torch.rand((n, 3), generator=gen, device=dev) * torch.tensor(
        prod.grid, dtype=torch.float32, device=dev)
    vel = torch.randn((n, 3), generator=gen, device=dev) * vth
    lp, lv, la, dropped = bucket(pos, vel, torch.ones(n, dtype=torch.bool,
                                                      device=dev), prod)
    check(int(dropped) == 0, "bucketing the production state dropped")
    del pos, vel
    xyz = lp.permute(2, 0, 1).contiguous()
    v = lv.permute(2, 0, 1).contiguous()
    alive = la.float()
    del lp, lv, la
    _, moved, _ = tk.deposit_move(xyz, v * float(cadence), alive, q, prod,
                                  mxu_dtype=torch.bfloat16)
    return alive, tuple(moved) + tuple(v)


def capture_calls(mod, names: dict, run) -> dict:
    """Call run() with the functions of mod named in names spied: each
    call's inputs are recorded (cloned, since the merges write in place).
    Returns {kernel: [(fn, plain, args)]}, kernel = names[function]; the
    plain version of f is mod.f_plain."""
    calls = {k: [] for k in names.values()}
    orig = {n: getattr(mod, n) for n in names}

    def spy(n):
        def fn(*args, **kw):
            args = args + tuple(kw.values())
            calls[names[n]].append((orig[n], getattr(mod, n + "_plain"),
                                    fresh_copy(args)))
            return orig[n](*args)
        return fn
    try:
        for n in names:
            setattr(mod, n, spy(n))
        run()
    finally:
        for n, f in orig.items():
            setattr(mod, n, f)
    return calls


def capture_exchange(gx, ex, alive, planes, ntiles, T, K):
    """The kernel calls of one gather exchange."""
    return capture_calls(
        gx, {"extract_compact_rows_g": "extract", "cleanup_rows_g": "cleanup",
             "merge_rows_g": "merge"},
        lambda: ex.rebucket_exchange_planes(
            tuple(p.clone() for p in planes), alive.clone(), ntiles, T, K=K,
            rows=True))


def merge_prefix(alive, inc) -> float:
    """Slots of alive the one-hot merge must read: in each segment (row,
    or tile for R = 1) up to the free slot its last placed arrival takes."""
    import torch
    NT, B = alive.shape
    R = inc.shape[2]
    free = (alive <= 0.5).reshape(NT, R, B // R)
    need = torch.minimum((inc[:, 6] > 0.5).sum(-1), free.sum(-1))
    return float(((torch.cumsum(free, -1) < need[..., None]).sum(-1)
                  + (need > 0)).sum())


def exchange_bytes(kind: str, args, out) -> float:
    """Bytes the call must move (each input read once, each output written
    once; where the work depends on the data, what this data needs)."""
    import torch
    if kind == "extract":
        alive, planes = args[0], args[1]
        buf, alive2 = out
        leavers = float((alive > 0.5).sum() - (alive2 > 0.5).sum())
        return alive.numel() * 20.0 + leavers * 12.0 + buf.numel() * 4.0
    if kind in ("onehot_extract_rows", "onehot_extract_tile"):
        # (coord, alive, planes, ...) for one axis, (planes, alive, ...)
        # for all axes: 4 B of alive and 4 (one axis) or 12 B of coordinates
        # read and alive written a slot; the other payloads of a copied
        # leaver read; the buffer written
        alive, buf = args[1], out[0]
        one_axis = isinstance(args[0], torch.Tensor)
        copied = float((buf[:, 6] > 0.5).sum())
        return (alive.numel() * (12.0 if one_axis else 20.0)
                + copied * (20.0 if one_axis else 12.0) + buf.numel() * 4.0)
    if kind in ("cleanup", "onehot_cleanup"):
        inc = args[0]
        settled, extras = out
        valid = float((inc[:, 6] > 0.5).sum())
        return (inc[:, 6].numel() * 4.0 + valid * 24.0
                + (settled.numel() + sum(e.numel() for e in extras)) * 4.0)
    alive, inc = args[0], args[1]
    placed = float((out[1] > 0.5).sum() - (alive > 0.5).sum())
    if kind.startswith("onehot_merge"):
        return (merge_prefix(alive, inc) * 4.0 + inc[:, 6].numel() * 4.0
                + placed * 52.0)
    NT, B = alive.shape                                 # the gather merge
    free = (alive <= 0.5).reshape(NT, 8, B // 8)
    need = torch.minimum((inc[:, 6] > 0.5).sum(-1), free.sum(-1))
    prefix = (torch.cumsum(free, -1) < need[..., None]).sum(-1) + (need > 0)
    return (float(prefix.sum()) * 4.0 + inc[:, 6].numel() * 4.0
            + placed * 52.0)


def time_calls(calls: dict, where: str, card: str, times: dict,
               bounds: dict, equal=same) -> None:
    """Each recorded call against its plain version (equal), then timed
    (kernel, plain) by CUDA events on fresh copies of its inputs, with its
    bound from the bytes it must move; per kernel the mean over its
    calls."""
    for kind, recorded in calls.items():
        ms = plain_ms = nbytes = 0.0
        for fn, plain, args in recorded:
            def fresh(args=args):
                return fresh_copy(args)
            out = fn(*fresh())
            got, want = leaves(out), leaves(plain(*fresh()))
            check(len(got) == len(want) and all(map(equal, got, want)),
                  f"{kind} at {where}: differs from its plain version")
            nbytes += exchange_bytes(kind, args, out)
            if "merge" in kind:
                ms += cuda_ms_fresh(fresh, fn, reps=10)
                plain_ms += cuda_ms_fresh(fresh, plain, reps=2)
            else:
                ms += cuda_ms(lambda: fn(*args), reps=10, warmup=2)
                plain_ms += cuda_ms(lambda: plain(*args), reps=2, warmup=1)
        n = len(recorded)
        times[kind] = (ms / n, plain_ms / n)
        bounds[kind] = bound_ms(nbytes / n)
        print(f"  time {kind} at {where} (mean of {n} call(s) of one "
              f"electron exchange): kernel {ms / n:.4f} ms, plain "
              f"{plain_ms / n:.4f} ms, bound {bounds[kind]:.4f} ms ({card})",
              flush=True)


def check_exchange_bench(gx, ex, prod, gen, dev, card: str, times: dict,
                         bounds: dict) -> None:
    """Phase 2, production shape: the calls of one electron exchange
    (bench-like velocities, one cadence of drift), each kernel against its
    plain version bit for bit and timed; then one whole exchange per
    species, timed."""
    import torch
    K, caps = 256, "K=256: Ks=128, KU=384, Ke=128"
    species = {"electrons": (0.02, 10, -1.0 / 32), "ions": (0.0005, 200,
                                                            1.0 / 32)}
    alive, planes = bench_species(prod, gen, dev, *species["electrons"])
    calls = capture_exchange(gx, ex, alive, planes, prod.ntiles, prod.T, K)
    check([len(calls[k]) for k in ("extract", "cleanup", "merge")]
          == [1, 3, 1], f"one exchange made {calls}")
    time_calls(calls, f"{prod.NT}x{prod.B} ({caps})", card, times, bounds)
    del calls
    for name, (vth, cadence, q) in species.items():
        if name != "electrons":
            del alive, planes
            torch.cuda.empty_cache()
            alive, planes = bench_species(prod, gen, dev, vth, cadence, q)
        leavers = int(((alive > 0.5) & torch.stack(
            [(c < 0) | (c >= prod.T) for c in planes[:3]]).any(0)).sum())
        # the electrons also through the one-hot exchange
        # (tiles:exchangeImpl=onehot: the fused row exchange at Ks = 64,
        # Ke = 16), in turns with the gather
        impls = ("auto", "onehot", "onehot", "auto") if name == "electrons" \
            else ("auto",)
        ms = {impl: [] for impl in impls}
        for impl in impls:
            ms[impl].append(cuda_ms_fresh(
                lambda: (tuple(p.clone() for p in planes), alive.clone()),
                lambda p, a, impl=impl: ex.rebucket_exchange_planes(
                    p, a, prod.ntiles, prod.T, K=K, rows=True, impl=impl),
                reps=5))
        if name == "electrons":
            _, a1, d1 = ex.rebucket_exchange_planes(
                tuple(p.clone() for p in planes), alive.clone(), prod.ntiles,
                prod.T, K=K, rows=True, impl="onehot")
            check(int(d1) == 0 and int((a1 > 0.5).sum())
                  == int((alive > 0.5).sum()),
                  f"the one-hot exchange of the bench electrons dropped "
                  f"{int(d1)}")
        times_txt = ", ".join(
            f"{'gather' if impl == 'auto' else impl} "
            f"{sum(v) / len(v):.4f} ms ({' / '.join(f'{x:.4f}' for x in v)})"
            for impl, v in ms.items())
        print(f"  time whole exchange re-bucket, {name} (vth {vth}, one "
              f"{cadence}-step drift, {leavers} leavers = "
              f"{leavers / float(alive.sum()):.4%}): {times_txt} ({card})",
              flush=True)
    del alive, planes
    torch.cuda.empty_cache()


def onehot_fixture(gen, dev, B: int = 640):
    """tests/test_torch_cuda.py's one-hot fixture: 8 tiles (2x2x2 of 4^3
    cells), B = 640 (rows of 80 slots, not a multiple of 32) or any B, 80%
    alive over [-1.5, 5.5); for B % 8 == 0 the first 40 slots of every row
    of tile 0 leave through -x, past the row and tile caps; every 7th vy
    and 9th y is -0.0 (stored as +0.0 by the one-hot exchange)."""
    import torch
    alive = (torch.rand((8, B), generator=gen, device=dev) < 0.8).float()
    planes = [torch.rand((8, B), generator=gen, device=dev) * 7.0 - 1.5
              for _ in range(3)]
    planes += [torch.randn((8, B), generator=gen, device=dev)
               for _ in range(3)]
    if B % 8 == 0:
        planes[0][0].view(8, B // 8)[:, :40] = -0.5
        alive[0].view(8, B // 8)[:, :40] = 1.0
    planes[4][:, ::7] = -0.0
    planes[1][:, ::9] = -0.0
    return alive, tuple(planes)


def check_onehot_fixture(ox, gx, ex, gen, dev) -> None:
    """Phase 2, fixture size: each one-hot kernel in each of its modes
    against its plain version, bit for bit: extracts with tile 0 past the
    leaver caps, cleanups past the edge cap, merges into rows and tiles
    with fewer free slots than arrivals, the ranked modes at B % 8 != 0
    (with pinc_tpu's active flags, none, and chunks switched off); then the
    drivers on the card against the CPU."""
    import torch
    alive, planes = onehot_fixture(gen, dev)

    def both(name, kern, plain, *args):
        got, want = leaves(kern(*args)), leaves(plain(*args))
        check(len(got) == len(want) and all(map(same_bits, got, want)),
              f"one-hot {name}, fixture: differs from its plain version")
        return got

    for d in range(3):
        b1 = both(f"extract_fused d={d}", ox.extract_fused,
                  ox.extract_fused_plain, planes[d], alive, planes, 32, 4)[0]
        b8 = both(f"extract_rows d={d}", ox.extract_rows,
                  ox.extract_rows_plain, planes[d], alive, planes, 16, 4)[0]
        if d == 0:
            check(float(b1[0, 6, :, :32].sum()) == 32
                  and float(b8[0, 6, :, :16].sum()) == 8 * 16,
                  "one-hot extract, fixture: the leaver caps did not fill")
    b6 = both("extract_all_rows", ox.extract_all_rows,
              ox.extract_all_rows_plain, planes, alive, 16, 4)[0]
    roll = gx._torch_roll
    inc_x = torch.cat([ox._roll_blocked(b6[..., :16], (2, 2, 2), 0, -1, roll),
                       ox._roll_blocked(b6[..., 16:32], (2, 2, 2), 0, 1,
                                        roll)], -1)
    inc_x = gx._shift_block(inc_x, 0, 4, ((16, 1), (16, -1)))
    for axes in ((1, 2), (2,)):              # Ke = 2: the edge cap overflows
        both(f"cleanup_rows {axes}", ox.cleanup_rows, ox.cleanup_rows_plain,
             inc_x, 32, 2, 4, axes)
    inc_r, _ = ox.extract_rows(planes[0], alive, planes, 16, 4)
    inc_t, _ = ox.extract_fused(planes[1], alive, planes, 32, 4)
    f = [b6[..., i * 16:(i + 1) * 16] for i in range(6)]
    inc_a = torch.cat([f[0], f[1], f[2], f[0][..., :8], f[3], f[1][..., :8],
                       f[4], f[2][..., :8], f[3][..., :8], f[5],
                       f[4][..., :8], f[5][..., :8]], -1).contiguous()
    blocks, off = [], 0
    for w in (32, 48, 16, 8, 8, 16, 8, 8):
        blocks.append((off, w))
        off += w
    room = (torch.rand((8, 640), generator=gen, device=dev) < 0.5).float()
    room.view(8, 8, 80)[:, :5] = 1.0       # rows 0-4 full: arrivals drop
    room_t = room.clone()
    room_t[:2] = 1.0
    room_t[:2, ::50] = 0.0                 # 13 free slots in tiles 0 and 1
    merges = {
        "merge_rows": (ox.merge_rows, ox.merge_rows_plain, inc_r, 16, room),
        "merge_fused": (ox.merge_fused, ox.merge_fused_plain, inc_t, 32,
                        room_t),
        "merge_all_rows": (ox.merge_all_rows, ox.merge_all_rows_plain, inc_a,
                           tuple(blocks), room),
    }
    for name, (kern, plain, inc, cap, room) in merges.items():
        outs = []
        for fn in (kern, plain):
            a, p = room.clone(), tuple(q.clone() for q in planes)
            fn(a, inc, p, cap)
            outs.append([a, *p])
        check(all(map(same_bits, *outs)),
              f"one-hot {name}, fixture: differs from its plain version")
        placed = float(outs[0][0].sum() - room.sum())
        check(0 < placed < float(inc[:, 6].sum()),
              f"one-hot {name}, fixture: expected drops, placed {placed}")
    for B in (100, 2100):                      # the ranked (B % 8 != 0) modes
        alive_b, planes_b = onehot_fixture(gen, dev, B)
        al = alive_b > 0.5
        lm, lp = al & (planes_b[2] < 0), al & (planes_b[2] >= 4)
        rm = torch.cumsum(lm, 1, dtype=torch.int32) - 1
        rp = torch.cumsum(lp, 1, dtype=torch.int32) - 1
        rank = torch.where(lm & (rm < 16), rm,
                           torch.where(lp & (rp < 16), 16 + rp,
                                       torch.full_like(rm, -1)))
        rank = torch.where((lm & (rm >= 16)) | (lp & (rp >= 16)),
                           torch.full_like(rm, 32), rank)
        bk = both(f"extract B={B}", ox.extract, ox.extract_plain, rank,
                  alive_b, planes_b, 32)[0]
        room_b = (torch.rand((8, B), generator=gen, device=dev) < 0.5).float()
        free = room_b <= 0.5
        fr_incl = torch.cumsum(free, 1, dtype=torch.int32)
        frank = torch.where(free, fr_incl - 1, torch.full_like(fr_incl, -1))
        CB = ox._chunk(B)
        ends = fr_incl[:, CB - 1::CB]
        base = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
        flags = ((base < bk[:, 6].sum((-2, -1))[:, None]) & (ends > base)
                 ).to(torch.int32)
        off_half = flags.clone()
        off_half[::2] = 0
        for label, act in (("flags", flags), ("none", None),
                           ("skip", off_half)):
            outs = []
            for fn in (ox.merge, ox.merge_plain):
                a, p = room_b.clone(), tuple(q.clone() for q in planes_b)
                fn(frank, a, bk, p, active=act)
                outs.append([a, *p])
            check(all(map(same_bits, *outs)),
                  f"one-hot merge B={B} active={label}, fixture: differs "
                  f"from its plain version")
    routes = {"v5": dict(K=64, rows=True), "v5 Ks=8": dict(K=16, rows=True),
              "v4": dict(K=64, rows=True, fused=False), "v3": dict(K=32),
              "v2": dict(K=16)}
    for name, kw in routes.items():
        B = 100 if name == "v2" else 640
        alive_d, planes_d = onehot_fixture(gen, dev, B)
        res = []
        for d in (dev, "cpu"):
            res.append(ex.rebucket_exchange_planes(
                tuple(q.to(d).clone() for q in planes_d),
                alive_d.to(d).clone(), (2, 2, 2), 4, **kw))
        (pg, ag, dg), (pc, ac, dc) = res
        check(int(dg) == int(dc) > 0 and same_bits(ag.cpu(), ac)
              and all(same_bits(g.cpu(), c) for g, c in zip(pg, pc)),
              f"one-hot driver {name}, fixture: card and CPU differ")
    torch.cuda.synchronize()
    print("  one-hot exchange fixture (8 tiles x 640, 100 and 2100; caps, "
          "edge caps and rows overflowing): ok (bit-equal)", flush=True)


def check_onehot_bench(ox, ex, gen, dev, card: str, times: dict,
                       bounds: dict) -> None:
    """Phase 2, production shapes of the one-hot decks (4096 tiles of 8^3,
    margin 2, face cap K = 256; 6144 uniform particles a tile, velocities
    N(0, 0.1) moved by one electron cadence of 4 steps): B = 7680 takes the
    fused row exchange (Ks = 64, Ke = 16), B = 6528 the per-tile sweeps
    (K = 256).  The calls of one exchange, each kernel against its plain
    version bit for bit and timed; then the whole exchange, timed."""
    import torch
    from pinc_tpu_torch.ops.tiled import TileSpec
    routes = {
        "onehot_rows": {"extract_all_rows": "onehot_extract_rows",
                        "cleanup_rows": "onehot_cleanup",
                        "merge_all_rows": "onehot_merge_rows"},
        "onehot_tile": {"extract_fused": "onehot_extract_tile",
                        "merge_fused": "onehot_merge_tile"},
    }
    for route, names in routes.items():
        rows = route == "onehot_rows"
        ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=ONEHOT_B[route])
        alive, planes = bench_species(ts, gen, dev, 0.1, 4, -1.0 / ONEHOT_PC,
                                      per_tile=ONEHOT_PC * 8 ** 3)

        def run(rows=rows):
            return ex.rebucket_exchange_planes(
                tuple(p.clone() for p in planes), alive.clone(), ts.ntiles,
                ts.T, K=256, rows=rows)
        calls = capture_calls(ox, names, run)
        check({k: len(v) for k, v in calls.items()} == ROUTE_CALLS[route],
              f"one {route} exchange made {calls}")
        caps = "Ks=64, Ke=16" if rows else "K=256"
        time_calls(calls, f"{ts.NT}x{ts.B} ({route}, {caps})", card, times,
                   bounds, equal=same_bits)
        del calls
        _, a1, d1 = run()
        n0 = int((alive > 0.5).sum())
        check(int(d1) == 0 and int((a1 > 0.5).sum()) == n0,
              f"{route} exchange at {ts.NT}x{ts.B}: {int(d1)} dropped")
        del a1
        leavers = int(((alive > 0.5) & torch.stack(
            [(c < 0) | (c >= ts.T) for c in planes[:3]]).any(0)).sum())
        ms = cuda_ms_fresh(
            lambda: (tuple(p.clone() for p in planes), alive.clone()),
            lambda p, a: ex.rebucket_exchange_planes(
                p, a, ts.ntiles, ts.T, K=256, rows=rows), reps=5)
        print(f"  time whole {route} exchange re-bucket at {ts.NT}x{ts.B}, "
              f"electrons (vth 0.1, one 4-step drift, {leavers} leavers = "
              f"{leavers / n0:.4%}, 0 dropped): {ms:.4f} ms ({card})",
              flush=True)
        del alive, planes
        torch.cuda.empty_cache()


def onehot_deck(route: str) -> str:
    """The one-hot decks: bench.py's headline deck (vth 0.1/0.0023) at
    ONEHOT_PC particles per cell, with the route's slack."""
    deck = scan_deck(HEADLINE_VTH).replace(
        "32 pc", f"{ONEHOT_PC} pc").replace("slack = 1.0625\n", "")
    slack = ONEHOT_SLACK[route]
    return deck + (f"slack = {slack}\n" if slack else "")


def run_main_path(cli_main, kernel_modules, extra, steps: int,
                  deck_text: str = BENCH_DECK):
    """The CLI on a deck (default: the bench deck); the launch counts are
    set to 0 just before and read just after.  Returns (rc, out, launches,
    wall s)."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "bench128.ini")
        with open(deck, "w") as f:
            f.write(deck_text)
        torch.cuda.reset_peak_memory_stats()
        for m in kernel_modules:
            m.reset_launches()
        out: dict = {}
        t0 = time.monotonic()
        rc = cli_main([deck, "methods:layout=tiled", *extra,
                       f"time:nTimeSteps={steps}"], out=out)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for m in kernel_modules for k, v in m.LAUNCHES.items()}
    return rc, out, launches, wall


def check_main_path(label, rc, out, launches, wall, steps, prod, card,
                    route: str):
    """The checks of phase 3 on one run; route: the re-bucket the deck
    must take (a key of ROUTE_CALLS)."""
    import torch
    check(rc == 0, f"{label}: the CLI returned {rc}")
    sim = out["sim"]
    mode = "sort" if route == "sort" else "exchange"
    S, per_species = sim.state.alive.shape[0], sim._capacity
    print(f"phase 3 {label}: {type(sim).__name__}, {sim.ts.ntiles} tiles "
          f"of {sim.ts.T}^3, B={sim.ts.B}, M={sim.ts.M}, {mode} re-bucket, "
          f"cadences {sim.rebucket_every_s}, face cap {sim._exchange_cap}, "
          f"rows {sim._exchange_rows}, {steps} steps, {wall:.1f} s "
          f"including set-up", flush=True)
    check((sim.ts.T, sim.ts.M, sim.ts.B, sim.ts.NT)
          == (prod.T, prod.M, prod.B, prod.NT),
          f"phase 2 checked the kernels at T={prod.T} M={prod.M} B={prod.B} "
          f"NT={prod.NT}, but the main path derived T={sim.ts.T} "
          f"M={sim.ts.M} B={sim.ts.B} NT={sim.ts.NT}")
    rows = route != "onehot_tile"
    check(sim._rebucket_mode == mode and sim._exchange_cap == 256
          and sim._exchange_rows == rows,
          f"{label}: expected the {mode} re-bucket with face cap 256 and "
          f"the row gate {rows} (the caps phase 2 used)")
    print(f"  launches: {launches}", flush=True)
    check(all(launches[k] > 0 for k in
              ("deposit", "gather", "deposit_move", "gather_kick")),
          f"{label}: a kernel of the step never launched: {launches}")
    check(launches["deposit_move"] == S * steps
          and launches["gather_kick"] == S * steps,
          f"{label}: deposit_move/gather_kick ran {launches}, expected {S} "
          f"per step")
    check(launches["fold_global"] == steps + 1 and launches["pic_step"] == 0
          and launches["efield_tiles"] == 0,
          f"{label}: expected fold_global once a step and the half kick, "
          f"no pic_step/efield_tiles: {launches}")
    # species re-bucket events: the scheduled ones, and on the one-hot
    # decks (vth 0.1 at M = 2: the Maxwellian's tail of 50M particles)
    # every species again at a step where particles reached the margin
    scheduled = sum(steps // R for R in sim.rebucket_every_s)
    calls = ROUTE_CALLS[route]
    first = next(iter(calls), None)
    events = launches[first] // calls[first] if first else scheduled
    onehot = route.startswith("onehot")
    check(scheduled >= 1 and (out["n_lost"] == 0 or onehot)
          and (events == scheduled or (onehot and events > scheduled
                                       and out["n_lost"] > 0)),
          f"{label}: {events} re-bucket events ({scheduled} scheduled), "
          f"{out['n_lost']} margin hits")
    got = {k: launches[k] for k in EXCHANGE_KERNELS}
    want = {k: calls.get(k, 0) * events for k in EXCHANGE_KERNELS}
    check(got == want and (events >= 2 or route == "sort"),
          f"{label}: the exchange kernels ran {got}, expected {want} "
          f"({events} events)")
    print(f"  species re-bucket events: {events} ({scheduled} scheduled; "
          f"{out['n_lost']} particle(s) reached the margin)", flush=True)
    st = sim.state
    on_card = all(t.is_cuda for t in (st.lpos, st.vel, st.alive))
    check(on_card, f"{label}: a state tensor left the card")
    n_alive = int((st.alive > 0.5).sum())
    print(f"  state on cuda: {on_card}; alive: {n_alive} of "
          f"{S * per_species}; re-bucket drops: {out['dropped']}",
          flush=True)
    check(n_alive == S * per_species, f"{label}: the alive count changed")
    check(out["dropped"] == 0, f"{label}: re-bucketing dropped particles")
    ke = out["kinetic"].sum(axis=1)
    pe = out["potential"]
    finite = bool(all(math.isfinite(v) for v in list(ke) + list(pe)))
    check(finite and len(ke) == steps + 1, f"{label}: non-finite energies")
    etot = ke + pe
    drift = abs(etot[-1] - etot[0]) / abs(etot[0])
    print(f"  total energy {etot[0]:.9g} -> {etot[-1]:.9g}: relative change "
          f"{drift:.3e} (limit {ENERGY_DRIFT})", flush=True)
    check(drift <= ENERGY_DRIFT, f"{label}: total energy drifted")
    steps_s = out["step_seconds"][1:]
    step_s = float(sum(steps_s) / len(steps_s))
    slow = sorted(range(len(steps_s)), key=lambda i: -steps_s[i])[:3]
    print("  slowest steps (host clock, re-bucket and retune included): "
          + ", ".join(f"step {i + 2} {steps_s[i] * 1e3:.3f} ms" for i in slow),
          flush=True)
    print(f"  per-step wall {step_s * 1e3:.3f} ms (mean of steps 2-{steps}, "
          f"re-buckets included; median "
          f"{sorted(steps_s)[len(steps_s) // 2] * 1e3:.3f} ms), "
          f"{S * per_species / step_s:.4e} particle-steps/s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card})", flush=True)
    return sim, step_s * 1e3, S * per_species / step_s


def step_breakdown(sim, card: str) -> None:
    """Phase 4: device time of each part of one step of the main path, by
    CUDA events, on the final state of phase 3 (the calls the step makes,
    with its arguments), and each species' sort re-bucket."""
    import torch
    from pinc_tpu_torch.grid import gradient
    from pinc_tpu_torch.ops import field_kernels as fk
    from pinc_tpu_torch.ops import tiled_kernels as tk
    st, ts = sim.state, sim.ts
    S = st.lpos.shape[0]
    mdt = sim._mxu_dtype

    def moves():
        return [tk.deposit_move(st.lpos[s], st.vel[s], st.alive[s],
                                sim._charge[s], ts, mxu_dtype=mdt,
                                order=sim._distr_order) for s in range(S)]

    def kicks():
        return [tk.gather_kick(ep5, moved[s][1], st.vel[s], st.alive[s],
                               sim._qm[s], ts, mxu_dtype=mdt,
                               order=sim._acc_order, e_ext=sim._e_ext,
                               boris=sim._boris(s)) for s in range(S)]

    moved = moves()
    tiles = sum(m[0] for m in moved)
    rho = fk.fold_global(tiles, ts).to(sim.spec.dtype)
    phi = sim.solver(rho)
    E = -gradient(phi)
    ep5 = sim._field_tiles(E)
    vels = [k[0] for k in kicks()]
    # name: (fn, reps, re-bucket cadence or None)
    parts = {
        "whole step (no re-bucket)": (lambda: sim._tiled_step_fused(st), 5,
                                      None),
        f"K2 deposit_move x {S}": (moves, 10, None),
        "K7 fold_global": (lambda: fk.fold_global(tiles, ts), 10, None),
        "FFT solve": (lambda: sim.solver(rho), 10, None),
        "gradient": (lambda: gradient(phi), 10, None),
        "pad E tiles": (lambda: sim._field_tiles(E), 10, None),
        f"K4 gather_kick x {S}": (kicks, 10, None),
        "state stacking (lpos, vel)": (
            lambda: (torch.stack([m[1] for m in moved]), torch.stack(vels)),
            10, None),
    }
    print(f"phase 4 step breakdown, CUDA events ({card}):", flush=True)
    for name, (fn, reps, every) in parts.items():
        ms = cuda_ms(fn, reps=reps, warmup=1)
        print(f"  {name}: {ms:.4f} ms", flush=True)
    del moved, tiles, rho, phi, E, ep5, vels
    # each species' re-bucket, on its state drifted by one cadence (the
    # final state was just re-bucketed), each call on a fresh copy
    for s in range(S):
        R = sim.rebucket_every_s[s]
        drifted = st.lpos[s] + float(R) * st.vel[s]
        for mode in ("exchange", "sort"):
            sim._rebucket_mode = mode
            ms = cuda_ms_fresh(
                lambda: (drifted.clone(), st.vel[s].clone(),
                         st.alive[s].clone()), sim._rebucket_one, reps=3)
            print(f"  {mode} re-bucket, species {s}: {ms:.4f} ms, every {R} "
                  f"steps: {ms / R:.4f} ms/step", flush=True)
        sim._rebucket_mode = "exchange"
        del drifted
    exchange_profile(sim, card)
    torch.cuda.empty_cache()


def exchange_profile(sim, card: str) -> None:
    """Device time by operation of one electron exchange re-bucket, on the
    state drifted by one cadence, by torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st = sim.state
    drifted = st.lpos[0] + float(sim.rebucket_every_s[0]) * st.vel[0]

    def fresh():
        return drifted.clone(), st.vel[0].clone(), st.alive[0].clone()
    sim._rebucket_one(*fresh())
    args = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._rebucket_one(*args)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"  exchange re-bucket, species 0, by torch.profiler: {total:.4f} "
          f"ms of device time in {sum(r[2] for r in rows)} device "
          f"operations ({card}); the largest:", flush=True)
    for key, ms, count in rows[:14]:
        print(f"    {ms:.4f} ms  x{count}  {key[:90]}", flush=True)
    del drifted, args


def scan_deck(vth: str, rebucket=None) -> str:
    """bench.py's deck with the given thermal velocities (and a pinned
    uniform re-bucket cadence, as bench.py's aux deck)."""
    deck = BENCH_DECK.replace("thermalVelocity = 0.02,0.0005",
                              f"thermalVelocity = {vth}")
    if rebucket:
        deck += f"rebucketEvery = {rebucket}\n"
    return deck


def run_scan(label: str, deck: str, modules, card: str, expect: dict,
             route: str = "gather"):
    """Phase 5: the window bench.py:bench_pic times, through
    TiledSimulation.make_scan_steps(steps, donate=True, fresh=True) on the
    card: one untimed warm window, then a timed one, with the launch counts
    set to 0 just before each and read just after.  Returns (sim, state,
    result)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sim = TiledSimulation(PincConfig.from_string(deck), seed=1)
    carry = sim.state
    sim.state = None
    S = carry.alive.shape[0]
    n_particles = int((carry.alive > 0.5).sum())
    Rs = sim.rebucket_every_s
    Ri, Re = max(Rs), min(Rs)
    steps = SCAN_STEPS
    if Ri % Re == 0 and Ri <= 400:
        steps = Ri * max(1, round(steps / Ri))
    run_n = sim.make_scan_steps(steps, donate=True, fresh=True)
    sched = any(m is not None for kind, m in run_n.plan if kind == "step")
    events = [a for kind, a in run_n.plan if kind == "rebucket"]
    n_events = sum(len(a) for a in events)
    print(f"phase 5 {label}: M={sim.ts.M}, cadences {Rs}, window {steps} "
          f"steps, margin schedule {'on' if sched else 'off'}, "
          f"{n_events} species re-bucket events a window, {sim.ts.ntiles} "
          f"tiles of {sim.ts.T}^3, B={sim.ts.B}, face cap "
          f"{sim._exchange_cap}, rows {sim._exchange_rows}, "
          f"{n_particles} particles, set-up {time.monotonic() - t0:.1f} s",
          flush=True)
    got = dict(M=sim.ts.M, cadences=list(Rs), steps=steps, sched=sched,
               B=sim.ts.B)
    check(all(got[k] == v for k, v in expect.items()),
          f"{label}: derived {got}, expected {expect}")
    for window in ("warm", "timed"):
        for m in modules:
            m.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        carry, (ke, pe, dropped) = run_n(carry)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
        print(f"  {window} window: {wall:.3f} s, launches {launches}",
              flush=True)
        want = {"deposit": S, "pic_step": steps, "fold_global": steps + 1,
                "efield_tiles": steps + 1}
        want.update({k: n * n_events for k, n in ROUTE_CALLS[route].items()})
        check({k: v for k, v in launches.items() if v} == want,
              f"{label} {window}: launches {launches}, expected {want}")
        on_card = all(t.is_cuda for t in (carry.lpos, carry.vel, carry.alive,
                                          ke, pe, dropped))
        check(on_card, f"{label}: a tensor of the window left the card")
        n_alive = int((carry.alive > 0.5).sum())
        check(int(dropped) == 0, f"{label} {window}: {int(dropped)} dropped")
        check(n_alive == n_particles, f"{label} {window}: alive "
              f"{n_particles} -> {n_alive}")
        ke_np, pe_np = ke.cpu().numpy(), pe.cpu().numpy()
        etot = ke_np.sum(axis=1) + pe_np
        finite = bool(torch.isfinite(ke).all() and torch.isfinite(pe).all())
        check(finite and ke_np.shape == (steps, S),
              f"{label} {window}: non-finite energies")
        drift = abs(etot[-1] - etot[0]) / abs(etot[0])
        check(drift <= ENERGY_DRIFT, f"{label} {window}: total energy "
              f"drifted {drift:.3e}")
    res = dict(wall=wall, steps=steps, ms_step=wall / steps * 1e3,
               psteps=n_particles * steps / wall, launches=launches,
               drift=drift, n_particles=n_particles, events=n_events,
               peak=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  timed window: {res['ms_step']:.4f} ms/step, "
          f"{res['psteps']:.4e} particle-steps/s; state on cuda; 0 "
          f"dropped; alive {n_alive} of {n_particles}; total energy "
          f"{etot[0]:.9g} -> {etot[-1]:.9g}: relative change {drift:.3e} "
          f"(limit {ENERGY_DRIFT}); peak device memory {res['peak']:.2f} GiB "
          f"({card})", flush=True)
    return sim, carry, res


def mega_breakdown(sim, st, card: str) -> None:
    """Device time of each part of one mega step (CUDA events) on the
    window's final state, and each species' exchange re-bucket on it
    drifted by one cadence."""
    import torch
    from pinc_tpu_torch.grid import potential_energy
    from pinc_tpu_torch.ops import field_kernels as fk
    from pinc_tpu_torch.ops import tiled_kernels as tk
    ts, mdt = sim.ts, sim._mxu_dtype
    S = st.lpos.shape[0]
    print(f"  mega step breakdown, CUDA events ({card}):", flush=True)
    # the exchanges first: the window's final state is freshly re-bucketed,
    # and the timed steps below move it in place
    for s in range(S):
        R = sim.rebucket_every_s[s]
        drifted = st.lpos[s] + float(R) * st.vel[s]
        ms = cuda_ms_fresh(lambda: (drifted.clone(), st.vel[s].clone(),
                                    st.alive[s].clone()),
                           sim._rebucket_one, reps=3)
        print(f"    exchange re-bucket, species {s}: {ms:.4f} ms, every {R} "
              f"steps: {ms / R:.4f} ms/step", flush=True)
        del drifted
    mass = torch.tensor(sim._mass, dtype=torch.float32,
                        device=st.lpos.device)
    rho0 = sim._deposit_rho(st)
    E = fk.efield_tiles(sim.solver(rho0), ts, out_dtype=mdt)

    def k5():
        return tk.pic_step(E, st.lpos, st.vel, st.alive, sim._charge,
                           sim._qm, ts, mxu_dtype=mdt,
                           order_acc=sim._acc_order,
                           order_distr=sim._distr_order, e_ext=sim._e_ext,
                           boris_T=sim._boris_T, boris_S=sim._boris_S,
                           inplace=True)
    tiles, _, _, vdot, _ = k5()
    rho = fk.fold_global(tiles, ts)
    phi = sim.solver(rho)

    def whole():
        t, _, _, vd, _ = k5()
        r = fk.fold_global(t, ts)
        p = sim.solver(r)
        return (fk.efield_tiles(p, ts, out_dtype=mdt), potential_energy(r, p),
                0.5 * mass * vd)
    parts = {
        "whole mega step (no re-bucket)": whole,
        f"K5 pic_step ({S} species, in place)": k5,
        "K7 fold_global": lambda: fk.fold_global(tiles, ts),
        "FFT solve": lambda: sim.solver(rho),
        "K6 efield_tiles": lambda: fk.efield_tiles(phi, ts, out_dtype=mdt),
        "energy sums (0.5 m vdot, 0.5 sum rho phi)": lambda: (
            0.5 * mass * vdot, potential_energy(rho, phi)),
    }
    for name, fn in parts.items():
        print(f"    {name}: {cuda_ms(fn, reps=10, warmup=2):.4f} ms",
              flush=True)
    del tiles, rho, phi, E, rho0
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pinc_tpu_torch.__main__ import main as cli_main
    from pinc_tpu_torch.ops import _cuda_build
    from pinc_tpu_torch.ops import exchange as ex
    from pinc_tpu_torch.ops import field_kernels as fk
    from pinc_tpu_torch.ops import gather_exchange as gx
    from pinc_tpu_torch.ops import onehot_exchange as ox
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.ops.tiled import TileSpec, bucket

    card = card_line()
    print(card, flush=True)
    check("H100" in card, f"expected an H100, nvidia-smi says {card!r}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.monotonic()
    lib = _cuda_build.build(verbose=True)
    _cuda_build.load()
    print(f"phase 1 build: {lib.name} with {_cuda_build.nvcc_path()} "
          f"({_cuda_build.build_seconds:.1f} s nvcc, "
          f"{time.monotonic() - t0:.1f} s total)", flush=True)

    # -- phase 2: kernels vs plain versions on the card -------------------
    print(f"phase 2 kernels vs plain (deposit err <= {DEPOSIT_RTOL}*max, "
          f"field/velocity err <= {FIELD_ATOL}, n_out exact, vdot rel <= "
          f"{VDOT_RTOL}; exchange kernels bit-equal):", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    errs = {k: 0.0 for k in tk.LAUNCHES}
    kicks = {"leapfrog": dict(), "boris": dict(
        boris=((0.01, -0.02, 0.03), (0.0199, -0.0398, 0.0597))),
        "e_ext": dict(e_ext=(0.05, 0.0, -0.02))}
    # the test fixture: 3000 uniform particles on 16^3, T=4, M=1, B=128,
    # bucketed on the card
    fx = TileSpec(grid=(16, 16, 16), T=4, M=1, B=128)
    pos = torch.rand((3000, 3), generator=gen, device=dev) * 16
    alive = torch.ones(3000, dtype=torch.bool, device=dev)
    alive[::13] = False
    lp, _, la, _ = bucket(pos, torch.zeros_like(pos), alive, fx)
    small = dict(xyz=lp.permute(2, 0, 1).contiguous(),
                 vel=0.3 * torch.randn((3, fx.NT, fx.B), generator=gen,
                                       device=dev),
                 alive=la.float(),
                 field=torch.randn((fx.NT, fx.P, fx.P, fx.P, 3),
                                   generator=gen, device=dev))
    for mdt in (torch.float32, torch.bfloat16):
        for order in (1, 0):
            compare(tk, fx, small, mdt, order, 1.3, -0.37, kicks, errs,
                    f"fixture {str(mdt)[6:]} order {order}")
    # K5 at the fixture: two species (tests/test_torch_pic_step.py's), f32
    # and bf16, CIC and NGP, leapfrog, Boris and e_ext, full margins and a
    # scheduled pair; then at M = 2 with tests/test_margin_schedule.py's
    # margin sets on a state inside each set's envelope
    two = dict(E=torch.randn((fx.NT, 3 * fx.P, fx.P ** 2), generator=gen,
                             device=dev),
               lpos=torch.stack([small["xyz"], small["xyz"] + 0.01]),
               vel=torch.stack([small["vel"], -small["vel"]]),
               alive=torch.stack([small["alive"], small["alive"]]))
    for mdt in (torch.float32, torch.bfloat16):
        compare_step(tk, fx, two, mdt, [(1, 1), (0, 0)], STEP_KICKS,
                     [None, ((1, 1), (0, 1))], (-1.0, 1.5), (-0.5, 0.25),
                     errs, f"fixture {str(mdt)[6:]}")
    fx2 = TileSpec(grid=(16, 16, 16), T=4, M=2, B=128)
    for margins in MARGIN_SETS:
        d2 = step_inputs(fx2, gen, dev, 0.05, 0.7,
                         wander=0.4 if min(m for m, _ in margins) else 0.0)
        for mdt in (torch.float32, torch.bfloat16):
            compare_step(tk, fx2, d2, mdt, [(1, 1)], {"leapfrog": dict()},
                         [margins], (-1.0, 1.0), (-1.0, 1.0 / 1836.0), errs,
                         f"fixture M=2 {str(mdt)[6:]}")
    # K6 and K7 at tests/test_pallas_field.py's grid, M = 1 and 2, and a
    # T <= 2M+1 layout (tiles that overlap from both sides)
    for fts in (TileSpec(grid=(16, 24, 32), T=8, M=1, B=128),
                TileSpec(grid=(16, 24, 32), T=8, M=2, B=128),
                TileSpec(grid=(16, 8, 24), T=4, M=2, B=128)):
        compare_field(fk, fts, gen, dev, errs,
                      f"fixture {fts.grid} T={fts.T} M={fts.M}")
    errs = {k: 0.0 for k in tk.LAUNCHES}
    # the production shape of the bench deck: M=1 (derived from its
    # electron thermal velocity), B=17408, 16384 live slots per tile on
    # average; charge and q/m of its electrons
    prod = TileSpec(grid=(128, 128, 128), T=8, M=1, B=17408)
    xyz, vel, palive, field = inputs(prod, gen, dev, 0.05, 16384 / 17408)
    big = dict(xyz=xyz, vel=vel, alive=palive, field=field)
    q_e = -0.2 ** 2 * 128 ** 3 / (32 * 128 ** 3)
    for mdt in (torch.float32, torch.bfloat16):
        compare(tk, prod, big, mdt, 1, q_e, -1.0,
                {"leapfrog": dict()}, errs,
                f"production {prod.NT}x{prod.B} {str(mdt)[6:]}")

    mdt = torch.bfloat16
    value = palive * q_e
    timed = {
        "deposit": (lambda: tk.deposit(xyz, value, prod, mxu_dtype=mdt),
                    lambda: tk.deposit_plain(xyz, value, prod,
                                             mxu_dtype=mdt)),
        "deposit_move": (
            lambda: tk.deposit_move(xyz, vel, palive, q_e, prod,
                                    mxu_dtype=mdt),
            lambda: tk.deposit_move_plain(xyz, vel, palive, q_e, prod,
                                          mxu_dtype=mdt)),
        "gather": (lambda: tk.gather(field, xyz, prod, mxu_dtype=mdt),
                   lambda: tk.gather_plain(field, xyz, prod, mxu_dtype=mdt)),
        "gather_kick": (
            lambda: tk.gather_kick(field, xyz, vel, palive, -1.0, prod,
                                   mxu_dtype=mdt),
            lambda: tk.gather_kick_plain(field, xyz, vel, palive, -1.0, prod,
                                         mxu_dtype=mdt)),
    }
    # bytes each call must move: the slot planes it reads and writes and
    # the padded tile blocks (P^3 floats per tile, 3 per field node)
    slots, blk = prod.NT * prod.B, prod.NT * prod.P ** 3 * 4
    bounds = {"deposit": bound_ms(slots * 16 + blk),
              "deposit_move": bound_ms(slots * 40 + blk + prod.NT * 4),
              "gather": bound_ms(slots * 24 + 3 * blk),
              "gather_kick": bound_ms(slots * 40 + 3 * blk + prod.NT * 4)}
    times = {}
    for name, (kern, plain) in timed.items():
        ms = cuda_ms(kern, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        times[name] = (ms, plain_ms)
        print(f"  time {name} at {prod.NT}x{prod.B} bf16: kernel {ms:.4f} ms,"
              f" plain {plain_ms:.4f} ms, bound {bounds[name]:.4f} ms "
              f"({card})", flush=True)
    del xyz, vel, palive, field, big, value, timed
    torch.cuda.empty_cache()
    # K5, K6, K7 at the production shapes of phase 5's two decks: M = 1
    # (the aux deck) and M = 2 (the headline deck); electrons and ions of
    # the bench deck
    prods = {M: TileSpec(grid=(128, 128, 128), T=8, M=M, B=17408)
             for M in (1, 2)}
    step_times = {M: time_step_and_field(tk, fk, ts, gen, dev, card,
                                         (q_e, -q_e), (-1.0, 1.0 / 1836.0),
                                         errs)
                  for M, ts in prods.items()}
    for name, (ms, plain_ms, bound) in step_times[2].items():
        times[name], bounds[name] = (ms, plain_ms), bound
    check_exchange_fixture(gx, ex, gen, dev)
    check_exchange_bench(gx, ex, prod, gen, dev, card, times, bounds)
    check_onehot_fixture(ox, gx, ex, gen, dev)
    check_onehot_bench(ox, ex, gen, dev, card, times, bounds)
    # the exchange kernels are checked bit-equal (bit pattern for K11)
    errs.update({k: 0.0 for m in (gx, ox) for k in m.LAUNCHES})

    # -- phase 3: the main path through the CLI, default re-bucket --------
    modules = (tk, fk, gx, ox)
    res = run_main_path(cli_main, modules, [], MAIN_STEPS)
    launches = res[2]
    sim, run_ms, run_psteps = check_main_path(
        "exchange run (default)", *res, MAIN_STEPS, prod, card, "gather")
    # -- phase 4: where the time of a step goes ---------------------------
    step_breakdown(sim, card)
    del sim, res
    torch.cuda.empty_cache()
    # -- phase 3, again: the sort re-bucket -------------------------------
    res = run_main_path(cli_main, modules, ["tiles:rebucket=sort"],
                        SORT_STEPS)
    check_main_path("sort run", *res, SORT_STEPS, prod, card, "sort")
    del res
    torch.cuda.empty_cache()
    # -- phase 3, again: the one-hot exchange decks (K11) ----------------
    onehot_runs = {}
    for route in ("onehot_rows", "onehot_tile"):
        res = run_main_path(cli_main, modules, [], MAIN_STEPS,
                            deck_text=onehot_deck(route))
        _, ms_step, psteps = check_main_path(
            f"{route} run ({ONEHOT_PC} pc, slack "
            f"{ONEHOT_SLACK[route] or 'default'})", *res, MAIN_STEPS,
            TileSpec(grid=(128, 128, 128), T=8, M=2, B=ONEHOT_B[route]),
            card, route)
        onehot_runs[route] = (ms_step, psteps)
        # K11 runs on these decks: its launches are their runs'
        launches.update({k: res[2][k] for k in ROUTE_CALLS[route]})
        del res
        torch.cuda.empty_cache()

    # -- phase 5: the scan window bench.py times, on the card -------------
    scans = {}
    for key, label, deck, M in (
            ("headline", f"headline deck (vth {HEADLINE_VTH})",
             scan_deck(HEADLINE_VTH), 2),
            ("aux", f"aux deck (phase 3's, rebucketEvery {AUX_REBUCKET})",
             scan_deck("0.02,0.0005", AUX_REBUCKET), 1),
            ("onehot_rows", f"one-hot deck ({ONEHOT_PC} pc, default slack: "
             f"B = {ONEHOT_B['onehot_rows']})", onehot_deck("onehot_rows"),
             2)):
        B = ONEHOT_B[key] if key in ONEHOT_B else prods[M].B
        sim, st, scans[key] = run_scan(label, deck, modules, card,
                                       dict(M=M, B=B, sched=M >= 2),
                                       route=key if key in ONEHOT_B
                                       else "gather")
        mega_breakdown(sim, st, card)
        del sim, st
        torch.cuda.empty_cache()
    one = scans["onehot_rows"]
    print(f"  one-hot deck on this card: scan window {one['ms_step']:.4f} "
          f"ms/step, {one['psteps']:.4e} particle-steps/s, "
          f"{one['events']} species events a window; run() "
          + ", ".join(f"{r} {v[0]:.4f} ms/step ({v[1]:.4e} particle-steps/s)"
                      for r, v in onehot_runs.items()) + f" ({card})",
          flush=True)
    aux = scans["aux"]
    print(f"  aux deck on this card: scan window {aux['ms_step']:.4f} "
          f"ms/step, {aux['psteps']:.4e} particle-steps/s; phase 3's run() "
          f"{run_ms:.4f} ms/step, {run_psteps:.4e} particle-steps/s "
          f"({card})", flush=True)
    # K5-K7 run on the scan path: their launches are the headline window's
    for name in ("pic_step", "efield_tiles", "fold_global"):
        launches[name] = scans["headline"]["launches"][name]

    rows = [{"name": name, "route": "cuda",
             "source": getattr(m, "SOURCES", {}).get(name, m.SOURCE),
             "replaces": m.REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name],
             "bound_by": "bytes", "library_ms": None}
            for m in modules for name in m.LAUNCHES]
    check(len(rows) == 15 and all(r["launches"] > 0 for r in rows),
          f"expected 15 kernels, each launched on its path: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
