#!/usr/bin/env python3
"""Smoke run of pinc_tpu_torch on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Builds the CUDA kernels from pinc_tpu_torch/csrc with nvcc (one nvcc
   per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card and
   times both by CUDA events: deposit, deposit_move, gather, gather_kick at
   the test fixture's size and at the bench deck's production shape (128^3
   grid: 4096 tiles of 8^3 cells, margin 1, 17,408 slots), with f32 and
   bf16 weights; the exchange kernels extract, cleanup and merge at the
   fixture size (with forced overflow, spill and drops) and at the
   production shape, on the calls one whole exchange makes on a bucketed
   state moved by one K2 drift of bench-like velocities (bit for bit).  It
   also times one whole exchange re-bucket per species.
3. Runs the CLI entry point, pinc_tpu_torch.__main__.main, on bench.py's
   deck (128^3, 2 x 67,108,864 particles, sSolve, puAcc3D1KE, puDistr3D1,
   tiles 8 / bf16 / slack 1.0625) with methods:layout=tiled: 20 steps with
   the default re-bucket (the gather exchange), then 10 steps with
   tiles:rebucket=sort.  For each run it checks that every kernel of its
   path ran (the launch counts are set to 0 just before the run and read
   just after), that the state stayed on the card, that no particle was
   lost or dropped, and that the energies are finite and conserved.
4. Times each part of one step of the exchange run (the two kernel pairs,
   fold, FFT solve, gradient, E padding, state stacking, and each
   species' exchange and sort re-bucket of a state moved by one cadence)
   with CUDA events, and the device time of one electron exchange by
   operation with torch.profiler.

Every phase that fails exits non-zero.  Without a CUDA card the script
exits non-zero before printing any result.  The line before the last is a
JSON object with each kernel's numbers (launches on the exchange run of
phase 3, max error against the plain version, kernel and plain ms, and
bound_ms: the bytes the call must move at 3.35 TB/s, from this run's
inputs); the last line is
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
MAIN_STEPS = 20        # two electron re-bucket events (cadence 10) on this deck
SORT_STEPS = 10        # one electron event with tiles:rebucket=sort
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet

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


def same(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a, b)


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


def bench_species(prod, gen, dev, vth: float, cadence: int, q: float):
    """A bucketed species at the production layout, moved by one K2 drift
    of cadence x its velocities: 16,384 uniform particles per tile on
    average, velocities N(0, vth).  Returns (alive, 6 planes)."""
    import torch
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.ops.tiled import bucket
    n = 16384 * prod.NT
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


def capture_exchange(gx, ex, alive, planes, ntiles, T, K):
    """Run one exchange and record each kernel call's inputs (cloned, since
    the merge writes in place).  Returns {kernel: [(fn, plain, args)]}."""
    calls = {"extract": [], "cleanup": [], "merge": []}
    names = {"extract_compact_rows_g": "extract", "cleanup_rows_g": "cleanup",
             "merge_rows_g": "merge"}
    orig = {n: getattr(gx, n) for n in names}

    def spy(n):
        def fn(*args, **kw):
            args = args + tuple(kw.values())
            calls[names[n]].append((orig[n], getattr(gx, n + "_plain"),
                                    fresh_copy(args)))
            return orig[n](*args)
        return fn
    try:
        for n in names:
            setattr(gx, n, spy(n))
        ex.rebucket_exchange_planes(tuple(p.clone() for p in planes),
                                    alive.clone(), ntiles, T, K=K, rows=True)
    finally:
        for n, f in orig.items():
            setattr(gx, n, f)
    return calls


def exchange_bytes(kind: str, args, out) -> float:
    """Bytes the call must move (each input read once, each output written
    once; where the work depends on the data, what this data needs)."""
    import torch
    if kind == "extract":
        alive, planes = args[0], args[1]
        buf, alive2 = out
        leavers = float((alive > 0.5).sum() - (alive2 > 0.5).sum())
        return alive.numel() * 20.0 + leavers * 12.0 + buf.numel() * 4.0
    if kind == "cleanup":
        inc = args[0]
        settled, extras = out
        valid = float((inc[:, 6] > 0.5).sum())
        return (inc[:, 6].numel() * 4.0 + valid * 24.0
                + (settled.numel() + sum(e.numel() for e in extras)) * 4.0)
    alive, inc = args[0], args[1]                      # merge
    NT, B = alive.shape
    free = (alive <= 0.5).reshape(NT, 8, B // 8)
    need = torch.minimum((inc[:, 6] > 0.5).sum(-1), free.sum(-1))
    prefix = (torch.cumsum(free, -1) < need[..., None]).sum(-1) + (need > 0)
    placed = float((out[1] > 0.5).sum() - (alive > 0.5).sum())
    return (float(prefix.sum()) * 4.0 + inc[:, 6].numel() * 4.0
            + placed * 52.0)


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
    for kind, recorded in calls.items():
        ms = plain_ms = nbytes = 0.0
        for fn, plain, args in recorded:
            def fresh(args=args):
                return fresh_copy(args)
            out = fn(*fresh())
            got, want = leaves(out), leaves(plain(*fresh()))
            check(len(got) == len(want) and all(map(same, got, want)),
                  f"{kind} at {prod.NT}x{prod.B}: differs from its plain "
                  f"version")
            nbytes += exchange_bytes(kind, args, out)
            if kind == "merge":
                ms += cuda_ms_fresh(fresh, fn, reps=10)
                plain_ms += cuda_ms_fresh(fresh, plain, reps=2)
            else:
                ms += cuda_ms(lambda: fn(*args), reps=10, warmup=2)
                plain_ms += cuda_ms(lambda: plain(*args), reps=2, warmup=1)
        n = len(recorded)
        times[kind] = (ms / n, plain_ms / n)
        bounds[kind] = bound_ms(nbytes / n)
        print(f"  time {kind} at {prod.NT}x{prod.B} ({caps}; mean of {n} "
              f"call(s) of one electron exchange): kernel {ms / n:.4f} ms, "
              f"plain {plain_ms / n:.4f} ms, bound {bounds[kind]:.4f} ms "
              f"({card})", flush=True)
    del calls
    for name, (vth, cadence, q) in species.items():
        if name != "electrons":
            del alive, planes
            torch.cuda.empty_cache()
            alive, planes = bench_species(prod, gen, dev, vth, cadence, q)
        leavers = int(((alive > 0.5) & torch.stack(
            [(c < 0) | (c >= prod.T) for c in planes[:3]]).any(0)).sum())
        ms = cuda_ms_fresh(
            lambda: (tuple(p.clone() for p in planes), alive.clone()),
            lambda p, a: ex.rebucket_exchange_planes(
                p, a, prod.ntiles, prod.T, K=K, rows=True), reps=5)
        print(f"  time whole exchange re-bucket, {name} (vth {vth}, one "
              f"{cadence}-step drift, {leavers} leavers = "
              f"{leavers / float(alive.sum()):.4%}): {ms:.4f} ms ({card})",
              flush=True)
    del alive, planes
    torch.cuda.empty_cache()


def run_main_path(cli_main, kernel_modules, extra, steps: int):
    """The CLI on the bench deck; the launch counts are set to 0 just
    before and read just after.  Returns (rc, out, launches, wall s)."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "bench128.ini")
        with open(deck, "w") as f:
            f.write(BENCH_DECK)
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
                    mode: str):
    """The checks of phase 3 on one run."""
    import torch
    check(rc == 0, f"{label}: the CLI returned {rc}")
    sim = out["sim"]
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
    check(sim._rebucket_mode == mode and sim._exchange_cap == 256
          and sim._exchange_rows,
          f"{label}: expected the {mode} re-bucket with face cap 256 and "
          f"the row gate true (the caps phase 2 used)")
    print(f"  launches: {launches}", flush=True)
    check(all(launches[k] > 0 for k in
              ("deposit", "gather", "deposit_move", "gather_kick")),
          f"{label}: a kernel of the step never launched: {launches}")
    check(launches["deposit_move"] == S * steps
          and launches["gather_kick"] == S * steps,
          f"{label}: deposit_move/gather_kick ran {launches}, expected {S} "
          f"per step")
    events = sum(steps // R for R in sim.rebucket_every_s)
    check(events >= 1 and out["n_lost"] == 0,
          f"{label}: {events} re-bucket events, {out['n_lost']} margin hits")
    ex_launches = [launches[k] for k in ("extract", "cleanup", "merge")]
    if mode == "exchange":
        check(ex_launches == [events, 3 * events, events] and events >= 2,
              f"{label}: extract/cleanup/merge ran {ex_launches}, expected "
              f"(1, 3, 1) x {events} events")
    else:
        check(ex_launches == [0, 0, 0],
              f"{label}: the sort run launched exchange kernels")
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
    print(f"  per-step wall {step_s * 1e3:.3f} ms (mean of steps 2-{steps}, "
          f"re-buckets included; median "
          f"{sorted(steps_s)[len(steps_s) // 2] * 1e3:.3f} ms), "
          f"{S * per_species / step_s:.4e} particle-steps/s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card})", flush=True)
    return sim


def step_breakdown(sim, card: str) -> None:
    """Phase 4: device time of each part of one step of the main path, by
    CUDA events, on the final state of phase 3 (the calls the step makes,
    with its arguments), and each species' sort re-bucket."""
    import torch
    from pinc_tpu_torch.grid import gradient
    from pinc_tpu_torch.ops import tiled as tl
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
    tiles = sum(m[0] for m in moved).reshape((ts.NT,) + (ts.P,) * 3)
    rho = tl.fold_to_global(tiles, ts).to(sim.spec.dtype)
    phi = sim.solver(rho)
    E = -gradient(phi)
    ep5 = sim._field_tiles(E)
    vels = [k[0] for k in kicks()]
    # name: (fn, reps, re-bucket cadence or None)
    parts = {
        "whole step (no re-bucket)": (lambda: sim._tiled_step_fused(st), 5,
                                      None),
        f"K2 deposit_move x {S}": (moves, 10, None),
        "fold": (lambda: tl.fold_to_global(tiles, ts), 10, None),
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pinc_tpu_torch.__main__ import main as cli_main
    from pinc_tpu_torch.ops import _cuda_build
    from pinc_tpu_torch.ops import exchange as ex
    from pinc_tpu_torch.ops import gather_exchange as gx
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
    check_exchange_fixture(gx, ex, gen, dev)
    check_exchange_bench(gx, ex, prod, gen, dev, card, times, bounds)
    errs.update({k: 0.0 for k in gx.LAUNCHES})      # checked bit-equal

    # -- phase 3: the main path through the CLI, default re-bucket --------
    modules = (tk, gx)
    res = run_main_path(cli_main, modules, [], MAIN_STEPS)
    launches = res[2]
    sim = check_main_path("exchange run (default)", *res, MAIN_STEPS, prod,
                          card, "exchange")
    # -- phase 4: where the time of a step goes ---------------------------
    step_breakdown(sim, card)
    del sim, res
    torch.cuda.empty_cache()
    # -- phase 3, again: the sort re-bucket -------------------------------
    res = run_main_path(cli_main, modules, ["tiles:rebucket=sort"],
                        SORT_STEPS)
    check_main_path("sort run", *res, SORT_STEPS, prod, card, "sort")
    del res

    rows = [{"name": name, "route": "cuda", "source": m.SOURCE,
             "replaces": m.REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name],
             "bound_by": "bytes", "library_ms": None}
            for m in modules for name in m.LAUNCHES]
    check(len(rows) == 7 and all(r["launches"] > 0 for r in rows),
          f"expected 7 kernels, each launched on the main path: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
