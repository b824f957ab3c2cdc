#!/usr/bin/env python3
"""Smoke run of pinc_tpu_torch on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Builds the CUDA kernels from pinc_tpu_torch/csrc with nvcc.
2. Holds each kernel (deposit, deposit_move, gather, gather_kick) against
   its plain PyTorch version on the card, at the test fixture's size and at
   the bench deck's production shape (128^3 grid: 4096 tiles of 8^3 cells,
   margin 1, 17,408 slots), with f32 and bf16 weights, and times both.
3. Runs the CLI entry point, pinc_tpu_torch.__main__.main, on bench.py's
   deck (128^3, 2 x 67,108,864 particles, sSolve, puAcc3D1KE, puDistr3D1,
   tiles 8 / bf16 / slack 1.0625) with methods:layout=tiled and
   tiles:rebucket=sort, and checks that every kernel ran on the main path,
   that the state stayed on the card, that no particle was lost, and that
   the energies are finite and conserved.
4. Times each part of one step of that run (the two kernel pairs, fold,
   FFT solve, gradient, E padding, state stacking, each species' sort
   re-bucket) with CUDA events.

Every phase that fails exits non-zero.  Without a CUDA card the script
exits non-zero before printing any result.  The line before the last is a
JSON object with each kernel's numbers; the last line is
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
# another order, with atomics in the deposits)
DEPOSIT_RTOL = 1e-5    # max |tiles - plain| <= 1e-5 * max |plain|
FIELD_ATOL = 1e-5      # gathered fields and kicked velocities, absolute
VDOT_RTOL = 1e-5       # the kick's sum of alive * vdot
ENERGY_DRIFT = 0.01    # |E_tot(end) - E_tot(0)| / |E_tot(0)| on the main path
MAIN_STEPS = 20        # >= the electrons' re-bucket cadence (10) on this deck

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
    for s in range(S):
        parts[f"sort re-bucket, species {s}"] = (
            lambda s=s: sim._rebucket_one(st.lpos[s], st.vel[s],
                                          st.alive[s]),
            3, sim.rebucket_every_s[s])
    print(f"phase 4 step breakdown, CUDA events ({card}):", flush=True)
    for name, (fn, reps, every) in parts.items():
        ms = cuda_ms(fn, reps=reps, warmup=1)
        extra = ("" if every is None else
                 f", every {every} steps: {ms / every:.4f} ms/step")
        print(f"  {name}: {ms:.4f} ms{extra}", flush=True)
    del moved, tiles, rho, phi, E, ep5, vels
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pinc_tpu_torch.__main__ import main as cli_main
    from pinc_tpu_torch.ops import _cuda_build
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
          f"{VDOT_RTOL}):", flush=True)
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
    times = {}
    for name, (kern, plain) in timed.items():
        ms = cuda_ms(kern, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        times[name] = (ms, plain_ms)
        print(f"  time {name} at {prod.NT}x{prod.B} bf16: kernel {ms:.4f} ms,"
              f" plain {plain_ms:.4f} ms ({card})", flush=True)
    del xyz, vel, palive, field, big, value, timed
    torch.cuda.empty_cache()

    # -- phase 3: the main path through the CLI ---------------------------
    S, per_species = 2, 32 * 128 ** 3
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "bench128.ini")
        with open(deck, "w") as f:
            f.write(BENCH_DECK)
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launches()
        out: dict = {}
        t0 = time.monotonic()
        rc = cli_main([deck, "methods:layout=tiled", "tiles:rebucket=sort",
                       f"time:nTimeSteps={MAIN_STEPS}"], out=out)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(tk.LAUNCHES)
    check(rc == 0, f"the CLI returned {rc}")
    sim = out["sim"]
    print(f"phase 3 main path: {type(sim).__name__}, {sim.ts.ntiles} tiles "
          f"of {sim.ts.T}^3, B={sim.ts.B}, M={sim.ts.M}, re-bucket cadences "
          f"{sim.rebucket_every_s}, {MAIN_STEPS} steps, {wall:.1f} s "
          f"including set-up", flush=True)
    check((sim.ts.T, sim.ts.M, sim.ts.B, sim.ts.NT)
          == (prod.T, prod.M, prod.B, prod.NT),
          f"phase 2 checked the kernels at T={prod.T} M={prod.M} B={prod.B} "
          f"NT={prod.NT}, but the main path derived T={sim.ts.T} "
          f"M={sim.ts.M} B={sim.ts.B} NT={sim.ts.NT}")
    print(f"launches: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(launches["deposit_move"] == S * MAIN_STEPS
          and launches["gather_kick"] == S * MAIN_STEPS,
          f"deposit_move/gather_kick ran {launches}, expected {S} per step")
    check(min(sim.rebucket_every_s) <= MAIN_STEPS,
          "no re-bucket was due within the run")
    st = sim.state
    on_card = all(t.is_cuda for t in (st.lpos, st.vel, st.alive))
    print(f"state on cuda: {on_card}", flush=True)
    check(on_card, "a state tensor left the card")
    n_alive = int((st.alive > 0.5).sum())
    print(f"alive: {n_alive} of {S * per_species}", flush=True)
    check(n_alive == S * per_species, "the alive count changed")
    print(f"re-bucket drops: {out['dropped']}, margin hits: {out['n_lost']}",
          flush=True)
    check(out["dropped"] == 0, "re-bucketing dropped particles")
    ke = out["kinetic"].sum(axis=1)
    pe = out["potential"]
    finite = bool(all(math.isfinite(v) for v in list(ke) + list(pe)))
    print(f"KE, PE finite at every step: {finite}", flush=True)
    check(finite and len(ke) == MAIN_STEPS + 1, "non-finite energies")
    etot = ke + pe
    drift = abs(etot[-1] - etot[0]) / abs(etot[0])
    print(f"total energy {etot[0]:.9g} -> {etot[-1]:.9g}: relative change "
          f"{drift:.3e} (limit {ENERGY_DRIFT})", flush=True)
    check(drift <= ENERGY_DRIFT, "total energy drifted beyond the limit")
    steps = out["step_seconds"][1:]
    step_s = float(sum(steps) / len(steps))
    rate = S * per_species / step_s
    print(f"per-step wall {step_s * 1e3:.3f} ms (mean of steps 2-"
          f"{MAIN_STEPS}, re-buckets included; median "
          f"{sorted(steps)[len(steps) // 2] * 1e3:.3f} ms), "
          f"{rate:.4e} particle-steps/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})",
          flush=True)
    step_breakdown(sim, card)

    rows = [{"name": name, "route": "cuda", "source": tk.SOURCE,
             "replaces": tk.REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1]} for name in tk.LAUNCHES]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
