#!/usr/bin/env python3
"""Smoke run of pinc_tpu_torch on one NVIDIA H100.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Builds the CUDA kernels from pinc_tpu_torch/csrc with nvcc (one nvcc
   per source, all started together), and checks with cuobjdump that the
   density adds of pic_step, deposit and deposit_move compile to native
   integer shared atomics (ATOMS.ADD, no compare-and-swap loop) in every
   instantiation, and that every instantiation of the exchange's
   extract_kernel and cleanup_kernel, of efield_kernel and of fold_kernel
   holds 16-byte global loads and stores (LDG/STG .128), and the merges
   (merge_rows_kernel, both merge_kernel instantiations) 16-byte loads,
   merge_ranked_kernel and extract_ranked_kernel both;
   that both instantiations of the kernel benchmark's given_kron_kernel
   hold tensor-core instructions (HGMMA), and that the shared atomics of
   weight_sums_kernel and of both deposit_variant_kernel instantiations
   (int8, and bf16_native on the int32 pair) are all ATOMS.ADD.
2. Holds each kernel against its plain PyTorch version on the card and
   times both by CUDA events: deposit, deposit_move, gather, gather_kick at
   the test fixture's size and at the bench deck's production shape (128^3
   grid: 4096 tiles of 8^3 cells, margin 1, 17,408 slots), with f32 and
   bf16 weights, deposit and deposit_move launched twice (their integer
   density sums must give bit-identical tiles, deposit's with vmax given
   and read from the values); pic_step at the fixture (f32/bf16, CIC/NGP, leapfrog,
   Boris, e_ext, and tests/test_margin_schedule.py's margin sets at M = 2)
   and at the production shape at M = 1 and M = 2, each launched twice
   (its integer density sums must give bit-identical tiles); efield_tiles
   and fold_global at M = 1, 2 and a T <= 2M+1 layout, and at 128^3 (bit for
   bit; fold_global also at ntz = 5, 1, 2, T = 6 and 3 and M >= T); the
   exchange kernels extract, cleanup and merge at the fixture
   size (with forced overflow, spill and drops) and at the production
   shape, on the calls one whole exchange makes on a bucketed state moved
   by one K2 drift of bench-like velocities (bit for bit), the merge also
   with rows 0-3 of every tile full (its spill passes in every tile); each
   merge prints how many tiles it found with leftovers.  It also times
   one whole exchange re-bucket per species, and the electrons' through
   the one-hot exchange (tiles:exchangeImpl=onehot) in turns with the
   gather.  The one-hot exchange kernels (K11: extract, cleanup and merge
   in each of their modes) are held bit pattern for bit pattern against
   their plain versions at the fixture (leaver caps, edge caps and free
   slots overflowing; B % 8 != 0 for the ranked modes; the drivers against
   the CPU) and on the calls of one exchange at the one-hot decks'
   production shapes (4096 tiles, B = 7680 for the fused row exchange, B =
   6528 for the per-tile sweeps), each timed with its bound (the merges
   also in a CUDA graph), then the merge of that exchange on a fuller
   destination (rows 0-3 of every tile full, or one free slot in 512:
   arrivals drop) and the whole exchange.  The fixture also holds the
   one-hot extracts, cleanup and merges on rows that start off a 16-byte
   boundary (B = 648, cleanup rows of 18, merge runs of 13 columns with
   their flags not a prefix), where the kernels take a scalar head.  The
   ranked modes (pinc_tpu's extract and merge, for B % 8 != 0) are held at
   the fixture (the extract also at B = 101 and 2101 with K2 = 30, 8198
   and 9001: several blocks of 4096 columns, K2 % 4 != 0, alive off
   rank's 16-byte offset) and timed at 4096 x 6524, both also in a CUDA
   graph, the merge against its bound in 32-byte sectors.  Last, the
   extract
   and cleanup calls at the headline scan window's face cap (K = 512, M =
   2, B = 17,408; the gather exchange, the one-hot rows and the per-tile
   sweeps on one state), each against its plain version and timed with
   its bound.
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
   decks only.  The gather run and phase 5's warm windows also count the
   merge calls and tiles whose spill passes run.
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
6. The kernel benchmark (K12 and K13's probes): each mode of the
   variant kernels of csrc/kbench.cu against its plain version at the
   test fixture (M = 1 and 2, B = 256 and 1040), bf16_native, given_kron
   and weight_sums also at 4096 x 9216 at M = 2, bf16_native and
   weight_sums launched twice (the same bits), and each of the four
   exchange-primitive kernels of csrc/kbench_prims.cu (take, roll,
   plane_add, lane_prefix) at the probes' own shapes (kbench.check_prims,
   bit pattern for bit pattern); then pinc_tpu_torch.kbench.run in process
   at the scripts' production shapes (4096 tiles; B = 12288 at M = 1, 2
   for K12 on K1/K3; B = 9216 at M = 1 for the deposit/gather probes;
   4096 x (8, 2176) and 4096 x 9216 for the primitives, and 4096 blocks
   of each take probe's own block), every row against
   its plain version (int8 and the primitives bit for bit), with its time,
   bound, share of the bound and error against K1/K3 bf16 or, for the
   primitives, the time of the one PyTorch call that computes the same
   function; the ceilings' times against K1's and K3's; and given_kron's
   product as one torch.matmul of bf16 operands beside its kernel.
7. Output and checkpoints.  Where h5py is missing (the card's host has
   none), the CLI raises pinc_tpu's "h5py is required" error on each
   output deck (input/langmuirWarm.ini, langmuirCold1D.ini,
   langmuir2D.ini); each deck runs at its size for 20 steps without its
   files:output line; the 32^3 tiled langmuirWarm (tiles:margin = 3)
   resumed at step 10 from the first run's state and tuning
   (TiledSimulation.resume, what a tiled checkpoint file restores) is the
   uninterrupted run bit for bit; the bench deck runs 20 steps with the
   port's io_h5.OutputWriter on files:async = true (its fields every 10
   steps to the native spooler, the energy history to a stand-in), and
   the last written step is read back with read_spool bit for bit.  It
   prints a written step's host time against the unwritten steps' median
   and write_step's own time, counts each tiled run's kernel launches,
   and says that the HDF5 and checkpoint files are checked by the CPU
   tests only.

8. Bounded walls, the multigrid solver, the run modes and the small
   decks.  The multigrid solve (input/maxwellian.ini's [multigrid]: 4
   levels, 15 cycles, 10/10/10 sweeps, tolerance 5e-6) of one seeded rho
   on the card against the port's own CPU solve at 64^3, periodic,
   Dirichlet and Neumann on x with periodic y/z (the same cycle count, phi
   within 1e-4 of max|phi|), then timed at 128^3 by CUDA events: ms a
   solve, ms a V-cycle and a V-cycle's device launches (torch.profiler).
   Deck (a), bench.py's deck with methods:poisson = mgSolve and that
   section, through the CLI for 20 steps with phase 3's checks, then
   make_scan_steps(20, donate=True) with phase 5's (K5, K7, K6 a step, the
   multigrid solve between them).  Decks (b) and (c), deck (a) inside
   Dirichlet and Neumann walls (zero values), 20 steps of run(): K1, K3
   and K7 every step, no K2, K4 or K5, the gather exchange at every species
   event, every particle inside [0, L-1], no drop, alive conserved,
   finite energies.  After each deck's run(), one step split by CUDA
   events (the solve, the kernels, the glue).  Then mgMode at 128^3,
   mgModeErrorScaling at 32^3 (order above 1.5), puModeParticle and
   puModeInterp (their orders) through the CLI; input/maxwellian.ini on
   one subdomain for 5 steps, periodic, in Dirichlet and in Neumann walls;
   langmuirCold1D.ini and langmuir2D.ini on the tiled layout for 20
   steps, re-bucketed every 5 (pinc_tpu's kernel-free route: no kernel
   launches); the bench deck
   under methods:debug = true and population:maxVel = 1 for 5 steps.
   Prints each deck's ms a step beside phase 3's and phase 5's with the
   FFT solve.

Every phase that fails exits non-zero.  Without a CUDA card the script
exits non-zero before printing any result.  The line before the last is a
JSON object with each kernel's numbers (launches on the path that runs
it: phase 3's exchange run, its one-hot runs for the one-hot kernels (the
row kernels the B = 7680 run, the per-tile ones the B = 6528 run), for
pic_step, efield_tiles and fold_global the headline scan window of phase
5, for the kbench kernels (one row a mode) and the four primitives phase
6's benchmark run; max error against the plain version; kernel and plain
ms; bound_ms: the bytes the call must move at 3.35 TB/s, or its
operations at the card's peak rate, from this run's inputs; and
library_ms, the one PyTorch call's time, for the primitives at the
production row named in PRIM_ROWS, None for the others); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
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
# the kernel benchmark's production row of each exchange primitive whose
# numbers go into the kernels line
#: the kbench deposit modes redesigned for Hopper's tensor cores and
#: integer atomics, also held at the production shape at M = 2
REDESIGNED_MODES = ("bf16_native", "given_kron", "weight_sums")
# the kbench deposits whose sums are integers: two launches, the same bits
SAME_BITS_MODES = ("bf16_native", "weight_sums")
PRIM_ROWS = {"kbench_take": "prims take extract",
             "kbench_roll": "prims roll rows p=1",
             "kbench_plane_add": "prims plane_add G=1",
             "kbench_lane_prefix": "prims lane_prefix mask"}

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


def sass_ops(lib_path, kernel: str, pattern: str) -> dict:
    """{SASS op: count} of the instructions matching the regular
    expression pattern in each instantiation of a kernel of the built
    library, by cuobjdump -sass (beside nvcc); {mangled name: {op:
    count}}."""
    import re
    from pinc_tpu_torch.ops import _cuda_build
    cuobjdump = os.path.join(os.path.dirname(_cuda_build.nvcc_path()),
                             "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-500:]}")
    out, name = {}, None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1) if kernel in fn.group(1) else None
            if name:
                out[name] = {}
        elif name:
            op = re.search(pattern, line)
            if op:
                out[name][op.group(1)] = out[name].get(op.group(1), 0) + 1
    return out


def shared_atomics(lib_path, kernel: str) -> dict:
    """The shared-memory atomics (ATOMS*) of each instantiation."""
    return sass_ops(lib_path, kernel, r"\b(ATOMS\S*)")


def wide_accesses(lib_path, kernel: str) -> dict:
    """The 16-byte global loads and stores (LDG/STG ... .128) of each
    instantiation."""
    return sass_ops(lib_path, kernel, r"\b((?:LDG|STG)\.E\S*\.128)\b")


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
    """Each kernel against its plain version on the same CUDA tensors; the
    deposits also against themselves: a second launch on the same input
    gives bit-identical tiles (their density sums are integers), deposit's
    with vmax read from the values instead of given."""
    import torch
    value = d["alive"] * q
    t = tk.deposit(d["xyz"], value, ts, mxu_dtype=mdt, order=order,
                   vmax=abs(q))
    tr = tk.deposit_plain(d["xyz"], value, ts, mxu_dtype=mdt, order=order)
    e = (t - tr).abs().max().item()
    check(e <= DEPOSIT_RTOL * tr.abs().max().item(),
          f"deposit {label}: max err {e} > {DEPOSIT_RTOL} * max|tiles|")
    check(torch.equal(t, tk.deposit(d["xyz"], value, ts, mxu_dtype=mdt,
                                    order=order)),
          f"deposit {label}: a second launch gave other tiles")
    errs["deposit"] = max(errs["deposit"], e)

    t, x, n = tk.deposit_move(d["xyz"], d["vel"], d["alive"], q, ts,
                              mxu_dtype=mdt, order=order)
    tr, xr, nr = tk.deposit_move_plain(d["xyz"], d["vel"], d["alive"], q,
                                       ts, mxu_dtype=mdt, order=order)
    e = (t - tr).abs().max().item()
    check(e <= DEPOSIT_RTOL * tr.abs().max().item(),
          f"deposit_move {label}: tiles max err {e}")
    check(torch.equal(t, tk.deposit_move(d["xyz"], d["vel"], d["alive"], q,
                                         ts, mxu_dtype=mdt, order=order)[0]),
          f"deposit_move {label}: a second launch gave other tiles")
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
    kick tolerances; and against itself: a second launch on the same
    input gives bit-identical tiles (its density sums are integers)."""
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
                check(torch.equal(t, tk.pic_step(*args, **opts)[0]),
                      f"{what}: a second launch gave other tiles")
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
    check(same_bits(fk.fold_global(tiles, ts),
                    fk.fold_global_plain(tiles, ts)),
          f"fold_global {label}: differs from its plain version")
    errs["efield_tiles"] = errs["fold_global"] = 0.0
    torch.cuda.synchronize()
    print(f"  efield_tiles, fold_global {label}: ok (bit-equal)", flush=True)
    return phi, tiles


def compare_fold(fk, ts, gen, dev) -> None:
    """K7 against its plain version, bit for bit."""
    import torch
    tiles = torch.randn((ts.NT, ts.P, ts.P * ts.P), generator=gen, device=dev)
    check(same_bits(fk.fold_global(tiles, ts),
                    fk.fold_global_plain(tiles, ts)),
          f"fold_global {ts.grid} T={ts.T} M={ts.M}: differs from its plain "
          f"version")


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
    from pinc_tpu_torch import kbench
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
        # the field kernels also in a CUDA graph: their launches without
        # the wrapper's host time
        graph = (f", in a CUDA graph {kbench.graph_ms(kern, 20):.4f} ms"
                 if name != "pic_step" else "")
        print(f"  time {name} at {ts.NT}x{ts.B}, M={ts.M} (P={ts.P}) bf16: "
              f"kernel {ms:.4f} ms{graph}, plain {plain_ms:.4f} ms, bound "
              f"{res[name][2]:.4f} ms, {res[name][2] / ms:.1%} of it "
              f"({card})", flush=True)
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
        gx, {"extract_compact_rows_g": "extract", "cleanup_faces_g": "cleanup",
             "cleanup_rows_g": "cleanup", "merge_rows_g": "merge"},
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
        # the outputs the call writes: settled (none for the fused
        # exchange's first cleanup, cleanup_faces_g) and the extras
        inc = args[0]
        valid = float((inc[:, 6] > 0.5).sum())
        return (inc[:, 6].numel() * 4.0 + valid * 24.0
                + sum(t.numel() for t in leaves(out)) * 4.0)
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


def merge_leftovers(alive, inc, blocks):
    """The tiles of one gather merge call (K9) whose pass 0 leaves
    leftovers (a row with more arrivals than free slots), so that its
    spill passes run: a device tensor, read after the run (no host sync
    in the call)."""
    import torch
    NT, B = alive.shape
    cols = torch.zeros(inc.shape[-1], dtype=torch.bool, device=inc.device)
    for o, w in blocks:
        cols[o:o + w] = True
    arrivals = ((inc[:, 6] > 0.5) & cols).sum(-1)                # (NT, 8)
    free = (alive <= 0.5).reshape(NT, 8, B // 8).sum(-1)
    return (arrivals > free).any(-1).sum()


@contextlib.contextmanager
def leftover_spy(gx):
    """gx.merge_rows_g spied: each call appends (its tiles with leftovers,
    a device tensor; its tiles) to the yielded list."""
    seen, orig = [], gx.merge_rows_g

    def spy(alive, inc, planes, blocks):
        seen.append((merge_leftovers(alive, inc, blocks), alive.shape[0]))
        return orig(alive, inc, planes, blocks)
    gx.merge_rows_g = spy
    try:
        yield seen
    finally:
        gx.merge_rows_g = orig


def leftover_text(seen) -> str:
    if not seen:
        return "no K9 merge call"
    lo = [int(n) for n, _ in seen]
    return (f"K9 merge calls whose spill passes run: {sum(map(bool, lo))} "
            f"of {len(lo)}; tiles with leftovers {sum(lo)} of "
            f"{sum(nt for _, nt in seen)}")


def time_calls(calls: dict, where: str, card: str, times: dict,
               bounds: dict, equal=same) -> None:
    """Each recorded call against its plain version (equal), then timed
    (kernel, plain) by CUDA events on fresh copies of its inputs, with its
    bound from the bytes it must move; per kernel the mean over its
    calls."""
    from pinc_tpu_torch import kbench
    for kind, recorded in calls.items():
        ms = plain_ms = nbytes = settled_bytes = graph = 0.0
        leftovers = 0
        for fn, plain, args in recorded:
            def fresh(args=args):
                return fresh_copy(args)
            out = fn(*fresh())
            got, want = leaves(out), leaves(plain(*fresh()))
            check(len(got) == len(want) and all(map(equal, got, want)),
                  f"{kind} at {where}: differs from its plain version")
            nbytes += exchange_bytes(kind, args, out)
            if kind == "merge":
                leftovers += int(merge_leftovers(args[0], args[1], args[3]))
            if fn.__name__ == "cleanup_faces_g":
                # the settled output it no longer writes (inc's shape)
                settled_bytes += args[0].numel() * 4.0
            if "merge" in kind:
                ms += cuda_ms_fresh(fresh, fn, reps=10)
                plain_ms += cuda_ms_fresh(fresh, plain, reps=2)
                graph += kbench.graph_ms_inplace(fn, args)
            else:
                ms += cuda_ms(lambda: fn(*args), reps=10, warmup=2)
                plain_ms += cuda_ms(lambda: plain(*args), reps=2, warmup=1)
        n = len(recorded)
        times[kind] = (ms / n, plain_ms / n)
        bounds[kind] = bound_ms(nbytes / n)
        old = (f" (with the settled output of its first call, as before: "
               f"{bound_ms((nbytes + settled_bytes) / n):.4f} ms)"
               if settled_bytes else "")
        if kind == "merge":
            old += (f" ({leftovers} of {n * args[0].shape[0]} tiles with "
                    f"leftovers)")
        if "merge" in kind:
            old += f", in a CUDA graph {graph / n:.4f} ms"
        print(f"  time {kind} at {where} (mean of {n} call(s) of one "
              f"electron exchange): kernel {ms / n:.4f} ms, plain "
              f"{plain_ms / n:.4f} ms, bound {bounds[kind]:.4f} ms{old}, "
              f"{bounds[kind] / (ms / n):.1%} of it ({card})", flush=True)


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
    # the merge's spill passes at this shape: the same call with rows 0-3
    # of every tile full, so that their arrivals spill into rows 4-7
    fn, plain, args = calls["merge"][0]
    full = args[0].clone().reshape(prod.NT, 8, -1)
    full[:, :4] = 1.0
    time_calls({"merge": [(fn, plain, (full.reshape(prod.NT, -1),)
                           + tuple(args[1:]))]},
               f"{prod.NT}x{prod.B} ({caps}), rows 0-3 of every tile full",
               card, {}, {})
    del calls, full
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
    # rows that start off a 16-byte boundary (L = 81; cleanup rows of 18
    # and edge rows of 3): the extract's and the cleanup's scalar heads
    alive_p, planes_p = onehot_fixture(gen, dev, 648)
    for d in range(3):
        both(f"extract_fused B=648 d={d}", ox.extract_fused,
             ox.extract_fused_plain, planes_p[d], alive_p, planes_p, 32, 4)
        both(f"extract_rows B=648 d={d}", ox.extract_rows,
             ox.extract_rows_plain, planes_p[d], alive_p, planes_p, 16, 4)
    b6p = both("extract_all_rows B=648", ox.extract_all_rows,
               ox.extract_all_rows_plain, planes_p, alive_p, 16, 4)[0]
    inc_p = b6p[..., 14:32].contiguous()       # the xm run's tail, xp's head
    for axes in ((1, 2), (2,)):
        both(f"cleanup_rows W=18 {axes}", ox.cleanup_rows,
             ox.cleanup_rows_plain, inc_p, 18, 3, 4, axes)
    # the merges on rows off a 16-byte boundary (L = 81) from buffers
    # whose rows are too (runs of 13 columns; merge_all_rows' eight runs of
    # 26, 36, 13, 5, 5, 13, 5, 5), flags set at random columns of each run
    # (not a prefix), more arrivals than free slots (rows 0-2 full; the
    # tiles of merge_fused one free slot in 60)
    room_r = (torch.rand((8, 648), generator=gen, device=dev) < 0.7).float()
    room_r.view(8, 8, 81)[:, :3] = 1.0
    room_f = torch.ones((8, 648), device=dev)
    room_f[:, ::60] = 0.0
    eight, off = [], 0
    for w in (26, 36, 13, 5, 5, 13, 5, 5):
        eight.append((off, w))
        off += w
    for name, kern, plain, R, arg, KT, room in (
            ("merge_rows", ox.merge_rows, ox.merge_rows_plain, 8, 13, 26,
             room_r),
            ("merge_all_rows", ox.merge_all_rows, ox.merge_all_rows_plain, 8,
             tuple(eight), off, room_r),
            ("merge_fused", ox.merge_fused, ox.merge_fused_plain, 1, 13, 26,
             room_f)):
        inc = torch.randn((8, 7, R, KT), generator=gen, device=dev)
        inc[:, 6] = (torch.rand((8, R, KT), generator=gen, device=dev)
                     < 0.6).float()
        inc[:, 4, :, ::7] = -0.0
        outs = []
        for fn in (kern, plain):
            a, p = room.clone(), tuple(q.clone() for q in planes_p)
            fn(a, inc, p, arg)
            outs.append([a, *p])
        check(all(map(same_bits, *outs)),
              f"one-hot {name} B=648, fixture: differs from its plain "
              f"version")
        placed = float(outs[0][0].sum() - room.sum())
        check(0 < placed < float((inc[:, 6] > 0.5).sum()),
              f"one-hot {name} B=648, fixture: expected drops, placed "
              f"{placed}")
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
    # the ranked extract's column blocks: K2 = 30 (K2 % 4 != 0), 8198 and
    # 9001 (two and three blocks of 4096 columns), ranks at distinct
    # random columns of [0, max(1.1 K2, 2B)) (those >= K2 killed, not
    # copied), the last column taken, tile 3 empty; B = 101 and 2101 (rows
    # off a 16-byte boundary); alive also read from a view one word past
    # rank's 16-byte offset (scalar alive accesses)
    for B, K2 in ((101, 30), (101, 8198), (2101, 9001)):
        alive_b, planes_b = onehot_fixture(gen, dev, B)
        rank = spread_ranks(gen, dev, B, K2)
        bk = both(f"extract B={B} K2={K2}", ox.extract, ox.extract_plain,
                  rank, alive_b, planes_b, K2)[0]
        check(float(bk[:, 6, 0, (K2 - 1) // 4096 * 4096:].sum()) > 0
              and float(bk[3, 6].sum()) == 0,
              f"one-hot extract B={B} K2={K2}, fixture: the last column "
              f"block holds no copy, or the empty tile one")
        view = torch.empty(8 * B + 1, device=dev)[1:].view(8, B)
        view.copy_(alive_b)
        both(f"extract B={B} K2={K2}, alive off rank's offset", ox.extract,
             ox.extract_plain, rank, view, planes_b, K2)
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
    print("  one-hot exchange fixture (8 tiles x 640, 648, 100 and 2100; "
          "caps, edge caps and rows overflowing; rows off a 16-byte "
          "boundary; merge flags not a prefix of their runs; the ranked "
          "extract at B = 101 and 2101 with K2 = 30, 8198 and 9001): ok "
          "(bit-equal)", flush=True)


def spread_ranks(gen, dev, B: int, K2: int):
    """(8, B) int32 ranks: about half of each tile's slots at distinct
    random columns of [0, max(1.1 K2, 2B)), -1 elsewhere; column K2 - 1
    taken in tile 0, none in tile 3."""
    import torch
    n = max(int(1.1 * K2), 2 * B)
    rank = torch.stack([torch.randperm(n, generator=gen, device=dev)[:B]
                        for _ in range(8)]).int()
    off = torch.rand((8, B), generator=gen, device=dev) < 0.5
    rank = torch.where(off, torch.full_like(rank, -1), rank)
    rank[0][rank[0] == K2 - 1] = -1
    rank[0, 0] = K2 - 1
    rank[3] = -1
    return rank


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
        merge_overflow(calls[names[next(n for n in names if "merge" in n)]],
                       rows, f"{ts.NT}x{ts.B} ({route}, {caps})", card)
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


def merge_overflow(recorded, rows: bool, where: str, card: str) -> None:
    """A one-hot merge call of the exchange on a fuller destination, so
    that arrivals drop: rows 0-3 of every tile full (R = 8), or one free
    slot in 512 of every tile (R = 1).  Against its plain version bit for
    bit, then timed (events, and in a CUDA graph)."""
    import torch
    from pinc_tpu_torch import kbench
    fn, plain, args = recorded[0]
    alive = args[0].clone()
    NT, B = alive.shape
    if rows:
        alive.view(NT, 8, B // 8)[:, :4] = 1.0
        label = "rows 0-3 of every tile full"
    else:
        alive.fill_(1.0)
        alive[:, ::512] = 0.0
        label = "one free slot in 512"
    args = (alive,) + args[1:]
    got = leaves(fn(*fresh_copy(args)))
    want = leaves(plain(*fresh_copy(args)))
    check(all(map(same_bits, got, want)),
          f"one-hot merge at {where}, {label}: differs from its plain "
          f"version")
    placed = float(got[-1].sum() - alive.sum())
    arrivals = float((args[1][:, 6] > 0.5).sum())
    check(0 < placed < arrivals, f"one-hot merge at {where}, {label}: "
          f"placed {placed} of {arrivals}, expected drops")
    ms = cuda_ms_fresh(lambda: fresh_copy(args), fn, reps=10)
    print(f"  time merge at {where}, {label} ({arrivals - placed:.0f} of "
          f"{arrivals:.0f} arrivals dropped, bit-equal): kernel {ms:.4f} "
          f"ms, in a CUDA graph {kbench.graph_ms_inplace(fn, args):.4f} ms "
          f"({card})", flush=True)
    del alive, args, got, want
    torch.cuda.empty_cache()


def sectors(mask) -> int:
    """The 32-byte sectors (8 words) of a flat array of 4-byte words that
    hold a word where mask (any shape, row-major over the array) is set."""
    import torch
    m = mask.reshape(-1)
    m = torch.cat([m, m.new_zeros((-m.numel()) % 8)])
    return int(m.view(-1, 8).any(1).sum())


def ranked_merge_sectors(frank, act, buf, alive2, alive_out) -> float:
    """Bytes of the distinct 32-byte sectors the ranked merge must touch
    at these inputs: the placed slots' stores in the 6 planes and alive
    (each plane on the layout of alive), frank of the walked slots (the
    active chunks'), active, the flag row of every tile and the used
    columns of the six payload rows (rows start on 32-byte boundaries:
    K2 % 8 == 0)."""
    import torch
    from pinc_tpu_torch.ops import onehot_exchange as ox
    NT, B = frank.shape
    K2 = buf.shape[-1]
    K = K2 // 2
    placed = (alive_out > 0.5) & (alive2 <= 0.5)
    walked = act.bool().repeat_interleave(ox._chunk(B), 1)
    n_m = (buf[:, 6, 0, :K] > 0.5).sum(-1, keepdim=True)
    f = frank.long()
    col = torch.where(f < n_m, f, K + f - n_m)
    used = torch.zeros((NT, K2), dtype=torch.bool, device=frank.device)
    t = torch.arange(NT, device=frank.device)[:, None].expand(NT, B)
    used[t[placed], col[placed]] = True
    n = (7 * sectors(placed) + sectors(walked) + -(-act.numel() // 8)
         + NT * K2 // 8 + 6 * sectors(used))
    return n * 32.0


def check_ranked_bench(ox, gen, dev, card: str) -> None:
    """Phase 2: K11's ranked modes (pinc_tpu's extract and merge, kept for
    B % 8 != 0; no deck reaches them) at a shape near the v3 deck's, 4096
    tiles x 6524 slots (6144 particles a tile, velocities N(0, 0.1) moved
    by one 4-step cadence), the z sweep with K = 256: ranks as pinc_tpu's
    exchange_dim computes them, the free ranks and the active flags of
    the extract's output (kernel_trials.ranked_case).  Each against its
    plain version, bit for bit, and timed with its bound in bytes; the
    merge also in a CUDA graph (restore + merge minus the restore alone)
    and against its bound in 32-byte sectors (ranked_merge_sectors), the
    extract also in a CUDA graph.  Printed only."""
    import torch
    from pinc_tpu_torch import kbench
    from pinc_tpu_torch.kernel_trials import ranked_case
    from pinc_tpu_torch.ops.tiled import TileSpec
    ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=6524)
    alive, planes = bench_species(ts, gen, dev, 0.1, 4, -1.0 / ONEHOT_PC,
                                  per_tile=ONEHOT_PC * 8 ** 3)
    K = 256
    rank, buf, alive2, frank, act = ranked_case(alive, planes, ts.T, K)
    args = (rank, alive, planes, 2 * K)
    pbuf, palive2 = ox.extract_plain(*args)
    check(same_bits(buf, pbuf) and same_bits(alive2, palive2),
          f"one-hot extract (ranked) at {ts.NT}x{ts.B}: differs from its "
          f"plain version")
    copied = float((buf[:, 6] > 0.5).sum())
    x_bytes = alive.numel() * 12.0 + copied * 24.0 + buf.numel() * 4.0
    x_ms = cuda_ms(lambda: ox.extract(*args), reps=10, warmup=2)
    x_graph = kbench.graph_ms(lambda: ox.extract(*args), 10)
    x_plain = cuda_ms(lambda: ox.extract_plain(*args), reps=2, warmup=1)
    # the merge into the extract's output
    margs = (frank, alive2, buf, planes)
    got = leaves(ox.merge(*fresh_copy(margs), active=act))
    want = leaves(ox.merge_plain(*fresh_copy(margs), active=act))
    check(all(map(same_bits, got, want)),
          f"one-hot merge (ranked) at {ts.NT}x{ts.B}: differs from its "
          f"plain version")
    placed = float(got[-1].sum() - alive2.sum())
    CB = ox._chunk(ts.B)
    active_slots = float(act.sum()) * CB
    m_bytes = (active_slots * 4.0 + act.numel() * 4.0
               + buf[:, 6].numel() * 4.0 + placed * 52.0)
    m_sectors = ranked_merge_sectors(frank, act, buf, alive2, got[-1])
    m_ms = cuda_ms_fresh(lambda: fresh_copy(margs),
                         lambda *a: ox.merge(*a, active=act), reps=10)
    m_graph = kbench.graph_ms_inplace(
        lambda *a: ox.merge(*a, active=act), margs)
    m_plain = cuda_ms_fresh(lambda: fresh_copy(margs),
                            lambda *a: ox.merge_plain(*a, active=act),
                            reps=2)
    for name, ms, plain_ms, nbytes in (
            ("extract_ranked_kernel", x_ms, x_plain, x_bytes),
            ("merge_ranked_kernel", m_ms, m_plain, m_bytes)):
        b = bound_ms(nbytes)
        print(f"  time {name} at {ts.NT}x{ts.B} (ranked mode, K = {K}, "
              f"{copied:.0f} copied, {placed:.0f} placed, bit-equal): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} "
              f"ms, {b / ms:.1%} of it ({card})", flush=True)
    xb = bound_ms(x_bytes)
    print(f"  extract_ranked_kernel: in a CUDA graph {x_graph:.4f} ms, "
          f"{xb / x_graph:.1%} of its bound ({card})", flush=True)
    sb = bound_ms(m_sectors)
    print(f"  merge_ranked_kernel: {float(act.sum()):.0f} of {act.numel()} "
          f"chunks active ({CB} slots a chunk); in a CUDA graph "
          f"{m_graph:.4f} ms; bound in 32-byte sectors {sb:.4f} ms "
          f"({m_sectors / 32:.0f} sectors), {sb / m_graph:.1%} of it in the "
          f"graph; byte bound {bound_ms(m_bytes):.4f} ms, "
          f"{bound_ms(m_bytes) / m_graph:.1%} ({card})", flush=True)
    del alive, planes, rank, args, buf, alive2, margs, got, want, frank
    torch.cuda.empty_cache()


def check_headline_cap(gx, ox, ex, gen, dev, card: str) -> None:
    """Phase 2, the headline scan window's exchange (phase 5's deck: M =
    2, B = 17,408, face cap K = 512; electrons with velocities N(0, 0.1)
    moved by one 4-step cadence): the extract, cleanup and merge calls of
    one gather exchange (Ks = 128, KU = 384, Ke = 128) and, on the same
    state,
    of the one-hot row exchange (tiles:exchangeImpl=onehot: Ks = 128, Ke
    = 32) and the per-tile one-hot sweeps (K = 512), each against its
    plain version and timed with its bound.  Printed only: the kernels
    line keeps the deck shapes above."""
    import torch
    from pinc_tpu_torch.ops.tiled import TileSpec
    ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=17408)
    alive, planes = bench_species(ts, gen, dev, 0.1, 4, -1.0 / 32)
    routes = {
        "gather": (gx, {"extract_compact_rows_g": "extract",
                        "cleanup_faces_g": "cleanup",
                        "cleanup_rows_g": "cleanup",
                        "merge_rows_g": "merge"},
                   dict(rows=True), same),
        "onehot rows": (ox, {"extract_all_rows": "onehot_extract_rows",
                             "cleanup_rows": "onehot_cleanup"},
                        dict(rows=True, impl="onehot"), same_bits),
        "onehot tile": (ox, {"extract_fused": "onehot_extract_tile"},
                        dict(rows=False), same_bits),
    }
    for route, (mod, names, kw, equal) in routes.items():
        # a function the package lacks is skipped, so that the same phase
        # can time an earlier version of the package
        names = {n: k for n, k in names.items() if hasattr(mod, n)}
        calls = capture_calls(mod, names, lambda: ex.rebucket_exchange_planes(
            tuple(p.clone() for p in planes), alive.clone(), ts.ntiles, ts.T,
            K=512, **kw))
        time_calls(calls, f"{ts.NT}x{ts.B} M=2, the headline window's face "
                   f"cap 512 ({route})", card, {}, {}, equal=equal)
        del calls
        torch.cuda.empty_cache()
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
                    route: str, phase: str = "3"):
    """The checks of phase 3 on one run; route: the re-bucket the deck
    must take (a key of ROUTE_CALLS)."""
    import torch
    check(rc == 0, f"{label}: the CLI returned {rc}")
    sim = out["sim"]
    mode = "sort" if route == "sort" else "exchange"
    S, per_species = sim.state.alive.shape[0], sim._capacity
    print(f"phase {phase} {label}: {type(sim).__name__}, {sim.ts.ntiles} "
          f"tiles "
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
             route: str = "gather", steps=None, fresh: bool = True,
             phase: str = "5"):
    """Phase 5: the window bench.py:bench_pic times, through
    TiledSimulation.make_scan_steps(steps, donate=True, fresh=fresh) on
    the card: one untimed warm window, then a timed one, with the launch
    counts set to 0 just before each and read just after.  steps: the
    window (default SCAN_STEPS, sized to the slow cadence).  Returns (sim,
    state, result)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.ops import gather_exchange as gx
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
    if steps is None:
        steps = SCAN_STEPS
        if Ri % Re == 0 and Ri <= 400:
            steps = Ri * max(1, round(steps / Ri))
    run_n = sim.make_scan_steps(steps, donate=True, fresh=fresh)
    sched = any(m is not None for kind, m in run_n.plan if kind == "step")
    events = [a for kind, a in run_n.plan if kind == "rebucket"]
    n_events = sum(len(a) for a in events)
    print(f"phase {phase} {label}: M={sim.ts.M}, cadences {Rs}, window "
          f"{steps} "
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
        # the untimed warm window counts the merge calls whose spill
        # passes run (a few device ops a call)
        with (leftover_spy(gx) if window == "warm"
              else contextlib.nullcontext([])) as seen:
            carry, (ke, pe, dropped) = run_n(carry)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
        print(f"  {window} window: {wall:.3f} s, launches {launches}"
              + (f"; {leftover_text(seen)}" if window == "warm" else ""),
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


def kernel_bench(card: str, launches: dict, times: dict, bounds: dict,
                 errs: dict, libs: dict) -> None:
    """Phase 6: the kernel benchmark's kernels (K12, K13's probes).  Each
    variant mode against its plain version at the test fixture (16^3, T =
    8, B = 256 and 1040, M = 1 and 2: B = 1040's 130 columns a row take
    given_kron's element-copy instantiation in three plane stages), the
    REDESIGNED_MODES also at 4096 x 9216 at M = 2 (P = 13: given_kron's two
    column blocks), bf16_native and weight_sums launched twice (their
    integer sums give the same bits), each exchange primitive at the
    probes' shapes (bit
    pattern for bit pattern), then pinc_tpu_torch.kbench.run at the
    production shapes, with the launch counts set to 0 just before and
    read just after; every row must agree with its plain version (int8
    and the primitives bit for bit) and each primitive with its library
    call; then given_kron's product timed as one torch.matmul beside its
    kernel (kbench.given_kron_matmul_ms, context, not a library call).
    Fills the kbench kernels' entries of launches, times, bounds and errs,
    and libs for the primitives."""
    import torch
    from pinc_tpu_torch import kbench
    from pinc_tpu_torch.ops import kbench_kernels as kb
    from pinc_tpu_torch.ops import kbench_prims as kp
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.ops.tiled import TileSpec
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for grid, M, B in (((16, 16, 16), 1, 256), ((16, 16, 16), 2, 256),
                       ((16, 16, 16), 1, 1040), ((16, 16, 16), 2, 1040),
                       ((128, 128, 128), 2, 9216)):
        ts = TileSpec(grid=grid, T=8, M=M, B=B)
        modes = kb.DEPOSIT_MODES if grid[0] == 16 else REDESIGNED_MODES
        xyz = torch.rand((3, ts.NT, ts.B), generator=gen, device=dev) * (
            ts.T + 2 * M) - M
        val = (torch.rand((ts.NT, ts.B), generator=gen, device=dev)
               < 0.9).float()
        kron = torch.rand((ts.P ** 2, ts.B // 8), generator=gen,
                          device=dev).bfloat16()
        for mode in modes:
            got = kb.deposit_variant(xyz, val, ts, mode, kron=kron)
            want = kb.deposit_variant_plain(xyz, val, ts, mode, kron=kron)
            check(torch.equal(got, want) if mode == "int8" else
                  (got - want).abs().max().item()
                  <= kbench.DEPOSIT_RTOL * want.abs().max().item(),
                  f"kbench deposit {mode}, {ts.NT} tiles M={M} B={B}: "
                  f"differs from its plain version")
            if mode in SAME_BITS_MODES:   # integer sums: the same bits
                check(kbench.same_bits(
                    got, kb.deposit_variant(xyz, val, ts, mode)),
                      f"kbench deposit {mode}, {ts.NT} tiles M={M} "
                      f"B={B}: two launches differ")
        if grid[0] == 16:
            field = torch.randn((ts.NT, ts.P, ts.P, ts.P, 3), generator=gen,
                                device=dev)
            Eq, scale = kb.quantize_field(field)
            for mode in kb.GATHER_MODES:
                f, kw = ((Eq, dict(scale=scale)) if mode == "int8"
                         else (field, {}))
                got = kb.gather_variant(f, xyz, ts, mode, **kw)
                want = kb.gather_variant_plain(f, xyz, ts, mode, **kw)
                check(torch.equal(got, want) if mode == "int8" else
                      (got - want).abs().max().item()
                      <= kbench.GATHER_RTOL * want.abs().max().item(),
                      f"kbench gather {mode}, fixture M={M} B={B}: differs "
                      f"from its plain version")
        del xyz, val, kron, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("phase 6 kernel bench: every variant mode against its plain "
          "version at the fixture (M = 1, 2; B = 256, 1040), bf16_native, "
          "given_kron and weight_sums also at 4096 x 9216, M = 2; "
          "bf16_native and weight_sums launched twice, the same bits: ok",
          flush=True)
    checks = kbench.check_prims(dev, log=lambda s: print(f"  {s}",
                                                          flush=True))
    torch.cuda.synchronize()
    check(all(r["ok"] for r in checks) and {r["kernel"] for r in checks}
          == set(kp.LAUNCHES), "kernel bench: an exchange primitive differs "
          "from its plain version at the probes' shapes: "
          f"{[r['name'] for r in checks if not r['ok']]}")
    print(f"phase 6 exchange primitives at the probes' shapes: "
          f"{len(checks)} cases bit-equal to their plain versions",
          flush=True)
    kb.reset_launches()
    kp.reset_launches()
    tk.reset_launches()
    rows = kbench.run(reps=10, device=dev,
                      log=lambda s: print(f"  {s} ({card})", flush=True))
    torch.cuda.synchronize()
    got = {**kb.LAUNCHES, **kp.LAUNCHES}
    print(f"  launches: {got}, K1 {tk.LAUNCHES['deposit']}, K3 "
          f"{tk.LAUNCHES['gather']}", flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    check(not bad, f"kernel bench: rows differ from their plain versions "
          f"(or a primitive from its library call): {bad}")
    check(all(v > 0 for v in got.values()) and tk.LAUNCHES["deposit"] > 0
          and tk.LAUNCHES["gather"] > 0,
          f"kernel bench: a kernel never launched: {got}")
    for mode, (ms, base, share) in kbench.ceiling_split(rows).items():
        print(f"  ceiling split: {mode} {ms:.4f} ms = {share:.1%} of "
              f"{'K3' if mode == 'no_xreduce' else 'K1'} bf16 {base:.4f} ms "
              f"at 4096x9216; {kbench.CEILING_NOTES[mode]} ({card})",
              flush=True)
    print(f"  {kbench.format_matmul(kbench.given_kron_matmul_ms(dev))} "
          f"({card})", flush=True)
    by = {r["name"]: r for r in rows}
    for key in kp.LAUNCHES:
        r = by[PRIM_ROWS[key]]
        print(f"  {key} at its production row ({r['name']}): kernel "
              f"{r['ms']:.4f} ms = {r['x_library']:.3f}x {r['library']} "
              f"{r['library_ms']:.4f} ms ({card})", flush=True)
    for r in rows:
        key = r["kernel"]
        if key in kb.LAUNCHES or r["name"] == PRIM_ROWS.get(key):
            launches[key] = got[key]
            times[key] = (r["ms"], r["plain_ms"])
            bounds[key] = (r["bound_ms"], r["bound_by"])
            if key in kp.LAUNCHES:
                libs[key] = r["library_ms"]
        if key in got:
            errs[key] = max(errs.get(key, 0.0), r["max_abs_err"])
    torch.cuda.empty_cache()


# -- phase 7: output and checkpoints ------------------------------------------
OUTPUT_DECKS = ("langmuirWarm.ini", "langmuirCold1D.ini", "langmuir2D.ini")
OUTPUT_STEPS = 20      # each deck's nTimeSteps (100 and 150 in the decks)
WRITE_EVERY = 10       # files:writeFrequency
# langmuirWarm.ini on the tiled layout: its electrons' estimated 2.32 cells
# a step exceed the default wander margin of 2, so tiles:margin = 3
TILED_WARM = ("methods:layout=tiled", "tiles:margin=3")
CKPT_STEP = 10
H5_MISSING = "h5py is required for HDF5 output"


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def deck_path(name: str, tmp: str, output: bool = True) -> str:
    """input/<name> beside this script, or (output=False) a copy in tmp
    without its files:output line."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "input",
                       name)
    if output:
        return src
    dst = os.path.join(tmp, name)
    with open(src) as f, open(dst, "w") as g:
        g.writelines(line for line in f
                     if not line.strip().lower().startswith("output"))
    return dst


def check_decks(cli_main, modules, card: str, tmp: str, h5: bool) -> None:
    """Phase 7: each shipped deck's output raises pinc_tpu's error through
    the CLI where h5py is missing; the decks run at full size without
    their files:output line."""
    import torch
    for name in OUTPUT_DECKS:
        if not h5:
            try:
                cli_main([deck_path(name, tmp),
                          f"time:nTimeSteps={OUTPUT_STEPS}",
                          f"files:output={tmp}/{name[:-4]}"], out={})
            except RuntimeError as e:
                check(H5_MISSING in str(e), f"phase 7 {name}: raised {e!r}")
            else:
                fail(f"phase 7 {name}: files:output ran without h5py")
        for m in modules:
            m.reset_launches()
        out: dict = {}
        check(cli_main([deck_path(name, tmp, output=False),
                        f"time:nTimeSteps={OUTPUT_STEPS}"], out=out) == 0,
              f"phase 7 {name}: the CLI failed")
        launched = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
        sim, ke, pe = out["sim"], out["kinetic"].sum(1), out["potential"]
        check(ke.shape == pe.shape == (OUTPUT_STEPS + 1,) and all(
            math.isfinite(v) for v in list(ke) + list(pe)),
              f"phase 7 {name}: non-finite energies")
        etot = ke + pe
        print(f"phase 7 {name}: "
              + ("" if h5 else f"files:output raises {H5_MISSING!r}; ")
              + f"without it {type(sim).__name__} on "
              f"{sim.particles.cell.device}, {sim.particles.capacity} slots "
              f"x {sim.particles.n_species} species, {OUTPUT_STEPS} steps, "
              f"total energy {etot[0]:.6g} -> {etot[-1]:.6g}; kernel "
              f"launches {launched or 'none (flat path)'} ({card})",
              flush=True)
        del sim, out
        torch.cuda.empty_cache()


def check_tiled_launches(label: str, launches: dict, sim, steps: int,
                         first: int) -> None:
    """run()'s kernels on a tiled run of steps first+1 .. steps: K2/K4 per
    species a step, K7 once a step (and the half kick's K1/K3/K7 from step
    0), the exchange at every scheduled species event."""
    S = sim.state.alive.shape[0]
    n = steps - first
    kick = 0 if first else 1
    events = sum(steps // R - first // R for R in sim.rebucket_every_s)
    ex_launched = sum(launches[k] for k in EXCHANGE_KERNELS)
    check(launches["deposit_move"] == launches["gather_kick"] == S * n
          and launches["fold_global"] == n + kick
          and launches["deposit"] == launches["gather"] == S * kick
          and (ex_launched > 0) == (events > 0),
          f"{label}: launches {launches} ({S} species, {n} steps, "
          f"{events} re-bucket events)")


def check_tiled_resume(cli_main, modules, card: str, tmp: str) -> None:
    """Phase 7: langmuirWarm.ini at 32^3 on the tiled layout, 20 steps
    uninterrupted and 10 + 10 resumed through TiledSimulation.resume from
    the first 10 steps' state and tuning (what a tiled checkpoint file
    restores).  The final states are bit-identical."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    deck = deck_path("langmuirWarm.ini", tmp, output=False)

    def cli(steps):
        for m in modules:
            m.reset_launches()
        out: dict = {}
        check(cli_main([deck, *TILED_WARM, f"time:nTimeSteps={steps}"],
                       out=out) == 0, "phase 7 tiled: the CLI failed")
        return out, {k: v for m in modules for k, v in m.LAUNCHES.items()}

    full, launches = cli(OUTPUT_STEPS)
    sim_f = full["sim"]
    check_tiled_launches("phase 7 tiled run", launches, sim_f, OUTPUT_STEPS,
                         0)
    part, _ = cli(CKPT_STEP)
    st = part["sim"].state
    sim_r = TiledSimulation(PincConfig.from_file(
        deck, [*TILED_WARM, f"time:nTimeSteps={OUTPUT_STEPS}"]))
    sim_r.resume(CKPT_STEP, type(st)(lpos=st.lpos.clone(),
                                     vel=st.vel.clone(),
                                     alive=st.alive.clone()),
                 part["sim"].tuning())
    del part, st
    for m in modules:
        m.reset_launches()
    hist = sim_r.run(progress_every=0)
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    check(sim_r._resumed and sim_r.start_step == CKPT_STEP,
          "phase 7 tiled resume: not resumed at the checkpoint's step")
    check_tiled_launches("phase 7 tiled resume", launches, sim_r,
                         OUTPUT_STEPS, CKPT_STEP)
    got = [getattr(sim_r.state, k) for k in ("lpos", "vel", "alive")]
    want = [getattr(sim_f.state, k) for k in ("lpos", "vel", "alive")]
    check(all(map(same_bits, got, want))
          and (hist["kinetic"] == full["kinetic"][CKPT_STEP + 1:]).all(),
          "phase 7 tiled resume: the resumed state or energies differ from "
          "the uninterrupted run's")
    print(f"phase 7 tiled langmuirWarm ({', '.join(TILED_WARM)}) on "
          f"{sim_r.state.lpos.device}: "
          f"{sim_f.ts.ntiles} tiles, B = {sim_f.ts.B}, cadences "
          f"{sim_f.rebucket_every_s}, {sim_f._rebucket_mode} re-bucket; "
          f"resumed at step {CKPT_STEP} through TiledSimulation.resume: "
          f"step {OUTPUT_STEPS}'s state and steps {CKPT_STEP + 1}-"
          f"{OUTPUT_STEPS}' energies bit-identical to the uninterrupted run "
          f"({card})", flush=True)
    del sim_f, sim_r, full
    torch.cuda.empty_cache()


class NoHistory:
    """io_h5.XYFile's stand-in for the energy history, which is not
    written (the card's host has no h5py)."""

    def __init__(self, cfg, name: str):
        pass

    def create(self, name: str) -> None:
        pass

    def append(self, name: str, x: float, y: float) -> None:
        pass


def time_bench_output(modules, card: str, tmp: str) -> None:
    """Phase 7: the bench deck (128^3, tiled) for 20 steps through run()
    with the port's io_h5.OutputWriter on files:async = true,
    files:writePop = false and its fields written every 10 steps: the
    native spooler takes them (io_h5.XYFile replaced by NoHistory), and
    the last written step is read back with read_spool, bit for bit.
    Prints a written step's host time against the unwritten steps' median
    and write_step's own time."""
    import numpy as np
    import torch
    from pinc_tpu_torch import io_h5
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.spool import SpoolWriter, read_spool
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    cfg = PincConfig.from_string(BENCH_DECK)
    for key, value in (("methods:layout", "tiled"),
                       ("time:nTimeSteps", MAIN_STEPS),
                       ("files:output", f"{tmp}/bench"),
                       ("files:async", "true"), ("files:writePop", "false"),
                       ("files:writeFrequency", WRITE_EVERY)):
        cfg.set_str(key, str(value))
    sim = TiledSimulation(cfg)
    xy = io_h5.XYFile
    io_h5.XYFile = NoHistory
    try:
        w = io_h5.OutputWriter(cfg, sim)
    finally:
        io_h5.XYFile = xy
    check(isinstance(w.spool, SpoolWriter) and not w.grids,
          "phase 7 bench deck: files:async did not take the native spooler")
    seconds, last = {}, {}
    write_step = w.write_step

    def timed(n, out):
        t0 = time.monotonic()
        write_step(n, out)
        seconds[n] = time.monotonic() - t0
        last.update(n=n, out=out)
    w.write_step = timed
    for m in modules:
        m.reset_launches()
    out = sim.run(writer=w, progress_every=0)
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    check(w.spool.close() == 3 * (MAIN_STEPS // WRITE_EVERY + 1),
          "phase 7 bench deck: the spooler lost records")
    n = last["n"]
    arrays = {k: io_h5.fetch_global(getattr(last["out"], k))
              for k in ("rho", "phi", "E")}
    back = {k: a for k, t, a in read_spool(w.spool_path) if t == n}
    check(n == MAIN_STEPS and sorted(back) == sorted(arrays) and all(
        back[k].dtype == arrays[k].dtype
        and np.array_equal(back[k], arrays[k]) for k in arrays),
          "phase 7 bench deck: read_spool did not give back the spooled "
          "step")
    check_tiled_launches("phase 7 bench deck", launches, sim, MAIN_STEPS, 0)
    step_s = out["step_seconds"]
    written = {k: step_s[k - 1] for k in range(WRITE_EVERY, MAIN_STEPS + 1,
                                                WRITE_EVERY)}
    rest = sorted(v for i, v in enumerate(step_s[1:], 2)
                  if i not in written)
    med = rest[len(rest) // 2]
    print(f"phase 7 bench deck with fields every {WRITE_EVERY} steps through "
          f"io_h5.OutputWriter on files:async (the native spooler; read "
          f"back bit for bit with read_spool): written steps' host time "
          + ", ".join(f"step {k} {v * 1e3:.3f} ms"
                      for k, v in written.items())
          + f" (re-bucket cadences {sim.rebucket_every_s}: steps "
          f"{[k for k in written if any(k % R == 0 for R in sim.rebucket_every_s)]}"
          f" of them also re-bucket) against the unwritten steps' median "
          f"{med * 1e3:.3f} ms; write_step's own host time "
          + ", ".join(f"step {k} {v * 1e3:.3f} ms"
                      for k, v in sorted(seconds.items()))
          + f" ({card})", flush=True)
    del sim, out, last
    torch.cuda.empty_cache()


def check_output(cli_main, modules, card: str) -> None:
    """Phase 7: output and checkpoints on the card: the CLI's h5py error
    on each output deck where h5py is missing, the decks without output,
    the tiled resume from the first run's state, the bench deck through
    the port's writer and the native spooler.  The HDF5 files and
    checkpoint files themselves are checked by the CPU tests."""
    h5 = have_h5py()
    print(f"phase 7 output and checkpoints: h5py "
          f"{'installed' if h5 else 'not installed on this host'}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        check_decks(cli_main, modules, card, tmp, h5)
        check_tiled_resume(cli_main, modules, card, tmp)
        time_bench_output(modules, card, tmp)
    print("phase 7: HDF5 files and checkpoint files are checked on the CPU "
          "only (tests/test_torch_io.py, test_torch_checkpoint.py, "
          "test_torch_decks.py)", flush=True)


# -- phase 8: bounded walls, multigrid, the run modes, small decks ------------
# input/maxwellian.ini's [multigrid] section
MG_SECTION = """[multigrid]
cycle = mgVRecursive
preSmooth = gaussSeidelRB
postSmooth = gaussSeidelRB
coarseSolver = gaussSeidelRB
mgLevels = 4
mgCycles = 15
nPreSmooth = 10
nPostSmooth = 10
nCoarseSolve = 10
"""
MG_KW = dict(n_levels=4, n_pre=10, n_post=10, n_coarse=10,
             cycle="mgVRecursive", smoother="gaussSeidelRB", max_cycles=15,
             tol=5e-6)           # make_from_config's float32 default tol
MG_CHECK_N = 64        # card against CPU at 64^3 (the CPU's solve is slow)
MG_TIME_N = 128        # the card's solve timed at the bench deck's grid
MG_RTOL = 1e-4         # max|phi_card - phi_cpu| <= 1e-4 * max|phi_cpu|
                       # (float32 means and sums in another order, 15
                       # cycles); final RMS residuals rtol 1e-3
MG_STEPS = 20          # run() and the window on decks (a)-(c)
DEBUG_STEPS = 5
# deck (a): the bench deck solved by multigrid; (b) and (c) bounded by
# Dirichlet and Neumann walls with zero values (the reference's default
# Neumann value 2.0 is a normal field of 2 at every wall node, a kick of
# 2 cells a step for the electrons, beyond the tiled layout's margin)
MG_DECKS = {
    "a": BENCH_DECK.replace("poisson = sSolve", "poisson = mgSolve")
    .replace("[tiles]", MG_SECTION + "[tiles]"),
}
for _key, _bnd in (("b", "DIRICHLET"), ("c", "NEUMANN")):
    MG_DECKS[_key] = MG_DECKS["a"].replace(
        "boundaries = PERIODIC",
        f"boundaries = {_bnd}\nbndValues = 0,0,0,0,0,0")
SMALL_DECKS = ("langmuirCold1D.ini", "langmuir2D.ini")
SMALL_REBUCKET = 5     # their default cadence (200) outlasts the 20 steps


def mg_rho(n: int):
    """A seeded charge density at n^3: a smooth mode plus noise."""
    import numpy as np
    x = np.arange(n) * 2 * np.pi / n
    smooth = (np.sin(x)[:, None, None] * np.cos(2 * x)[None, :, None]
              * np.sin(x + 0.3)[None, None, :])
    noise = np.random.default_rng(8).standard_normal((n, n, n))
    return (0.01 * (smooth + 0.1 * noise)).astype(np.float32)


def check_multigrid(card: str) -> None:
    """Phase 8.1: the multigrid solve on the card against the port's own
    CPU solve of the same seeded rho at 64^3 (periodic, Dirichlet, Neumann
    on x with periodic y/z), then its time at 128^3 by CUDA events, a
    V-cycle's time and its device launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pinc_tpu_torch.bc import BCSpec
    from pinc_tpu_torch.grid import BndType
    from pinc_tpu_torch.solvers.multigrid import MultigridSolver
    P, D, N = BndType.PERIODIC, BndType.DIRICHLET, BndType.NEUMANN
    zero = (0.0,) * 3
    cases = {"periodic": None,
             "Dirichlet": BCSpec((D,) * 3, (D,) * 3, zero, zero),
             "Neumann x, periodic y/z": BCSpec((N, P, P), (N, P, P), zero,
                                               zero)}
    rho = torch.from_numpy(mg_rho(MG_CHECK_N))
    shape = (MG_CHECK_N,) * 3
    for label, bc in cases.items():
        t0 = time.monotonic()
        phi_c, n_c, r_c = MultigridSolver(shape, bc=bc, **MG_KW) \
            .solve_with_stats(rho)
        cpu_s = time.monotonic() - t0
        phi_g, n_g, r_g = MultigridSolver(shape, bc=bc, **MG_KW) \
            .solve_with_stats(rho.cuda())
        err = float((phi_g.cpu() - phi_c).abs().max())
        scale = float(phi_c.abs().max())
        r_c, r_g = float(r_c), float(r_g)
        check(phi_g.is_cuda and n_g == n_c and err <= MG_RTOL * scale
              and abs(r_g - r_c) <= 1e-3 * r_c,
              f"phase 8 multigrid {label}: card {n_g} cycles, residual "
              f"{r_g:.6e}; CPU {n_c} cycles, residual {r_c:.6e}; max|dphi| "
              f"{err:.3e} of max|phi| {scale:.3e}")
        print(f"phase 8 multigrid {label} at {MG_CHECK_N}^3 (4 levels, "
              f"10/10/10 sweeps, tol 5e-6): card {n_g} cycles = CPU "
              f"{n_c}, residual {r_g:.6e} vs {r_c:.6e}, max|dphi| "
              f"{err:.3e} <= {MG_RTOL} * {scale:.3e} (CPU solve "
              f"{cpu_s:.1f} s)", flush=True)
    n = MG_TIME_N
    solver = MultigridSolver((n,) * 3, **MG_KW)
    rho = torch.from_numpy(mg_rho(n)).cuda()
    _, n_cycles, resid = solver.solve_with_stats(rho)
    ms_solve = cuda_ms(lambda: solver.solve_with_stats(rho), reps=3,
                       warmup=0)
    rho_n = rho - rho.mean()
    phi0 = torch.zeros_like(rho)
    ms_cycle = cuda_ms(lambda: solver._vcycle(0, phi0, rho_n), reps=5,
                       warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver._vcycle(0, phi0, rho_n)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_time_total > 0)
    print(f"phase 8 multigrid at {n}^3 on the card (seeded rho, 4 levels, "
          f"10/10/10 sweeps, tol 5e-6): {n_cycles} cycles (residual "
          f"{float(resid):.6e}), {ms_solve:.3f} ms a solve, {ms_cycle:.3f} "
          f"ms a V-cycle (CUDA events), {launches} device launches a "
          f"V-cycle (torch.profiler) ({card})", flush=True)


def walls_ok(sim) -> tuple:
    """(min, max) over every live particle's global coordinate, each dim."""
    import torch
    from pinc_tpu_torch.ops.tiled import tile_origins
    st = sim.state
    org = tile_origins(sim.ts, st.lpos.device)                 # (NT, 3)
    live = st.alive > 0.5
    out = []
    for d in range(3):
        g = (st.lpos[:, d] + org[None, :, d, None])[live]
        out.append((float(g.min()), float(g.max())))
    return out


def mg_breakdown(sim, label: str, card: str) -> None:
    """Device time of each part of one step of an mgSolve deck's run(), by
    CUDA events, on the run's final state: the kernels of the step (K2/K4
    on a periodic deck; the drift and reflection, K1 with K7, K3 and the
    kick inside walls), the multigrid solve (its cycles on this rho) and
    E with its padded tiles."""
    import torch
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.tiled_sim import TiledState
    st = sim.state
    S = st.lpos.shape[0]
    rho = sim._deposit_rho(st)
    phi, n_cycles, resid = sim.solver.solve_with_stats(rho)
    E = sim._efield(phi)
    parts = {"whole step (no re-bucket)": lambda: sim._tiled_step(st)}
    if sim._use_fused:
        ep5 = sim._field_tiles(E)
        parts[f"K2 deposit_move x {S}"] = lambda: [
            tk.deposit_move(st.lpos[s], st.vel[s], st.alive[s],
                            sim._charge[s], sim.ts, mxu_dtype=sim._mxu_dtype,
                            order=sim._distr_order) for s in range(S)]
        parts[f"K4 gather_kick x {S}"] = lambda: [
            tk.gather_kick(ep5, st.lpos[s], st.vel[s], st.alive[s],
                           sim._qm[s], sim.ts, mxu_dtype=sim._mxu_dtype,
                           order=sim._acc_order, e_ext=sim._e_ext,
                           boris=sim._boris(s)) for s in range(S)]
    else:
        parts["drift + reflection"] = lambda: sim._reflect_walls(TiledState(
            lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive))
        parts[f"K1 deposit x {S} + K7 fold_global"] = (
            lambda: sim._deposit_rho(st))
        parts[f"K3 gather + kick x {S}"] = lambda: sim._kick(st, E, False)
    parts[f"multigrid solve ({n_cycles} cycles, residual "
          f"{float(resid):.3e})"] = lambda: sim.solver(rho)
    parts["E = -grad(phi) and its padded tiles"] = (
        lambda: sim._field_tiles(sim._efield(phi)))
    print(f"phase 8 {label}, one step by CUDA events ({card}):", flush=True)
    for name, fn in parts.items():
        print(f"  {name}: {cuda_ms(fn, reps=2, warmup=1):.3f} ms",
              flush=True)
    del rho, phi, E
    torch.cuda.empty_cache()


def check_bounded_run(label: str, rc, out, launches, wall, steps: int,
                      card: str) -> float:
    """Phase 8.3's checks on one bounded run(): the unfused step (K1 and
    K3 per species a step and in the half kick, K7 once a step and in the
    half kick, no K2/K4/K5/K6), the gather exchange at every species event,
    the state on the card, no drop, alive conserved, every particle in
    [0, L-1], finite energies.  Returns the mean ms a step."""
    check(rc == 0, f"{label}: the CLI returned {rc}")
    sim = out["sim"]
    S, per_species = sim.state.alive.shape[0], sim._capacity
    check(not sim._use_fused and not sim._use_mega
          and all(sim._bounded_dims),
          f"{label}: the deck took the fused route")
    want = {"deposit": S * (steps + 1), "gather": S * (steps + 1),
            "fold_global": steps + 1}
    scheduled = sum(steps // R for R in sim.rebucket_every_s)
    events = launches["extract"]
    check(events == scheduled or (events > scheduled and out["n_lost"] > 0),
          f"{label}: {events} re-bucket events ({scheduled} scheduled, "
          f"{out['n_lost']} margin hits)")
    want.update({k: n * events for k, n in ROUTE_CALLS["gather"].items()})
    got = {k: v for k, v in launches.items() if v}
    check(got == want, f"{label}: launches {got}, expected {want}")
    st = sim.state
    check(all(t.is_cuda for t in (st.lpos, st.vel, st.alive)),
          f"{label}: a state tensor left the card")
    n_alive = int((st.alive > 0.5).sum())
    check(n_alive == S * per_species and out["dropped"] == 0,
          f"{label}: alive {n_alive} of {S * per_species}, "
          f"{out['dropped']} dropped")
    spans = walls_ok(sim)
    check(all(lo >= 0.0 and hi <= g - 1 for (lo, hi), g
              in zip(spans, sim.ts.grid)),
          f"{label}: particles outside [0, L-1]: {spans}")
    ke, pe = out["kinetic"].sum(axis=1), out["potential"]
    check(len(ke) == steps + 1 and all(math.isfinite(v) for v in
                                       list(ke) + list(pe)),
          f"{label}: non-finite energies")
    step_ms = float(sum(out["step_seconds"][1:])
                    / (steps - 1)) * 1e3
    spans = [tuple(round(v, 4) for v in x) for x in spans]
    print(f"phase 8 {label}: {steps} steps, {wall:.1f} s including set-up; "
          f"launches {got}; state on cuda, alive {n_alive} of "
          f"{S * per_species}, 0 dropped, {out['n_lost']} margin hits, "
          f"global positions in {spans} (walls [0, {sim.ts.grid[0] - 1}]); "
          f"total energy "
          f"{ke[0] + pe[0]:.9g} -> {ke[-1] + pe[-1]:.9g}; {step_ms:.3f} "
          f"ms a step (mean of steps 2-{steps}, re-buckets included) "
          f"({card})", flush=True)
    return step_ms


def check_run_modes(cli_main, card: str) -> None:
    """Phase 8.4: mgMode at 128^3, mgModeErrorScaling at 32^3 (16^3 and
    32^3 solves: at 128^3 the 4-level solve stops at its 15-cycle cap far
    from the discretization error), puModeParticle and puModeInterp,
    through the CLI on the card."""
    mode_deck = """[time]
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = {n},{n},{n}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 1 pc
nAlloc = 1 pc
charge = -1,1
mass = 1,1836
[methods]
mode = {mode}
poisson = mgSolve
""" + MG_SECTION
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, n in (("mgMode", 128), ("mgModeErrorScaling", 32),
                        ("puModeParticle", 64), ("puModeInterp", 64)):
            deck = os.path.join(tmp, f"{mode}.ini")
            with open(deck, "w") as f:
                f.write(mode_deck.format(n=n, mode=mode))
            out: dict = {}
            t0 = time.monotonic()
            check(cli_main([deck], out=out) == 0,
                  f"phase 8 {mode}: the CLI failed")
            results[mode] = (out, time.monotonic() - t0)
    out, wall = results["mgMode"]
    check(out["seconds"] > 0 and out["cycles"] >= 1,
          f"phase 8 mgMode: {out}")
    print(f"phase 8 mgMode at 128^3 (maxwellian.ini's [multigrid]): "
          f"{out['seconds'] * 1e3:.3f} ms a solve (CUDA events, mean of 5), "
          f"{out['cycles']} cycles, rms error against the analytic phi "
          f"{out['rms_error']:.4e}; {wall:.1f} s in all ({card})",
          flush=True)
    out, _ = results["mgModeErrorScaling"]
    check(out["order"] > 1.5, f"phase 8 mgModeErrorScaling: order "
          f"{out['order']} (tests/test_solvers.py:88 bound 1.5)")
    print(f"phase 8 mgModeErrorScaling ({out['fixture']}, {out['sizes']}): "
          f"errors {out['errors']}, order {out['order']:.4f} > 1.5",
          flush=True)
    out, _ = results["puModeParticle"]
    check(all(o > 1.8 for o in out["orders"]),
          f"phase 8 puModeParticle: orders {out['orders']}")
    print(f"phase 8 puModeParticle: orders {out['orders']} (> 1.8)",
          flush=True)
    out, _ = results["puModeInterp"]
    check(0.8 < out["order_ngp"] < 1.2 and 1.8 < out["order_cic"] < 2.2,
          f"phase 8 puModeInterp: {out}")
    print(f"phase 8 puModeInterp: orders ngp {out['order_ngp']:.4f}, cic "
          f"{out['order_cic']:.4f}", flush=True)


def check_maxwellian(cli_main, card: str) -> None:
    """Phase 8.5: input/maxwellian.ini (mgSolve) on one subdomain without
    its files:output line, 5 steps through the CLI: periodic as shipped,
    inside Dirichlet and Neumann walls of zero value (the Neumann default
    2.0 is a wall field that multiplies this deck's kinetic energy
    ~1300-fold in its first step): the flat layout on the card, the multigrid solve, every
    particle inside the walls, finite energies."""
    with tempfile.TemporaryDirectory() as tmp:
        deck = deck_path("maxwellian.ini", tmp, output=False)
        for walls in ([], *([f"grid:boundaries={b}",
                             "grid:bndValues=0,0,0,0,0,0"]
                            for b in ("DIRICHLET", "NEUMANN"))):
            out: dict = {}
            label = ("phase 8 maxwellian.ini "
                     + (" ".join(walls) or "periodic"))
            check(cli_main([deck, "grid:nSubdomains=1,1,1",
                            "time:nTimeSteps=5", *walls], out=out) == 0,
                  f"{label}: the CLI failed")
            sim, ke, pe = out["sim"], out["kinetic"].sum(1), out["potential"]
            p = sim.particles
            pos = p.pos()[p.alive]
            L = sim.spec.global_size
            inside = all(float(pos[:, d].min()) >= 0.0
                         and float(pos[:, d].max()) <= L[d] - 1
                         for d in range(3)) if walls else True
            check(type(sim.solver).__name__ == "MultigridSolver"
                  and p.cell.is_cuda and inside and len(ke) == 6
                  and all(math.isfinite(v) for v in list(ke) + list(pe)),
                  f"{label}: solver {type(sim.solver).__name__}, on "
                  f"{p.cell.device}, inside the walls {inside}, energies "
                  f"{ke} {pe}")
            print(f"{label}: {type(sim).__name__} on {p.cell.device}, "
                  f"{p.capacity} slots x {p.n_species} species, 5 steps, "
                  f"total energy {ke[0] + pe[0]:.6g} -> "
                  f"{ke[-1] + pe[-1]:.6g}"
                  f"{', every particle inside the walls' if walls else ''}"
                  f" ({card})", flush=True)


def check_small_decks(cli_main, modules, card: str) -> None:
    """Phase 8.5: langmuirCold1D.ini and langmuir2D.ini on the tiled
    layout without files:output, 20 steps re-bucketed every 5 (the sort):
    pinc_tpu's kernel-free route for 1-D and 2-D decks (no kernel
    launches), the state on the card."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        for name in SMALL_DECKS:
            for m in modules:
                m.reset_launches()
            out: dict = {}
            check(cli_main([deck_path(name, tmp, output=False),
                            "methods:layout=tiled",
                            f"tiles:rebucketEvery={SMALL_REBUCKET}",
                            f"time:nTimeSteps={MG_STEPS}"], out=out) == 0,
                  f"phase 8 {name}: the CLI failed")
            launched = {k: v for m in modules for k, v in m.LAUNCHES.items()
                        if v}
            sim = out["sim"]
            ke, pe = out["kinetic"].sum(1), out["potential"]
            check(type(sim).__name__ == "TiledSimulation" and not launched
                  and sim.state.lpos.is_cuda and out["dropped"] == 0
                  and len(ke) == MG_STEPS + 1
                  and all(math.isfinite(v) for v in list(ke) + list(pe)),
                  f"phase 8 {name}: launches {launched}, dropped "
                  f"{out['dropped']}, energies {ke}")
            print(f"phase 8 {name} tiled: {sim.ts.ntiles} tiles, B = "
                  f"{sim.ts.B}, {sim._backend} route, {sim._rebucket_mode} "
                  f"re-bucket every {sim.rebucket_every_s}, state on {sim.state.lpos.device}, no kernel "
                  f"launch, total energy {ke[0] + pe[0]:.6g} -> "
                  f"{ke[-1] + pe[-1]:.6g} ({card})", flush=True)
            del sim, out
            torch.cuda.empty_cache()


def check_mg_and_walls(cli_main, modules, prod, card: str, run_ms: float,
                       aux_ms: float) -> None:
    """Phase 8: the multigrid solver, deck (a) (the bench deck solved by
    multigrid) through run() and the mega window, decks (b) and (c)
    (Dirichlet and Neumann walls) through run(), the run modes, the small
    tiled decks and the bench deck under methods:debug."""
    import torch
    check_multigrid(card)
    res = run_main_path(cli_main, modules, [], MG_STEPS,
                        deck_text=MG_DECKS["a"])
    sim, a_ms, _ = check_main_path("deck (a) mgSolve, periodic", *res,
                                   MG_STEPS, prod, card, "gather",
                                   phase="8")
    check(type(sim.solver).__name__ == "MultigridSolver",
          "phase 8 deck (a): not solved by multigrid")
    mg_breakdown(sim, "deck (a) run()", card)
    del sim, res
    torch.cuda.empty_cache()
    _, _, scan = run_scan("deck (a) mgSolve, periodic", MG_DECKS["a"],
                          modules, card, dict(M=1, B=prod.B, sched=False),
                          steps=MG_STEPS, fresh=False, phase="8")
    torch.cuda.empty_cache()
    bounded = {}
    for key, label in (("b", "deck (b) Dirichlet walls"),
                       ("c", "deck (c) Neumann walls")):
        res = run_main_path(cli_main, modules, [], MG_STEPS,
                            deck_text=MG_DECKS[key])
        bounded[key] = check_bounded_run(label, *res, MG_STEPS, card)
        mg_breakdown(res[1]["sim"], label, card)
        del res
        torch.cuda.empty_cache()
    print(f"phase 8 ms a step ({card}): deck (a) run() {a_ms:.3f}, window "
          f"{scan['ms_step']:.3f}; deck (b) run() {bounded['b']:.3f}; deck "
          f"(c) run() {bounded['c']:.3f}; with the FFT solve: phase 3's "
          f"run() {run_ms:.3f}, phase 5's aux window {aux_ms:.3f}",
          flush=True)
    check_run_modes(cli_main, card)
    check_maxwellian(cli_main, card)
    check_small_decks(cli_main, modules, card)
    rc, out, launches, wall = run_main_path(
        cli_main, modules, ["methods:debug=true", "population:maxVel=1"],
        DEBUG_STEPS)
    check(rc == 0 and out["dropped"] == 0,
          "phase 8 bench deck with methods:debug: the run failed")
    print(f"phase 8 bench deck with methods:debug=true population:maxVel=1:"
          f" {DEBUG_STEPS} steps, every guard held, {wall:.1f} s including "
          f"set-up ({card})", flush=True)
    del out
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
    # the deposits' density adds must be native integer atomics (a float32
    # or 64-bit shared atomicAdd is a compare-and-swap loop,
    # ATOMS.CAST.SPIN): pic_step's 16 instantiations, deposit and
    # deposit_move's 8
    k5 = shared_atomics(lib, "pic_step_kernel")
    k12 = shared_atomics(lib, "deposit_kernel")
    for name, got, count in (("pic_step", k5, 16),
                             ("deposit and deposit_move", k12, 8)):
        check(len(got) == count and all(ops and set(ops) == {"ATOMS.ADD"}
                                        for ops in got.values()),
              f"{name}'s shared atomics are not all ATOMS.ADD in its "
              f"{count} instantiations: {got}")
    print(f"phase 1 SASS (cuobjdump): pic_step's shared atomics per "
          f"instantiation {sorted({tuple(o.items()) for o in k5.values()})}"
          f"; deposit and deposit_move's "
          f"{sorted({tuple(o.items()) for o in k12.values()})}", flush=True)
    # the kernel benchmark's given_kron runs on the tensor cores (wgmma:
    # HGMMA) in both instantiations (16-byte copies or not), and
    # weight_sums' R sums are native integer shared atomics
    gk = sass_ops(lib, "given_kron_kernel", r"\b(H[G]?MMA\S*)")
    check(len(gk) == 2 and all(gk.values()),
          f"given_kron_kernel's 2 instantiations do not all hold tensor-core "
          f"instructions (HGMMA/HMMA): {gk}")
    ws = shared_atomics(lib, "weight_sums_kernel")
    check(len(ws) == 1 and all(ops and set(ops) == {"ATOMS.ADD"}
                               for ops in ws.values()),
          f"weight_sums_kernel's shared atomics are not all ATOMS.ADD: {ws}")
    # bf16_native sums on the int32 pair: deposit_variant_kernel<1>'s
    # shared atomics (and int8's, <0>) are all native ATOMS.ADD
    dv = shared_atomics(lib, "deposit_variant_kernel")
    bf = {n: o for n, o in dv.items() if "ILi1E" in n}
    check(len(dv) == 2 and len(bf) == 1 and all(
        ops and set(ops) == {"ATOMS.ADD"} for ops in dv.values()),
          f"deposit_variant_kernel<1>'s (bf16_native) and <0>'s shared "
          f"atomics are not all ATOMS.ADD: {dv}")
    print(f"phase 1 SASS (cuobjdump): given_kron_kernel's tensor-core "
          f"instructions per instantiation "
          f"{sorted({tuple(o.items()) for o in gk.values()})}; weight_sums'"
          f" shared atomics {sorted({tuple(o.items()) for o in ws.values()})}"
          f"; deposit_variant_kernel<1>'s (bf16_native) "
          f"{sorted({tuple(o.items()) for o in bf.values()})}", flush=True)
    # the exchange's extract and cleanup walk rows in 16-byte lane groups:
    # every instantiation must load and store 16 bytes at a time (extract:
    # 3 kinds x (K8's R = 8, K11's R = 8 and 1); cleanup: 3 axes tuples x
    # bit copies or x + 0.0)
    # the merges (K9, K11's R = 8 and 1) count and walk their rows in
    # 16-byte groups (their stores to the scattered free slots stay
    # scalar), the ranked merge reads frank and rewrites a placed slot's
    # group 16 bytes at a time, the ranked extract reads rank and alive and
    # writes alive' and its staged columns 16 bytes at a time, efield
    # stages phi and writes its tiles 16 bytes at a time
    # (f32 and bf16, each with P = 11, 13 compiled in and any P), and the
    # fold stages its tiles and writes rho 16 bytes at a time ((T, M) =
    # (8, 1), (8, 2) compiled in and any)
    for kernel, count, ops_needed in (
            ("extract_kernel", 9, ("LDG", "STG")),
            ("cleanup_kernel", 6, ("LDG", "STG")),
            ("merge_rows_kernel", 1, ("LDG",)),
            ("merge_kernel", 2, ("LDG",)),
            ("merge_ranked_kernel", 1, ("LDG", "STG")),
            ("extract_ranked_kernel", 1, ("LDG", "STG")),
            ("efield_kernel", 6, ("LDG", "STG")),
            ("fold_kernel", 3, ("LDG", "STG"))):
        got = wide_accesses(lib, kernel)
        check(len(got) == count and all(
            all(any(op.startswith(k) for op in ops) for k in ops_needed)
            for ops in got.values()),
              f"{kernel}'s {count} instantiations do not all hold 16-byte "
              f"global {' and '.join(ops_needed)}: {got}")
        print(f"phase 1 SASS (cuobjdump): {kernel}'s 16-byte global "
              f"accesses per instantiation "
              f"{sorted({tuple(sorted(o.items())) for o in got.values()})}",
              flush=True)

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
    # K6 and K7 at tests/test_pallas_field.py's grid, M = 1 and 2, a
    # T <= 2M+1 layout (tiles that overlap from both sides), and ntz = 10
    # (K6's runs of 8 tiles along z and a rest of 2)
    for fts in (TileSpec(grid=(16, 24, 32), T=8, M=1, B=128),
                TileSpec(grid=(16, 24, 32), T=8, M=2, B=128),
                TileSpec(grid=(16, 8, 24), T=4, M=2, B=128),
                TileSpec(grid=(16, 16, 80), T=8, M=2, B=128)):
        compare_field(fk, fts, gen, dev, errs,
                      f"fixture {fts.grid} T={fts.T} M={fts.M}")
    # K7's runs of tiles along z at more shapes: ntz = 5, 1, 2 (the run's
    # z-neighbours wrap into it or onto its one tile), T = 6 (rows of rho
    # off a 16-byte boundary) and 3, and M >= T (fold_generic_kernel)
    for grid, T, M in (((16, 8, 40), 8, 1), ((8, 8, 8), 8, 2),
                       ((16, 8, 16), 8, 1), ((12, 6, 18), 6, 2),
                       ((6, 6, 9), 3, 2), ((8, 8, 8), 2, 2)):
        compare_fold(fk, TileSpec(grid=grid, T=T, M=M, B=128), gen, dev)
    print("  fold_global at ntz = 5, 1, 2, T = 6 and 3, M >= T: ok "
          "(bit-equal)", flush=True)
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
        "deposit": (lambda: tk.deposit(xyz, value, prod, mxu_dtype=mdt,
                                       vmax=abs(q_e)),
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
    k, j = tk.deposit_scale((q_e, -q_e), prod.B)
    k1, j1 = tk.deposit_scale([q_e], prod.B)
    print(f"  density accumulator of pic_step, deposit and deposit_move: "
          f"{tk.ACCUMULATOR} fixed point, hi on the grid 2^-{k} and lo on "
          f"2^-{k + j} for pic_step (k = {k}, j = {j} at the bench deck's "
          f"charges and B = {prod.B}), 2^-{k1} and 2^-{k1 + j1} for one "
          f"species' deposit; tiles bit-identical across launches",
          flush=True)
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
    check_ranked_bench(ox, gen, dev, card)
    check_headline_cap(gx, ox, ex, gen, dev, card)
    # the exchange kernels are checked bit-equal (bit pattern for K11)
    errs.update({k: 0.0 for m in (gx, ox) for k in m.LAUNCHES})

    # -- phase 3: the main path through the CLI, default re-bucket --------
    modules = (tk, fk, gx, ox)
    with leftover_spy(gx) as seen:    # a few device ops a merge call
        res = run_main_path(cli_main, modules, [], MAIN_STEPS)
    launches = res[2]
    sim, run_ms, run_psteps = check_main_path(
        "exchange run (default)", *res, MAIN_STEPS, prod, card, "gather")
    print(f"  {leftover_text(seen)}", flush=True)
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

    # -- phase 6: the kernel benchmark (K12, K13) ----------------------------
    from pinc_tpu_torch.ops import kbench_kernels as kb
    from pinc_tpu_torch.ops import kbench_prims as kp
    libs = {}
    kernel_bench(card, launches, times, bounds, errs, libs)
    bounds = {k: v if isinstance(v, tuple) else (v, "bytes")
              for k, v in bounds.items()}

    # -- phase 7: output and checkpoints on the card ----------------------
    check_output(cli_main, modules, card)

    # -- phase 8: bounded walls, multigrid, run modes, small decks --------
    check_mg_and_walls(cli_main, modules, prod, card, run_ms,
                       aux["ms_step"])

    rows = [{"name": name, "route": "cuda",
             "source": getattr(m, "SOURCES", {}).get(name, m.SOURCE),
             "replaces": m.REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": libs.get(name)}
            for m in modules + (kb, kp) for name in m.LAUNCHES]
    check(len(rows) == 27 and all(r["launches"] > 0 for r in rows)
          and all(libs.get(k) for k in kp.LAUNCHES),
          f"expected 27 kernels, each launched on its path, the four "
          f"primitives with their library_ms: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
