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
9. Embedded objects (objects.py; the grids built in memory with
   make_sphere and given to the factory as domain=, the card host having
   no h5py).  9.1: the bench deck with a sphere of radius 16 at (64, 64,
   64) (17,077 interior and 4,784 surface nodes, 243 of 4096 tiles near
   it) and collisionType = absorb,absorb: the object set-up timed (the
   Green's solve, building A, the float64 inversion), 20 steps of run()
   through the factory (K1 and K3 per species and K7 every step and in
   the half kick, the gather exchange at every species event, never K2,
   K4, K5 or K6), nothing dropped, every number finite, the charge of the
   particles and rho_obj conserved from the cull on within 1e-5 of the
   gross charge, the object charge and potential negative; one object
   step split by CUDA events; then make_scan_steps(20, donate=True) with
   the same checks, and both ms a step beside phase 8's walled decks.
   9.2: reflect,secondary (secondaries into the electrons) for 10 steps
   with the same checks, the emitted count and the count with no free
   slot.  9.3: input/sphereObject.ini (flat, mgSolve, 32^3, a sphere of
   radius 4) for 5 steps on the card and on the port's CPU path, as
   shipped and with adhere,backscatter: equal alive counts, rho_obj and
   phi_c within the CPU tests' tolerances; one step and a solve timed.
   9.4: that deck inside Dirichlet walls of zero value on the tiled
   layout: the batched capacitance set-up (296 unit charges) timed, its
   first batch's cycle counts against the CPU's, then 5 steps of run()
   with 9.1's checks and every particle inside the walls.
10. The multi-device layer (parallel/) on meshes that name the one card
   several times.  10.1: input/bench_scaleout.ini as shipped (256 x 128 x
   128, 2 x 32 a cell; each shard carries phase 3's per-card deck, at
   phase 2's local shapes) through make_simulation(cfg, devices=[cuda:0,
   cuda:0]): 20 steps of run() (per shard: K2 and K4 once a species a
   step, K1 and K3 in the half kick, the gather exchange's kernels at each
   species event; K6 and K7 never), then an untimed and a timed 40-step
   make_scan_steps window (K5 once a shard a step), each with phase 3's
   checks (no drop, alive conserved, energies finite and within 1%); ms a
   step beside phase 3's run() and phase 5's aux window, and the share of
   the torch fold/pad and their halo plane copies (CUDA events).  10.2:
   the flat and the tiled class over (2, 2, 2) on [cuda:0] * 8 against the
   same global deck on cuda:0, 8 steps, within the CPU tests' tolerances.
   10.3: input/maxwellian.ini and input/langmuirCold.ini as shipped over
   [cuda:0] * 4, 20 steps, the sharded multigrid's cycles a solve, against
   the deck at nSubdomains = 1,1,1, trueSize = 32,32,32.  10.4: the
   solvers at 256 x 128 x 128 over two shards: the replicated against the
   pencil FFT, the sharded against the single V-cycle, ms of each.  10.5:
   the CLI on maxwellian.ini: with fewer than four cards pinc_tpu's "deck
   wants 4 devices", never the CPU.
11. Decomposed object decks on meshes that name the one card several
   times, the object grids built in memory with make_sphere and given as
   domain=.  11.1: input/bench_scaleout.ini as shipped (256 x 128 x 128,
   2,1,1) with a sphere of radius 16 at (128, 64, 64), across the shard
   boundary (its 4,784 surface nodes and its near-object tiles on both
   shards), absorb,absorb, through make_simulation(cfg, devices=[cuda:0,
   cuda:0], domain=...): the set-up timed, 20 steps of run(), then an
   untimed and a timed 20-step make_scan_steps window, the kernels
   counted a shard (K1 a species a step and in the half kick, K3 a
   species in the half kick, K4 a species a step: the sharded tiled
   _local_kick's full kick on the pallas route, as pinc_tpu's; the gather
   exchange at each species event; never K2, K5, K6 or K7), each with
   phase 9.1's checks (nothing dropped, every number finite, the
   particles' charge plus rho_obj conserved from the cull on within 1e-5
   of the gross charge, the object's charge and potential negative); one
   object step and its object work by CUDA events; ms a step beside phase
   9.1's single-card object deck and phase 10.1's sharded deck without
   objects.  11.2: reflect,secondary at 11.1's size for 10 steps with the
   same checks, the emitted secondaries and those with no free slot
   summed over the shards.  11.3: the CPU tests' 16^3 sphere decks, the
   flat class over [cuda:0] * 8 and the tiled over [cuda:0] * 2, against
   the same global deck on cuda:0: equal alive counts, energies, rho_obj
   and phi_c within the CPU tests' tolerances.  11.4:
   input/sphereObject.ini (flat, mgSolve, 32^3) with grid:nSubdomains =
   1,2,2 over [cuda:0] * 4 against its 1,1,1 deck, 5 steps: equal alive
   counts, rho_obj and phi_c within tolerance, the same multigrid cycles
   each solve.
12. Runs over several processes on the one card: ``python -m
   torch.distributed.run --standalone --nproc-per-node=2 chip_smoke.py
   --phase12 DIR`` (torchrun's environment; ``phase12_child``), after
   12.0, the launch a user types (``torchrun --standalone
   --nproc-per-node=2 -m pinc_tpu_torch input/bench_scaleout.ini``, 4
   steps: rc 0, each rank's STATUS line naming cuda:0 and gloo); both
   processes on cuda:0 over gloo (NCCL refuses two ranks on one card, so
   its card run waits for a multi-card host), each logging its rank,
   device and backend; any process's failure fails the phase.  12.1:
   input/bench_scaleout.ini as shipped through the CLI's main(), one
   shard a process, 20 run() steps, then an untimed and a timed 40-step
   window from run()'s state, against phase 10.1 (the same deck over
   [cuda:0] * 2 in one process; its windows from the same state):
   equal alive counts, nothing dropped, the same launches a shard
   (K1-K5, K8-K10), energies bit for bit where they are, else within 1e-6
   of their maxima (the phase says which), ms a step beside 10.1's.
   12.2: phase 10.2's tiled deck over (2, 2, 2), four shards a process
   (B = 384: K11's per-tile sweeps), against 10.2's 8-shard mesh.  12.3:
   input/maxwellian.ini as shipped (flat, the sharded multigrid) over
   (1, 2, 2), two shards a process, 5 steps, against the first 5 of
   10.3's: the same multigrid cycles every solve and alive counts; and
   the pencil FFT of 10.4's rho at 256 x 128 x 128 over two processes
   against 10.4's.
   12.4: 11.1's object deck, one shard a process, 20 run() steps against
   11.1's, the charge conserved within 1e-5 of the gross charge.  The
   card host has no h5py: the output files and checkpoints over
   processes are checked by the CPU tests only
   (tests/test_torch_multiprocess.py).
13. The repo's framework and verification tools, ported
   (check_verification): 13.1 verification.dispersion at its defaults
   (600 steps; modes 1-2 within 15% of Bohm-Gross), 13.2
   verification.pumode all (the tool's orders), 13.3 script.validate at
   200 steps (VALIDATION PASS: its exchange check's five combinations, each
   on its route by the launch counts, then the 128^3 deck at 16 per cell),
   13.4 cbaseline.drift, 4 chunks of 50 steps with retune() between, on
   the mega scan body (K5) and then on the in-step fused body
   (tiles:mega=false: K2, K4), each on its route by its launches and held
   to the same gates (nothing lost or dropped, E(1) within 0.2% of the C
   reference's 7.66067e8, |total drift| <= 0.2%; the 10k-step run is the
   tool's own),
   13.5 verification.sweep dt --inproc (every drift finite), 13.6
   script.framework.mg_optimizing on maxwellian.ini at 32^3 on one shard,
   one round (the best setting solved to the tolerance, its rms error
   within 2.5 times the deck's own setting's), 13.7
   Pinc(langmuirCold1D.ini).getnp() and .run() and pinc_tpu_torch/mpinc.sh
   on the same deck, in child processes (rc 0).

Every phase that fails exits non-zero.  Without a CUDA card the script
exits non-zero before printing any result.  The line before the last is a
JSON object with each kernel's numbers (launches on the path that runs
it: phase 3's exchange run, its one-hot runs for the one-hot kernels (the
row kernels the B = 7680 run, the per-tile ones the B = 6528 run), for
pic_step, efield_tiles and fold_global the headline scan window of phase
5, plus phase 11.1's launches (both shards, run() and its two windows)
for deposit, gather, gather_kick and the gather exchange's kernels, plus
phase 12's (both processes: 12.1's run() and windows, 12.2, 12.4) for
K1-K5 and K8-K11, plus phase 13's (13.3, 13.4) for K1, K2, K4-K11, for the
kbench kernels (one row a mode) and the four
primitives phase
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
                       aux_ms: float) -> dict:
    """Phase 8: the multigrid solver, deck (a) (the bench deck solved by
    multigrid) through run() and the mega window, decks (b) and (c)
    (Dirichlet and Neumann walls) through run(), the run modes, the small
    tiled decks and the bench deck under methods:debug.  Returns the
    run() ms a step of decks (a)-(c)."""
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
    return {"a": a_ms, **bounded}


# -- phase 9: embedded objects ------------------------------------------------
OBJ_CENTRE, OBJ_RADIUS = (64, 64, 64), 16   # the full-width sphere
OBJ_NODES = (17077, 4784)     # its interior and surface nodes
OBJ_NEAR_TILES = 243          # of 4096 tiles of 8^3
OBJ_STEPS = 20                # run() and the window, absorb
OBJ_RESP_STEPS = 10           # reflect,secondary
SHIPPED_STEPS = 5             # input/sphereObject.ini, flat and walled
SHIPPED_SPHERE = ((32, 32, 32), (16, 16, 16), 4)   # its header's grid
SHIPPED_SURFACE = 296
OBJ_CHARGE_RTOL = 1e-5        # charge conservation, of the gross charge
OBJ_RHO_RTOL = 1e-5           # card vs CPU: rho_obj of max|rho_obj| (+
OBJ_PHI_RTOL, OBJ_PHI_ATOL = 1e-4, 1e-7   # 1e-7 max|q|), phi_c


def obj_deck(ctypes: str, extra: str = "") -> str:
    """The bench deck with a sphere (given in memory as domain=) and the
    responses, on the tiled layout."""
    return (f"[objects]\nobjects = sphere128.grid.h5\ncollisionType = "
            f"{ctypes}\n{extra}" + BENCH_DECK.replace(
                "migrate = puExtractEmigrantsND",
                "migrate = puExtractEmigrantsND\nlayout = tiled"))


def obj_charge_total(sim, st, rho_obj, cull: bool = False):
    """(sum_s q_s alive_s + sum(rho_obj), sum_s |q_s| alive_s) in float64
    from a tiled state on the card, or a sharded one (a list of the
    shards' states); cull=True counts only the particles the initial cull
    keeps (floor cell outside the object)."""
    import torch
    from pinc_tpu_torch.objects import _at, _cell_of
    from pinc_tpu_torch.ops.tiled import tile_origins
    sharded = isinstance(st, list)
    q = [float(v) for v in sim.params.charge]
    total = gross = 0.0
    for i, sti in enumerate(st if sharded else [st]):
        if sti is None:               # another process's shard
            continue
        org = tile_origins(sim.ts_local if sharded else sim.ts,
                           sti.lpos.device)
        if sharded:
            from pinc_tpu_torch.parallel.mesh import subdomain_offset
            org = org + torch.tensor(subdomain_offset(sim.ctx, i),
                                     dtype=org.dtype, device=org.device)
        for s in range(sti.alive.shape[0]):
            alive = sti.alive[s] > 0.5
            if cull:
                g = (sti.lpos[s] + org.T[:, :, None]).movedim(0, -1)
                alive = alive & (_at(sim.objects.interior_id,
                                     _cell_of(g, sim.ts.grid)) == 0)
                del g
            n = int(alive.sum())
            total += q[s] * n
            gross += abs(q[s]) * n
    if rho_obj is not None:
        total += float(rho_obj.double().sum())
    return total, gross


def obj_launch_check(label: str, launches: dict, S: int, steps: int,
                     kick: int, events: int) -> dict:
    """K1 and K3 per species a step (and in the half kick), K7 once a
    step, the gather exchange at every species event; never K2, K4, K5
    or K6."""
    want = {"deposit": S * (steps + kick), "gather": S * (steps + kick),
            "fold_global": steps + kick}
    want.update({k: n * events for k, n in ROUTE_CALLS["gather"].items()
                 if events})
    got = {k: v for k, v in launches.items() if v}
    check(got == want, f"{label}: launches {got}, expected {want}")
    return got


def obj_setup_text(sim, seconds: float) -> str:
    su = sim.objects.setup
    return (f"set-up {seconds:.2f} s (the solves {su['solve_s']:.3f} s, "
            f"building A {su['matrix_s']:.3f} s, the float64 inversion "
            f"{su['invert_s']:.3f} s)")


def make_obj_sim(deck: str, dom, device, overrides=(), devices=None):
    """The factory (parallel/pic.py) on a deck text, the object grid given
    as domain= (and a mesh's devices); returns (sim, host seconds)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel.pic import make_simulation
    cfg = PincConfig.from_string(deck)
    for o in overrides:
        k, v = o.split("=", 1)
        cfg.set_str(k, v)
    t0 = time.monotonic()
    sim = make_simulation(cfg, device=device, domain=dom, devices=devices)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return sim, time.monotonic() - t0


def obj_run(label: str, sim, modules, steps: int, card: str,
            negative: bool) -> float:
    """run() on an object deck on the card with phase 9's checks; returns
    the mean ms a step (steps 2-n, re-buckets included)."""
    import numpy as np
    import torch
    S = sim.state.alive.shape[0]
    q0, gross = obj_charge_total(sim, sim.state, None, cull=True)
    sim.n_time_steps = steps
    for m in modules:
        m.reset_launches()
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    events = launches["extract"]
    scheduled = sum(steps // R for R in sim.rebucket_every_s)
    check(events == scheduled or (events > scheduled and hist["n_lost"]),
          f"{label}: {events} re-bucket events, {scheduled} scheduled")
    got = obj_launch_check(label, launches, S, steps, 1, events)
    st = sim.state
    check(st.lpos.is_cuda and sim.rho_obj.is_cuda
          and sim.objects.interior_id.is_cuda,
          f"{label}: a tensor of the run left the card")
    check(hist["dropped"] == 0, f"{label}: {hist['dropped']} dropped")
    ke, pe = hist["kinetic"].sum(axis=1), hist["potential"]
    finite = (all(math.isfinite(v) for v in list(ke) + list(pe))
              and bool(torch.isfinite(sim.rho_obj).all())
              and np_finite(sim.last_obj_potential))
    check(finite and len(ke) == steps + 1, f"{label}: non-finite numbers")
    total, _ = obj_charge_total(sim, st, sim.rho_obj)
    check(abs(total - q0) <= OBJ_CHARGE_RTOL * gross,
          f"{label}: charge {q0:.9g} after the cull -> {total:.9g} "
          f"(gross {gross:.6g})")
    q_obj = float(sim.objects.object_charge(sim.rho_obj)[0])
    phi_c = float(sim.last_obj_potential[0])
    if negative:
        check(q_obj < 0.0 and phi_c < 0.0,
              f"{label}: object charge {q_obj:.6g}, potential {phi_c:.6g}")
    step_ms = float(np.mean(hist["step_seconds"][1:])) * 1e3
    n_alive = int((st.alive > 0.5).sum())
    print(f"phase 9 {label}: {steps} steps of run(); launches {got} "
          f"({events} species re-bucket events, {hist['n_lost']} margin "
          f"hits); state on cuda, {n_alive} alive, 0 dropped; charge "
          f"{q0:.9g} after the cull -> {total:.9g} (|d| / gross "
          f"{abs(total - q0) / gross:.2e}); object charge {q_obj:.6g}, "
          f"potential {phi_c:.6g}; total energy {ke[0] + pe[0]:.9g} -> "
          f"{ke[-1] + pe[-1]:.9g}; {step_ms:.3f} ms a step (mean of "
          f"steps 2-{steps}, re-buckets included) ({card})", flush=True)
    return step_ms


def np_finite(x) -> bool:
    import numpy as np
    return x is not None and bool(np.isfinite(np.asarray(x)).all())


def obj_window(label: str, sim, modules, steps: int, card: str) -> float:
    """make_scan_steps(steps, donate=True) from the run's final state and
    rho_obj, with phase 9's checks; returns ms a step."""
    import torch
    S = sim.state.alive.shape[0]
    st = sim.state
    q0, gross = obj_charge_total(sim, st, sim.rho_obj)
    run_n = sim.make_scan_steps(steps, donate=True)
    events = sum(len(a) for kind, a in run_n.plan if kind == "rebucket")
    for m in modules:
        m.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    (st, rho_obj), (ke, pe, dropped, phi_c) = run_n(st, sim.rho_obj)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    got = obj_launch_check(label, launches, S, steps, 0, events)
    check(all(t.is_cuda for t in (st.lpos, rho_obj, ke, pe, phi_c)),
          f"{label}: a tensor of the window left the card")
    check(int(dropped) == 0, f"{label}: {int(dropped)} dropped")
    check(bool(torch.isfinite(ke).all() and torch.isfinite(pe).all()
               and torch.isfinite(phi_c).all()
               and torch.isfinite(rho_obj).all())
          and tuple(ke.shape) == (steps, S), f"{label}: non-finite numbers")
    total, _ = obj_charge_total(sim, st, rho_obj)
    check(abs(total - q0) <= OBJ_CHARGE_RTOL * gross,
          f"{label}: charge {q0:.9g} -> {total:.9g} (gross {gross:.6g})")
    q_obj = float(sim.objects.object_charge(rho_obj)[0])
    check(q_obj < 0.0 and float(phi_c[-1, 0]) < 0.0,
          f"{label}: object charge {q_obj:.6g}, potential "
          f"{float(phi_c[-1, 0]):.6g}")
    sim.state, sim.rho_obj = st, rho_obj
    ms = wall / steps * 1e3
    print(f"phase 9 {label}: make_scan_steps({steps}, donate=True): "
          f"launches {got} ({events} species re-bucket events); 0 dropped;"
          f" charge {q0:.9g} -> {total:.9g} (|d| / gross "
          f"{abs(total - q0) / gross:.2e}); object charge {q_obj:.6g}, "
          f"potential {float(phi_c[-1, 0]):.6g}; {ms:.3f} ms a step "
          f"({card})", flush=True)
    return ms


def obj_breakdown(sim, card: str) -> None:
    """Device time of each part of one object step (_tiled_step_obj) on
    the final state, by CUDA events: the drift and margin count, the
    absorb on the near-object tiles, the spread into rho_obj, K1 x S + K7,
    the two solves, the capacitance, E, K3 + the kick."""
    import torch
    from pinc_tpu_torch.tiled_sim import TiledState
    st, rho_obj = sim.state, sim.rho_obj
    S = st.alive.shape[0]

    def fresh():
        return (TiledState(lpos=st.lpos.clone(), vel=st.vel.clone(),
                           alive=st.alive.clone()),)
    _, counter, _ = sim._absorb(*fresh())
    rho = sim._deposit_rho(st) + rho_obj
    phi = sim.solver(rho)
    rho_c, _ = sim.objects.apply_capacitance(rho, phi)
    E = sim._efield(phi)
    ns = len(sim.objects.surface_idx[0])
    parts = {
        "whole object step (no re-bucket)": (
            lambda: fresh() + (rho_obj,), sim._tiled_step_obj),
        "drift + margin count": (None, lambda: sim._out_of_margin(
            TiledState(lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive))),
        f"absorb, {S} species on {sim._obj_tiles.numel()} near-object "
        f"tiles": (fresh, sim._absorb),
        "spread into rho_obj": (None, lambda: sim._spread_obj_charge(
            rho_obj, counter)),
        f"K1 deposit x {S} + K7 fold_global": (
            None, lambda: sim._deposit_rho(st)),
        "solve 1 (FFT)": (None, lambda: sim.solver(rho)),
        f"capacitance (C of {ns}^2)": (
            None, lambda: sim.objects.apply_capacitance(rho, phi)),
        "solve 2 (FFT)": (None, lambda: sim.solver(rho_c)),
        "E = -grad(phi)": (None, lambda: sim._efield(phi)),
        f"K3 gather + kick x {S}": (None, lambda: sim._kick(st, E, False)),
    }
    print(f"phase 9 one object step by CUDA events ({card}):", flush=True)
    for name, (setup, fn) in parts.items():
        ms = (cuda_ms(fn, reps=2, warmup=1) if setup is None
              else cuda_ms_fresh(setup, fn, reps=2))
        print(f"  {name}: {ms:.3f} ms", flush=True)
    del rho, phi, rho_c, E
    torch.cuda.empty_cache()


def check_shipped_deck(card: str) -> None:
    """Phase 9.3: input/sphereObject.ini (flat, mgSolve, 32^3, the sphere
    of radius 4 its header names, given as domain=) for 5 steps on the
    card and on the port's CPU path, with its collisionType and with
    adhere,backscatter: equal alive counts, rho_obj and phi_c within the
    CPU tests' tolerances."""
    import numpy as np
    import torch
    from pinc_tpu_torch.objects import make_sphere
    dom = make_sphere(*SHIPPED_SPHERE)
    with tempfile.TemporaryDirectory() as tmp:
        with open(deck_path("sphereObject.ini", tmp, output=False)) as f:
            text = f.read()
    for extra in ([], ["objects:collisionType=adhere,backscatter"]):
        runs = {}
        for dev in ("cuda", "cpu"):
            sim, setup_s = make_obj_sim(
                text, dom, dev, [f"time:nTimeSteps={SHIPPED_STEPS}",
                                 *extra])
            t0 = time.monotonic()
            hist = sim.run(progress_every=0)
            runs[dev] = (sim, hist, setup_s, time.monotonic() - t0)
        (g, hg, sg, wg), (c, hc, _, wc) = runs["cuda"], runs["cpu"]
        label = "phase 9 sphereObject.ini " + (
            " ".join(extra) or "(absorb, as shipped)")
        check(type(g).__name__ == "Simulation"
              and type(g.solver).__name__ == "MultigridSolver"
              and g.particles.cell.is_cuda,
              f"{label}: {type(g).__name__} / {type(g.solver).__name__} on "
              f"{g.particles.cell.device}")
        ag = g.particles.alive.sum(1).cpu().numpy()
        ac = c.particles.alive.sum(1).numpy()
        check((ag == ac).all(), f"{label}: alive {ag} on the card, {ac} on "
              f"the CPU")
        q = np.abs(c.params.charge.numpy()).max()
        drho = float(np.abs(g.last_rho_obj - c.last_rho_obj).max())
        tol = OBJ_RHO_RTOL * float(np.abs(c.last_rho_obj).max()) + 1e-7 * q
        check(drho <= tol, f"{label}: rho_obj differs by {drho:.3g} (tol "
              f"{tol:.3g})")
        check(np.allclose(g.last_obj_potential, c.last_obj_potential,
                          rtol=OBJ_PHI_RTOL, atol=OBJ_PHI_ATOL)
              and np_finite(hg["kinetic"]),
              f"{label}: phi_c {g.last_obj_potential} on the card, "
              f"{c.last_obj_potential} on the CPU")
        rho = g.distr(g.particles, g.params, g.spec.global_size,
                      periodic=g._periodic_dims, dtype=g.spec.dtype)
        _, n_cyc, _ = g.solver.solve_with_stats(rho + g.rho_obj)
        solve_ms = cuda_ms(lambda: g.solver(rho + g.rho_obj), reps=2,
                           warmup=1)
        step_ms = cuda_ms(lambda: g._step(g.particles, g.rho_obj), reps=2,
                          warmup=1)
        print(f"{label}: one step on the final state {step_ms:.3f} ms, of "
              f"which a solve {solve_ms:.3f} ms ({n_cyc} cycles; two a "
              f"step) ({card})", flush=True)
        print(f"{label}: flat, mgSolve, {SHIPPED_STEPS} steps; alive {ag} "
              f"on the card and the CPU; max|d rho_obj| {drho:.3g}; phi_c "
              f"{float(g.last_obj_potential[0]):.8g} / "
              f"{float(c.last_obj_potential[0]):.8g}; card: "
              f"{obj_setup_text(g, sg)}, run {wg:.2f} s; CPU run {wc:.2f} s"
              f" ({card})", flush=True)
        del runs, g, c
        torch.cuda.empty_cache()


def check_walled_object_deck(modules, card: str) -> None:
    """Phase 9.4: the shipped deck inside Dirichlet walls of zero value on
    the tiled layout: the batched capacitance set-up (296 unit charges in
    batches of 16) timed, its first batch's cycle counts against the
    CPU's, then 5 steps of run() with phase 9's checks and every particle
    inside the walls."""
    import numpy as np
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.objects import find_surface, make_sphere
    from pinc_tpu_torch.solvers.multigrid import make_from_config
    from pinc_tpu_torch.units import alloc_and_normalize
    dom = make_sphere(*SHIPPED_SPHERE)
    with tempfile.TemporaryDirectory() as tmp:
        with open(deck_path("sphereObject.ini", tmp, output=False)) as f:
            text = f.read()
    walls = ["grid:boundaries=DIRICHLET", "grid:bndValues=0,0,0,0,0,0",
             "methods:layout=tiled"]
    sim, setup_s = make_obj_sim(text, dom, "cuda", walls)
    label = "phase 9 sphereObject.ini in Dirichlet walls, tiled"
    su = sim.objects.setup
    ns = len(sim.objects.surface_idx[0])
    check(ns == SHIPPED_SURFACE and not sim.objects.periodic
          and len(su["cycles"]) == -(-ns // 16),
          f"{label}: {ns} surface nodes, {len(su['cycles'])} batches")
    cfg = PincConfig.from_string(text)
    for o in walls:
        k, v = o.split("=", 1)
        cfg.set_str(k, v)
    alloc_and_normalize(cfg)
    idx = np.flatnonzero(find_surface(dom, 1)[0].ravel())[:16]
    rhs = torch.zeros((len(idx), dom.size))
    rhs[torch.arange(len(idx)), torch.as_tensor(idx)] = 1.0
    t0 = time.monotonic()
    _, cpu_cycles, _ = make_from_config(cfg).solve_batch_with_stats(
        rhs.reshape((-1,) + dom.shape))
    cpu_s = time.monotonic() - t0
    card_cycles = su["cycles"][0]
    check((card_cycles == cpu_cycles).all(),
          f"{label}: first batch's cycles {card_cycles.tolist()} on the "
          f"card, {cpu_cycles.tolist()} on the CPU")
    print(f"{label}: {ns} surface nodes in {len(su['cycles'])} batches of "
          f"16; {obj_setup_text(sim, setup_s)}; the first batch's cycles "
          f"{card_cycles.tolist()} on the card and on the CPU ({cpu_s:.2f} "
          f"s there); cycles of all batches {sorted(set(int(c) for b in su['cycles'] for c in b))} ({card})", flush=True)
    obj_run("sphereObject.ini in Dirichlet walls, tiled", sim, modules,
            SHIPPED_STEPS, card, negative=False)
    spans = walls_ok(sim)
    check(all(lo >= 0.0 and hi <= g - 1 for (lo, hi), g
              in zip(spans, sim.ts.grid)),
          f"{label}: particles outside [0, L-1]: {spans}")
    del sim
    torch.cuda.empty_cache()


def check_objects(modules, card: str, walled_ms: dict) -> float:
    """Phase 9: embedded objects on the card (see the module docstring);
    returns 9.1's ms a run() step."""
    import torch
    from pinc_tpu_torch.objects import make_sphere
    t_phase = time.monotonic()
    dom = make_sphere((128,) * 3, OBJ_CENTRE, OBJ_RADIUS)
    # 9.1: the full-width absorb deck, run() then the window
    sim, setup_s = make_obj_sim(obj_deck("absorb,absorb"), dom, "cuda")
    obj = sim.objects
    n_int = int((obj.interior_id > 0).sum())
    n_surf = len(obj.surface_idx[0])
    check((n_int, n_surf) == OBJ_NODES
          and sim._obj_tiles.numel() == OBJ_NEAR_TILES
          and type(sim).__name__ == "TiledSimulation"
          and not sim._use_fused and not sim._use_mega,
          f"phase 9: {n_int} interior, {n_surf} surface nodes, "
          f"{sim._obj_tiles.numel()} near tiles, {type(sim).__name__}, "
          f"fused {sim._use_fused}")
    print(f"phase 9.1 full-width sphere (radius {OBJ_RADIUS} at "
          f"{OBJ_CENTRE}, 128^3, {n_int} interior and {n_surf} surface "
          f"nodes, C {n_surf}^2 f32 = "
          f"{n_surf ** 2 * 4 / 1e6:.1f} MB on the card, "
          f"{sim._obj_tiles.numel()} of {sim.ts.NT} tiles near the object; "
          f"B = {sim.ts.B}, M = {sim.ts.M}, cadences "
          f"{sim.rebucket_every_s}): {obj_setup_text(sim, setup_s)} "
          f"({card})", flush=True)
    run_ms = obj_run("9.1 absorb,absorb", sim, modules, OBJ_STEPS, card,
                     negative=True)
    obj_breakdown(sim, card)
    win_ms = obj_window("9.1 absorb,absorb window", sim, modules,
                        OBJ_STEPS, card)
    print(f"phase 9.1 ms a step ({card}): object run() {run_ms:.3f}, object "
          f"window {win_ms:.3f}; the unfused walled decks (phase 8, "
          f"this run): (b) Dirichlet {walled_ms['b']:.3f}, (c) Neumann "
          f"{walled_ms['c']:.3f}", flush=True)
    del sim, obj
    torch.cuda.empty_cache()
    # 9.2: reflecting electrons, ions emitting secondary electrons
    sim, setup_s = make_obj_sim(obj_deck("reflect,secondary",
                                         "seeSpecies = 0\n"), dom, "cuda")
    obj_run("9.2 reflect,secondary", sim, modules, OBJ_RESP_STEPS, card,
            negative=False)
    print(f"phase 9.2 secondaries emitted {int(sim.see_emitted)}, found no "
          f"free slot {int(sim.see_overflow)} ({card})", flush=True)
    del sim
    torch.cuda.empty_cache()
    # 9.3 and 9.4: the shipped deck
    check_shipped_deck(card)
    check_walled_object_deck(modules, card)
    print(f"phase 9: {time.monotonic() - t_phase:.1f} s", flush=True)
    return run_ms


# -- phase 10: the multi-device layer on a mesh of the one card ------------

SCALEOUT_STEPS = 20   # run() steps of 10.1 (two electron re-bucket events)
SCALEOUT_WINDOW = 40  # the 10.1 window: bench_scaleout.ini's nTimeSteps
PARITY_STEPS = 8      # 10.2, a re-bucket every 2 steps on the tiled deck
MG_DECK_STEPS = 20    # 10.3
# 10.2's decks: tests/test_parallel.py's DECK_3D (flat) and
# tests/test_tiled_sharded.py's deck (tiled), (2, 2, 2) at 8^3 local
PARITY_FLAT = """
[time]
nTimeSteps = 8
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 16 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.3
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrants3D
"""
PARITY_TILED = PARITY_FLAT.replace("8 pc", "4 pc").replace(
    "16 pc", "4 pc").replace("0.1,0.01", "0.08,0.002").replace(
    "drift = 0.3", "drift = 0.05").replace(
    "perturbAmplitude = 0.01,0,0,0,0,0\nperturbMode = 1,0,0,0,0,0\n",
    "") + "layout = tiled\n[tiles]\ntileSize = 4\nmargin = 1\n" \
    "rebucketEvery = 2\n"


def shard_counts(mesh, names) -> dict:
    """{shard: {kernel: launches}} of the kernels ``names`` since the last
    reset_shard_launches()."""
    return {i: {k: c[k] for k in names if c[k]}
            for i, c in sorted(mesh.SHARD_LAUNCHES.items())}


def glue_ms(sim, card: str) -> dict:
    """10.1's glue on the sharded tiled path, by CUDA events at the deck's
    local shapes, over both shards: the torch fold of the density tiles,
    the padded E tiles of K4 and of K5's window, each with its halo planes
    from the other shard (roll_fns) and with the plain periodic roll in
    their place; the difference is the plane copies and their cats."""
    import torch
    from pinc_tpu_torch.ops import tiled as tl
    ctx, ln = sim.ctx, sim.ts_local
    rolls = sim._roll_fns()
    gen = torch.Generator(device="cuda").manual_seed(10)
    tiles = [torch.rand((ln.NT, ln.P, ln.P * ln.P), device=d, generator=gen)
             for d in ctx.devices]
    E = [torch.rand(ctx.true_size + (3,), device=d, generator=gen)
         for d in ctx.devices]
    P = ln.P
    parts = {
        "fold": lambda r: lambda t: tl.fold_to_global(t, ln, roll_fns=r),
        "pad": lambda r: lambda e: tl.pad_tiles(e, ln, roll_fns=r)
        .float().contiguous(),
        "pad_cmajor": lambda r: lambda e: tl.pad_tiles_cmajor(
            e, ln, roll_fns=r).reshape(ln.NT, 3 * P, P * P).contiguous()}
    out = {}
    for name, make in parts.items():
        arg = tiles if name == "fold" else E
        out[name] = cuda_ms(lambda: ctx.shard_map(make(rolls), arg), 5, 1)
        out[name + "_roll"] = cuda_ms(
            lambda: [make(None)(a) for a in arg], 5, 1)
    print("phase 10.1 glue, both shards, CUDA events around the call (" +
          card + "): " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
          + "; '_roll': the same op with the periodic roll in place of the "
          "other shard's planes, the shards called in turn without threads "
          "(the events see the host where it is slower than the card)",
          flush=True)
    return out


def scaleout_breakdown(sim, card: str, steps: int = 2) -> None:
    """10.1's device time of a run() step by torch.profiler (CUDA
    activities of both shards' threads), on the state run() left: the
    total and the largest kernels and ops a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st = sim.state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            st, *_ = sim._tiled_step(st)
        torch.cuda.synchronize()
    sim.state = st
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
             / steps) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    print(f"phase 10.1 a run() step's device time (torch.profiler, {steps} "
          f"steps, {card}): {total:.3f} ms; "
          + "; ".join(f"{k[:48]} {ms:.3f}" for k, ms in rows[:8]),
          flush=True)


def check_scaleout(modules, card: str, prod, run_ms: float,
                   window_ms: float) -> float:
    """Phase 10.1: input/bench_scaleout.ini as shipped (256 x 128 x 128,
    2 x 32 a cell: each shard carries phase 3's per-card deck) through
    make_simulation(cfg, devices=[cuda:0, cuda:0])."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel import mesh
    from pinc_tpu_torch.parallel.pic import make_simulation
    from pinc_tpu_torch.parallel.tiled_pic import ShardedTiledSimulation
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PincConfig.from_file(deck_path("bench_scaleout.ini", tmp),
                                   [f"time:nTimeSteps={SCALEOUT_STEPS}"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sim = make_simulation(cfg, devices=[dev, dev])
    setup_s = time.monotonic() - t0
    ln = sim.ts_local
    check(isinstance(sim, ShardedTiledSimulation)
          and sim.ctx.devices == [dev, dev] and sim._use_fused
          and sim._use_mega and (ln.T, ln.M, ln.B, ln.NT)
          == (prod.T, prod.M, prod.B, prod.NT),
          f"phase 10.1: {type(sim).__name__} on {sim.ctx.devices}, local "
          f"T={ln.T} M={ln.M} B={ln.B} NT={ln.NT} (phase 2 held the "
          f"kernels at T={prod.T} M={prod.M} B={prod.B} NT={prod.NT})")
    S = len(sim._charge)
    n0 = sum(int((s.alive > 0.5).sum()) for s in sim.state)
    print(f"phase 10.1 bench_scaleout.ini: {sim.ctx.n_subdomains} mesh of "
          f"{sim.ctx.devices}, {sim.ts.ntiles} tiles ({ln.ntiles} a shard) "
          f"of {ln.T}^3, B={ln.B}, M={ln.M}, cadences "
          f"{sim.rebucket_every_s}, face cap {sim._exchange_cap}, rows "
          f"{sim._exchange_rows}, solve "
          f"{getattr(sim._solve, '__name__', type(sim._solve).__name__)}, "
          f"{n0} particles, set-up {setup_s:.1f} s", flush=True)
    step_names = ("deposit", "gather", "deposit_move", "gather_kick",
                  "pic_step") + tuple(ROUTE_CALLS["gather"])
    # run(): the launch counts set to 0 just before and read just after
    for m in modules:
        m.reset_launches()
    mesh.reset_shard_launches()
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    per_shard = shard_counts(mesh, step_names)
    # species events: the scheduled ones, and every species again at a
    # step where a particle reached the margin (run()'s early re-bucket)
    scheduled = sum(SCALEOUT_STEPS // R for R in sim.rebucket_every_s)
    events = per_shard.get(0, {}).get("extract", 0)
    want = {"deposit": S, "gather": S, "deposit_move": S * SCALEOUT_STEPS,
            "gather_kick": S * SCALEOUT_STEPS}
    want.update({k: n * events for k, n in ROUTE_CALLS["gather"].items()})
    print(f"  run() launches per shard {per_shard}; all {launches}; "
          f"{events} species events ({scheduled} scheduled, "
          f"{hist['n_lost']} particle(s) reached the margin)", flush=True)
    check(per_shard == {0: want, 1: want} and scheduled >= 2
          and (events == scheduled
               or (events > scheduled and hist["n_lost"] > 0))
          and hist["dropped"] == 0
          and launches == {k: 2 * v for k, v in want.items()},
          f"phase 10.1 run(): per shard {per_shard}, expected {want} "
          f"({events} species events, {scheduled} scheduled), "
          f"{hist['n_lost']} margin hits, {hist['dropped']} dropped, all "
          f"launches {launches}")
    alive = sum(int((s.alive > 0.5).sum()) for s in sim.state)
    ke, pe = hist["kinetic"].sum(axis=1), hist["potential"]
    etot = ke + pe
    drift = abs(etot[-1] - etot[0]) / abs(etot[0])
    check(alive == n0 and all(math.isfinite(v) for v in list(ke) + list(pe))
          and drift <= ENERGY_DRIFT,
          f"phase 10.1 run(): alive {n0} -> {alive}, total energy drift "
          f"{drift:.3e}")
    steps_s = hist["step_seconds"][1:]
    step_ms = float(sum(steps_s) / len(steps_s)) * 1e3
    median_ms = sorted(steps_s)[len(steps_s) // 2] * 1e3
    slow = sorted(range(len(steps_s)), key=lambda i: -steps_s[i])[:3]
    print(f"  run(): {SCALEOUT_STEPS} steps, total energy {etot[0]:.9g} -> "
          f"{etot[-1]:.9g} (relative change {drift:.3e}), alive {alive}, "
          f"{step_ms:.3f} ms/step (mean of steps 2-{SCALEOUT_STEPS}, host "
          f"clock, re-buckets and retune included; median "
          f"{median_ms:.3f}; slowest "
          + ", ".join(f"step {i + 2} {steps_s[i] * 1e3:.3f}" for i in slow)
          + f") ({card})", flush=True)
    REFS["12.1"] = dict(ke=hist["kinetic"], pe=hist["potential"], n0=n0,
                        alive=alive, per_shard=per_shard[0],
                        median_ms=median_ms, launches=launches)
    # the window from run()'s state: an untimed, then a timed one (phase
    # 12.1 holds both's energies)
    carry = sim.state
    sim.state = None
    run_n = sim.make_scan_steps(SCALEOUT_WINDOW, donate=True, fresh=True)
    events = sum(len(a) for kind, a in run_n.plan if kind == "rebucket")
    for window in ("warm", "timed"):
        for m in modules:
            m.reset_launches()
        mesh.reset_shard_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        carry, (ke, pe, dropped) = run_n(carry)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for m in modules for k, v in m.LAUNCHES.items()
                    if v}
        per_shard = shard_counts(mesh, step_names)
        want = {"deposit": S, "pic_step": SCALEOUT_WINDOW}
        want.update({k: n * events
                     for k, n in ROUTE_CALLS["gather"].items()})
        alive = sum(int((s.alive > 0.5).sum()) for s in carry)
        ke_np, pe_np = ke.cpu().numpy(), pe.cpu().numpy()
        etot = ke_np.sum(axis=1) + pe_np
        drift = abs(etot[-1] - etot[0]) / abs(etot[0])
        check(per_shard == {0: want, 1: want}
              and launches == {k: 2 * v for k, v in want.items()}
              and int(dropped) == 0 and alive == n0
              and bool(torch.isfinite(ke).all() and torch.isfinite(pe).all())
              and drift <= ENERGY_DRIFT,
              f"phase 10.1 {window} window: per shard {per_shard}, expected "
              f"{want}, all {launches}, {int(dropped)} dropped, alive {n0} "
              f"-> {alive}, drift {drift:.3e}")
        REFS["12.1"][window] = dict(ke=ke_np, pe=pe_np, alive=alive,
                                    per_shard=per_shard[0],
                                    ms=wall / SCALEOUT_WINDOW * 1e3)
    win_ms = wall / SCALEOUT_WINDOW * 1e3
    print(f"  window of {SCALEOUT_WINDOW} (K5 a shard a step, "
          f"{events} species re-bucket events): launches per shard "
          f"{per_shard}; timed {win_ms:.4f} ms/step, "
          f"{n0 * SCALEOUT_WINDOW / wall:.4e} particle-steps/s; 0 dropped; "
          f"alive {alive}; relative energy change {drift:.3e}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card})", flush=True)
    sim.state = carry
    scaleout_breakdown(sim, card)
    glue = glue_ms(sim, card)
    run_glue = glue["fold"] + glue["pad"]
    win_glue = glue["fold"] + glue["pad_cmajor"]
    copies = run_glue - glue["fold_roll"] - glue["pad_roll"]
    print(f"phase 10.1 ms a step ({card}): two shards on one card run() "
          f"{step_ms:.3f} (median {median_ms:.3f}), window {win_ms:.4f}; "
          f"one card's deck (phase 3's "
          f"run() {run_ms:.3f}, phase 5's aux window {window_ms:.4f}); the "
          f"torch fold/pad {run_glue:.3f} ms of a run() step "
          f"({run_glue / median_ms:.1%} of the median), {win_glue:.3f} ms of "
          f"a window step "
          f"({win_glue / win_ms:.1%}), of which the halo plane copies and "
          f"their cats {copies:.4f} ms", flush=True)
    del sim, carry, run_n
    torch.cuda.empty_cache()
    return median_ms


def check_mesh_parity(card: str) -> None:
    """Phase 10.2: the flat and the tiled class over (2, 2, 2) on
    [cuda:0] * 8 against the same global deck on cuda:0, from one host
    state (the same seed), 8 steps of run() (the tiled deck re-buckets
    every 2): KE within 1e-4 and PE within 1e-3 of their maxima (the CPU
    tests' tolerances), no drop, equal alive counts; on the tiled deck
    (B = 384) every shard launches the same kernels, K11's per-tile
    sweeps at its re-buckets."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel import mesh
    from pinc_tpu_torch.parallel.pic import make_simulation
    dev = torch.device("cuda", 0)
    for label, deck in (("flat", PARITY_FLAT), ("tiled", PARITY_TILED)):
        t0 = time.monotonic()
        one = make_simulation(PincConfig.from_string(
            deck.format(nsub="1,1,1", ts="16,16,16")), device=dev)
        sim = make_simulation(PincConfig.from_string(
            deck.format(nsub="2,2,2", ts="8,8,8")), devices=[dev] * 8)
        h1 = one.run(progress_every=0)
        mesh.reset_shard_launches()
        hN = sim.run(progress_every=0)
        torch.cuda.synchronize()
        counts = {i: dict(c) for i, c in sorted(mesh.SHARD_LAUNCHES.items())}
        ke1, keN = h1["kinetic"].sum(1), hN["kinetic"].sum(1)
        pe1, peN = h1["potential"], hN["potential"]
        dke = float(abs(ke1 - keN).max() / abs(ke1).max())
        dpe = float(abs(pe1 - peN).max() / abs(pe1).max())
        if label == "flat":
            n1 = one.particles.counts().tolist()
            nN = sim.gather_particles().counts().tolist()
            dropped = 0
        else:
            n1 = int(one.state.alive.sum())
            nN = sum(int(s.alive.sum()) for s in sim.state)
            dropped = h1["dropped"] + hN["dropped"]
            REFS["12.2"] = dict(ke=hN["kinetic"], pe=hN["potential"],
                                alive=nN, dropped=hN["dropped"],
                                per_shard=dict(counts[0]))
            # B = 384: each shard re-buckets with K11's per-tile sweeps
            route = ROUTE_CALLS["onehot_tile"]
            S = len(sim._charge)
            check(sorted(counts) == list(range(8))
                  and all(c == counts[0] for c in counts.values())
                  and counts[0].get("deposit_move") == S * PARITY_STEPS
                  and all(counts[0].get(k, 0) > 0 for k in route),
                  f"phase 10.2 tiled: launches per shard {counts}")
            print(f"  launches per shard (each of the 8 the same): "
                  f"{counts[0]}", flush=True)
        check(dke < 1e-4 and dpe < 1e-3 and n1 == nN and dropped == 0,
              f"phase 10.2 {label}: KE {dke:.3e}, PE {dpe:.3e} relative, "
              f"alive {n1} vs {nN}, dropped {dropped}")
        print(f"phase 10.2 {label} {type(sim).__name__} over 8 shards of "
              f"cuda:0 vs {type(one).__name__}: {PARITY_STEPS} steps, KE "
              f"within {dke:.3e} and PE within {dpe:.3e} of their maxima, "
              f"alive {nN}, {time.monotonic() - t0:.1f} s ({card})",
              flush=True)
        del one, sim
    torch.cuda.empty_cache()


def deposit_corner_ms(sim, name: str, card: str) -> None:
    """The flat deposit's adds, one CIC corner of the deck's particles:
    ops/cic.scatter_cic's index_add_ on the flat grid against the
    index_put_(accumulate=True) it replaced (CUDA events)."""
    import torch
    from pinc_tpu_torch.ops import cic
    p = sim.particles
    S, cap, D = p.cell.shape
    shape = sim.spec.global_size
    idx = cic._corner_indices(p.cell.reshape(-1, D), (0,) * D, shape,
                              True)
    w = cic._corner_weight(p.frac.reshape(-1, D), (0,) * D)
    lin = cic._linear(idx, shape)
    flat = torch.zeros(math.prod(shape), device=w.device)
    grid = torch.zeros(shape, device=w.device)
    add_ms = cuda_ms(lambda: flat.index_add_(0, lin, w), 5, 1)
    put_ms = cuda_ms(lambda: grid.index_put_(idx, w, accumulate=True), 2, 1)
    print(f"phase 10.3 {name} at {shape} ({S} x {cap} slots): the flat "
          f"deposit's adds, one CIC corner, index_add_ {add_ms:.3f} ms, "
          f"index_put_(accumulate=True) {put_ms:.3f} ms ({card})",
          flush=True)


def check_mg_decks(card: str) -> None:
    """Phase 10.3: input/maxwellian.ini and input/langmuirCold.ini as
    shipped (nSubdomains 1,2,2 of 32 x 16 x 16, mgSolve / mgSolver; without
    files:output, the host has no h5py) over [cuda:0] * 4, 20 steps of
    run(), against the deck at nSubdomains = 1,1,1, trueSize = 32,32,32 on
    cuda:0: the sharded multigrid's cycles a solve, finite energies,
    particles conserved; KE within 1e-4 and PE within 1e-3 of their
    maxima (the CPU tests' tolerances)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel.mg import ShardedMultigridSolver
    from pinc_tpu_torch.parallel.pic import ShardedSimulation, make_simulation
    dev = torch.device("cuda", 0)
    for name in ("maxwellian.ini", "langmuirCold.ini"):
        runs = {}
        for label, extra, devices in (
                ("sharded", [], [dev] * 4),
                ("single", ["grid:nSubdomains=1,1,1",
                            "grid:trueSize=32,32,32"], None)):
            with tempfile.TemporaryDirectory() as tmp:
                cfg = PincConfig.from_file(
                    deck_path(name, tmp, output=False),
                    [f"time:nTimeSteps={MG_DECK_STEPS}", *extra])
            sim = make_simulation(cfg, devices=devices, device=dev)
            solver = sim._solve if label == "sharded" else sim.solver
            if label == "single":
                deposit_corner_ms(sim, name, card)
            cycles = []
            solve = solver.solve_with_stats

            def counted(*a, solve=solve, cycles=cycles):
                out = solve(*a)
                cycles.append(out[1])
                return out
            solver.solve_with_stats = counted
            n0 = (sim.gather_particles() if label == "sharded"
                  else sim.particles).counts().tolist()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            hist = sim.run(progress_every=0)
            wall = time.monotonic() - t0
            n1 = (sim.gather_particles() if label == "sharded"
                  else sim.particles).counts().tolist()
            ok = (isinstance(sim, ShardedSimulation)
                  and isinstance(solver, ShardedMultigridSolver)
                  if label == "sharded" else type(sim).__name__ ==
                  "Simulation")
            check(ok and n0 == n1 and len(cycles) == MG_DECK_STEPS + 1
                  and bool(np_finite(hist["kinetic"])
                           and np_finite(hist["potential"])),
                  f"phase 10.3 {name} {label}: {type(sim).__name__}, "
                  f"{type(solver).__name__}, alive {n0} -> {n1}, "
                  f"{len(cycles)} solves")
            runs[label] = (hist, cycles, wall, sim.particles
                           if label == "single" else None)
            if label == "sharded" and name == "maxwellian.ini":
                REFS["12.3"] = dict(ke=hist["kinetic"], pe=hist["potential"],
                                    cycles=cycles, alive=n1,
                                    ms=wall / MG_DECK_STEPS * 1e3)
            del sim
        (h, cyc, wall), (h1, cyc1, wall1) = (runs["sharded"][:3],
                                             runs["single"][:3])
        ke, ke1 = h["kinetic"].sum(1), h1["kinetic"].sum(1)
        dke = float(abs(ke - ke1).max() / abs(ke1).max())
        dpe = float(abs(h["potential"] - h1["potential"]).max()
                    / abs(h1["potential"]).max())
        check(dke < 1e-4 and dpe < 1e-3,
              f"phase 10.3 {name}: KE {dke:.3e}, PE {dpe:.3e} relative to "
              f"the single-device run")
        print(f"phase 10.3 {name} over 4 shards of cuda:0: "
              f"{MG_DECK_STEPS} steps, {wall / MG_DECK_STEPS * 1e3:.1f} "
              f"ms/step (host clock, set-up excluded; one device "
              f"{wall1 / MG_DECK_STEPS * 1e3:.1f}), multigrid cycles a "
              f"solve {sorted(set(cyc))} (one device {sorted(set(cyc1))}), "
              f"KE within {dke:.3e} and PE within {dpe:.3e} of the one "
              f"device's ({card})", flush=True)
    torch.cuda.empty_cache()


def check_sharded_solvers(card: str) -> None:
    """Phase 10.4: the solvers at 256 x 128 x 128 over two shards of
    cuda:0 (bench_scaleout.ini's mesh): the replicated FFT against the
    pencil FFT within 1e-5 of max|phi|, and the sharded multigrid (2
    V-cycles, maxwellian.ini's [multigrid]: 4 levels, 10/10/10 sweeps)
    against the single-device one on the same rho within 1e-4 of
    max|phi| (the card-vs-CPU bound of tests/test_torch_cuda.py); ms of
    each by CUDA events."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel.mesh import make_mesh
    from pinc_tpu_torch.parallel.mg import ShardedMultigridSolver, from_single
    from pinc_tpu_torch.parallel.pencil_fft import (PencilSpectralSolver,
                                                    make_sharded_solver)
    from pinc_tpu_torch.solvers.multigrid import MultigridSolver
    from pinc_tpu_torch.solvers.spectral import SpectralSolver
    dev = torch.device("cuda", 0)
    shape = (256, 128, 128)
    ctx = make_mesh((2, 1, 1), (128, 128, 128), devices=[dev, dev])
    gen = torch.Generator(device="cuda").manual_seed(11)
    rho = torch.randn(shape, device=dev, generator=gen)
    rho -= rho.mean()
    blocks = ctx.split(rho)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PincConfig.from_file(deck_path("bench_scaleout.ini", tmp))
    rep = make_sharded_solver(SpectralSolver(shape), ctx, cfg, torch.float32)
    cfg.set_str("parallel:pencilfft", "true")
    pen = make_sharded_solver(SpectralSolver(shape), ctx, cfg, torch.float32)
    check(not isinstance(rep, PencilSpectralSolver)
          and isinstance(pen, PencilSpectralSolver),
          "phase 10.4: the solver dispatch did not take the replicated and "
          "the pencil FFT")
    phi_r, phi_p = ctx.gather(rep(blocks)), ctx.gather(pen(blocks))
    REFS["12.3 pencil"] = phi_p.cpu().numpy()
    scale = float(phi_r.abs().max())
    d_fft = float((phi_r - phi_p).abs().max()) / scale
    one = SpectralSolver(shape)
    ms = {"replicated": cuda_ms(lambda: rep(blocks), 5, 1),
          "pencil": cuda_ms(lambda: pen(blocks), 5, 1),
          "one device": cuda_ms(lambda: one(rho), 5, 1)}
    REFS["12.3 pencil ms"] = ms["pencil"]
    mg_args = dict(n_levels=4, n_pre=10, n_post=10, n_coarse=10,
                   max_cycles=2, tol=0.0)
    mg1 = MultigridSolver(shape, **mg_args)
    mgN = from_single(mg1, ctx, cfg, torch.float32)
    check(isinstance(mgN, ShardedMultigridSolver) and mgN.n_levels == 4,
          "phase 10.4: from_single did not keep the 4 levels")
    phi1, c1, _ = mg1.solve_with_stats(rho)
    phiN, cN, _ = mgN.solve_with_stats(blocks)
    d_mg = float((ctx.gather(phiN) - phi1).abs().max()) / float(
        phi1.abs().max())
    ms["mg sharded"] = cuda_ms(lambda: mgN.solve_with_stats(blocks), 2, 1)
    ms["mg one device"] = cuda_ms(lambda: mg1.solve_with_stats(rho), 2, 1)
    check(d_fft <= 1e-5 and d_mg <= 1e-4 and c1 == cN == 2,
          f"phase 10.4: pencil vs replicated {d_fft:.3e}, sharded vs "
          f"single multigrid {d_mg:.3e} of max|phi| ({cN}, {c1} cycles)")
    print(f"phase 10.4 solvers at {shape} over 2 shards of cuda:0: pencil "
          f"within {d_fft:.3e} of the replicated FFT, the sharded "
          f"multigrid within {d_mg:.3e} of the single one (2 V-cycles); "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" a solve ({card})", flush=True)
    del rho, blocks, phi_r, phi_p, phi1, phiN
    torch.cuda.empty_cache()


def check_cli_cards(cli_main, card: str) -> None:
    """Phase 10.5: the CLI on input/maxwellian.ini as shipped (4
    subdomains) takes the visible cards: with fewer than four it raises
    pinc_tpu's "deck wants 4 devices", and never falls back to the CPU;
    with four or more it runs on them."""
    import torch
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        deck = deck_path("maxwellian.ini", tmp, output=False)
        out: dict = {}
        try:
            rc = cli_main([deck, "time:nTimeSteps=2"], out=out)
        except ValueError as e:
            check(n < 4 and "deck wants 4 devices" in str(e),
                  f"phase 10.5: {n} card(s), the CLI raised {e!r}")
            print(f"phase 10.5 the CLI on maxwellian.ini with {n} card(s): "
                  f"raised {e} ({card})", flush=True)
            return
    devs = out["sim"].ctx.devices
    check(n >= 4 and rc == 0 and all(d.type == "cuda" for d in devs),
          f"phase 10.5: {n} card(s), rc {rc}, the mesh {devs}")
    print(f"phase 10.5 the CLI on maxwellian.ini with {n} cards: ran on "
          f"{devs} ({card})", flush=True)


def check_parallel(cli_main, modules, prod, card: str, run_ms: float,
                   window_ms: float) -> float:
    """Phase 10: the multi-device layer (parallel/) on meshes of the one
    card (see the module docstring); returns 10.1's median ms a run()
    step."""
    t_phase = time.monotonic()
    scaleout_ms = check_scaleout(modules, card, prod, run_ms, window_ms)
    check_mesh_parity(card)
    check_mg_decks(card)
    check_sharded_solvers(card)
    check_cli_cards(cli_main, card)
    print(f"phase 10: {time.monotonic() - t_phase:.1f} s", flush=True)
    return scaleout_ms


# -- phase 11: decomposed object decks on meshes of the one card -----------

SHARDED_SPHERE = ((256, 128, 128), (128, 64, 64), 16)  # across x = 128
SHARDED_OBJ_STEPS = 20      # 11.1's run() and each window
SHARDED_RESP_STEPS = 10     # 11.2
OBJ_PARITY_STEPS = 6        # 11.3, the CPU tests' decks
SHIPPED_SHARDED_STEPS = 5   # 11.4
# 11.3's decks: tests/test_torch_sharded_objects.py's (flat, 2,2,2) and
# tests/test_torch_tiled_sharded_objects.py's (tiled, 2,1,1), 16^3 with a
# sphere of radius 2.5 at the centre
OBJ_PARITY_FLAT = """
[objects]
objects = sphere16.grid.h5
[time]
nTimeSteps = 6
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 16 pc
charge = -1,1
mass = 1,100
multiplicity = auto
thermalVelocity = 0.2,0.02
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
"""
OBJ_PARITY_TILED = OBJ_PARITY_FLAT.replace("16 pc", "8 pc").replace(
    "0.2,0.02", "0.1,0.02") + "layout = tiled\n[tiles]\ntileSize = 4\n" \
    "margin = 2\nrebucketEvery = 4\n"


def sharded_obj_sim(ctypes: str, extra=(), steps: int = SHARDED_OBJ_STEPS):
    """input/bench_scaleout.ini as shipped with the straddling sphere
    (domain=) and the responses, through make_simulation over
    [cuda:0, cuda:0]; returns (sim, host seconds of the set-up)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.objects import make_sphere
    from pinc_tpu_torch.parallel.pic import make_simulation
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PincConfig.from_file(deck_path("bench_scaleout.ini", tmp), [
            f"time:nTimeSteps={steps}",
            "objects:objects=sphere_scaleout.grid.h5",
            f"objects:collisionType={ctypes}", *extra])
    dom = make_sphere(*SHARDED_SPHERE)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    sim = make_simulation(cfg, devices=[dev, dev], domain=dom)
    torch.cuda.synchronize()
    return sim, time.monotonic() - t0


def sharded_obj_checks(label: str, sim, st, rho_obj, q0: float,
                       gross: float, ke, pe, phi_c, dropped: int,
                       negative: bool) -> str:
    """Phase 9.1's checks on a sharded object run or window: nothing
    dropped, every number finite and on the card, the charge of the
    particles plus rho_obj conserved within 1e-5 of the gross charge,
    the object's charge and potential negative (negative=True)."""
    import numpy as np
    import torch
    check(all(s.lpos.is_cuda for s in st) and rho_obj.is_cuda,
          f"{label}: a tensor of the run left the card")
    check(dropped == 0, f"{label}: {dropped} dropped")
    finite = (np_finite(ke) and np_finite(pe) and np_finite(phi_c)
              and bool(torch.isfinite(rho_obj).all()))
    check(finite, f"{label}: non-finite numbers")
    total, _ = obj_charge_total(sim, st, rho_obj)
    check(abs(total - q0) <= OBJ_CHARGE_RTOL * gross,
          f"{label}: charge {q0:.9g} -> {total:.9g} (gross {gross:.6g})")
    q_obj = float(sim.objects.object_charge(rho_obj)[0])
    phi = float(np.asarray(phi_c).reshape(-1)[-1])
    if negative:
        check(q_obj < 0.0 and phi < 0.0,
              f"{label}: object charge {q_obj:.6g}, potential {phi:.6g}")
    return (f"charge {q0:.9g} -> {total:.9g} (|d| / gross "
            f"{abs(total - q0) / gross:.2e}); object charge {q_obj:.6g}, "
            f"potential {phi:.6g}")


def sharded_obj_run(label: str, sim, modules, steps: int, card: str,
                    negative: bool) -> tuple:
    """run() of a sharded object deck with the launch counts per shard
    (K1 per species a step and in the half kick, K3 per species in the
    half kick, K4 per species a step: _local_kick's full kick on the
    pallas route, the gather exchange at each species event; never K2,
    K5, K6, K7) and the checks; returns (mean ms a step of steps 2-n,
    the median, the launches of both shards)."""
    import numpy as np
    import torch
    from pinc_tpu_torch.parallel import mesh
    S = len(sim._charge)
    q0, gross = obj_charge_total(sim, sim.state, None, cull=True)
    for m in modules:
        m.reset_launches()
    mesh.reset_shard_launches()
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    per_shard = shard_counts(mesh, launches)
    events = per_shard.get(0, {}).get("extract", 0)
    scheduled = sum(steps // R for R in sim.rebucket_every_s)
    want = {"deposit": S * (steps + 1), "gather": S,
            "gather_kick": S * steps}
    want.update({k: n * events for k, n in ROUTE_CALLS["gather"].items()
                 if events})
    check(per_shard == {0: want, 1: want}
          and launches == {k: 2 * v for k, v in want.items()}
          and (events == scheduled
               or (events > scheduled and hist["n_lost"] > 0)),
          f"{label}: launches per shard {per_shard}, expected {want} "
          f"({events} species events, {scheduled} scheduled), all "
          f"{launches}")
    text = sharded_obj_checks(
        label, sim, sim.state, sim.rho_obj, q0, gross,
        hist["kinetic"], hist["potential"], sim.last_obj_potential,
        hist["dropped"], negative)
    steps_s = hist["step_seconds"][1:]
    mean_ms = float(np.mean(steps_s)) * 1e3
    median_ms = float(np.median(steps_s)) * 1e3
    n_alive = sum(int((s.alive > 0.5).sum()) for s in sim.state)
    if label.startswith("11.1"):
        REFS["12.4"] = dict(ke=hist["kinetic"], pe=hist["potential"],
                            alive=n_alive, per_shard=per_shard[0],
                            phi_c=np.asarray(sim.last_obj_potential),
                            median_ms=median_ms)
    print(f"phase 11 {label}: {steps} steps of run(); launches per shard "
          f"{per_shard} ({events} species re-bucket events, "
          f"{hist['n_lost']} margin hits); {n_alive} alive, 0 dropped; "
          f"{text}; {mean_ms:.3f} ms a step (mean of steps 2-{steps}, "
          f"re-buckets included; median {median_ms:.3f}) ({card})",
          flush=True)
    return mean_ms, median_ms, launches


def sharded_obj_window(label: str, sim, modules, steps: int,
                       card: str) -> tuple:
    """An untimed, then a timed make_scan_steps(steps, donate=True) window
    from the run's final state and rho_obj (K1 and K4 per species a step
    a shard, the gather exchange at each event), with the checks;
    returns (ms a step of the timed window, its launches)."""
    import torch
    from pinc_tpu_torch.parallel import mesh
    S = len(sim._charge)
    run_n = sim.make_scan_steps(steps, donate=True)
    events = sum(len(a) for kind, a in run_n.plan if kind == "rebucket")
    want = {"deposit": S * steps, "gather_kick": S * steps}
    want.update({k: n * events for k, n in ROUTE_CALLS["gather"].items()
                 if events})
    carry, rho_obj = sim.state, sim.rho_obj
    sim.state = None
    for window in ("warm", "timed"):
        q0, gross = obj_charge_total(sim, carry, rho_obj)
        for m in modules:
            m.reset_launches()
        mesh.reset_shard_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (carry, rho_obj), (ke, pe, dropped, phi_c) = run_n(carry, rho_obj)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for m in modules for k, v in m.LAUNCHES.items()
                    if v}
        per_shard = shard_counts(mesh, launches)
        check(per_shard == {0: want, 1: want}
              and launches == {k: 2 * v for k, v in want.items()}
              and tuple(ke.shape) == (steps, S),
              f"{label} {window} window: launches per shard {per_shard}, "
              f"expected {want}, all {launches}")
        text = sharded_obj_checks(f"{label} {window} window", sim, carry,
                                  rho_obj, q0, gross, ke.cpu().numpy(),
                                  pe.cpu().numpy(), phi_c.cpu().numpy(),
                                  int(dropped), True)
    sim.state, sim.rho_obj = carry, rho_obj
    ms = wall / steps * 1e3
    print(f"phase 11 {label}: make_scan_steps({steps}, donate=True), a "
          f"warm and a timed window: launches per shard {per_shard} "
          f"({events} species re-bucket events); 0 dropped; {text}; "
          f"{ms:.3f} ms a step ({card})", flush=True)
    return ms, launches


def sharded_obj_share(sim, card: str) -> tuple:
    """CUDA events around one object step of the mesh on the final state
    (no re-bucket) and around its object work: the absorb on both shards'
    near-object tiles (after the drift), the spread into rho_obj, and the
    object solve (rho += rho_obj, solve, the capacitance on the gathered
    fields, the second solve, E) less the plain solve; returns (the
    step's ms, the object work's ms)."""
    import torch
    from pinc_tpu_torch.parallel.pic import (solve_fields,
                                             solve_object_fields)
    from pinc_tpu_torch.tiled_sim import TiledState
    ctx, st, rho_obj = sim.ctx, sim.state, sim.rho_obj

    def fresh(drift: bool):
        return ([TiledState(lpos=s.lpos + s.vel if drift else s.lpos.clone(),
                            vel=s.vel.clone(), alive=s.alive.clone())
                 for s in st],)
    res = ctx.shard_map(lambda s: sim._local_absorb_tiled(s)[1],
                        fresh(True)[0])
    counter = res[0]
    rho = ctx.shard_map(sim._local_fields, st)
    parts = {
        "step": cuda_ms_fresh(lambda: fresh(False) + (rho_obj,),
                              sim._tiled_step_obj, reps=2),
        "absorb": cuda_ms_fresh(
            lambda: fresh(True), lambda s: ctx.shard_map(
                sim._local_absorb_tiled, s), reps=2),
        "spread": cuda_ms(lambda: sim._spread_obj_charge(rho_obj, counter),
                          reps=3, warmup=1),
        "object solve": cuda_ms(lambda: solve_object_fields(sim, rho,
                                                            rho_obj),
                                reps=3, warmup=1),
        "plain solve": cuda_ms(lambda: solve_fields(sim, rho), reps=3,
                               warmup=1)}
    obj_ms = (parts["absorb"] + parts["spread"] + parts["object solve"]
              - parts["plain solve"])
    print("phase 11.1 one object step of the mesh by CUDA events (" + card
          + "): " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; the object work {obj_ms:.3f} ms, "
          f"{obj_ms / parts['step']:.1%} of the step", flush=True)
    del rho, res
    torch.cuda.empty_cache()
    return parts["step"], obj_ms


def check_scaleout_objects(modules, card: str, single_ms: float,
                           scaleout_ms: float) -> dict:
    """Phases 11.1 and 11.2: input/bench_scaleout.ini with a sphere across
    the shard boundary; returns 11.1's launches (both shards, run() and
    the two windows)."""
    import torch
    from pinc_tpu_torch.parallel.tiled_pic import ShardedTiledSimulation
    sim, setup_s = sharded_obj_sim("absorb,absorb")
    obj = sim.objects
    near = [int(t[0].numel()) for t in sim._shard_obj_tiles]
    n_int = int((obj.interior_id > 0).sum())
    n_surf = len(obj.surface_idx[0])
    check(isinstance(sim, ShardedTiledSimulation)
          and sim.ctx.devices == [torch.device("cuda", 0)] * 2
          and (n_int, n_surf) == OBJ_NODES and min(near) > 0
          and sum(near) == sim._obj_tiles.numel()
          and not sim._use_fused and obj.interior_id.is_cuda,
          f"phase 11.1: {type(sim).__name__} on {sim.ctx.devices}, "
          f"{n_int} interior and {n_surf} surface nodes, near-object tiles "
          f"per shard {near} of {sim._obj_tiles.numel()}")
    print(f"phase 11.1 bench_scaleout.ini with a sphere of radius "
          f"{SHARDED_SPHERE[2]} at {SHARDED_SPHERE[1]} (across the shard "
          f"boundary; {n_int} interior and {n_surf} surface nodes, "
          f"near-object tiles per shard {near} of {sim.ts_local.NT}), "
          f"absorb,absorb: set-up {setup_s:.2f} s (the factory, "
          f"population and object set-up; of it the solves "
          f"{obj.setup['solve_s']:.3f} s, building A "
          f"{obj.setup['matrix_s']:.3f} s, the float64 inversion "
          f"{obj.setup['invert_s']:.3f} s) ({card})", flush=True)
    mean_ms, median_ms, launches = sharded_obj_run(
        "11.1 absorb,absorb", sim, modules, SHARDED_OBJ_STEPS, card, True)
    step_ms, obj_ms = sharded_obj_share(sim, card)
    win_ms, win = sharded_obj_window("11.1 absorb,absorb window", sim,
                                     modules, SHARDED_OBJ_STEPS, card)
    for k, v in win.items():
        launches[k] = launches.get(k, 0) + 2 * v      # warm and timed
    print(f"phase 11.1 ms a step ({card}): the sharded object deck run() "
          f"{mean_ms:.3f} (median {median_ms:.3f}), window {win_ms:.3f}; "
          f"one object step {step_ms:.3f} by CUDA events, of which the "
          f"object work {obj_ms:.3f} ({obj_ms / step_ms:.1%}); phase "
          f"9.1's single-card object deck run() {single_ms:.3f}; phase "
          f"10.1's sharded deck without objects run() median "
          f"{scaleout_ms:.3f}", flush=True)
    del sim, obj
    torch.cuda.empty_cache()
    # 11.2: reflecting electrons, ions emitting secondary electrons
    sim, setup_s = sharded_obj_sim("reflect,secondary",
                                   ["objects:seeSpecies=0"],
                                   SHARDED_RESP_STEPS)
    sharded_obj_run("11.2 reflect,secondary", sim, modules,
                    SHARDED_RESP_STEPS, card, False)
    print(f"phase 11.2 secondaries emitted {int(sim.see_emitted)}, found "
          f"no free slot {int(sim.see_overflow)}, over both shards; set-up "
          f"{setup_s:.2f} s ({card})", flush=True)
    del sim
    torch.cuda.empty_cache()
    return launches


def obj_parity(label: str, one, sim, hists, ke_rtol: float,
               pe_rtol: float, rho_rtol: float, phi_rtol: float,
               rho_by_sum: bool = False) -> str:
    """Equal alive counts, then the energies (relative to their maxima),
    rho_obj (its largest difference relative to its maximum, or with
    rho_by_sum its sum's relative difference) and phi_c (relative to its
    maximum) of the mesh's run against the one device's; returns a
    summary."""
    import numpy as np
    h1, h = hists
    if hasattr(sim, "ts"):
        n1 = one.state.alive.sum(dim=(1, 2)).cpu().numpy()
        n = sum(s.alive.sum(dim=(1, 2)).cpu().numpy() for s in sim.state)
    else:
        n1 = one.particles.counts().cpu().numpy()
        n = sim.gather_particles().counts().cpu().numpy()
    dke = float(np.abs(h["kinetic"] - h1["kinetic"]).max()
                / np.abs(h1["kinetic"]).max())
    dpe = float(np.abs(h["potential"] - h1["potential"]).max()
                / np.abs(h1["potential"]).max())
    r1, r = one.last_rho_obj, sim.last_rho_obj
    drho = float(np.abs(r - r1).max() / np.abs(r1).max())
    dsum = abs(float(r.sum(dtype=np.float64) - r1.sum(dtype=np.float64))) \
        / abs(float(r1.sum(dtype=np.float64)))
    p1, p = one.last_obj_potential, sim.last_obj_potential
    dphi = float(np.abs(p - p1).max() / np.abs(p1).max())
    check((n == n1).all() and dke <= ke_rtol and dpe <= pe_rtol
          and (dsum if rho_by_sum else drho) <= rho_rtol
          and dphi <= phi_rtol,
          f"{label}: alive {n} vs {n1} on one device, KE {dke:.3e} (tol "
          f"{ke_rtol}), PE {dpe:.3e} ({pe_rtol}), rho_obj {drho:.3e} / sum "
          f"{dsum:.3e} ({rho_rtol}), phi_c {dphi:.3e} ({phi_rtol})")
    return (f"alive {n.tolist()} on both, KE within {dke:.2e} and PE "
            f"within {dpe:.2e} of their maxima, rho_obj within {drho:.2e} "
            f"of its maximum (sum {dsum:.2e}), phi_c within {dphi:.2e}")


def check_object_mesh_parity(card: str) -> None:
    """Phase 11.3: the CPU tests' 16^3 object decks, the flat class over
    [cuda:0] * 8 (2,2,2) and the tiled over [cuda:0] * 2 (2,1,1), against
    the same global deck on cuda:0 (the same seed), 6 steps of run():
    equal alive counts; the flat within pinc_tpu's own sharded-object
    tolerances (KE 2e-3, rho_obj's sum 1e-4, phi_c 5e-3), the tiled within
    tests/test_torch_tiled_sharded_objects.py's (KE 1e-5, PE 1e-4, rho_obj
    1e-5 and phi_c 1e-4 of their maxima)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.objects import make_sphere
    from pinc_tpu_torch.parallel.pic import make_simulation
    dev = torch.device("cuda", 0)
    dom = make_sphere((16,) * 3, (8, 8, 8), 2.5)
    for label, deck, nsub, tols in (
            ("flat", OBJ_PARITY_FLAT, (2, 2, 2), (2e-3, 1.0, 1e-4, 5e-3,
                                                   True)),
            ("tiled", OBJ_PARITY_TILED, (2, 1, 1), (1e-5, 1e-4, 1e-5,
                                                    1e-4))):
        t0 = time.monotonic()
        ts = ",".join(str(16 // n) for n in nsub)
        one = make_simulation(PincConfig.from_string(deck.format(
            nsub="1,1,1", ts="16,16,16")), seed=4, device=dev, domain=dom)
        sim = make_simulation(PincConfig.from_string(deck.format(
            nsub=",".join(map(str, nsub)), ts=ts)), seed=4,
            devices=[dev] * (nsub[0] * nsub[1] * nsub[2]), domain=dom)
        hists = (one.run(progress_every=0), sim.run(progress_every=0))
        text = obj_parity(f"phase 11.3 {label}", one, sim, hists, *tols)
        print(f"phase 11.3 {label} {type(sim).__name__} over "
              f"{sim.ctx.n_devices} shards of cuda:0 vs "
              f"{type(one).__name__}: {OBJ_PARITY_STEPS} steps, {text}, "
              f"{time.monotonic() - t0:.1f} s ({card})", flush=True)
        del one, sim
    torch.cuda.empty_cache()


def check_shipped_sharded(card: str) -> None:
    """Phase 11.4: input/sphereObject.ini (flat, mgSolve, 32^3, its
    sphere of radius 4 as domain=) with grid:nSubdomains = 1,2,2 over
    [cuda:0] * 4 against the 1,1,1 deck on cuda:0, 5 steps: equal alive
    counts, rho_obj within 1e-5 of its maximum, phi_c within 1e-4 (the
    CPU tests' multigrid tolerance), the same multigrid cycles each
    solve."""
    import torch
    from pinc_tpu_torch.objects import make_sphere
    from pinc_tpu_torch.parallel.mg import ShardedMultigridSolver
    from pinc_tpu_torch.parallel.pic import ShardedSimulation
    dev = torch.device("cuda", 0)
    dom = make_sphere(*SHIPPED_SPHERE)
    with tempfile.TemporaryDirectory() as tmp:
        with open(deck_path("sphereObject.ini", tmp, output=False)) as f:
            text = f.read()
    runs = {}
    for label, extra, devices in (
            ("sharded", ["grid:nSubdomains=1,2,2",
                         "grid:trueSize=32,16,16"], [dev] * 4),
            ("single", [], None)):
        sim, setup_s = make_obj_sim(
            text, dom, dev, [f"time:nTimeSteps={SHIPPED_SHARDED_STEPS}",
                             *extra], devices=devices)
        solver = sim._solve if devices is not None else sim.solver
        cycles = []
        solve = solver.solve_with_stats

        def counted(*a, solve=solve, cycles=cycles):
            out = solve(*a)
            cycles.append(int(out[1]))
            return out
        solver.solve_with_stats = counted
        torch.cuda.synchronize()
        t0 = time.monotonic()
        hist = sim.run(progress_every=0)
        torch.cuda.synchronize()
        runs[label] = (sim, hist, cycles, time.monotonic() - t0, setup_s)
    (sim, h, cyc, wall, setup_s), (one, h1, cyc1, wall1, setup1) = (
        runs["sharded"], runs["single"])
    check(isinstance(sim, ShardedSimulation)
          and isinstance(sim._solve, ShardedMultigridSolver)
          and len(cyc) == 2 * SHIPPED_SHARDED_STEPS + 1 and cyc == cyc1,
          f"phase 11.4: {type(sim).__name__} / {type(sim._solve).__name__}"
          f", cycles a solve {cyc} sharded, {cyc1} on one device")
    text = obj_parity("phase 11.4", one, sim, (h1, h), 1.0, 1.0, 1e-5,
                      1e-4)
    print(f"phase 11.4 sphereObject.ini over 1,2,2 shards of cuda:0: "
          f"{SHIPPED_SHARDED_STEPS} steps, {text}; multigrid cycles a solve "
          f"{cyc} (the same on one device); run {wall:.2f} s (one device "
          f"{wall1:.2f}), set-up {setup_s:.2f} s ({setup1:.2f}) ({card})",
          flush=True)
    del runs, sim, one
    torch.cuda.empty_cache()


def check_sharded_objects(modules, card: str, single_ms: float,
                          scaleout_ms: float) -> dict:
    """Phase 11: decomposed object decks on meshes of the one card (see
    the module docstring); returns 11.1's launches."""
    t_phase = time.monotonic()
    launches = check_scaleout_objects(modules, card, single_ms, scaleout_ms)
    check_object_mesh_parity(card)
    check_shipped_sharded(card)
    print(f"phase 11: {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


# -- phase 12: runs over several processes on the one card ----------------

P12_WORLD = 2           # torchrun's processes, both on cuda:0 (gloo)
P12_CLI_STEPS = 4       # 12.0's steps, the CLI as a user launches it
P12_MG_STEPS = 5        # 12.3's run() steps (the first of 10.3's 20)
P12_TIMEOUT_S = 420     # a torchrun of phase 12, then killed (its processes
                        # too)
P12_GROUP_TIMEOUT_S = 240   # a wait on the other process, then it fails
P12_RTOL = 1e-6         # energies where the run is not bit for bit
#: what phases 10 and 11 leave for phase 12 to hold the processes against
REFS: dict = {}


def p12_reset(modules) -> None:
    from pinc_tpu_torch.parallel import mesh
    for m in modules:
        m.reset_launches()
    mesh.reset_shard_launches()


def p12_counts(modules) -> dict:
    """This process's launches since p12_reset: all of them, and per shard
    (the kernels of K1-K5 and K8-K11)."""
    from pinc_tpu_torch.parallel import mesh
    names = ("deposit", "gather", "deposit_move", "gather_kick",
             "pic_step") + tuple(EXCHANGE_KERNELS)
    return {"all": {k: v for m in modules for k, v in m.LAUNCHES.items()
                    if v},
            "shards": {str(i): c for i, c in
                       shard_counts(mesh, names).items()}}


def p12_alive(states) -> int:
    return sum(int((s.alive > 0.5).sum()) for s in states if s is not None)


def p12_scaleout(cli_main, modules) -> dict:
    """12.1 in a process: the CLI's main() under torchrun's environment,
    20 run() steps of input/bench_scaleout.ini as shipped; then an untimed
    and a timed 40-step window from run()'s state."""
    import torch
    deck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "input",
                        "bench_scaleout.ini")
    out: dict = {}
    p12_reset(modules)
    rc = cli_main([deck, f"time:nTimeSteps={SCALEOUT_STEPS}"], out=out)
    torch.cuda.synchronize()
    sim, res = out["sim"], {"rc": rc, "run": p12_counts(modules)}
    res.update(held=list(sim.ctx.local), kind=type(sim).__name__,
               ke=out["kinetic"].tolist(), pe=out["potential"].tolist(),
               dropped=out["dropped"], n_lost=out["n_lost"],
               step_ms=[t * 1e3 for t in out["step_seconds"]],
               alive=p12_alive(sim.state))
    carry = sim.state
    sim.state = None
    run_n = sim.make_scan_steps(SCALEOUT_WINDOW, donate=True, fresh=True)
    for window in ("warm", "timed"):
        p12_reset(modules)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        carry, (ke, pe, dropped) = run_n(carry)
        torch.cuda.synchronize()
        res[window] = dict(ms=(time.monotonic() - t0) / SCALEOUT_WINDOW
                           * 1e3, ke=ke.cpu().numpy().tolist(),
                           pe=pe.cpu().numpy().tolist(),
                           dropped=int(dropped), alive=p12_alive(carry),
                           launches=p12_counts(modules))
    del sim, carry, run_n, out
    torch.cuda.empty_cache()
    return res


def p12_parity(modules) -> dict:
    """12.2 in a process: phase 10.2's tiled deck over (2, 2, 2), four
    shards a process (B = 384: K11's per-tile sweeps)."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel.pic import make_simulation
    dev = torch.device("cuda", 0)
    sim = make_simulation(PincConfig.from_string(
        PARITY_TILED.format(nsub="2,2,2", ts="8,8,8")), devices=[dev] * 8)
    p12_reset(modules)
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    res = dict(held=list(sim.ctx.local), ke=hist["kinetic"].tolist(),
               pe=hist["potential"].tolist(), dropped=hist["dropped"],
               alive=p12_alive(sim.state), launches=p12_counts(modules))
    del sim
    torch.cuda.empty_cache()
    return res


def p12_solvers() -> dict:
    """12.3 in a process: input/maxwellian.ini as shipped (flat, the sharded
    multigrid) over (1, 2, 2), two shards a process, with the cycles of
    every solve; then the pencil FFT of 10.4's rho at 256 x 128 x 128 over
    (2, 1, 1), one shard a process."""
    import torch
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.parallel.mesh import make_mesh
    from pinc_tpu_torch.parallel.mg import ShardedMultigridSolver
    from pinc_tpu_torch.parallel.pencil_fft import (PencilSpectralSolver,
                                                    make_sharded_solver)
    from pinc_tpu_torch.parallel.pic import make_simulation
    from pinc_tpu_torch.solvers.spectral import SpectralSolver
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PincConfig.from_file(
            deck_path("maxwellian.ini", tmp, output=False),
            [f"time:nTimeSteps={P12_MG_STEPS}"])
        bench = PincConfig.from_file(deck_path("bench_scaleout.ini", tmp),
                                     ["parallel:pencilFFT=true"])
    sim = make_simulation(cfg, devices=[dev] * 4, device=dev)
    solver, cycles = sim._solve, []
    solve = solver.solve_with_stats

    def counted(*a):
        out = solve(*a)
        cycles.append(int(out[1]))
        return out
    solver.solve_with_stats = counted
    torch.cuda.synchronize()
    t0 = time.monotonic()
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    res = dict(held=list(sim.ctx.local), cycles=cycles,
               mg=isinstance(solver, ShardedMultigridSolver),
               ke=hist["kinetic"].tolist(), pe=hist["potential"].tolist(),
               ms=(time.monotonic() - t0) / P12_MG_STEPS * 1e3,
               alive=sim.gather_particles().counts().tolist())
    del sim
    shape = (256, 128, 128)
    ctx = make_mesh((2, 1, 1), (128, 128, 128), devices=[dev, dev])
    gen = torch.Generator(device="cuda").manual_seed(11)
    rho = torch.randn(shape, device=dev, generator=gen)
    rho -= rho.mean()
    blocks = ctx.split(rho)
    pen = make_sharded_solver(SpectralSolver(shape), ctx, bench,
                              torch.float32)
    phi = ctx.gather(pen(blocks)).cpu().numpy()
    res.update(pencil=isinstance(pen, PencilSpectralSolver),
               pencil_ms=cuda_ms(lambda: pen(blocks), 5, 1))
    del rho, blocks
    torch.cuda.empty_cache()
    return res, phi


def p12_objects(modules) -> dict:
    """12.4 in a process: 11.1's deck (bench_scaleout.ini, the sphere of
    radius 16 across the shard boundary, absorb,absorb), one shard a
    process, 20 run() steps; this process's share of the charge."""
    import numpy as np
    import torch
    sim, setup_s = sharded_obj_sim("absorb,absorb")
    q0, gross0 = obj_charge_total(sim, sim.state, None, cull=True)
    p12_reset(modules)
    hist = sim.run(progress_every=0)
    torch.cuda.synchronize()
    q1, _ = obj_charge_total(sim, sim.state, None)
    res = dict(held=list(sim.ctx.local), ke=hist["kinetic"].tolist(),
               pe=hist["potential"].tolist(), dropped=hist["dropped"],
               alive=p12_alive(sim.state), q0=q0, gross=gross0, q1=q1,
               rho_obj=float(sim.rho_obj.double().sum()),
               phi_c=np.asarray(sim.last_obj_potential).tolist(),
               median_ms=float(np.median(hist["step_seconds"][1:])) * 1e3,
               setup_s=setup_s, launches=p12_counts(modules))
    del sim
    torch.cuda.empty_cache()
    return res


def phase12_child(out_dir: str) -> int:
    """One of phase 12's processes (``chip_smoke.py --phase12 DIR`` under
    torchrun): the process group by the backend rule, 12.1-12.4 in turn,
    its results to DIR/rank<r>.json (and 12.3's pencil phi to
    DIR/phi<r>.npy)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pinc_tpu_torch.__main__ import main as cli_main
    from pinc_tpu_torch.ops import _cuda_build
    from pinc_tpu_torch.ops import field_kernels as fk
    from pinc_tpu_torch.ops import gather_exchange as gx
    from pinc_tpu_torch.ops import onehot_exchange as ox
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.utils import multihost as mh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda_build.load()            # phase 1 built it: the cached library
    t0 = time.monotonic()
    mh.init(timeout_s=P12_GROUP_TIMEOUT_S)
    rank, modules = mh.process_index(), (tk, fk, gx, ox)
    res = dict(rank=rank, world=mh.process_count(), backend=mh.backend(),
               device=str(mh.local_device()), init_s=time.monotonic() - t0)
    t = time.monotonic()
    res["12.1"] = p12_scaleout(cli_main, modules)
    res["12.1"]["seconds"] = time.monotonic() - t
    t = time.monotonic()
    res["12.2"] = p12_parity(modules)
    res["12.2"]["seconds"] = time.monotonic() - t
    t = time.monotonic()
    res["12.3"], phi = p12_solvers()
    res["12.3"]["seconds"] = time.monotonic() - t
    np.save(os.path.join(out_dir, f"phi{rank}.npy"), phi)
    t = time.monotonic()
    res["12.4"] = p12_objects(modules)
    res["12.4"]["seconds"] = time.monotonic() - t
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mh.shutdown()
    return 0


def p12_same(label: str, ref_ke, ref_pe, got: list) -> str:
    """Each process's energies against the single-process mesh's: bit for
    bit, or within P12_RTOL of their maxima; fails otherwise.  Returns
    which."""
    import numpy as np
    ke_r, pe_r = np.asarray(ref_ke, np.float32), np.asarray(ref_pe,
                                                             np.float32)
    bits = True
    for g in got:
        ke, pe = np.asarray(g["ke"], np.float32), np.asarray(g["pe"],
                                                             np.float32)
        check(ke.shape == ke_r.shape and pe.shape == pe_r.shape,
              f"{label}: energies of shapes {ke.shape}, {pe.shape} against "
              f"{ke_r.shape}, {pe_r.shape}")
        if np.array_equal(ke, ke_r) and np.array_equal(pe, pe_r):
            continue
        bits = False
        dke = float(np.abs(ke - ke_r).max() / np.abs(ke_r).max())
        dpe = float(np.abs(pe - pe_r).max() / np.abs(pe_r).max())
        check(dke <= P12_RTOL and dpe <= P12_RTOL,
              f"{label}: KE {dke:.3e}, PE {dpe:.3e} of their maxima from "
              f"the single-process mesh's (tolerance {P12_RTOL})")
    return ("energies bit for bit the single-process mesh's" if bits else
            f"energies within {P12_RTOL} of the single-process mesh's "
            "(not bit for bit)")


def p12_launch(cmd: list, cwd: str) -> str:
    """Run torchrun (in a process group of its own, so that a timeout
    kills its processes too); fails unless it exits 0.  Returns its
    output."""
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=P12_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)            # torchrun and its processes
        log, _ = proc.communicate()
        fail(f"phase 12: {' '.join(cmd[2:])} passed {P12_TIMEOUT_S} s and "
             f"was killed; its output ends:\n{log[-4000:]}")
    check(proc.returncode == 0,
          f"phase 12: {' '.join(cmd[2:])} exited {proc.returncode}; its "
          f"output ends:\n{log[-6000:]}")
    return log


def check_multiprocess(modules, card: str) -> dict:
    """Phase 12: runs over several processes on the one card (see the
    module docstring); returns the processes' launches of the kernels
    (12.1's run() and windows, 12.2, 12.4)."""
    import numpy as np
    import torch
    t_phase = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()       # the processes share the card
    here = os.path.dirname(os.path.abspath(__file__))
    # 12.0: the launch a user types, a short run
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={P12_WORLD}", "-m", "pinc_tpu_torch",
           os.path.join("input", "bench_scaleout.ini"),
           f"time:nTimeSteps={P12_CLI_STEPS}"]
    log = p12_launch(cmd, here)
    said = [f"process {r} of {P12_WORLD} on cuda:0, backend gloo" in log
            for r in range(P12_WORLD)]
    check(all(said) and "PINC-TPU-torch finished" in log,
          f"phase 12.0: the ranks' STATUS lines {said}; the output ends:\n"
          f"{log[-4000:]}")
    print(f"phase 12.0 torchrun --standalone --nproc-per-node={P12_WORLD} "
          f"-m pinc_tpu_torch input/bench_scaleout.ini "
          f"time:nTimeSteps={P12_CLI_STEPS}: rc 0, each rank on cuda:0 "
          f"over gloo, {time.monotonic() - t_phase:.1f} s with the launch "
          f"({card})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={P12_WORLD}", os.path.abspath(__file__),
               "--phase12", tmp]
        log = p12_launch(cmd, here)
        lines = [ln for ln in log.splitlines()
                 if "rank" in ln or "Time spent" in ln or "Error" in ln]
        print("phase 12 torchrun's processes said:\n  "
              + "\n  ".join(lines[-12:]), flush=True)
        got = []
        for r in range(P12_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got.append(json.load(f))
        phis = [np.load(os.path.join(tmp, f"phi{r}.npy"))
                for r in range(P12_WORLD)]
    wall = time.monotonic() - t_phase
    check([g["rank"] for g in got] == list(range(P12_WORLD))
          and all(g["world"] == P12_WORLD and g["backend"] == "gloo"
                  and g["device"].startswith("cuda") for g in got),
          "phase 12: the processes' ranks, worlds, backends, devices "
          + str([(g["rank"], g["world"], g["backend"], g["device"])
                 for g in got]))
    print(f"phase 12: {P12_WORLD} processes on {got[0]['device']} "
          f"(backend {got[0]['backend']}: NCCL refuses two ranks on one "
          f"card), process group in "
          f"{max(g['init_s'] for g in got):.1f} s; phase 12 took "
          f"{wall:.1f} s ({card})", flush=True)
    launches: dict = {}

    def add(counts):
        for k, v in counts["all"].items():
            launches[k] = launches.get(k, 0) + v

    # 12.1
    ref = REFS["12.1"]
    res = [g["12.1"] for g in got]
    per_shard = [r["run"]["shards"] for r in res]
    check(all(r["rc"] == 0 and r["held"] == [i] and r["kind"] ==
              "ShardedTiledSimulation" for i, r in enumerate(res))
          and per_shard == [{str(i): ref["per_shard"]}
                            for i in range(P12_WORLD)]
          and sum(r["alive"] for r in res) == ref["alive"] == ref["n0"]
          and all(r["dropped"] == 0 for r in res),
          f"phase 12.1: rc {[r['rc'] for r in res]}, held "
          f"{[r['held'] for r in res]}, launches per shard {per_shard} "
          f"(10.1's a shard {ref['per_shard']}), alive "
          f"{[r['alive'] for r in res]} ({ref['alive']} in 10.1), dropped "
          f"{[r['dropped'] for r in res]}")
    text = p12_same("phase 12.1 run()", ref["ke"], ref["pe"], res)
    for r in res:
        add(r["run"])
    win = []
    for window in ("warm", "timed"):
        w = [r[window] for r in res]
        wps = [x["launches"]["shards"] for x in w]
        check(wps == [{str(i): ref["warm"]["per_shard"]}
                      for i in range(P12_WORLD)]
              and sum(x["alive"] for x in w) == ref["n0"]
              and all(x["dropped"] == 0 for x in w),
              f"phase 12.1 {window} window: launches per shard {wps}, "
              f"alive {[x['alive'] for x in w]}, dropped "
              f"{[x['dropped'] for x in w]}")
        for x in w:
            add(x["launches"])
        win.append(w)
    wtext = p12_same("phase 12.1 window", ref["warm"]["ke"],
                     ref["warm"]["pe"], win[0])
    ttext = p12_same("phase 12.1 timed window", ref["timed"]["ke"],
                     ref["timed"]["pe"], win[1])
    med = [float(np.median(r["step_ms"][1:])) for r in res]
    print(f"phase 12.1 bench_scaleout.ini through main() under torchrun, "
          f"one shard a process: {SCALEOUT_STEPS} run() steps, {text}; "
          f"alive {sum(r['alive'] for r in res)}, 0 dropped; the "
          f"{SCALEOUT_WINDOW}-step window from its state, {wtext}; the "
          f"timed window after it, {ttext}; "
          f"launches per shard, run() "
          + "; ".join(f"rank {i} {p}" for i, p in enumerate(per_shard))
          + ", window " + "; ".join(
              f"rank {i} {x['launches']['shards']}"
              for i, x in enumerate(win[1]))
          + f"; ms a step: run() median {max(med):.3f} (10.1, one process: "
          f"{ref['median_ms']:.3f}), timed window "
          f"{max(x['ms'] for x in win[1]):.3f} (10.1: "
          f"{ref['timed']['ms']:.3f}) (host clock, {card})", flush=True)

    # 12.2
    ref = REFS["12.2"]
    res = [g["12.2"] for g in got]
    shards = [r["launches"]["shards"] for r in res]
    check([r["held"] for r in res] == [[0, 1, 2, 3], [4, 5, 6, 7]]
          and all(c == ref["per_shard"] for s in shards
                  for c in s.values())
          and sorted(int(k) for s in shards for k in s) == list(range(8))
          and sum(r["alive"] for r in res) == ref["alive"]
          and all(r["dropped"] == ref["dropped"] == 0 for r in res),
          f"phase 12.2: held {[r['held'] for r in res]}, launches per "
          f"shard {shards} (10.2's {ref['per_shard']}), alive "
          f"{[r['alive'] for r in res]} ({ref['alive']})")
    text = p12_same("phase 12.2", ref["ke"], ref["pe"], res)
    for r in res:
        add(r["launches"])
    print(f"phase 12.2 10.2's tiled deck over (2, 2, 2), four shards a "
          f"process: {PARITY_STEPS} steps, {text}; alive "
          f"{ref['alive']}, 0 dropped; each shard's launches "
          f"{ref['per_shard']} ({card})", flush=True)

    # 12.3
    ref = REFS["12.3"]
    res = [g["12.3"] for g in got]
    n = P12_MG_STEPS + 1
    check([r["held"] for r in res] == [[0, 1], [2, 3]]
          and all(r["mg"] and r["pencil"] for r in res)
          and all(r["cycles"] == list(ref["cycles"][:n]) for r in res)
          and all(r["alive"] == list(ref["alive"]) for r in res),
          f"phase 12.3: held {[r['held'] for r in res]}, cycles a solve "
          f"{[r['cycles'] for r in res]} (10.3's first {n}: "
          f"{list(ref['cycles'][:n])}), alive {[r['alive'] for r in res]} "
          f"(10.3's {list(ref['alive'])})")
    text = p12_same("phase 12.3 maxwellian.ini", ref["ke"][:n],
                    ref["pe"][:n], res)
    pref = REFS["12.3 pencil"]
    bits = all(np.array_equal(p, pref) for p in phis)
    dphi = max(float(np.abs(p - pref).max()) for p in phis) / float(
        np.abs(pref).max())
    check(bits or dphi <= P12_RTOL,
          f"phase 12.3 pencil: phi {dphi:.3e} of max|phi| from 10.4's")
    print(f"phase 12.3 maxwellian.ini over (1, 2, 2), two shards a "
          f"process: {P12_MG_STEPS} steps, multigrid cycles a solve "
          f"{res[0]['cycles']} (10.3's the same), {text}; "
          f"{max(r['ms'] for r in res):.1f} ms a step (10.3, one process: "
          f"{ref['ms']:.1f}); the pencil FFT at 256 x 128 x 128 over two "
          f"processes: phi "
          + ("bit for bit 10.4's" if bits
             else f"within {dphi:.3e} of max|phi| of 10.4's")
          + f", {max(r['pencil_ms'] for r in res):.3f} ms a solve (10.4, "
          f"one process: {REFS['12.3 pencil ms']:.3f}) ({card})",
          flush=True)

    # 12.4
    ref = REFS["12.4"]
    res = [g["12.4"] for g in got]
    q0 = sum(r["q0"] for r in res)
    gross = sum(r["gross"] for r in res)
    q1 = sum(r["q1"] for r in res) + res[0]["rho_obj"]
    shards = [r["launches"]["shards"] for r in res]
    check([r["held"] for r in res] == [[0], [1]]
          and shards == [{str(i): ref["per_shard"]}
                         for i in range(P12_WORLD)]
          and sum(r["alive"] for r in res) == ref["alive"]
          and all(r["dropped"] == 0 for r in res)
          and res[0]["rho_obj"] == res[1]["rho_obj"]
          and abs(q1 - q0) <= OBJ_CHARGE_RTOL * gross,
          f"phase 12.4: held {[r['held'] for r in res]}, launches per shard "
          f"{shards} (11.1's {ref['per_shard']}), alive "
          f"{[r['alive'] for r in res]} ({ref['alive']}), charge {q0:.9g} "
          f"-> {q1:.9g} (gross {gross:.6g}), rho_obj sums "
          f"{[r['rho_obj'] for r in res]}")
    text = p12_same("phase 12.4", ref["ke"], ref["pe"], res)
    dphi = max(float(np.abs(np.asarray(r["phi_c"]) - ref["phi_c"]).max()
                     / np.abs(ref["phi_c"]).max()) for r in res)
    check(dphi <= P12_RTOL, f"phase 12.4: phi_c {dphi:.3e} from 11.1's")
    for r in res:
        add(r["launches"])
    print(f"phase 12.4 11.1's object deck, one shard a process: "
          f"{SHARDED_OBJ_STEPS} run() steps, {text}; phi_c within "
          f"{dphi:.2e}; alive {ref['alive']}, 0 dropped; charge {q0:.9g} -> "
          f"{q1:.9g} (|d| / gross {abs(q1 - q0) / gross:.2e}); launches "
          f"per shard {shards}; run() median "
          f"{max(r['median_ms'] for r in res):.3f} ms a step (11.1, one "
          f"process: {ref['median_ms']:.3f}) ({card})", flush=True)
    print(f"phase 12: the processes' kernel launches {launches}; "
          + ", ".join(f"{k} {g[k]['seconds']:.1f} s"
                      for g in got[:1] for k in ("12.1", "12.2", "12.3",
                                                 "12.4")), flush=True)
    return launches


# -- phase 13: the framework and verification tools on the card ---------------

C_E1 = 7.66067e8            # the C reference's E(1), PARITY.md:51
DRIFT_E1_RTOL = 0.002       # E(1) within 0.2% of it (4.19 M particles)
DRIFT_TOTAL = 0.002         # |total drift| over 13.4's steps
# 13.4's depth: the deck solves by multigrid (langmuirCold.ini's mgSolver),
# which runs its 15-cycle cap every step, eager and host-bound: ~0.3 s a
# step on the card, so the protocol's 10k steps (and 2,000) do not fit the
# run's time; 13.4 takes 4 chunks of 50 with retune() between on each of
# the two scan bodies (64-87 s each), and the 10k-step run is the tool's
# own (python -m pinc_tpu_torch.cbaseline.drift)
DRIFT_STEPS = 200
DRIFT_CHUNK = 50
VALIDATE_STEPS = 200        # script/validate_tpu.py's default
SWEEP_STEPS = 100           # verification/sweep.py's default
# 13.6: maxwellian.ini's tolerance is on the residual (the multigrid's
# default, 5e-6; a solve that meets it stops before the 15-cycle cap), none
# on the error against the analytic phi, which a solve to the tolerance
# takes to the discretization error (9.8e-3 of an rms phi of 3.06).  The
# gate: the best setting solved to the tolerance (fewer cycles than the
# cap), its error within MG_OPT_FACTOR times the deck's own setting's
MG_OPT_FACTOR = 2.5
FRAMEWORK_STEPS = 20        # 13.7


def p13_counts(modules, launches: dict) -> dict:
    """This sub-phase's launches (since the last reset) added into
    ``launches``; returns them."""
    got = {k: v for m in modules for k, v in m.LAUNCHES.items() if v}
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return got


def p13_reset(modules) -> None:
    for m in modules:
        m.reset_launches()


def check_verification(modules, card: str) -> dict:
    """Phase 13: the repo's framework and verification tools, ported
    (pinc_tpu_torch/verification, script, cbaseline, mpinc.sh), each run
    on the card through its Python entry as its CLI runs it, each with its
    own PASS/FAIL rule.  Returns the kernels' launches over the phase."""
    import numpy as np
    import torch
    from pinc_tpu_torch.cbaseline import drift
    from pinc_tpu_torch.script import validate
    from pinc_tpu_torch.script.framework import mg_optimizing
    from pinc_tpu_torch.script.framework.pinc import Pinc
    from pinc_tpu_torch.verification import dispersion, pumode, sweep

    dev = torch.device("cuda", 0)
    here = os.path.dirname(os.path.abspath(__file__))
    launches: dict = {}
    t_phase = time.monotonic()

    # 13.1: the warm 1-D deck's dispersion at its defaults (600 steps)
    t0 = time.monotonic()
    errs = dispersion.main([], device=dev)
    wall = time.monotonic() - t0
    check(dispersion.passed(errs),
          f"phase 13.1 dispersion: modes 1-2 off Bohm-Gross by {errs[:2]} "
          f"(limit {dispersion.TOLERANCE})")
    print(f"phase 13.1 dispersion (600 steps, phi fetched every step): "
          f"PASS, relative errors of modes 1-4 "
          f"{[round(float(e), 6) for e in errs]}; {wall:.1f} s ({card})",
          flush=True)

    # 13.2: the convergence orders
    t0 = time.monotonic()
    check(pumode.main(["all"], device=dev) == 0,
          "phase 13.2 pumode all: FAIL")
    print(f"phase 13.2 pumode all: PASS; {time.monotonic() - t0:.1f} s "
          f"({card})", flush=True)

    # 13.3: the validation run: the exchange check, then 200 steps of the
    # 128^3 deck at 16 per cell
    p13_reset(modules)
    res = validate.validate(VALIDATE_STEPS, device=dev)
    torch.cuda.synchronize()
    got = p13_counts(modules, launches)
    k11 = sum(got.get(k, 0) for k in ("onehot_extract_rows",
                                      "onehot_extract_tile",
                                      "onehot_cleanup", "onehot_merge_rows",
                                      "onehot_merge_tile"))
    check(res["ok"], f"phase 13.3 validate: VALIDATION FAIL {res}")
    check(all(got.get(k, 0) > 0 for k in ("extract", "cleanup", "merge",
                                          "onehot_extract_tile",
                                          "onehot_extract_rows",
                                          "onehot_cleanup",
                                          "onehot_merge_rows",
                                          "onehot_merge_tile", "pic_step",
                                          "efield_tiles", "fold_global",
                                          "deposit"))
          and got.get("pic_step", 0) >= VALIDATE_STEPS,
          f"phase 13.3 validate: launches {got}")
    print(f"phase 13.3 validate: VALIDATION PASS; the exchange check's five "
          f"combinations each on its route; {res['n0']:,} particles, "
          f"{res['steps']} steps in {res['wall']:.2f} s "
          f"({res['psteps']:.4e} particle-steps/s; set-up "
          f"{res['setup']:.1f} s), cadences {res['cadences']}, dropped "
          f"{res['dropped']}, mean |dE/E| re-bucket steps "
          f"{res['rb_mean']:.4e} vs others {res['other_mean']:.4e}; "
          f"launches K8-K10 {got.get('extract', 0)}/{got.get('cleanup', 0)}"
          f"/{got.get('merge', 0)}, K11 {k11}, K5 {got.get('pic_step', 0)}; "
          f"{got} ({card})", flush=True)
    torch.cuda.empty_cache()

    # 13.4: the drift protocol on the C reference's deck, on the mega scan
    # body (the tool's default: K5) and on the in-step fused body
    # (tiles:mega=false: K2, K4), each held to the same gates; the mega
    # body's E(1) is the initial state's energy, the in-step body's the
    # first step's (the mega series is the in-step one a slot later)
    for body, extra, kernels in (
            ("mega", (), ("pic_step", "efield_tiles")),
            ("in-step", ("tiles:mega=false",),
             ("deposit_move", "gather_kick"))):
        p13_reset(modules)
        t0 = time.monotonic()
        sim = drift.make_sim(DRIFT_STEPS, device=dev, extra=extra)
        setup = time.monotonic() - t0
        res = drift.run_chunks(sim, DRIFT_STEPS, DRIFT_CHUNK,
                               log=lambda text: None)
        torch.cuda.synchronize()
        got = p13_counts(modules, launches)
        e1_rel = res["e1"] / C_E1 - 1.0
        print(f"phase 13.4 drift, {body} body ({DRIFT_STEPS} steps in "
              f"chunks of {DRIFT_CHUNK}, retune between): E(1) "
              f"{res['e1']:.6e} ({e1_rel * 100:+.4f}% of the C reference's "
              f"{C_E1:.5e}), total drift {res['total'] * 100:+.5f}%, "
              f"plateau {res['plateau_per_1k'] * 100:+.5f}%/1k steps over "
              f"the last {res['plateau_steps']}; particles "
              f"{res['n0']:,} -> {res['n1']:,}, dropped {res['dropped']}; "
              f"{res['wall']:.1f} s ({res['psteps']:.4e} particle-steps/s; "
              f"set-up {setup:.1f} s), cadences {sim.rebucket_every_s}; "
              f"launches {got} ({card})", flush=True)
        check(sim._use_mega == (body == "mega")
              and all(got.get(k, 0) >= DRIFT_STEPS
                      for k in kernels + ("extract", "merge")),
              f"phase 13.4 drift, {body} body: not on its route, launches "
              f"{got}")
        check(res["n1"] == res["n0"] and res["dropped"] == 0,
              f"phase 13.4 drift, {body} body: particles lost or dropped")
        check(abs(e1_rel) <= DRIFT_E1_RTOL
              and abs(res["total"]) <= DRIFT_TOTAL
              and np.isfinite(res["tot"]).all(),
              f"phase 13.4 drift, {body} body: E(1) off by {e1_rel:+.3e} "
              f"(limit {DRIFT_E1_RTOL}) or total drift "
              f"{res['total']:+.3e} (limit {DRIFT_TOTAL})")
        del sim
        torch.cuda.empty_cache()

    # 13.5: the energy sweep over timeStep, in process
    t0 = time.monotonic()
    values, drifts = sweep.main(["dt", "--inproc", "--steps",
                                 str(SWEEP_STEPS)], device=dev)
    check(len(drifts) == 4 and all(np.isfinite(drifts)),
          f"phase 13.5 sweep: drifts {drifts}")
    print(f"phase 13.5 sweep dt --inproc ({SWEEP_STEPS} steps): "
          + ", ".join(f"dt={v}: {d:.4e}" for v, d in zip(values, drifts))
          + f"; {time.monotonic() - t0:.1f} s ({card})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # 13.6: the multigrid search on maxwellian.ini at 32^3, one shard
        deck = deck_path("maxwellian.ini", tmp, output=False)
        out = os.path.join(tmp, "mg.json")
        t0 = time.monotonic()
        check(mg_optimizing.main([deck, "--rounds", "1", "--json", out,
                                  "grid:nSubdomains=1,1,1",
                                  "grid:trueSize=32,32,32"],
                                 device=dev) == 0,
              "phase 13.6 mg_optimizing failed")
        with open(out) as f:
            mg = json.load(f)
        hist = mg["history"]
        best = next(h for h in hist if all(h[k] == v for k, v in
                                           mg["best"].items()))
        base_err = hist[0]["rms_error"]
        cap = 15                                 # maxwellian.ini mgCycles
        check(all(np.isfinite(h["rms_error"]) and 1 <= h["cycles"] <= cap
                  for h in hist)
              and best["cycles"] < cap
              and best["rms_error"] <= base_err * MG_OPT_FACTOR,
              f"phase 13.6 mg_optimizing: the best setting's {best['cycles']}"
              f" cycles (cap {cap}) and rms error {best['rms_error']} "
              f"against the deck's setting's {base_err} (limit "
              f"{MG_OPT_FACTOR} times), or a setting's error or cycles out "
              f"of range: {hist}")
        ladder = sorted(hist, key=lambda h: h["seconds"])
        capped = sum(h["cycles"] >= cap for h in hist)
        print(f"phase 13.6 mg_optimizing (maxwellian.ini, 32^3, one shard, "
              f"1 round, {len(hist)} settings): best {mg['best']} "
              f"{mg['seconds'] * 1e3:.4f} ms/solve, {best['cycles']} "
              f"cycles, "
              f"rms error {best['rms_error']:.5e} (the deck's "
              f"setting {hist[0]['seconds'] * 1e3:.4f} ms, "
              f"{hist[0]['cycles']} cycles, {base_err:.5e}); {capped} "
              f"settings ran to the cycle cap; fastest five "
              + "; ".join(f"{h['n_pre']}/{h['n_post']}/{h['n_coarse']}/"
                          f"{h['levels']} {h['seconds'] * 1e3:.4f} ms"
                          for h in ladder[:5])
              + f"; {time.monotonic() - t0:.1f} s ({card})", flush=True)

        # 13.7: the Pinc framework and the launcher, subprocesses on the
        # card
        deck = deck_path("langmuirCold1D.ini", tmp, output=False)
        t0 = time.monotonic()
        run = Pinc(deck, {"time:nTimeSteps": FRAMEWORK_STEPS})
        n_dev = run.getnp()
        rc = run.run(check=False).returncode
        check(n_dev == 1 and rc == 0,
              f"phase 13.7 Pinc: getnp {n_dev}, run rc {rc}")
        proc = subprocess.run(
            ["bash", os.path.join(here, "pinc_tpu_torch", "mpinc.sh"), deck,
             f"time:nTimeSteps={FRAMEWORK_STEPS}"],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0
              and "deck requests 1 device(s)" in proc.stderr
              and "PINC-TPU-torch finished" in proc.stderr + proc.stdout,
              f"phase 13.7 mpinc.sh: rc {proc.returncode}; "
              f"{proc.stderr[-2000:]}")
        print(f"phase 13.7 Pinc(langmuirCold1D.ini, {FRAMEWORK_STEPS} steps)"
              f".getnp() {n_dev}, .run() rc {rc}; pinc_tpu_torch/mpinc.sh "
              f"rc {proc.returncode} ('deck requests 1 device(s)'); "
              f"{time.monotonic() - t0:.1f} s ({card})", flush=True)
    print(f"phase 13: {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


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
    walled_ms = check_mg_and_walls(cli_main, modules, prod, card, run_ms,
                                   aux["ms_step"])

    # -- phase 9: embedded objects ----------------------------------------
    obj_ms = check_objects(modules, card, walled_ms)

    # -- phase 10: the multi-device layer on meshes of the one card -------
    scaleout_ms = check_parallel(cli_main, modules, prod, card, run_ms,
                                 aux["ms_step"])

    # -- phase 11: decomposed object decks on meshes of the one card ------
    # K1, K3, K4 and the gather exchange run on its path: their rows count
    # 11.1's launches too (both shards, run() and its two windows)
    for name, n in check_sharded_objects(modules, card, obj_ms,
                                         scaleout_ms).items():
        launches[name] = launches.get(name, 0) + n

    # -- phase 12: runs over several processes on the one card ------------
    # the processes' launches of K1-K5 and K8-K11 count on the path too
    for name, n in check_multiprocess(modules, card).items():
        launches[name] = launches.get(name, 0) + n

    # -- phase 13: the framework and verification tools -------------------
    # K1, K5-K11 run on its path (13.3's exchange check and window, 13.4's
    # windows): their rows count its launches too
    for name, n in check_verification(modules, card).items():
        launches[name] = launches.get(name, 0) + n

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
    if len(sys.argv) == 3 and sys.argv[1] == "--phase12":
        raise SystemExit(phase12_child(sys.argv[2]))
    raise SystemExit(main())
