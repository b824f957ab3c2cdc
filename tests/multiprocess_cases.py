"""The decks of tests/test_torch_multiprocess.py, run by two spawned gloo
processes over a FileStore and by the test process on the single-process
mesh over ``["cpu"] * n``; each case returns the numbers it is held to.
Imports neither jax nor pinc_tpu: the spawned processes import this
module."""

import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from object_decks import TILES_M2, deck as object_deck, sphere_domain
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.parallel.pencil_fft import PencilSpectralSolver
from pinc_tpu_torch.parallel.mesh import make_mesh
from pinc_tpu_torch.parallel.pic import make_simulation
from pinc_tpu_torch.utils import multihost as mh

WORLD = 2
#: the process group's deadline in the spawned processes
TIMEOUT_S = 60.0
STEPS = 4

# tests/test_torch_tiled_sharded.py's deck (T = 4, M = 1, B = 384: the
# one-hot exchange, a re-bucket every 2 steps)
TILED = """
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {true}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.08,0.002
drift = 0.05
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
margin = 1
rebucketEvery = 2
{extra}"""

# tests/test_torch_parallel.py's DECK_3D (flat)
FLAT = """
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {true}
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
poisson = {solver}
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrants3D
[multigrid]
mgLevels = 2
mgCycles = 15
nPreSmooth = 3
nPostSmooth = 3
nCoarseSolve = 10
{extra}"""


def tiled_deck(nsub, true, steps=STEPS, extra=""):
    return TILED.format(nsub=nsub, true=true, steps=steps, extra=extra)


def flat_deck(nsub, true, solver="sSolve", steps=STEPS, extra=""):
    return FLAT.format(nsub=nsub, true=true, solver=solver, steps=steps,
                       extra=extra)


def _np(x):
    return x.detach().cpu().numpy()


def _state(sim, st) -> dict:
    flat = sim._flat_state(st)
    return {k: _np(getattr(flat, k)) for k in ("lpos", "vel", "alive")}


def _hist(hist) -> dict:
    return {"ke": hist["kinetic"], "pe": hist["potential"]}


def tiled_case(nsub, true, debug=False):
    """run() (re-buckets, the margin count, the drops; debug: with the
    methods:debug guards), a window from its state (the mega body: K5's
    plain version a shard), then one step's gathered rho and phi, and the
    gathered state."""
    def case(tmp: Path) -> dict:
        cfg = PincConfig.from_string(tiled_deck(nsub, true))
        cfg.set_str("methods:debug", str(debug).lower())
        sim = make_simulation(cfg, seed=7, device="cpu")
        hist = sim.run(progress_every=0)
        out = _hist(hist)
        out.update(dropped=hist["dropped"], lost=hist["n_lost"],
                   proc_held=sum(s is not None for s in sim.state))
        st, (ke, pe, dropped) = sim.make_scan_steps(STEPS, donate=True)(
            sim.state)
        out.update(wke=_np(ke), wpe=_np(pe), wdropped=int(dropped))
        st, rho, phi, _, diag = sim._tiled_step(st)
        out.update(rho=_np(sim.ctx.gather(rho)), phi=_np(sim.ctx.gather(phi)),
                   ke1=_np(diag.kin_energy), **_state(sim, st))
        return out
    return case


def flat_mg_case(tmp: Path) -> dict:
    """The flat (1, 2, 2) deck solved by the sharded multigrid: run() with
    the methods:debug guards, the cycles of every solve, the gathered
    population and fields."""
    cfg = PincConfig.from_string(flat_deck("1,2,2", "16,8,8",
                                           solver="mgSolve"))
    cfg.set_str("methods:debug", "true")
    sim = make_simulation(cfg, seed=3, device="cpu")
    solver, cycles = sim._solve, []

    def counted(rho):
        phi, n, _ = solver.solve_with_stats(rho)
        cycles.append(n)
        return phi
    sim._solve = counted
    hist = sim.run(progress_every=0)
    out = _hist(hist)
    step = sim._step(sim.particles)
    p = sim.gather_particles(step.particles)
    out.update(cycles=np.asarray(cycles), lost=_np(step.diag.n_lost),
               rho=_np(sim.ctx.gather(step.rho)),
               phi=_np(sim.ctx.gather(step.phi)),
               **{k: _np(getattr(p, k))
                  for k in ("cell", "frac", "vel", "alive")})
    return out


def mgmode_case(tmp: Path) -> dict:
    """methods:mode = mgMode through the CLI on the (1, 2, 2) multigrid
    deck, its timer file the primary's."""
    from pinc_tpu_torch.__main__ import main
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "deck.ini"
    if mh.is_primary():
        path.write_text(flat_deck("1,2,2", "16,8,8", solver="mgSolve"))
    mh.barrier()
    out: dict = {}
    assert main([str(path), "methods:mode=mgMode",
                 "multigrid:nRepetitions=2",
                 f"files:output={tmp}/out/run"], out=out,
                device="cpu") == 0
    return {"cycles": out["cycles"], "rms_error": out["rms_error"]}


def pencil_case(tmp: Path) -> dict:
    """The pencil FFT over (2, 2, 1): a solve of a seeded rho, and two steps
    of the flat deck that solves with it."""
    ctx = make_mesh((2, 2, 1), (8, 8, 16), devices=["cpu"] * 4)
    rho = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, 16, 16)).astype(np.float32))
    phi = PencilSpectralSolver((16, 16, 16), ctx)(ctx.split(rho))
    sim = make_simulation(PincConfig.from_string(flat_deck(
        "2,2,1", "8,8,16", steps=2, extra="[parallel]\npencilFFT = true\n")),
        seed=3, device="cpu")
    assert isinstance(sim._solve, PencilSpectralSolver)
    out = _hist(sim.run(progress_every=0))
    out["phi"] = _np(ctx.gather(phi))
    return out


def object_case(layout):
    """The sphere deck (tests/object_decks.py) over (2, 1, 1), the sphere
    across the shard boundary: absorb on the flat layout, ions emitting
    electrons on the tiled one (the sums of the absorbed, adhered and
    emitted charge over the mesh)."""
    def case(tmp: Path) -> dict:
        tiled = layout == "tiled"
        cfg = PincConfig.from_string(object_deck(
            "sphere.grid.h5", "secondary" if tiled else "absorb",
            steps=STEPS, layout=layout, extra=TILES_M2 if tiled else ""))
        cfg.set_str("grid:nSubdomains", "2,1,1")
        cfg.set_str("grid:trueSize", "8,16,16")
        sim = make_simulation(cfg, seed=1, device="cpu",
                              domain=sphere_domain())
        out = _hist(sim.run(progress_every=0))
        out.update(rho_obj=sim.last_rho_obj,
                   phi_c=sim.last_obj_potential)
        if tiled:
            out.update(see=_np(torch.stack([sim.see_emitted,
                                            sim.see_overflow])),
                       **_state(sim, sim.state))
        else:
            p = sim.gather_particles()
            out.update({k: _np(getattr(p, k))
                        for k in ("cell", "frac", "vel", "alive")})
        return out
    return case


def output_case(text, *overrides):
    """The CLI with files:output, every second step; the test reads the
    files."""
    def case(tmp: Path) -> dict:
        from pinc_tpu_torch.__main__ import main
        tmp.mkdir(parents=True, exist_ok=True)
        path = tmp / "deck.ini"
        if mh.is_primary():
            path.write_text(text)
        mh.barrier()
        assert main([str(path), f"files:output={tmp}/out/run",
                     "files:writeFrequency=2", *overrides],
                    device="cpu") == 0
        return {}
    return case


def checkpoint_case(tmp: Path) -> dict:
    """A checkpoint of the tiled (2, 1, 1) deck every 2 steps (4 steps),
    then a resume to step 6 from it."""
    def cfg(steps, resume=False):
        c = PincConfig.from_string(tiled_deck(
            "2,1,1", "16,16,16", steps=steps,
            extra=f"[files]\noutput = {tmp}/run\ncheckpointEvery = 2\n"))
        if resume:
            c.set_str("time:resume", "true")
        return c
    make_simulation(cfg(STEPS), seed=7, device="cpu").run(progress_every=0)
    sim = make_simulation(cfg(STEPS + 2, resume=True), seed=7, device="cpu")
    out = _hist(sim.run(progress_every=0))
    out.update(start=sim.start_step, **_state(sim, sim.state))
    return out


CASES = {
    "tiled_211": tiled_case("2,1,1", "16,16,16"),
    "tiled_221": tiled_case("2,2,1", "8,8,16", debug=True),
    "flat_mg": flat_mg_case,
    "mgmode": mgmode_case,
    "pencil": pencil_case,
    "objects_flat": object_case("flat"),
    "objects_tiled": object_case("tiled"),
    "output": output_case(tiled_deck("2,1,1", "16,16,16")),
    "output_async": output_case(flat_deck("2,1,1", "8,16,16"),
                                "files:async=true"),
    "checkpoint": checkpoint_case,
}


def scaleout_card_case(tmp: Path) -> dict:
    """input/bench_scaleout.ini at 32^3 a shard over [cuda:0] * 2: run()
    (K2, K4, the gather exchange), then a window (K5)."""
    root = Path(__file__).resolve().parent.parent
    cfg = PincConfig.from_file(str(root / "input" / "bench_scaleout.ini"),
                               ["grid:trueSize=32,32,32",
                                f"time:nTimeSteps={STEPS + 2}"])
    sim = make_simulation(cfg, devices=[torch.device("cuda", 0)] * 2)
    hist = sim.run(progress_every=0)
    out = _hist(hist)
    st, (ke, pe, dropped) = sim.make_scan_steps(STEPS, donate=True)(
        sim.state)
    out.update(dropped=hist["dropped"], wke=_np(ke), wpe=_np(pe),
               wdropped=int(dropped), proc_held=sum(
                   s is not None for s in st), **_state(sim, st))
    return out


CARD_CASES = {"scaleout_card": scaleout_card_case}


def _mismatch(tmp: Path) -> dict:
    """Process 1 leaves; process 0's next collective must fail, not
    hang."""
    if mh.process_index() == 1:
        return {}
    ctx = make_mesh((2, 1, 1), (4, 4, 4), devices=["cpu"] * 2)
    t0 = time.monotonic()
    try:
        ctx.sum([torch.ones(()) if i in ctx.local else None
                 for i in range(2)])
    except RuntimeError as e:
        return {"error": str(e)[:200], "seconds": time.monotonic() - t0}
    return {"seconds": time.monotonic() - t0}


def _save(out_dir: Path, name: str, rank: int, res: dict) -> None:
    np.savez(out_dir / f"{name}.r{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})


def child(rank: int, store: str, out_dir: str, names,
          device: str = "cpu") -> None:
    """A spawned process: torchrun's environment, the process group over
    the FileStore (gloo, by the backend rule: on the CPU, or both ranks on
    the one card), then the cases in turn (results to out_dir), on the
    CPU the mismatch last."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)
    out = Path(out_dir)
    cases = {**CASES, **CARD_CASES}
    try:
        mh.init(device="cpu" if device == "cpu" else None,
                init_method=f"file://{store}", timeout_s=TIMEOUT_S)
        for name in names:
            _save(out, name, rank, cases[name](out / name))
        if device == "cpu":
            _save(out, "mismatch", rank, _mismatch(out / "mismatch"))
        else:
            mh.shutdown()
    except BaseException:
        (out / f"error.r{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(out_dir: Path, names, device: str = "cpu"):
    """Start the two processes (spawn, not fork)."""
    import multiprocessing as mp
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=child, args=(r, str(out_dir / "store"),
                                             str(out_dir), list(names),
                                             device))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def join(procs, deadline_s: float) -> list:
    """Join with a deadline; a process past it is killed.  Returns the exit
    codes (None where killed)."""
    end = time.monotonic() + deadline_s
    codes = []
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def load(out_dir: Path, name: str, rank: int) -> dict:
    with np.load(out_dir / f"{name}.r{rank}.npz") as f:
        return {k: f[k] for k in f.files}
