"""tiles:backend and tiles:gather in pinc_tpu_torch's TiledSimulation,
against pinc_tpu's.

pinc_tpu reads tiles:backend (pinc_tpu/tiled_sim.py:224-228): "pallas"
takes its fused kernels, the mega scan body and the margin schedule; any
other value ("xla") the unfused XLA step, f32 weights whatever
tiles:mxuDtype says, and a scan over run()'s in-step kick order.  The port
reads it the same way, and runs the XLA route as pinc_tpu's unfused step
(the drift, then K1 and K7, the solve, K3 and the kick, in run() and in
the scan window) at f32 weights.

* The XLA route as a whole: a 16^3 deck (T = 4, M = 2, two species, the
  sort re-bucket, tiles:mxuDtype = bf16, which the XLA route ignores), the
  scan window (8 steps, cadences forced to [2, 4], fresh=True) and run()
  (6 steps, rebucketEvery = 2), from the same host-initialised tiled state
  on both sides.  The JAX side runs its XLA deposit and gather on the CPU,
  the port the kernels' plain versions.
* The selection: "pallas" (the port's default) still takes the mega body
  and, with fresh=True, the margin schedule; "xla" takes neither, with or
  without tiles:mega, as in pinc_tpu.
* tiles:gather is accepted and changes nothing.

Tolerances: those of tests/test_torch_slice.py at f32 weights: ke and pe
rtol 1e-5, the final lpos and vel atol 1e-5 (float32 sums in another
order); alive, the drop count and the plans exactly."""

import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu_torch import compat
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import field_kernels as fk
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.tiled_sim import TiledSimulation

DECK = """
[time]
nTimeSteps = 6
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 8 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.05
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
margin = 2
rebucket = sort
mxuDtype = bf16
"""
STEPS, CADENCES = 8, [2, 4]
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deck(backend=None, extra=""):
    return (DECK + (f"backend = {backend}\n" if backend else "") + extra)


def _force_cadences(sim):
    sim.rebucket_every_s = list(CADENCES)
    sim.rebucket_every = min(CADENCES)
    return sim


def _numpy_state(st):
    return tuple(np.asarray(getattr(st, k)) for k in ("lpos", "vel", "alive"))


def _compare_state(mine, theirs):
    lpos, vel, alive = mine
    np.testing.assert_array_equal(alive, theirs[2])
    np.testing.assert_allclose(lpos, theirs[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(vel, theirs[1], rtol=0, atol=ATOL)


def _check_init(sim, jsim):
    for mine, theirs in zip(compat.tiled_state_to_numpy(sim.state),
                            _numpy_state(jsim.state)):
        np.testing.assert_array_equal(mine, theirs)


def test_xla_scan_window_matches_pinc_tpu():
    """The window on the XLA route: pinc_tpu scans its unfused step with
    the generic re-bucket schedule even with fresh=True; so does the port,
    with its unfused step at f32 weights."""
    jsim = _force_cadences(JTiledSimulation(
        JConfig.from_string(_deck("xla")), seed=3))
    assert jsim._backend == "xla" and not jsim._use_mega
    sim = _force_cadences(TiledSimulation(
        PincConfig.from_string(_deck("xla")), seed=3, device="cpu"))
    _check_init(sim, jsim)
    jst, (jke, jpe, jdropped) = jsim.make_scan_steps(
        STEPS, fresh=True)(jsim.state)
    run_n = sim.make_scan_steps(STEPS, fresh=True)
    assert run_n.plan == sim._plan_generic(STEPS)
    tk.reset_launches()
    fk.reset_launches()
    st, (ke, pe, dropped) = run_n(sim.state)
    assert tk.LAUNCHES["pic_step"] == 0 and tk.LAUNCHES["deposit_move"] == 0
    assert ke.shape == (STEPS, 2) and pe.shape == (STEPS,)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jke), rtol=RTOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=RTOL)
    assert int(dropped) == int(jdropped) == 0
    _compare_state(compat.tiled_state_to_numpy(st), _numpy_state(jst))


def test_xla_run_matches_pinc_tpu():
    """run() on the XLA route: pinc_tpu's unfused step against the port's
    (K1 and K3), both with f32 weights."""
    deck = _deck("xla", "rebucketEvery = 2\n")
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=3)
    assert not jsim._use_fused
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3,
                          device="cpu")
    assert sim._mxu_dtype == torch.float32
    _check_init(sim, jsim)
    jhist = jsim.run(progress_every=0)
    hist = sim.run(progress_every=0)
    for key in ("kinetic", "potential"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=RTOL)
    assert hist["dropped"] == hist["n_lost"] == 0
    _compare_state(compat.tiled_state_to_numpy(sim.state),
                   _numpy_state(jsim.state))


@pytest.mark.parametrize("backend, mega", [
    (None, None), ("pallas", None), ("PALLAS", "false"), ("xla", None),
    ("xla", "true"), ("XLA", "false")])
def test_backend_selects_the_scan_route(backend, mega):
    """pinc_tpu's flags and the port's on the same deck: the mega body
    (pallas with tiles:mega not false), the margin schedule of a fresh
    window (pallas, mega body, M >= 2); and the port's weight dtype (bf16
    as asked on pallas, f32 on xla, where pinc_tpu's XLA deposit and
    gather never read tiles:mxuDtype).  The deck without tiles:backend is
    the pallas route in the port; pinc_tpu's default on its CPU is xla."""
    extra = f"mega = {mega}\n" if mega else ""
    sim = _force_cadences(TiledSimulation(
        PincConfig.from_string(_deck(backend, extra)), seed=3,
        device="cpu"))
    pallas = backend is None or backend.lower() == "pallas"
    mega_on = pallas and mega != "false"
    assert sim._use_mega == mega_on
    assert sim._mxu_dtype == (torch.bfloat16 if pallas else torch.float32)
    plan = sim.make_scan_steps(STEPS, fresh=True).plan
    want = sim._plan_sched(STEPS) if mega_on else sim._plan_generic(STEPS)
    assert plan == want
    assert (plan != sim._plan_generic(STEPS)) == mega_on
    if backend is not None:
        jsim = JTiledSimulation(JConfig.from_string(_deck(backend, extra)),
                                seed=3)
        assert jsim._backend == sim._backend == backend.lower()
        assert jsim._use_mega == sim._use_mega


@pytest.mark.parametrize("gather", ["mxu", "XLA"])
def test_gather_key_is_accepted(gather):
    """tiles:gather is read (lower-cased, as pinc_tpu reads it) and
    changes nothing: two steps of run() bit for bit as without it."""
    runs = []
    for extra in ("", f"gather = {gather}\n"):
        sim = TiledSimulation(PincConfig.from_string(
            _deck("xla", extra).replace("nTimeSteps = 6", "nTimeSteps = 2")),
            seed=3, device="cpu")
        runs.append((sim, sim.run(progress_every=0)))
    (plain, hp), (gsim, hg) = runs
    assert plain._gather_mode == "mxu" and gsim._gather_mode == gather.lower()
    assert np.array_equal(hp["kinetic"], hg["kinetic"])
    assert np.array_equal(hp["potential"], hg["potential"])
    for a, b in zip(compat.tiled_state_to_numpy(plain.state),
                    compat.tiled_state_to_numpy(gsim.state)):
        assert np.array_equal(a, b)
