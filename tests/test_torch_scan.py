"""The scan windows of pinc_tpu_torch's TiledSimulation (make_scan_steps,
the mega-fused window and the kernel-pair window) against pinc_tpu's.

* The window as a whole: 8 steps of a 16^3 deck (T = 4, M = 2, two species,
  cadences forced to [2, 4], the sort re-bucket on both sides, f32
  weights), with fresh=True (the per-step margin schedule) and fresh=False
  (the full margin), and with tiles:mega=false.  The JAX side runs its
  Pallas kernels in interpret mode (tiles:backend=pallas), the port the
  plain versions; both start from the same initial tiled state.
* The plan: the port's sequence of steps, per-step margins and re-bucket
  events against the one pinc_tpu's _scan_with_rebuckets and _scan_sched
  execute, recorded by running them with jax.lax.scan replaced by a Python
  loop and a body and re-bucket that note what they are asked to do.

Tolerances: ke and pe rtol 1e-5, the final lpos and vel atol 1e-5 (float32
sums in another order, over 8 steps); alive, the drop count and the plans
exactly."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
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
nTimeSteps = 8
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
backend = pallas
mxuDtype = f32
"""
STEPS, CADENCES = 8, [2, 4]
RUNS = {"sched": dict(fresh=True), "generic": dict(fresh=False),
        "pairs": dict(fresh=True, mega=False)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deck(mega=True):
    return DECK + ("" if mega else "mega = false\n")


def _force_cadences(sim):
    sim.rebucket_every_s = list(CADENCES)
    sim.rebucket_every = min(CADENCES)
    return sim


@pytest.fixture(scope="module")
def jax_runs():
    """pinc_tpu's make_scan_steps window for each case, with its initial
    tiled state, as numpy arrays."""
    out = {}
    for name, kw in RUNS.items():
        sim = _force_cadences(JTiledSimulation(
            JConfig.from_string(_deck(kw.get("mega", True))), seed=3))
        assert sim._backend == "pallas"
        assert sim._use_mega == kw.get("mega", True)
        init = tuple(np.array(getattr(sim.state, k))
                     for k in ("lpos", "vel", "alive"))
        st, (ke, pe, dropped) = sim.make_scan_steps(
            STEPS, fresh=kw["fresh"])(sim.state)
        out[name] = dict(init=init, ke=np.asarray(ke), pe=np.asarray(pe),
                         dropped=int(dropped),
                         final=tuple(np.asarray(getattr(st, k))
                                     for k in ("lpos", "vel", "alive")))
    return out


def _port_sim(mega=True):
    return _force_cadences(TiledSimulation(
        PincConfig.from_string(_deck(mega)), seed=3, device="cpu"))


@pytest.mark.parametrize("name", list(RUNS))
def test_scan_matches_pinc_tpu(jax_runs, name):
    ref, kw = jax_runs[name], RUNS[name]
    sim = _port_sim(kw.get("mega", True))
    for mine, theirs in zip(compat.tiled_state_to_numpy(sim.state),
                            ref["init"]):
        np.testing.assert_array_equal(mine, theirs)
    run_n = sim.make_scan_steps(STEPS, fresh=kw["fresh"])
    want_plan = (sim._plan_sched(STEPS) if name == "sched"
                 else sim._plan_generic(STEPS))
    assert run_n.plan == want_plan
    tk.reset_launches()
    fk.reset_launches()
    st, (ke, pe, dropped) = run_n(sim.state)
    assert tk.LAUNCHES["pic_step"] == 0 and fk.LAUNCHES["fold_global"] == 0
    assert ke.shape == (STEPS, 2) and pe.shape == (STEPS,)
    np.testing.assert_allclose(ke.numpy(), ref["ke"], rtol=1e-5)
    np.testing.assert_allclose(pe.numpy(), ref["pe"], rtol=1e-5)
    assert int(dropped) == ref["dropped"] == 0
    lpos, vel, alive = compat.tiled_state_to_numpy(st)
    np.testing.assert_array_equal(alive, ref["final"][2])
    np.testing.assert_allclose(lpos, ref["final"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(vel, ref["final"][1], rtol=0, atol=1e-5)
    assert alive.sum() == 2 * 8 * 16 ** 3


def test_scan_donation():
    """donate=False leaves the state it is given as it was (a second call
    on it gives the same window); donate=True updates it in place."""
    sim = _port_sim()
    st0 = sim.state
    keep = [t.clone() for t in (st0.lpos, st0.vel, st0.alive)]
    run_n = sim.make_scan_steps(STEPS, fresh=True)
    st1, (ke1, pe1, _) = run_n(st0)
    for a, b in zip((st0.lpos, st0.vel, st0.alive), keep):
        assert torch.equal(a, b)
    st2, (ke2, pe2, _) = run_n(st0)
    assert torch.equal(ke1, ke2) and torch.equal(pe1, pe2)
    assert torch.equal(st1.lpos, st2.lpos)
    st3, (ke3, _, _) = sim.make_scan_steps(STEPS, donate=True,
                                           fresh=True)(st0)
    assert st3.lpos is st0.lpos and st3.vel is st0.vel
    assert torch.equal(ke3, ke1) and torch.equal(st0.lpos, st1.lpos)


def test_margin_schedule_needs_fresh_m2_and_whole_windows():
    sim = _port_sim()
    assert sim.make_scan_steps(8, fresh=True).plan == sim._plan_sched(8)
    for n, fresh in ((8, False), (7, True)):
        assert (sim.make_scan_steps(n, fresh=fresh).plan
                == sim._plan_generic(n))
    sim.cfg = PincConfig.from_string(_deck() + "marginSchedule = false\n")
    assert sim.make_scan_steps(8, fresh=True).plan == sim._plan_generic(8)


def _pyscan(f, init, xs, length):
    """jax.lax.scan as a Python loop."""
    carry, ys = init, []
    for _ in range(length):
        carry, y = f(carry, None)
        ys.append(y)
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


def _jax_plan(monkeypatch, cadences, n, M, sched):
    """The steps (with their margins) and re-bucket events that pinc_tpu's
    _scan_sched (sched) or _scan_with_rebuckets execute, in order."""
    events = []
    sim = JTiledSimulation.__new__(JTiledSimulation)
    sim.rebucket_every_s = list(cadences)
    sim.rebucket_every = min(cadences)
    sim.ts = SimpleNamespace(M=M)

    def rebucket(st, species=None):
        events.append(("rebucket", tuple(species)))
        return st, jnp.zeros((), jnp.int32)

    def body(carry, margins=None):
        events.append(("step", margins))
        return carry, jnp.zeros(())
    sim._rebucket = rebucket
    monkeypatch.setattr(jax.lax, "scan", _pyscan)
    if sched:
        sim._scan_sched(body, (0,), n)
    else:
        sim._scan_with_rebuckets(lambda c, _: body(c, None), (0,), n)
    return events


PLANS = {
    "test_deck": ([2, 4], 8, 2),
    "headline": ([4, 176], 176, 2),
    "aux_uniform": ([10, 10], 40, 1),
    "leftover": ([4, 8], 14, 2),
    "one_species": ([6], 20, 2),
    "three_cadences": ([2, 3, 6], 24, 2),
    "m3_tail": ([4, 12, 12], 30, 3),
    "collapse_over_64": ([3, 5], 200, 2),
}


@pytest.mark.parametrize("sched", [False, True], ids=["generic", "sched"])
@pytest.mark.parametrize("case", list(PLANS))
def test_plan_matches_pinc_tpu(monkeypatch, case, sched):
    cadences, n, M = PLANS[case]
    want = _jax_plan(monkeypatch, cadences, n, M, sched)
    sim = TiledSimulation.__new__(TiledSimulation)
    sim.rebucket_every_s = list(cadences)
    sim.rebucket_every = min(cadences)
    sim.ts = SimpleNamespace(M=M)
    got = sim._plan_sched(n) if sched else sim._plan_generic(n)
    assert got == want
    assert sum(kind == "step" for kind, _ in got) == n
    if case == "collapse_over_64" and not sched:
        # pinc_tpu re-buckets every species every 3 steps here: 66 events
        assert got.count(("rebucket", (0,))) == n // 3
        assert got.count(("rebucket", (1,))) == n // 3
