"""Bounded walls, the multigrid solver inside a run, the methods:debug
guards and the tiled 1-D and 2-D decks: pinc_tpu_torch against pinc_tpu on
the same inputs.

* reflect (ops/pusher.py) on positions several boxes outside the walls
  (many bounces in one step), all dims bounded and mixed: positions atol
  1e-5 (the same float32 folds), velocities and alive exactly.
* Flat runs of tests/test_tiled_bc.py's deck (16^3, two species, mgSolve,
  5 steps; Dirichlet, Neumann and a mixed deck): energies rtol 1e-5,
  global positions and velocities atol 1e-5 slot for slot.
* Tiled runs of the same deck, Dirichlet and Neumann, re-bucketed by the
  sort: the JAX side runs tiles:backend=pallas with its kernels in
  interpret mode, as tests/test_torch_slice.py does, so both take the
  unfused route (drift, reflection, K1 per species, K7, the multigrid
  solve, the BC-aware gradient, K3); energies rtol 1e-5, lpos and vel
  atol 1e-5 slot for slot, alive exactly, and every live particle inside
  [0, L-1].  Within the port, the same Dirichlet run re-bucketed by the
  gather exchange (slack 4: B = 1024; pinc_tpu's interpret-mode exchange
  takes minutes, and tests/test_torch_exchange.py holds the exchange to
  it bit for bit) against the sort run: the same particles, each inside
  the walls, energies rtol 1e-5 (the slots, and so the summation order,
  differ).
* The periodic mgSolve deck (tests/test_torch_scan.py's, 2 levels): the
  mega scan window (8 steps, cadences [2, 4], fresh) against pinc_tpu's in
  interpret mode, and run() on tiles:backend=xla on both sides (pinc_tpu's
  XLA step against the port's unfused K1/K3 step): ke and pe rtol 1e-4
  (pe is 0.5 sum(rho phi), rho a difference of near-equal densities),
  lpos and vel atol 1e-5.
* methods:debug: a tiny population:maxVel raises in both packages, flat
  and tiled; a sound deck runs in both.
* input/maxwellian.ini (mgSolve) on one subdomain, 5 steps through the
  port's CLI: the flat layout, the multigrid, finite energies.
* input/langmuirCold1D.ini and langmuir2D.ini with methods:layout=tiled,
  6 steps, re-bucketed every 2 (pinc_tpu's XLA route and the sort; the
  port through its CLI, on its plain tiled functions): the same particles (each species'
  global positions and velocities, each component sorted, atol 1e-5: the
  cold lattice puts particles on tile boundaries, where a round-off
  decides the tile a re-bucket gives them, so slots are not compared);
  ke rtol 1e-3 and pe within 1e-3 of its largest magnitude: these cold
  decks start from a 1e-3 perturbation, so rho is ~1e-4 of each
  species' density, and the float32 round-off of the species' sums
  (~1e-7 of them) is ~1e-3 of rho and of the field and kinetic energy
  it drives.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.ops import pusher as jpusher
from pinc_tpu.population import Particles as JParticles
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu.utils.logging import PincError as JPincError
from pinc_tpu_torch import compat
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import pusher
from pinc_tpu_torch.ops.tiled import tile_origins
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.tiled_sim import TiledSimulation
from pinc_tpu_torch.utils.logging import PincError

INPUT = Path(__file__).resolve().parents[1] / "input"

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bounded", [None, (True, False, True),
                                     (False, True, False)])
def test_reflect_matches_pinc_tpu(bounded):
    rng = np.random.default_rng(5)
    L = (16, 8, 12)
    pos = rng.uniform(-40, 60, (2, 500, 3))
    pos[0, :8] = [[0.0, 7.0, 11.0], [15.0, 0.0, 0.0], [-15.0, 14.0, 23.0],
                  [30.0, -7.0, 22.0], [45.5, 21.0, -0.5], [-0.25, 7.5, 11.5],
                  [15.0, 8.0, 12.0], [-30.0, -14.0, -22.0]]
    cell = np.floor(pos).astype(np.int32)
    frac = (pos - cell).astype(np.float32)
    vel = rng.standard_normal((2, 500, 3)).astype(np.float32)
    alive = rng.uniform(size=(2, 500)) > 0.1
    ref = jpusher.reflect(JParticles(cell=cell, frac=frac, vel=vel,
                                     alive=alive), L, bounded=bounded)
    mine = pusher.reflect(compat.particles_from_numpy(cell, frac, vel,
                                                      alive), L,
                          bounded=bounded)
    np.testing.assert_allclose(mine.pos().numpy(), np.asarray(ref.pos()),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mine.vel.numpy(), np.asarray(ref.vel))
    np.testing.assert_array_equal(mine.alive.numpy(), alive)
    flips = (mine.vel.numpy() != vel).any()
    assert flips
    for d in range(3):
        if bounded is None or bounded[d]:
            g = mine.pos().numpy()[..., d]
            assert g.min() >= 0.0 and g.max() <= L[d] - 1


BOUNDED_DECK = """
[time]
nTimeSteps = 5
timeStep = 0.1
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = {bounds}
bndValues = 0,0,0,0,0,0
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.06,0.002
drift = 0.03
[methods]
mode = regular
poisson = mgSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = {layout}
[multigrid]
mgLevels = 2
mgCycles = 8
nPreSmooth = 3
nPostSmooth = 3
nCoarseSolve = 12
[tiles]
tileSize = 4
margin = 1
rebucketEvery = 2
"""
MIXED = "DIRICHLET,PERIODIC,NEUMANN,DIRICHLET,PERIODIC,NEUMANN"


def _energies(hist, ref):
    for key in ("kinetic", "potential"):
        np.testing.assert_allclose(hist[key], ref[key], rtol=RTOL,
                                   atol=1e-12)


@pytest.mark.parametrize("bounds", ["DIRICHLET", "NEUMANN", MIXED])
def test_flat_bounded_run_matches_pinc_tpu(bounds):
    deck = BOUNDED_DECK.format(bounds=bounds, layout="flat")
    jsim = JSimulation(JConfig.from_string(deck), seed=9)
    sim = Simulation(PincConfig.from_string(deck), seed=9, device="cpu")
    assert sim._periodic_dims == jsim._periodic_dims
    _energies(sim.run(progress_every=0), jsim.run(progress_every=0))
    jp, p = jsim.particles, sim.particles
    np.testing.assert_array_equal(p.alive.numpy(), np.asarray(jp.alive))
    np.testing.assert_allclose(p.pos().numpy(), np.asarray(jp.pos()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.vel.numpy(), np.asarray(jp.vel), rtol=0,
                               atol=ATOL)
    pos = p.pos().numpy()[p.alive.numpy()]
    for d, b in enumerate(bounds.split(",")[:3] if "," in bounds
                          else [bounds] * 3):
        if b != "PERIODIC":
            assert pos[:, d].min() >= 0.0 and pos[:, d].max() <= 15.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_particles(mine, ref):
    """The same live particles, each species' global positions and
    velocities compared component by component after a sort (atol ATOL):
    for runs whose slots differ."""
    for s in range(mine.alive.shape[0]):
        a, b = _np(mine.alive[s]), _np(ref.alive[s])
        assert a.sum() == b.sum()
        for x, y in ((mine.pos(), ref.pos()), (mine.vel, ref.vel)):
            np.testing.assert_allclose(np.sort(_np(x[s])[a], axis=0),
                                       np.sort(_np(y[s])[b], axis=0),
                                       rtol=0, atol=ATOL)


def _inside_walls(sim):
    lpos, _, alive = compat.tiled_state_to_numpy(sim.state)
    org = tile_origins(sim.ts).numpy()                     # (NT, D)
    live = alive > 0.5
    for d in range(3):
        g = (lpos[:, d] + org[None, :, d, None])[live]
        assert g.min() >= 0.0 and g.max() <= sim.ts.grid[d] - 1


@pytest.mark.parametrize("bounds", ["DIRICHLET", "NEUMANN"])
def test_tiled_bounded_run_matches_pinc_tpu(bounds):
    deck = (BOUNDED_DECK.format(bounds=bounds, layout="tiled")
            + "backend = pallas\nrebucket = sort\n")
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=9)
    assert not jsim._use_fused
    sim = TiledSimulation(PincConfig.from_string(deck), seed=9, device="cpu")
    assert not sim._use_fused and not sim._use_mega
    assert sim._bounded_dims == jsim._bounded_dims == (True,) * 3
    for mine, ref in zip(compat.tiled_state_to_numpy(sim.state),
                         (jsim.state.lpos, jsim.state.vel, jsim.state.alive)):
        np.testing.assert_array_equal(mine, np.asarray(ref))
    hist = sim.run(progress_every=0)
    _energies(hist, jsim.run(progress_every=0))
    assert hist["dropped"] == 0
    lpos, vel, alive = compat.tiled_state_to_numpy(sim.state)
    np.testing.assert_array_equal(alive, np.asarray(jsim.state.alive))
    np.testing.assert_allclose(lpos, np.asarray(jsim.state.lpos), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(vel, np.asarray(jsim.state.vel), rtol=0,
                               atol=ATOL)
    _inside_walls(sim)
    assert int(alive.sum()) == 2 * 4 * 16 ** 3


def test_tiled_bounded_exchange_keeps_the_walls():
    runs = {}
    for tiles in ("rebucket = sort\n", "slack = 4\n"):
        deck = BOUNDED_DECK.format(bounds="DIRICHLET", layout="tiled") + tiles
        sim = TiledSimulation(PincConfig.from_string(deck), seed=9,
                              device="cpu")
        runs[sim._rebucket_mode] = (sim, sim.run(progress_every=0))
    sim, hist = runs["exchange"]
    assert sim.ts.B == 1024 and sim._exchange_rows
    assert hist["dropped"] == 0 and hist["n_lost"] == 0
    _inside_walls(sim)
    _energies(hist, runs["sort"][1])
    mine = sim.to_particles(sim.state)
    assert int(mine.alive.sum()) == 2 * 4 * 16 ** 3
    _same_particles(mine, runs["sort"][0].to_particles(runs["sort"][0].state))


MG_PERIODIC = """
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
poisson = mgSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[multigrid]
mgLevels = 2
mgCycles = 4
nPreSmooth = 2
nPostSmooth = 2
nCoarseSolve = 4
[tiles]
tileSize = 4
margin = 2
rebucket = sort
mxuDtype = f32
"""


def _close_state(st, jst, atol=ATOL):
    lpos, vel, alive = compat.tiled_state_to_numpy(st)
    np.testing.assert_array_equal(alive, np.asarray(jst.alive))
    np.testing.assert_allclose(lpos, np.asarray(jst.lpos), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(vel, np.asarray(jst.vel), rtol=0, atol=atol)


def test_mgsolve_scan_window_matches_pinc_tpu():
    deck = MG_PERIODIC + "backend = pallas\n"
    sims = [JTiledSimulation(JConfig.from_string(deck), seed=3),
            TiledSimulation(PincConfig.from_string(deck), seed=3,
                            device="cpu")]
    for s in sims:
        assert s._use_mega
        s.rebucket_every_s, s.rebucket_every = [2, 4], 2
    jst, (jke, jpe, jdropped) = sims[0].make_scan_steps(
        8, fresh=True)(sims[0].state)
    st, (ke, pe, dropped) = sims[1].make_scan_steps(8, fresh=True)(
        sims[1].state)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jke), rtol=1e-4)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-4)
    assert int(dropped) == int(jdropped) == 0
    _close_state(st, jst)


def test_mgsolve_run_matches_pinc_tpu():
    deck = MG_PERIODIC + "backend = xla\nrebucketEvery = 2\n"
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=3)
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device="cpu")
    assert not sim._use_fused and not jsim._use_fused
    hist, jhist = sim.run(progress_every=0), jsim.run(progress_every=0)
    for key in ("kinetic", "potential"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4)
    _close_state(sim.state, jsim.state)


@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("max_vel, raises", [("1e-4", True), ("1", False)])
def test_debug_guards_match_pinc_tpu(layout, max_vel, raises):
    """methods:debug with population:maxVel: the speed guard fires at
    step 1 in both packages with a tiny bound, and a sound deck (bounded
    walls, so every position stays inside the box) runs in both."""
    deck = (BOUNDED_DECK.format(bounds="DIRICHLET", layout=layout)
            .replace("nTimeSteps = 5", "nTimeSteps = 3")
            .replace("[tiles]", "[tiles]\nrebucket = sort")
            .replace("[methods]", "[methods]\ndebug = true")
            .replace("[population]", f"[population]\nmaxVel = {max_vel}"))
    jcls = JTiledSimulation if layout == "tiled" else JSimulation
    cls = TiledSimulation if layout == "tiled" else Simulation
    jsim = jcls(JConfig.from_string(deck), seed=9)
    sim = cls(PincConfig.from_string(deck), seed=9, device="cpu")
    if raises:
        with pytest.raises(JPincError, match="step 1: particle speed"):
            jsim.run(progress_every=0)
        with pytest.raises(PincError, match="step 1: particle speed"):
            sim.run(progress_every=0)
    else:
        jsim.run(progress_every=0)
        assert len(sim.run(progress_every=0)["potential"]) == 4


def _without_output(tmp_path, name: str) -> str:
    """input/<name> copied without its files:output line."""
    deck = tmp_path / name
    deck.write_text("".join(
        line for line in (INPUT / name).open()
        if not line.strip().lower().startswith("output")))
    return str(deck)


def test_maxwellian_deck_runs_through_main(tmp_path):
    out = {}
    assert main([_without_output(tmp_path, "maxwellian.ini"),
                 "grid:nSubdomains=1,1,1", "time:nTimeSteps=5"],
                out=out, device="cpu") == 0
    sim = out["sim"]
    assert type(sim).__name__ == "Simulation"
    assert type(sim.solver).__name__ == "MultigridSolver"
    assert len(out["potential"]) == 6
    assert np.isfinite(out["kinetic"]).all()
    assert np.isfinite(out["potential"]).all()


@pytest.mark.parametrize("name", ["langmuirCold1D.ini", "langmuir2D.ini"])
def test_tiled_low_dim_decks_match_pinc_tpu(tmp_path, name):
    deck = _without_output(tmp_path, name)
    over = ["methods:layout=tiled", "time:nTimeSteps=6",
            "tiles:rebucketEvery=2"]
    jsim = JTiledSimulation(JConfig.from_file(deck, over), seed=1)
    out = {}
    assert main([deck, *over], out=out, device="cpu") == 0
    sim = out["sim"]
    assert (sim._backend, sim._rebucket_mode) == (jsim._backend,
                                                  jsim._rebucket_mode) \
        == ("xla", "sort")
    assert sim.ts == type(sim.ts)(grid=jsim.ts.grid, T=jsim.ts.T,
                                  M=jsim.ts.M, B=jsim.ts.B)
    hist, jhist = out, jsim.run(progress_every=0)
    np.testing.assert_allclose(hist["kinetic"], jhist["kinetic"], rtol=1e-3)
    pe = np.asarray(jhist["potential"])
    np.testing.assert_allclose(hist["potential"], pe, rtol=0,
                               atol=1e-3 * np.abs(pe).max())
    assert hist["dropped"] == 0 and hist["n_lost"] == 0
    _same_particles(sim.to_particles(sim.state),
                    jsim.to_particles(jsim.state))


@pytest.mark.parametrize("key, value", [("backend", "pallas"),
                                        ("rebucket", "exchange")])
def test_low_dim_tiled_decks_refuse_the_3d_kernels(key, value):
    deck = str(INPUT / "langmuir2D.ini")
    cfg = PincConfig.from_file(deck, ["methods:layout=tiled",
                                      f"tiles:{key}={value}"])
    with pytest.raises(ValueError, match="3-D deck"):
        TiledSimulation(cfg, device="cpu")
