"""The slice as a whole: pinc_tpu_torch's TiledSimulation.run() against
pinc_tpu's, on tests/test_tiled.py's deck with rebucketEvery=2 and
nTimeSteps=6, re-bucketed by the sort (tiles:rebucket=sort) and by the
default gather exchange (with slack 2.0, so that B = 1024 and the per-row
gate holds).  The JAX side runs its fused step (tiles:backend=pallas) with
the Pallas kernels in interpret mode; the port runs the kernels' plain
versions on the CPU.  Both start from the same host initial conditions, so
the tiled states compare slot for slot.

Tolerances: energies rtol 1e-5 and the final lpos/vel atol 1e-5 with f32
weights (float32 sums in another order); with bf16 weights rtol 1e-4 on
the energies and atol 1e-4 on the state, since an f32 round-off can flip
a bf16 weight rounding (2^-9 relative).  alive matches exactly.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pinc_tpu.__main__ import main as jmain
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.registry import RUN_MODES as JRUN_MODES
from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu.ops import pallas_gather_exchange as pgx
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu.tiled_sim import TiledState as JTiledState
from pinc_tpu_torch import compat
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox
from pinc_tpu_torch.simulation import Simulation
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
rebucketEvery = 2
rebucket = sort
backend = pallas
"""

TOL = {"f32": (1e-5, 1e-5), "bf16": (1e-4, 1e-4)}   # (energy rtol, state atol)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deck(mxu):
    return DECK + f"mxuDtype = {mxu}\n"


@pytest.fixture(scope="module")
def jax_runs():
    """pinc_tpu's TiledSimulation.run() per weight dtype, with its initial
    tiled state kept as numpy arrays."""
    out = {}
    for mxu in TOL:
        sim = JTiledSimulation(JConfig.from_string(_deck(mxu)), seed=3)
        assert sim._use_fused and sim._rebucket_mode == "sort"
        init = tuple(np.array(getattr(sim.state, k))
                     for k in ("lpos", "vel", "alive"))
        hist = sim.run(progress_every=0)
        final = tuple(np.asarray(getattr(sim.state, k))
                      for k in ("lpos", "vel", "alive"))
        out[mxu] = dict(init=init, hist=hist, final=final)
    return out


def _compare(ref, hist, sim, mxu):
    rtol, atol = TOL[mxu]
    np.testing.assert_allclose(hist["kinetic"], ref["hist"]["kinetic"],
                               rtol=rtol)
    np.testing.assert_allclose(hist["potential"], ref["hist"]["potential"],
                               rtol=rtol)
    lpos, vel, alive = compat.tiled_state_to_numpy(sim.state)
    np.testing.assert_array_equal(alive, ref["final"][2])
    np.testing.assert_allclose(lpos, ref["final"][0], rtol=0, atol=atol)
    np.testing.assert_allclose(vel, ref["final"][1], rtol=0, atol=atol)
    assert hist["dropped"] == 0 and hist["n_lost"] == 0
    assert alive.sum() == 2 * 8 * 16 ** 3
    assert sim.particles.counts().tolist() == [8 * 16 ** 3] * 2
    assert int(sim._out_of_margin(sim.state)) == 0


@pytest.mark.parametrize("mxu", list(TOL))
def test_tiled_run_matches_pinc_tpu(jax_runs, mxu):
    sim = TiledSimulation(PincConfig.from_string(_deck(mxu)), seed=3,
                          device="cpu")
    ref = jax_runs[mxu]
    for mine, theirs in zip(compat.tiled_state_to_numpy(sim.state),
                            ref["init"]):
        np.testing.assert_array_equal(mine, theirs)     # bucketing, slot for slot
    _compare(ref, sim.run(progress_every=0), sim, mxu)


def test_tiled_run_from_pinc_tpu_state(jax_runs):
    """The port started from pinc_tpu's own initial tiled state."""
    ref = jax_runs["f32"]
    sim = TiledSimulation(PincConfig.from_string(_deck("f32")), seed=3,
                          device="cpu")
    sim.state = compat.tiled_state_from_numpy(*ref["init"], device="cpu")
    _compare(ref, sim.run(progress_every=0), sim, "f32")


def test_tiled_boris_eext_run_matches_pinc_tpu():
    """puBoris3D1KE with a magnetic and an external electric field: the
    half kick's and the fused kick's Boris rotation and e_ext against
    pinc_tpu's, at the f32 tolerances."""
    deck = (_deck("f32").replace("acc = puAcc3D1KE", "acc = puBoris3D1KE")
            .replace("nTimeSteps = 6", "nTimeSteps = 4")
            + "[fields]\nBExt = 0.02,-0.01,0.05\nEExt = 0.01,0,-0.005\n")
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=3)
    assert jsim._use_fused and jsim._acc_boris
    ref = dict(hist=jsim.run(progress_every=0),
               final=tuple(np.asarray(getattr(jsim.state, k))
                           for k in ("lpos", "vel", "alive")))
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device="cpu")
    assert sim._acc_boris
    np.testing.assert_allclose(sim._e_ext, (0.01, 0.0, -0.005), rtol=1e-6)
    _compare(ref, sim.run(progress_every=0), sim, "f32")


FLAT = DECK.replace("layout = tiled", "layout = flat").replace(
    "8 pc", "4 pc")


def _exchange_deck(knobs: str) -> str:
    return DECK.replace("rebucket = sort\n", knobs) + "mxuDtype = f32\n"


EXCHANGE = _exchange_deck("slack = 2.0\n")


def _spy(monkeypatch, module, name):
    """Count the calls of module.name."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


# the exchange decks: (knobs, B, row gate, the driver both packages take);
# the gather needs B % 1024 == 0, the one-hot rows need the row gate
EXCHANGE_DECKS = {
    "gather": ("slack = 2.0\n", 1024, True, "rebucket_exchange_all_rows_g"),
    "onehot_v3": ("slack = 1.25\n", 640, False, "exchange_dim"),
    "onehot_v5": ("slack = 2.25\n", 1152, True, "rebucket_exchange_all_rows"),
    "onehot_v4": ("slack = 2.25\nexchangeFused = false\n", 1152, True,
                  "exchange_dim"),
}
DRIVERS = {"rebucket_exchange_all_rows_g": (pgx, gx),
           "exchange_dim_g": (pgx, gx),
           "rebucket_exchange_all_rows": (pex, ox),
           "exchange_dim": (pex, ox)}


@pytest.mark.parametrize("deck", list(EXCHANGE_DECKS))
def test_tiled_exchange_run_matches_pinc_tpu(monkeypatch, deck):
    """The exchange re-bucket on both sides, on a deck per route: the
    gather exchange (B = 1024) and pinc_tpu's one-hot exchange (B % 1024
    != 0): the per-tile sweeps (the row gate false), the fused row exchange
    and the per-row sweeps.  Each package takes the same driver; energies,
    the final state, alive and the drop count agree."""
    knobs, B, rows, driver = EXCHANGE_DECKS[deck]
    text = _exchange_deck(knobs)
    jsim = JTiledSimulation(JConfig.from_string(text), seed=3)
    assert jsim._rebucket_mode == "exchange" and jsim._exchange_rows == rows
    assert jsim.ts.B == B and jsim._use_fused
    jcalls = _spy(monkeypatch, pex, "rebucket_exchange_planes")
    jdrv = {n: _spy(monkeypatch, m[0], n) for n, m in DRIVERS.items()}
    # jsim._rebucket inlines both species' exchanges into one compile; the
    # same calls, with one species' exchange compiled once and reused
    one = jax.jit(jsim._rebucket_one)

    def rebucket(st, species):
        lpos, vel, alive = st.lpos, st.vel, st.alive
        dropped = 0
        for s in species:
            lp, lv, la, d_n = one(lpos[s], vel[s], alive[s])
            lpos, vel = lpos.at[s].set(lp), vel.at[s].set(lv)
            alive = alive.at[s].set(la)
            dropped = dropped + d_n
        return JTiledState(lpos=lpos, vel=vel, alive=alive), dropped
    jsim._rebucket_jit = rebucket
    ref = dict(hist=jsim.run(progress_every=0),
               final=tuple(np.asarray(getattr(jsim.state, k))
                           for k in ("lpos", "vel", "alive")))
    assert jcalls
    assert {n for n, c in jdrv.items() if c} == {driver}
    calls = _spy(monkeypatch, ex, "rebucket_exchange_planes")
    tdrv = {n: _spy(monkeypatch, m[1], n) for n, m in DRIVERS.items()}
    sim = TiledSimulation(PincConfig.from_string(text), seed=3, device="cpu")
    assert sim._rebucket_mode == "exchange" and sim._exchange_rows == rows
    assert sim.ts.B == B
    hist = sim.run(progress_every=0)
    assert len(calls) == 2 * 3          # 2 species x steps 2, 4, 6
    assert {n for n, c in tdrv.items() if c} == {driver}
    _compare(ref, hist, sim, "f32")


def test_flat_run_matches_pinc_tpu():
    """The flat layout, started from pinc_tpu's particles through
    compat.particles_from_numpy (identical to the port's own host ICs)."""
    jsim = JSimulation(JConfig.from_string(FLAT), seed=3)
    init = [np.array(getattr(jsim.particles, k))
            for k in ("cell", "frac", "vel", "alive")]
    h_ref = jsim.run(progress_every=0)
    sim = Simulation(PincConfig.from_string(FLAT), seed=3, device="cpu")
    for k, a in zip(("cell", "frac", "vel", "alive"), init):
        np.testing.assert_array_equal(getattr(sim.particles, k).numpy(), a)
    sim.particles = compat.particles_from_numpy(*init, device="cpu")
    hist = sim.run(progress_every=0)
    np.testing.assert_allclose(hist["kinetic"], h_ref["kinetic"], rtol=1e-5)
    np.testing.assert_allclose(hist["potential"], h_ref["potential"],
                               rtol=1e-5)


FLAT_METHODS = {
    "spectralFD": [("poisson = sSolve", "poisson = spectralFD")],
    "puAccND0KE_puDistrND0": [("acc = puAcc3D1KE", "acc = puAccND0KE"),
                              ("distr = puDistr3D1", "distr = puDistrND0")],
    "puAccND0_puDistrND0": [("acc = puAcc3D1KE", "acc = puAccND0"),
                            ("distr = puDistr3D1", "distr = puDistrND0")],
    "puDistr3D1split": [("distr = puDistr3D1", "distr = puDistr3D1split")],
    "sweepChunk": [("[methods]", "sweepChunk = 1000\n[methods]")],
}


@pytest.mark.parametrize("case", list(FLAT_METHODS))
def test_flat_methods_match_pinc_tpu(case):
    """The registered flat methods no other test holds against pinc_tpu
    (spectralFD, the NGP accelerators and distributor, the split deposit,
    population:sweepChunk's chunked sweeps), run() on the flat deck (16^3,
    6 steps, seed 5): KE within 4e-7 and PE within 8e-6 of their maxima
    (exact where a method computes no KE)."""
    deck = FLAT
    for old, new in FLAT_METHODS[case]:
        assert old in deck
        deck = deck.replace(old, new, 1)
    ref = JSimulation(JConfig.from_string(deck), seed=5).run(
        progress_every=0)
    hist = Simulation(PincConfig.from_string(deck), seed=5,
                      device="cpu").run(progress_every=0)
    for key, tol in (("kinetic", 4e-7), ("potential", 8e-6)):
        want, got = np.asarray(ref[key]), np.asarray(hist[key])
        scale = np.abs(want).max()
        if scale == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= tol * scale, (key, got, want)


def test_smode_and_msgfiles_match_pinc_tpu(tmp_path, monkeypatch):
    """sMode (one spectral solve of the sin fixture) and the [msgfiles]
    parse dump, through both CLIs."""
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32") + "[msgfiles]\nparsedump = dump.txt\n")
    monkeypatch.chdir(tmp_path)
    args = [str(deck), "methods:mode=sMode"]
    out = {}
    assert main(args, out=out, device="cpu") == 0
    mine = (tmp_path / "dump.txt").read_text()
    assert jmain(args) == 0                 # rewrites dump.txt
    assert (tmp_path / "dump.txt").read_text() == mine
    jout = JRUN_MODES.select(JConfig.from_file(deck, args[1:]),
                             "methods:mode")()
    np.testing.assert_allclose(out["phi"], jout["phi"], rtol=0,
                               atol=1e-5 * np.abs(jout["phi"]).max())
    assert out["rms_error"] < 1e-5 * np.abs(out["phi_exact"]).max()


def test_cli_runs_the_tiled_slice(tmp_path):
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32"))
    out = {}
    assert main([str(deck), "time:nTimeSteps=2"], out=out,
                device="cpu") == 0
    assert isinstance(out["sim"], TiledSimulation)
    assert out["sim"].state.lpos.device.type == "cpu"
    assert out["kinetic"].shape == (3, 2)
    assert main([str(deck), "getnp"]) == 0


@pytest.mark.parametrize("slack, rows, driver", [
    (1.25, False, "exchange_dim"), (2.25, True, "rebucket_exchange_all_rows")],
    ids=["row_gate_false", "row_gate_true"])
def test_cli_runs_onehot_decks(tmp_path, monkeypatch, slack, rows, driver):
    """The CLI on the slice deck with the default exchange and B % 1024 !=
    0 (B = 640 or 1152): pinc_tpu's one-hot exchange, no sort needed."""
    deck = tmp_path / "deck.ini"
    deck.write_text(_exchange_deck(f"slack = {slack}\n"))
    drivers = {n: _spy(monkeypatch, m[1], n) for n, m in DRIVERS.items()}
    out = {}
    assert main([str(deck), "time:nTimeSteps=2"], out=out,
                device="cpu") == 0
    sim = out["sim"]
    assert sim.ts.B % 1024 and sim._exchange_rows == rows
    assert {n for n, c in drivers.items() if c} == {driver}
    assert out["dropped"] == 0
    assert int(sim.state.alive.sum()) == 2 * 8 * 16 ** 3


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without a card, a run that does not pass device="cpu" raises before
    it starts; getnp needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main([str(deck), "time:nTimeSteps=2"], out={})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TiledSimulation(PincConfig.from_string(_deck("f32")), seed=3)
    assert main([str(deck), "getnp"]) == 0


@pytest.mark.parametrize("override, cls", [
    ("grid:nSubdomains=2,1,1", "ShardedTiledSimulation"),
])
def test_decomposed_object_deck_runs(tmp_path, override, cls):
    """An object deck over more than one subdomain runs through the CLI
    (the sharded object branches; the sharded tiled path re-buckets by
    the exchange only)."""
    pytest.importorskip("h5py")
    from pinc_tpu_torch.objects import make_sphere, save_domain
    grid = tmp_path / "sphere.grid.h5"
    save_domain(str(grid), make_sphere((32, 16, 16), (16, 8, 8), 2.5))
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32") + f"[objects]\nobjects = {grid}\n")
    out = {}
    assert main([str(deck), override, "tiles:rebucket=exchange",
                 "time:nTimeSteps=2"], out=out, device="cpu") == 0
    sim = out["sim"]
    assert type(sim).__name__ == cls and sim.objects is not None
    assert np.isfinite(out["kinetic"]).all()
    assert np.isfinite(out["potential"]).all()
    assert np.isfinite(sim.last_obj_potential).all()


@pytest.mark.parametrize("overrides, result", [
    (["methods:mode=puModeInterp"], "order_cic"),
    (["grid:boundaries=DIRICHLET", "methods:poisson=mgSolve"], "kinetic"),
    (["grid:boundaries=NEUMANN", "grid:bndValues=0,0,0,0,0,0",
      "methods:poisson=mgSolve"], "kinetic"),
    (["methods:poisson=mgSolve"], "kinetic"),
    (["methods:debug=true", "population:maxVel=1"], "kinetic"),
    (["methods:mode=mgMode", "methods:poisson=mgSolve"], "cycles"),
    (["objects:objects={sphere}"], "kinetic"),
])
def test_ported_features_run(tmp_path, overrides, result):
    """The deck features test_unported_features_raise pinned before bc.py,
    the multigrid solver, the debug guards, the run modes and the embedded
    objects (objects.py; a sphere grid written by the port's save_domain)
    were ported now run on the CPU."""
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32"))
    if any("{sphere}" in o for o in overrides):
        pytest.importorskip("h5py")
        from pinc_tpu_torch.objects import make_sphere, save_domain
        sphere = str(tmp_path / "sphere.grid.h5")
        save_domain(sphere, make_sphere((16,) * 3, (8, 8, 8), 2.5))
        overrides = [o.format(sphere=sphere) for o in overrides]
    out = {}
    assert main([str(deck), *overrides, "time:nTimeSteps=2"], out=out,
                device="cpu") == 0
    assert result in out
    if result == "kinetic":
        assert np.isfinite(out["kinetic"]).all() and out["dropped"] == 0


@pytest.mark.parametrize("override, written", [
    ("files:output=out/run", "out/run_history.xy.h5"),
    ("files:checkpointEvery=2", "checkpoint.chk.h5"),
])
def test_output_and_checkpoint_keys_run(tmp_path, monkeypatch, override,
                                        written):
    """files:output and files:checkpointEvery, which the port refused
    before io_h5.py and checkpoint.py were ported, now run and write."""
    pytest.importorskip("h5py")
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("f32"))
    monkeypatch.chdir(tmp_path)
    assert main([str(deck), override, "time:nTimeSteps=2"],
                device="cpu") == 0
    assert (tmp_path / written).exists()


def test_no_jax_import():
    code = textwrap.dedent("""
        import sys
        import pinc_tpu_torch, pinc_tpu_torch.__main__, pinc_tpu_torch.compat
        import pinc_tpu_torch.tiled_sim, pinc_tpu_torch.parallel.pic
        import pinc_tpu_torch.ops.tiled_kernels, pinc_tpu_torch.ops._cuda_build
        import pinc_tpu_torch.ops.gather_exchange, pinc_tpu_torch.ops.exchange
        import pinc_tpu_torch.ops.onehot_exchange
        import pinc_tpu_torch.ops.field_kernels
        import pinc_tpu_torch.utils.timer
        import pinc_tpu_torch.io_h5, pinc_tpu_torch.spool
        import pinc_tpu_torch.checkpoint, pinc_tpu_torch.native
        import pinc_tpu_torch.bc, pinc_tpu_torch.solvers.multigrid
        import pinc_tpu_torch.pumodes, pinc_tpu_torch.objects
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pinc_tpu")]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
