"""pinc_tpu_torch's checkpoints (checkpoint.py and the resume branches of
Simulation.run and TiledSimulation.run) against pinc_tpu's.

* A flat resume (tests/test_torch_slice.py's flat deck, 10 steps, then a
  resume to 20) gives the uninterrupted 20-step run's particles bit for
  bit: the checkpoint holds the state verbatim and the CPU runs the same
  operations.
* A tiled resume on the CPU (the kernels' plain versions; the slice's
  tiled deck, 5 + 5 steps) is bit-identical to the uninterrupted run,
  also where a margin hit retuned the re-bucket cadences before the
  checkpoint (the cadences travel in the file's tuning:* attributes).
* A tiled checkpoint refuses the flat layout; a resume without a
  checkpoint warns and starts fresh.
* The file is pinc_tpu's (attributes step, format_version, layout; the
  same datasets and dtypes), so each package resumes the other's: a
  pinc_tpu checkpoint, flat and tiled, continues in the port within the
  slice's f32 tolerance of pinc_tpu's own continuation, and the port's in
  pinc_tpu.  Tolerances (tests/test_torch_slice.py's): energies rtol 1e-5;
  flat positions and velocities, and tiled lpos and vel, atol 1e-5; alive
  exactly.  The tiled decks run tiles:backend = xla in both packages.
"""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu_torch import checkpoint
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.tiled_sim import TiledSimulation

FLAT = """
[files]
output = {out}
checkpointEvery = {ck}
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
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
layout = flat
"""

TILED = """
[files]
output = {out}
checkpointEvery = {ck}
[time]
nTimeSteps = {steps}
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
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
layout = tiled
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[tiles]
tileSize = 4
margin = 2
rebucketEvery = 2
rebucket = sort
"""
XLA = "backend = xla\n"
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, deck, out, steps, ck=0, resume=False, extra=""):
    cfg = cls.from_string(deck.format(out=out, steps=steps, ck=ck) + extra)
    if resume:
        cfg.set_str("time:resume", "true")
    return cfg


def _flat_state(sim):
    p = sim.particles
    return [np.asarray(x.numpy() if hasattr(x, "numpy") else x)
            for x in (p.pos(), p.vel, p.alive)]


def _tiled_state(sim):
    return [np.asarray(getattr(sim.state, k)) for k in ("lpos", "vel",
                                                        "alive")]


def test_flat_resume_continues_the_trajectory(tmp_path):
    full = Simulation(_cfg(PincConfig, FLAT, f"{tmp_path}/full", 20),
                      device="cpu")
    h_full = full.run(progress_every=0)
    part = f"{tmp_path}/part"
    Simulation(_cfg(PincConfig, FLAT, part, 10, ck=5),
               device="cpu").run(progress_every=0)
    sim = Simulation(_cfg(PincConfig, FLAT, part, 20, ck=5, resume=True),
                     device="cpu")
    assert sim._resumed and sim.start_step == 10
    hist = sim.run(progress_every=0)
    assert hist["kinetic"].shape == (10, 2)          # steps 11..20, no re-kick
    np.testing.assert_array_equal(hist["kinetic"], h_full["kinetic"][11:])
    for a, b in zip(_flat_state(sim), _flat_state(full)):
        np.testing.assert_array_equal(a, b)
    with h5py.File(checkpoint.checkpoint_path(sim.cfg), "r") as f:
        assert f.attrs["step"] == 20 and f.attrs["format_version"] == 1


def test_tiled_resume_is_bitwise(tmp_path):
    """The port's default route (the kernels' plain versions on the CPU):
    5 steps, a checkpoint, a resume to 10 == 10 uninterrupted steps."""
    full = TiledSimulation(_cfg(PincConfig, TILED, f"{tmp_path}/full", 10),
                           seed=3, device="cpu")
    full.run(progress_every=0)
    part = f"{tmp_path}/part"
    TiledSimulation(_cfg(PincConfig, TILED, part, 5, ck=5), seed=3,
                    device="cpu").run(progress_every=0)
    sim = TiledSimulation(_cfg(PincConfig, TILED, part, 10, ck=5,
                               resume=True), seed=3, device="cpu")
    assert sim._resumed and sim.start_step == 5
    hist = sim.run(progress_every=0)
    assert hist["kinetic"].shape == (5, 2)
    for a, b in zip(_tiled_state(sim), _tiled_state(full)):
        np.testing.assert_array_equal(a, b)


def test_tiled_resume_after_retune_is_bitwise(tmp_path):
    """tiles:rebucketEvery = 8 lets a particle reach the margin at step 6
    and retune() sets the cadences to [4, 40]; a checkpoint at step 7
    keeps them, and the resume to 14 re-buckets at steps 8 and 12 as the
    uninterrupted run does (on the deck's 8 it would re-bucket the ions
    at step 8)."""
    extra = "rebucketEvery = 8\n"
    full = TiledSimulation(_cfg(PincConfig, TILED, f"{tmp_path}/full", 14,
                                extra=extra), seed=3, device="cpu")
    h_full = full.run(progress_every=0)
    assert h_full["n_lost"] > 0 and full.rebucket_every_s == [4, 40]
    part = f"{tmp_path}/part"
    TiledSimulation(_cfg(PincConfig, TILED, part, 7, ck=7, extra=extra),
                    seed=3, device="cpu").run(progress_every=0)
    with h5py.File(checkpoint.checkpoint_path(
            _cfg(PincConfig, TILED, part, 7)), "r") as f:
        assert list(f.attrs["tuning:rebucket_every_s"]) == [4, 40]
    sim = TiledSimulation(_cfg(PincConfig, TILED, part, 14, ck=7,
                               resume=True, extra=extra), seed=3,
                          device="cpu")
    assert sim._resumed and sim.start_step == 7
    assert sim.tuning() == full.tuning()
    hist = sim.run(progress_every=0)
    np.testing.assert_array_equal(hist["kinetic"], h_full["kinetic"][8:])
    for a, b in zip(_tiled_state(sim), _tiled_state(full)):
        np.testing.assert_array_equal(a, b)


def test_layout_mismatch_raises(tmp_path):
    out = f"{tmp_path}/m"
    TiledSimulation(_cfg(PincConfig, TILED, out, 2, ck=2), seed=1,
                    device="cpu").run(progress_every=0)
    with pytest.raises(ValueError, match="methods:layout=tiled"):
        Simulation(_cfg(PincConfig, FLAT, out, 4, resume=True),
                   device="cpu")
    with pytest.raises(ValueError, match="'tiled'-layout"):
        checkpoint.load(_cfg(PincConfig, FLAT, out, 4))
    cfg = _cfg(PincConfig, TILED, out, 4, resume=True,
               extra="slack = 2.0\n")             # another bucket size
    with pytest.raises(ValueError, match="deck-derived"):
        TiledSimulation(cfg, seed=1, device="cpu")


def test_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    sim = Simulation(_cfg(PincConfig, FLAT, f"{tmp_path}/none", 3,
                          resume=True), device="cpu")
    assert "no checkpoint found; starting fresh" in capsys.readouterr().err
    assert not sim._resumed and sim.start_step == 0
    assert sim.run(progress_every=0)["kinetic"].shape == (4, 2)


def _datasets(path):
    with h5py.File(path, "r") as f:
        return dict(f.attrs), {k: (f[k].shape, f[k].dtype) for k in f}


def _flat_pair(tmp_path, first):
    """(the package that wrote the step-10 checkpoint, the other) as sims
    resumed to step 20, and the writer's own continuation."""
    out = f"{tmp_path}/{first}"
    classes = {"jax": (JConfig, lambda c: JSimulation(c)),
               "torch": (PincConfig, lambda c: Simulation(c, device="cpu"))}
    other = "torch" if first == "jax" else "jax"
    cfg_cls, make = classes[first]
    make(_cfg(cfg_cls, FLAT, out, 10, ck=10)).run(progress_every=0)
    layout = _datasets(checkpoint.checkpoint_path(
        _cfg(PincConfig, FLAT, out, 10)))
    runs = {}
    for name in (first, other):
        cfg_cls, make = classes[name]
        sim = make(_cfg(cfg_cls, FLAT, out, 20, resume=True))
        assert sim._resumed and sim.start_step == 10
        runs[name] = (sim.run(progress_every=0), _flat_state(sim))
    return runs, layout


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_flat_checkpoint_crosses_packages(tmp_path, first):
    runs, (attrs, sets) = _flat_pair(tmp_path, first)
    assert attrs["step"] == 10 and attrs["format_version"] == 1
    assert "layout" not in attrs
    assert {k: str(d) for k, (_, d) in sets.items()} == {
        "cell": "int32", "frac": "float32", "vel": "float32",
        "alive": "bool"}
    (h_j, s_j), (h_t, s_t) = runs["jax"], runs["torch"]
    np.testing.assert_allclose(h_t["kinetic"], h_j["kinetic"], rtol=RTOL)
    np.testing.assert_allclose(h_t["potential"], h_j["potential"], rtol=RTOL)
    for a, b in zip(s_t[:2], s_j[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(s_t[2], s_j[2])


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_tiled_checkpoint_crosses_packages(tmp_path, first):
    """tiles:backend = xla in both: 4 steps and a tiled checkpoint by one
    package, then each resumes it to 8."""
    out = f"{tmp_path}/{first}"
    make = {"jax": lambda c: JTiledSimulation(c, seed=3),
            "torch": lambda c: TiledSimulation(c, seed=3, device="cpu")}
    cls = {"jax": JConfig, "torch": PincConfig}
    make[first](_cfg(cls[first], TILED, out, 4, ck=4, extra=XLA)).run(
        progress_every=0)
    attrs, sets = _datasets(checkpoint.checkpoint_path(
        _cfg(PincConfig, TILED, out, 4)))
    assert attrs["step"] == 4 and attrs["layout"] == "tiled"
    assert {k: (len(s), str(d)) for k, (s, d) in sets.items()} == {
        "lpos": (4, "float32"), "vel": (4, "float32"),
        "alive": (3, "float32")}
    runs = {}
    for name in ("jax", "torch"):
        sim = make[name](_cfg(cls[name], TILED, out, 8, resume=True,
                              extra=XLA))
        assert sim._resumed and sim.start_step == 4
        runs[name] = (sim.run(progress_every=0), _tiled_state(sim))
    (h_j, s_j), (h_t, s_t) = runs["jax"], runs["torch"]
    assert h_t["kinetic"].shape == h_j["kinetic"].shape == (4, 2)
    np.testing.assert_allclose(h_t["kinetic"], h_j["kinetic"], rtol=RTOL)
    np.testing.assert_allclose(h_t["potential"], h_j["potential"], rtol=RTOL)
    for a, b in zip(s_t[:2], s_j[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(s_t[2], s_j[2])
