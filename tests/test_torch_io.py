"""pinc_tpu_torch's HDF5 output (io_h5.py, spool.py) against pinc_tpu's.

Both packages run the same deck from the same host initial conditions and
write through their own OutputWriter; the files must hold the same names,
dataset shapes, dtypes and attributes, and values within the tolerance of
the run they come from:

* the flat 2-D deck of tests/test_io.py (3 steps, seed 1), the flat slice's
  tolerance (tests/test_torch_slice.py): every grid, position and velocity
  dataset within 1e-5 of its largest magnitude (float32 sums in another
  order), the energy history rtol 1e-5;
* a 3-D tiled deck, tests/test_torch_slice.py's fixture on
  tiles:backend = xla in both packages (2 steps, seed 3), its f32
  tolerance: positions and velocities atol 1e-5, the energy history rtol
  1e-5, and the grids within 1e-5 of their largest magnitude or 1e-6,
  whichever is larger: the two species' densities are O(1) and cancel to
  ~2e-4 at step 0, so rho's float32 round-off (a few ulp of the species'
  sums, ~5e-8) is large against rho itself, and phi and E inherit it.
  Population rows are compared row for row: both packages write the live
  slots in slot order.

Within the port: a grid round trip, an xy append, files:async = true
against false (the same bits), and script/plot/reader.py reading both
packages' files.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.io_h5 import OutputWriter as JOutputWriter
from pinc_tpu.io_h5 import h5_path as jh5_path
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.io_h5 import GridFile, OutputWriter, XYFile, h5_path
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.tiled_sim import TiledSimulation

ROOT = Path(__file__).resolve().parents[1]

FLAT_DECK = """
[files]
output = {out}
[time]
nTimeSteps = 3
timeStep = 0.2
[grid]
nDims = 2
nSubdomains = 1,1
trueSize = 16,8
stepSize = 6.28 tot
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
temperature = 0
perturbAmplitude = 0.001,0,0,0
perturbMode = 1,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAccND1KE
distr = puDistrND1
migrate = puExtractEmigrantsND
"""

TILED_DECK = """
[files]
output = {out}
[time]
nTimeSteps = 2
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
backend = xla
"""

FILES = ("rho.grid.h5", "phi.grid.h5", "E.grid.h5", "pop.pop.h5",
         "history.xy.h5")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def datasets(path: Path) -> dict:
    """{dataset name: array} and {"@attr": value} of one HDF5 file."""
    with h5py.File(path, "r") as f:
        out = {f"@{k}": v for k, v in f.attrs.items()}
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def compare_files(mine: Path, theirs: Path, field_rtol: float,
                  particle_atol=None, energy_rtol: float = 1e-5,
                  grid_atol: float = 0.0) -> None:
    """The five output files of two runs: the same names, shapes, dtypes
    and attributes; grids (and, without particle_atol, particles) within
    field_rtol of their largest magnitude (grids: or grid_atol, whichever
    is larger), particles within particle_atol, the energy history within
    energy_rtol."""
    for name in FILES:
        a, b = datasets(mine / name), datasets(theirs / name)
        assert sorted(a) == sorted(b), name
        for key, want in b.items():
            got = a[key]
            if key.startswith("@"):
                assert got == want and type(got) is type(want), (name, key)
                continue
            assert got.shape == want.shape and got.dtype == want.dtype, \
                (name, key)
            if name == "history.xy.h5":
                np.testing.assert_array_equal(got[:, 0], want[:, 0])
                np.testing.assert_allclose(got[:, 1], want[:, 1],
                                           rtol=energy_rtol, atol=1e-30)
            elif name == "pop.pop.h5" and particle_atol is not None:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=particle_atol)
            else:
                floor = grid_atol if name.endswith("grid.h5") else 0.0
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=max(field_rtol * np.abs(want).max(), floor, 1e-30))


def run_flat(out: Path, port: bool, extra: str = "") -> None:
    text = FLAT_DECK.format(out=f"{out}/") + extra
    if port:
        cfg = PincConfig.from_string(text)
        sim = Simulation(cfg, device="cpu")
        writer = OutputWriter(cfg, sim)
    else:
        cfg = JConfig.from_string(text)
        sim = JSimulation(cfg)
        writer = JOutputWriter(cfg, sim)
    try:
        sim.run(writer=writer, progress_every=0)
    finally:
        writer.close()


@pytest.fixture(scope="module")
def flat_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flat")
    run_flat(root / "jax", port=False)
    run_flat(root / "torch", port=True)
    return root


@pytest.mark.parametrize("prefix", [".", "dir/", "pre"])
def test_h5_path_matches_pinc_tpu(prefix):
    text = f"[files]\noutput = {prefix}\n"
    for name, kind in (("rho", "grid"), ("pop", "pop"), ("history", "xy"),
                       ("checkpoint", "chk")):
        assert (h5_path(PincConfig.from_string(text), name, kind)
                == jh5_path(JConfig.from_string(text), name, kind))


def test_flat_output_matches_pinc_tpu(flat_runs):
    compare_files(flat_runs / "torch", flat_runs / "jax", field_rtol=1e-5)
    with h5py.File(flat_runs / "torch" / "rho.grid.h5", "r") as f:
        assert sorted(f) == ["n=0.0", "n=1.0", "n=2.0", "n=3.0"]
        assert f["n=1.0"].shape == (8, 16, 1)
    with h5py.File(flat_runs / "torch" / "pop.pop.h5", "r") as f:
        assert f["pos/specie 0/n=1.0"].shape == (4 * 16 * 8, 2)
        assert "vel/specie 1/n=0.5" in f
    with h5py.File(flat_runs / "torch" / "history.xy.h5", "r") as f:
        assert f["energy/kinetic/total"].shape == (4, 2)


def test_tiled_output_matches_pinc_tpu(tmp_path):
    """The tiled run's writer (the StepOutput built on written steps only,
    E the global -grad(phi)) against pinc_tpu's tiled run."""
    text = TILED_DECK.format(out=f"{tmp_path}/torch/")
    cfg = PincConfig.from_string(text)
    sim = TiledSimulation(cfg, seed=3, device="cpu")
    writer = OutputWriter(cfg, sim)
    sim.run(writer=writer, progress_every=0)
    writer.close()
    jtext = TILED_DECK.format(out=f"{tmp_path}/jax/")
    jcfg = JConfig.from_string(jtext)
    jsim = JTiledSimulation(jcfg, seed=3)
    jwriter = JOutputWriter(jcfg, jsim)
    jsim.run(writer=jwriter, progress_every=0)
    jwriter.close()
    compare_files(tmp_path / "torch", tmp_path / "jax", field_rtol=1e-5,
                  particle_atol=1e-5, grid_atol=1e-6)
    with h5py.File(tmp_path / "torch" / "E.grid.h5", "r") as f:
        assert f["n=2.0"].shape == (16, 16, 16, 3)
    with h5py.File(tmp_path / "torch" / "pop.pop.h5", "r") as f:
        assert f["pos/specie 1/n=2.0"].shape == (8 * 16 ** 3, 3)


def test_tiled_run_converts_particles_on_written_steps_only(tmp_path,
                                                            monkeypatch):
    """files:writeFrequency = 2 over 3 steps writes steps 0 and 2; with
    files:writePop = false no step converts the tiled state to particles
    (run() converts once at its end)."""
    text = TILED_DECK.format(out=f"{tmp_path}/").replace(
        "nTimeSteps = 2", "nTimeSteps = 3")
    calls = []
    orig = TiledSimulation.to_particles
    monkeypatch.setattr(TiledSimulation, "to_particles",
                        lambda self, st: calls.append(1) or orig(self, st))
    for pop, want in (("true", 2), ("false", 0)):
        cfg = PincConfig.from_string(
            text + f"[files]\nwriteFrequency = 2\nwritePop = {pop}\n")
        sim = TiledSimulation(cfg, seed=3, device="cpu")
        writer = OutputWriter(cfg, sim)
        del calls[:]
        sim.run(writer=writer, progress_every=0)
        writer.close()
        assert len(calls) == want + 1            # + the run's final one
        with h5py.File(tmp_path / "rho.grid.h5", "r") as f:
            assert sorted(f) == ["n=0.0", "n=2.0"]
        with h5py.File(tmp_path / "history.xy.h5", "r") as f:
            assert f["energy/kinetic/total"].shape == (4, 2)
        (tmp_path / "history.xy.h5").unlink()
        (tmp_path / "rho.grid.h5").unlink()


def test_grid_roundtrip(tmp_path):
    cfg = PincConfig.from_string(f"[files]\noutput = {tmp_path}/rt/\n")
    g = GridFile(cfg, "phi", n_dims=3)
    arr = np.random.default_rng(0).normal(size=(4, 5, 6)).astype(np.float32)
    g.write(7, arr)
    back = g.read(7)
    assert back.shape == (4, 5, 6)
    np.testing.assert_array_equal(back, arr.astype(np.float64))
    vec = np.random.default_rng(1).normal(size=(4, 5, 6, 3))
    g.write(8, vec)
    np.testing.assert_array_equal(g.read(8), vec)
    g.close()


def test_xy_append(tmp_path):
    cfg = PincConfig.from_string(f"[files]\noutput = {tmp_path}/xy/\n")
    xy = XYFile(cfg, "history")
    xy.create("/energy/kinetic/total")
    xy.create("/energy/kinetic/total")             # a second create is a no-op
    for i in range(5):
        xy.append("/energy/kinetic/total", i, i * 2.0)
    ds = xy.f["/energy/kinetic/total"]
    assert ds.shape == (5, 2) and ds.maxshape == (None, 2)
    np.testing.assert_array_equal(ds[:, 1], [0, 2, 4, 6, 8])
    xy.close()


def test_async_output_matches_sync(tmp_path, flat_runs):
    """files:async = true (the native spooler, converted at close) writes
    the same files, bit for bit, as the synchronous writer."""
    run_flat(tmp_path / "async", port=True, extra="[files]\nasync = true\n")
    assert (tmp_path / "async" / "snapshots.spool").exists()
    for name in FILES:
        a = datasets(tmp_path / "async" / name)
        b = datasets(flat_runs / "torch" / name)
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


def _reader():
    spec = importlib.util.spec_from_file_location(
        "plot_reader", ROOT / "script" / "plot" / "reader.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plot_reader_reads_both_packages(flat_runs):
    """script/plot/reader.py's read_grid and read_particles give the same
    arrays (within the flat tolerance) on both packages' files."""
    reader = _reader()
    for name in ("rho.grid.h5", "E.grid.h5"):
        with h5py.File(flat_runs / "torch" / name, "r") as f, \
                h5py.File(flat_runs / "jax" / name, "r") as g:
            assert reader.timesteps(f) == reader.timesteps(g) == [0, 1, 2, 3]
            for t in reader.timesteps(f):
                a, b = reader.read_grid(f, t), reader.read_grid(g, t)
                assert a.shape == b.shape and a.shape[:2] == (16, 8)
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-5 * np.abs(b).max())
    with h5py.File(flat_runs / "torch" / "pop.pop.h5", "r") as f, \
            h5py.File(flat_runs / "jax" / "pop.pop.h5", "r") as g:
        for what, t in (("pos", 2.0), ("vel", 1.5)):
            a, b = reader.read_particles(f, t, what), \
                reader.read_particles(g, t, what)
            assert sorted(a) == sorted(b) == ["specie 0", "specie 1"]
            for s in a:
                assert a[s].shape == b[s].shape == (4 * 16 * 8, 2)
                np.testing.assert_allclose(a[s], b[s], rtol=0,
                                           atol=1e-5 * np.abs(b[s]).max())
