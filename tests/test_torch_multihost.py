"""pinc_tpu_torch/utils/multihost.py and the multi-process I/O discipline,
against pinc_tpu's: tests/test_io.py:112-160 run on both packages with the
same mocked process index and count (jax.process_index/process_count and
multihost.process_index/process_count), and the file names each writes
must be equal.

* A secondary process writes only its pop.p2 file; the primary owns the
  grids, the history and pop.p0; a secondary's checkpoint writes nothing.
* With one process: init() without WORLD_SIZE (or with 1) joins nothing,
  fetch_global/fetch_local pass a tensor through, and the writer's
  _owned_rows passes an array through (a process-sharded list gives this
  process's shards).
* The backend rule, the transport's byte packing, the rank-aware logging
  and the mesh's process blocks (no process group needed).
"""

import jax
import numpy as np
import pytest
import torch

from pinc_tpu import checkpoint as jckpt
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.io_h5 import OutputWriter as JOutputWriter
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.utils import multihost as jmh
from pinc_tpu_torch import checkpoint as ckpt
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.io_h5 import OutputWriter
from pinc_tpu_torch.parallel import mesh
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.utils import logging as plog
from pinc_tpu_torch.utils import multihost as mh

h5py = pytest.importorskip("h5py")

# tests/test_io.py's DECK
DECK = """
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


def _mock_process(monkeypatch, idx, count):
    monkeypatch.setattr(jax, "process_index", lambda: idx)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(mh, "process_index", lambda: idx)
    monkeypatch.setattr(mh, "process_count", lambda: count)


def _sims(tmp_path):
    """{package: (cfg, simulation, writer class)} of DECK, each writing to
    its own folder."""
    out = {}
    for pkg, cfg_cls, sim in (("jax", JConfig, JSimulation),
                              ("torch", PincConfig, None)):
        cfg = cfg_cls.from_string(DECK.format(out=f"{tmp_path}/{pkg}/d/"))
        out[pkg] = (cfg, JSimulation(cfg, seed=1) if sim
                    else Simulation(cfg, seed=1, device="cpu"),
                    JOutputWriter if sim else OutputWriter)
    return out


def _names(d):
    return sorted(p.name for p in d.iterdir())


def test_secondary_process_writes_only_its_pop_file(tmp_path, monkeypatch):
    """On a non-primary process the writer opens no grid or history file
    and creates only its own population file."""
    sims = _sims(tmp_path)
    _mock_process(monkeypatch, 2, 4)
    for pkg, (cfg, sim, writer) in sims.items():
        w = writer(cfg, sim)
        assert w.history is None and w.grids == {}, pkg
        w.write_energy(0, np.zeros(2), 0.0)       # a no-op, not a crash
        w.close()
    names = {pkg: _names(tmp_path / pkg / "d") for pkg in sims}
    assert names["torch"] == names["jax"] == ["pop.p2.pop.h5"]


def test_primary_process_owns_single_files(tmp_path, monkeypatch):
    sims = _sims(tmp_path)
    _mock_process(monkeypatch, 0, 4)
    for pkg, (cfg, sim, writer) in sims.items():
        w = writer(cfg, sim)
        assert w.history is not None, pkg
        assert set(w.grids) == {"rho", "phi", "E"}, pkg
        w.write_energy(0, np.zeros(2), 0.0)
        w.close()
    names = {pkg: _names(tmp_path / pkg / "d") for pkg in sims}
    assert names["torch"] == names["jax"]
    assert {"history.xy.h5", "pop.p0.pop.h5", "rho.grid.h5"} <= set(
        names["torch"])


def test_secondary_checkpoint_writes_nothing(tmp_path, monkeypatch):
    sims = _sims(tmp_path)
    # pinc_tpu's fetch_global would allgather with a count above 1
    monkeypatch.setattr(jmh, "fetch_global", lambda a: np.asarray(a))
    for idx in (1, 0):
        _mock_process(monkeypatch, idx, 4)
        paths = {pkg: (jckpt if pkg == "jax" else ckpt).save(
            cfg, 3, sim.particles) for pkg, (cfg, sim, _) in sims.items()}
        assert all(p.exists() == (idx == 0) for p in paths.values())
        assert paths["torch"].name == paths["jax"].name
    assert _names(tmp_path / "torch" / "d") == _names(tmp_path / "jax" / "d")


def test_owned_rows_single_process_passthrough(tmp_path):
    cfg = PincConfig.from_string(DECK.format(out=f"{tmp_path}/d/"))
    w = OutputWriter(cfg, Simulation(cfg, seed=1, device="cpu"))
    arr = np.arange(12).reshape(2, 6)
    np.testing.assert_array_equal(w._owned_rows(arr), arr)
    # a process-sharded list: this process's shards, along the axis
    parts = [torch.zeros(2, 3), None, torch.ones(2, 2)]
    np.testing.assert_array_equal(
        w._owned_rows(parts), np.concatenate([np.zeros((2, 3)),
                                              np.ones((2, 2))], axis=1))
    w.close()


@pytest.mark.parametrize("world", [None, "1"])
def test_init_without_a_world_is_a_no_op(monkeypatch, world):
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    assert mh.init(device="cpu") is False
    assert (mh.process_index(), mh.process_count()) == (0, 1)
    assert mh.is_primary() and mh.backend() is None
    mh.barrier()                                   # nothing to wait for


@pytest.mark.parametrize("fails", [False, True])
def test_main_leaves_the_group(tmp_path, monkeypatch, fails):
    """main() leaves the group it joined: after a barrier when the run
    ends, without one when the run raises (a peer inside another
    collective would report that barrier instead of the error)."""
    from pinc_tpu_torch import __main__ as cli
    from pinc_tpu_torch.registry import RUN_MODES
    left = []
    monkeypatch.setattr(mh, "init", lambda **k: True)
    monkeypatch.setattr(mh, "shutdown",
                        lambda barrier=True: left.append(barrier))

    def run(device):
        if fails:
            raise RuntimeError("the run failed")
        return {}
    monkeypatch.setattr(RUN_MODES, "select", lambda *a, **k: run)
    deck = tmp_path / "deck.ini"
    deck.write_text(DECK.format(out=f"{tmp_path}/d/"))
    if fails:
        with pytest.raises(RuntimeError, match="the run failed"):
            cli.main([str(deck)], device="cpu")
    else:
        assert cli.main([str(deck)], device="cpu") == 0
    assert left == [not fails]


def test_fetch_single_process_passthrough():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for fetch in (mh.fetch_global, mh.fetch_local):
        got = fetch(x)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, x.numpy())
        np.testing.assert_array_equal(fetch(x.numpy()), x.numpy())
    # one process holds every shard of a sharded list
    np.testing.assert_array_equal(mh.fetch_global([x, x + 6]),
                                  np.arange(12).reshape(4, 3))


@pytest.mark.parametrize("requested,dev,local,cards,want", [
    (None, "cpu", 2, 0, "gloo"),
    ("gloo", "cpu", 2, 0, "gloo"),
    (None, "cuda", 2, 2, "nccl"),
    (None, "cuda", 2, 1, "gloo"),
    ("gloo", "cuda", 2, 2, "gloo"),
    ("nccl", "cuda", 4, 4, "nccl"),
    ("nccl", "cuda", 2, 1, ValueError),
    ("nccl", "cpu", 2, 0, ValueError),
])
def test_backend_rule(requested, dev, local, cards, want):
    """gloo on the CPU and where ranks share a card, nccl where each has
    its own; nccl asked on a shared card raises, naming gloo."""
    if want is ValueError:
        with pytest.raises(ValueError, match="gloo"):
            mh.choose_backend(requested, torch.device(dev), local, cards)
    else:
        assert mh.choose_backend(requested, torch.device(dev), local,
                                 cards) == want


def test_wire_round_trip():
    """The transport's one buffer: every dtype the mesh sends, each at a
    16-byte offset, back bit for bit."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(3, 5, generator=g), torch.arange(7),
          torch.rand(9, generator=g) > 0.5,
          torch.randn(4, 3, dtype=torch.complex64, generator=g),
          torch.randn(5, generator=g).to(torch.bfloat16),
          torch.tensor(3, dtype=torch.int32)]
    buf = mh._to_wire(ts)
    assert buf.dtype == torch.uint8 and buf.numel() % 16 == 0
    for a, b in zip(ts, mh._from_wire(buf, ts)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    it = iter(mh.leaves((ts[0], [ts[1], None])))
    back = mh.rebuild((ts[0], [ts[1], None]), it)
    assert back[0] is ts[0] and back[1][1] is None


def test_logging_prints_on_the_primary(monkeypatch, capsys):
    monkeypatch.setattr(mh, "process_index", lambda: 1)
    plog.msg(plog.STATUS, "hidden")
    plog.msg(plog.STATUS, "shown %d", 7, all_ranks=True)
    err = capsys.readouterr().err
    assert "hidden" not in err and "STATUS(rank 1)" in err and "shown 7" in err


def test_mesh_blocks_over_processes(monkeypatch):
    """Process 1 of 2 holds shards 2 and 3 of a (2, 2, 1) mesh, in
    mixed-radix order; another process's shard is listed on this
    process's device; a count that does not divide the shards raises."""
    _mock_process(monkeypatch, 1, 2)
    ctx = mesh.make_mesh((2, 2, 1), (4, 4, 4), devices=["cpu"] * 4)
    assert (ctx.rank, ctx.world, ctx.local) == (1, 2, (2, 3))
    assert [ctx.owner(i) for i in range(4)] == [0, 0, 1, 1]
    assert ctx.coords(2) == (1, 0, 0) and ctx.distinct_devices() == [
        torch.device("cpu")]
    assert ctx.map(lambda x: x + 1, [0, 1, 2, 3]) == [None, None, 3, 4]
    assert ctx.first([None, None, "a", "b"]) == "a"
    with pytest.raises(ValueError, match="do not divide"):
        mesh.make_mesh((3, 1, 1), (4, 4, 4), devices=["cpu"] * 3)
    assert mesh.mesh_devices("cpu", 2) == [torch.device("cpu")] * 2
