"""pinc_tpu_torch's ShardedTiledSimulation (parallel/tiled_pic.py) on a CPU
mesh of ``["cpu"] * 8``, against pinc_tpu's and against the port's
single-device TiledSimulation, on tests/test_tiled_sharded.py's
``_deck((2, 2, 2), (8, 8, 8))`` (16^3 cells, T = 4, M = 1, B = 384: the
one-hot exchange, a re-bucket every 2 steps).

* The initial shards hold pinc_tpu's sharded state bit for bit.
* make_scan_steps(4) on the fused route (K2/K4's plain versions,
  tiles:mega = false) and on the XLA route, against pinc_tpu's
  make_scan_steps(4) (its XLA route, the CPU's default; the exchange in
  Pallas interpret mode): KE within 1e-4, PE within 1e-3 (relative,
  tests/test_tiled_sharded.py's), no drop.
* run() against the same window (run()'s step is the window's step):
  the same tolerances.
* The mega window (K5's plain version a shard) against the port's
  single-device mega window: KE within 1e-4, PE within 1e-3, particles
  conserved.  (pinc_tpu's sharded mega window runs pic_step in interpret
  mode, ~40 s; its own test holds it only to rtol 0.2 of the pair route.)
* A re-bucket whose movers cross shards, against the single-device
  re-bucket of the same drifted state: the gathered state bit for bit.
* A walled deck (x, y Dirichlet, mgSolve) against the single device.
* Each shard's kernel calls run in its thread inside its device's scope
  (torch.cuda.device stubbed): the guard for hosts with several cards.
"""

import threading

import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.parallel.tiled_pic import \
    ShardedTiledSimulation as JShardedTiled
from pinc_tpu_torch import compat
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.parallel import mesh
from pinc_tpu_torch.parallel.tiled_pic import ShardedTiledSimulation
from pinc_tpu_torch.tiled_sim import TiledSimulation

CPU8 = ["cpu"] * 8
STEPS = 4


def _deck(nsub, true, extra=""):
    return f"""
[time]
nTimeSteps = {STEPS}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {','.join(map(str, nsub))}
trueSize = {','.join(map(str, true))}
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


def _bounded(nsub, true):
    return _deck(nsub, true).replace(
        "boundaries = PERIODIC",
        "boundaries = DIRICHLET,DIRICHLET,PERIODIC,"
        "DIRICHLET,DIRICHLET,PERIODIC").replace(
        "poisson = sSolve", "poisson = mgSolve").replace(
        "drift = 0.05", "drift = 0") + "\n[multigrid]\nmgLevels = 2\n"


def _sharded(extra=""):
    return ShardedTiledSimulation(
        PincConfig.from_string(_deck((2, 2, 2), (8, 8, 8), extra)), seed=7,
        devices=CPU8)


def _single(extra=""):
    return TiledSimulation(
        PincConfig.from_string(_deck((1, 1, 1), (16, 16, 16), extra)),
        seed=7, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_window(cpu_devices):
    j = JShardedTiled(JConfig.from_string(_deck((2, 2, 2), (8, 8, 8))),
                      seed=7, devices=cpu_devices[:8])
    assert j._backend == "xla"
    init = tuple(np.array(getattr(j.state, k))
                 for k in ("lpos", "vel", "alive"))
    st, (ke, pe, dropped) = j.make_scan_steps(STEPS)(j.state)
    return dict(init=init, ke=np.asarray(ke), pe=np.asarray(pe),
                dropped=int(dropped),
                alive=int(np.asarray(st.alive).sum()))


def _energies_close(ke_ref, pe_ref, ke, pe):
    ke_ref, ke = np.asarray(ke_ref).sum(-1), np.asarray(ke).sum(-1)
    pe_ref, pe = np.asarray(pe_ref), np.asarray(pe)
    assert np.abs(ke - ke_ref).max() / np.abs(ke_ref).max() < 1e-4, \
        (ke_ref, ke)
    assert np.abs(pe - pe_ref).max() / np.abs(pe_ref).max() < 1e-3, \
        (pe_ref, pe)


def _alive(sim, st):
    return int(sim._flat_state(st).alive.sum())


def test_initial_shards_are_pinc_tpus(jax_window):
    """The shards hold pinc_tpu's sharded state bit for bit, both ways
    through compat's converters."""
    sim = _sharded()
    got = compat.sharded_tiled_state_to_numpy(
        sim.state, sim.ctx.n_subdomains, sim.ts_local.ntiles)
    for g, w in zip(got, jax_window["init"]):
        np.testing.assert_array_equal(g, w)
    back = compat.sharded_tiled_state_from_numpy(
        *jax_window["init"], sim.ctx.n_subdomains, sim.ctx.devices)
    for b, st in zip(back, sim.state):
        for k in ("lpos", "vel", "alive"):
            assert torch.equal(getattr(b, k), getattr(st, k)), k
    assert sim.ts_local.ntiles == (2, 2, 2) and sim.ts.B == 384


@pytest.mark.parametrize("extra", ["mega = false\n", "backend = xla\n"],
                         ids=["fused", "xla"])
def test_window_matches_pinc_tpu(jax_window, extra):
    sim = _sharded(extra)
    assert not sim._use_mega
    n0 = _alive(sim, sim.state)
    st, (ke, pe, dropped) = sim.make_scan_steps(STEPS)(sim.state)
    assert int(dropped) == jax_window["dropped"] == 0
    assert _alive(sim, st) == jax_window["alive"] == n0
    _energies_close(jax_window["ke"], jax_window["pe"], ke, pe)


def test_run_matches_pinc_tpu_window(jax_window):
    sim = _sharded()
    hist = sim.run(progress_every=0)
    assert hist["dropped"] == 0 and hist["n_lost"] == 0
    _energies_close(jax_window["ke"], jax_window["pe"],
                    hist["kinetic"][1:], hist["potential"][1:])
    assert int(sim.particles.alive.sum()) == jax_window["alive"]


def test_mega_window_matches_single():
    sim, one = _sharded(), _single()
    assert sim._use_mega and one._use_mega
    n0 = _alive(sim, sim.state)
    st, (ke, pe, dropped) = sim.make_scan_steps(STEPS)(sim.state)
    _, (ke1, pe1, d1) = one.make_scan_steps(STEPS)(one.state)
    assert int(dropped) == int(d1) == 0
    assert _alive(sim, st) == n0
    _energies_close(ke1, pe1, ke, pe)


def test_rebucket_across_shards_matches_single():
    """Drift every live slot by up to 0.9 cells (movers cross tiles and
    shards), then re-bucket: the shards' gathered state equals the
    single-device re-bucket's bit for bit."""
    sim, one = _sharded(), _single()
    st1 = one.state
    rng = np.random.default_rng(0)
    drift = torch.from_numpy(rng.uniform(-0.9, 0.9, tuple(st1.lpos.shape))
                             .astype(np.float32))
    st1.lpos += drift * st1.alive[:, None]
    st_n = sim._shard_state(st1)
    n0 = int(st1.alive.sum())
    st1, d1 = one._rebucket(st1)
    st_n, d_n = sim._rebucket(st_n)
    assert d1 == d_n == 0
    flat = sim._flat_state(st_n)
    for k in ("lpos", "vel", "alive"):
        assert torch.equal(getattr(flat, k), getattr(st1, k)), k
    assert int(flat.alive.sum()) == n0


def test_retune_sample_matches_single():
    """retune()'s velocity sample (every NT // 64-th global tile), taken
    from the shards that hold the tiles: the single device's bit for
    bit, so both derive the same cadences and face cap."""
    sim, one = _sharded(), _single()
    got, want = sim._retune_sample(sim.state), one._retune_sample(one.state)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert sim.retune(drops=1) == one.retune(drops=1)
    assert sim.tuning() == one.tuning()


def test_bounded_deck_matches_single():
    one = TiledSimulation(PincConfig.from_string(
        _bounded((1, 1, 1), (16, 16, 16))), seed=7, device="cpu")
    sim = ShardedTiledSimulation(PincConfig.from_string(
        _bounded((2, 2, 2), (8, 8, 8))), seed=7, devices=CPU8)
    assert not sim._use_fused
    _, (ke1, pe1, d1) = one.make_scan_steps(STEPS)(one.state)
    st, (ke, pe, dropped) = sim.make_scan_steps(STEPS)(sim.state)
    assert int(d1) == int(dropped) == 0
    np.testing.assert_allclose(ke.numpy(), ke1.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(pe.numpy(), pe1.numpy(), rtol=1e-3,
                               atol=1e-8)
    lp = sim.to_particles(st)
    pos = lp.pos()[lp.alive]
    assert float(pos[:, :2].min()) >= 0 and float(pos[:, :2].max()) <= 15


def test_shards_launch_inside_their_device_scope(monkeypatch):
    """torch.cuda.device stubbed (every device treated as a card): each
    kernel wrapper call of a step, a mega window and a re-bucket runs in a
    shard's thread, inside the scope that thread entered for that shard's
    device, and every shard makes the same calls."""
    scopes = threading.local()
    calls = []

    class FakeDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            if not hasattr(scopes, "stack"):
                scopes.stack = []
            scopes.stack.append(self.dev)

        def __exit__(self, *exc):
            scopes.stack.pop()

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(mesh, "device_scope",
                        lambda dev: torch.cuda.device(dev))
    sim = _sharded()
    devices = sim.ctx.devices

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            shard = mesh.current_shard()
            stack = getattr(scopes, "stack", [])
            calls.append((name, shard, threading.get_ident(),
                          bool(stack) and shard is not None
                          and stack[-1] == devices[shard]))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("deposit", "deposit_move", "gather", "gather_kick",
                 "pic_step"):
        spy(tk, name)
    spy(ex, "rebucket_exchange_planes")
    st, *_ = sim._tiled_half_kick(sim.state)
    st, *_ = sim._tiled_step(st)
    st, _ = sim._rebucket(st)
    sim.make_scan_steps(2)(st)
    assert calls and all(ok for *_, ok in calls)
    per_shard = {}
    for name, shard, tid, _ in calls:
        per_shard.setdefault(shard, []).append(name)
    assert sorted(per_shard) == list(range(8))
    assert all(v == per_shard[0] for v in per_shard.values())
    assert {"deposit", "deposit_move", "gather", "gather_kick", "pic_step",
            "rebucket_exchange_planes"} <= set(per_shard[0])
    assert len({tid for _, _, tid, _ in calls}) > 1


def test_sharded_run_writes_global_output(tmp_path):
    """files:output on the sharded deck (through the CLI on a CPU mesh)
    writes the global fields and population, gathered from the shards:
    pinc_tpu's files of the same shapes as the single device's run, the
    values within 1e-4 of their maxima."""
    h5py = pytest.importorskip("h5py")
    from pinc_tpu_torch.__main__ import main
    runs = {}
    for label, nsub, true in (("one", (1, 1, 1), (16, 16, 16)),
                              ("sharded", (2, 2, 2), (8, 8, 8))):
        deck = tmp_path / f"{label}.ini"
        deck.write_text(_deck(nsub, true))
        out = {}
        assert main([str(deck), f"files:output={tmp_path}/{label}/run",
                     "files:writeFrequency=2"], out=out, device="cpu") == 0
        runs[label] = out["sim"]
    assert isinstance(runs["sharded"], ShardedTiledSimulation)
    for name in ("rho.grid.h5", "phi.grid.h5", "E.grid.h5", "pop.pop.h5"):
        with h5py.File(tmp_path / "one" / f"run_{name}", "r") as f1, \
                h5py.File(tmp_path / "sharded" / f"run_{name}", "r") as fN:
            keys = []
            f1.visit(lambda k: keys.append(k)
                     if isinstance(f1[k], h5py.Dataset) else None)
            assert keys
            for k in keys:
                a, b = f1[k][()], fN[k][()]
                assert a.shape == b.shape, (name, k)
                scale = max(float(np.abs(a).max()), 1e-12)
                assert np.abs(a - b).max() <= 1e-4 * scale, (name, k)
