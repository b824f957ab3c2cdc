"""The gather-exchange re-bucket of pinc_tpu_torch (ops/gather_exchange.py,
ops/exchange.py) against pinc_tpu's (ops/pallas_gather_exchange.py,
ops/pallas_exchange.py, Pallas kernels in interpret mode), on the same
numpy inputs.

Every comparison is exact (assert_array_equal): each value is either a bit
copy or an f32 +-T add on both sides, and the port keeps pinc_tpu's row
semantics (8 rows of B/8 slots, per-row caps and ranks, spill passes), so
buffers, planes, alive and drop counts agree slot for slot.

The JAX side is jitted once per shape and static arguments (interpret-mode
Pallas compiles slowly; a jitted call then runs in well under a second),
so the driver tests share one layout: 2x2x2 tiles of 4^3 cells, B = 2048.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu.ops import pallas_gather_exchange as pgx
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu.ops.tiled import bucket as jbucket
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu_torch import tiled_sim
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox
from pinc_tpu_torch.tiled_sim import TiledSimulation, TiledState
from pinc_tpu_torch.utils import timer

GRID, T, B, K = (8, 8, 8), 4, 2048, 256
NTILES = tuple(g // T for g in GRID)
NT = int(np.prod(NTILES))
L = B // 8

_JIT = {}


def _jax(name, fn, **static):
    """fn with the static keyword arguments, jitted once per module."""
    key = (name,) + tuple(sorted(static.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(partial(fn, interpret=True, **static))
    return _JIT[key]


def _jax_rebucket(fused):
    return _jax("rebucket", pex.rebucket_exchange_planes, ntiles=NTILES, T=T,
                K=K, rows=True, fused=fused)


def _torch(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _eq(mine, theirs):
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def _rows_state(seed=1):
    """Slots spread over [-1.5, T+1.5) with 80% alive; in tile 0 the first
    200 slots of every row leave through -x, past every 128-wide row cap."""
    rng = np.random.default_rng(seed)
    alive = (rng.uniform(size=(NT, B)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, T + 1.5, (NT, B)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(NT, B)).astype(np.float32) for _ in range(3)]
    planes[0][0].reshape(8, L)[:, :200] = -0.5
    alive[0].reshape(8, L)[:, :200] = 1.0
    return alive, planes


def _both(alive, planes):
    """The same state for each side: jax arrays, and fresh torch tensors."""
    return ((jnp.asarray(alive), tuple(jnp.asarray(p) for p in planes)),
            (_torch(alive), tuple(_torch(p) for p in planes)))


EXTRACTS = {
    "dim0": (lambda a, p: pgx.extract_rows_g(0, a, p, 128, T, interpret=True),
             lambda a, p: gx.extract_rows_g(0, a, p, 128, T)),
    "dim1": (lambda a, p: pgx.extract_rows_g(1, a, p, 128, T, interpret=True),
             lambda a, p: gx.extract_rows_g(1, a, p, 128, T)),
    "dim2": (lambda a, p: pgx.extract_rows_g(2, a, p, 128, T, interpret=True),
             lambda a, p: gx.extract_rows_g(2, a, p, 128, T)),
    "all": (lambda a, p: pgx.extract_all_rows_g(a, p, 128, T, interpret=True),
            lambda a, p: gx.extract_all_rows_g(a, p, 128, T)),
    "compact": (lambda a, p: pgx.extract_compact_rows_g(a, p, 128, T,
                                                        interpret=True),
                lambda a, p: gx.extract_compact_rows_g(a, p, 128, T)),
}


@pytest.mark.parametrize("kind", list(EXTRACTS))
def test_extract_matches_pinc_tpu(kind):
    alive, planes = _rows_state()
    (ja, jp), (ta, tp) = _both(alive, planes)
    jfn, tfn = EXTRACTS[kind]
    jbuf, jal = jfn(ja, jp)
    tbuf, tal = tfn(ta, tp)
    _eq(tbuf, jbuf)
    _eq(tal, jal)
    if kind in ("dim0", "all", "compact"):
        # the flooded tile overflows every row's first (x-minus) run, and
        # the overflow is killed all the same
        assert tbuf[0, 6, :, :128].sum() == 8 * 128
        assert float(tal[0].reshape(8, L)[:, :200].sum()) == 0.0
    for mine, orig in zip(tp, planes):              # inputs untouched
        np.testing.assert_array_equal(mine.numpy(), orig)


def _compact_buffer():
    alive, planes = _rows_state()
    _, (ta, tp) = _both(alive, planes)
    buf, alive2 = gx.extract_compact_rows_g(ta, tp, 384, T)
    return buf, alive2, tp


@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2), (2,)])
def test_cleanup_matches_pinc_tpu(axes):
    buf, _, _ = _compact_buffer()
    js, je = _jax("cleanup", pgx.cleanup_rows_g, Ke=128, T=T, axes=axes)(
        jnp.asarray(buf.numpy()))
    ts, te = gx.cleanup_rows_g(buf, 128, T, axes)
    _eq(ts, js)
    assert len(te) == len(je) == 2 * len(axes)
    for mine, theirs in zip(te, je):
        _eq(mine, theirs)
    if axes == (0, 1, 2):      # the flooded tile overflows the xm cap
        assert te[0][0, 6].sum() == 8 * 128


def test_merge_matches_pinc_tpu():
    """Arrivals: the six face runs of the compact buffer, put back into the
    same tiles, whose rows 0-3 are full and rows 4-7 empty: rows 0-3's
    arrivals spill into rows 4-7, and the tiles have less room than
    arrivals, so pass 0, the spill passes and the drops all run."""
    buf, _, tp = _compact_buffer()
    _, faces = gx.cleanup_rows_g(buf, 128, T, (0, 1, 2))
    inc = torch.cat(faces, -1)
    blocks = tuple((128 * i, 128) for i in range(6))
    room = torch.zeros((NT, 8, L))
    room[:, :4] = 1.0
    alive = room.reshape(NT, B)
    jpl, jal = pgx.merge_rows_g(jnp.asarray(alive.numpy()),
                                jnp.asarray(inc.numpy()),
                                tuple(jnp.asarray(p.numpy()) for p in tp),
                                blocks, interpret=True)
    tpl, tal = gx.merge_rows_g(alive, inc, tp, blocks)
    assert tal is alive and all(a is b for a, b in zip(tpl, tp))  # in place
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    placed = tal.reshape(NT, 8, L)[:, 4:].sum(-1)
    assert float(placed.sum()) < float(inc[:, 6].sum())          # drops
    assert bool((placed > inc[:, 6, 4:].sum(-1)).any())          # spills


def _drifted_state(seed, drift, n=6000):
    """tests/test_exchange_gather.py's _setup at this module's layout:
    bucketed uniform particles, every live slot drifted by up to +-drift."""
    ts = JTileSpec(grid=GRID, T=T, M=1, B=B)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, GRID[0], (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::11] = False
    lp, lv, la, _ = jbucket(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.asarray(alive), ts)
    lp = np.asarray(lp) + rng.uniform(-drift, drift, lp.shape).astype(
        np.float32) * np.asarray(la)[..., None]
    return _planes_of(lp, np.asarray(lv), np.asarray(la))


def _planes_of(lp, lv, la):
    planes = [np.ascontiguousarray(lp[..., d]) for d in range(3)]
    planes += [np.ascontiguousarray(lv[..., d]) for d in range(3)]
    return la.astype(np.float32), planes


def _run_both(alive, planes, fused=True):
    (ja, jp), (ta, tp) = _both(alive, planes)
    jpl, jal, jd = _jax_rebucket(fused)(jp, ja)
    tpl, tal, td = ex.rebucket_exchange_planes(tp, ta, NTILES, T, K=K,
                                               rows=True, fused=fused)
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    assert int(td) == int(jd)
    assert int(tal.sum()) + int(td) == int(alive.sum())
    return tpl, tal, int(td)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_dim"])
def test_driver_matches_pinc_tpu(fused):
    alive, planes = _drifted_state(seed=3, drift=1.5 if fused else 0.9)
    tpl, tal, dropped = _run_both(alive, planes, fused=fused)
    assert dropped == 0
    live = tal > 0.5
    for c in tpl[:3]:
        assert float(c[live].min()) >= 0.0 and float(c[live].max()) < T


def test_extract_overflow_drops_match():
    """test_gather_overflow_counted: most of every tile pushed out through
    +x, past the 128-wide row face cap: both packages drop the same
    leavers."""
    ts = JTileSpec(grid=GRID, T=T, M=1, B=B)
    rng = np.random.default_rng(7)
    n = 14000
    pos = rng.uniform(0, 8, (n, 3)).astype(np.float32)
    lp, lv, la, _ = jbucket(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                            jnp.ones(n, bool), ts)
    lp = np.asarray(lp).copy()
    lp[..., 0] += np.where(np.asarray(la), 3.5, 0.0).astype(np.float32)
    alive, planes = _planes_of(lp, np.asarray(lv), np.asarray(la))
    _, _, dropped = _run_both(alive, planes)
    assert dropped > 0


def _tile_pair():
    lp = np.full((NT, B, 3), 1.5, np.float32)
    lv = np.zeros((NT, B, 3), np.float32)
    la = np.zeros((NT, B), bool)
    return lp, lv, la, 0, NT // 2           # source tile 0, its +x neighbour


def test_row_spill_matches():
    """test_gather_merge_row_spill: rows 0..6 of the receiving tile are
    full, 100 arrivals come from row 0: they spill into row 7."""
    lp, lv, la, src, dst = _tile_pair()
    la[dst, :7 * L] = True
    lv[dst, :7 * L, 0] = 7.0
    la[src, :100] = True
    lp[src, :100, 0] = 4.25
    lv[src, :100, 1] = np.arange(100, dtype=np.float32) + 1000.0
    alive, planes = _planes_of(lp, lv, la)
    tpl, tal, dropped = _run_both(alive, planes)
    assert dropped == 0
    a2 = tal.reshape(NT, 8, L) > 0.5
    assert int(a2[dst, 7].sum()) == 100


def test_full_tile_drops_match():
    """test_gather_merge_tile_full_drops_counted: every arrival into a full
    tile is dropped and counted."""
    lp, lv, la, src, dst = _tile_pair()
    la[dst, :] = True
    la[src, :50] = True
    lp[src, :50, 0] = 4.25
    alive, planes = _planes_of(lp, lv, la)
    assert _run_both(alive, planes)[2] == 50


def _bench_like_state(seed=5, n=8 * 1800):
    """The bench deck's electrons at this module's layout: uniform
    particles filling 88% of the slots, velocities N(0, 0.02) cells a step,
    moved by one 10-step re-bucket cadence."""
    ts = JTileSpec(grid=GRID, T=T, M=1, B=B)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, GRID[0], (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    lp, lv, la, _ = jbucket(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.ones(n, bool), ts)
    assert int(np.asarray(la).sum()) == n
    lp = np.asarray(lp) + 10.0 * np.asarray(lv) * np.asarray(la)[..., None]
    return _planes_of(lp, np.asarray(lv), np.asarray(la))


@pytest.mark.parametrize("state", ["fixture", "bench_like"])
def test_first_cleanup_settles_nothing(state):
    """The fused exchange's first cleanup splits the compact extract into
    the six faces.  Every valid column of that buffer is out on some axis,
    so pinc_tpu's settled output holds no valid column; the port's
    cleanup_faces_g, whose kernel writes no settled output, gives the same
    faces, and the port's fused exchange the same planes, alive and
    drops."""
    alive, planes = _rows_state() if state == "fixture" \
        else _bench_like_state()
    _, (ta, tp) = _both(alive, planes)
    Ks = gx.round_cap(ox.default_row_cap(K, B))
    buf, _ = gx.extract_compact_rows_g(ta, tp, gx.total_cap(Ks, K), T)
    js, je = _jax("cleanup", pgx.cleanup_rows_g, Ke=Ks, T=T,
                  axes=(0, 1, 2))(jnp.asarray(buf.numpy()))
    assert float(buf[:, 6].sum()) > 0
    assert not (np.asarray(js)[:, 6] > 0.5).any()
    faces = gx.cleanup_faces_g(buf, Ks, T)
    assert len(faces) == len(je) == 6
    for mine, theirs in zip(faces, je):
        _eq(mine, theirs)
    _run_both(alive, planes)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTES = [  # (B, ntiles, rows, fused, impl)
    (1024, (2, 2, 2), True, True, "auto"),
    (1024, (2, 2, 2), True, False, "auto"),
    (2048, (2, 2, 2), True, True, "gather"),
    (1024, (2, 2, 2), False, True, "auto"),
    (1024, (2, 2, 2), True, True, "onehot"),
    (640, (2, 2, 2), True, True, "auto"),
    (640, (2, 2, 2), True, True, "gather"),
    (640, (2, 2, 2), False, False, "auto"),
    (1024, (4, 2), True, True, "auto"),
]


def _record(calls, name):
    """Stand-in for a fused driver (planes, alive, ntiles, T, Ks, ...):
    records the caps it was given."""
    def fn(planes, alive, *args, **kw):
        calls.append((name, args, kw.get("KU")))
        return planes, alive, 0
    return fn


def _record_dim(calls, name):
    """Stand-in for a per-axis sweep (planes, alive, ntiles, d, T, K)."""
    def fn(planes, alive, *args, **kw):
        calls.append((name, args[1], args[3]))
        return planes, alive
    return fn


@pytest.mark.parametrize("route", ROUTES, ids=str)
def test_routing_matches_pinc_tpu(monkeypatch, route):
    B_, nt, rows, fused, impl = route
    jcalls, tcalls = [], []
    monkeypatch.setattr(pgx, "rebucket_exchange_all_rows_g",
                        _record(jcalls, "gather"))
    monkeypatch.setattr(pgx, "exchange_dim_g", _record_dim(jcalls, "dim"))
    monkeypatch.setattr(pex, "rebucket_exchange_all_rows",
                        _record(jcalls, "onehot"))
    monkeypatch.setattr(pex, "exchange_dim", _record_dim(jcalls, "onehot"))
    monkeypatch.setattr(gx, "rebucket_exchange_all_rows_g",
                        _record(tcalls, "gather"))
    monkeypatch.setattr(gx, "exchange_dim_g", _record_dim(tcalls, "dim"))
    monkeypatch.setattr(ox, "rebucket_exchange_all_rows",
                        _record(tcalls, "onehot"))
    monkeypatch.setattr(ox, "exchange_dim", _record_dim(tcalls, "onehot"))
    nt_ = int(np.prod(nt))
    kw = dict(K=256, rows=rows, fused=fused, impl=impl)
    pex.rebucket_exchange_planes((jnp.zeros((nt_, B_)),) * 6,
                                 jnp.zeros((nt_, B_)), nt, 4, **kw)
    planes = tuple(torch.zeros((nt_, B_)) for _ in range(6))
    if B_ % 1024 and jcalls[0][0] != "onehot":  # an assertion in pgx
        with pytest.raises(ValueError, match="B % 1024"):
            ex.rebucket_exchange_planes(planes, torch.zeros((nt_, B_)), nt, 4,
                                        **kw)
    else:
        ex.rebucket_exchange_planes(planes, torch.zeros((nt_, B_)), nt, 4,
                                    **kw)
        assert tcalls == jcalls


EXCHANGE_DECK = """
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
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
"""


def _host_percentiles(speeds, alive):
    """retune()'s previous selection: the sample copied to the host and
    np.percentile there."""
    v, a = speeds.cpu().numpy(), alive.cpu().numpy()
    out = []
    for s in range(v.shape[0]):
        vs = v[s].reshape(v.shape[1], -1)[:, a[s].reshape(-1)]
        out.append(float(np.percentile(vs, 99.9)) if vs.size else None)
    return out


def _speed_case(name):
    """(speeds (S, D, n, B), alive (S, n, B)) float32 and bool."""
    rng = np.random.default_rng(11)
    size, live = {"1": (1, 1.0), "2": (2, 1.0), "999": (999, 1.0),
                  "1000": (1000, 1.0), "1001": (1001, 1.0),
                  "100k": (100_003, 1.0), "tied": (20_000, 1.0),
                  "equal": (5000, 1.0), "mostly_dead": (50_000, 0.03),
                  "empty": (4096, 0.0), "nan": (3000, 1.0)}[name]
    v = rng.gamma(2.0, 0.05, size).astype(np.float32)
    if name == "tied":
        v = np.round(v, 2).astype(np.float32)
    if name == "equal":
        v[:] = np.float32(0.3)
    if name == "nan":
        v[17] = np.nan
    alive = rng.random(size) < live
    if name == "100k":     # two species, D = 3, the second one empty
        v = np.stack([v[:99_999].reshape(3, 1, -1), v[4:].reshape(3, 1, -1)])
        alive = np.stack([alive[:33_333], np.zeros(33_333, bool)])[:, None]
        return torch.from_numpy(v), torch.from_numpy(alive)
    return (torch.from_numpy(v).reshape(1, 1, 1, size),
            torch.from_numpy(alive).reshape(1, 1, size))


@pytest.mark.parametrize("name", ["1", "2", "999", "1000", "1001", "100k",
                                  "tied", "equal", "mostly_dead", "empty",
                                  "nan"])
def test_speed_percentiles_match_numpy(name):
    """retune()'s velocity scale, selected on the device, is
    np.percentile(vs, 99.9) of the alive speeds bit for bit (None where no
    slot is alive)."""
    speeds, alive = _speed_case(name)
    got = tiled_sim.speed_percentiles(speeds, alive)
    want = _host_percentiles(speeds, alive)
    assert [repr(g) for g in got] == [repr(w) for w in want]


# retune()'s states: (velocity scale, share of the particles killed)
HEATED = [(1.0, 0.0), (2.5, 0.0), (0.375, 0.0), (6.0, 0.9), (1.0, 0.97)]


@pytest.mark.parametrize("knobs", [
    "margin = 2\nslack = 2.0\n",
    "margin = 1\nslack = 2.0\n",
    "margin = 2\nslack = 4.0\nexchangeCap = 512\n",
], ids=["m2", "m1", "cap512"])
def test_tiled_sim_exchange_sizing_matches_pinc_tpu(monkeypatch, knobs):
    """The re-bucket mode, face cap, row gate and bucket size TiledSimulation
    derives equal pinc_tpu's; so do retune()'s decisions (cadences, face
    cap, escalation after drops, row gate, return value) on heated and
    thinned states, with and without drops, and those of the previous
    host path (np.percentile on the copied sample); a retune copies at
    most 64 bytes to the host."""
    deck = EXCHANGE_DECK + knobs
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=3)
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device="cpu")
    host = TiledSimulation(PincConfig.from_string(deck), seed=3, device="cpu")
    keys = ("_rebucket_mode", "_exchange_cap", "_exchange_rows",
            "rebucket_every_s")
    assert sim.ts.B == jsim.ts.B and sim.ts.M == jsim.ts.M
    assert {k: getattr(sim, k) for k in keys} == {
        k: getattr(jsim, k) for k in keys}
    assert sim._rebucket_mode == "exchange"
    rng = np.random.default_rng(5)
    calls = changed = 0
    for heat, kill in HEATED:
        keep = (rng.random(tuple(sim.state.alive.shape)) >= kill).astype(
            np.float32)
        st = TiledState(sim.state.lpos, sim.state.vel * heat,
                        sim.state.alive * torch.from_numpy(keep))
        jst = dataclasses.replace(jsim.state, vel=jsim.state.vel * heat,
                                  alive=jsim.state.alive * jnp.asarray(keep))
        for drops in (3, 0, 7, 0):
            with timer.tracing(True):
                timer.reset()
                got = sim.retune(st, drops=drops)
                rep = timer.report()
            with monkeypatch.context() as m:
                m.setattr(tiled_sim, "speed_percentiles", _host_percentiles)
                assert host.retune(st, drops=drops) == got
            assert jsim.retune(jst, drops=drops) == got
            calls, changed = calls + 1, changed + got
            assert rep["spans"]["pinc.retune"]["calls"] == 1
            assert 0 < rep["counts"]["pinc.retune_host_bytes"] <= 64
            want = {k: getattr(jsim, k) for k in keys + ("_cap_escalation",)}
            for mine in (sim, host):
                assert {k: getattr(mine, k) for k in want} == want
    assert 0 < changed < calls
