"""The one-hot exchange re-bucket of pinc_tpu_torch (ops/onehot_exchange.py,
its routing in ops/exchange.py) against pinc_tpu's
(ops/pallas_exchange.py, Pallas kernels in interpret mode), on the same
numpy inputs.

Every comparison is bit for bit (the float32 bit patterns): each value is
a copy or an f32 +-T add on both sides, and the port keeps pinc_tpu's
rows, ranks, caps and merge order.  The inputs hold -0.0 payloads: the
one-hot matmuls return them as +0.0, and so does the port.  Buffers are
compared in pinc_tpu's layout (NT, 8, R*W), the port's (NT, 7, R, W) with
a zero eighth payload row.

The JAX side is jitted once per shape and static arguments (interpret-mode
Pallas compiles slowly), so the tests share a few layouts: 2x2x2 tiles of
4^3 cells with B = 640 (rows of 80 slots), and B = 100 for the ranked
kernels that pinc_tpu keeps for B % 8 != 0.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu.ops.tiled import bucket as jbucket
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox
from pinc_tpu_torch.tiled_sim import TiledSimulation

GRID, T = (8, 8, 8), 4
NTILES = tuple(g // T for g in GRID)
NT = int(np.prod(NTILES))
B, L = 640, 80
KS, K = 16, 32          # row cap, tile cap of the kernel tests

_JIT = {}


def _jax(name, fn, **static):
    """fn with the static keyword arguments, jitted once per module."""
    key = (name,) + tuple(sorted(static.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(partial(fn, interpret=True, **static))
    return _JIT[key]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.uint32)


def _eq(mine, theirs):
    """Bit-equal float32 arrays (so -0.0 != +0.0)."""
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else mine
    np.testing.assert_array_equal(_bits(mine), _bits(theirs))


def _pinc_buf(buf: torch.Tensor) -> np.ndarray:
    """The port's (NT, 7, R, W) buffer in pinc_tpu's (NT, 8, R*W)."""
    n, _, R, W = buf.shape
    return torch.cat([buf, torch.zeros((n, 1, R, W))], 1).reshape(
        n, 8, R * W).numpy()


def _state(seed=1, b=B):
    """80% alive over [-1.5, T+1.5); in tile 0 the first 40 slots of every
    row leave through -x (past every row and tile cap); every 7th vy and
    every 9th y are -0.0."""
    rng = np.random.default_rng(seed)
    alive = (rng.uniform(size=(NT, b)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, T + 1.5, (NT, b)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(NT, b)).astype(np.float32) for _ in range(3)]
    if b % 8 == 0:
        planes[0][0].reshape(8, b // 8)[:, :40] = -0.5
        alive[0].reshape(8, b // 8)[:, :40] = 1.0
    planes[4][:, ::7] = -0.0
    planes[1][:, ::9] = -0.0
    return alive, planes


def _both(alive, planes):
    """The same state for each side: jax arrays, and fresh torch tensors."""
    return ((jnp.asarray(alive), tuple(jnp.asarray(p) for p in planes)),
            (torch.from_numpy(alive.copy()),
             tuple(torch.from_numpy(p.copy()) for p in planes)))


def _check_untouched(tp, planes):
    for mine, orig in zip(tp, planes):
        _eq(mine, orig)


# ---------------------------------------------------------------------------
# the kernels' functions, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [0, 1, 2])
def test_extract_fused_matches_pinc_tpu(d):
    """Tile-wide ranks in slot order, cap K a direction; tile 0's x
    leavers overflow it and are killed all the same."""
    alive, planes = _state()
    (ja, jp), (ta, tp) = _both(alive, planes)
    jbuf, jal = _jax("xf", pex.extract_fused, K=K, T=T)(jp[d], ja, jp)
    tbuf, tal = ox.extract_fused(tp[d], ta, tp, K, T)
    assert tbuf.shape == (NT, 7, 1, 2 * K)
    _eq(_pinc_buf(tbuf), jbuf)
    _eq(tal, jal)
    _check_untouched(tp, planes)
    if d == 0:
        assert float(tbuf[0, 6, 0, :K].sum()) == K
        assert float(tal[0].reshape(8, L)[:, :40].sum()) == 0.0


@pytest.mark.parametrize("d", [0, 1, 2])
def test_extract_rows_matches_pinc_tpu(d):
    alive, planes = _state(2)
    (ja, jp), (ta, tp) = _both(alive, planes)
    jbuf, jal = _jax("xr", pex.extract_rows, Ks=KS, T=T)(jp[d], ja, jp)
    tbuf, tal = ox.extract_rows(tp[d], ta, tp, KS, T)
    assert tbuf.shape == (NT, 7, 8, 2 * KS)
    _eq(_pinc_buf(tbuf), jbuf)
    _eq(tal, jal)
    if d == 0:                       # every row of tile 0 overflows
        assert float(tbuf[0, 6, :, :KS].sum()) == 8 * KS


def test_extract_all_rows_matches_pinc_tpu():
    alive, planes = _state(3)
    (ja, jp), (ta, tp) = _both(alive, planes)
    jbuf, jal = _jax("xa", pex.extract_all_rows, Ks=KS, T=T)(jp, ja)
    tbuf, tal = ox.extract_all_rows(tp, ta, KS, T)
    assert tbuf.shape == (NT, 7, 8, 6 * KS)
    _eq(_pinc_buf(tbuf), jbuf)
    _eq(tal, jal)
    assert float(tbuf[0, 6, :, :KS].sum()) == 8 * KS
    _check_untouched(tp, planes)


def _ranks(coord, alive, k):
    """pinc_tpu's rank encoding of exchange_dim's B % 8 != 0 branch."""
    al = alive > 0.5
    lm, lp = al & (coord < 0.0), al & (coord >= T)
    rm = np.cumsum(lm, axis=1) - 1
    rp = np.cumsum(lp, axis=1) - 1
    rank = np.where(lm & (rm < k), rm, np.where(lp & (rp < k), k + rp, -1))
    rank = np.where((lm & (rm >= k)) | (lp & (rp >= k)), 2 * k, rank)
    return rank.astype(np.int32)


def test_extract_ranked_matches_pinc_tpu():
    """B % 8 != 0: ranks given, 2K kills without a copy."""
    alive, planes = _state(4, b=100)
    planes[0][0, :60] = -0.5                   # tile 0 overflows K = 16
    alive[0, :60] = 1.0
    rank = _ranks(planes[0], alive, 16)
    assert (rank == 32).any()
    (ja, jp), (ta, tp) = _both(alive, planes)
    jbuf, jal = _jax("xk", pex.extract, K2=32)(jnp.asarray(rank), ja, jp)
    tbuf, tal = ox.extract(torch.from_numpy(rank), ta, tp, 32)
    _eq(_pinc_buf(tbuf), jbuf)
    _eq(tal, jal)


def _inc_rows(seed=5):
    """Arrivals for the row cleanup: the x hop of the v5 exchange, rolled
    and shifted, as ops/onehot_exchange.rebucket_exchange_all_rows builds
    it (row blocks of Wx = 2Ks)."""
    alive, planes = _state(seed)
    _, (ta, tp) = _both(alive, planes)
    buf, _ = ox.extract_all_rows(tp, ta, KS, T)
    nt = NTILES
    inc = torch.cat([ox._roll_blocked(buf[..., :KS], nt, 0, -1, gx._torch_roll),
                     ox._roll_blocked(buf[..., KS:2 * KS], nt, 0, 1,
                                      gx._torch_roll)], -1)
    return gx._shift_block(inc, 0, T, ((KS, 1), (KS, -1)))


@pytest.mark.parametrize("axes", [(1, 2), (2,)], ids=["yz", "z"])
def test_cleanup_rows_matches_pinc_tpu(axes):
    """Settled (cap W) and the per-direction extras (cap Ke = 2: the
    multi-axis movers overflow it)."""
    inc = _inc_rows()
    W = inc.shape[-1]
    js, je = _jax("cl", pex.cleanup_rows, W=W, Ke=2, T=T, axes=axes)(
        jnp.asarray(_pinc_buf(inc)))
    ts, te = ox.cleanup_rows(inc, W, 2, T, axes)
    _eq(_pinc_buf(ts), js)
    assert len(te) == len(je) == 2 * len(axes)
    for mine, theirs in zip(te, je):
        _eq(_pinc_buf(mine), theirs)
    extras = (((inc[:, 6] > 0.5) & ((inc[:, 2] < 0) | (inc[:, 2] >= T)))
              .sum(-1))
    assert int(extras.max()) > 2                    # Ke overflows


def _room(seed, b=B):
    """Destination alive planes: rows 0-4 of every tile full, rows 5-7
    half full, so arrivals outnumber some rows' (and tiles') free slots."""
    rng = np.random.default_rng(seed)
    alive = (rng.uniform(size=(NT, b)) < 0.5).astype(np.float32)
    if b % 8 == 0:
        alive.reshape(NT, 8, b // 8)[:, :5] = 1.0
    return alive


def _merge_both(jfn, tfn, alive, inc_t, planes, R):
    """Run a merge on both sides from the same inputs; compare."""
    jpl, jal = jfn(jnp.asarray(alive), jnp.asarray(_pinc_buf(inc_t)),
                   tuple(jnp.asarray(p) for p in planes))
    ta = torch.from_numpy(alive.copy())
    tp = tuple(torch.from_numpy(p.copy()) for p in planes)
    tpl, tal = tfn(ta, inc_t, tp)
    assert tal is ta and all(a is b for a, b in zip(tpl, tp))   # in place
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    return tal


def test_merge_rows_matches_pinc_tpu():
    alive0, planes = _state(6)
    _, (ta, tp) = _both(alive0, planes)
    inc, _ = ox.extract_rows(tp[0], ta, tp, KS, T)
    alive = _room(7)
    tal = _merge_both(_jax("mr", pex.merge_rows, Ks=KS),
                      lambda a, i, p: ox.merge_rows(a, i, p, KS),
                      alive, inc, planes, 8)
    placed = (tal.numpy() - alive).reshape(NT, 8, L).sum(-1)
    arrivals = inc[:, 6].sum(-1).numpy()
    assert (placed < arrivals).any()                # full rows drop
    assert (placed[:, 5:] > 0).all()


def test_merge_fused_matches_pinc_tpu():
    alive0, planes = _state(8)
    _, (ta, tp) = _both(alive0, planes)
    inc, _ = ox.extract_fused(tp[1], ta, tp, K, T)
    alive = _room(9)
    alive[:2] = 1.0
    alive[:2, ::50] = 0.0                          # 13 free slots: drops
    tal = _merge_both(_jax("mf", pex.merge_fused, K=K),
                      lambda a, i, p: ox.merge_fused(a, i, p, K),
                      alive, inc, planes, 1)
    placed = (tal.numpy() - alive).sum(-1)
    assert (placed[:2] == 13).all() and (inc[:2, 6].sum((-2, -1)) > 13).all()


@pytest.mark.parametrize("active", ["flags", "none", "skip"])
def test_merge_ranked_matches_pinc_tpu(active):
    """B % 8 != 0: free ranks given; with pinc_tpu's per-chunk flags,
    without (every chunk active), and with every other tile's chunk off
    (it places nothing, on both sides)."""
    alive0, planes = _state(10, b=100)
    rank = _ranks(planes[2], alive0, 16)
    _, (ta, tp) = _both(alive0, planes)
    inc, _ = ox.extract(torch.from_numpy(rank), ta, tp, 32)
    alive = _room(11, b=100)
    free = alive <= 0.5
    fr_incl = np.cumsum(free, axis=1)
    frank = np.where(free, fr_incl - 1, -1).astype(np.int32)
    act = None
    if active != "none":
        CB = ox._chunk(100)
        ends = fr_incl[:, CB - 1::CB]
        base = np.concatenate([np.zeros((NT, 1)), ends[:, :-1]], axis=1)
        n_arr = inc[:, 6].sum((-2, -1)).numpy()[:, None]
        act = ((base < n_arr) & (ends > base)).astype(np.int32)
        if active == "skip":
            act[::2] = 0
    jpl, jal = _jax("mk", pex.merge)(
        jnp.asarray(frank), jnp.asarray(alive), jnp.asarray(_pinc_buf(inc)),
        tuple(jnp.asarray(p) for p in planes),
        active=None if act is None else jnp.asarray(act))
    ta = torch.from_numpy(alive.copy())
    tpl, tal = ox.merge(torch.from_numpy(frank), ta, inc,
                        tuple(torch.from_numpy(p.copy()) for p in planes),
                        active=None if act is None else torch.from_numpy(act))
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    placed = (tal.numpy() - alive).sum(-1)
    assert (placed[1::2] > 0).all()
    assert (placed[::2] == 0).all() == (active == "skip")


def test_merge_all_rows_matches_pinc_tpu():
    """The v5 merge's table of eight compacted runs (Wx, 2(Ks+Ke), Ks, Ke,
    Ke, Ks, Ke, Ke) on rows that cannot take every arrival."""
    Ke = 8
    alive0, planes = _state(12)
    _, (ta, tp) = _both(alive0, planes)
    buf, _ = ox.extract_all_rows(tp, ta, KS, T)
    f = [buf[..., i * KS:(i + 1) * KS] for i in range(6)]
    half = [b[..., :Ke] for b in f]
    inc = torch.cat([f[0], f[1], f[2], half[0], f[3], half[1],
                     f[4], half[2], half[3], f[5], half[4], half[5]], -1)
    blocks, off = [], 0
    for w in (2 * KS, 2 * (KS + Ke), KS, Ke, Ke, KS, Ke, Ke):
        blocks.append((off, w))
        off += w
    assert off == inc.shape[-1]
    alive = _room(13)
    tal = _merge_both(_jax("ma", pex.merge_all_rows, blocks=tuple(blocks)),
                      lambda a, i, p: ox.merge_all_rows(a, i, p, blocks),
                      alive, inc.contiguous(), planes, 8)
    placed = (tal.numpy() - alive).reshape(NT, 8, L).sum(-1)
    assert (placed < inc[:, 6].sum(-1).numpy()).any()


def test_functions_point_at_pallas_calls():
    """FUNCTIONS names the nine pinc_tpu functions that reach
    pl.pallas_call, each at its def; REPLACES picks one per kernel."""
    import inspect
    src = inspect.getsource(pex).splitlines()
    calls = {name for name, fn in vars(pex).items()
             if inspect.isfunction(fn) and "pl.pallas_call" in
             inspect.getsource(fn)}
    assert set(ox.FUNCTIONS) == calls and len(calls) == 9
    for name, (where, kernel) in ox.FUNCTIONS.items():
        line = int(where.rsplit(":", 1)[1])
        assert src[line - 1].startswith(f"def {name}("), where
        assert kernel in ox.LAUNCHES
        assert ox.REPLACES[kernel] in {w for w, k in ox.FUNCTIONS.values()
                                       if k == kernel}
    assert set(ox.REPLACES) == set(ox.LAUNCHES) == set(ox.SOURCES)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def _drifted_state(seed, drift, b=B, n=3600):
    """Bucketed uniform particles (every 11th dead), every live slot
    drifted by up to +-drift; some vz are -0.0."""
    ts = JTileSpec(grid=GRID, T=T, M=1, B=b)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, GRID[0], (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    vel[::5, 2] = -0.0
    alive = np.ones(n, bool)
    alive[::11] = False
    lp, lv, la, dropped = jbucket(jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(alive), ts)
    assert int(dropped) == 0
    lp = np.asarray(lp) + rng.uniform(-drift, drift, lp.shape).astype(
        np.float32) * np.asarray(la)[..., None]
    planes = [np.ascontiguousarray(lp[..., d]) for d in range(3)]
    planes += [np.ascontiguousarray(np.asarray(lv)[..., d]) for d in range(3)]
    return np.asarray(la).astype(np.float32), planes


@pytest.mark.parametrize("variant, d, b, k", [("v4", 0, B, 8),
                                             ("v3", 1, B, 8),
                                             ("v2", 2, 100, 4)])
def test_exchange_dim_matches_pinc_tpu(variant, d, b, k):
    """One axis' sweep: per row (v4), per tile (v3), and the ranked
    kernels of B % 8 != 0 (v2), with caps small enough to drop."""
    rows = variant == "v4"
    alive, planes = _drifted_state(d + 20, 2.0, b=b, n=3600 if b == B
                                   else 560)
    (ja, jp), (ta, tp) = _both(alive, planes)
    jfn = _jax(f"xd{variant}", pex.exchange_dim, ntiles=NTILES, d=d, T=T,
               K=k, rows=rows)
    jpl, jal = jfn(jp, ja)
    tpl, tal = ox.exchange_dim(tp, ta, NTILES, d, T, k, rows=rows)
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    assert float(tal.sum()) < float(alive.sum())      # cap overflow drops


@pytest.mark.parametrize("drift, K_", [(0.9, 64), (2.0, 16)],
                         ids=["clean", "overflow"])
def test_all_rows_exchange_matches_pinc_tpu(drift, K_):
    """The v5 exchange through rebucket_exchange_planes (rows, fused):
    planes, alive and drops; with Ks = 16 and with Ks = 8, Ke = 8 (face,
    edge and row-room overflow)."""
    alive, planes = _drifted_state(30, drift)
    (ja, jp), (ta, tp) = _both(alive, planes)
    jfn = _jax(f"v5{K_}", pex.rebucket_exchange_planes, ntiles=NTILES, T=T,
               K=K_, rows=True, fused=True)
    jpl, jal, jd = jfn(jp, ja)
    tpl, tal, td = ex.rebucket_exchange_planes(tp, ta, NTILES, T, K_,
                                               rows=True, fused=True)
    for mine, theirs in zip(tpl, jpl):
        _eq(mine, theirs)
    _eq(tal, jal)
    assert int(td) == int(jd)
    assert int(tal.sum()) + int(td) == int(alive.sum())
    if K_ == 64:
        assert int(td) == 0
        live = tal > 0.5
        for c in tpl[:3]:
            assert float(c[live].min()) >= 0.0 and float(c[live].max()) < T
    else:
        assert int(td) > 0


@pytest.mark.parametrize("kw, b", [
    (dict(rows=True), B), (dict(rows=True, fused=False), B),
    (dict(rows=False), B), (dict(rows=True), 1024)],
    ids=["onehot_v5", "onehot_v4", "onehot_v3", "gather"])
def test_roll_fns_replace_torch_roll(kw, b):
    """roll_fns (per axis, for a sharded tile grid) take the place of
    torch.roll in every driver: the same result, each axis' override
    called with its own axis."""
    alive, planes = _drifted_state(40, 0.9, b=b)
    out, seen = [], []

    def roll_of(d):
        def roll(a, shift, axis):
            seen.append((d, axis))
            return torch.roll(a, shift, axis)
        return roll
    for roll_fns in (None, tuple(roll_of(d) for d in range(3))):
        _, (ta, tp) = _both(alive, planes)
        out.append(ex.rebucket_exchange_planes(tp, ta, NTILES, T, 64,
                                               roll_fns=roll_fns, **kw))
    for mine, theirs in zip(out[1][0], out[0][0]):
        _eq(mine, theirs)
    _eq(out[1][1], out[0][1])
    assert int(out[1][2]) == int(out[0][2])
    assert {d for d, _ in seen} == {0, 1, 2}
    assert all(d == axis for d, axis in seen)


def _record(calls, name):
    def fn(planes, alive, *args, **kw):
        calls.append((name,) + tuple(args[:4]) + (kw.get("rows"),))
        if name.endswith("dim"):
            return planes, alive
        return planes, alive, 0
    return fn


def _spy_routes(monkeypatch):
    calls = []
    for mod, name in ((ox, "rebucket_exchange_all_rows"),
                      (ox, "exchange_dim"),
                      (gx, "rebucket_exchange_all_rows_g"),
                      (gx, "exchange_dim_g")):
        monkeypatch.setattr(mod, name, _record(calls, name))
    return calls


def test_retune_moves_a_deck_between_routes(monkeypatch):
    """A one-hot deck (16^3, T = 4, 8 per cell, slack 2.25: B = 1152) starts
    on the fused row exchange (v5); retune() after drops escalates the face
    cap until the rows lose their head room, and the deck moves to the
    per-tile sweeps (v3), as in pinc_tpu."""
    deck = EXCHANGE_DECK
    jsim = JTiledSimulation(JConfig.from_string(deck), seed=3)
    sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device="cpu")
    assert sim.ts.B == jsim.ts.B == 1152
    calls = _spy_routes(monkeypatch)

    def route():
        calls.clear()
        st = sim.state
        sim._rebucket_one(st.lpos[0], st.vel[0], st.alive[0])
        return {c[0] for c in calls}

    assert sim._exchange_rows and jsim._exchange_rows
    assert route() == {"rebucket_exchange_all_rows"}
    seen = []
    for drops in (3, 5, 7, 2, 4, 6):
        assert sim.retune(sim.state, drops=drops) == jsim.retune(
            jsim.state, drops=drops)
        assert (sim._exchange_cap, sim._exchange_rows) == (
            jsim._exchange_cap, jsim._exchange_rows)
        seen.append(sim._exchange_rows)
    assert seen[0] and not seen[-1]
    assert route() == {"exchange_dim"}
    assert all(c[-1] is False for c in calls) and len(calls) == 3


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
slack = 2.25
"""
