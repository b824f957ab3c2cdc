"""tests/test_exchange_v2.py's eight cases against pinc_tpu_torch: the same
inputs through pinc_tpu's rebucket_exchange_planes (its one-hot exchange,
Pallas kernels in interpret mode) and the port's, whose planes, alive and
drop count must be bit-equal; then each case's own assertions, on the
port's results.  Those layouts (B = 64 to 512) all take the one-hot
kernels: rows=False runs the per-tile sweeps (v3), rows=True the fused row
exchange (v5) or, with fused=False, the per-row sweeps (v4).
"""

import jax.numpy as jnp
import numpy as np
import torch

from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu.ops.tiled import bucket as jbucket
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops.tiled import TileSpec, bucket, global_positions


def _setup(grid, T, B, n, drift_scale, seed=0):
    """test_exchange_v2._setup, as numpy: bucketed uniform particles
    (every 11th dead), positions drifted by up to +-drift_scale."""
    ts = JTileSpec(grid=grid, T=T, M=1, B=B, chunk=8)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, grid[0], (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::11] = False
    lp, lv, la, _ = jbucket(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.asarray(alive), ts)
    drift = rng.uniform(-drift_scale, drift_scale, lp.shape).astype(
        np.float32)
    lp2 = np.asarray(lp) + drift * np.asarray(la)[..., None]
    return (TileSpec(grid=grid, T=T, M=1, B=B), lp2, np.asarray(lv),
            np.asarray(la))


def _pushed(grid, T, B, n, push, seed):
    """test_exchange_v2's overflow layouts: uniform particles at rest,
    every live slot pushed by +push in every axis."""
    ts = JTileSpec(grid=grid, T=T, M=1, B=B, chunk=8)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, grid[0], (n, 3)).astype(np.float32)
    lp, lv, la, _ = jbucket(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                            jnp.ones(n, bool), ts)
    lp2 = np.asarray(lp) + np.float32(push) * np.asarray(la)[..., None]
    return (TileSpec(grid=grid, T=T, M=1, B=B), lp2, np.asarray(lv),
            np.asarray(la))


def _run(ts, lp, lv, la, **kw):
    """Both packages' rebucket_exchange_planes on the same planes;
    asserts bit equality and returns the port's (lpos (NT, B, 3), vel,
    alive bool, dropped)."""
    planes = [np.ascontiguousarray(lp[..., d]) for d in range(3)]
    planes += [np.ascontiguousarray(lv[..., d]) for d in range(3)]
    al = la.astype(np.float32)
    jpl, jal, jd = pex.rebucket_exchange_planes(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(al), ts.ntiles,
        ts.T, interpret=True, **kw)
    tpl, tal, td = ex.rebucket_exchange_planes(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(al.copy()), ts.ntiles, ts.T, **kw)
    for mine, theirs in zip(tpl, jpl):
        np.testing.assert_array_equal(mine.numpy().view(np.uint32),
                                      np.asarray(theirs).view(np.uint32))
    np.testing.assert_array_equal(tal.numpy(), np.asarray(jal))
    assert int(td) == int(jd)
    return (torch.stack(tpl[:3], -1), torch.stack(tpl[3:], -1), tal > 0.5,
            int(td))


def _in_tile(lp3, la3, T):
    live = lp3[la3]
    assert float(live.min()) >= 0.0 and float(live.max()) < T


def _mset(gp, v, alive):
    return np.sort(((gp[alive] * 7.1).sum(1) + (v[alive] * 13.3).sum(1))
                   .numpy())


def _mset6(planes_nb3, vel_nb3, alive):
    ps = [planes_nb3[..., d] for d in range(3)] + [vel_nb3[..., d]
                                                   for d in range(3)]
    return np.sort(sum(p[alive].numpy() * w for p, w in
                       zip(ps, [7.1, 3.3, 5.5, 13.3, 1.7, 2.9])))


def test_exchange_v2_conserves():
    ts, lp2, lv, la = _setup((16, 16, 16), 4, 128, 3000, 0.9)
    lp3, lv3, la3, dropped = _run(ts, lp2, lv, la, K=64)
    la0 = torch.from_numpy(la)
    assert dropped == 0 and int(la3.sum()) == int(la0.sum())
    _in_tile(lp3, la3, ts.T)
    before = _mset(global_positions(torch.from_numpy(lp2), ts),
                   torch.from_numpy(lv), la0)
    after = _mset(global_positions(lp3, ts), lv3, la3)
    assert np.allclose(before, after, atol=1e-2)


def test_exchange_v2_overflow_counted():
    ts, lp2, lv, la = _pushed((8, 8, 8), 4, 128, 1000, 0.9, seed=2)
    lp3, _, la3, dropped = _run(ts, lp2, lv, la, K=8)
    assert int(la3.sum()) + dropped == int(la.sum())
    _in_tile(lp3, la3, ts.T)


def test_exchange_matches_sort_rebucket():
    ts, lp2, lv, la = _setup((8, 8, 8), 4, 512, 2000, 0.9, seed=3)
    gpos = global_positions(torch.from_numpy(lp2), ts).reshape(-1, 3)
    lp_s, lv_s, la_s, d1 = bucket(gpos, torch.from_numpy(lv).reshape(-1, 3),
                                  torch.from_numpy(la).reshape(-1), ts)
    lp3, lv3, la3, d2 = _run(ts, lp2, lv, la, K=64)
    assert int(d1) == d2 == 0
    assert int(la_s.sum()) == int(la3.sum())
    np.testing.assert_allclose(
        _mset(global_positions(lp_s, ts), lv_s, la_s),
        _mset(global_positions(lp3, ts), lv3, la3), atol=1e-2)


def test_exchange_rows_matches_tile_path():
    ts, lp2, lv, la = _setup((16, 16, 16), 4, 256, 3000, 0.9, seed=5)
    lp_r, lv_r, la_r, d_r = _run(ts, lp2, lv, la, K=64, rows=True)
    lp_t, lv_t, la_t, d_t = _run(ts, lp2, lv, la, K=64, rows=False)
    assert d_r == d_t == 0 and int(la_r.sum()) == int(la_t.sum())
    np.testing.assert_allclose(_mset6(lp_r, lv_r, la_r),
                               _mset6(lp_t, lv_t, la_t), atol=1e-2)
    _in_tile(lp_r, la_r, ts.T)


def test_exchange_rows_overflow_counted():
    ts, lp2, lv, la = _pushed((8, 8, 8), 4, 64, 800, 0.9, seed=7)
    lp3, _, la3, dropped = _run(ts, lp2, lv, la, K=8, rows=True, ks=8)
    assert int(la3.sum()) + dropped == int(la.sum())
    _in_tile(lp3, la3, ts.T)


def test_exchange_fused_matches_perdim():
    ts, lp2, lv, la = _setup((16, 16, 16), 4, 256, 3000, 1.5, seed=9)
    lp_f, lv_f, la_f, d_f = _run(ts, lp2, lv, la, K=64, rows=True,
                                 fused=True)
    lp_s, lv_s, la_s, d_s = _run(ts, lp2, lv, la, K=64, rows=True,
                                 fused=False)
    assert d_f == d_s == 0 and int(la_f.sum()) == int(la_s.sum())
    np.testing.assert_allclose(_mset6(lp_f, lv_f, la_f),
                               _mset6(lp_s, lv_s, la_s), atol=1e-2)
    _in_tile(lp_f, la_f, ts.T)


def test_exchange_fused_corner_flow():
    ts = TileSpec(grid=(16, 16, 16), T=4, M=1, B=64)
    lp = np.zeros((ts.NT, 64, 3), np.float32)
    lv = np.zeros((ts.NT, 64, 3), np.float32)
    la = np.zeros((ts.NT, 64), bool)
    tid = (1 * 4 + 2) * 4 + 3                 # tile (1, 2, 3)
    la[tid, 5] = True
    lp[tid, 5] = [-0.5, 4.25, -0.75]
    lv[tid, 5] = [1.0, 2.0, 3.0]
    lp3, lv3, la3, dropped = _run(ts, lp, lv, la, K=8, rows=True,
                                  fused=True)
    assert dropped == 0 and int(la3.sum()) == 1
    dst, slot = (int(i) for i in torch.nonzero(la3)[0])
    assert dst == (0 * 4 + 3) * 4 + 2         # tile (0, 3, 2)
    assert lp3[dst, slot].tolist() == [3.5, 0.25, 3.25]
    assert lv3[dst, slot].tolist() == [1.0, 2.0, 3.0]


def test_exchange_fused_overflow_counted():
    ts, lp2, lv, la = _pushed((8, 8, 8), 4, 64, 800, 0.9, seed=7)
    lp3, _, la3, dropped = _run(ts, lp2, lv, la, K=8, rows=True, ks=8,
                                fused=True)
    assert int(la3.sum()) + dropped == int(la.sum())
    _in_tile(lp3, la3, ts.T)
