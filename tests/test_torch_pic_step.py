"""The plain PyTorch version of K5 pic_step (pinc_tpu_torch
ops/tiled_kernels.py) against pinc_tpu's Pallas pic_step in interpret mode:
on tests/test_pallas_tiled.py's fixture (two species, f32 and bf16
weights, CIC and NGP, leapfrog and Boris + e_ext) and on
tests/test_margin_schedule.py's M = 2 state with its three sets of
per-species working margins.  Inputs are numpy arrays made from seeds and
fed to both packages; the port's E is pinc_tpu's padded field in
efield_tiles' (NT, 3P, P*P) layout, the same memory as its
(NT, 3, P, P*P) component-major tiles.

Tolerances: n_out exact; positions and velocities atol 1e-6, tiles atol
1e-6 and rtol 1e-6 (a node's density sums some hundred slots), vdot rtol
1e-6: the same float32 products, summed in another order (a dense
contraction on the JAX side, per-node sums on the port's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.ops import pallas_tiled as pt
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu.ops.tiled import bucket as jbucket
from pinc_tpu.ops.tiled import pad_tiles as jpad
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ORDERS = {"cic": (1, 1), "ngp": (0, 0), "cic_ngp": (1, 0)}
KICKS = {
    "leapfrog": dict(),
    "boris_eext": dict(e_ext=(0.05, 0.0, -0.02),
                       boris_T=((0.01, -0.02, 0.03), (0.001, 0.002, 0.003)),
                       boris_S=((0.0199, -0.0398, 0.0597),
                                (0.002, 0.004, 0.006))),
}
ATOL, VDOT_RTOL = 1e-6, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _e_tiles(field, jts):
    """A global field (X, Y, Z, 3) -> pinc_tpu's padded (NT, P, P, P, 3)
    tiles and the port's (NT, 3P, P*P) E tiles of the same values."""
    P = jts.P
    ep5 = np.asarray(jpad(jnp.asarray(field), jts)).reshape(
        jts.NT, P, P, P, 3)
    return ep5, np.ascontiguousarray(
        np.moveaxis(ep5, -1, 1).reshape(jts.NT, 3 * P, P * P))


@pytest.fixture(scope="module")
def fixture():
    """tests/test_pallas_tiled.py's fixture: 3000 uniform particles in a
    16^3 grid, T=4, M=1, B=128, every 13th dead; two species as in its
    test_pic_step_matches_kernel_pair."""
    jts = JTileSpec(grid=(16, 16, 16), T=4, M=1, B=128, chunk=8)
    rng = np.random.default_rng(0)
    n = 3000
    pos = rng.uniform(0, 16, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::13] = False
    lp, _, la, _ = jbucket(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                           jnp.asarray(alive), jts)
    xyz = np.moveaxis(np.asarray(lp), -1, 0)
    la = np.asarray(la).astype(np.float32)
    vel = (rng.normal(size=xyz.shape) * 0.1).astype(np.float32)
    ep5, E = _e_tiles(rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
                      jts)
    return dict(jts=jts, ts=TileSpec(grid=(16, 16, 16), T=4, M=1, B=128),
                ep5=ep5, E=E, lpos=np.stack([xyz, xyz + 0.01]),
                vel=np.stack([vel, -vel]), alive=np.stack([la, la]),
                charge=(-1.0, 1.5), qm=(-0.5, 0.25))


def _compare(got, want):
    tiles, lpos, vel, vdot, nout = (x.numpy() for x in got)
    w = [np.asarray(x) for x in want]
    np.testing.assert_allclose(tiles, w[0], rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(lpos, w[1], rtol=0, atol=ATOL)
    np.testing.assert_allclose(vel, w[2], rtol=0, atol=ATOL)
    np.testing.assert_allclose(vdot, w[3], rtol=VDOT_RTOL)
    np.testing.assert_array_equal(nout, w[4])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kick", list(KICKS))
@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_pic_step_plain_matches_pallas(fixture, dt, order, kick):
    f = fixture
    oa, od = ORDERS[order]
    kw = KICKS[kick]
    want = pt.pic_step(jnp.asarray(f["ep5"]), jnp.asarray(f["lpos"]),
                       jnp.asarray(f["vel"]), jnp.asarray(f["alive"]),
                       f["charge"], f["qm"], f["jts"], interpret=True,
                       mxu_dtype=DTYPES[dt][0], order_acc=oa,
                       order_distr=od, **kw)
    before = dict(tk.LAUNCHES)
    E = _t(f["E"]).to(DTYPES[dt][1])   # bf16 E with bf16 weights, as the scan
    got = tk.pic_step(E, _t(f["lpos"]), _t(f["vel"]), _t(f["alive"]),
                      f["charge"], f["qm"], f["ts"], mxu_dtype=DTYPES[dt][1],
                      order_acc=oa, order_distr=od, **kw)
    assert tk.LAUNCHES == before            # CPU tensors: plain version
    assert float(got[4][0]) > 0             # some live slot left the margin
    _compare(got, want)


MARGINS = (((1, 1), (1, 1)), ((1, 2), (2, 2)), ((0, 1), (1, 1)))


@pytest.mark.parametrize("margins", MARGINS,
                         ids=["m11_m11", "m12_m22", "m01_m11"])
def test_pic_step_margins_plain_matches_pallas(margins):
    """tests/test_margin_schedule.py's M = 2 state (wander 0.4, or 0 for a
    margin-0 gather) and field, at each of its margin sets; the port's
    node range test against pinc_tpu's embed matmuls."""
    jts = JTileSpec(grid=(16, 16, 16), T=4, M=2, B=128, chunk=8)
    ts = TileSpec(grid=(16, 16, 16), T=4, M=2, B=128)
    rng = np.random.default_rng(3)
    ep5, E = _e_tiles(rng.normal(0, 0.01, (16, 16, 16, 3)).astype(np.float32),
                      jts)
    wander = 0.4 if min(mg for mg, _ in margins) >= 1 else 0.0
    rng = np.random.default_rng(0)
    NT, B = ts.NT, ts.B
    lpos = rng.uniform(wander and -wander, ts.T - 1e-3 + (wander or 0),
                       (2, 3, NT, B)).astype(np.float32)
    vel = rng.normal(0, 0.05, (2, 3, NT, B)).astype(np.float32)
    alive = (rng.uniform(size=(2, NT, B)) < 0.7).astype(np.float32)
    charge, qm = (-1.0, 1.0), (-1.0, 1.0 / 1836.0)
    want = pt.pic_step(jnp.asarray(ep5), jnp.asarray(lpos),
                       jnp.asarray(vel), jnp.asarray(alive), charge, qm, jts,
                       interpret=True, margins=margins)
    got = tk.pic_step(_t(E), _t(lpos), _t(vel), _t(alive), charge, qm, ts,
                      margins=margins)
    _compare(got, want)


def test_pic_step_in_place(fixture):
    """inplace=True writes the new state into the given tensors, with the
    values of the out-of-place call."""
    f = fixture
    args = (_t(f["E"]), _t(f["lpos"]), _t(f["vel"]), _t(f["alive"]),
            f["charge"], f["qm"], f["ts"])
    ref = tk.pic_step(*args)
    lpos, vel = _t(f["lpos"]), _t(f["vel"])
    got = tk.pic_step(args[0], lpos, vel, *args[3:], inplace=True)
    assert got[1] is lpos and got[2] is vel
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(args[1], _t(f["lpos"]))   # out of place: untouched


def test_pic_step_rejects_bad_margins_and_devices(fixture):
    f = fixture
    args = (_t(f["E"]), _t(f["lpos"]), _t(f["vel"]), _t(f["alive"]),
            f["charge"], f["qm"], f["ts"])
    with pytest.raises(ValueError, match="margins"):
        tk.pic_step(*args, margins=((1, 0), (1, 1)))
    with pytest.raises(ValueError, match="margins"):
        tk.pic_step(*args, margins=((2, 1), (1, 1)))
    with pytest.raises(ValueError, match="no kernel"):
        tk.pic_step(*(a.to("meta") for a in args[:4]), *args[4:])
