"""The plain PyTorch versions of the four tiled kernels (pinc_tpu_torch
ops/tiled_kernels.py) against pinc_tpu's Pallas kernels in interpret mode,
on the fixture of tests/test_pallas_tiled.py.  Inputs are numpy arrays fed
to both packages.

Tolerances: atol 1e-5 on tiles, fields and velocities (the same float32
products, summed in another order); n_out exact; vdot rtol 1e-5.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.ops import pallas_tiled as pt
from pinc_tpu.ops.tiled import TileSpec as JTileSpec, bucket as jbucket
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_pallas_tiled.py's fixture: 3000 uniform particles in a
    16^3 grid, T=4, M=1, B=128, every 13th dead."""
    jts = JTileSpec(grid=(16, 16, 16), T=4, M=1, B=128, chunk=8)
    rng = np.random.default_rng(0)
    n = 3000
    pos = rng.uniform(0, 16, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::13] = False
    lp, _, la, _ = jbucket(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                           jnp.asarray(alive), jts)
    xyz = np.ascontiguousarray(np.moveaxis(np.asarray(lp), -1, 0))
    la = np.asarray(la)
    vel = rng.normal(scale=0.3, size=xyz.shape).astype(np.float32)
    E = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    from pinc_tpu.ops.tiled import pad_tiles as jpad
    ep5 = np.asarray(jpad(jnp.asarray(E), jts)).reshape(
        jts.NT, jts.P, jts.P, jts.P, 3)
    ts = TileSpec(grid=(16, 16, 16), T=4, M=1, B=128)
    return dict(jts=jts, ts=ts, xyz=xyz, alive=la,
                alive_f=la.astype(np.float32), vel=vel, ep5=ep5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_deposit_plain_matches_pallas(setup, dt, order):
    s = setup
    value = np.where(s["alive"], np.float32(1.3), np.float32(0.0))
    ref = np.asarray(pt.deposit(jnp.asarray(s["xyz"]), jnp.asarray(value),
                                s["jts"], interpret=True,
                                mxu_dtype=DTYPES[dt][0], order=order))
    before = dict(tk.LAUNCHES)
    got = tk.deposit(_t(s["xyz"]), _t(value), s["ts"],
                     mxu_dtype=DTYPES[dt][1], order=order).numpy()
    assert tk.LAUNCHES == before            # CPU tensors: plain version
    assert got.shape == ref.shape == (s["ts"].NT, 7, 49)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_deposit_move_plain_matches_pallas(setup, dt, order):
    s = setup
    q = -1.7
    tiles_r, xyz_r, nout_r = pt.deposit_move(
        jnp.asarray(s["xyz"]), jnp.asarray(s["vel"]),
        jnp.asarray(s["alive_f"]), q, s["jts"], interpret=True,
        mxu_dtype=DTYPES[dt][0], order=order)
    tiles, xyz, nout = tk.deposit_move(
        _t(s["xyz"]), _t(s["vel"]), _t(s["alive_f"]), q, s["ts"],
        mxu_dtype=DTYPES[dt][1], order=order)
    np.testing.assert_allclose(tiles.numpy(), np.asarray(tiles_r), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(xyz_r))
    assert float(nout) == float(nout_r) > 0


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_plain_matches_pallas(setup, dt, order):
    s = setup
    ref = np.asarray(pt.gather(jnp.asarray(s["ep5"]), jnp.asarray(s["xyz"]),
                               s["jts"], interpret=True,
                               mxu_dtype=DTYPES[dt][0], order=order))
    got = tk.gather(_t(s["ep5"]), _t(s["xyz"]), s["ts"],
                    mxu_dtype=DTYPES[dt][1], order=order).numpy()
    assert got.shape == ref.shape == (3, s["ts"].NT, s["ts"].B)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


KICKS = {
    "leapfrog": dict(e_ext=None, boris=None),
    "boris": dict(e_ext=None, boris=((0.01, -0.02, 0.03),
                                     (0.0199, -0.0398, 0.0597))),
    "e_ext": dict(e_ext=(0.05, 0.0, -0.02), boris=None),
}


@pytest.mark.parametrize("kick", list(KICKS))
@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_kick_plain_matches_pallas(setup, dt, order, kick):
    s = setup
    qm = -0.37
    kw = KICKS[kick]
    vel_r, vdot_r = pt.gather_kick(
        jnp.asarray(s["ep5"]), jnp.asarray(s["xyz"]), jnp.asarray(s["vel"]),
        jnp.asarray(s["alive_f"]), qm, s["jts"], interpret=True,
        mxu_dtype=DTYPES[dt][0], order=order, **kw)
    vel, vdot = tk.gather_kick(
        _t(s["ep5"]), _t(s["xyz"]), _t(s["vel"]), _t(s["alive_f"]), qm,
        s["ts"], mxu_dtype=DTYPES[dt][1], order=order, **kw)
    np.testing.assert_allclose(vel.numpy(), np.asarray(vel_r), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(vdot), float(vdot_r), rtol=1e-5)


def test_wrappers_reject_other_devices(setup):
    s = setup
    with pytest.raises(ValueError, match="no kernel"):
        tk.deposit(_t(s["xyz"]).to("meta"), _t(s["alive_f"]).to("meta"),
                   s["ts"])
    with pytest.raises(ValueError, match="order"):
        tk.deposit(_t(s["xyz"]), _t(s["alive_f"]), s["ts"], order=2)
