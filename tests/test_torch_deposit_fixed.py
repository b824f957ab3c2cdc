"""K1 deposit's and K2 deposit_move's fixed-point density (pinc_tpu_torch
csrc/tiled.cu, ops/tiled_kernels.py): the kernels sum each tile's
density in a pair of int32 blocks on the grid tk.deposit_scale([vmax], B)
(K1) or tk.deposit_scale([charge], B) (K2).  A numpy emulation of that
accumulator (tests/fixed_point_deposit.py, shared with K5's tests) is held
within chip_smoke.py's 1e-5 of max|tiles| of the port's float32 plain
versions, and within tests/test_pallas_tiled.py's tolerances (rtol 1e-5,
atol 1e-5) of pinc_tpu's Pallas deposit and deposit_move in interpret
mode: at tests/test_pallas_tiled.py's fixture (f32 and bf16 weights, CIC
and NGP) and on one tile of the bench deck's production layout (T = 8,
B = 17,408, M = 1, bf16).  Inputs are numpy arrays made from seeds and fed
to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixed_point_deposit import deposit_fixed
from pinc_tpu.ops import pallas_tiled as pt
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu.ops.tiled import bucket as jbucket
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ORDERS = {"cic": 1, "ngp": 0}
DEPOSIT_RTOL = 1e-5     # chip_smoke.py's gate of the kernels' tiles
PALLAS_RTOL = PALLAS_ATOL = 1e-5   # tests/test_pallas_tiled.py's, tiles
BENCH_Q = -0.2 ** 2 / 32           # bench.py's electrons


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    """tests/test_pallas_tiled.py's fixture: 3000 uniform particles in a
    16^3 grid, T=4, M=1, B=128, every 13th dead; velocities N(0, 0.3)."""
    jts = JTileSpec(grid=(16, 16, 16), T=4, M=1, B=128, chunk=8)
    rng = np.random.default_rng(0)
    n = 3000
    pos = rng.uniform(0, 16, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::13] = False
    lp, _, la, _ = jbucket(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                           jnp.asarray(alive), jts)
    xyz = np.ascontiguousarray(np.moveaxis(np.asarray(lp), -1, 0))
    vel = rng.normal(scale=0.3, size=xyz.shape).astype(np.float32)
    return dict(jts=jts, ts=TileSpec(grid=(16, 16, 16), T=4, M=1, B=128),
                xyz=xyz, vel=vel, alive=np.asarray(la).astype(np.float32),
                value=1.3, q=-1.7)


def _production():
    """One tile of the bench deck's production layout: 16,384 live of
    17,408 slots on average, anywhere in [-M, T+M), dead slots parked at
    -2M-2, velocities N(0, 0.05); bench.py's electron charge."""
    jts = JTileSpec(grid=(8, 8, 8), T=8, M=1, B=17408)
    ts = TileSpec(grid=(8, 8, 8), T=8, M=1, B=17408)
    rng = np.random.default_rng(8)
    alive = (rng.uniform(size=(1, 17408)) < 16384 / 17408).astype(np.float32)
    xyz = rng.uniform(-1, 9 - 1e-3, (3, 1, 17408)).astype(np.float32)
    xyz = np.where(alive > 0, xyz, np.float32(-4.0))
    vel = rng.normal(0, 0.05, (3, 1, 17408)).astype(np.float32)
    return dict(jts=jts, ts=ts, xyz=xyz, vel=vel, alive=alive,
                value=-BENCH_Q, q=BENCH_Q)


CASES = [f"fixture_{dt}_{o}" for dt in DTYPES for o in ORDERS] + [
    "production_bf16_cic"]


def _case(fixture, case):
    where, dt, order = case.split("_")
    return (fixture if where == "fixture" else _production()), dt, \
        ORDERS[order]


def _hold(emu, plain, want):
    """emu within DEPOSIT_RTOL * max|tiles| of the plain version's tiles
    and within the Pallas tests' tolerances of pinc_tpu's."""
    assert np.abs(emu).max() > 0
    assert np.abs(emu - plain).max() <= DEPOSIT_RTOL * np.abs(plain).max()
    np.testing.assert_allclose(emu, want, rtol=PALLAS_RTOL,
                               atol=PALLAS_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_deposit_fixed_point_matches_plain_and_pallas(fixture, case):
    """K1 on value = alive * v at vmax = |v|."""
    f, dt, order = _case(fixture, case)
    value = f["alive"] * np.float32(f["value"])
    want = np.asarray(pt.deposit(
        jnp.asarray(f["xyz"]), jnp.asarray(value), f["jts"], interpret=True,
        mxu_dtype=DTYPES[dt][0], order=order))
    plain = tk.deposit_plain(torch.from_numpy(f["xyz"]),
                             torch.from_numpy(value), f["ts"],
                             mxu_dtype=DTYPES[dt][1], order=order).numpy()
    emu = deposit_fixed(f["xyz"][None], value[None], [abs(f["value"])],
                        f["ts"], dt == "bf16", order=order)
    _hold(emu, plain, want)


@pytest.mark.parametrize("case", CASES)
def test_deposit_move_fixed_point_matches_plain_and_pallas(fixture, case):
    """K2: the deposit of alive * q at the drifted positions, on the grid
    of |q|."""
    f, dt, order = _case(fixture, case)
    want, jxyz, _ = pt.deposit_move(
        jnp.asarray(f["xyz"]), jnp.asarray(f["vel"]),
        jnp.asarray(f["alive"]), f["q"], f["jts"], interpret=True,
        mxu_dtype=DTYPES[dt][0], order=order)
    plain, new_xyz, _ = tk.deposit_move_plain(
        torch.from_numpy(f["xyz"]), torch.from_numpy(f["vel"]),
        torch.from_numpy(f["alive"]), f["q"], f["ts"],
        mxu_dtype=DTYPES[dt][1], order=order)
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(jxyz))
    values = (f["alive"] * np.float32(f["q"]))[None]
    emu = deposit_fixed(new_xyz.numpy()[None], values, [f["q"]], f["ts"],
                        dt == "bf16", order=order)
    _hold(emu, plain.numpy(), np.asarray(want))


def test_deposit_scale_rejects_what_no_grid_holds():
    """A value bound that is not finite (K1's vmax read from values that
    hold inf or NaN) has no fixed-point grid."""
    for bad in (float("inf"), float("nan")):
        with pytest.raises(ValueError, match="not finite"):
            tk.deposit_scale([bad], 128)
