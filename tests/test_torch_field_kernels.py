"""The plain PyTorch versions of the field kernels (pinc_tpu_torch
ops/field_kernels.py: K6 efield_tiles, K7 fold_global) against pinc_tpu's
Pallas kernels in interpret mode (pinc_tpu/ops/pallas_field.py), and against
pinc_tpu's XLA fold where the TPU fold cannot run (T <= 2M+1).  Inputs are
numpy arrays made from seeds and fed to both packages.

Tolerances: K6 bit-equal (the same float32 difference 0.5*(phi[n-1] -
phi[n+1]), cast once).  K7 bit-equal to pinc_tpu's fold_to_global (the same
three per-axis overlap-add passes in the same order), and rtol 1e-6 with
atol 1e-6 * max|rho| against the TPU fold kernel, which sums the same
entries in another order.  The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.ops import pallas_field as pf
from pinc_tpu.ops import tiled as jtl
from pinc_tpu_torch.ops import field_kernels as fk
from pinc_tpu_torch.ops.tiled import TileSpec

SHAPE = (16, 24, 32)


def _specs(T, M, shape=SHAPE):
    return (jtl.TileSpec(grid=shape, T=T, M=M, B=128),
            TileSpec(grid=shape, T=T, M=M, B=128))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 2])
def test_efield_tiles_plain_matches_pallas(M, dt):
    jts, ts = _specs(8, M)
    phi = np.random.default_rng(10 + M).normal(size=SHAPE).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    want = pf.efield_tiles(jnp.asarray(phi), jts, interpret=True,
                           out_dtype=jdt)
    before = dict(fk.LAUNCHES)
    got = fk.efield_tiles(torch.from_numpy(phi), ts, out_dtype=tdt)
    assert fk.LAUNCHES == before            # CPU tensors: plain version
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (
        ts.NT, 3 * ts.P, ts.P ** 2)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _tiles(ts, seed):
    return np.random.default_rng(seed).normal(
        size=(ts.NT, ts.P, ts.P * ts.P)).astype(np.float32)


@pytest.mark.parametrize("M", [1, 2])
def test_fold_global_plain_matches_pallas(M):
    jts, ts = _specs(8, M)
    tiles = _tiles(ts, 20 + M)
    want = np.asarray(pf.fold_global_t(jnp.asarray(tiles), jts,
                                       interpret=True)).transpose(1, 0, 2)
    got = fk.fold_global(torch.from_numpy(tiles), ts).numpy()
    assert got.shape == want.shape == SHAPE
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    xla = np.asarray(jtl.fold_to_global(
        jnp.asarray(tiles).reshape((ts.NT,) + (ts.P,) * 3), jts))
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("T, M", [(4, 2), (4, 1), (3, 2)])
def test_fold_global_plain_matches_xla_fold_where_tiles_overlap(T, M):
    """T <= 2M+1: a node takes the low planes of the next tile and the
    high planes of the previous one at once (pinc_tpu's TPU fold asserts
    T > 2M+1; the port's fold has no such gate)."""
    shape = (12, 12, 24) if T == 3 else (16, 8, 24)
    jts, ts = _specs(T, M, shape)
    tiles = _tiles(ts, 30 + T + M)
    want = np.asarray(jtl.fold_to_global(
        jnp.asarray(tiles).reshape((ts.NT,) + (ts.P,) * 3), jts))
    got = fk.fold_global(torch.from_numpy(tiles), ts).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold_global_plain_conserves_charge():
    """Every entry of every tile lands on exactly one node."""
    _, ts = _specs(4, 2, (8, 8, 8))
    tiles = torch.from_numpy(_tiles(ts, 40)).double()
    rho = fk.fold_global_plain(tiles, ts)
    assert abs(float(rho.sum() - tiles.sum())) < 1e-9


def test_efield_tiles_plain_is_minus_the_gradient():
    """Against the port's own grid.gradient, padded by ops/tiled.pad_tiles:
    E = -grad(phi) at every padded node."""
    from pinc_tpu_torch.grid import gradient
    from pinc_tpu_torch.ops.tiled import pad_tiles
    _, ts = _specs(8, 2)
    phi = torch.from_numpy(
        np.random.default_rng(50).normal(size=SHAPE).astype(np.float32))
    want = pad_tiles(-gradient(phi), ts).permute(0, 4, 1, 2, 3).reshape(
        ts.NT, 3 * ts.P, ts.P ** 2)
    assert torch.equal(fk.efield_tiles_plain(phi, ts), want)


def test_field_wrappers_reject_what_they_cannot_take():
    _, ts = _specs(8, 1)
    with pytest.raises(ValueError, match="no kernel"):
        fk.efield_tiles(torch.zeros(SHAPE, device="meta"), ts)
    with pytest.raises(ValueError, match="out_dtype"):
        fk.efield_tiles(torch.zeros(SHAPE), ts, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="3-D"):
        fk.fold_global(torch.zeros((4, 11, 11)),
                       TileSpec(grid=(16, 16), T=8, M=1, B=128))
