"""The arithmetic of the kernel benchmark's bf16_native deposit
(pinc_tpu_torch/csrc/kbench.cu deposit_variant_kernel<BF16_NATIVE>,
ops/kbench_kernels.py deposit_variant), emulated in numpy and held against
the TPU probe it ports, experiments/archive/kbench4.py's
mk_dep(_deposit_kernel_bf), run as tests/test_torch_kbench.py runs it
(loaded by path, pl.pallas_call in interpret mode), and against the port's
plain version, on the same numpy inputs.

The kernel: the weights in bf16 arithmetic at the nodes floor(x) and
floor(x) + 1 (d = bf16(x - n), w = max(0, 1 - |d|), each op rounded to
bf16; 0 outside [-M, T + M]); wa = bf16(wx bf16(v)), wyz = bf16(wy wz);
each product c = wa wyz (exact in float32) added into the int32 pair:
y = c 2^k, hi += rint(y), lo += rint((y - hi) 2^j), on the grid (k, j) =
tk.deposit_scale((vmax,), B); a node's value (hi + lo 2^-j) 2^-k, formed
in double and rounded once to float32.

Tolerance: max|emulation - reference| <= 1e-5 max|reference| (the card
test's DEPOSIT_RTOL; the reference sums in float32 in another order), at M
= 1 and 2, B = 256 and 1040.  With 0/1 values every addend lies on the
pair's grid, so the emulated tiles equal the exact (float64) sums rounded
once to float32, bit for bit.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu_torch import kbench
from pinc_tpu_torch.ops import kbench_kernels as kb
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec
from test_torch_kbench_tc import bf16

ROOT = Path(__file__).resolve().parent.parent
T = 8
RTOL = kbench.DEPOSIT_RTOL
GRID = (16, 16, 16)
_PALLAS_CALL = pl.pallas_call


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


@pytest.fixture(scope="module")
def kbench4():
    spec = importlib.util.spec_from_file_location(
        "_pair_ref_kbench4", ROOT / "experiments/archive/kbench4.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(M: int, B: int, seed: int, values: str = "mask"):
    """Slots uniform over [-M, T + M); values the probes' 90% alive mask,
    or uniform over [-1, 1)."""
    ts = TileSpec(grid=GRID, T=T, M=M, B=B)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-M, T + M, (3, ts.NT, B)).astype(np.float32)
    if values == "mask":
        val = (rng.uniform(size=(ts.NT, B)) < 0.9).astype(np.float32)
    else:
        val = rng.uniform(-1, 1, (ts.NT, B)).astype(np.float32)
    return ts, JTileSpec(grid=GRID, T=T, M=M, B=B), xyz, val


def _nodes_bf16(x, M, T_):
    """nodes_bf16: [(index, bf16 weight)] of floor(x), floor(x) + 1."""
    f = np.floor(x)
    out = []
    for kk in (0, 1):
        n = f + np.float32(kk)
        inside = (n >= -M) & (n <= T_ + M)
        d = bf16(x - n)
        w = np.maximum(np.float32(0), bf16(np.float32(1) - np.abs(d)))
        out.append((np.where(inside, n + M, 0).astype(np.int64),
                    np.where(inside, w, np.float32(0)).astype(np.float32)))
    return out


def bf16_native_pair(xyz, val, P, M, vmax):
    """deposit_variant_kernel<BF16_NATIVE>'s arithmetic: xyz (3, NT, B),
    val (NT, B) -> (tiles (NT, P, P^2) float32, the exact float64 sums,
    the largest |hi| and |lo| sums, whether every lo add was exact)."""
    _, NT, B = xyz.shape
    T_ = P - 1 - 2 * M
    k, j = tk.deposit_scale((vmax,), B)
    scale, lo_scale = np.float32(2.0 ** k), np.float32(2.0 ** j)
    P2, P3 = P * P, P ** 3
    tiles = np.empty((NT, P3), np.float32)
    exact = np.zeros((NT, P3), np.float64)
    big, on_grid = [0, 0], True
    for t in range(NT):
        hi = np.zeros(P3, np.int64)
        lo = np.zeros(P3, np.int64)
        vb = bf16(val[t])
        nx, ny, nz = (_nodes_bf16(xyz[d, t], M, T_) for d in range(3))
        live = val[t] != 0
        for ia, wx in nx:
            wa = bf16(wx * vb)
            for ib, wy in ny:
                for ic, wz in nz:
                    c = wa * bf16(wy * wz)          # exact in float32
                    on = live & (wa != 0) & (bf16(wy * wz) != 0)
                    idx = (ia * P2 + ib * P + ic)[on]
                    y = c[on] * scale
                    h = np.rint(y)
                    r = (y - h) * lo_scale
                    on_grid &= bool(np.all(r == np.rint(r)))
                    np.add.at(hi, idx, h.astype(np.int64))
                    np.add.at(lo, idx, np.rint(r).astype(np.int64))
                    np.add.at(exact[t], idx, c[on].astype(np.float64))
        big = [max(big[0], np.abs(hi).max()), max(big[1], np.abs(lo).max())]
        tiles[t] = ((hi + lo / 2.0 ** j) * 2.0 ** -k).astype(np.float32)
    return (tiles.reshape(NT, P, P2), exact.reshape(NT, P, P2), big,
            on_grid)


@pytest.mark.parametrize("B", [256, 1040])
@pytest.mark.parametrize("M", [1, 2])
def test_bf16_native_pair_matches_kbench4(kbench4, M, B):
    ts, jts, xyz, val = _inputs(M, B, seed=20 + M + B)
    m = kbench4
    m.TS, m.NT, m.B, m.P, m.M = jts, ts.NT, ts.B, ts.P, ts.M
    ref = np.asarray(m.mk_dep(m._deposit_kernel_bf)(jnp.asarray(xyz),
                                                    jnp.asarray(val)))
    got, exact, big, on_grid = bf16_native_pair(xyz, val, ts.P, ts.M, 1.0)
    assert big[0] < 2 ** 31 and big[1] < 2 ** 31
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= RTOL * scale
    plain = kb.deposit_variant_plain(torch.from_numpy(xyz),
                                     torch.from_numpy(val), ts,
                                     "bf16_native").numpy()
    assert np.abs(got - plain).max() <= RTOL * np.abs(plain).max()
    # 0/1 values: every add on the grid, each node its exact sum rounded
    # once; the reference's float32 sums are no closer
    assert on_grid
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    assert (np.abs(got - exact).max()
            <= np.abs(ref.astype(np.float64) - exact).max())


@pytest.mark.parametrize("M", [1, 2])
def test_bf16_native_pair_on_signed_values(M):
    """Values over [-1, 1) at the grid of their largest magnitude (the
    wrapper's vmax=None): the pair rounds each add onto that grid and
    stays within the tolerance of the plain version."""
    ts, _, xyz, val = _inputs(M, 1040, seed=30 + M, values="signed")
    vmax = float(np.abs(val).max())
    got, exact, big, _ = bf16_native_pair(xyz, val, ts.P, ts.M, vmax)
    assert big[0] < 2 ** 31 and big[1] < 2 ** 31
    plain = kb.deposit_variant_plain(torch.from_numpy(xyz),
                                     torch.from_numpy(val), ts,
                                     "bf16_native").numpy()
    assert np.abs(got - plain).max() <= RTOL * np.abs(plain).max()
    assert np.abs(got - exact).max() <= RTOL * np.abs(exact).max()


def test_bf16_native_scale_at_the_benchmark_shape():
    """The kernel benchmark's grid: 0/1 values at B = 9216 give (k, j) =
    (15, 18), a grid of 2^-33 that holds every addend (a multiple of
    2^-24: two bf16 weights, each a multiple of 2^-8, and wyz rounded no
    finer than 2^-16) and the tile's worst case (all 9216 slots' weight
    on one node) below 2^30 in hi."""
    k, j = tk.deposit_scale((1.0,), 9216)
    assert (k, j) == (15, 18)
    assert 2 * 9216 * 2 ** k <= 2 ** tk.HI_BITS
    assert k + j >= 24


def test_deposit_variant_takes_vmax_on_the_cpu():
    """vmax only sets the card's grid: on the CPU the wrapper runs the
    plain version, with or without it."""
    ts, _, xyz, val = _inputs(1, 256, seed=40)
    x, v = torch.from_numpy(xyz), torch.from_numpy(val)
    want = kb.deposit_variant_plain(x, v, ts, "bf16_native")
    assert torch.equal(kb.deposit_variant(x, v, ts, "bf16_native",
                                          vmax=1.0), want)
    assert torch.equal(kb.deposit_variant(x, v, ts, "bf16_native"), want)
