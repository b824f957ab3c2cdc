"""The arithmetic of the kernel benchmark's given_kron and weight_sums
kernels (pinc_tpu_torch/csrc/kbench.cu, ops/kbench_kernels.py), emulated
in numpy and held against the TPU probes they port, run as
tests/test_torch_kbench.py runs them (loaded by path, pl.pallas_call in
interpret mode): experiments/archive/kbench2.py deposit_constk and
kbench3.py's mk_dep(_deposit_kernel_vpuonly), and against the port's
plain versions, on the same numpy inputs.

given_kron_kernel: A, the rows' weights, built at every node a of the 16
rows a warp gives wgmma (bf16(max(0, 1 - |x - (a - M)|) v), rows past P
zero), the plane staged 64 columns a stage (zeros past L), 8 wgmmas a k16
step (one a row r), each adding its 16-deep product to a float32
accumulator; a fresh accumulator a stage, added into the total with a
float32 round to nearest.  The tensor cores' float32 sums are modelled as
an exact sum of the step's products and the accumulator, truncated
toward zero (the model the stage fold answers: one accumulator over the
576 steps of a production tile drifts by the truncations).

weight_sums_kernel: X[a] sums of bf16(w(x) v) in per-thread float32 bins
(thread t the slots t, t + 256, ... in order), each bin's 256 threads
summed by lane (8 a lane in order, then a butterfly); R[k] sums of
bf16(w(y) w(z)) in the int32 pair (hi = rint(c 2^k), lo = rint((c 2^k -
hi) 2^j)) on the grid kb.weight_sums_scale(B); out = X[a] + R[k].

Tolerance: max|emulation - reference| <= 1e-5 max|reference| (the card
test's DEPOSIT_RTOL), at M = 1 and 2, at L = 32 and at L = 130 (not a
multiple of 16), and for given_kron on one tile of the production shape
(L = 1152).
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

ROOT = Path(__file__).resolve().parent.parent
T = 8
RTOL = kbench.DEPOSIT_RTOL
CHUNK = 64          # kGkChunk: plane columns a stage, a fresh accumulator
ROWS = 16           # rows of A a warp gives wgmma: P padded
THREADS = 256       # weight_sums_kernel's block
_PALLAS_CALL = pl.pallas_call

#: (grid, M, B): the fixture at both margins, a row of 130 columns, and
#: one tile of the production shape (given_kron only)
SHAPES = {"m1_b256": ((16, 16, 16), 1, 256),
          "m2_b256": ((16, 16, 16), 2, 256),
          "m1_b1040": ((16, 16, 16), 1, 1040),
          "m2_b1040": ((16, 16, 16), 2, 1040),
          "production_tile": ((8, 8, 8), 1, 9216)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tc_ref_{name}", ROOT / f"experiments/archive/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kbench2():
    return _load("kbench2")


@pytest.fixture(scope="module")
def kbench3():
    return _load("kbench3")


def bf16(a):
    """float32 -> bf16 (round to nearest even) -> float32."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def rz32(t):
    """float64 -> float32, rounded toward zero."""
    f = t.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(t)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _inputs(shape: str, seed: int):
    grid, M, B = SHAPES[shape]
    ts = TileSpec(grid=grid, T=T, M=M, B=B)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-M, T + M, (3, ts.NT, B)).astype(np.float32)
    val = (rng.uniform(size=(ts.NT, B)) < 0.9).astype(np.float32)
    kron = bf16(rng.uniform(size=(ts.P ** 2, B // 8)).astype(np.float32))
    return ts, JTileSpec(grid=grid, T=T, M=M, B=B), xyz, val, kron


# ---------------------------------------------------------------------------
# given_kron
# ---------------------------------------------------------------------------

def given_kron_tc(x, val, kron, P, M, fold=True):
    """given_kron_kernel's arithmetic: x, val (NT, B), kron (P^2, B/8)
    bf16 values -> (NT, P, P^2) float32.  fold=False: one accumulator for
    the whole tile (the truncations' drift unbounded)."""
    NT, B = val.shape
    L = B // 8
    Lp = -(-L // 16) * 16                       # zeros past L
    nodes = np.where(np.arange(ROWS) < P, np.arange(ROWS) - M,
                     np.float32(1e30)).astype(np.float32)
    xr = x.reshape(NT, 8, 1, L)
    hat = np.maximum(np.float32(0), np.float32(1) - np.abs(
        xr - nodes[:, None]))
    W = np.zeros((NT, 8, ROWS, Lp), np.float64)
    W[..., :L] = bf16(hat * val.reshape(NT, 8, 1, L))
    K = np.zeros((P * P, Lp), np.float64)
    K[:, :L] = kron
    acc = np.zeros((NT, ROWS, P * P), np.float32)
    tot = np.zeros_like(acc)
    for s in range(Lp // 16):
        cols = slice(16 * s, 16 * s + 16)
        for r in range(8):
            acc = rz32(acc.astype(np.float64)
                       + W[:, r, :, cols] @ K[:, cols].T)
        if fold and (s + 1) % (CHUNK // 16) == 0:
            tot, acc = tot + acc, np.zeros_like(acc)
    tot = tot + acc
    return tot[:, :P]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_given_kron_emulation_matches_deposit_constk(kbench2, shape):
    ts, jts, xyz, val, kron = _inputs(shape, seed=11)
    ref = np.asarray(kbench2.deposit_constk(
        jnp.asarray(xyz), jnp.asarray(val),
        jnp.asarray(kron).astype(jnp.bfloat16), jts))
    got = given_kron_tc(xyz[0], val, kron, ts.P, ts.M)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= RTOL * scale
    plain = kb.deposit_variant_plain(
        torch.from_numpy(xyz), torch.from_numpy(val), ts, "given_kron",
        kron=torch.from_numpy(kron).bfloat16()).numpy()
    assert np.abs(got - plain).max() <= RTOL * np.abs(plain).max()


def test_given_kron_stage_fold_bounds_the_truncation():
    """On production tiles (L = 1152: 576 wgmma steps), one accumulator
    drifts by the truncations toward zero; a fresh one a stage keeps the
    drift an order of magnitude inside the tolerance."""
    ts, _, xyz, val, kron = _inputs("production_tile", seed=12)
    x = np.concatenate([xyz[0]] * 2)
    v = np.concatenate([val, np.ones_like(val)])      # the second all live
    L = ts.B // 8
    nodes = np.arange(ts.P, dtype=np.float32) - ts.M
    W = bf16(np.maximum(np.float32(0), np.float32(1) - np.abs(
        x.reshape(2, 8, 1, L) - nodes[:, None])) * v.reshape(2, 8, 1, L))
    exact = np.einsum("tral,kl->tak", W.astype(np.float64),
                      kron.astype(np.float64))
    tol = RTOL * np.abs(exact).max()
    folded = np.abs(given_kron_tc(x, v, kron, ts.P, ts.M) - exact).max()
    single = np.abs(given_kron_tc(x, v, kron, ts.P, ts.M, fold=False)
                    - exact).max()
    assert folded <= 0.1 * tol and single >= 10 * folded


def test_given_kron_matmul_operands():
    """kbench.given_kron_matmul_ms's GEMM (W built outside, the plane
    repeated for the 8 rows) computes given_kron's function; the timing
    itself runs on the card only."""
    ts, _, xyz, val, kron = _inputs("m2_b256", seed=15)
    xyz, val = torch.from_numpy(xyz), torch.from_numpy(val)
    kron = torch.from_numpy(kron).bfloat16()
    W, Kt = kbench.given_kron_operands(xyz, val, kron, ts)
    assert W.shape == (ts.NT * ts.P, ts.B) and Kt.shape == (ts.B, ts.P ** 2)
    got = (W.double() @ Kt.double()).reshape(ts.NT, ts.P, ts.P ** 2)
    plain = kb.deposit_variant_plain(xyz, val, ts, "given_kron", kron=kron)
    assert (got - plain).abs().max() <= RTOL * plain.abs().max()
    with pytest.raises(ValueError, match="CUDA card"):
        kbench.given_kron_matmul_ms("cpu")


def test_given_kron_plane_stages():
    """The stage layout the kernel's descriptor assumes: a stage of 64
    plane columns of 128 rows in K-major core matrices of 8 rows x 16
    bytes, 128 bytes apart along K and 1024 along N, holds every element
    once."""
    n, k = np.meshgrid(np.arange(128), np.arange(CHUNK), indexing="ij")
    at = (n >> 3) * (CHUNK * 16) + (k >> 3) * 128 + (n & 7) * 16 + (k & 7) * 2
    assert sorted(at.ravel()) == list(range(0, 128 * CHUNK * 2, 2))
    # a k16 step s starts 256 s bytes in; its two core matrices along K
    # are LBO = 128 bytes apart, the 8-row groups SBO = 1024
    assert at[0, 16] == 256 and at[0, 8] == 128 and at[8, 0] == 1024


# ---------------------------------------------------------------------------
# weight_sums
# ---------------------------------------------------------------------------

def _nodes(x, M, T_):
    """The kernels' nodes(): [(index, weight)] of floor(x), floor(x) + 1,
    weight 0 and index 0 outside [-M, T + M]."""
    f = np.floor(x)
    out = []
    for kk in (0, 1):
        n = f + np.float32(kk)
        inside = (n >= -M) & (n <= T_ + M)
        w = np.maximum(np.float32(0), np.float32(1) - np.abs(x - n))
        out.append((np.where(inside, n + M, 0).astype(np.int64),
                    np.where(inside, w, np.float32(0)).astype(np.float32)))
    return out


def weight_sums_fixed(xyz, val, P, M):
    """weight_sums_kernel's arithmetic: xyz (3, NT, B), val (NT, B) ->
    (NT, P, P^2) float32; also returns the largest |hi| and |lo| sums."""
    _, NT, B = xyz.shape
    T_ = P - 1 - 2 * M
    k, j = kb.weight_sums_scale(B)
    scale, lo_scale = np.float32(2.0 ** k), np.float32(2.0 ** j)
    out = np.empty((NT, P, P * P), np.float32)
    big = [0, 0]
    for t in range(NT):
        bins = np.zeros((P, THREADS), np.float32)
        for m in range(0, B, THREADS):
            js = np.arange(m, min(m + THREADS, B))
            th = js - m
            for ia, w in _nodes(xyz[0, t, js], M, T_):
                wa = bf16(w * val[t, js])
                on = wa != 0
                bins[ia[on], th[on]] = bins[ia[on], th[on]] + wa[on]
        lanes = np.zeros((P, 32), np.float32)
        for u in range(THREADS // 32):
            lanes = lanes + bins[:, 32 * u:32 * u + 32]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        X = lanes[:, 0]
        hi = np.zeros(P * P, np.int64)
        lo = np.zeros(P * P, np.int64)
        ny, nz = _nodes(xyz[1, t], M, T_), _nodes(xyz[2, t], M, T_)
        for ib, wb in ny:
            for ic, wc in nz:
                c = bf16(wb * wc)
                on = c != 0
                y = c[on] * scale
                h = np.rint(y)
                np.add.at(hi, (ib * P + ic)[on], h.astype(np.int64))
                np.add.at(lo, (ib * P + ic)[on],
                          np.rint((y - h) * lo_scale).astype(np.int64))
        big = [max(big[0], np.abs(hi).max()), max(big[1], np.abs(lo).max())]
        R = ((hi + lo / 2.0 ** j) * 2.0 ** -k).astype(np.float32)
        out[t] = X[:, None] + R[None, :]
    return out, big


@pytest.mark.parametrize("B", [8, 256, 1040, 9216, 17408, 1 << 20])
def test_weight_sums_scale(B):
    """The R sums' grid: the largest k with 2^k 2 B <= 2^30 (a tile's B
    slots on one (y, z) node, wyz up to 1, x 2 for bf16's rounding up),
    the largest j <= 30 with B 2^(j-1) < 2^31 (|lo| <= 2^(j-1) a slot),
    tk.deposit_scale's at magnitude 1."""
    k, j = kb.weight_sums_scale(B)
    assert (k, j) == tk.deposit_scale((1.0,), B)
    assert 2.0 ** k * 2 * B <= 2 ** tk.HI_BITS < 2.0 ** (k + 1) * 2 * B
    assert B * 2 ** (j - 1) < 2 ** 31 and (j == 30
                                           or B * 2 ** j >= 2 ** 31)


@pytest.mark.parametrize("shape", ["m1_b256", "m2_b256", "m1_b1040"])
def test_weight_sums_emulation_matches_vpuonly(kbench3, shape):
    ts, jts, xyz, val, _ = _inputs(shape, seed=13)
    m = kbench3
    m.TS, m.NT, m.B, m.P, m.M = jts, ts.NT, ts.B, ts.P, ts.M
    ref = np.asarray(m.mk_dep(m._deposit_kernel_vpuonly)(
        jnp.asarray(xyz), jnp.asarray(val)))
    got, big = weight_sums_fixed(xyz, val, ts.P, ts.M)
    assert big[0] < 2 ** 31 and big[1] < 2 ** 31
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= RTOL * scale
    plain = kb.deposit_variant_plain(torch.from_numpy(xyz),
                                     torch.from_numpy(val), ts,
                                     "weight_sums").numpy()
    assert np.abs(got - plain).max() <= RTOL * np.abs(plain).max()


def test_weight_sums_at_the_scale_bound(kbench3):
    """Every slot of a tile on one (y, z) node (wyz = 1): the R bin sums
    B, its hi sum B 2^k at the scale's worst case (more than half of
    2^HI_BITS / 2), and the tiles still agree with vpuonly."""
    ts, jts, xyz, val, _ = _inputs("m1_b256", seed=14)
    xyz[1] = np.float32(3.0)
    xyz[2] = np.float32(5.0)
    m = kbench3
    m.TS, m.NT, m.B, m.P, m.M = jts, ts.NT, ts.B, ts.P, ts.M
    ref = np.asarray(m.mk_dep(m._deposit_kernel_vpuonly)(
        jnp.asarray(xyz), jnp.asarray(val)))
    got, big = weight_sums_fixed(xyz, val, ts.P, ts.M)
    k, _ = kb.weight_sums_scale(ts.B)
    assert big[0] == ts.B * 2 ** k
    assert 2 ** (tk.HI_BITS - 2) < big[0] < 2 ** 31
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()
