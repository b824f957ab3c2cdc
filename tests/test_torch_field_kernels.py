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
these plain versions on the card by tests/test_torch_cuda.py.

K6's kernel takes runs of up to 8 tiles along z in one block (a pencil's
last run the ntz % 8 rest).  A numpy emulation of its index arithmetic
(the run's staged window of phi from 4-node groups; each warp's chunks of
32 rows of P outputs, a lane a row, with the rows' mixed-radix digits
stepped as the kernel steps them; each chunk's staging shifted to the
span's 16-byte alignment, its whole 16-byte groups and its scalar ends)
is held bit for bit against the plain version at every run length, and
the plain version against pinc_tpu where ntz % 8 != 0 and where the z-wrap
falls inside a run's window.

K7's kernel (M < T) takes runs of tiles along z too.  A numpy emulation of
it (fold_runs: the staged blocks assembled from the (x, y) neighbours'
spans, each a scalar head and 16-byte groups; the shared layout that puts
planes and core rows on 16-byte boundaries; the x, y and z passes in
place, with the plain version's additions of zero padding; the rows of rho
as a scalar head and 16-byte groups) is held bit for bit against the plain
version and pinc_tpu's fold_to_global at run lengths 1-8, ntz = 1, 2, 3
and 5, T = 8, 6, 4 and 3, and within the tolerance above against the TPU
kernel's fold_global_t, which sums in another order."""

import functools

import jax
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


@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 16, 80)),
                                         (8, 2, (8, 16, 24)),
                                         (4, 2, (8, 8, 28))])
def test_efield_tiles_plain_matches_pallas_on_runs(T, M, shape):
    """ntz = 10 (a run of 8 and a rest of 2), ntz = 3 (one run whose
    window wraps at both z edges) and T <= 2M+1 with ntz = 7."""
    jts, ts = _specs(T, M, shape)
    phi = np.random.default_rng(T + M).normal(size=shape).astype(np.float32)
    want = pf.efield_tiles(jnp.asarray(phi), jts, interpret=True,
                           out_dtype=jnp.bfloat16)
    got = fk.efield_tiles(torch.from_numpy(phi), ts, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _split(i, radix):
    """Mixed-radix digits of i, fastest first, the last unbounded (the
    kernel's Radix::split)."""
    d = []
    for r in radix:
        d.append(i % r)
        i = i // r
    return d + [i]


def _add(d, s, radix):
    """The kernel's Radix::add: d + s digit by digit with carries, each
    stride digit below its radix (so one subtraction a digit)."""
    out, carry = [], 0
    for k, r in enumerate(radix):
        v = d[k] + s[k] + carry
        assert (v < 2 * r).all()
        carry = (v >= r).astype(int)
        out.append(v - r * carry)
    return out + [d[-1] + s[-1] + carry]


def efield_runs(phi, T, M, g, bf16):
    """efield_kernel<bf16> with runs of g tiles on a numpy phi (X, Y, Z):
    the flat output (NT * 3P^3) as float32 values of the output type.
    Asserts that every output element is written once, that the 16-byte
    stores and staging reads start on 16-byte boundaries, that no unstaged
    window node is read and that a warp's lanes read distinct banks."""
    X, Y, Z = phi.shape
    P, W = T + 1 + 2 * M, T + 3 + 2 * M
    V = 8 if bf16 else 4
    ntx, nty, ntz = X // T, Y // T, Z // T
    g = min(g, ntz)
    runs = -(-ntz // g)
    P3 = P ** 3
    out = np.full(ntx * nty * ntz * 3 * P3, np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    cast = ((lambda v: torch.from_numpy(v).to(torch.bfloat16).float()
             .numpy()) if bf16 else (lambda v: v))
    for blk in range(ntx * nty * runs):
        rz, pencil = blk % runs, blk // runs
        ty, tx = pencil % nty, pencil // nty
        tz0 = rz * g
        ng = min(g, ntz - tz0)
        Zw = ng * T + 2 * M + 3
        gx0, gy0, gz0 = tx * T - M - 1, ty * T - M - 1, tz0 * T - M - 1
        q0 = gz0 // 4
        nq = (gz0 + Zw - 1) // 4 - q0 + 1
        PS = W * Zw + 32

        def plane(x):                          # the kernel's plane_base
            return x * PS + ((1 - 2 * x - W) * Zw) % 32
        win = np.full(W * PS, np.nan, np.float32)
        for x in range(W):
            for y in range(W):
                row = phi[(gx0 + x) % X, (gy0 + y) % Y]
                for qi in range(nq):
                    z0 = 4 * (q0 + qi)
                    if Z % 4 == 0:           # one 16-byte load
                        assert (z0 % Z) % 4 == 0
                    for j in range(4):
                        zi = z0 + j - gz0
                        if 0 <= zi < Zw:
                            win[plane(x) + y * Zw + zi] = row[(z0 + j) % Z]
        n, nrows = ng * 3 * P3, ng * 3 * P * P
        R0 = ((tx * nty + ty) * ntz + tz0) * 3 * P3

        def put(x, v, vector=False):
            if vector:                         # one 16-byte store
                assert (R0 + x) % V == 0, f"16-byte store at {R0 + x}"
                x = np.arange(x, x + V)
            out[R0 + x] = v
            writes[R0 + x] += 1

        lanes = np.arange(32)
        radix = (P, P, 3)
        hop = _split(np.full(32, 8 * 32), radix)
        for warp in range(8):
            d = _split(warp * 32 + lanes, radix)
            for ch in range(warp, -(-nrows // 32), 8):
                # lane l: row 32 ch + l, digits (b, a, c, k), P outputs
                rows = ch * 32 + lanes
                assert all((x == y).all() for x, y in zip(
                    d, _split(rows, radix)))
                x0, x1 = ch * 32 * P, min(ch * 32 * P + 32 * P, n)
                sh = (R0 + x0) % V
                stage = np.full(32 * P + V, np.nan, np.float32)
                firsts = {}                    # (c, k) -> lanes' first reads
                for lane in lanes[rows < nrows]:
                    b, a, c, k = (int(x[lane]) for x in d)
                    zo = k * T + 1 + np.arange(P)
                    mid = plane(a + 1)
                    lo, hi = [win[i] for i in (
                        (plane(a) + (b + 1) * Zw + zo,
                         plane(a + 2) + (b + 1) * Zw + zo) if c == 0 else
                        (mid + b * Zw + zo, mid + (b + 2) * Zw + zo)
                        if c == 1 else
                        (mid + (b + 1) * Zw + zo - 1,
                         mid + (b + 1) * Zw + zo + 1))]
                    assert not (np.isnan(lo).any() or np.isnan(hi).any())
                    stage[sh + lane * P + np.arange(P)] = cast(
                        np.float32(0.5) * (lo - hi))
                    firsts.setdefault((c, k), []).append(
                        plane(a) + (b + 1) * Zw + zo[0] if c == 0
                        else mid + b * Zw + zo[0])
                # the skewed planes: lanes of one (tile, component) read
                # distinct banks (Zw odd)
                if Zw % 2:
                    for idx in firsts.values():
                        assert len({i % 32 for i in idx}) == len(idx)
                ga = min(x1, x0 + (V - sh) % V)
                gb = max(ga, x1 - (R0 + x1) % V)
                for x in range(ga, gb, V):
                    i = sh + x - x0
                    assert i % V == 0             # an aligned staging read
                    put(x, stage[i:i + V], vector=True)
                for x in list(range(x0, ga)) + list(range(gb, x1)):
                    put(x, stage[sh + x - x0])
                d = _add(d, hop, radix)
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 16, 80)),
                                         (8, 2, (8, 16, 24)),
                                         (4, 2, (8, 8, 28)),
                                         (6, 1, (6, 12, 18))])
def test_efield_run_emulation_matches_plain(T, M, shape, dt, g):
    """Run lengths 1-8 (g = 3: spans that start off a 16-byte boundary in
    f32 too), ntz % g != 0, a window wrapping at both z edges, T <= 2M+1,
    and Z % 4 != 0 (scalar staging loads)."""
    _, ts = _specs(T, M, shape)
    phi = np.random.default_rng(60 + T + M).normal(size=shape).astype(
        np.float32)
    bf16 = dt == "bf16"
    got = efield_runs(phi, T, M, g, bf16)
    want = fk.efield_tiles_plain(torch.from_numpy(phi), ts,
                                 out_dtype=torch.bfloat16 if bf16
                                 else torch.float32)
    np.testing.assert_array_equal(got, want.float().numpy().reshape(-1))


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


def fold_runs(tiles, T, M, g, grid):
    """fold_kernel (M < T) with runs of g tiles on numpy (NT, P, P*P)
    float32 tiles: rho (X, Y, Z).  Per block (a run of up to g tiles along
    z at (tx, ty)): the staged blocks of the run's tiles and their two
    z-neighbours, each plane ax of a staged block from tile tx + 1 (ax <
    M), tx (core) or tx - 1 (ax >= T + M) and within it the rows ay the
    same way along y, one contiguous span of n P floats a (plane,
    y-region) loaded as a scalar head up to its first 16-byte boundary and
    4-float groups (the last one short); then the x, y and z passes in
    shared memory, in place, and the run's rows of rho as a scalar head
    and 16-byte groups.  Asserts that every staged entry is loaded once,
    that every 16-byte load and store starts on a 16-byte boundary, that a
    pass reads only entries no pass writes (or the one it writes), and
    that every node of rho is written once."""
    X, Y, Z = grid
    P = T + 1 + 2 * M
    assert M < T
    ntx, nty, ntz = X // T, Y // T, Z // T
    g = min(g, ntz)
    flat = np.ascontiguousarray(tiles).reshape(-1)
    rho = np.full(X * Y * Z, np.nan, np.float32)
    writes = np.zeros(rho.size, np.int64)
    zero = np.float32(0.0)
    core = range(M, T + M)
    for blk in range(ntx * nty * -(-ntz // g)):
        runs = -(-ntz // g)
        rz, pencil = blk % runs, blk // runs
        ty, tx = pencil % nty, pencil // nty
        tz0 = rz * g
        ng = min(g, ntz - tz0)
        nk = ng + 2
        # the shared layout: planes S floats apart (S % 4 == 0), pad before
        # each so that its core rows start on a 16-byte boundary: the x
        # pass's float4s, and the y pass's where T P % 4 == 0 (rows T P
        # floats apart)
        pad = (-M * P) % 4
        S = -(-(pad + P * P) // 4) * 4
        assert S % 4 == 0 and (pad + M * P) % 4 == 0 and S >= pad + P * P
        st = np.full((nk, P, P, P), np.nan, np.float32)
        loaded = np.zeros(st.shape, np.int64)
        # (1) staging: span (k, ax, r)
        for k in range(nk):
            sz = (tz0 - 1 + k) % ntz
            for ax in range(P):
                sx = (tx + (1 if ax < M else (0 if ax < T + M else -1))) % ntx
                for r, (ay0, n) in enumerate(((0, M), (M, T), (T + M, M + 1))):
                    sy = (ty + 1 - r) % nty
                    src = ((((sx * nty + sy) * ntz + sz) * P + ax) * P
                           + ay0) * P
                    n *= P
                    h = min(n, (-src) % 4)
                    offs = np.concatenate([[0], np.arange(h, n, 4)])
                    cnts = np.concatenate([[h], np.minimum(4, n - offs[1:])])
                    assert ((src + offs[cnts == 4]) % 4 == 0).all()
                    for off, cnt in zip(offs, cnts):     # the span's items
                        sl = slice(ay0 * P + off, ay0 * P + off + cnt)
                        st[k, ax].reshape(-1)[sl] = flat[src + off:
                                                         src + off + cnt]
                        loaded[k, ax].reshape(-1)[sl] += 1
        assert (loaded == 1).all()
        # (2) x pass, (3) y pass: core entry m + M takes m + M - T (m >= T
        # - M, a piece only where M > 0) and m + M + T (m <= M), zeros
        # elsewhere; the entries read are margins (never written) or the
        # one written
        for mx in range(T):
            lo_i, hi_i = mx + M - T, mx + M + T
            assert lo_i not in core and hi_i not in core
            x = st[:, mx + M].copy()
            if M > 0:
                x = x + (st[:, lo_i] if mx >= T - M else zero)
            st[:, mx + M] = x + (st[:, hi_i] if mx <= M else zero)
        for my in range(T):
            y = st[:, M:T + M, my + M].copy()
            if M > 0:
                y = y + (st[:, M:T + M, my + M - T] if my >= T - M else zero)
            st[:, M:T + M, my + M] = y + (st[:, M:T + M, my + M + T]
                                          if my <= M else zero)
        # (4) z pass as rho is written: run tile k (block k + 1), node mz
        nz = ng * T
        col = np.empty((T, T, nz), np.float32)
        for e in range(nz):
            k, mz = divmod(e, T)
            z = st[k + 1, M:T + M, M:T + M, mz + M]
            if M > 0:
                z = z + (st[k + 2, M:T + M, M:T + M, mz + M - T]
                         if mz >= T - M else zero)
            col[:, :, e] = z + (st[k, M:T + M, M:T + M, mz + M + T]
                                if mz <= M else zero)
        for mx in range(T):
            for my in range(T):
                row = ((tx * T + mx) * Y + ty * T + my) * Z + tz0 * T
                h = min(nz, (-row) % 4)
                for off, cnt in [(0, h)] + [(off, min(4, nz - off))
                                            for off in range(h, nz, 4)]:
                    if cnt == 4:
                        assert (row + off) % 4 == 0       # a 16-byte store
                    rho[row + off:row + off + cnt] = col[mx, my,
                                                         off:off + cnt]
                    writes[row + off:row + off + cnt] += 1
    assert (writes == 1).all()
    return rho.reshape(grid)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 8, 40)),
                                         (8, 2, (8, 16, 24)),
                                         (8, 2, (8, 8, 8)),
                                         (8, 1, (16, 8, 16)),
                                         (6, 2, (12, 6, 18)),
                                         (4, 2, (8, 8, 12)),
                                         (3, 2, (6, 6, 9))])
def test_fold_run_emulation_matches_plain(T, M, shape, g):
    """Runs of 1-8 tiles, ntz = 1, 2, 3 and 5 (the z-neighbours of a run
    the same tile, or wrapping into the run), ntz % g != 0, T = 6 (rows of
    rho off a 16-byte boundary), T <= 2M+1 (a node takes from both
    neighbours of an axis).  Bit for bit against the port's plain version
    and pinc_tpu's fold_to_global (the same three per-axis passes); the
    TPU kernel's fold (pallas_field.fold_global_t) sums in another order
    and takes T > 2M+1: within its tolerance at T = 8."""
    tiles, plain, xla, tpu = _fold_refs(T, M, shape)
    got = fold_runs(tiles, T, M, g, shape)
    _eq_bits(got, plain)
    _eq_bits(got, xla)
    if tpu is not None:
        np.testing.assert_allclose(got, tpu, rtol=1e-6,
                                   atol=1e-6 * np.abs(tpu).max())


@functools.lru_cache(maxsize=None)
def _fold_refs(T, M, shape):
    """The tiles of a fold case and their folds: the port's plain version,
    pinc_tpu's fold_to_global, and its TPU kernel's (T > 2M+1 only, in
    interpret mode, transposed back), computed once for every run length."""
    jts, ts = _specs(T, M, shape)
    tiles = _tiles(ts, 70 + T + M + len(shape))
    plain = fk.fold_global_plain(torch.from_numpy(tiles), ts).numpy()
    xla = np.asarray(jax.jit(lambda t: jtl.fold_to_global(t, jts))(
        jnp.asarray(tiles).reshape((ts.NT,) + (ts.P,) * 3)))
    tpu = (np.asarray(pf.fold_global_t(jnp.asarray(tiles), jts,
                                       interpret=True)).transpose(1, 0, 2)
           if T > 2 * M + 1 else None)
    return tiles, plain, xla, tpu


def _eq_bits(a, b):
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint32),
                                  np.ascontiguousarray(b).view(np.uint32))


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
