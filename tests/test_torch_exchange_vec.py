"""The exchange kernels' 16-byte lane groups (pinc_tpu_torch
csrc/exchange_common.cuh extract_kernel, csrc/gather_exchange.cu
cleanup_kernel), emulated in numpy and held bit for bit against pinc_tpu's
Pallas kernels in interpret mode and against the port's plain versions.

A CUDA kernel cannot run on the CPU, so this file keeps its arithmetic
testable: a numpy emulation walks each row as the kernels do (RowWalk: a
scalar head up to the row's first 16-byte boundary, then chunks of 128
slots, 4 consecutive slots a lane, the row's last group short), ranks each
class with the kernels' four ballots a chunk (rank_class), puts each
entry's source index into its flag entry, and fills every output entry in
a second pass (fill_segments: RowWalk groups of each output row, a copy
below the count, zeros beyond, 16-byte stores where a payload row's group
starts on a boundary).  The emulation asserts that every 16-byte
access starts on a 16-byte boundary (the arrays start on one, as the
wrappers check) and that the fill pass writes every output entry exactly
once (the kernels' outputs are torch.empty).

Shapes: rows of L = 2176 (the bench deck's B = 17,408), 960 (B = 7680),
256, 128, 80, and 81 and 83 (L % 4 != 0: rows start off a 16-byte
boundary); cleanup widths 384, 128, 130 and 18 (W % 4 != 0: rows start off
a boundary), with the leaver and edge caps overflowing.  The JAX side is jitted once per shape and static arguments
(interpret-mode Pallas compiles slowly), so each pinc_tpu function runs at
one or two of them; the port's plain versions cover every shape.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu.ops import pallas_gather_exchange as pgx
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox

T = 4
VEC, LANES = 4, 32              # slots of a 16-byte access; lanes of a warp
CHUNK = VEC * LANES
NPAY = 7
ALL, ANY = 3, 4                 # the kernels' classifier kinds (0-2: an axis)

_JIT = {}


def _jax(name, fn, **static):
    """fn with the static keyword arguments, jitted once per module."""
    key = (name,) + tuple(sorted(static.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(partial(fn, interpret=True, **static))
    return _JIT[key]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

class _Out:
    """A flat float32 output and a count of the writes to each entry."""

    def __init__(self, shape):
        self.shape = shape
        self.a = np.full(int(np.prod(shape)), np.nan, np.float32)
        self.n = np.zeros(self.a.size, np.int64)

    def put(self, i, v, vector=False):
        if vector:                            # one 16-byte store
            assert i % VEC == 0, f"16-byte store at element {i}"
            idx = np.arange(i, i + VEC)
        else:
            idx = np.asarray([i])
        self.a[idx] = v
        self.n[idx] += 1

    def done(self):
        assert (self.n == 1).all(), (
            f"{int((self.n == 0).sum())} entries unwritten, "
            f"{int((self.n > 1).sum())} written twice")
        return self.a.reshape(self.shape)


def row_walk(start, n):
    """The kernels' RowWalk of a row of n floats from element `start` of an
    array that starts on a 16-byte boundary: per chunk, each lane's (first
    slot, slot count); chunk -1 is the head (lane 0) when the row does not
    start on a boundary."""
    h = min(n, (-start) % VEC)
    chunks = [[(0, h)] + [(0, 0)] * (LANES - 1)] if h else []
    for c in range(-(-(n - h) // CHUNK)):
        offs = [h + VEC * (LANES * c + lane) for lane in range(LANES)]
        chunks.append([(o, max(0, min(VEC, n - o))) for o in offs])
    return chunks


def load(flat, start, group):
    """A lane's group loaded as the kernel does (load4): 4 values, zeros
    past the count; a whole group is one 16-byte load."""
    off, cnt = group
    if cnt == VEC:
        assert (start + off) % VEC == 0, f"16-byte load at {start + off}"
    v = np.zeros(VEC, np.float32)
    v[:cnt] = flat[start + off:start + off + cnt]
    return v


def rank_class(cls, c, run):
    """The kernels' ranks of class c in one chunk, cls (32, 4) (-1: no
    class): four ballots m_j = the lanes whose slot j is in c; rank(l, j) =
    run + sum_j popc(m_j & lanes below l) + #{j' < j : cls[l, j'] == c}.
    Returns (ranks (32, 4), run advanced past the chunk)."""
    lanes = np.arange(LANES, dtype=np.uint64)
    hit = cls == c
    m = (hit.astype(np.uint64) << lanes[:, None]).sum(0)          # (4,)
    lt = (np.uint64(1) << lanes) - np.uint64(1)                    # (32,)
    below = np.bitwise_count(m[None, :] & lt[:, None]).astype(
        np.int64).sum(1)
    within = np.cumsum(hit, 1) - hit
    return (run + below[:, None] + within,
            run + int(np.bitwise_count(m).sum()))


def fill_vec(out, seg0, pstride, n, cap, value):
    """The kernels' fill pass (fill_segments) on one output segment whose
    payload-0 row starts at element seg0 of out: RowWalk groups of that
    row; a group's columns < n take value(q, column), the others zeros;
    payload q's group is one 16-byte store where it starts on a 16-byte
    boundary, else scalar stores."""
    for groups in row_walk(seg0, cap):
        for off, cnt in groups:
            for q in range(NPAY):
                start = seg0 + q * pstride + off
                vals = [value(q, off + j) if off + j < n else 0.0
                        for j in range(cnt)]
                if cnt == VEC and start % VEC == 0:
                    out.put(start, vals, vector=True)
                else:
                    for j in range(cnt):
                        out.put(start + j, vals[j])


def _stored(x, canon):
    return np.float32(x) + np.float32(0.0) if canon else np.float32(x)


def _classify(kind, c, T):
    """classify<KIND> of exchange_common.cuh on one slot's coordinates."""
    if kind in (0, 1, 2):
        return 0 if c[0] < 0 else (1 if c[0] >= T else -1)
    out = [(a, s) for a in range(3) for s in (0, 1)
           if (c[a] < 0 if s == 0 else c[a] >= T)]
    if not out:
        return -1
    return 0 if kind == ANY else 2 * out[0][0] + out[0][1]


def extract_vec(coord, alive, planes, kind, R, K, T, canon):
    """extract_kernel<kind, R, canon> on numpy arrays (NT, B): returns
    (buf (NT, 7, R, n_cls * K), alive_out (NT, B))."""
    NT, B = alive.shape
    L = B // 8
    ncls = {ALL: 6, ANY: 1}.get(kind, 2)
    W = ncls * K
    fa = alive.reshape(-1)
    cpl = ([coord.reshape(-1)] if kind in (0, 1, 2)
           else [p.reshape(-1) for p in planes[:3]])
    pay = [p.reshape(-1) for p in planes]
    buf, aout = _Out((NT, NPAY, R, W)), _Out((NT, B))

    def classes(base, groups):
        cls = np.full((LANES, VEC), -1)
        for lane, g in enumerate(groups):
            a = load(fa, base, g)
            cs = [load(p, base, g) for p in cpl]
            for j in range(g[1]):
                if a[j] > 0.5:
                    cls[lane, j] = _classify(kind, [c[j] for c in cs], T)
        return cls

    for t in range(NT):
        counts = np.zeros((8, ncls), np.int64)
        slots = {(r, c): {} for r in range(R) for c in range(ncls)}
        if R == 1:                                    # the counting pass
            for w in range(8):
                for groups in row_walk(t * B + w * L, L):
                    cls = classes(t * B + w * L, groups)
                    counts[w] += [(cls == c).sum() for c in range(ncls)]
        for w in range(8):
            base = t * B + w * L
            run = (counts[:w].sum(0) if R == 1
                   else np.zeros(ncls, np.int64)).tolist()
            for groups in row_walk(base, L):
                cls = classes(base, groups)
                for lane, (off, cnt) in enumerate(groups):
                    kept = np.where(cls[lane] >= 0, np.float32(0),
                                    load(fa, base, (off, cnt)))
                    if cnt == VEC:
                        aout.put(base + off, kept, vector=True)
                    for j in range(cnt if cnt < VEC else 0):
                        aout.put(base + off + j, kept[j])
                if not (cls >= 0).any():
                    continue
                for c in range(ncls):
                    ranks, run[c] = rank_class(cls, c, run[c])
                    for lane, j in zip(*np.nonzero(cls == c)):
                        if ranks[lane, j] < K:       # the slot, in the tile
                            slots[(0 if R == 1 else w, c)][ranks[lane, j]] = (
                                w * L + groups[lane][0] + j)
            if R == 8:
                counts[w] = run
        segs = ([(0, c, counts[:, c].sum()) for c in range(ncls)] if R == 1
                else [(w, c, counts[w, c]) for w in range(8)
                      for c in range(ncls)])
        for row, c, n in segs:
            idx = slots.pop((row, c))
            fill_vec(buf, (t * NPAY * R + row) * W + c * K, R * W,
                     min(int(n), K), K,
                     lambda q, col: (1.0 if q == 6 else
                                     _stored(pay[q][t * B + idx[col]],
                                             canon)))
    return buf.done(), aout.done()


def cleanup_vec(inc, Ke, T, axes, canon, settled=True):
    """cleanup_kernel<len(axes), canon> on a numpy (NT, 7, 8, W) buffer:
    returns (settled or None, tuple of 2 len(axes) extras)."""
    NT, _, _, W = inc.shape
    assert tuple(axes) == tuple(range(3 - len(axes), 3))
    ncls = 1 + 2 * len(axes)
    caps = [W] + [Ke] * (ncls - 1)
    outs = [_Out((NT, NPAY, 8, cap)) if c or settled else None
            for c, cap in enumerate(caps)]
    flat = inc.reshape(-1)
    ipstride = 8 * W
    for t in range(NT):
        counts = np.zeros((8, ncls), np.int64)
        cols = {}
        for r in range(8):
            start = (t * NPAY * 8 + r) * W
            run = [0] * ncls
            cols.update({(r, c): {} for c in range(ncls)})
            for groups in row_walk(start, W):
                flags = np.stack([load(flat, start + 6 * ipstride, g)
                                  for g in groups])
                coords = np.stack([[load(flat, start + a * ipstride, g)
                                    for a in axes] for g in groups])
                cls = np.full((LANES, VEC), -1)
                for lane, j in zip(*np.nonzero(flags > 0.5)):
                    cls[lane, j] = 0
                    for i, cc in enumerate(coords[lane, :, j]):
                        if cc < 0 or cc >= T:
                            cls[lane, j] = 1 + 2 * i + int(cc >= T)
                            break
                if not (cls >= 0).any():
                    continue
                for c in range(ncls):
                    ranks, run[c] = rank_class(cls, c, run[c])
                    for lane, j in zip(*np.nonzero(cls == c)):
                        if ranks[lane, j] < caps[c] and outs[c] is not None:
                            cols[(r, c)][ranks[lane, j]] = (
                                groups[lane][0] + j)
            counts[r] = run
        for r in range(8):
            for c in range(ncls):
                if outs[c] is None:
                    continue
                idx = cols[(r, c)]
                fill_vec(outs[c], (t * NPAY * 8 + r) * caps[c], 8 * caps[c],
                         min(int(counts[r, c]), caps[c]), caps[c],
                         lambda q, col: _stored(inc[t, q, r, idx[col]],
                                                canon))
    done = [o.done() if o is not None else None for o in outs]
    return done[0], tuple(done[1:])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _state(B, NT=2, seed=0, flood=None):
    """80% alive over [-1.5, T+1.5); in tile 0 the first `flood` slots of
    every row leave through -x (past the caps); every 7th vy and 9th y is
    -0.0 (the one-hot kernels store it as +0.0)."""
    rng = np.random.default_rng(seed)
    L = B // 8
    alive = (rng.uniform(size=(NT, B)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, T + 1.5, (NT, B)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(NT, B)).astype(np.float32)
               for _ in range(3)]
    if flood:
        planes[0][0].reshape(8, L)[:, :flood] = -0.5
        alive[0].reshape(8, L)[:, :flood] = 1.0
    planes[4][:, ::7] = -0.0
    planes[1][:, ::9] = -0.0
    return alive, planes


def _runs(W_run, n_runs, NT=2, seed=0):
    """A cleanup input (NT, 7, 8, n_runs * W_run): each row's runs hold a
    valid prefix of random length (flag 1.0, coordinates over [-1.5,
    T+1.5)), zeros beyond; some -0.0 payloads."""
    rng = np.random.default_rng(seed)
    W = W_run * n_runs
    inc = np.zeros((NT, NPAY, 8, W), np.float32)
    for t in range(NT):
        for r in range(8):
            for b in range(n_runs):
                n = int(rng.integers(0, W_run + 1))
                cols = slice(b * W_run, b * W_run + n)
                inc[t, :3, r, cols] = rng.uniform(-1.5, T + 1.5, (3, n))
                inc[t, 3:6, r, cols] = rng.normal(size=(3, n))
                inc[t, 6, r, cols] = 1.0
    inc[:, 4, :, ::5] = -0.0
    return inc


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _eq(mine, theirs):
    np.testing.assert_array_equal(_bits(mine), _bits(theirs))


def _pinc_buf(buf):
    """(NT, 7, R, W) -> pinc_tpu's one-hot layout (NT, 8, R*W)."""
    n, _, R, W = buf.shape
    return np.concatenate([buf, np.zeros((n, 1, R, W), np.float32)],
                          1).reshape(n, 8, R * W)


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# against pinc_tpu
# ---------------------------------------------------------------------------

# (B, kind, R, cap, flood, canon, pinc_tpu call)
EXTRACTS = {
    "gather compact L=2176": (17408, ANY, 8, 128, 200, False,
                              lambda a, p: _jax(
                                  "xc", pgx.extract_compact_rows_g, KU=128,
                                  T=T)(a, p)),
    "gather dim0 L=256": (2048, 0, 8, 128, 200, False,
                          lambda a, p: _jax("x0", pgx.extract_rows_g,
                                            coord_d=0, Ks=128, T=T)(
                              alive=a, planes=p)),
    "gather all L=128": (1024, ALL, 8, 128, None, False,
                         lambda a, p: _jax("xa", pgx.extract_all_rows_g,
                                           Ks=128, T=T)(a, p)),
    "onehot all L=960": (7680, ALL, 8, 64, 100, True,
                         lambda a, p: _jax("oa", pex.extract_all_rows, Ks=64,
                                           T=T)(p, a)),
    "onehot fused L=80": (640, 1, 1, 32, 40, True,
                          lambda a, p: _jax("of", pex.extract_fused, K=32,
                                            T=T)(p[1], a, p)),
    "onehot rows L=81": (648, 0, 8, 16, 40, True,
                         lambda a, p: _jax("or", pex.extract_rows, Ks=16,
                                           T=T)(p[0], a, p)),
}


@pytest.mark.parametrize("case", list(EXTRACTS))
def test_extract_emulation_matches_pinc_tpu(case):
    B, kind, R, cap, flood, canon, theirs = EXTRACTS[case]
    alive, planes = _state(B, flood=flood)
    coord = planes[kind] if kind in (0, 1, 2) else None
    buf, aout = extract_vec(coord, alive, planes, kind, R, cap, T, canon)
    jbuf, jal = theirs(jnp.asarray(alive),
                       tuple(jnp.asarray(p) for p in planes))
    _eq(buf if case.startswith("gather") else _pinc_buf(buf), jbuf)
    _eq(aout, jal)
    if flood:                  # tile 0's first run overflows its cap
        assert buf[0, 6, :, :cap].sum() == (8 if R == 8 else 1) * cap


def test_cleanup_emulation_matches_pinc_tpu_gather():
    """K10 on the compact extract of the bench deck's row (L = 2176, KU =
    128, tile 0 flooded), all three axes."""
    alive, planes = _state(17408, flood=200)
    buf, _ = gx.extract_compact_rows_g_plain(
        _torch(alive), tuple(map(_torch, planes)), 128, T)
    inc = buf.numpy()
    settled, extras = cleanup_vec(inc, 128, T, (0, 1, 2), False)
    js, je = _jax("c012", pgx.cleanup_rows_g, Ke=128, T=T, axes=(0, 1, 2))(
        jnp.asarray(inc))
    _eq(settled, js)
    for mine, theirs in zip(extras, je):
        _eq(mine, theirs)
    # every column of the compact buffer is out on some axis
    assert settled[:, 6].sum() == 0 and inc[:, 6].sum() > 0
    _, faces = cleanup_vec(inc, 128, T, (0, 1, 2), False, settled=False)
    for mine, theirs in zip(faces, je):
        _eq(mine, theirs)


def test_cleanup_emulation_matches_pinc_tpu_onehot():
    """K11's cleanup (canon) at W = 18 (rows start off a 16-byte boundary)
    and an edge cap of 3 that overflows."""
    inc = _runs(9, 2)
    settled, extras = cleanup_vec(inc, 3, T, (1, 2), True)
    js, je = _jax("oc", pex.cleanup_rows, W=18, Ke=3, T=T, axes=(1, 2))(
        jnp.asarray(_pinc_buf(inc)))
    _eq(_pinc_buf(settled), js)
    for mine, theirs in zip(extras, je):
        _eq(_pinc_buf(mine), theirs)
    assert any(e[:, 6].sum(-1).max() == 3 for e in extras)      # overflow


# ---------------------------------------------------------------------------
# against the port's plain versions, every shape
# ---------------------------------------------------------------------------

ROWS = [2176, 960, 80, 81, 83]


@pytest.mark.parametrize("L", ROWS)
@pytest.mark.parametrize("kind, R", [(2, 8), (ALL, 8), (ANY, 8), (0, 1),
                                     (ALL, 1)])
def test_extract_emulation_matches_plain(kind, R, L):
    NT = 1 if L > 1000 else 2
    cap = 32 if R == 8 else 64
    alive, planes = _state(8 * L, NT=NT, seed=L + kind, flood=min(L, 48))
    coord = planes[kind] if kind in (0, 1, 2) else None
    ta, tp = _torch(alive), tuple(map(_torch, planes))
    canon = kind != ANY and (R == 1 or L % 128 != 0)   # the one-hot's
    if canon:
        tc = tp[kind] if coord is not None else None
        want = ox._extract_plain(tc, ta, tp, kind, R, cap, T)
    else:
        want = gx._extract_plain(ta, tp, kind, cap, T)
    got = extract_vec(coord, alive, planes, kind, R, cap, T, canon)
    for mine, theirs in zip(got, want):
        _eq(mine, theirs.numpy())


@pytest.mark.parametrize("W_run, n_runs, Ke", [(128, 3, 128), (64, 2, 16),
                                               (9, 2, 3), (65, 2, 5)])
@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2), (2,)])
def test_cleanup_emulation_matches_plain(axes, W_run, n_runs, Ke):
    inc = _runs(W_run, n_runs, seed=W_run + len(axes))
    canon = W_run % 128 != 0
    want = gx.cleanup_rows_g_plain(_torch(inc), Ke, T, axes, canon=canon)
    got = cleanup_vec(inc, Ke, T, axes, canon)
    _eq(got[0], want[0].numpy())
    for mine, theirs in zip(got[1], want[1]):
        _eq(mine, theirs.numpy())
