"""The one-hot merge kernel (K11, pinc_tpu_torch csrc/onehot_exchange.cu
merge_kernel<R>), emulated in numpy and held bit for bit against
pinc_tpu's Pallas merge_rows, merge_all_rows (R = 8) and merge_fused
(R = 1) in interpret mode and against the port's plain versions.

A CUDA kernel cannot run on the CPU, so this file keeps its arithmetic
testable.  The emulation does what the kernel does, step by step:

1. the flags are counted per block in the 16-byte lane groups of one
   RowWalk over the span the blocks cover: for R = 8 each warp its row;
   for R = 1 the tile's one row, chunk i of the walk taken by warp i % 8
   and the warps' counts summed.  Every set flag counts, wherever it lies
   in its block; the counts' prefix gives each rank its block;
2. R = 8: each warp walks its row's alive in RowWalk groups (a scalar
   head where the row starts off a 16-byte boundary), turns a chunk's four
   ballots into four words of 32 free-slot bits and places as it ranks:
   lane l takes slot c0 + 32 s + l of word s (c0 the chunk's first slot),
   free rank k below the row's arrivals taking arrival k, placed if that
   column's flag is set, copied as x + 0.0; the walk stops once the row's
   arrivals are ranked.  R = 1: the 8 warps walk the tile's alive in
   rounds of 8 chunks, chunk i of a round to warp i: the round's free
   counts are summed (a barrier), each warp places its chunk from the
   count of the chunks before it, and the rounds stop once the tile's
   arrivals are ranked.

It asserts that every 16-byte load starts on a 16-byte boundary, that the
flag chunks are each counted by one warp, that the words are the chunk's
free slots, that a lane places only its slot of a word, and that only
placed slots are written, each once.

Cases (tests/test_torch_cuda.py's merge_inputs, which the card tests use
too): rows that start off a 16-byte boundary (L % 4 != 0), buffers whose
rows do too (KT % 4 != 0), tables of 1, 2, 3 (with a gap, out of column
order) and 8 runs, rows and tiles with more arrivals than free slots
(drops), flags that are not a prefix of their run, and -0.0 payloads.
The JAX side is jitted once per function at B = 648 (rows of 81 slots).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu_torch.ops import onehot_exchange as ox
from test_torch_cuda import MERGE_CASES as CASES
from test_torch_cuda import MERGE_TABLES as TABLES
from test_torch_cuda import merge_inputs
from test_torch_exchange_vec import (LANES, VEC, _eq, _pinc_buf, _torch,
                                     load, row_walk)
from test_torch_merge_vec import _spread8

ROWS = 8
NPAY = 7


def _popc(x):
    return bin(x).count("1")


def _words(flat, start, groups):
    """A chunk's free slots as merge_kernel forms them: four ballots (bit l
    of ballot j: lane l's slot j is free), spread8 into four 32-slot
    words."""
    m = [0] * VEC
    for lane, g in enumerate(groups):
        a = load(flat, start, g)
        for j in range(g[1]):
            m[j] |= int(a[j] <= 0.5) << lane
    return [sum(_spread8(m[j] >> (8 * s)) << j for j in range(VEC))
            for s in range(VEC)]


def onehot_merge_vec(alive, inc, planes, blocks):
    """merge_kernel<R> on numpy arrays: alive (NT, B), inc (NT, 7, R, KT),
    6 planes (NT, B), R = inc.shape[2].  Returns (planes', alive', stats)
    without touching the inputs; stats per tile: the arrivals per segment
    and the alive chunks read per warp (R = 8) or the rounds read (R = 1)."""
    NT, B = alive.shape
    R, KT = inc.shape[2], inc.shape[3]
    L = B // ROWS
    fa = np.ascontiguousarray(alive).reshape(-1)
    finc = np.ascontiguousarray(inc).reshape(-1)
    out_a = fa.copy()
    outs = [np.ascontiguousarray(p).reshape(-1).copy() for p in planes]
    writes = np.zeros(fa.size, np.int64)
    lo = min(o for o, _ in blocks)
    hi = max(o + w for o, w in blocks)
    stats = []
    for t in range(NT):
        # (1) arrivals per segment and block
        nb = np.zeros((R, len(blocks)), np.int64)
        for r in range(R):
            start = ((t * NPAY + 6) * R + r) * KT + lo
            chunks = row_walk(start, hi - lo) if lo < hi else []
            counted_by = [i % ROWS if R == 1 else r for i in range(len(chunks))]
            assert R == ROWS or sorted(set(counted_by)) == list(
                range(min(ROWS, len(chunks))))
            for groups in chunks:
                for g in groups:
                    f = load(finc, start, g)
                    for j in range(g[1]):
                        if f[j] > 0.5:
                            col = lo + g[0] + j
                            nb[r] += [o <= col < o + w for o, w in blocks]
        nbe = np.cumsum(nb, 1)
        narr = nbe[:, -1].tolist()
        st_t = dict(narr=narr, read=[0] * ROWS)
        stats.append(st_t)

        def place(base, k, r, rank, lane, c0, s):
            """Slot k of the segment at base, free rank `rank` of segment
            r, by lane."""
            assert k - c0 - 32 * s == lane
            slot = base + k
            b = int((rank >= nbe[r][:-1]).sum())
            col = blocks[b][0] + rank - (int(nbe[r][b - 1]) if b else 0)
            assert blocks[b][0] <= col < blocks[b][0] + blocks[b][1]
            src = [((t * NPAY + q) * R + r) * KT + col for q in range(NPAY)]
            if not finc[src[6]] > 0.5:
                return
            assert fa[slot] <= 0.5
            for q in range(6):
                outs[q][slot] = np.float32(finc[src[q]]) + np.float32(0.0)
            out_a[slot] = 1.0
            writes[slot] += 1

        def place_chunk(w, c0, base, r, run):
            for s in range(VEC):
                for lane in range(LANES):
                    rank = run + _popc(w[s] & ((1 << lane) - 1))
                    if w[s] >> lane & 1 and rank < narr[r]:
                        place(base, c0 + 32 * s + lane, r, rank, lane, c0,
                              s)
                run += _popc(w[s])
            return run

        def checked_words(base, groups):
            w = _words(fa, base, groups)
            c0 = groups[0][0]                 # the chunk's first slot
            end = max(off + n for off, n in groups if n)
            for s in range(VEC):
                want = sum(int(fa[base + c0 + 32 * s + i] <= 0.5) << i
                           for i in range(32) if c0 + 32 * s + i < end)
                assert w[s] == want
            return w, c0

        # (2) placing
        if R == ROWS:
            for r in range(ROWS):
                if not narr[r]:
                    continue
                base, run = t * B + r * L, 0
                for groups in row_walk(base, L):
                    w, c0 = checked_words(base, groups)
                    st_t["read"][r] += 1
                    run = place_chunk(w, c0, base, r, run)
                    if run >= narr[r]:
                        break
        else:
            # rounds of 8 chunks of the tile, chunk i of a round to warp i;
            # a round's free counts, then each warp places its chunk
            base, before = t * B, 0
            chunks = row_walk(base, B)
            st_t["read"] = 0
            for r0 in range(0, len(chunks), ROWS):
                if before >= narr[0]:
                    break
                words = [checked_words(base, g) for g in chunks[r0:r0 + ROWS]]
                counts = [sum(_popc(x) for x in w) for w, _ in words]
                for warp, (w, c0) in enumerate(words):
                    place_chunk(w, c0, base, 0, before + sum(counts[:warp]))
                before += sum(counts)
                st_t["read"] += 1
    assert writes.max(initial=0) <= 1
    assert np.array_equal(writes == 1, (fa <= 0.5) & (out_a == 1.0)
                          & (writes == 1))
    return ([o.reshape(NT, B) for o in outs], out_a.reshape(NT, B), stats)


def _against(got, want):
    (gp, ga), (wp, wa) = got, want
    for mine, theirs in zip(gp, wp):
        _eq(mine, theirs)
    _eq(ga, wa)


def _plain(alive, inc, planes, blocks):
    tp = tuple(_torch(p.copy()) for p in planes)
    wp, wa = ox._merge_plain(_torch(alive.copy()), _torch(inc), tp, blocks)
    return [p.numpy() for p in wp], wa.numpy()


def _check_case(alive, inc, stats, case):
    """What each named case must have exercised."""
    R = inc.shape[2]
    L = alive.shape[1] // ROWS
    free = (alive <= 0.5).reshape(alive.shape[0], R, -1).sum(-1)
    arrivals = (inc[:, 6] > 0.5).sum(-1)
    if case == "overflow":
        assert (arrivals > free).any()
    if case == "no arrivals":
        assert all(sum(st["narr"]) == 0 for st in stats)
    if case == "roomy" and R == ROWS and L > 2 * VEC * LANES:
        # the walk stops at the chunk of a row's last arrival
        assert any(r < -(-L // (VEC * LANES)) for st in stats
                   for r, n in zip(st["read"], st["narr"]) if n)
    if case == "roomy" and R == 1 and ROWS * L > 2 * ROWS * VEC * LANES:
        # the rounds stop at the round of the tile's last arrival
        assert any(st["read"] < -(-ROWS * L // (ROWS * VEC * LANES))
                   for st in stats)


# ---------------------------------------------------------------------------
# against pinc_tpu (interpret mode) and the port's plain version
# ---------------------------------------------------------------------------

_JIT = {}


def _jax(name, fn, **static):
    key = (name,) + tuple(sorted(static.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(partial(fn, interpret=True, **static))
    return _JIT[key]


def _packed(B, R, table, names, seed):
    parts = [merge_inputs(B, R, table, n, seed + 10 * i)
             for i, n in enumerate(names)]
    blocks = parts[0][3]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            [np.concatenate([p[2][k] for p in parts]) for k in range(6)],
            blocks)


JAX_CALLS = {
    "merge_rows": (8, "two", lambda blocks: _jax(
        "mr", pex.merge_rows, Ks=blocks[0][1])),
    "merge_all_rows": (8, "eight", lambda blocks: _jax(
        "ma", pex.merge_all_rows, blocks=blocks)),
    "merge_fused": (1, "two", lambda blocks: _jax(
        "mf", pex.merge_fused, K=blocks[0][1])),
}


@pytest.mark.parametrize("fn", list(JAX_CALLS))
def test_onehot_merge_emulation_matches_pinc_tpu(fn):
    """B = 648 (rows of 81 slots, off a 16-byte boundary from row 1 on),
    buffers of 13-column runs; the cases packed as tiles of one call."""
    R, table, make = JAX_CALLS[fn]
    alive, inc, planes, blocks = _packed(648, R, table, list(CASES), seed=7)
    gp, ga, stats = onehot_merge_vec(alive, inc, planes, blocks)
    jp, ja = make(blocks)(jnp.asarray(alive), jnp.asarray(
        _pinc_buf(inc)), tuple(jnp.asarray(p) for p in planes))
    _against((gp, ga), (jp, ja))
    _against((gp, ga), _plain(alive, inc, planes, blocks))
    placed = ga.sum() - alive.sum()
    assert 0 < placed < (inc[:, 6] > 0.5).sum()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("R, L", [(8, 81), (8, 323), (8, 256), (1, 81),
                                  (1, 323), (1, 130)])
def test_onehot_merge_emulation_matches_plain(R, L, table, case):
    alive, inc, planes, blocks = merge_inputs(8 * L, R, table, case,
                                              seed=L + R)
    gp, ga, stats = onehot_merge_vec(alive, inc, planes, blocks)
    _check_case(alive, inc, stats, case)
    _against((gp, ga), _plain(alive, inc, planes, blocks))
