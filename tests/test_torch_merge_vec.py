"""The gather merge kernel (K9, pinc_tpu_torch csrc/gather_exchange.cu
merge_rows_kernel), emulated in numpy and held bit for bit against
pinc_tpu's Pallas merge_rows_g in interpret mode and against the port's
plain version.

A CUDA kernel cannot run on the CPU, so this file keeps its arithmetic
testable.  The emulation does what the kernel does, step by step:

1. each warp counts its row's arrivals a_r per block from the flag plane,
   in the 16-byte lane groups of one RowWalk over the span the blocks
   cover;
2. it walks its row's alive in 16-byte lane groups, a chunk of 128 slots
   at a time, turns the chunk's four ballots (one per slot of a lane's
   group) into four words of 32 free-slot bits, and places pass 0 as it
   goes: the free slot of rank k < a_r (lane l: slot 32 s + l of word s)
   takes the row's arrival k; it stops once the a_r-th free slot is
   placed or the row ends;
3. spill pass p = 1..7 runs only while the tile has leftovers: row r
   rescans its row from slot 0 in 32-slot chunks (lane l: slot 32 i + l,
   the lane that placed it in pass 0, so it reads its own alive writes),
   and its free slots take the leftovers of row (r - p) % 8 from that
   row's consumed count on; the counts are updated after the pass.

It asserts that every 16-byte load starts on a 16-byte boundary, that the
four words are the chunk's free slots, that a slot read in a spill pass
was written only by the lane that reads it, and that each written slot is
a placed one, written once (no other slot is touched).

Cases: rows 0-3 full (spill and drops), a full tile, a tile with no
arrivals, rows whose free slots run out in pass 0 and in a spill pass, and
the block tables of the two drivers (per axis: 2 blocks; fused: 8).  The
JAX side is jitted once per shape (interpret-mode Pallas compiles
slowly): L = 256 with the 2-block table and L = 2176 with the 8-block
table, the cases packed as tiles of one call; the port's plain version
covers L = 2176, 256 and 128 with both tables.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pinc_tpu.ops import pallas_gather_exchange as pgx
from pinc_tpu_torch.ops import gather_exchange as gx
from test_torch_exchange_vec import (LANES, VEC, _eq, _torch, load,
                                     rank_class, row_walk)

NPAY = 7
ROWS = 8

# the drivers' block tables (gather_exchange.exchange_dim_g and
# rebucket_exchange_all_rows_g at K = 256: Ks = 128, Ke = 128)
TABLE2 = ((0, 128), (128, 128))
TABLE8 = tuple(zip((0, 256, 768, 896, 1024, 1152, 1280, 1408),
                   (256, 512, 128, 128, 128, 128, 128, 128)))

_JIT = {}


def _jax_merge(blocks):
    if blocks not in _JIT:
        _JIT[blocks] = jax.jit(partial(pgx.merge_rows_g, blocks=blocks,
                                       interpret=True))
    return _JIT[blocks]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _spread8(x):
    """merge_rows_kernel's spread8: bits 0..7 of x to bits 0, 4, ..., 28."""
    x &= 0xFF
    x = (x ^ (x << 12)) & 0x000F000F
    x = (x ^ (x << 6)) & 0x03030303
    return (x ^ (x << 3)) & 0x11111111


def merge_vec(alive, inc, planes, blocks):
    """merge_rows_kernel on numpy arrays: alive (NT, B), inc (NT, 7, 8, KT),
    6 planes (NT, B).  Returns (planes', alive', stats) without touching
    the inputs; stats: per tile the counts, the chunks the pass-0 walk
    read and the placements of each row in each pass."""
    NT, B = alive.shape
    L = B // ROWS
    KT = inc.shape[-1]
    fa = np.ascontiguousarray(alive).reshape(-1)
    finc = np.ascontiguousarray(inc).reshape(-1)
    out_a = fa.copy()
    outs = [np.ascontiguousarray(p).reshape(-1).copy() for p in planes]
    writes = np.zeros(fa.size, np.int64)
    lo = min(o for o, _ in blocks)
    hi = max(o + w for o, w in blocks)
    stats = []
    for t in range(NT):
        # (1) arrivals per row and block
        nb = np.zeros((ROWS, len(blocks)), np.int64)
        for r in range(ROWS):
            start = ((t * NPAY + 6) * ROWS + r) * KT + lo
            for groups in row_walk(start, hi - lo):
                for g in groups:
                    f = load(finc, start, g)
                    for j in range(g[1]):
                        if f[j] > 0.5:
                            col = lo + g[0] + j
                            nb[r] += [o <= col < o + w for o, w in blocks]
        narr = nb.sum(1).tolist()
        st_t = dict(narr=narr)
        stats.append(st_t)
        if sum(narr) == 0:
            continue
        nb_end = np.cumsum(nb, 1)

        def place(slot, s, a, lane):
            """Arrival rank a of source row s into slot (flat), by lane."""
            assert slot % 32 == lane
            b = int((a >= nb_end[s][:-1]).sum())
            a -= int(nb_end[s][b - 1]) if b else 0
            assert 0 <= a < nb[s, b]
            col = blocks[b][0] + a
            assert fa[slot] <= 0.5
            for q in range(6):
                outs[q][slot] = finc[((t * NPAY + q) * ROWS + s) * KT + col]
            out_a[slot] = 1.0
            writes[slot] += 1

        # (2) the walk: pass 0 placed as the free slots are ranked
        run, counted = [0] * ROWS, [0] * ROWS
        for r in range(ROWS):
            if not narr[r]:
                continue
            base = t * B + r * L
            assert base % VEC == 0            # rows on 16-byte boundaries
            for groups in row_walk(base, L):
                c0 = groups[0][0]             # the chunk's first slot
                # four ballots, one per slot of a lane's group, to four
                # words of 32 slots (bit 4 i + j of word s: lane 8 s + i's
                # slot j)
                m = [0] * VEC
                for lane, g in enumerate(groups):
                    a = load(fa, base, g)
                    for j in range(g[1]):
                        m[j] |= int(a[j] <= 0.5) << lane
                w = [sum(_spread8(m[j] >> (8 * s)) << j for j in range(VEC))
                     for s in range(VEC)]
                for s in range(VEC):
                    want = sum(int(fa[base + c0 + 32 * s + i] <= 0.5) << i
                               for i in range(32) if c0 + 32 * s + i < L)
                    assert w[s] == want
                    for lane in range(LANES):       # lane: slot 32 s + lane
                        rank = run[r] + bin(w[s] & ((1 << lane) - 1)).count(
                            "1")
                        if w[s] >> lane & 1 and rank < narr[r]:
                            place(base + c0 + 32 * s + lane, r, rank, lane)
                    run[r] += bin(w[s]).count("1")
                counted[r] += 1
                if run[r] >= narr[r]:
                    break
        consumed = [min(f, a) for f, a in zip(run, narr)]
        LO = sum(a - c for a, c in zip(narr, consumed))
        took = [[0] * ROWS for _ in range(ROWS)]   # [row][pass]
        for r in range(ROWS):
            took[r][0] = consumed[r]
        free_r = (fa[t * B:(t + 1) * B] <= 0.5).reshape(ROWS, L).sum(1)
        st_t.update(found=list(run), LO=LO, counted=counted, took=took,
                    free=free_r.tolist())
        # (3) the spill passes, while the tile has leftovers
        for p in range(1, ROWS):
            if sum(narr) == sum(consumed):
                break
            taken = [0] * ROWS
            for r in range(ROWS):
                s = (r - p) % ROWS
                first = consumed[s]
                avail = narr[s] - first
                frun = 0
                base = t * B + r * L
                for c0 in range(0, L, 32):
                    if frun >= avail:
                        break
                    free = [out_a[base + c0 + lane] <= 0.5
                            for lane in range(LANES)]
                    for lane in range(LANES):
                        frank = frun + sum(free[:lane])
                        if free[lane] and frank < avail:
                            place(base + c0 + lane, s, first + frank, lane)
                    frun += sum(free)
                taken[s] = min(frun, avail) if avail > 0 else 0
                took[r][p] = taken[s]
            for s in range(ROWS):
                consumed[s] += taken[s]
    # only placed slots are written, each once
    assert writes.max(initial=0) <= 1
    placed = (fa <= 0.5) & (out_a == 1.0) & (writes == 1)
    assert np.array_equal(writes == 1, placed)
    return ([o.reshape(NT, B) for o in outs], out_a.reshape(NT, B), stats)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _arrivals(counts, blocks, KT, seed):
    """inc (NT, 7, 8, KT): block b of row r of tile t holds counts[t, r, b]
    valid entries (flag 1.0) as a prefix, zeros beyond; random payloads,
    some -0.0."""
    rng = np.random.default_rng(seed)
    NT = counts.shape[0]
    inc = np.zeros((NT, NPAY, ROWS, KT), np.float32)
    for t in range(NT):
        for r in range(ROWS):
            for b, (o, w) in enumerate(blocks):
                n = int(min(counts[t, r, b], w))
                inc[t, :6, r, o:o + n] = rng.normal(size=(6, n))
                inc[t, 6, r, o:o + n] = 1.0
    inc[:, 4, :, ::7] = -0.0
    return inc


def _free_state(free_frac, B, seed):
    """alive (NT, B): row r of tile t has a fraction free_frac[t][r] of its
    slots free (alive 0.0), the others alive; random planes, some -0.0."""
    rng = np.random.default_rng(seed)
    NT = len(free_frac)
    L = B // ROWS
    alive = np.ones((NT, ROWS, L), np.float32)
    for t in range(NT):
        for r in range(ROWS):
            alive[t, r, rng.uniform(size=L) < free_frac[t][r]] = 0.0
    planes = [rng.uniform(-1.0, 5.0, (NT, B)).astype(np.float32)
              for _ in range(6)]
    planes[3][:, ::5] = -0.0
    return alive.reshape(NT, B), planes


def _case(name, B, blocks, seed=0):
    """(alive, inc, planes) of a named case; each case is a few tiles."""
    rng = np.random.default_rng(seed)
    L = B // ROWS
    KT = max(o + w for o, w in blocks)
    nbk = len(blocks)
    widths = np.array([w for _, w in blocks])

    def draw(NT, frac):
        return rng.integers(0, (widths * frac).astype(int) + 1,
                            size=(NT, ROWS, nbk))
    if name == "rows 0-3 full":          # spill into rows 4-7, then drops
        free = [[0.0] * 4 + [min(1.0, 0.5 * widths.sum() / L)] * 4]
        counts = draw(1, 0.9)
        counts[0, :4] = widths * 0.8
    elif name == "full tile":            # every arrival dropped
        free = [[0.0] * ROWS]
        counts = draw(1, 0.5)
    elif name == "no arrivals":          # nothing written
        free = [[0.3] * ROWS]
        counts = np.zeros((1, ROWS, nbk), np.int64)
    elif name == "out mid-pass":
        # row 2 runs out in pass 0; its leftovers fill row 3's few
        # remaining slots in pass 1 and run on into row 4 in pass 2
        free = [[0.5, 0.5, 0.0, 0.0, 0.5, 0.5, 0.5, 0.5]]
        counts = np.zeros((1, ROWS, nbk), np.int64)
        counts[0, :, 0] = min(L // 16, widths[0])
        counts[0, 2, :] = widths // 2
        counts[0, 3, 0] = 0
    elif name == "bench-like":           # ~12% free, a few % arrivals
        free = [[0.12] * ROWS]
        counts = draw(1, 0.12)
    else:
        raise KeyError(name)
    alive, planes = _free_state(free, B, seed + 1)
    if name == "out mid-pass":           # row 3: a few free slots
        a = alive.reshape(1, ROWS, L)
        a[0, 2, :] = 1.0
        a[0, 2, 7] = 0.0
        a[0, 3, :] = 1.0
        a[0, 3, [3, 64, L - 1]] = 0.0
    inc = _arrivals(counts, blocks, KT, seed + 2)
    return alive, inc, planes


CASES = ["rows 0-3 full", "full tile", "no arrivals", "out mid-pass",
         "bench-like"]


def _packed(B, blocks, names, seed):
    parts = [_case(n, B, blocks, seed + 10 * i) for i, n in enumerate(names)]
    return tuple(np.concatenate(x, 0) for x in zip(*[
        (a, i) for a, i, _ in parts])) + (
        [np.concatenate([p[k] for _, _, p in parts], 0) for k in range(6)],)


def _check_stats(stats, names):
    """What each named tile must have exercised."""
    for st_t, name in zip(stats, names):
        narr = st_t["narr"]
        if name == "no arrivals":
            assert sum(narr) == 0
            continue
        took = st_t["took"]
        placed = [sum(row) for row in took]
        if name == "full tile":
            assert st_t["LO"] == sum(narr) > 0 and sum(placed) == 0
        if name == "rows 0-3 full":
            assert st_t["LO"] > 0 and sum(placed) < sum(narr)     # drops
            assert all(placed[r] > 0 for r in range(4, 8))
            if any(st_t["free"][r] > narr[r] for r in range(4, 8)):
                assert any(sum(took[r][1:]) > 0                   # spill
                           for r in range(4, 8))
        if name == "out mid-pass":
            assert st_t["found"][2] < narr[2] and st_t["LO"] > 0
            # row 3 filled its 3 slots in pass 1, row 4 took the rest of
            # row 2's leftovers in pass 2
            assert took[3][1] == 3 and took[4][2] > 0
        # the pass-0 walk stops at the chunk of the row's a_r-th free slot
        if st_t["LO"] == 0:
            assert all(f >= a for f, a in zip(st_t["found"], narr))


def _against(got, want):
    (gp, ga), (wp, wa) = got, want
    for mine, theirs in zip(gp, wp):
        _eq(mine, theirs)
    _eq(ga, wa)


# ---------------------------------------------------------------------------
# against pinc_tpu and the port's plain version
# ---------------------------------------------------------------------------

# (B, table, the cases packed as tiles)
JAX_SHAPES = {
    "L=256 per-axis table": (2048, TABLE2, CASES[:4]),
    "L=2176 fused table": (17408, TABLE8, ["bench-like", "rows 0-3 full"]),
}


@pytest.mark.parametrize("shape", list(JAX_SHAPES))
def test_merge_emulation_matches_pinc_tpu(shape):
    B, blocks, names = JAX_SHAPES[shape]
    alive, inc, planes = _packed(B, blocks, names, seed=len(names))
    gp, ga, stats = merge_vec(alive, inc, planes, blocks)
    _check_stats(stats, names)
    jp, ja = _jax_merge(blocks)(jnp.asarray(alive), jnp.asarray(inc),
                                tuple(jnp.asarray(p) for p in planes))
    _against((gp, ga), (jp, ja))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("table", ["per-axis", "fused"])
@pytest.mark.parametrize("L", [2176, 256, 128])
def test_merge_emulation_matches_plain(L, table, case):
    blocks = TABLE2 if table == "per-axis" else TABLE8
    alive, inc, planes = _case(case, 8 * L, blocks, seed=L)
    gp, ga, stats = merge_vec(alive, inc, planes, blocks)
    _check_stats(stats, [case])
    ta, tp = _torch(alive), tuple(map(_torch, planes))
    wp, wa = gx.merge_rows_g_plain(ta, _torch(inc), tp, blocks)
    _against((gp, ga), ([p.numpy() for p in wp], wa.numpy()))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.booleans(), min_size=128, max_size=128))
def test_pass0_words_are_the_free_slots(free):
    """A chunk's four ballots (ballot j: bit l set where lane l's slot j,
    slot 4 l + j, is free), spread8 into four words, give word s's bit i
    exactly where slot 32 s + i is free: lane l of pass 0 then owns slot
    32 s + l, the slot of the spill passes' lane l."""
    m = [sum(int(free[VEC * lane + j]) << lane for lane in range(LANES))
         for j in range(VEC)]
    for s in range(VEC):
        w = sum(_spread8(m[j] >> (8 * s)) << j for j in range(VEC))
        assert w == sum(int(free[32 * s + i]) << i for i in range(32))
