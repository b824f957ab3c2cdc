"""The one-hot exchange's ranked merge and extract (K11, pinc_tpu_torch
csrc/onehot_exchange.cu merge_ranked_kernel and extract_ranked_kernel),
emulated in numpy and held bit for bit against pinc_tpu's Pallas ``merge``
and ``extract`` in interpret mode and against the port's plain versions
(``ox.merge_plain``, ``ox.extract_plain``).  The extract's emulation and
its cases are described where they start, below the merge's.

A CUDA kernel cannot run on the CPU, so this file keeps its walk testable.
The emulation does what the kernel does, one block a tile:

1. the flag row is read (in 16-byte groups where the buffer's rows allow)
   and kept in the staged block; n_m and n_p count the set flags of the
   minus run [0, K) and the plus run [K, 2K);
2. with ``active``, each window of 2048 chunks is listed by the 8 warps,
   warp v the set flags of chunks [w0 + 256 v, w0 + 256 v + 256) in order
   into its part of the list;
3. the block stages columns [0, n_m) and [K, K + n_p) of the six payload
   rows (rounded up to whole 16-byte groups where the rows and K allow);
   every other payload entry of the staged block stays unset (NaN here);
4. the items: without ``active`` the tile's frank row as a scalar head up
   to its first 16-byte boundary, 16-byte groups and a scalar tail; with
   ``active`` the listed chunks, item q part q - o ipc of list entry o =
   q // ipc (ipc parts a chunk), found through the warps' prefix counts:
   16-byte groups where CB % 4 == 0 and the row is 16-byte aligned, else
   single slots;
5. a slot with rank f < n_m takes column f, n_m <= f < n_m + n_p column K
   + f - n_m, placed (x + 0.0, alive = 1) if that column's staged flag is
   set; a 16-byte item with a placed slot reads its group of the six
   planes and alive, replaces the placed slots and writes the group back
   whole, a scalar item stores its slot.

It asserts that every 16-byte load of frank and every 16-byte group of
the planes starts on a 16-byte boundary, that the walk visits each slot
of the walked chunks (all, without ``active``) exactly once, that a slot
is written at most once, and that a placed slot reads only staged
columns.

Cases: B = 100 (one chunk of 100 slots) and 2100 (chunks of 4) against
pinc_tpu and the plain version; ``active`` from the ranks, None, and half
of the tiles' chunks off; more arrivals than free slots; free ranks
permuted within a tile (not monotone in slot order); two slots sharing a
rank.  Against the plain version only (pinc_tpu's interpret mode would run
B grid steps a tile): B = 2101 (one-slot chunks, two windows of the list,
rows off a 16-byte boundary) and B = 102 (one chunk of 102 slots, rows
off a 16-byte boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.ops import pallas_exchange as pex
from pinc_tpu_torch.ops import onehot_exchange as ox
from test_torch_onehot_exchange import (NT, _eq, _jax, _pinc_buf, _ranks,
                                        _room, _state)

K = 16              # the runs' cap: buffers of K2 = 32 columns
WARPS = 8
VEC = 4             # slots of one 16-byte access
SPAN = 256          # kActSpan: chunks a warp lists in a window
WINDOW = WARPS * SPAN


def _items(B, CB, fr0, listed, pre, lst):
    """The walk's items [(first slot, width)] of one tile: fr0 the word
    offset of the tile's frank row from a 16-byte boundary."""
    if not listed:
        h = min(B, (VEC - fr0 % VEC) % VEC)
        ng = (B - h) // VEC
        n = B - (VEC - 1) * ng
        out = []
        for q in range(n):
            if q < h:
                out.append((q, 1))
            elif q < h + ng:
                out.append((h + VEC * (q - h), VEC))
            else:
                out.append((q + (VEC - 1) * ng, 1))
        return out
    width = VEC if CB % VEC == 0 and fr0 % VEC == 0 else 1
    ipc = CB // width
    out = []
    for q in range(pre[WARPS] * ipc):
        o = q // ipc
        start = 0
        for v in range(1, WARPS):
            if o >= pre[v]:
                start = v * SPAN - pre[v]
        chunk = lst[start + o]
        assert chunk >= 0
        out.append((chunk * CB + (q - o * ipc) * width, width))
    return out


def merge_ranked_vec(frank, alive, inc, planes, active):
    """merge_ranked_kernel's walk on numpy inputs (the port's buffer
    layout (NT, 7, 1, K2)); returns (planes', alive')."""
    NT_, B = frank.shape
    K2 = inc.shape[-1]
    Kr = K2 // 2
    CB = ox._chunk(B)
    NC = B // CB
    alive = alive.copy()
    planes = [p.copy() for p in planes]
    for t in range(NT_):
        tin = inc[t, :, 0]
        stage = np.full((7, K2), np.nan, np.float32)
        stage[6] = tin[6]
        n_m = int((tin[6, :Kr] > 0.5).sum())
        n_p = int((tin[6, Kr:] > 0.5).sum())
        if K2 % VEC == 0 and Kr % VEC == 0:
            em, ep = -(-n_m // VEC) * VEC, -(-n_p // VEC) * VEC
        else:
            em, ep = n_m, n_p
        stage[:6, :em] = tin[:6, :em]
        stage[:6, Kr:Kr + ep] = tin[:6, Kr:Kr + ep]
        fr0 = t * B                         # frank starts 16-byte aligned
        fr = frank[t]
        written = np.zeros(B, bool)
        walked = np.zeros(B, np.int64)

        def column(f):
            if f < 0:
                return -1
            if f < n_m:
                col = f
            elif f - n_m < n_p:
                col = Kr + (f - n_m)
            else:
                return -1
            return col if stage[6, col] > 0.5 else -1

        def walk(items):
            for at, w in items:
                if w == VEC:
                    assert (fr0 + at) % VEC == 0       # one 16-byte load
                walked[at:at + w] += 1
                cols = [column(int(fr[at + e])) for e in range(w)]
                if max(cols) < 0:
                    continue
                # a group written whole (read, placed slots replaced), or
                # a scalar item's slot
                assert not written[at:at + w].any()
                written[at:at + w] = True
                rows = [p[t] for p in planes] + [alive[t]]
                for q, row in enumerate(rows):
                    d = row[at:at + w].copy()
                    for e, col in enumerate(cols):
                        if col >= 0:
                            assert not np.isnan(stage[:6, col]).any()
                            d[e] = (stage[q, col] + np.float32(0.0)
                                    if q < 6 else 1.0)
                    row[at:at + w] = d

        if active is None:
            walk(_items(B, CB, fr0, False, None, None))
            assert (walked == 1).all()
            continue
        want = np.zeros(B, np.int64)
        for w0 in range(0, NC, WINDOW):
            lst = np.full(WINDOW, -1)
            nlist = []
            for v in range(WARPS):
                c0 = w0 + v * SPAN
                on = [c for c in range(c0, min(c0 + SPAN, NC))
                      if active[t, c] != 0]
                lst[v * SPAN:v * SPAN + len(on)] = on
                nlist.append(len(on))
            pre = np.concatenate([[0], np.cumsum(nlist)]).tolist()
            walk(_items(B, CB, fr0, True, pre, lst))
            for c in range(w0, min(w0 + WINDOW, NC)):
                want[c * CB:(c + 1) * CB] = active[t, c] != 0
        np.testing.assert_array_equal(walked, want)
    return planes, alive


def _frank(alive, mode, rng):
    """Free ranks of the destination: in slot order, permuted within each
    tile, or in slot order with the second free slot of every tile given
    the first one's rank."""
    free = alive <= 0.5
    fr_incl = np.cumsum(free, axis=1)
    frank = np.where(free, fr_incl - 1, -1).astype(np.int32)
    for t in range(frank.shape[0]):
        slots = np.flatnonzero(free[t])
        if mode == "permuted":
            frank[t, slots] = rng.permutation(len(slots))
        elif mode == "duplicate" and len(slots) > 1:
            frank[t, slots[1]] = frank[t, slots[0]]
    return frank


def _active(frank, inc, B, mode):
    """pinc_tpu's per-chunk flags: a chunk holding a free rank below the
    tile's arrival count; "skip" turns every other tile's flags off."""
    if mode == "none":
        return None
    CB = ox._chunk(B)
    n_arr = (inc[:, 6] > 0.5).sum((-2, -1))[:, None, None]
    fr = frank.reshape(frank.shape[0], B // CB, CB)
    act = ((fr >= 0) & (fr < n_arr)).any(-1).astype(np.int32)
    if mode == "skip":
        act[::2] = 0
    return act


def _case(B, room, seed):
    """Leavers of a z sweep as arrivals (ox.extract at cap K), and the
    destination alive: half full, or full but every 40th slot (more
    arrivals than free slots)."""
    alive0, planes = _state(seed, b=B)
    rank = _ranks(planes[2], alive0, K)
    inc, _ = ox.extract(torch.from_numpy(rank), torch.from_numpy(alive0),
                        tuple(torch.from_numpy(p) for p in planes), 2 * K)
    alive = _room(seed + 1, b=B)
    if room == "full":
        alive[:] = 1.0
        alive[:, ::40] = 0.0
    return inc.numpy(), alive, planes


# (B, active, frank, room)
CASES = {"b100_flags": (100, "flags", "ranks", "half"),
         "b100_none": (100, "none", "ranks", "half"),
         "b100_skip": (100, "skip", "ranks", "half"),
         "b100_full": (100, "flags", "ranks", "full"),
         "b100_permuted": (100, "flags", "permuted", "half"),
         "b100_duplicate": (100, "none", "duplicate", "full"),
         "b2100_flags": (2100, "flags", "ranks", "half"),
         "b2100_permuted_none": (2100, "none", "permuted", "half"),
         "b2100_skip_duplicate": (2100, "skip", "duplicate", "full")}
PLAIN_CASES = {"b2101_flags": (2101, "flags", "permuted", "half"),
               "b2101_none": (2101, "none", "ranks", "half"),
               "b102_flags": (102, "flags", "duplicate", "full"),
               "b102_none": (102, "none", "permuted", "half")}


def _run(B, act_mode, frank_mode, room, seed):
    inc, alive, planes = _case(B, room, seed)
    frank = _frank(alive, frank_mode, np.random.default_rng(seed))
    act = _active(frank, inc, B, act_mode)
    got_p, got_a = merge_ranked_vec(frank, alive, inc, planes, act)
    pp, pa = ox.merge_plain(
        torch.from_numpy(frank), torch.from_numpy(alive.copy()),
        torch.from_numpy(inc), tuple(torch.from_numpy(p.copy())
                                     for p in planes),
        active=None if act is None else torch.from_numpy(act))
    for mine, plain in zip(got_p, pp):
        _eq(mine, plain.numpy())
    _eq(got_a, pa.numpy())
    placed = (got_a - alive).sum(-1)
    arrivals = (inc[:, 6] > 0.5).sum((-2, -1))
    assert placed.sum() > 0
    if room == "full":
        assert (placed < arrivals).any()        # arrivals dropped
    if act_mode == "skip":
        assert (placed[::2] == 0).all()
    return frank, alive, inc, planes, act, got_p, got_a


@pytest.mark.parametrize("case", list(CASES))
def test_ranked_merge_walk_matches_pinc_tpu(case):
    B, act_mode, frank_mode, room = CASES[case]
    frank, alive, inc, planes, act, got_p, got_a = _run(
        B, act_mode, frank_mode, room, seed=50 + len(case))
    jpl, jal = _jax("mk", pex.merge)(
        jnp.asarray(frank), jnp.asarray(alive),
        jnp.asarray(_pinc_buf(torch.from_numpy(inc))),
        tuple(jnp.asarray(p) for p in planes),
        active=None if act is None else jnp.asarray(act))
    for mine, theirs in zip(got_p, jpl):
        _eq(mine, theirs)
    _eq(got_a, jal)


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_ranked_merge_walk_matches_plain(case):
    B, act_mode, frank_mode, room = PLAIN_CASES[case]
    _run(B, act_mode, frank_mode, room, seed=70 + len(case))


def test_ranked_merge_items_cover_rows_off_a_boundary():
    """Without active, every start of a row off a 16-byte boundary: the
    head reaches the boundary, the groups are aligned, each slot once."""
    for B in (1, 2, 3, 5, 7, 100, 101):
        for fr0 in range(VEC):
            seen = np.zeros(B, int)
            for at, w in _items(B, ox._chunk(B), fr0, False, None, None):
                assert w == 1 or (fr0 + at) % VEC == 0
                seen[at:at + w] += 1
            assert (seen == 1).all(), (B, fr0)


def test_ranked_merge_refuses_a_stage_beyond_shared_memory():
    """The staged block, 7 K2 floats, must fit a block's shared memory
    beside the list of active chunks."""
    alive, planes = _state(3, b=100)
    K2 = 2 * (ox.RANKED_STAGE_MAX // (4 * 7 * 2) + 1)
    inc = torch.zeros((NT, 7, 1, K2))
    frank = torch.full((NT, 100), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        ox.merge(frank, torch.from_numpy(alive), inc,
                 tuple(torch.from_numpy(p) for p in planes))


# ---------------------------------------------------------------------------
# The ranked extract (extract_ranked_kernel): a block takes Kc = min(K2
# rounded up to 4, COLS) columns of a tile's buffer, ceil(K2 / Kc) blocks a
# tile.  It sets each column's source slot to none in shared memory, its 8
# warps walk the tile's rank row in 16-byte lane groups (RowWalk: a scalar
# head up to the row's first 16-byte boundary, chunks of 128 slots, chunk c
# to warp c % 8), a slot whose rank falls in the block's columns becomes
# that column's source, the first block of a tile writes alive' (0 where
# rank >= 0, else alive; 16 bytes at a time where alive's and alive''s rows
# lie on rank's 16-byte offset), and after one barrier the block writes its
# columns out whole, a 4-column group at a time: each source's six payloads
# (x + 0.0) and flag 1, zeros for a column without one (16-byte stores where
# K2 % 4 == 0, else scalar stores).
# ---------------------------------------------------------------------------

COLS = 4096        # kRankedCols: the columns one block takes
CHUNK = 32 * VEC   # slots of one warp-wide 16-byte access


def _row_groups(B, off0):
    """RowWalk's groups [(chunk, first slot, slot count)] of a row of B
    slots whose first word lies off0 words past a 16-byte boundary."""
    h = min(B, (VEC - off0 % VEC) % VEC)
    end = -(-(B - h) // CHUNK)
    out = [(-1, 0, h)] if h else []
    for c in range(end):
        for lane in range(32):
            off = h + VEC * (32 * c + lane)
            n = max(0, min(VEC, B - off))
            if n:
                out.append((c, off, n))
    return out


def extract_ranked_vec(rank, alive, planes, K2, rank0=0, alive0=0, out0=0):
    """extract_ranked_kernel on numpy inputs; rank0, alive0, out0: the word
    offsets of the rank, alive and alive' arrays from a 16-byte boundary.
    Returns (buf (NT, 7, 1, K2), alive')."""
    NT_, B = rank.shape
    Kc = min(-(-K2 // VEC) * VEC, COLS)
    nblk = -(-K2 // Kc)
    buf = np.full((NT_, 7, 1, K2), np.nan, np.float32)
    alive2 = np.full_like(alive, np.nan)
    written = np.zeros((NT_, 7, K2), np.int64)
    for t in range(NT_):
        r_off = (rank0 + t * B) % VEC
        vec_al = (alive0 + t * B) % VEC == r_off == (out0 + t * B) % VEC
        groups = _row_groups(B, r_off)
        visited = np.zeros(B, np.int64)
        for blk in range(nblk):
            c0 = blk * Kc
            nc = min(Kc, K2 - c0)
            src = np.full(Kc, -1)
            for c, off, n in groups:
                if n == VEC:
                    assert (r_off + off) % VEC == 0        # one 16-byte load
                r = rank[t, off:off + n]
                for e in range(n):
                    col = int(r[e]) - c0
                    if 0 <= col < nc:
                        assert src[col] == -1              # ranks unique
                        src[col] = off + e
                if blk == 0:
                    visited[off:off + n] += 1
                    if n == VEC and vec_al:
                        assert (alive0 + t * B + off) % VEC == 0
                    alive2[t, off:off + n] = np.where(
                        r >= 0, np.float32(0.0), alive[t, off:off + n])
            vec = K2 % VEC == 0
            if vec:
                assert c0 % VEC == 0 and nc % VEC == 0     # 16-byte stores
            for j0 in range(0, nc, VEC if vec else 1):
                for j in range(j0, min(j0 + (VEC if vec else 1), nc)):
                    for q in range(7):
                        buf[t, q, 0, c0 + j] = (
                            np.float32(0.0) if src[j] < 0 else
                            planes[q][t, src[j]] + np.float32(0.0) if q < 6
                            else np.float32(1.0))
                        written[t, q, c0 + j] += 1
        assert (visited == 1).all()
    assert (written == 1).all()                         # each entry once
    return buf, alive2


def _extract_case(B, K2, seed, spread=False, empty=None):
    """Ranks of a z sweep at cap K2 // 2 (pinc_tpu's exchange_dim encoding;
    a leaver past the cap ranked 2 (K2 // 2): killed, not copied); with
    spread, each tile's leavers take distinct random columns of [0, 1.1
    K2) instead (ranks >= K2 killed), so that every column chunk of a wide
    buffer is reached; `empty`: a tile with no rank >= 0."""
    alive, planes = _state(seed, b=B)
    rank = _ranks(planes[2], alive, K2 // 2)
    if spread:
        rng = np.random.default_rng(seed)
        for t in range(rank.shape[0]):
            on = np.flatnonzero(rank[t] >= 0)
            rank[t, on] = rng.choice(int(1.1 * K2), len(on), replace=False)
    if empty is not None:
        rank[empty] = -1
    return rank, alive, planes


# B % 8 != 0 and rows off a 16-byte boundary (B = 101, 2101), K2 % 4 != 0,
# a K2 spanning three column chunks, ranks >= K2, an empty tile
EXTRACT_CASES = {"b101_k32": (101, 32, False, None),
                 "b101_k30_empty": (101, 30, False, 3),
                 "b101_k9001_spread": (101, 9001, True, None),
                 "b2101_k254": (2101, 254, False, 5),
                 "b100_k8192_spread": (100, 8192, True, 0)}


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_ranked_extract_walk_matches_pinc_tpu(case):
    B, K2, spread, empty = EXTRACT_CASES[case]
    rank, alive, planes = _extract_case(B, K2, 90 + len(case), spread, empty)
    assert (rank >= K2).any() and (rank == -1).any()
    if empty is not None:
        assert (rank[empty] < 0).all()
    buf, al2 = extract_ranked_vec(rank, alive, planes, K2, rank0=1,
                                  alive0=1, out0=1)
    pbuf, pal = ox.extract_plain(torch.from_numpy(rank),
                                 torch.from_numpy(alive),
                                 tuple(torch.from_numpy(p) for p in planes),
                                 K2)
    _eq(buf, pbuf.numpy())
    _eq(al2, pal.numpy())
    if K2 > COLS:
        cols = np.flatnonzero(buf[:, 6, 0].max(0) > 0.5)
        assert cols.max() >= (K2 - 1) // COLS * COLS    # the last chunk
    jbuf, jal = _jax(f"xv{B}_{K2}", pex.extract, K2=K2)(
        jnp.asarray(rank), jnp.asarray(alive),
        tuple(jnp.asarray(p) for p in planes))
    _eq(_pinc_buf(torch.from_numpy(buf)), jbuf)
    _eq(al2, jal)


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (0, 2, 0), (2, 2, 1)])
def test_ranked_extract_walk_rows_off_a_boundary(offsets):
    """Every start of the rank row off a 16-byte boundary, and alive or
    alive' on another offset than rank (scalar alive accesses): the same
    buffer and alive' as the plain version."""
    rank, alive, planes = _extract_case(2101, 30, 97, False, 2)
    buf, al2 = extract_ranked_vec(rank, alive, planes, 30, *offsets)
    pbuf, pal = ox.extract_plain(torch.from_numpy(rank),
                                 torch.from_numpy(alive),
                                 tuple(torch.from_numpy(p) for p in planes),
                                 30)
    _eq(buf, pbuf.numpy())
    _eq(al2, pal.numpy())
