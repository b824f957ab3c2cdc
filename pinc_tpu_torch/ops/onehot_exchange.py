"""The one-hot exchange re-bucket — the counterpart of
``pinc_tpu/ops/pallas_exchange.py``.

pinc_tpu sends a 3-D tiled deck here whenever the gather exchange
(``ops/gather_exchange.py``) does not take it: B % 1024 != 0, the per-row
gate false, or ``tiles:exchangeImpl = onehot`` (routing in
``ops/exchange.py``).  Its TPU kernels select leavers and place arrivals
with one-hot matmuls and rank them with triangular-matrix scans.  Here each
function keeps pinc_tpu's name, arguments and result and copies by index:
ranks are cumsums in the plain versions and ballot/popc counts in the CUDA
kernels (``csrc/onehot_exchange.cu``; the cleanup runs K10's kernel of
``csrc/gather_exchange.cu``):

=====================  ================================================
kernel (LAUNCHES key)  pinc_tpu functions it computes
=====================  ================================================
onehot_extract_rows    ``extract_rows`` :291, ``extract_all_rows`` :777
onehot_extract_tile    ``extract_fused`` :227, ``extract`` :425
onehot_cleanup         ``cleanup_rows`` :841
onehot_merge_rows      ``merge_rows`` :358, ``merge_all_rows`` :917
onehot_merge_tile      ``merge_fused`` :505, ``merge`` :575
=====================  ================================================

What the TPU kernels compute is kept, so the port agrees with pinc_tpu slot
for slot and drop for drop:

* the row kernels see a tile's B slots as 8 rows of L = B/8 slots, each
  with its own ranks and caps; the per-tile kernels rank over the whole
  tile in slot order (R = 1 buffer row).  Leavers ranked beyond the cap
  are killed and not copied (dropped);
* the merge fills a row's (or the tile's) free slots (alive <= 0.5), in
  slot order, with its arrivals counted over the compacted runs in order.
  Arrivals beyond the free slots are dropped: there is no spill pass (the
  gather merge has one);
* the caps are pinc_tpu's: ``default_row_cap`` rounds to 64 or 8 slots and
  ``default_edge_cap`` is max(8, Ks/4), neither to 128;
* every copied value is x + 0.0: the one-hot sums turn -0.0 into +0.0 and
  copy every other finite value exactly.

Buffers are payload-major ``(NT, 7, R, W)`` (x, y, z, vx, vy, vz, flag;
R = 8 or 1), where pinc_tpu has ``(NT, 8, R*W)`` with a zero eighth row.
The merges write the arrivals IN PLACE into the planes and alive they are
given (pinc_tpu returns new arrays with the same values), so the drivers
update the caller's planes.  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it checks them, launches the kernel on the
current stream, raises on a nonzero launch error and adds one to
``LAUNCHES[name]``.  There is no fallback from a CUDA tensor to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _cuda_build
from . import gather_exchange as gx
from .tiled_kernels import _check, _is_cpu, _launch, _ptr, _stream

NPAY = gx.NPAY

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"onehot_extract_rows": 0, "onehot_extract_tile": 0,
            "onehot_cleanup": 0, "onehot_merge_rows": 0,
            "onehot_merge_tile": 0}

_PEX = "pinc_tpu/ops/pallas_exchange.py"

#: file:line of each pinc_tpu function that reaches pl.pallas_call, and
#: the kernel (LAUNCHES key) that replaces it
FUNCTIONS = {
    "extract_fused": (f"{_PEX}:227", "onehot_extract_tile"),
    "extract_rows": (f"{_PEX}:291", "onehot_extract_rows"),
    "merge_rows": (f"{_PEX}:358", "onehot_merge_rows"),
    "extract": (f"{_PEX}:425", "onehot_extract_tile"),
    "merge_fused": (f"{_PEX}:505", "onehot_merge_tile"),
    "merge": (f"{_PEX}:575", "onehot_merge_tile"),
    "extract_all_rows": (f"{_PEX}:777", "onehot_extract_rows"),
    "cleanup_rows": (f"{_PEX}:841", "onehot_cleanup"),
    "merge_all_rows": (f"{_PEX}:917", "onehot_merge_rows"),
}

#: the TPU kernel each CUDA kernel replaces on a deck's path (the v5
#: exchange for the row kernels, the v3 sweeps for the per-tile ones)
REPLACES = {
    "onehot_extract_rows": FUNCTIONS["extract_all_rows"][0],
    "onehot_extract_tile": FUNCTIONS["extract_fused"][0],
    "onehot_cleanup": FUNCTIONS["cleanup_rows"][0],
    "onehot_merge_rows": FUNCTIONS["merge_all_rows"][0],
    "onehot_merge_tile": FUNCTIONS["merge_fused"][0],
}

SOURCE = "pinc_tpu_torch/csrc/onehot_exchange.cu"
#: the cleanup runs K10's kernel
SOURCES = {k: gx.SOURCE if k == "onehot_cleanup" else SOURCE
           for k in LAUNCHES}

_DIM_KIND = 0      # csrc classifier codes: one axis (on coord), all axes
_ALL = 3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_row_cap(K: int, B: int) -> int:
    """Per-row face cap: K/4 (2x head room over the even K/8 share),
    rounded to the lane quantum."""
    q = 64 if B >= 4096 else 8
    return max(q, -(-K // 4 // q) * q)


def default_edge_cap(Ks: int) -> int:
    """Cap for multi-axis (edge/corner) flows per hop: max(8, Ks/4)."""
    return max(8, Ks // 4)


#: bytes of shared memory the ranked merge may stage its arrivals in: a
#: block's 227 KB less its list of active chunks (csrc/onehot_exchange.cu)
RANKED_STAGE_MAX = 232448 - 4 * (2048 + 24)


def _chunk(B: int, target: int = 2048) -> int:
    """pinc_tpu's lane chunk of the ranked merge's ``active`` flags: the
    largest power-of-two divisor of B up to target (B itself if smaller)."""
    c = min(B, target)
    while B % c:
        c //= 2
    return max(c, 1)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _segments(a: torch.Tensor, R: int) -> torch.Tensor:
    """(NT, B) -> the (NT, R, B/R) view: R = 8 rows, or the whole tile."""
    NT, B = a.shape
    return a.view(NT, R, B // R)


def _extract_plain(coord, alive, planes, kind: int, R: int, K: int, T: int):
    """Leavers of each segment by class, compacted per class (cap K)."""
    al = _segments(alive, R)
    if kind == _ALL:
        masks, leave = gx._classify_all(
            [_segments(p, R) for p in planes[:3]], al, T)
    else:
        c = _segments(coord, R)
        live = al > 0.5
        masks = (live & (c < 0.0), live & (c >= float(T)))
        leave = masks[0] | masks[1]
    NT, B = alive.shape
    buf = torch.zeros((NT, NPAY, R, len(masks) * K), dtype=torch.float32,
                      device=alive.device)
    pays = [_segments(p, R) + 0.0 for p in planes] + [None]
    for i, m in enumerate(masks):
        gx._compact(buf, m, pays, i * K, K)
    alive2 = torch.where(leave, torch.zeros((), device=alive.device), al)
    return buf, alive2.reshape(NT, B)


def extract_fused_plain(coord, alive, planes, K: int, T: int):
    return _extract_plain(coord, alive, planes, _DIM_KIND, 1, K, T)


def extract_rows_plain(coord, alive, planes, Ks: int, T: int):
    return _extract_plain(coord, alive, planes, _DIM_KIND, 8, Ks, T)


def extract_all_rows_plain(planes, alive, Ks: int, T: int):
    return _extract_plain(None, alive, planes, _ALL, 8, Ks, T)


def extract_plain(rank, alive, planes, K2: int):
    """See extract."""
    NT, _ = rank.shape
    buf = torch.zeros((NT, NPAY, 1, K2), dtype=torch.float32,
                      device=alive.device)
    t, j = torch.nonzero((rank >= 0) & (rank < K2), as_tuple=True)
    col = rank[t, j].long()
    for q, p in enumerate(planes):
        buf[t, q, 0, col] = p[t, j] + 0.0
    buf[t, 6, 0, col] = 1.0
    alive2 = torch.where(rank >= 0, torch.zeros((), device=alive.device),
                         alive)
    return buf, alive2


def cleanup_rows_plain(inc, W: int, Ke: int, T: int, axes):
    return gx.cleanup_rows_g_plain(inc, Ke, T, tuple(axes), canon=True)


def _place(al, outs, inc, t, r, j, col) -> None:
    """Write arrival (t, r, col) of inc into slot (t, r, j) of the segment
    views al (alive) and outs (planes), where its flag is set."""
    hit = inc[t, 6, r, col] > 0.5
    t, r, j, col = t[hit], r[hit], j[hit], col[hit]
    for q, o in enumerate(outs):
        o[t, r, j] = inc[t, q, r, col] + 0.0
    al[t, r, j] = 1.0


def _merge_plain(alive, inc, planes, blocks):
    """Free slot f of each segment takes arrival f of the same segment,
    counted over the compacted blocks in order (in place)."""
    R = inc.shape[2]
    al = _segments(alive, R)
    valid = inc[:, 6] > 0.5                                   # (NT, R, KT)
    n_b = torch.stack([valid[..., off:off + w].sum(-1)
                       for off, w in blocks], -1)             # (NT, R, nb)
    ends = torch.cumsum(n_b, -1)
    starts = ends - n_b
    offs = torch.tensor([off for off, _ in blocks], device=alive.device)
    free = al <= 0.5
    frank = torch.cumsum(free, -1) - 1
    take = free & (frank < ends[..., -1:])
    t, r, j = torch.nonzero(take, as_tuple=True)
    f = frank[t, r, j]
    b = (ends[t, r] <= f[:, None]).sum(-1)
    _place(al, [_segments(p, R) for p in planes], inc, t, r, j,
           offs[b] + f - starts[t, r, b])
    return tuple(planes), alive


def merge_rows_plain(alive, inc, planes, Ks: int):
    return _merge_plain(alive, inc, planes, ((0, Ks), (Ks, Ks)))


def merge_fused_plain(alive, inc, planes, K: int):
    return _merge_plain(alive, inc, planes, ((0, K), (K, K)))


def merge_all_rows_plain(alive, inc, planes, blocks):
    return _merge_plain(alive, inc, planes, blocks)


def merge_plain(frank, alive, inc, planes, active=None):
    """See merge."""
    NT, B = frank.shape
    K = inc.shape[-1] // 2
    valid = inc[:, 6, 0] > 0.5
    n_m = valid[:, :K].sum(-1, keepdim=True)
    n_p = valid[:, K:].sum(-1, keepdim=True)
    f = frank.long()
    ok = (f >= 0) & ((f < n_m) | (f - n_m < n_p))
    if active is not None:
        ok &= (active != 0).repeat_interleave(_chunk(B), dim=1)
    col = torch.where(f < n_m, f, K + f - n_m)
    t, j = torch.nonzero(ok, as_tuple=True)
    _place(_segments(alive, 1), [_segments(p, 1) for p in planes], inc, t,
           torch.zeros_like(t), j, col[t, j])
    return tuple(planes), alive


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_planes(alive: torch.Tensor, planes: Sequence[torch.Tensor],
                  rows: bool = True) -> Tuple[int, int]:
    if alive.dim() != 2:
        raise ValueError("alive must be (NT, B)")
    NT, B = alive.shape
    if rows and B % 8:
        raise ValueError(f"the one-hot row and tile kernels need B % 8 == 0, "
                         f"got B = {B}")
    if len(planes) != 6:
        raise ValueError(f"expected 6 planes (x, y, z, vx, vy, vz), got "
                         f"{len(planes)}")
    _check(alive, "alive", (NT, B), alive.device)
    for i, p in enumerate(planes):
        _check(p, f"planes[{i}]", (NT, B), alive.device)
    return NT, B


def _check_inc(inc: torch.Tensor, NT: int, R: int,
               device: torch.device) -> int:
    if inc.dim() != 4 or tuple(inc.shape[:3]) != (NT, NPAY, R):
        raise ValueError(f"inc must be ({NT}, 7, {R}, W), got "
                         f"{tuple(inc.shape)}")
    _check(inc, "inc", tuple(inc.shape), device)
    return inc.shape[-1]


def _extract(name, coord, alive, planes, kind: int, R: int, K: int, T: int):
    """Launch the extract kernel (see extract_rows / extract_fused)."""
    NT, B = _check_planes(alive, planes)
    if coord is not None:
        _check(coord, "coord", (NT, B), alive.device)
    if K <= 0:
        raise ValueError(f"the extract cap must be positive, got {K}")
    if _is_cpu(alive, name):
        return _extract_plain(coord, alive, planes, kind, R, K, T)
    gx.check_aligned16(alive=alive, **({"coord": coord} if coord is not None
                                       else gx.classifier_planes(planes,
                                                                 kind)))
    dev = alive.device
    n_cls = 6 if kind == _ALL else 2
    buf = torch.empty((NT, NPAY, R, n_cls * K), dtype=torch.float32,
                      device=dev)
    alive2 = torch.empty_like(alive)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch(name, lib.pinc_ox_extract,
                ctypes.c_void_p(None) if coord is None else _ptr(coord),
                _ptr(alive), *[_ptr(p) for p in planes], _ptr(buf),
                _ptr(alive2), NT, B, kind, R, K, float(T), _stream(dev),
                counts=LAUNCHES)
    return buf, alive2


def extract_fused(coord: torch.Tensor, alive: torch.Tensor, planes, K: int,
                  T: int):
    """Per-tile extract along the axis of ``coord`` (one of the coordinate
    planes, (NT, B) f32, B % 8 == 0): each live slot with coord < 0 leaves
    minus, coord >= T plus; ranks run over the tile in slot order, cap K a
    direction.  Returns (bufs (NT, 7, 1, 2K) — minus run [0, K), plus run
    [K, 2K) — and the new alive (NT, B) with every leaver killed).

    Kernel onehot_extract_tile, replaces pallas_exchange.extract_fused.
    Bound on the card: bytes — alive and coord read, alive written (12
    B/slot), 24 B read and 28 B written per copied leaver, the buffer's
    zero tail.  Design: one block per tile, one warp per 1/8 of it; a
    counting pass gives each warp the tile-wide rank its slots start from,
    then the ranks of K8's kernel: 16-byte lane groups of 4 slots (a
    scalar head and a short last group where a warp's slice does not start
    on a 16-byte boundary, B % 32 != 0), four ballots a class."""
    return _extract("onehot_extract_tile", coord, alive, planes, _DIM_KIND,
                    1, K, T)


def extract_rows(coord: torch.Tensor, alive: torch.Tensor, planes, Ks: int,
                 T: int):
    """Per-row extract_fused: ranks and the cap Ks per row (8 rows of B/8
    slots).  Returns (bufs (NT, 7, 8, 2Ks), alive').

    Kernel onehot_extract_rows, replaces pallas_exchange.extract_rows.
    Bound on the card: bytes, as extract_fused.  Design: K8's kernel
    (exchange_common.cuh), one warp per row in 16-byte lane groups (a
    scalar head where a row does not start on a 16-byte boundary, B % 32
    != 0), copies x + 0.0."""
    return _extract("onehot_extract_rows", coord, alive, planes, _DIM_KIND,
                    8, Ks, T)


def extract_all_rows(planes, alive: torch.Tensor, Ks: int, T: int):
    """All axes in one plane pass, priority x > y > z: per-row runs [xm,
    xp, ym, yp, zm, zp], each Ks wide.  Returns (bufs (NT, 7, 8, 6Ks),
    alive').

    Kernel onehot_extract_rows, replaces pallas_exchange.extract_all_rows.
    Bound on the card: bytes — alive, x, y, z read and alive written (20
    B/slot), 12 B read and 28 B written per copied leaver, the zero tail."""
    return _extract("onehot_extract_rows", None, alive, planes, _ALL, 8, Ks,
                    T)


def extract(rank: torch.Tensor, alive: torch.Tensor, planes, K2: int):
    """rank (NT, B) int32, the buffer column of each slot (-1 stays; a
    rank >= K2 is killed and not copied; ranks in [0, K2) unique), alive
    and six planes (NT, B) f32, any B.  Returns (bufs (NT, 7, 1, K2),
    alive' with every ranked slot killed).

    Kernel onehot_extract_tile (its ranked mode), replaces
    pallas_exchange.extract.  Bound on the card: bytes — rank and alive
    read, alive written, 24 B read per copied slot, the buffer written
    once.  Design: a block takes up to 4096 columns of a tile's buffer
    (ceil(K2 / 4096) blocks a tile), walks the rank row in 16-byte groups
    noting each column's source slot in shared memory, then writes its
    columns out whole, the sources' payloads loaded a 4-column group a
    thread."""
    NT, B = _check_planes(alive, planes, rows=False)
    _check(rank, "rank", (NT, B), alive.device, dtypes=(torch.int32,))
    if _is_cpu(alive, "onehot_extract_tile"):
        return extract_plain(rank, alive, planes, K2)
    dev = alive.device
    buf = torch.empty((NT, NPAY, 1, K2), dtype=torch.float32, device=dev)
    alive2 = torch.empty_like(alive)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("onehot_extract_tile", lib.pinc_ox_extract_ranked,
                _ptr(rank), _ptr(alive), *[_ptr(p) for p in planes],
                _ptr(buf), _ptr(alive2), NT, B, K2, _stream(dev),
                counts=LAUNCHES)
    return buf, alive2


def cleanup_rows(inc: torch.Tensor, W: int, Ke: int, T: int, axes):
    """inc (NT, 7, 8, W) row-blocked arrivals: classify each valid column
    against the remaining ``axes`` (first axis out wins), compact the
    settled ones (cap W) and each direction's extras (cap Ke).  Returns
    (settled (NT, 7, 8, W), tuple of 2*len(axes) extras (NT, 7, 8, Ke)).

    Kernel onehot_cleanup, replaces pallas_exchange.cleanup_rows: K10's
    kernel (csrc/gather_exchange.cu) with canon = 1, which takes any W and
    Ke and the axes (0, 1, 2), (1, 2) and (2,)."""
    axes = tuple(axes)
    if gx._check_inc(inc) != W:
        raise ValueError(f"inc has rows {inc.shape[-1]} wide, W = {W}")
    if _is_cpu(inc, "onehot_cleanup"):
        return cleanup_rows_plain(inc, W, Ke, T, axes)
    return gx.launch_cleanup(inc, Ke, T, axes, True, "onehot_cleanup",
                             LAUNCHES)


def _merge(name, alive, inc, planes, blocks, R: int):
    """Launch the merge kernel (see merge_all_rows / merge_fused)."""
    blocks = tuple((int(o), int(w)) for o, w in blocks)
    NT, B = _check_planes(alive, planes)
    KT = _check_inc(inc, NT, R, alive.device)
    if not 1 <= len(blocks) <= 8 or any(
            o < 0 or w < 0 or o + w > KT for o, w in blocks):
        raise ValueError(f"blocks must be 1 to 8 (offset, width) runs "
                         f"inside [0, {KT}), got {blocks}")
    if _is_cpu(alive, name):
        return _merge_plain(alive, inc, planes, blocks)
    dev = alive.device
    table = (ctypes.c_int * 16)(*[v for ow in blocks for v in ow])
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch(name, lib.pinc_ox_merge, _ptr(alive), _ptr(inc),
                *[_ptr(p) for p in planes], table, len(blocks), NT, B, R, KT,
                _stream(dev), counts=LAUNCHES)
    return tuple(planes), alive


def merge_all_rows(alive: torch.Tensor, inc: torch.Tensor, planes, blocks):
    """inc (NT, 7, 8, KT) row-blocked arrivals, blocks = ((offset, width),
    ...) compacted runs within each row, at most 8: row r's free slots
    (alive <= 0.5), in slot order, take row r's arrivals counted over the
    blocks in order; arrivals beyond the free slots are dropped.  Writes IN
    PLACE into ``planes`` and ``alive``; returns (planes, alive).

    Kernel onehot_merge_rows, replaces pallas_exchange.merge_all_rows.
    Bound on the card: bytes — alive read up to the last free slot a row
    fills, the flag plane, 28 B read and written per placed arrival.
    Design: one block per tile, one warp per row: the flags counted per
    block and alive walked in 16-byte lane groups, each chunk's free slots
    placed as they are ranked, lane l taking slot 32 s + l of each 32-slot
    word (a store covers one 128-byte line)."""
    return _merge("onehot_merge_rows", alive, inc, planes, blocks, 8)


def merge_rows(alive: torch.Tensor, inc: torch.Tensor, planes, Ks: int):
    """merge_all_rows with the runs of extract_rows: minus [0, Ks), plus
    [Ks, 2Ks).  Replaces pallas_exchange.merge_rows."""
    return _merge("onehot_merge_rows", alive, inc, planes,
                  ((0, Ks), (Ks, Ks)), 8)


def merge_fused(alive: torch.Tensor, inc: torch.Tensor, planes, K: int):
    """Per-tile merge: inc (NT, 7, 1, 2K); the tile's free slots, in slot
    order, take its arrivals, minus run first.  In place, as
    merge_all_rows.

    Kernel onehot_merge_tile, replaces pallas_exchange.merge_fused.  Bound
    on the card: bytes — alive up to the last free slot the tile fills,
    the flag plane, 28 B read and written per placed arrival.  Design:
    merge_all_rows' walk with ranks
    over the tile: every warp counts a share of the flags, then the 8
    warps walk the tile in rounds of 8 chunks of 128 slots, one a warp,
    each placing its chunk once a barrier has made the round's free
    counts known; the rounds stop at the tile's last arrival."""
    return _merge("onehot_merge_tile", alive, inc, planes,
                  ((0, K), (K, K)), 1)


def merge(frank: torch.Tensor, alive: torch.Tensor, inc: torch.Tensor,
          planes, active=None):
    """frank (NT, B) int32 free-slot ranks (-1 = occupied), any B; inc
    (NT, 7, 1, K2): free rank f takes arrival f (the minus run first).
    active: optional (NT, NC) int32, one flag per chunk of _chunk(B) slots;
    a chunk whose flag is 0 places nothing (pinc_tpu computes it so that
    it only skips work).  In place, as merge_all_rows.

    frank may be any int32 plane: ranks need not rise in slot order, and
    slots that share a rank each take its arrival.

    Kernel onehot_merge_tile (its ranked mode), replaces
    pallas_exchange.merge.  Bound on the card: bytes — the flag row,
    active, frank of the walked slots, 24 B read and 28 B written per
    placed arrival; in 32-byte sectors its scattered stores (a sector a
    plane and placed slot) dominate.  Design: one block a tile stages the
    arrivals it can place (the minus run's first n_m columns, the plus
    run's first n_p) in shared memory (7 K2 floats), lists the active
    chunks with ballots and walks only their slots (all slots without
    active), frank in 16-byte groups where the row allows, 4 groups a
    thread loaded before any is placed; a group with a placed slot is
    read from the six planes and alive and written back whole (16-byte
    stores)."""
    NT, B = _check_planes(alive, planes, rows=False)
    _check(frank, "frank", (NT, B), alive.device, dtypes=(torch.int32,))
    K2 = _check_inc(inc, NT, 1, alive.device)
    if K2 % 2:
        raise ValueError(f"inc must hold two runs of K, got width {K2}")
    if 4 * NPAY * K2 > RANKED_STAGE_MAX:
        raise ValueError(f"the ranked merge stages 7 x {K2} floats: more "
                         f"than a block's {RANKED_STAGE_MAX} bytes of shared "
                         f"memory")
    CB = _chunk(B)
    if active is not None:
        _check(active, "active", (NT, B // CB), alive.device,
               dtypes=(torch.int32,))
    if _is_cpu(alive, "onehot_merge_tile"):
        return merge_plain(frank, alive, inc, planes, active=active)
    dev = alive.device
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("onehot_merge_tile", lib.pinc_ox_merge_ranked, _ptr(frank),
                _ptr(alive), _ptr(inc),
                ctypes.c_void_p(None) if active is None else _ptr(active),
                *[_ptr(p) for p in planes], NT, B, K2, CB, B // CB,
                _stream(dev), counts=LAUNCHES)
    return tuple(planes), alive


# ---------------------------------------------------------------------------
# Drivers (tile-grid rolls, concatenations and the +-T frame shift are
# plain torch ops around the kernels, as they sit outside Pallas in JAX)
# ---------------------------------------------------------------------------

def _roll_blocked(buf: torch.Tensor, nt: Tuple[int, ...], d: int, sign: int,
                  roll) -> torch.Tensor:
    """Roll a buffer (NT, 7, R, w) to the d-neighbour over the tile grid."""
    return roll(buf.reshape(nt + tuple(buf.shape[1:])), sign, d).reshape(
        buf.shape)


def _ranks(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive per-tile counts of mask (NT, B) in slot order, int32."""
    return (torch.cumsum(mask, dim=1, dtype=torch.int32) - 1)


def exchange_dim(planes, alive: torch.Tensor, ntiles: Tuple[int, ...],
                 d: int, T: int, K: int, roll_fn=None, ks: int = None,
                 rows: bool = False):
    """One axis' +-1-tile transfer on the planes (x, y, z, vx, vy, vz),
    each (NT, B) f32 tile-local, alive (NT, B) f32: extract, roll the minus
    run to the lower neighbour and the plus run to the upper one, shift the
    arrivals into the receiver's frame, merge.  rows (B % 8 == 0): the
    per-row kernels with cap ks (default default_row_cap(K, B)); else the
    per-tile kernels with cap K (B % 8 != 0: ranks computed here, the
    ranked kernels).  roll_fn(x, shift, axis) replaces torch.roll over the
    tile grid.  Returns (planes, alive'); planes are updated in place."""
    NT, B = alive.shape
    coord = planes[d]
    nt = tuple(ntiles)
    roll = roll_fn or gx._torch_roll
    if rows and B % 8 == 0:
        Ks = ks or default_row_cap(K, B)
        bufs, alive2 = extract_rows(coord, alive, planes, Ks, T)
        inc = torch.cat([_roll_blocked(bufs[..., :Ks], nt, d, -1, roll),
                         _roll_blocked(bufs[..., Ks:], nt, d, 1, roll)], -1)
        inc = gx._shift_block(inc, d, T, ((Ks, 1), (Ks, -1)))
        return merge_rows(alive2, inc, planes, Ks)
    if B % 8 == 0:
        bufs, alive2 = extract_fused(coord, alive, planes, K, T)
    else:
        al = alive > 0.5
        lm = al & (coord < 0.0)
        lp = al & (coord >= float(T))
        rm, rp = _ranks(lm), _ranks(lp)
        minus_one = torch.full_like(rm, -1)
        rank = torch.where(lm & (rm < K), rm,
                           torch.where(lp & (rp < K), K + rp, minus_one))
        # overflow leavers die: rank 2K is killed and copied nowhere
        rank = torch.where((lm & (rm >= K)) | (lp & (rp >= K)),
                           torch.full_like(rm, 2 * K), rank)
        bufs, alive2 = extract(rank, alive, planes, 2 * K)
    inc = torch.cat([_roll_blocked(bufs[..., :K], nt, d, -1, roll),
                     _roll_blocked(bufs[..., K:], nt, d, 1, roll)], -1)
    inc = gx._shift_block(inc, d, T, ((K, 1), (K, -1)))
    if B % 8 == 0:
        return merge_fused(alive2, inc, planes, K)
    free = alive2 <= 0.5
    fr_incl = torch.cumsum(free, dim=1, dtype=torch.int32)
    frank = torch.where(free, fr_incl - 1, torch.full_like(fr_incl, -1))
    # per-chunk activity, as pinc_tpu computes it: chunk c places an
    # arrival iff the free count before it is below the arrival count and
    # it holds a free slot
    CB = _chunk(B)
    ends = fr_incl[:, CB - 1::CB]
    base = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    n_arr = inc[:, 6].sum((-2, -1))[:, None]
    active = ((base < n_arr) & (ends > base)).to(torch.int32)
    return merge(frank, alive2, inc, planes, active=active)


def rebucket_exchange_all_rows(planes, alive: torch.Tensor,
                               ntiles: Tuple[int, ...], T: int, Ks: int,
                               Ke: int = None, roll_fns=None):
    """Fused all-axes per-row exchange: one extract of the six faces, the
    x -> y -> z hops over the small buffers (a cleanup after the x and y
    hops re-routes the movers still out of range in a later axis, under
    the edge cap Ke, default default_edge_cap(Ks)), one merge of the eight
    compacted runs.  roll_fns: per-axis replacements of torch.roll.
    Returns (planes, alive', n_dropped); planes are updated in place."""
    NT, _ = alive.shape
    nt = tuple(ntiles)
    Ke = Ke or default_edge_cap(Ks)
    rolls = roll_fns or (gx._torch_roll,) * 3
    n0 = alive.to(torch.int32).sum()

    bufs, alive2 = extract_all_rows(planes, alive, Ks, T)
    face = [bufs[..., i * Ks:(i + 1) * Ks] for i in range(6)]

    def cat(xs):
        return torch.cat(xs, -1)

    def hop(minus, plus, d):
        return cat([_roll_blocked(minus, nt, d, -1, rolls[d]),
                    _roll_blocked(plus, nt, d, 1, rolls[d])])

    # x hop: the face buffers only
    Wx = 2 * Ks
    inc_x = gx._shift_block(hop(face[0], face[1], 0), 0, T,
                            ((Ks, 1), (Ks, -1)))
    settled_x, (ym_e, yp_e, zm_e, zp_e) = cleanup_rows(inc_x, Wx, Ke, T,
                                                       axes=(1, 2))
    # y hop: the y faces + the x arrivals' y extras
    Wy1 = Ks + Ke
    inc_y = gx._shift_block(hop(cat([face[2], ym_e]), cat([face[3], yp_e]),
                                1), 1, T, ((Wy1, 1), (Wy1, -1)))
    settled_y, (zm_e2, zp_e2) = cleanup_rows(inc_y, 2 * Wy1, Ke, T, axes=(2,))
    # z hop (the last axis: its arrivals are settled by construction)
    Wz1 = Ks + 2 * Ke
    inc_z = gx._shift_block(hop(cat([face[4], zm_e, zm_e2]),
                                cat([face[5], zp_e, zp_e2]), 2), 2, T,
                            ((Wz1, 1), (Wz1, -1)))

    # merge: settled_x, settled_y and the six z sub-runs, each compacted
    inc = cat([settled_x, settled_y, inc_z])
    blocks = []
    off = 0
    for w in (Wx, 2 * Wy1, Ks, Ke, Ke, Ks, Ke, Ke):
        blocks.append((off, w))
        off += w
    planes, alive3 = merge_all_rows(alive2, inc, planes, tuple(blocks))
    dropped = n0 - alive3.to(torch.int32).sum()
    return planes, alive3, dropped
