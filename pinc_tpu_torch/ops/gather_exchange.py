"""The gather-exchange re-bucket — the counterpart of
``pinc_tpu/ops/pallas_gather_exchange.py``.

A re-bucket moves every live slot that left its tile (a coordinate outside
[0, T)) into the neighbouring tile, one axis hop at a time, through
fixed-capacity buffers.  Three kernels, hand-written in CUDA C++ for
Hopper (``csrc/gather_exchange.cu``, built by ``ops/_cuda_build.py``),
each with a plain PyTorch version of the same signature and layout beside
it:

===========  ===============================================================
``extract``  K8, replaces ``pallas_gather_exchange._extract_g`` (the
             wrappers ``extract_rows_g``, ``extract_all_rows_g`` and
             ``extract_compact_rows_g``)
``cleanup``  K10, replaces ``pallas_gather_exchange.cleanup_rows_g``
``merge``    K9, replaces ``pallas_gather_exchange.merge_rows_g``
===========  ===============================================================

The row semantics of pinc_tpu are part of the result and are kept: a
tile's B slots are 8 rows of L = B/8 contiguous slots.  Leaver ranks and
the buffer caps are per row, in slot order; buffers are payload-major
``(NT, 7, 8, W)`` (x, y, z, vx, vy, vz, flag), zero beyond each row's
count; the merge fills each row's free slots (alive <= 0.5) in slot order
from the same row's compacted blocks, then spill passes p = 1..7 place
row (r - p) % 8's leftovers into row r's remaining free slots.  So the port
agrees with pinc_tpu slot for slot and drop for drop.

The merge writes the arrivals IN PLACE into the planes and alive it is
given (only arrival slots are written; pinc_tpu returns new arrays with the
same values), and the drivers therefore update the caller's planes.  The
extract returns a new alive plane and leaves its inputs untouched.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
checks them, launches the kernel on the current stream, raises on a
nonzero launch error, and adds one to ``LAUNCHES[name]``.  There is no
fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _cuda_build
from .tiled_kernels import _check, _is_cpu, _launch, _ptr, _stream

NPAY = 7        # x, y, z, vx, vy, vz, flag

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"extract": 0, "cleanup": 0, "merge": 0}

#: the TPU kernel each CUDA kernel replaces (file:line of the function
#: that reaches pl.pallas_call on the main path)
REPLACES = {
    "extract": "pinc_tpu/ops/pallas_gather_exchange.py:220",
    "cleanup": "pinc_tpu/ops/pallas_gather_exchange.py:540",
    "merge": "pinc_tpu/ops/pallas_gather_exchange.py:422",
}

SOURCE = "pinc_tpu_torch/csrc/gather_exchange.cu"

# classifier codes of csrc/gather_exchange.cu (0, 1, 2: one axis)
_ALL, _ANY = 3, 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(B: int) -> bool:
    """The row layout needs B % 1024 == 0 (as in pinc_tpu)."""
    return B % 1024 == 0


def round_cap(k: int) -> int:
    """Buffer widths are multiples of 128, at least 128 (pinc_tpu's vreg
    rounding, kept so the caps and therefore the drops agree); rounding
    the cap up only reduces drops."""
    return max(128, -(-k // 128) * 128)


def total_cap(Ks: int, K: int = None) -> int:
    """Default single-class extract cap (total leavers per row): 3*Ks,
    floored, when the tile-level face cap K is known, at the mean total
    flux per row (K/2) plus 5 Poisson sigmas."""
    ku = 3 * Ks
    if K is not None:
        mean_row = K / 2.0
        ku = max(ku, int(mean_row + 5.0 * mean_row ** 0.5) + 1)
    return round_cap(ku)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _rows(a: torch.Tensor) -> torch.Tensor:
    """(NT, B) -> the (NT, 8, L) row view."""
    NT, B = a.shape
    return a.reshape(NT, 8, B // 8)


def _classify_dim(d: int):
    def classify(planes, alive, T):
        al = alive > 0.5
        c = planes[d]
        lm = al & (c < 0.0)
        lp = al & (c >= float(T))
        return (lm, lp), lm | lp
    return classify


def _classify_all(planes, alive, T):
    """Priority x > y > z: classes [xm, xp, ym, yp, zm, zp]."""
    al = alive > 0.5
    Tf = float(T)
    x, y, z = planes[0], planes[1], planes[2]
    xm = al & (x < 0.0)
    xp = al & (x >= Tf)
    xa = xm | xp
    ym = al & ~xa & (y < 0.0)
    yp = al & ~xa & (y >= Tf)
    ya = ym | yp
    zm = al & ~xa & ~ya & (z < 0.0)
    zp = al & ~xa & ~ya & (z >= Tf)
    return (xm, xp, ym, yp, zm, zp), xa | ya | zm | zp


def _classify_any(planes, alive, T):
    """One class: every leaver, its direction resolved by a cleanup."""
    al = alive > 0.5
    Tf = float(T)
    x, y, z = planes[0], planes[1], planes[2]
    leave = al & ((x < 0.0) | (x >= Tf) | (y < 0.0) | (y >= Tf)
                  | (z < 0.0) | (z >= Tf))
    return (leave,), leave


_CLASSIFIERS = {0: _classify_dim(0), 1: _classify_dim(1), 2: _classify_dim(2),
                _ALL: _classify_all, _ANY: _classify_any}


def _compact(out: torch.Tensor, mask: torch.Tensor, pays, col0: int,
             cap: int) -> None:
    """Write each row's masked entries, in order, to columns
    [col0, col0 + cap) of the payload-major buffer out (NT, 7, 8, W);
    entries ranked >= cap are left out.  pays: 7 (NT, 8, n) sources
    (None for the flag: written as 1.0)."""
    rank = torch.cumsum(mask, dim=2, dtype=torch.int32) - 1
    t, r, j = torch.nonzero(mask & (rank < cap), as_tuple=True)
    col = col0 + rank[t, r, j].long()
    for p, src in enumerate(pays):
        out[t, p, r, col] = 1.0 if src is None else src[t, r, j]


def _extract_plain(alive, planes, kind: int, Ks: int, T: int):
    masks, leave = _CLASSIFIERS[kind]([_rows(p) for p in planes[:3]],
                                      _rows(alive), T)
    NT, B = alive.shape
    buf = torch.zeros((NT, NPAY, 8, len(masks) * Ks), dtype=torch.float32,
                      device=alive.device)
    pays = [_rows(p) for p in planes] + [None]
    for c, m in enumerate(masks):
        _compact(buf, m, pays, c * Ks, Ks)
    alive2 = torch.where(leave, torch.zeros((), device=alive.device),
                         _rows(alive))
    return buf, alive2.reshape(NT, B)


def extract_rows_g_plain(coord_d: int, alive, planes, Ks: int, T: int):
    return _extract_plain(alive, planes, coord_d, Ks, T)


def extract_all_rows_g_plain(alive, planes, Ks: int, T: int):
    return _extract_plain(alive, planes, _ALL, Ks, T)


def extract_compact_rows_g_plain(alive, planes, KU: int, T: int):
    return _extract_plain(alive, planes, _ANY, KU, T)


def cleanup_rows_g_plain(inc: torch.Tensor, Ke: int, T: int, axes,
                         canon: bool = False):
    """See cleanup_rows_g.  canon: copy each value as x + 0.0 (-0.0 becomes
    +0.0, as in pinc_tpu's one-hot cleanup_rows)."""
    NT, _, _, W = inc.shape
    Tf = float(T)
    valid = inc[:, 6] > 0.5
    taken = torch.zeros_like(valid)
    masks = []
    for a in axes:
        cc = inc[:, a]
        m_m = valid & ~taken & (cc < 0.0)
        m_p = valid & ~taken & (cc >= Tf)
        masks += [m_m, m_p]
        taken = taken | m_m | m_p
    masks = [valid & ~taken] + masks
    pays = [inc[:, p] + 0.0 if canon else inc[:, p] for p in range(NPAY)]
    outs = []
    for c, m in enumerate(masks):
        cap = W if c == 0 else Ke
        out = torch.zeros((NT, NPAY, 8, cap), dtype=torch.float32,
                          device=inc.device)
        _compact(out, m, pays, 0, cap)
        outs.append(out)
    return outs[0], tuple(outs[1:])


def merge_rows_g_plain(alive: torch.Tensor, inc: torch.Tensor, planes,
                       blocks):
    """See merge_rows_g (in place into planes and alive)."""
    NT, B = alive.shape
    dev = alive.device
    al = _rows(alive)
    outs = [_rows(p) for p in planes]
    valid = inc[:, 6] > 0.5
    n_b = torch.stack([valid[:, :, off:off + w].sum(-1)
                       for off, w in blocks], -1)            # (NT, 8, nb)
    ends = torch.cumsum(n_b, -1)
    starts = ends - n_b
    offs = torch.tensor([off for off, _ in blocks], device=dev)
    n_arr = ends[..., -1]                                     # (NT, 8)
    consumed = torch.zeros_like(n_arr)
    rows = torch.arange(8, device=dev)
    for p in range(8):
        if p and not bool((n_arr - consumed).any()):
            break
        src = (rows - p) % 8                 # source row of each dest row
        n_avail = (n_arr - consumed)[:, src]                  # per dest row
        free = al <= 0.5
        frank = torch.cumsum(free, -1) - 1
        take = free & (frank < n_avail[..., None])
        t, r, j = torch.nonzero(take, as_tuple=True)
        s = src[r]
        arank = consumed[t, s] + frank[t, r, j]
        b = (ends[t, s] <= arank[:, None]).sum(-1)
        col = offs[b] + arank - starts[t, s, b]
        for pp in range(6):
            outs[pp][t, r, j] = inc[t, pp, s, col]
        al[t, r, j] = 1.0
        consumed[:, src] += take.sum(-1)
    return tuple(planes), alive


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_planes(alive: torch.Tensor, planes: Sequence[torch.Tensor],
                  dev: torch.device) -> Tuple[int, int]:
    if alive.dim() != 2:
        raise ValueError("alive must be (NT, B)")
    NT, B = alive.shape
    if not supported(B):
        raise ValueError(f"the gather exchange needs B % 1024 == 0, got "
                         f"B = {B}")
    if len(planes) != 6:
        raise ValueError(f"expected 6 planes (x, y, z, vx, vy, vz), got "
                         f"{len(planes)}")
    _check(alive, "alive", (NT, B), dev)
    for i, p in enumerate(planes):
        _check(p, f"planes[{i}]", (NT, B), dev)
    return NT, B


def _extract(alive, planes, kind: int, Ks: int, T: int):
    """K8: classify leavers, kill them, compact their 7 values per row.

    Replaces pinc_tpu/ops/pallas_gather_exchange.py ``_extract_g``.  Bound
    on the card: bytes — alive and the classifier's coordinates read (8
    B/slot for one axis, 16 for all axes) and alive written (4 B/slot),
    plus 24 B read and 28 B written per leaver and the zero tail of the
    buffer.  Design: one block per tile, one warp per row walking its L
    slots in 128-slot chunks, 4 slots a lane: 16-byte loads of alive and
    the classifier planes, the next chunk's in flight while a chunk is
    ranked, a 16-byte store of alive; slot-order ranks from four ballots a
    class with the run carried in registers, a leaver writing only its
    slot into its buffer column; then the whole block fills the buffer:
    the leavers' values gathered by slot, zeros beyond, 16-byte stores."""
    dev = alive.device
    NT, B = _check_planes(alive, planes, dev)
    if Ks % 128:
        raise ValueError(f"the extract cap must be a multiple of 128, got {Ks}")
    if _is_cpu(alive, "extract"):
        return _extract_plain(alive, planes, kind, Ks, T)
    check_aligned16(alive=alive, **classifier_planes(planes, kind))
    n_cls = {_ALL: 6, _ANY: 1}.get(kind, 2)
    buf = torch.empty((NT, NPAY, 8, n_cls * Ks), dtype=torch.float32,
                      device=dev)
    alive2 = torch.empty_like(alive)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("extract", lib.pinc_gx_extract, _ptr(alive),
                *[_ptr(p) for p in planes], _ptr(buf), _ptr(alive2), NT, B,
                kind, Ks, float(T), _stream(dev), counts=LAUNCHES)
    return buf, alive2


def extract_rows_g(coord_d: int, alive: torch.Tensor, planes, Ks: int,
                   T: int):
    """Per-dim extract: leavers along axis coord_d.  Returns (bufs
    (NT, 7, 8, 2*Ks) — minus run [0, Ks), plus run [Ks, 2Ks) — and the
    new alive (NT, B) with every leaver killed).  Ks % 128 == 0."""
    if coord_d not in (0, 1, 2):
        raise ValueError(f"coord_d must be 0, 1 or 2, got {coord_d}")
    return _extract(alive, planes, coord_d, Ks, T)


def extract_all_rows_g(alive: torch.Tensor, planes, Ks: int, T: int):
    """All axes in one pass, priority x > y > z: runs [xm, xp, ym, yp, zm,
    zp], each Ks wide."""
    return _extract(alive, planes, _ALL, Ks, T)


def extract_compact_rows_g(alive: torch.Tensor, planes, KU: int, T: int):
    """One class: every leaver in one (NT, 7, 8, KU) run, its direction
    resolved by cleanup_rows_g."""
    return _extract(alive, planes, _ANY, KU, T)


def cleanup_rows_g(inc: torch.Tensor, Ke: int, T: int, axes):
    """K10: inc (NT, 7, 8, W) arrivals; classify each valid column against
    the remaining ``axes`` (first axis out wins), compact the settled ones
    (cap W) and each direction's extras (cap Ke).  Returns (settled
    (NT, 7, 8, W), tuple of 2*len(axes) extras (NT, 7, 8, Ke)).

    Replaces pinc_tpu/ops/pallas_gather_exchange.py ``cleanup_rows_g``.
    Bound on the card: bytes — the flag plane read, 24 B read per valid
    column and every output written once.  Design: one block per tile, one
    warp per row in 128-column chunks, 4 columns a lane: 16-byte loads of
    the flags and the remaining axes' coordinates, the next chunk's in
    flight; slot-order ranks from four ballots a class, a valid column
    writing only its index into its output; then the whole block fills
    the outputs: the valid columns' 7 values gathered from the row, zeros
    beyond, 16-byte stores.  One template per axes tuple the exchanges
    use: (0, 1, 2), (1, 2) and (2,)."""
    return _cleanup(inc, Ke, T, tuple(axes), settled=True)


def cleanup_faces_g(inc: torch.Tensor, Ks: int, T: int):
    """K10 as the first cleanup of rebucket_exchange_all_rows_g: inc is the
    compact extract's buffer, whose valid columns are all out on some axis,
    so cleanup_rows_g(inc, Ks, T, (0, 1, 2)) leaves its settled output
    empty; the kernel neither computes nor writes it.  Returns the six face
    buffers (NT, 7, 8, Ks) [xm, xp, ym, yp, zm, zp]."""
    return _cleanup(inc, Ks, T, (0, 1, 2), settled=False)[1]


def cleanup_faces_g_plain(inc: torch.Tensor, Ks: int, T: int):
    return cleanup_rows_g_plain(inc, Ks, T, (0, 1, 2))[1]


def _cleanup(inc: torch.Tensor, Ke: int, T: int, axes, settled: bool):
    W = _check_inc(inc)
    if W % 128 or Ke % 128:
        raise ValueError(f"W and Ke must be multiples of 128, got {W}, {Ke}")
    if _is_cpu(inc, "cleanup"):
        return cleanup_rows_g_plain(inc, Ke, T, axes)
    return launch_cleanup(inc, Ke, T, axes, False, "cleanup", LAUNCHES,
                          settled=settled)


def _check_inc(inc: torch.Tensor) -> int:
    """inc must be a contiguous float32 (NT, 7, 8, W); returns W."""
    if inc.dim() != 4 or tuple(inc.shape[1:3]) != (NPAY, 8):
        raise ValueError(f"inc must be (NT, 7, 8, W), got {tuple(inc.shape)}")
    _check(inc, "inc", tuple(inc.shape), inc.device)
    return inc.shape[-1]


def classifier_planes(planes, kind: int) -> dict:
    """The planes an extract of this kind classifies on, by name: the
    coordinate plane of one axis (kind 0, 1, 2), else x, y and z."""
    axes = (kind,) if kind in (0, 1, 2) else (0, 1, 2)
    return {f"planes[{d}]": planes[d] for d in axes}


def check_aligned16(**tensors) -> None:
    """The extract kernels load and store alive, its classifier planes and
    the new alive in 16-byte groups that start at the same slot in each,
    and the gather merge walks alive in 16-byte groups: the inputs must
    start on a 16-byte boundary, as a fresh allocation and a (NT, B) plane
    of a stacked state with B % 4 == 0 do."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel's 16-byte loads), got address "
                             f"{t.data_ptr():#x}")


def launch_cleanup(inc: torch.Tensor, Ke: int, T: int, axes, canon: bool,
                   name: str, counts: dict, settled: bool = True):
    """Launch K10 on CUDA tensors (any W and Ke), adding one to
    counts[name]: the kernel of cleanup_rows_g and of the one-hot
    exchange's cleanup_rows (canon).  settled=False: no settled output is
    written, and None is returned in its place."""
    if axes not in ((0, 1, 2), (1, 2), (2,)):
        raise ValueError(f"the cleanup kernel takes axes (0, 1, 2), (1, 2) "
                         f"or (2,), got {axes}")
    NT, _, _, W = inc.shape
    dev = inc.device
    out = torch.empty_like(inc) if settled else None
    extras = [torch.empty((NT, NPAY, 8, Ke), dtype=torch.float32, device=dev)
              for _ in range(2 * len(axes))]
    ptrs = [_ptr(e) for e in extras] + [ctypes.c_void_p(None)] * (
        6 - len(extras))
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch(name, lib.pinc_gx_cleanup, _ptr(inc),
                ctypes.c_void_p(None) if out is None else _ptr(out),
                *ptrs, NT, W, Ke, len(axes), int(canon), float(T),
                _stream(dev), counts=counts)
    return out, tuple(extras)


def merge_rows_g(alive: torch.Tensor, inc: torch.Tensor, planes, blocks):
    """K9: place the arrivals of inc (NT, 7, 8, KT) — blocks = ((offset,
    width), ...) individually compacted runs, at most 8 — into the free
    slots (alive <= 0.5): each row's lowest free slots take the same
    row's arrivals in block order, then spill passes p = 1..7 give row r
    the leftovers of row (r - p) % 8.  Arrivals still unplaced are
    dropped.  Writes IN PLACE into ``planes`` and ``alive`` and returns
    them as (planes, alive).

    Replaces pinc_tpu/ops/pallas_gather_exchange.py ``merge_rows_g``.
    Bound on the card: bytes — the alive plane read up to the last free
    slot a row needs, the flag plane read, and 24 B read plus 28 B
    written per placed arrival.  Design: one block per tile, one warp per
    row: each warp counts its row's arrivals per block (flag plane), then
    walks its row's alive, both in 16-byte lane groups with the next
    chunk's loads in flight, and places pass 0 as it ranks the free slots
    (a lane a slot of each 32-slot word, so a store covers one 128-byte
    line of a plane).  Only a tile with leftovers runs the spill passes,
    each rescanning the row from slot 0, a slot a lane, with
    per-source-row consumed counters in shared memory.  alive must start
    on a 16-byte boundary (a fresh allocation, or a plane of a stacked
    state with B % 4 == 0)."""
    blocks = tuple((int(o), int(w)) for o, w in blocks)
    dev = alive.device
    NT, B = _check_planes(alive, planes, dev)
    if inc.dim() != 4 or tuple(inc.shape[:3]) != (NT, NPAY, 8):
        raise ValueError(f"inc must be ({NT}, 7, 8, KT), got "
                         f"{tuple(inc.shape)}")
    KT = inc.shape[-1]
    _check(inc, "inc", tuple(inc.shape), dev)
    if not 1 <= len(blocks) <= 8 or any(
            o < 0 or w < 0 or o + w > KT for o, w in blocks):
        raise ValueError(f"blocks must be 1 to 8 (offset, width) runs "
                         f"inside [0, {KT}), got {blocks}")
    if _is_cpu(alive, "merge"):
        return merge_rows_g_plain(alive, inc, planes, blocks)
    check_aligned16(alive=alive)
    table = (ctypes.c_int * 16)(*[v for ow in blocks for v in ow])
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("merge", lib.pinc_gx_merge, _ptr(alive), _ptr(inc),
                *[_ptr(p) for p in planes], table, len(blocks), NT, B, KT,
                _stream(dev), counts=LAUNCHES)
    return tuple(planes), alive


# ---------------------------------------------------------------------------
# Drivers (tile-grid rolls, concatenations and the +-T frame shift are
# plain torch ops around the kernels, as they sit outside Pallas in JAX)
# ---------------------------------------------------------------------------

def _shift_block(inc: torch.Tensor, d: int, T: int, parts) -> torch.Tensor:
    """Receiver-frame shift of coordinate d on a payload-major buffer (in
    place): parts = ((width, sign), ...) runs along the last axis."""
    shift = torch.cat([torch.full((w,), float(sgn) * float(T),
                                  dtype=torch.float32, device=inc.device)
                       for w, sgn in parts])
    inc[:, d] += torch.where(inc[:, 6] > 0.5, shift,
                             torch.zeros((), device=inc.device))
    return inc


def _torch_roll(a: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(a, shift, axis)


def exchange_dim_g(planes, alive: torch.Tensor, ntiles: Tuple[int, ...],
                   d: int, T: int, Ks: int, roll_fn=None):
    """One axis' +-1-tile transfer: extract, roll the minus run to the
    lower neighbour and the plus run to the upper one, shift, merge.
    roll_fn(x, shift, axis) replaces torch.roll over the tile grid (for a
    sharded grid).  Returns (planes, alive'); planes are updated in
    place."""
    NT, _ = alive.shape
    Ks = round_cap(Ks)
    nt = tuple(ntiles)
    roll = roll_fn or _torch_roll
    bufs, alive2 = extract_rows_g(d, alive, planes, Ks, T)
    b = bufs.reshape(nt + (NPAY, 8, 2 * Ks))
    minus = roll(b[..., :Ks], -1, d)
    plus = roll(b[..., Ks:], 1, d)
    inc = torch.cat([minus, plus], -1).reshape(NT, NPAY, 8, 2 * Ks)
    inc = _shift_block(inc, d, T, ((Ks, 1), (Ks, -1)))
    return merge_rows_g(alive2, inc, planes, ((0, Ks), (Ks, Ks)))


def rebucket_exchange_all_rows_g(planes, alive: torch.Tensor,
                                 ntiles: Tuple[int, ...], T: int, Ks: int,
                                 KU: int = None, roll_fns=None):
    """Fused all-axes exchange: one compact extract, a cleanup splitting
    it into six faces, the x -> y -> z hops over the small buffers (with a
    cleanup after x and after y re-routing corner movers), one merge.
    Ks is the row face cap, KU the total cap (default total_cap(Ks)); the
    cap of the extras re-routed by the x and y cleanups is Ke = max(128,
    Ks/4), rounded.  roll_fns: per-axis replacements of torch.roll (see
    exchange_dim_g).  Returns (planes, alive', n_dropped); planes are
    updated in place."""
    NT, _ = alive.shape
    nt = tuple(ntiles)
    roll = roll_fns or (_torch_roll,) * 3
    Ks = round_cap(Ks)
    Ke = round_cap(max(128, Ks // 4))
    n0 = alive.to(torch.int32).sum()

    KU = round_cap(KU) if KU else total_cap(Ks)
    bufs, alive2 = extract_compact_rows_g(alive, planes, KU, T)
    face6 = cleanup_faces_g(bufs, Ks, T)
    del bufs
    face = [f.reshape(nt + (NPAY, 8, Ks)) for f in face6]

    def cat(xs):
        return torch.cat(xs, -1)

    def flat(x):
        return x.reshape(NT, NPAY, 8, x.shape[-1])

    def grid5(x):
        return x.reshape(nt + (NPAY, 8, x.shape[-1]))

    # x hop: face buffers only
    inc_x = flat(cat([roll[0](face[0], -1, 0), roll[0](face[1], 1, 0)]))
    inc_x = _shift_block(inc_x, 0, T, ((Ks, 1), (Ks, -1)))
    settled_x, (ym_e, yp_e, zm_e, zp_e) = cleanup_rows_g(inc_x, Ke, T,
                                                         axes=(1, 2))
    Wx = 2 * Ks

    # y hop: the y faces + the x arrivals' y extras
    Wy1 = Ks + Ke
    ym_b = cat([face[2], grid5(ym_e)])
    yp_b = cat([face[3], grid5(yp_e)])
    inc_y = flat(cat([roll[1](ym_b, -1, 1), roll[1](yp_b, 1, 1)]))
    inc_y = _shift_block(inc_y, 1, T, ((Wy1, 1), (Wy1, -1)))
    settled_y, (zm_e2, zp_e2) = cleanup_rows_g(inc_y, Ke, T, axes=(2,))

    # z hop (the last axis: its arrivals are settled by construction)
    Wz1 = Ks + 2 * Ke
    zm_b = cat([face[4], grid5(zm_e), grid5(zm_e2)])
    zp_b = cat([face[5], grid5(zp_e), grid5(zp_e2)])
    inc_z = flat(cat([roll[2](zm_b, -1, 2), roll[2](zp_b, 1, 2)]))
    inc_z = _shift_block(inc_z, 2, T, ((Wz1, 1), (Wz1, -1)))

    # merge: settled_x, settled_y and the six z sub-runs, each compacted
    inc = cat([settled_x, settled_y, inc_z])
    blocks = []
    off = 0
    for w in (Wx, 2 * Wy1, Ks, Ke, Ke, Ks, Ke, Ke):
        blocks.append((off, w))
        off += w
    planes, alive3 = merge_rows_g(alive2, inc, planes, tuple(blocks))
    dropped = n0 - alive3.to(torch.int32).sum()
    return planes, alive3, dropped
