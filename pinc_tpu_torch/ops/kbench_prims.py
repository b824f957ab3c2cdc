"""The exchange primitives of the kernel benchmark — the counterpart of
K13's exchange-primitive probes: ``experiments/r4_gather_probe{,2,3}.py``,
``experiments/r4_roll_probe.py``, ``experiments/r5_progoverhead.py`` and
``experiments/archive/kbench7.py``.

On the TPU these probes decided how the exchange was built: the lane
gathers of the gather exchange, the spill passes' row rotation, and what a
grid program costs.  They compute four functions, each a CUDA kernel
written for Hopper (``csrc/kbench_prims.cu``) with one launch counter:

==================  =====================================================
kernel (LAUNCHES)   what it computes
==================  =====================================================
kbench_take         ``take_along_axis`` along the rows or the lanes of a
                    (batch, R, C) stack of 4-byte words (float32 or int32)
kbench_roll         ``roll`` along the rows or the lanes, by a host int or
                    by an int32 shift on the device
kbench_plane_add    ``x + 1.0`` of up to 8 float32 planes, G tiles a block
kbench_lane_prefix  the inclusive prefix sum of each row of an (NT, B)
                    float32 array, in the reference's log-step order
==================  =====================================================

Index semantics are JAX's: an index in [-n, 0) wraps, any other index
outside [0, n) gives the fill value (NaN for float32, INT32_MIN for
int32).  A shift is taken mod n, as ``np.roll`` does.  The gathers and
rolls copy bits; the prefix sum adds in ``kbench7.py _prefix_lanes``'s
order (``x_s[i] = x_{s-1}[i] + x_{s-1}[i-s]`` for s = 1, 2, 4, ... < B,
``+ 0.0`` below s), so kernel, plain version and reference agree bit for
bit on any float32 input.

A wrapper checks its inputs; given CPU tensors it then runs the plain
version, given CUDA tensors it launches the kernel on the current stream,
raises on a nonzero launch error and adds one to ``LAUNCHES[name]``.
There is no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Union

import torch

from . import _cuda_build
from .tiled_kernels import _check, _is_cpu, _launch, _ptr, _stream

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"kbench_take": 0, "kbench_roll": 0, "kbench_plane_add": 0,
            "kbench_lane_prefix": 0}

_R4 = "experiments/r4_gather_probe.py"
_R4_3 = "experiments/r4_gather_probe3.py"

#: each function of the six probe files that reaches pl.pallas_call, at its
#: def (r4_gather_probe.py's module-level ``gat`` at its assignment), and
#: what computes it in the port: (LAUNCHES key, detail), None where the
#: reference cannot run
FUNCTIONS = {
    "r4_gather_probe.build_taa_extract": (f"{_R4}:49", (
        "kbench_take", "lanes, (8, 2176) by (8, 768)")),
    "r4_gather_probe.build_taa_merge": (f"{_R4}:63", (
        "kbench_take", "lanes, (8, 768) by (8, 2176)")),
    "r4_gather_probe.build_taa_square": (f"{_R4}:78", (
        "kbench_take", "lanes, (8, 2176) by (8, 2176)")),
    "r4_gather_probe.build_taa_sublane": (f"{_R4}:94", (
        "kbench_take", "rows, (64, 128)")),
    "r4_gather_probe.gat": (f"{_R4}:136", (
        "kbench_take", "lanes, a block a tile, (NT, 8, 2176) by "
                       "(NT, 8, 768)")),
    "r4_gather_probe2.probe": ("experiments/r4_gather_probe2.py:13", (
        "kbench_take", "lanes (8, 128), (8, 256), (16, 128), (256, 128); "
                       "rows (8, 128)")),
    "r4_gather_probe3.int_gather": (f"{_R4_3}:35", (
        "kbench_take", "int32 words, lanes (8, 128)")),
    "r4_gather_probe3.dyn_roll": (f"{_R4_3}:54", (
        "kbench_roll", "lanes (8, 256), the shift on the device")),
    "r4_gather_probe3.run_extract": (f"{_R4_3}:142", (
        None, "no port: the reference does not trace")),
    "r4_roll_probe.run": ("experiments/r4_roll_probe.py:19", (
        "kbench_roll", "rows (8, 128), static shift p = 0..7")),
    "r5_progoverhead.mk": ("experiments/r5_progoverhead.py:43", (
        "kbench_plane_add", "7 planes (NT, 8, 2176), G = 1, 4, 8 tiles a "
                            "block")),
    "kbench7.pallas_scan": ("experiments/archive/kbench7.py:44", (
        "kbench_lane_prefix", "(NT, 9216), log-step order")),
}

#: the TPU kernel each CUDA kernel replaces (the first function of
#: FUNCTIONS that it computes)
REPLACES = {key: next(where for where, (k, _) in FUNCTIONS.values()
                      if k == key)
            for key in LAUNCHES}

SOURCE = "pinc_tpu_torch/csrc/kbench_prims.cu"

#: the fill of an out-of-range index: float32 NaN and INT32_MIN, as bits
FILL_BITS = {torch.float32: 0x7FC00000, torch.int32: -2 ** 31}
MAX_PLANES = 8
#: the prefix sum keeps a row twice in shared memory (227 KB a block)
MAX_PREFIX_B = 232448 // 8
#: take's chunk: about this many bytes of source a CTA (take_layout)
TAKE_CHUNK_BYTES = 16384
#: a chunk that needs more shared memory than this even at its least (one
#: row along the lanes, a strip of TAKE_MIN_STRIP columns along the rows)
#: reads the source through L1 instead of staging it
TAKE_STAGE_MAX_BYTES = 49152
#: a strip along the rows is at least this many columns (coalesced loads)
TAKE_MIN_STRIP = 32

WORDS = (torch.float32, torch.int32)
#: lane_prefix keeps at most this many elements of a row a thread in
#: registers
MAX_PREFIX_R = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _block_axis(t: torch.Tensor, axis: int, name: str) -> int:
    """axis of t (rank 2: one block, rank 3: a stack of blocks) -> 1 for
    the lanes, 0 for the rows of a block."""
    if t.dim() not in (2, 3):
        raise ValueError(f"{name} must be a (R, C) block or a (batch, R, C) "
                         f"stack, got rank {t.dim()}")
    a = axis + t.dim() if axis < 0 else axis
    if a not in (t.dim() - 2, t.dim() - 1):
        raise ValueError(f"axis {axis} is not a row or lane axis of a "
                         f"rank-{t.dim()} {name}")
    return a - (t.dim() - 2)


def _nonempty(t: torch.Tensor, name: str) -> None:
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")


def lane_prefix_layout(B: int):
    """(W, R) of lane_prefix's kernel for rows of B elements: W threads a
    row (the smallest power of two >= 32 that leaves R = ceil(B / W) <=
    MAX_PREFIX_R), element i = r * W + t in register r of thread t."""
    W = 32
    while -(-B // W) > MAX_PREFIX_R:
        W *= 2
    return W, -(-B // W)


class TakePlan(NamedTuple):
    """The chunks take's kernel launches (take_layout)."""
    rows: int        #: source rows a chunk (Rs along the rows)
    cols: int        #: source columns a chunk (Cs along the lanes)
    blocks: int      #: blocks a CTA (> 1 only where a chunk is a block)
    chunks: int      #: CTAs a block (chunks of a block)
    smem_bytes: int  #: shared memory a CTA; 0: the source read through L1

    def ctas(self, batch: int) -> int:
        """CTAs of a launch on batch blocks."""
        return -(-batch // self.blocks) * self.chunks


def take_layout(Rs: int, Cs: int, Ri: int, Ci: int, lanes: int,
                chunk_bytes: int = TAKE_CHUNK_BYTES,
                stage: bool = True) -> TakePlan:
    """The chunk plan of take's kernel for (Rs, Cs) source blocks, (Ri,
    Ci) index blocks, along the lanes (lanes = 1: output row r reads
    source row r) or the rows (output column c reads source column c).  A
    chunk holds about chunk_bytes of source: g whole rows along the lanes,
    a strip of w >= TAKE_MIN_STRIP columns (a multiple of it) over all Rs
    rows along the rows; the chunks of a block are balanced.  Where a
    whole block fits, a CTA takes as many blocks as fit, counting the
    index block too.  A chunk is staged in shared memory unless stage is
    false or even its least (one row, one minimal strip) needs more than
    TAKE_STAGE_MAX_BYTES; the chunk shape then splits the output alike."""
    budget = max(1, chunk_bytes // 4)                # source words
    # the axis a block splits along (n rows or n columns) and its part
    if lanes:
        n, part, least = Rs, max(1, budget // Cs), Cs
    else:
        step = TAKE_MIN_STRIP
        n, part, least = Cs, max(step, budget // Rs // step * step), Rs * step
    stage = stage and least * 4 <= TAKE_STAGE_MAX_BYTES
    if part >= n:                                    # whole blocks
        size, chunks = n, 1
        blocks = max(1, budget // max(Rs * Cs, Ri * Ci))
    else:
        chunks = -(-n // part)
        size = -(-n // chunks)
        if not lanes:
            size = -(-size // step) * step
            chunks = -(-n // size)
        blocks = 1
    rows, cols = (size, Cs) if lanes else (Rs, size)
    return TakePlan(rows, cols, blocks, chunks,
                    blocks * rows * cols * 4 if stage else 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def take_plain(src: torch.Tensor, idx: torch.Tensor,
               axis: int = -1) -> torch.Tensor:
    """jnp.take_along_axis(src, idx, axis): indices in [-n, 0) wrap, any
    other out-of-range index gives NaN (float32) or INT32_MIN (int32)."""
    n = src.shape[axis]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    got = torch.gather(src, axis, i.clamp(0, n - 1))
    fill = torch.tensor(FILL_BITS[src.dtype], dtype=torch.int32,
                        device=src.device).view(src.dtype)
    return torch.where(inside, got, fill)


def roll_plain(x: torch.Tensor, shift: Union[int, torch.Tensor],
               axis: int = -1) -> torch.Tensor:
    """np.roll(x, shift, axis); a device shift is read with .item()."""
    s = shift.item() if isinstance(shift, torch.Tensor) else shift
    return torch.roll(x, int(s) % x.shape[axis], axis)


def plane_add_plain(planes: Sequence[torch.Tensor],
                    G: int = 1) -> list:
    """[p + 1.0 for p in planes] (G, the tiles a block, does not change
    the function)."""
    return [p + 1.0 for p in planes]


def lane_prefix_plain(m: torch.Tensor) -> torch.Tensor:
    """kbench7.py _prefix_lanes: the inclusive prefix sum along the last
    axis, x <- x + [0 (s), x[:-s]] for s = 1, 2, 4, ... < B."""
    x = m
    b = x.shape[-1]
    s = 1
    while s < b:
        shifted = torch.cat([torch.zeros(x.shape[:-1] + (s,),
                                         dtype=x.dtype, device=x.device),
                             x[..., :-s]], dim=-1)
        x = x + shifted
        s *= 2
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def take(src: torch.Tensor, idx: torch.Tensor, axis: int = -1,
         plan: Optional[TakePlan] = None) -> torch.Tensor:
    """take_along_axis along a row or lane axis: src (R, Cs) or (batch,
    R, Cs) float32 or int32, idx int32 of src's rank whose extents equal
    src's but along ``axis`` -> idx's shape, src's type (the module's
    index semantics).  plan: the chunks the kernel launches (default
    take_layout's; the benchmark's chunk sweep passes others).

    Replaces the lane and row gathers of r4_gather_probe{,2,3}.py
    (FUNCTIONS).  Bound on the card: src, idx and the output moved once
    (bytes).  Design: a lane gather's output row reads one source row, a
    row gather's output column one source column, so a CTA takes a chunk
    of about TAKE_CHUNK_BYTES of source (take_layout): whole rows, or a
    strip of columns over all rows; several small blocks a CTA, a large
    block over several CTAs, so an SM holds several CTAs and one's loads
    overlap another's gathers.  The chunk is staged in shared memory with
    16-byte loads, then each thread gathers its output words from it, idx
    read and the output written coalesced; a chunk too wide to stage
    reads the source through L1."""
    lanes = _block_axis(src, axis, "src")
    if idx.dim() != src.dim():
        raise ValueError(f"idx has rank {idx.dim()}, src {src.dim()}")
    want = list(src.shape)
    want[axis] = idx.shape[axis]
    _check(src, "src", tuple(src.shape), src.device, dtypes=WORDS)
    _check(idx, "idx", tuple(want), src.device, dtypes=(torch.int32,))
    _nonempty(src, "src")
    _nonempty(idx, "idx")
    (Rs, Cs), (Ri, Ci) = src.shape[-2:], idx.shape[-2:]
    if max(Rs * Cs, Ri * Ci) >= 2 ** 31:
        raise ValueError(f"take indexes a block with int32: R * C < 2^31 "
                         f"words, got {Rs} x {Cs} and {Ri} x {Ci}")
    if _is_cpu(src, "take"):
        return take_plain(src, idx, axis)
    batch = src.shape[0] if src.dim() == 3 else 1
    if plan is None:
        plan = take_layout(Rs, Cs, Ri, Ci, lanes)
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    lib = _cuda_build.load()
    with torch.cuda.device(src.device):
        _launch("kbench_take", lib.pinc_kp_take, _ptr(src), _ptr(idx),
                _ptr(out), batch, Rs, Cs, Ri, Ci, lanes,
                FILL_BITS[src.dtype], _stream(src.device), plan.rows,
                plan.cols, plan.blocks, int(plan.smem_bytes > 0),
                counts=LAUNCHES)
    return out


def roll(x: torch.Tensor, shift: Union[int, torch.Tensor],
         axis: int = -1) -> torch.Tensor:
    """np.roll(x, shift, axis) along a row or lane axis of x, (R, C) or
    (batch, R, C) float32 or int32; shift a host int or an int32 tensor
    of one element on x's device, which the kernel reads (no host sync).

    Replaces r4_roll_probe.py's static sublane roll and
    r4_gather_probe3.py's dyn_roll (FUNCTIONS).  Bound on the card: x read
    and the output written once (bytes).  Design: one block a row of the
    (batch R, C) view; a row roll copies a whole source row with 16-byte
    loads, a lane roll reads each row at the shifted offset, coalesced but
    for the wrap."""
    lanes = _block_axis(x, axis, "x")
    _check(x, "x", tuple(x.shape), x.device, dtypes=WORDS)
    _nonempty(x, "x")
    n = x.shape[axis]
    on_device = isinstance(shift, torch.Tensor)
    if on_device:
        _check(shift, "shift", tuple(shift.shape), x.device,
               dtypes=(torch.int32,))
        if shift.numel() != 1:
            raise ValueError(f"shift must hold one int32, got shape "
                             f"{tuple(shift.shape)}")
    if _is_cpu(x, "roll"):
        return roll_plain(x, shift, axis)
    R, C = x.shape[-2:]
    rows = x.numel() // C
    out = torch.empty_like(x)
    lib = _cuda_build.load()
    with torch.cuda.device(x.device):
        _launch("kbench_roll", lib.pinc_kp_roll, _ptr(x), _ptr(out),
                ctypes.c_void_p(shift.data_ptr() if on_device else None),
                0 if on_device else int(shift) % n, rows, R, C, lanes,
                _stream(x.device), counts=LAUNCHES)
    return out


def plane_add(planes: Sequence[torch.Tensor], G: int = 1) -> list:
    """[p + 1.0 for p in planes]: 1..8 float32 planes of one shape (NT,
    ...), each tile (one index of the first axis) a unit; G tiles a block.

    Replaces r5_progoverhead.py's pass-through (FUNCTIONS), whose G tiles
    a grid program become G tiles a block.  Bound on the card: each plane
    read and written once (bytes).  Design: the planes' pointers as one
    struct argument; a block adds 1.0 (round to nearest) to its G tiles of
    every plane in the reference's order, with float4 loads where every
    tile is 16-byte aligned."""
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"plane_add takes 1 to {MAX_PLANES} planes, got "
                         f"{len(planes)}")
    if G < 1:
        raise ValueError(f"G must be >= 1, got {G}")
    first = planes[0]
    if first.dim() < 1:
        raise ValueError("the planes must have a tile axis")
    for k, p in enumerate(planes):
        _check(p, f"planes[{k}]", tuple(first.shape), first.device)
    _nonempty(first, "planes[0]")
    if _is_cpu(first, "plane_add"):
        return plane_add_plain(planes, G)
    NT = first.shape[0]
    outs = [torch.empty_like(p) for p in planes]
    ptrs = (ctypes.c_void_p * (2 * len(planes)))(
        *[p.data_ptr() for p in planes], *[o.data_ptr() for o in outs])
    lib = _cuda_build.load()
    with torch.cuda.device(first.device):
        _launch("kbench_plane_add", lib.pinc_kp_plane_add, ptrs, len(planes),
                NT, first.numel() // NT, G, _stream(first.device),
                counts=LAUNCHES)
    return outs


def lane_prefix(m: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of each row of m (NT, B) float32, in
    kbench7.py's log-step order (bit for bit with lane_prefix_plain);
    B <= MAX_PREFIX_B.

    Replaces kbench7.py's pallas_scan (FUNCTIONS).  Bound on the card: m
    read and the output written once (bytes); its ceil(log2 B) passes (14
    at B = 9216) are instructions and syncs.  Design: one block of W
    threads a row, the row in registers (lane_prefix_layout: element
    r * W + t in register r of thread t), so the passes s >= W add
    another register of the same thread, the passes s < 32 shuffle within
    the warp (only the first s lanes take their partner through shared
    memory), and only the passes 32 <= s < W go through the row in shared
    memory, double-buffered for one __syncthreads a pass; each add
    __fadd_rn so that no contraction changes a rounding."""
    if m.dim() != 2:
        raise ValueError(f"m must be (NT, B), got rank {m.dim()}")
    _check(m, "m", tuple(m.shape), m.device)
    _nonempty(m, "m")
    NT, B = m.shape
    if B > MAX_PREFIX_B:
        raise ValueError(f"lane_prefix keeps a row twice in shared memory: "
                         f"B <= {MAX_PREFIX_B}, got {B}")
    if _is_cpu(m, "lane_prefix"):
        return lane_prefix_plain(m)
    out = torch.empty_like(m)
    lib = _cuda_build.load()
    with torch.cuda.device(m.device):
        _launch("kbench_lane_prefix", lib.pinc_kp_lane_prefix, _ptr(m),
                _ptr(out), NT, B, *lane_prefix_layout(B), _stream(m.device),
                counts=LAUNCHES)
    return out
