"""The deposit and gather variants of the kernel benchmark — the
counterpart of the Pallas kernels of ``script/bench_kernels_tpu.py`` (K12)
and of the deposit/gather probes of ``experiments/archive/kbench{,2,3,4,5,
9}.py`` (K13).

Those TPU kernels compute the tile deposit (K1) and gather (K3) under other
weight roundings, or with a part of the work taken out (ceilings).  Where a
probe computes K1's or K3's own function (``FUNCTIONS`` says which), the
port runs K1's or K3's kernel (``ops/tiled_kernels.py``); the others run two
CUDA kernels written for Hopper (``csrc/kbench.cu``), one launch counter a
mode:

=========================  ================================================
kernel (LAUNCHES key)      what it computes, per tile
=========================  ================================================
kbench_deposit_int8        rint(127 w(x) v) x rint(127 w(y) w(z)) summed
                           exactly in int32, x 1/127^2
kbench_deposit_bf16_native K1 with every weight op rounded to bf16
kbench_deposit_weight_sums X[a] + R[k]: the tile's sums of wx = w(x) v and
                           of wyz = w(y) w(z) (the "weights only" probe)
kbench_deposit_given_kron  sum over rows of wx_r (P, L) . kron^T, one
                           product a row, the (P^2, L) bf16 plane given
                           (the "dense accumulation only" probe)
kbench_gather_int8         field quantized per tile to int8 (scale =
                           max|E|), int32 sums, x scale/127^2
kbench_gather_bf16_native  K3 bf16 with wyz in bf16 arithmetic
kbench_gather_g_bf16       K3 bf16 with G = sum E wyz rounded to bf16
kbench_gather_no_xreduce   G at the first x node, no x reduction (ceiling)
=========================  ================================================

The probes see a tile's B slots as 8 rows of L = B/8 (``(NT*8, L)`` rows;
gathers write ``(C, NT, 8, L)``); that is a reshape of the ``(NT, B)``
planes, so the wrappers take the planes and return views.  Weights are
``pallas_tiled._weights_t``'s CIC hats; the probes' ``mxu_dtype``, bf16
in every one of them, rounds ``wx = w(x) v`` and ``wyz`` of WEIGHT_SUMS
and GIVEN_KRON to bf16.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
checks them, launches the kernel on the current stream, raises on a
nonzero launch error and adds one to ``LAUNCHES[name]``.  There is no
fallback from a CUDA tensor to the plain version.  The plain versions sum
each slot's terms in the kernels' order; only the deposits' sums over
slots (atomics) and GIVEN_KRON's and WEIGHT_SUMS' sums are taken in
another order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda_build
from . import tiled_kernels as tk
from .tiled import TileSpec
from .tiled_kernels import _check, _is_cpu, _launch, _ptr, _stream

DEPOSIT_MODES = ("int8", "bf16_native", "weight_sums", "given_kron")
GATHER_MODES = ("int8", "bf16_native", "g_bf16", "no_xreduce")

#: kernel launches per wrapper and mode since the last reset_launches()
LAUNCHES = {**{f"kbench_deposit_{m}": 0 for m in DEPOSIT_MODES},
            **{f"kbench_gather_{m}": 0 for m in GATHER_MODES}}

_K12 = "script/bench_kernels_tpu.py"
_AR = "experiments/archive"
_NO_REPEAT = (None, "cannot run: _kron_rows is gone from pallas_tiled")

#: each function of the six files that reaches pl.pallas_call, at its def,
#: and per kernel body or case what computes it in the port: (LAUNCHES key
#: of ops/tiled_kernels or of this module, detail), kernel None where the
#: reference cannot run
FUNCTIONS = {
    "bench_kernels_tpu.deposit_v": (f"{_K12}:69", {
        "kron='iota'": ("deposit", "K1, mxu_dtype f32 or bf16"),
        "kron='repeat'": _NO_REPEAT}),
    "bench_kernels_tpu.gather_v": (f"{_K12}:116", {
        "kron='iota'": ("gather", "K3, mxu_dtype f32 or bf16, stack or not"),
        "kron='repeat'": _NO_REPEAT}),
    "kbench.deposit_q": (f"{_AR}/kbench.py:99", {
        "_deposit_kernel_q": ("kbench_deposit_int8", "")}),
    "kbench.gather_q": (f"{_AR}/kbench.py:140", {
        "_gather_kernel_q": ("kbench_gather_int8", "quantize_field glue")}),
    "kbench.deposit_2acc": (f"{_AR}/kbench.py:199", {
        "_deposit_kernel_2acc": ("deposit", "K1 bf16")}),
    "kbench2.deposit_constk": (f"{_AR}/kbench2.py:74", {
        "_deposit_kernel_constk": ("kbench_deposit_given_kron", "")}),
    "kbench2.deposit_novpu": (f"{_AR}/kbench2.py:114", {
        "_deposit_kernel_novpu": (None, "no port: the reference does not "
                                        "trace")}),
    "kbench3.mk_dep": (f"{_AR}/kbench3.py:126", {
        "_deposit_kernel_batched": ("deposit", "K1 bf16"),
        "_deposit_kernel_onedot": ("deposit", "K1 bf16"),
        "_deposit_kernel_vpuonly": ("kbench_deposit_weight_sums", "")}),
    "kbench3.mk_gat": (f"{_AR}/kbench3.py:212", {
        "_gather_kernel_batched": ("gather", "K3 bf16"),
        "_gather_kernel_onedot": ("gather", "K3 bf16")}),
    "kbench4.mk_dep": (f"{_AR}/kbench4.py:122", {
        "_deposit_kernel_bf": ("kbench_deposit_bf16_native", "")}),
    "kbench4.mk_gat": (f"{_AR}/kbench4.py:200", {
        "_gather_kernel_bf": ("kbench_gather_bf16_native", ""),
        "_gather_kernel_nored": ("kbench_gather_no_xreduce", ""),
        "_gather_kernel_tdot": ("gather", "K3 bf16")}),
    "kbench5.dep_row": (f"{_AR}/kbench5.py:98", {
        "_dep_row_kernel": ("deposit", "K1 bf16")}),
    "kbench5.gat_row": (f"{_AR}/kbench5.py:131", {
        "gdtype=f32": ("gather", "K3 bf16"),
        "gdtype=bf16": ("kbench_gather_g_bf16", "")}),
    "kbench5.dep_row_q": (f"{_AR}/kbench5.py:212", {
        "_dep_row_kernel_q": ("kbench_deposit_int8", "")}),
    "kbench9.deposit_v4": (f"{_AR}/kbench9.py:73", {
        "_deposit_kernel_v4": ("deposit", "K1 bf16")}),
    "kbench9.gather_v4": (f"{_AR}/kbench9.py:106", {
        "_gather_kernel_v4": ("gather", "K3 bf16")}),
}

#: the TPU kernel each CUDA kernel mode replaces (the first function of
#: FUNCTIONS that it computes)
REPLACES = {key: next(where for where, ports in FUNCTIONS.values()
                      if any(k == key for k, _ in ports.values()))
            for key in LAUNCHES}

SOURCE = "pinc_tpu_torch/csrc/kbench.cu"

#: the probes' int8 scale 1/127^2 (a float32 constant, as in jnp)
INV_127SQ = 1.0 / (127.0 * 127.0)


def weight_sums_scale(B: int):
    """(k, j) of weight_sums' fixed-point R sums (tk.ACCUMULATOR) for B
    slots a tile: wyz = bf16(w(y) w(z)) <= 1 and does not depend on the
    value, so tk.deposit_scale's worst case of a tile at magnitude 1 (all
    B slots on one (y, z) node) holds every input."""
    return tk.deposit_scale((1.0,), B)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mode(mode: str, modes) -> int:
    if mode not in modes:
        raise ValueError(f"mode must be one of {modes}, got {mode!r}")
    return modes.index(mode)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _nodes_bf16(x: torch.Tensor, M: int, T: int):
    """tk._nodes with the weight in bf16 arithmetic (kbench4.py
    _weights_t_bf): d = bf16(x - n), w = max(0, 1 - |d|), each op rounded;
    [(index, bf16 weight)]."""
    f = torch.floor(x)
    out = []
    for k in (0, 1):
        n = f + k
        d = (x - n).bfloat16()
        w = torch.clamp(1 - d.abs(), min=0)
        inside = (n >= -M) & (n <= T + M)
        w = torch.where(inside, w, torch.zeros_like(w))
        idx = torch.where(inside, n + M, torch.zeros_like(n)).long()
        out.append((idx, w))
    return out


def _quant(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """rint(127 a b) as float (exact small integers)."""
    return torch.round(a * b * 127.0)


def _rows(a: torch.Tensor, L: int) -> torch.Tensor:
    """(n, B) planes -> (n, 8, L): the probes' rows."""
    return a.reshape(a.shape[0], 8, L)


def deposit_variant_plain(xyz: torch.Tensor, value: torch.Tensor,
                          ts: TileSpec, mode: str,
                          kron: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """xyz (3, NT, B) tile-local planes, value (NT, B) -> (NT, P, P*P) by
    the deposit variant ``mode`` (the module's table); kron (P*P, B/8) bf16
    for given_kron."""
    _mode(mode, DEPOSIT_MODES)
    _, NT, B = xyz.shape
    P, M, T = ts.P, ts.M, ts.T
    P2, L = P * P, B // 8
    dev = xyz.device
    isum = mode == "int8"
    out = torch.zeros(NT * P ** 3, dtype=torch.int64 if isum else
                      torch.float32, device=dev)
    if mode == "given_kron":
        kt = kron.float().t()
    for t0, t1 in tk._tile_chunks(NT, B):
        x, y, z = (xyz[d, t0:t1] for d in range(3))
        val = value[t0:t1]
        n = t1 - t0
        base = (torch.arange(t0, t1, device=dev) * P ** 3)[:, None]
        nx = tk._nodes(x, M, T, 1)
        if mode == "given_kron":            # wx_r (P, L) . kron^T a row
            S = torch.zeros((n, 8, P, L), dtype=torch.float32, device=dev)
            for ia, wa in nx:
                S.scatter_add_(2, _rows(ia, L)[:, :, None],
                               _rows(tk._round(wa * val, True), L)[:, :, None])
            prods = torch.matmul(S, kt)
            acc = prods[:, 0]
            for r in range(1, 8):
                acc = acc + prods[:, r]
            out.view(NT, P, P2)[t0:t1] = acc
            continue
        if mode == "weight_sums":
            ny, nz = tk._nodes(y, M, T, 1), tk._nodes(z, M, T, 1)
            X = torch.zeros(n * 8 * P, device=dev)
            R = torch.zeros(n * 8 * P2, device=dev)
            row = torch.arange(n * 8, device=dev).reshape(n, 8, 1)
            for ia, wa in nx:
                X.index_add_(0, (row * P + _rows(ia, L)).reshape(-1),
                             tk._round(wa * val, True).reshape(-1))
            for ib, wb in ny:
                for ic, wc in nz:
                    R.index_add_(0, (row * P2 + _rows(ib * P + ic, L))
                                 .reshape(-1),
                                 tk._round(wb * wc, True).reshape(-1))
            X, R = X.reshape(n, 8, P), R.reshape(n, 8, P2)
            acc = torch.zeros((n, P, P2), device=dev)
            for r in range(8):
                acc = acc + (X[:, r, :, None] + R[:, r, None, :])
            out.view(NT, P, P2)[t0:t1] = acc
            continue
        if isum:
            ny, nz = tk._nodes(y, M, T, 1), tk._nodes(z, M, T, 1)
            wxs = [(ia, _quant(wa, val)) for ia, wa in nx]
        else:
            ny, nz = _nodes_bf16(y, M, T), _nodes_bf16(z, M, T)
            vb = val.bfloat16()
            wxs = [(ia, (wa * vb).float())
                   for ia, wa in _nodes_bf16(x, M, T)]
        for ia, wa in wxs:
            for ib, wb in ny:
                for ic, wc in nz:
                    idx = base + (ia * P + ib) * P + ic
                    if isum:
                        w = (wa * _quant(wb, wc)).long()
                    else:
                        w = wa * (wb * wc).float()
                    out.index_add_(0, idx.reshape(-1), w.reshape(-1))
    if isum:
        out = out.float() * INV_127SQ
    return out.reshape(NT, P, P2)


def quantize_field(field_pad: torch.Tensor):
    """kbench.py gather_q's quantization: per tile scale = max(max|E|,
    1e-30), Eq = rint(E * (127 / scale)) as int8.  Returns (Eq (NT, P, P,
    P, C) int8, scale (NT,) float32)."""
    amax = field_pad.abs().amax(dim=tuple(range(1, field_pad.dim())))
    scale = torch.clamp(amax, min=1e-30)
    r = torch.full_like(scale, 127.0) / scale        # one f32 division
    shape = (-1,) + (1,) * (field_pad.dim() - 1)
    return torch.round(field_pad * r.view(shape)).to(torch.int8), scale


def gather_variant_plain(field: torch.Tensor, xyz: torch.Tensor,
                         ts: TileSpec, mode: str,
                         scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """field (NT, P, P, P, C) (int8 with scale (NT,) for int8, else
    float32, rounded to bf16 here), xyz (3, NT, B) -> (C, NT, 8, B/8) by
    the gather variant ``mode`` (the module's table)."""
    _mode(mode, GATHER_MODES)
    _, NT, B = xyz.shape
    P, M, T = ts.P, ts.M, ts.T
    C = field.shape[-1]
    dev = xyz.device
    isum = mode == "int8"
    F = field.reshape(NT * P ** 3, C)
    F = F.long() if isum else F.float().bfloat16().float()
    if isum:
        sc = scale * INV_127SQ
    out = torch.empty((C, NT, B), dtype=torch.float32, device=dev)
    for t0, t1 in tk._tile_chunks(NT, B):
        x, y, z = (xyz[d, t0:t1] for d in range(3))
        base = (torch.arange(t0, t1, device=dev) * P ** 3)[:, None]
        if mode == "no_xreduce":
            nx = [(torch.zeros_like(x, dtype=torch.long),
                   torch.ones_like(x))]
        else:
            nx = tk._nodes(x, M, T, 1)
        if mode == "bf16_native":
            ny, nz = _nodes_bf16(y, M, T), _nodes_bf16(z, M, T)
        else:
            ny, nz = tk._nodes(y, M, T, 1), tk._nodes(z, M, T, 1)
        e = None
        for ia, wa in nx:
            g = None
            for ib, wb in ny:
                for ic, wc in nz:
                    if isum:
                        w = _quant(wb, wc).long()
                    elif mode == "bf16_native":
                        w = (wb * wc).float()
                    else:
                        w = (wb * wc).bfloat16().float()
                    term = F[base + (ia * P + ib) * P + ic] * w[..., None]
                    g = term if g is None else g + term
            if isum:
                g = g.float()
            elif mode == "g_bf16":
                g = g.bfloat16().float()
            term = g if mode == "no_xreduce" else wa[..., None] * g
            e = term if e is None else e + term
        if isum:
            e = e * sc[t0:t1, None, None]
        out[:, t0:t1] = e.permute(2, 0, 1)
    return out.reshape(C, NT, 8, B // 8)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _shape(xyz: torch.Tensor, ts: TileSpec):
    NT, B = tk._planes_shape(xyz, ts)
    if B % 8 or not 2 * ts.M + 1 < ts.P <= 16:
        raise ValueError(f"the kbench kernels take B % 8 == 0 and P <= 16, "
                         f"got B={B}, P={ts.P}")
    return NT, B


def deposit_variant(xyz: torch.Tensor, value: torch.Tensor, ts: TileSpec,
                    mode: str, kron: Optional[torch.Tensor] = None,
                    vmax: Optional[float] = None) -> torch.Tensor:
    """The deposit variant ``mode`` (the module's table): xyz (3, NT, B)
    f32 planes, value (NT, B) f32 (in [-1, 1] for int8, the probes'
    alive mask), kron (P*P, B/8) bf16 for given_kron -> (NT, P, P*P) f32.
    vmax (bf16_native only): a bound on |value| that sets the fixed-point
    grid, tk.deposit_scale((vmax,), B), as K1's ``deposit`` does; a value
    above it can overflow the integer sums.  With vmax=None the wrapper
    reads float(value.abs().max()), one host sync.

    Replaces the probes of FUNCTIONS (REPLACES names one a mode).  Bound on
    the card: 4 bytes a slot of value and 12 of x, y, z a live slot (4 of
    x for given_kron, whose 2 P^3 flops a slot at the bf16 tensor-core
    rate outweigh them).  Design: int8 and bf16_native one block per tile
    adding into shared (P, P*P) sums with native int32 atomics: int8 in
    one int32 block (exact), bf16_native in the int32 pair
    (tk.ACCUMULATOR, two ATOMS.ADD a product, 2 slots' loads a thread in
    flight ahead of them; with 0/1 values its grid holds every sum
    exactly); weight_sums one block per tile, X in per-thread float bins
    (P a thread) and R in one int32-pair block (weight_sums_scale);
    int8, bf16_native and weight_sums give the same bits from launch to
    launch.  given_kron one bf16 GEMM on the tensor cores (wgmma
    m64n128k16, float32 sums taken in two levels): a warpgroup a block,
    4 tiles a block as the 64 rows of A, built in registers from x and
    value, 128 result columns a block, the plane staged in shared memory
    64 columns a stage and shared by the 8 rows and the block's tiles."""
    if _is_cpu(xyz, "deposit_variant"):
        return deposit_variant_plain(xyz, value, ts, mode, kron=kron)
    code = _mode(mode, DEPOSIT_MODES)
    NT, B = _shape(xyz, ts)
    P = ts.P
    dev = xyz.device
    _check(xyz, "xyz", (3, NT, B), dev)
    _check(value, "value", (NT, B), dev)
    if mode == "given_kron":
        if kron is None:
            raise ValueError("given_kron needs the kron plane")
        _check(kron, "kron", (P * P, B // 8), dev, dtypes=(torch.bfloat16,))
    k, j = 0, 0
    if mode == "weight_sums":
        k, j = weight_sums_scale(B)
    elif mode == "bf16_native":
        if vmax is None:
            vmax = float(value.abs().max())
        k, j = tk.deposit_scale((vmax,), B)
    out = torch.empty((NT, P, P * P), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch(f"kbench_deposit_{mode}", lib.pinc_kb_deposit, _ptr(xyz),
                _ptr(value), ctypes.c_void_p(
                    kron.data_ptr() if mode == "given_kron" else None),
                _ptr(out), NT, B, P, ts.M, code, INV_127SQ, _stream(dev), k,
                j, counts=LAUNCHES)
    return out


def gather_variant(field: torch.Tensor, xyz: torch.Tensor, ts: TileSpec,
                   mode: str, scale: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The gather variant ``mode`` (the module's table): field (NT, P, P,
    P, 3), int8 with scale (NT,) f32 for int8 (quantize_field), else f32;
    xyz (3, NT, B) f32 -> (3, NT, 8, B/8) f32.

    Replaces the probes of FUNCTIONS (REPLACES names one a mode).  Bound on
    the card: the 12 bytes a slot read (8 for no_xreduce) and 4 C written,
    and the field block read once.  Design: K3's, one block per tile with
    the field block in shared memory (int8 for int8), one thread a slot."""
    if _is_cpu(xyz, "gather_variant"):
        return gather_variant_plain(field, xyz, ts, mode, scale=scale)
    code = _mode(mode, GATHER_MODES)
    NT, B = _shape(xyz, ts)
    C = tk._field_shape(field, ts)
    if C != 3:
        raise ValueError(f"the gather variants take C = 3, got {C}")
    dev = xyz.device
    _check(xyz, "xyz", (3, NT, B), dev)
    isum = mode == "int8"
    _check(field, "field", tuple(field.shape), dev,
           dtypes=(torch.int8,) if isum else (torch.float32,))
    if isum:
        if scale is None:
            raise ValueError("the int8 gather needs the per-tile scale")
        _check(scale, "scale", (NT,), dev)
    out = torch.empty((C, NT, 8, B // 8), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch(f"kbench_gather_{mode}", lib.pinc_kb_gather, _ptr(field),
                ctypes.c_void_p(scale.data_ptr() if isum else None),
                INV_127SQ, _ptr(xyz), _ptr(out), NT, B, ts.P, ts.M, code,
                _stream(dev), counts=LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# K12: bench_kernels_tpu.py's gather_v takes E component-major
# ---------------------------------------------------------------------------

def field_pad_of(E: torch.Tensor, P: int) -> torch.Tensor:
    """gather_v's component-major E (NT, C, P, P*P) -> K3's (NT, P, P, P,
    C) (one copy)."""
    NT, C = E.shape[:2]
    return E.reshape(NT, C, P, P, P).permute(0, 2, 3, 4, 1).contiguous()
