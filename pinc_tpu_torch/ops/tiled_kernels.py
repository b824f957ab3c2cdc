"""The tiled step's kernels — the counterpart of ``pinc_tpu/ops/pallas_tiled.py``.

Four kernels, hand-written in CUDA C++ for Hopper (``csrc/tiled.cu``,
built by ``ops/_cuda_build.py``), each with a plain PyTorch version of the
same signature and layout beside it:

================  ==========================================================
``deposit``       K1, replaces ``pallas_tiled.deposit`` (``_deposit_kernel``)
``deposit_move``  K2, replaces ``pallas_tiled.deposit_move``
                  (``_deposit_move_kernel``)
``gather``        K3, replaces ``pallas_tiled.gather`` (``_gather_kernel``)
``gather_kick``   K4, replaces ``pallas_tiled.gather_kick``
                  (``_gather_kick_kernel`` + ``_kick_rows``)
``pic_step``      K5, replaces ``pallas_tiled.pic_step``
                  (``_pic_step_kernel``): gather, kick, drift and deposit
                  of every species in one pass
================  ==========================================================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
checks device, dtype, shape and contiguity, launches the kernel on the
current stream, raises on a nonzero launch error, and adds one to
``LAUNCHES[name]``.  There is no fallback from a CUDA tensor to the plain
version.

Weights are those of ``pallas_tiled._w1d`` (CIC hat or NGP indicator over
the padded node offsets -M..T+M, or -m..T+m at a working margin m <= M);
with ``mxu_dtype=torch.bfloat16`` they
are rounded to bf16 at the TPU kernels' points (``wx*value`` and ``wy*wz``
in the deposit, the field and ``wy*wz`` in the gather), sums in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _cuda_build
from .tiled import TileSpec

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"deposit": 0, "deposit_move": 0, "gather": 0, "gather_kick": 0,
            "pic_step": 0}

#: the TPU kernel each CUDA kernel replaces (file:line of the function
#: that reaches pl.pallas_call)
REPLACES = {
    "deposit": "pinc_tpu/ops/pallas_tiled.py:169",
    "deposit_move": "pinc_tpu/ops/pallas_tiled.py:264",
    "gather": "pinc_tpu/ops/pallas_tiled.py:331",
    "gather_kick": "pinc_tpu/ops/pallas_tiled.py:735",
    "pic_step": "pinc_tpu/ops/pallas_tiled.py:530",
}

SOURCE = "pinc_tpu_torch/csrc/tiled.cu"

# Plain versions work on this many slots at a time (bounds the index and
# weight intermediates at production sizes).
_PLAIN_SLOTS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Shared weight arithmetic of the plain versions
# ---------------------------------------------------------------------------

def _is_bf16(mxu_dtype: torch.dtype) -> bool:
    if mxu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mxu_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {mxu_dtype}")
    return mxu_dtype == torch.bfloat16


def _round(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    return w.bfloat16().float() if bf16 else w


def _nodes(x: torch.Tensor, M: int, T: int, order: int,
           margin: Optional[int] = None):
    """The candidate nodes floor(x), floor(x)+1 of one coordinate plane:
    [(index into the padded block of layout margin M, weight)] with
    pallas_tiled._w1d's weights, zero for a node outside [-m, T+m], m the
    working margin (default M)."""
    m = M if margin is None else margin
    f = torch.floor(x)
    out = []
    for k in (0, 1):
        n = f + k
        d = x - n
        if order == 0:
            w = ((d >= -0.5) & (d < 0.5)).to(x.dtype)
        else:
            w = torch.clamp(1.0 - d.abs(), min=0.0)
        inside = (n >= -m) & (n <= T + m)
        w = torch.where(inside, w, torch.zeros_like(w))
        idx = torch.where(inside, n + M, torch.zeros_like(n)).long()
        out.append((idx, w))
    return out


def _tile_chunks(NT: int, B: int):
    step = max(1, _PLAIN_SLOTS // max(B, 1))
    return [(t0, min(t0 + step, NT)) for t0 in range(0, NT, step)]


def _check_order(order: int) -> None:
    if order not in (0, 1):
        raise ValueError(f"order must be 0 (NGP) or 1 (CIC), got {order}")


# ---------------------------------------------------------------------------
# Plain versions (same signatures and layouts as pallas_tiled)
# ---------------------------------------------------------------------------

def deposit_plain(xyz: torch.Tensor, value: torch.Tensor, ts: TileSpec,
                  mxu_dtype=torch.float32, order: int = 1,
                  margin: Optional[int] = None) -> torch.Tensor:
    """xyz (3, NT, B) tile-local planes, value (NT, B) -> padded tile
    densities (NT, P, P*P), on the nodes within ``margin`` (default M)."""
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    _, NT, B = xyz.shape
    P, M, T = ts.P, ts.M, ts.T
    out = torch.zeros(NT * P ** 3, dtype=torch.float32, device=xyz.device)
    for t0, t1 in _tile_chunks(NT, B):
        x, y, z = (xyz[d, t0:t1] for d in range(3))
        val = value[t0:t1]
        base = (torch.arange(t0, t1, device=xyz.device) * P ** 3)[:, None]
        nx, ny, nz = (_nodes(c, M, T, order, margin) for c in (x, y, z))
        for ia, wa in nx:
            wa = _round(wa * val, bf16)
            for ib, wb in ny:
                for ic, wc in nz:
                    w = wa * _round(wb * wc, bf16)
                    idx = base + (ia * P + ib) * P + ic
                    out.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return out.reshape(NT, P, P * P)


def deposit_move_plain(xyz: torch.Tensor, vel: torch.Tensor,
                       alive: torch.Tensor, charge: float, ts: TileSpec,
                       mxu_dtype=torch.float32, order: int = 1):
    """Drift x += v, the count of live slots outside [-M, T+M), and the
    deposit at the new x with value alive*charge.
    Returns (tiles (NT, P, P*P), new_xyz (3, NT, B), n_out scalar f32)."""
    new_xyz = xyz + vel
    lo, hi = -float(ts.M), float(ts.T + ts.M)
    out = ((new_xyz < lo) | (new_xyz >= hi)).any(dim=0)
    n_out = torch.where(out, alive, torch.zeros_like(alive)).sum()
    tiles = deposit_plain(new_xyz, alive * float(charge), ts,
                          mxu_dtype=mxu_dtype, order=order)
    return tiles, new_xyz, n_out


def gather_plain(field_pad: torch.Tensor, xyz: torch.Tensor, ts: TileSpec,
                 mxu_dtype=torch.float32, order: int = 1,
                 margin: Optional[int] = None) -> torch.Tensor:
    """field_pad (NT, P, P, P, C), xyz (3, NT, B) -> (C, NT, B) field at
    the slots: sum_a wx_a * sum_bc E[a, b, c] * wy_b wz_c, over the nodes
    within ``margin`` (default M)."""
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    _, NT, B = xyz.shape
    P, M, T = ts.P, ts.M, ts.T
    C = field_pad.shape[-1]
    F = _round(field_pad.float(), bf16).reshape(NT * P ** 3, C)
    out = torch.empty((C, NT, B), dtype=torch.float32, device=xyz.device)
    for t0, t1 in _tile_chunks(NT, B):
        x, y, z = (xyz[d, t0:t1] for d in range(3))
        base = (torch.arange(t0, t1, device=xyz.device) * P ** 3)[:, None]
        nx, ny, nz = (_nodes(c, M, T, order, margin) for c in (x, y, z))
        e = None
        for ia, wa in nx:
            g = None
            for ib, wb in ny:
                for ic, wc in nz:
                    w = _round(wb * wc, bf16)
                    term = F[base + (ia * P + ib) * P + ic] * w[..., None]
                    g = term if g is None else g + term
            term = wa[..., None] * g
            e = term if e is None else e + term
        out[:, t0:t1] = e.permute(2, 0, 1)
    return out


def _cross(a: Sequence[torch.Tensor], b: Sequence[float]):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def kick_planes(vs, Ecs, qm: float, boris=None):
    """pallas_tiled._kick_rows on planes: the leapfrog kick with
    vdot = v.(v+dv), or (boris = (T, S) float 3-tuples) the Boris rotation
    with vdot = |v_plus|^2 (puAcc3D1KE / puBoris3D1KE,
    src/pusher.c:197-210, 465-471).  Returns (new velocities, unmasked;
    vdot)."""
    if boris is None:
        outs = [vs[c] + qm * Ecs[c] for c in range(3)]
        vdot = vs[0] * outs[0] + vs[1] * outs[1] + vs[2] * outs[2]
        return outs, vdot
    T, S = boris
    half = [(0.5 * qm) * Ecs[c] for c in range(3)]
    vm = [vs[c] + half[c] for c in range(3)]
    cr = _cross(vm, T)
    vpr = [vm[c] + cr[c] for c in range(3)]
    cr2 = _cross(vpr, S)
    vpl = [vm[c] + cr2[c] for c in range(3)]
    outs = [vpl[c] + half[c] for c in range(3)]
    return outs, vpl[0] * vpl[0] + vpl[1] * vpl[1] + vpl[2] * vpl[2]


def _boris_floats(boris):
    if boris is None:
        return None
    return (tuple(float(v) for v in boris[0]),
            tuple(float(v) for v in boris[1]))


def gather_kick_plain(field_pad: torch.Tensor, xyz: torch.Tensor,
                      vel: torch.Tensor, alive: torch.Tensor, qm: float,
                      ts: TileSpec, mxu_dtype=torch.float32, order: int = 1,
                      e_ext=None, boris=None):
    """Gather, + e_ext, the kick of kick_planes masked by alive, and the
    sum of alive * vdot.  Returns (new_vel (3, NT, B), vdot scalar)."""
    Ep = gather_plain(field_pad, xyz, ts, mxu_dtype=mxu_dtype, order=order)
    Ecs = [Ep[c] if e_ext is None else Ep[c] + float(e_ext[c])
           for c in range(3)]
    vs = [vel[c] for c in range(3)]
    outs, vdot = kick_planes(vs, Ecs, float(qm), _boris_floats(boris))
    new_vel = torch.stack([v + alive * (vn - v) for v, vn in zip(vs, outs)])
    return new_vel, torch.sum(vdot * alive)


def _margins(margins, S: int, ts: TileSpec):
    """Per-species (mg, md) working margins, each checked against the
    layout margin: 0 <= mg <= M, 1 <= md <= M (default (M, M))."""
    if margins is None:
        return [(ts.M, ts.M)] * S
    out = [(int(mg), int(md)) for mg, md in margins]
    if len(out) != S or not all(0 <= mg <= ts.M and 1 <= md <= ts.M
                                for mg, md in out):
        raise ValueError(f"margins must be {S} pairs (mg, md) with "
                         f"0 <= mg <= {ts.M} and 1 <= md <= {ts.M}, got "
                         f"{margins}")
    return out


def _species_boris(boris_T, boris_S, s: int):
    if boris_T is None:
        return None
    return (tuple(float(v) for v in boris_T[s]),
            tuple(float(v) for v in boris_S[s]))


def pic_step_plain(E: torch.Tensor, lpos: torch.Tensor, vel: torch.Tensor,
                   alive: torch.Tensor, charge, qm_dt, ts: TileSpec,
                   mxu_dtype=torch.float32, order_acc: int = 1,
                   order_distr: int = 1, e_ext=None, boris_T=None,
                   boris_S=None, margins=None, inplace: bool = False):
    """Per species: gather E(x) at nodes within mg, + e_ext, the kick of
    kick_planes, v + alive (v' - v), the drift x + v of every slot, the
    count of live slots outside [-md, T+md), and the deposit of alive*q at
    the new x on nodes within md.  Returns (tiles (NT, P, P*P) summed over
    species, new lpos, new vel, vdot (S,), n_out (S,)); with inplace=True
    the new lpos and vel are written into lpos and vel."""
    _check_order(order_acc)
    _check_order(order_distr)
    S, _, NT, B = lpos.shape
    P, T = ts.P, ts.T
    field = E.float().reshape(NT, 3, P, P, P).permute(0, 2, 3, 4, 1)
    ext = (0.0, 0.0, 0.0) if e_ext is None else tuple(float(v) for v in e_ext)
    new_lpos = lpos if inplace else torch.empty_like(lpos)
    new_vel = vel if inplace else torch.empty_like(vel)
    tiles, vdots, nouts = None, [], []
    for s, (mg, md) in enumerate(_margins(margins, S, ts)):
        Ep = gather_plain(field, lpos[s], ts, mxu_dtype=mxu_dtype,
                          order=order_acc, margin=mg)
        vs = [vel[s, c] for c in range(3)]
        outs, vdot = kick_planes(vs, [Ep[c] + ext[c] for c in range(3)],
                                 float(qm_dt[s]),
                                 _species_boris(boris_T, boris_S, s))
        al = alive[s]
        vn = torch.stack([v + al * (o - v) for v, o in zip(vs, outs)])
        xn = lpos[s] + vn
        out = ((xn < -float(md)) | (xn >= float(T + md))).any(dim=0)
        nouts.append(torch.where(out, al, torch.zeros_like(al)).sum())
        vdots.append(torch.sum(vdot * al))
        t = deposit_plain(xn, al * float(charge[s]), ts, mxu_dtype=mxu_dtype,
                          order=order_distr, margin=md)
        tiles = t if tiles is None else tiles + t
        new_vel[s] = vn
        new_lpos[s] = xn
    return tiles, new_lpos, new_vel, torch.stack(vdots), torch.stack(nouts)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(t: torch.Tensor, name: str, shape: Tuple[int, ...],
           device: torch.device, dtypes=(torch.float32,)) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(str(d)[6:] for d in dtypes)}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _planes_shape(xyz: torch.Tensor, ts: TileSpec) -> Tuple[int, int]:
    if xyz.dim() != 3 or xyz.shape[0] != 3 or ts.n_dims != 3:
        raise ValueError("the tiled kernels are 3-D: xyz must be (3, NT, B)")
    _, NT, B = xyz.shape
    if NT != ts.NT or NT == 0 or B == 0:
        raise ValueError(f"xyz has {NT} tiles x {B} slots; the TileSpec "
                         f"has {ts.NT} tiles")
    return NT, B


def _launch(name: str, fn, *args, counts: Optional[dict] = None) -> None:
    """Call the C entry point fn(*args), raise on a nonzero launch error,
    and add one to counts[name] (default: this module's LAUNCHES)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    (LAUNCHES if counts is None else counts)[name] += 1


def _is_cpu(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def deposit(xyz: torch.Tensor, value: torch.Tensor, ts: TileSpec,
            mxu_dtype=torch.float32, order: int = 1) -> torch.Tensor:
    """K1: xyz (3, NT, B) tile-local planes f32, value (NT, B)
    charge*alive -> padded tile densities (NT, P, P*P) f32.

    Replaces pinc_tpu/ops/pallas_tiled.py ``deposit``.  Bound on the card:
    the shared-memory atomics, 8 per live CIC slot (1 for NGP), and the
    16 bytes/slot read (x, y, z, value) at one pass over HBM.  Design:
    one block per tile keeps the P^3-float accumulator (5.3 KB at P=11)
    in shared memory and writes the tile's block once — no global atomics,
    no dense weight matrices, dead slots skipped."""
    if _is_cpu(xyz, "deposit"):
        return deposit_plain(xyz, value, ts, mxu_dtype=mxu_dtype, order=order)
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    NT, B = _planes_shape(xyz, ts)
    dev = xyz.device
    _check(xyz, "xyz", (3, NT, B), dev)
    _check(value, "value", (NT, B), dev)
    out = torch.empty((NT, ts.P, ts.P * ts.P), dtype=torch.float32,
                      device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("deposit", lib.pinc_tiled_deposit, _ptr(xyz), _ptr(value),
                _ptr(out), NT, B, ts.P, ts.M, order, int(bf16), _stream(dev))
    return out


def deposit_move(xyz: torch.Tensor, vel: torch.Tensor, alive: torch.Tensor,
                 charge: float, ts: TileSpec, mxu_dtype=torch.float32,
                 order: int = 1):
    """K2: fused leapfrog drift + CIC/NGP deposition for one species.
    xyz, vel (3, NT, B) f32; alive (NT, B) f32 0/1.  Returns (tiles
    (NT, P, P*P), new_xyz (3, NT, B), n_out scalar f32 — live slots beyond
    the wander margin after the drift).

    Replaces pinc_tpu/ops/pallas_tiled.py ``deposit_move``.  Bound on the
    card: 40 bytes/slot of HBM traffic (7 planes in, 3 out) and the
    deposit's shared atomics.  Design: K1's per-tile shared accumulator,
    with the drift and the margin test done on the registers that feed
    the deposit; each block writes one n_out partial and torch sums the
    NT partials."""
    if _is_cpu(xyz, "deposit_move"):
        return deposit_move_plain(xyz, vel, alive, charge, ts,
                                  mxu_dtype=mxu_dtype, order=order)
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    NT, B = _planes_shape(xyz, ts)
    dev = xyz.device
    _check(xyz, "xyz", (3, NT, B), dev)
    _check(vel, "vel", (3, NT, B), dev)
    _check(alive, "alive", (NT, B), dev)
    tiles = torch.empty((NT, ts.P, ts.P * ts.P), dtype=torch.float32,
                        device=dev)
    new_xyz = torch.empty_like(xyz)
    nout = torch.empty((NT,), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("deposit_move", lib.pinc_tiled_deposit_move, _ptr(xyz),
                _ptr(vel), _ptr(alive), float(charge), _ptr(tiles),
                _ptr(new_xyz), _ptr(nout), NT, B, ts.P, ts.M, order,
                int(bf16), _stream(dev))
    return tiles, new_xyz, nout.sum()


def _field_shape(field_pad: torch.Tensor, ts: TileSpec) -> int:
    P = ts.P
    if field_pad.dim() != 5 or tuple(field_pad.shape[:4]) != (ts.NT, P, P, P):
        raise ValueError(f"field_pad has shape {tuple(field_pad.shape)}, "
                         f"expected ({ts.NT}, {P}, {P}, {P}, C)")
    return field_pad.shape[-1]


def gather(field_pad: torch.Tensor, xyz: torch.Tensor, ts: TileSpec,
           mxu_dtype=torch.float32, order: int = 1) -> torch.Tensor:
    """K3: field_pad (NT, P, P, P, C), xyz (3, NT, B) coordinate planes ->
    (C, NT, B) field at the slots.

    Replaces pinc_tpu/ops/pallas_tiled.py ``gather``.  Bound on the card:
    the 12 bytes/slot read plus C*4 bytes/slot written, and 8 shared-memory
    reads of C floats per CIC slot.  Design: one block per tile loads the
    tile's (P, P, P, C) field (16 KB at P=11, C=3) into shared memory once
    (bf16-rounded when asked) and interpolates every slot from there."""
    if _is_cpu(xyz, "gather"):
        return gather_plain(field_pad, xyz, ts, mxu_dtype=mxu_dtype,
                            order=order)
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    NT, B = _planes_shape(xyz, ts)
    C = _field_shape(field_pad, ts)
    if C not in (1, 3):
        raise ValueError(f"the gather kernel takes C = 1 or 3, got {C}")
    dev = xyz.device
    _check(xyz, "xyz", (3, NT, B), dev)
    _check(field_pad, "field_pad", tuple(field_pad.shape), dev)
    out = torch.empty((C, NT, B), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("gather", lib.pinc_tiled_gather, _ptr(field_pad), _ptr(xyz),
                _ptr(out), NT, B, ts.P, ts.M, C, order, int(bf16),
                _stream(dev))
    return out


def gather_kick(field_pad: torch.Tensor, xyz: torch.Tensor,
                vel: torch.Tensor, alive: torch.Tensor, qm: float,
                ts: TileSpec, mxu_dtype=torch.float32, order: int = 1,
                e_ext: Optional[Sequence[float]] = None, boris=None):
    """K4: fused field gather + velocity kick + kinetic-energy sum for one
    species.  field_pad (NT, P, P, P, 3); xyz, vel (3, NT, B); alive
    (NT, B) f32; qm = q/m (fold a half-kick factor in here); e_ext an
    optional 3-sequence added to the gathered field; boris optional (T, S)
    3-sequences.  Returns (new_vel (3, NT, B), vdot scalar f32).

    Replaces pinc_tpu/ops/pallas_tiled.py ``gather_kick``.  Bound on the
    card: 28 bytes/slot in and 12 out at one pass over HBM, plus K3's
    shared-memory interpolation.  Design: K3's shared field block; the
    kick runs on the interpolated registers, so the per-slot field never
    reaches HBM; one vdot partial per block, summed by torch."""
    if _is_cpu(xyz, "gather_kick"):
        return gather_kick_plain(field_pad, xyz, vel, alive, qm, ts,
                                 mxu_dtype=mxu_dtype, order=order,
                                 e_ext=e_ext, boris=boris)
    _check_order(order)
    bf16 = _is_bf16(mxu_dtype)
    NT, B = _planes_shape(xyz, ts)
    if _field_shape(field_pad, ts) != 3:
        raise ValueError("gather_kick needs a 3-component field")
    dev = xyz.device
    _check(field_pad, "field_pad", tuple(field_pad.shape), dev)
    _check(xyz, "xyz", (3, NT, B), dev)
    _check(vel, "vel", (3, NT, B), dev)
    _check(alive, "alive", (NT, B), dev)
    bo = _boris_floats(boris)
    params = (ctypes.c_float * 9)(
        *(tuple(float(v) for v in e_ext) if e_ext is not None else (0.0,) * 3),
        *(bo[0] if bo else (0.0,) * 3), *(bo[1] if bo else (0.0,) * 3))
    vel_out = torch.empty_like(vel)
    vdot = torch.empty((NT,), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("gather_kick", lib.pinc_tiled_gather_kick, _ptr(field_pad),
                _ptr(xyz), _ptr(vel), _ptr(alive), float(qm), params,
                int(bo is not None), _ptr(vel_out), _ptr(vdot), NT, B, ts.P,
                ts.M, order, int(bf16), _stream(dev))
    return vel_out, vdot.sum()


def pic_step(E: torch.Tensor, lpos: torch.Tensor, vel: torch.Tensor,
             alive: torch.Tensor, charge, qm_dt, ts: TileSpec,
             mxu_dtype=torch.float32, order_acc: int = 1,
             order_distr: int = 1, e_ext: Optional[Sequence[float]] = None,
             boris_T=None, boris_S=None, margins=None,
             inplace: bool = False):
    """K5: one leapfrog step of the particles of every species.  E
    (NT, 3P, P*P) f32 or bf16, efield_tiles' layout; lpos, vel
    (S, 3, NT, B) f32; alive (S, NT, B) f32 0/1; charge, qm_dt (S,)
    floats; e_ext an optional 3-sequence; boris_T, boris_S optional (S, 3)
    rotation vectors; margins optional per-species (mg, md) working
    margins (default (M, M)).  Returns (tiles (NT, P, P*P) f32 summed over
    species, new lpos, new vel, vdot (S,), n_out (S,)).  inplace=True
    writes the new lpos and vel into lpos and vel (each slot is read before
    it is written) and returns them.

    Replaces pinc_tpu/ops/pallas_tiled.py ``pic_step``.  Bound on the card:
    the slots' 28 bytes read and 24 written per species, plus the E tiles
    and the density blocks (2.2 ms at the bench deck's 2 x 71,303,168
    slots).  Design: one block per tile, the species loop inside it; the
    tile's E block is loaded into shared memory once for every species and
    its density block accumulates in shared memory across species (shared
    atomics) and is written once; the TPU kernel's embed matmuls become
    the node range test at (mg, md); vdot and n_out are reduced per block
    into (S, NT) partials and summed by torch, in a fixed order."""
    if _is_cpu(lpos, "pic_step"):
        return pic_step_plain(E, lpos, vel, alive, charge, qm_dt, ts,
                              mxu_dtype=mxu_dtype, order_acc=order_acc,
                              order_distr=order_distr, e_ext=e_ext,
                              boris_T=boris_T, boris_S=boris_S,
                              margins=margins, inplace=inplace)
    _check_order(order_acc)
    _check_order(order_distr)
    bf16 = _is_bf16(mxu_dtype)
    if lpos.dim() != 4 or lpos.shape[1] != 3 or ts.n_dims != 3:
        raise ValueError("pic_step is 3-D: lpos must be (S, 3, NT, B)")
    S, _, NT, B = lpos.shape
    if NT != ts.NT or B == 0 or not 1 <= S <= 8:
        raise ValueError(f"lpos has {S} species x {NT} tiles x {B} slots; "
                         f"the kernel takes 1..8 species and the "
                         f"TileSpec's {ts.NT} tiles")
    P = ts.P
    dev = lpos.device
    _check(E, "E", (NT, 3 * P, P * P), dev,
           dtypes=(torch.float32, torch.bfloat16))
    _check(lpos, "lpos", (S, 3, NT, B), dev)
    _check(vel, "vel", (S, 3, NT, B), dev)
    _check(alive, "alive", (S, NT, B), dev)
    ext = (0.0, 0.0, 0.0) if e_ext is None else tuple(float(v) for v in e_ext)
    params = []
    for s, (mg, md) in enumerate(_margins(margins, S, ts)):
        bo = _species_boris(boris_T, boris_S, s) or ((0.0,) * 3, (0.0,) * 3)
        params += [float(charge[s]), float(qm_dt[s]), *bo[0], *bo[1],
                   float(mg), float(md)]
    params = (ctypes.c_float * (10 * S + 3))(*params, *ext)
    tiles = torch.empty((NT, P, P * P), dtype=torch.float32, device=dev)
    lpos_out = lpos if inplace else torch.empty_like(lpos)
    vel_out = vel if inplace else torch.empty_like(vel)
    vdot = torch.empty((S, NT), dtype=torch.float32, device=dev)
    nout = torch.empty((S, NT), dtype=torch.float32, device=dev)
    lib = _cuda_build.load()
    with torch.cuda.device(dev):
        _launch("pic_step", lib.pinc_tiled_pic_step, _ptr(E),
                int(E.dtype == torch.bfloat16), _ptr(lpos), _ptr(vel),
                _ptr(alive), params, S, int(boris_T is not None),
                _ptr(tiles), _ptr(lpos_out), _ptr(vel_out), _ptr(vdot),
                _ptr(nout), NT, B, P, ts.M, order_acc, order_distr,
                int(bf16), _stream(dev))
    return tiles, lpos_out, vel_out, vdot.sum(dim=1), nout.sum(dim=1)
