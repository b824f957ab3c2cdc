"""Gather / scatter interpolation on the flat layout (NGP and CIC), the
counterpart of ``pinc_tpu/ops/cic.py``.

Reference: ``puInterp3D1``/``puInterpND1``/``puInterpND0``
(src/pusher.c:1089-1178) and ``puDistr3D1``/``puDistrND1``/``puDistrND0``
(src/pusher.c:512-678).  Gather is 2^D wrapped corner lookups + lerp;
scatter is 2^D ``index_add_`` adds on the flat grid.  Positions arrive in
split (cell:int32, frac:float) form, so CIC weights are exact.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import torch


def _corner_indices(cell: torch.Tensor, offsets: Tuple[int, ...],
                    L: Sequence[int], periodic) -> Tuple[torch.Tensor, ...]:
    """Per-dim node indices for one corner offset: periodic dims wrap,
    bounded ones clamp.  Returns a D-tuple of int64 index tensors."""
    D = len(offsets)
    per = (periodic,) * D if isinstance(periodic, bool) else tuple(periodic)
    idx = []
    for d, off in enumerate(offsets):
        i = cell[..., d].long()
        if off:
            i = i + off
            if per[d]:
                i = torch.where(i >= L[d], i - L[d], i)
            else:
                i = i.clamp(0, L[d] - 1)
        idx.append(i)
    return tuple(idx)


def _corner_weight(frac: torch.Tensor, offsets: Tuple[int, ...]) -> torch.Tensor:
    """CIC weight for one corner: prod_d (frac_d if off_d else 1-frac_d)."""
    w = None
    for d, off in enumerate(offsets):
        wd = frac[..., d] if off else 1.0 - frac[..., d]
        w = wd if w is None else w * wd
    return w


def gather_cic(field: torch.Tensor, cell: torch.Tensor, frac: torch.Tensor,
               periodic=True) -> torch.Tensor:
    """Multi-linear interpolation of ``field`` at particle positions.
    field: (*L,) or (*L, C); cell/frac: (..., D).  Returns (...,) or
    (..., C).  Matches puInterpND1."""
    D = cell.shape[-1]
    L = field.shape[:D]
    vector = field.ndim == D + 1
    out = None
    for offsets in itertools.product((0, 1), repeat=D):
        idx = _corner_indices(cell, offsets, L, periodic)
        w = _corner_weight(frac, offsets)
        val = field[idx]
        if vector:
            w = w[..., None]
        contrib = w * val
        out = contrib if out is None else out + contrib
    return out


def _wrap_or_clamp_near(near, L, periodic):
    """NGP node indices: wrap periodic dims, clamp bounded ones."""
    D = near.shape[-1]
    per = (periodic,) * D if isinstance(periodic, bool) else tuple(periodic)
    cols = []
    for d in range(D):
        i = near[..., d].long()
        if per[d]:
            i = torch.where(i >= L[d], torch.zeros_like(i), i)
        else:
            i = i.clamp(0, L[d] - 1)
        cols.append(i)
    return tuple(cols)


def gather_ngp(field: torch.Tensor, cell: torch.Tensor, frac: torch.Tensor,
               periodic=True) -> torch.Tensor:
    """Nearest-grid-point gather: node = round(pos) (puInterpND0,
    src/pusher.c:1164-1178)."""
    D = cell.shape[-1]
    L = field.shape[:D]
    near = cell + (frac >= 0.5).to(cell.dtype)
    return field[_wrap_or_clamp_near(near, L, periodic)]


def _linear(idx, shape: Sequence[int]) -> torch.Tensor:
    """Per-dim node indices -> flat indices of a row-major grid.  The
    deposits add with index_add_ on the flat grid: on a card that is one
    atomic add a contribution, where index_put_(accumulate=True) sorts the
    indices and walks each node's duplicates (one CIC corner of 2 x 3.1 M
    slots on 32^3 nodes: 3.7 against 248 ms, H100; chip_smoke.py phase
    10.3)."""
    lin = idx[0]
    for d in range(1, len(idx)):
        lin = lin * shape[d] + idx[d]
    return lin


def scatter_cic(shape: Sequence[int], cell: torch.Tensor, frac: torch.Tensor,
                value: torch.Tensor, periodic=True,
                dtype=torch.float32) -> torch.Tensor:
    """CIC charge deposition: rho[corner] += w_corner * value for the 2^D
    corners of each particle's cell (puDistrND1).  value carries
    charge * alive-mask, so dead slots deposit exactly zero.
    cell/frac: (N, D); value: (N,)."""
    D = cell.shape[-1]
    rho = torch.zeros(math.prod(shape), dtype=dtype, device=cell.device)
    for offsets in itertools.product((0, 1), repeat=D):
        idx = _corner_indices(cell, offsets, shape, periodic)
        w = _corner_weight(frac, offsets) * value
        rho.index_add_(0, _linear(idx, shape), w.to(dtype))
    return rho.reshape(tuple(shape))


def scatter_ngp(shape: Sequence[int], cell: torch.Tensor, frac: torch.Tensor,
                value: torch.Tensor, periodic=True,
                dtype=torch.float32) -> torch.Tensor:
    """NGP deposition: all charge to the nearest node (puDistrND0)."""
    near = cell + (frac >= 0.5).to(cell.dtype)
    idx = _wrap_or_clamp_near(near, tuple(shape), periodic)
    rho = torch.zeros(math.prod(shape), dtype=dtype, device=cell.device)
    rho.index_add_(0, _linear(idx, shape), value.to(dtype))
    return rho.reshape(tuple(shape))
