"""Boundary conditions beyond periodic (the counterpart of
``pinc_tpu/bc.py``).

The reference's boundary machinery (``gSetBndSlices``, src/grid.c:608-662;
``gBnd`` -> ``gPeriodic``/``gDirichlet``/``gNeumann``,
src/grid.c:922-1023):

* PERIODIC  — wrap (plus charge neutralization of phi, gPeriodic).
* DIRICHLET — the first/last true node plane along the dimension is
  clamped to the boundary value (src/grid.c:941-943).
* NEUMANN   — a ghost plane one node outside satisfies the centered
  derivative across the boundary node:  ghost = phi[inner] - 2*A
  (src/grid.c:1007-1013, same sign convention on both edges).

Boundary values default to the reference's constants 1.0 (Dirichlet) and
2.0 (Neumann) (src/grid.c:628-649) and are set per edge by
``grid:bndValues`` (2*nDims values, lower edges then upper).

Fields carry no ghost layers: :func:`pad_bc` pads one plane per side on
demand with planes that encode the BCs, so the stencils (gradient,
Laplacian, the multigrid smoothers) stay dense slice expressions.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

from .config import PincConfig
from .grid import BndType


@dataclass(frozen=True)
class BCSpec:
    lower: Tuple[BndType, ...]          # per dim
    upper: Tuple[BndType, ...]
    lower_value: Tuple[float, ...]      # Dirichlet value / Neumann derivative
    upper_value: Tuple[float, ...]

    @property
    def n_dims(self) -> int:
        return len(self.lower)

    @property
    def periodic(self) -> bool:
        return all(b is BndType.PERIODIC for b in self.lower + self.upper)

    def homogeneous(self) -> "BCSpec":
        """Same types with zero values — the BCs of multigrid error
        equations on coarse levels."""
        z = (0.0,) * self.n_dims
        return replace(self, lower_value=z, upper_value=z)

    @classmethod
    def from_config(cls, cfg: PincConfig) -> "BCSpec":
        nd = cfg.get_int("grid:ndims")
        names = cfg.get_str_arr("grid:boundaries", 2 * nd)
        bnd = [BndType(b.strip().upper()) for b in names]
        if "grid:bndvalues" in cfg:
            vals = cfg.get_double_arr("grid:bndvalues", 2 * nd)
        else:
            vals = [1.0 if b is BndType.DIRICHLET else 2.0 for b in bnd]
        return cls(lower=tuple(bnd[:nd]), upper=tuple(bnd[nd:]),
                   lower_value=tuple(vals[:nd]), upper_value=tuple(vals[nd:]))


def clamp_dirichlet(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    """Fix Dirichlet node planes to their boundary values (gDirichlet).
    Returns a new tensor; phi is not modified."""
    phi = phi.clone()
    for d in range(bc.n_dims):
        if bc.lower[d] is BndType.DIRICHLET:
            phi.narrow(d, 0, 1).fill_(bc.lower_value[d])
        if bc.upper[d] is BndType.DIRICHLET:
            phi.narrow(d, phi.shape[d] - 1, 1).fill_(bc.upper_value[d])
    return phi


def interior_mask(shape: Sequence[int], bc: BCSpec) -> np.ndarray:
    """Boolean mask, False on Dirichlet-clamped planes (smoothers must not
    update them)."""
    m = np.ones(tuple(shape), dtype=bool)
    for d in range(bc.n_dims):
        if bc.lower[d] is BndType.DIRICHLET:
            sl = [slice(None)] * len(shape)
            sl[d] = 0
            m[tuple(sl)] = False
        if bc.upper[d] is BndType.DIRICHLET:
            sl = [slice(None)] * len(shape)
            sl[d] = shape[d] - 1
            m[tuple(sl)] = False
    return m


def pad_bc(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    """Pad one plane per side per dim, encoding the BCs:

    * PERIODIC:  wrap planes.
    * DIRICHLET: the mirror of the inner neighbour through the clamped
      boundary node (2*value - phi[1]); with the node itself clamped this
      keeps the boundary node's stencil consistent.
    * NEUMANN:   ghost = phi[1] - 2*A (lower) / phi[-2] - 2*A (upper),
      the reference's one-node-outside centered-derivative ghost.
    """
    for d in range(bc.n_dims):
        n = phi.shape[d]
        first, second = phi.narrow(d, 0, 1), phi.narrow(d, 1, 1)
        last, penult = phi.narrow(d, n - 1, 1), phi.narrow(d, n - 2, 1)
        if bc.lower[d] is BndType.PERIODIC:
            lo = last
        elif bc.lower[d] is BndType.DIRICHLET:
            lo = 2.0 * bc.lower_value[d] - second
        else:
            lo = second - 2.0 * bc.lower_value[d]
        if bc.upper[d] is BndType.PERIODIC:
            hi = first
        elif bc.upper[d] is BndType.DIRICHLET:
            hi = 2.0 * bc.upper_value[d] - penult
        else:
            hi = penult - 2.0 * bc.upper_value[d]
        phi = torch.cat([lo, phi, hi], dim=d)
    return phi


def _face_pairs(p: torch.Tensor, nd: int):
    """For a padded field p, the (upper, lower) neighbour planes of every
    true node along each dim, cut back to the true extent in the other
    dims."""
    core = [slice(1, p.shape[dd] - 1) for dd in range(nd)]
    for d in range(nd):
        up, lo = list(core), list(core)
        up[d] = slice(2, p.shape[d])
        lo[d] = slice(0, p.shape[d] - 2)
        yield p[tuple(up)], p[tuple(lo)]


def neighbor_sum_bc(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    """Sum of the 2*D face neighbours of each node, honoring the BCs."""
    out = None
    for up, lo in _face_pairs(pad_bc(phi, bc), bc.n_dims):
        s = up + lo
        out = s if out is None else out + s
    return out


def laplacian_bc(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    return neighbor_sum_bc(phi, bc) - (2.0 * bc.n_dims) * phi


def gradient_bc(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    """Centered first difference honoring the BCs (gFinDiff1st through
    the halo/boundary slices), one vector component per dim."""
    comps = [0.5 * (up - lo)
             for up, lo in _face_pairs(pad_bc(phi, bc), bc.n_dims)]
    return torch.stack(comps, dim=-1)


def apply_bnd(phi: torch.Tensor, bc: BCSpec) -> torch.Tensor:
    """gBnd (src/grid.c:977-1023): neutralize if any dim is periodic,
    clamp the Dirichlet planes.  (Neumann ghosts are made on demand by
    pad_bc; there is no stored ghost layer to update.)"""
    if any(b is BndType.PERIODIC for b in bc.lower + bc.upper):
        phi = phi - torch.mean(phi)
    return clamp_dirichlet(phi, bc)
