"""Grid representation and whole-grid field operations (the counterpart of
``pinc_tpu/grid.py``).

A field is a tensor of shape ``(*dims, nValues)`` (vector fields) or
``(*dims,)`` (scalars) holding only true grid nodes; periodic shifts are
``torch.roll``.  Static metadata lives in :class:`GridSpec`, whose dtype is
a torch dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

import numpy as np
import torch

from .config import PincConfig


class BndType(Enum):
    """Boundary types per edge (reference bndType enum, src/core.h:145-150)."""
    PERIODIC = "PERIODIC"
    DIRICHLET = "DIRICHLET"
    NEUMANN = "NEUMANN"


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (replaces Grid's size/trueSize/sizeProd/bnd
    bookkeeping, ``gAlloc``, src/grid.c:413-500)."""

    n_dims: int
    true_size: Tuple[int, ...]          # local nodes per subdomain, per dim
    n_subdomains: Tuple[int, ...]       # subdomains per dim
    boundaries: Tuple[BndType, ...]     # lower+upper per dim, len 2*n_dims
    dtype: torch.dtype = torch.float32

    @property
    def global_size(self) -> Tuple[int, ...]:
        return tuple(t * n for t, n in zip(self.true_size, self.n_subdomains))

    @property
    def global_volume(self) -> int:
        return math.prod(self.global_size)

    @property
    def periodic(self) -> bool:
        return all(b is BndType.PERIODIC for b in self.boundaries)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.float64 if self.dtype == torch.float64
                        else np.float32)

    @classmethod
    def from_config(cls, cfg: PincConfig, dtype=None) -> "GridSpec":
        nd = cfg.get_int("grid:ndims")
        true_size = tuple(cfg.get_int_arr("grid:truesize", nd))
        nsub = tuple(cfg.get_int_arr("grid:nsubdomains", nd))
        bnd_names = cfg.get_str_arr("grid:boundaries", 2 * nd)
        bnd = tuple(BndType(b.strip().upper()) for b in bnd_names)
        if dtype is None:
            prec = cfg.get_str("methods:precision", "single").lower()
            dtype = torch.float64 if prec == "double" else torch.float32
        return cls(n_dims=nd, true_size=true_size, n_subdomains=nsub,
                   boundaries=bnd, dtype=dtype)


# ---------------------------------------------------------------------------
# Differential operators (periodic single-block versions).
# Reference: gFinDiff1st (src/grid.c:226-261), gFinDiff2nd3D/ND
# (src/grid.c:264-334).
# ---------------------------------------------------------------------------

def gradient(phi: torch.Tensor) -> torch.Tensor:
    """Centered first difference, one vector component per spatial dim:
    out[..., d] = 0.5*(phi[i+1] - phi[i-1]) along d (gFinDiff1st).  The
    caller negates for E = -grad(phi) exactly like main.c:178-180."""
    comps = [0.5 * (torch.roll(phi, -1, dims=d) - torch.roll(phi, 1, dims=d))
             for d in range(phi.ndim)]
    return torch.stack(comps, dim=-1)


def laplacian(phi: torch.Tensor) -> torch.Tensor:
    """Second-order stencil sum_d (phi[i-1] - 2 phi[i] + phi[i+1])
    (gFinDiff2ndND, src/grid.c:264-294), periodic."""
    out = -2.0 * phi.ndim * phi
    for d in range(phi.ndim):
        out = out + torch.roll(phi, -1, dims=d) + torch.roll(phi, 1, dims=d)
    return out


def potential_energy(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Total field energy 0.5*sum(rho*phi) over true nodes
    (gPotEnergy, src/grid.c:1276-1321)."""
    return 0.5 * torch.sum(rho.float() * phi.float())


def fill_sin(spec: GridSpec, modes: List[int] | None = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rho, phi_exact) for rho = prod_d sin(2 pi m_d x_d / L_d),
    with phi the exact continuum solution of grad^2 phi = -rho
    (gFillSin, src/grid.c:1350-1744)."""
    L = spec.global_size
    nd = spec.n_dims
    modes = modes or [1] * nd
    axes = [np.arange(n, dtype=np.float64) for n in L]
    mesh = np.meshgrid(*axes, indexing="ij")
    rho = np.ones(L, dtype=np.float64)
    k2 = 0.0
    for d in range(nd):
        k = 2.0 * np.pi * modes[d] / L[d]
        rho = rho * np.sin(k * mesh[d])
        k2 += k * k
    phi = rho / k2
    return rho, phi
