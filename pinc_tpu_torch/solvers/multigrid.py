"""Geometric multigrid Poisson solver (the counterpart of
``pinc_tpu/solvers/multigrid.py``).

The reference's ``src/multigrid.c``: solve ``grad^2 phi = -rho`` on a
hierarchy of 2x-coarsened grids with red-black Gauss-Seidel (or damped
Jacobi) smoothing, half-weighting restriction and multilinear
prolongation, driven to an RMS-residual tolerance (``mgSolveRaw``,
src/multigrid.c:1688-1724).

* A colour update is a dense masked stencil over the whole level: rolls
  (periodic) or the padded planes of ``bc.pad_bc`` (bounded) and a
  ``torch.where``, plain PyTorch on the level's tensors.
* Cycles (V regular/recursive, W, FMG, src/multigrid.c:1496-1683) are
  Python recursion over the static level list.
* The tolerance loop runs on the host: pinc_tpu keeps it on the device
  (``lax.while_loop``), eager PyTorch reads the RMS residual after every
  cycle, one host sync a cycle (at most ``mgCycles`` a solve).  The cycle
  count, and so phi, is pinc_tpu's.
* Dirichlet planes are clamped and masked out of the smoothers; Neumann
  ghosts come from ``pad_bc``.  Coarse levels solve the error equation
  with homogeneous versions of the same BCs.  Levels with no Dirichlet
  edge have a null space (the mean), so the defect is re-neutralized on
  every level, like the gNeutralizeGrid calls of mgVRegular
  (src/multigrid.c:1586-1626).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bc import (BCSpec, clamp_dirichlet, interior_mask, laplacian_bc,
                  neighbor_sum_bc)
from ..config import PincConfig
from ..grid import BndType
from ..registry import SOLVERS


class _Mask:
    """A constant boolean mask, moved to the device of the field it first
    meets and kept there."""

    def __init__(self, mask: np.ndarray):
        self._t = torch.from_numpy(np.ascontiguousarray(mask))

    def on(self, device) -> torch.Tensor:
        if self._t.device != device:
            self._t = self._t.to(device)
        return self._t


# ---------------------------------------------------------------------------
# Stencil primitives
# ---------------------------------------------------------------------------

def _neighbor_sum_periodic(phi: torch.Tensor) -> torch.Tensor:
    out = None
    for d in range(phi.ndim):
        s = torch.roll(phi, 1, dims=d) + torch.roll(phi, -1, dims=d)
        out = s if out is None else out + s
    return out


def _checkerboard(shape: Sequence[int]) -> np.ndarray:
    """Red mask: (i+j+k+...) % 2 == 0.  Requires even extents per dim for a
    consistent periodic colouring (true for all power-of-two levels)."""
    acc = np.zeros(shape, dtype=np.int64)
    for d, L in enumerate(shape):
        sh = [1] * len(shape)
        sh[d] = L
        acc = acc + np.arange(L).reshape(sh)
    return (acc % 2) == 0


def _level_ops(shape, bc: Optional[BCSpec]):
    """(neighbor_sum, update mask or None, laplacian) for one level."""
    if bc is None or bc.periodic:
        nsum = _neighbor_sum_periodic
        mask = None

        def lap(phi):
            return nsum(phi) - 2.0 * phi.ndim * phi
    else:
        nsum = partial(neighbor_sum_bc, bc=bc)
        m = interior_mask(shape, bc)
        mask = None if m.all() else m
        lap = partial(laplacian_bc, bc=bc)
    return nsum, mask, lap


# ---------------------------------------------------------------------------
# Smoothers.  All solve grad^2 phi = -rho: the pointwise update is
# phi_i = (sum(neighbours) + rho_i) / (2*D).
# ---------------------------------------------------------------------------

def make_gauss_seidel_rb(shape: Sequence[int], n_iter: int,
                         bc: Optional[BCSpec] = None) -> Callable:
    """Red-black Gauss-Seidel (mgGS2D/3D/ND, src/multigrid.c:584-837):
    update red sites from black neighbours, then black from updated red."""
    red = _checkerboard(shape)
    nsum, mask, _ = _level_ops(shape, bc)
    red_upd = _Mask(red if mask is None else red & mask)
    blk_upd = _Mask(~red if mask is None else ~red & mask)

    def smooth(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        inv2d = 1.0 / (2.0 * phi.ndim)
        r, b = red_upd.on(phi.device), blk_upd.on(phi.device)
        for _ in range(n_iter):
            phi = torch.where(r, (nsum(phi) + rho) * inv2d, phi)
            phi = torch.where(b, (nsum(phi) + rho) * inv2d, phi)
        return phi
    return smooth


def make_jacobi(shape: Sequence[int], n_iter: int,
                bc: Optional[BCSpec] = None,
                omega: float = 2.0 / 3.0) -> Callable:
    """Damped Jacobi (mgJacobi1D/3D/ND, src/multigrid.c:413-552; damping
    added — plain Jacobi does not damp the highest mode)."""
    nsum, mask, _ = _level_ops(shape, bc)
    m = None if mask is None else _Mask(mask)

    def smooth(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        inv2d = 1.0 / (2.0 * phi.ndim)
        for _ in range(n_iter):
            upd = (nsum(phi) + rho) * inv2d
            new = phi + omega * (upd - phi)
            phi = new if m is None else torch.where(m.on(phi.device), new,
                                                    phi)
        return phi
    return smooth


SMOOTHERS = {
    "gaussseidelrb": make_gauss_seidel_rb,
    "gaussseidelrbnd": make_gauss_seidel_rb,
    "gaussseidel": make_gauss_seidel_rb,
    "jacobi": make_jacobi,
    "jacobind": make_jacobi,
}


# ---------------------------------------------------------------------------
# Transfer operators
# ---------------------------------------------------------------------------

def _pad_zero_or_wrap(x: torch.Tensor,
                      periodic_dims: Sequence[bool]) -> torch.Tensor:
    """Pad one plane per side: wrap on periodic dims, zeros elsewhere
    (defects vanish at clamped boundaries)."""
    for d in range(x.ndim):
        n = x.shape[d]
        if periodic_dims[d]:
            lo, hi = x.narrow(d, n - 1, 1), x.narrow(d, 0, 1)
        else:
            lo = hi = torch.zeros_like(x.narrow(d, 0, 1))
        x = torch.cat([lo, x, hi], dim=d)
    return x


def _periodic_dims(bc: Optional[BCSpec], nd: int) -> List[bool]:
    if bc is None:
        return [True] * nd
    return [bc.lower[d] is BndType.PERIODIC and bc.upper[d] is BndType.PERIODIC
            for d in range(nd)]


def restrict_half_weight(fine: torch.Tensor,
                         bc: Optional[BCSpec] = None) -> torch.Tensor:
    """Half-weighting restriction (mgHalfRestrict3D/ND,
    src/multigrid.c:844-1022): coarse = 1/2 centre + 1/(4D) face
    neighbours, sampled at the even fine nodes."""
    D = fine.ndim
    p = _pad_zero_or_wrap(fine, _periodic_dims(bc, D))
    core = [slice(1, n - 1) for n in p.shape]
    nsum = None
    for d in range(D):
        up, lo = list(core), list(core)
        up[d] = slice(2, p.shape[d])
        lo[d] = slice(0, p.shape[d] - 2)
        s = p[tuple(up)] + p[tuple(lo)]
        nsum = s if nsum is None else nsum + s
    stencil = 0.5 * fine + (0.25 / D) * nsum
    return stencil[(slice(None, None, 2),) * D].contiguous()


def prolong_multilinear(coarse: torch.Tensor,
                        bc: Optional[BCSpec] = None) -> torch.Tensor:
    """Multilinear prolongation (mgBilinProl3D/ND,
    src/multigrid.c:1096-1238): the coarse values at the even fine nodes,
    then the odd nodes filled dimension by dimension with the average of
    their already-filled neighbours (periodic wrap or edge clamp)."""
    D = coarse.ndim
    pdims = _periodic_dims(bc, D)
    fine = coarse.new_zeros(tuple(2 * s for s in coarse.shape))
    fine[(slice(None, None, 2),) * D] = coarse
    for d in range(D):
        n = fine.shape[d]
        if pdims[d]:
            nxt = torch.roll(fine, -2, dims=d)
        else:
            # edge clamp: the last odd plane averages with the last even one
            nxt = torch.cat([fine.narrow(d, 2, n - 2),
                             fine.narrow(d, n - 2, 1),
                             fine.narrow(d, n - 1, 1)], dim=d)
        avg = 0.5 * (fine + nxt)
        odd = [slice(None)] * D
        odd[d] = slice(1, None, 2)
        even = [slice(None)] * D
        even[d] = slice(0, None, 2)
        fine[tuple(odd)] = avg[tuple(even)]
    return fine


RESTRICTORS = {
    "halfweight": restrict_half_weight,
    "halfweightnd": restrict_half_weight,
}
PROLONGATORS = {
    "bilinear": prolong_multilinear,
    "bilinearnd": prolong_multilinear,
}


# ---------------------------------------------------------------------------
# Cycles + tolerance driver
# ---------------------------------------------------------------------------

def _neutral(x: torch.Tensor) -> torch.Tensor:
    return x - torch.mean(x)


class MultigridSolver:
    """Callable phi = solve(rho), on the device of rho.  All level
    geometry is static; the tolerance loop (mgSolveRaw semantics,
    src/multigrid.c:1688-1724) reads the residual on the host once a
    cycle."""

    def __init__(self, shape: Sequence[int], n_levels: int = 4,
                 n_pre: int = 10, n_post: int = 10, n_coarse: int = 10,
                 cycle: str = "mgvrecursive", smoother: str = "gaussseidelrb",
                 max_cycles: int = 15, tol: float = 1e-10,
                 bc: Optional[BCSpec] = None, dtype=torch.float32):
        shape = tuple(shape)
        for s in shape:
            if s % (1 << (n_levels - 1)) != 0:
                raise ValueError(
                    f"grid extent {s} not divisible by 2^{n_levels-1} "
                    f"(mgAllocSubGrids check, src/multigrid.c:317-329)")
        self.shape = shape
        self.n_levels = n_levels
        self.cycle = cycle.lower()
        self.max_cycles = max_cycles
        self.tol = tol
        self.dtype = dtype
        if bc is not None and bc.periodic:
            bc = None
        self.bc = bc
        # the mean is only fixed when some Dirichlet plane pins phi
        self._has_nullspace = bc is None or not any(
            b is BndType.DIRICHLET for b in bc.lower + bc.upper)

        self._shapes: List[Tuple[int, ...]] = [
            tuple(s >> lv for s in shape) for lv in range(n_levels)]
        self._bcs: List[Optional[BCSpec]] = [
            bc if lv == 0 else (None if bc is None else bc.homogeneous())
            for lv in range(n_levels)]
        mk = SMOOTHERS[smoother.lower()]
        self._pre = [mk(s, n_pre, b) for s, b in zip(self._shapes, self._bcs)]
        self._post = [mk(s, n_post, b)
                      for s, b in zip(self._shapes, self._bcs)]
        self._coarse = mk(self._shapes[-1], n_coarse, self._bcs[-1])
        self._laps = [_level_ops(s, b)[2]
                      for s, b in zip(self._shapes, self._bcs)]
        self._resid_mask = (None if bc is None
                            else _Mask(interior_mask(shape, bc)))

    def _maybe_neutral(self, x: torch.Tensor) -> torch.Tensor:
        return _neutral(x) if self._has_nullspace else x

    # ------------------------------------------------------------- v-cycle
    def _vcycle(self, level: int, phi: torch.Tensor,
                rho: torch.Tensor) -> torch.Tensor:
        if level == self.n_levels - 1:
            return self._coarse(phi, rho)
        phi = self._pre[level](phi, rho)
        defect = self._maybe_neutral(rho + self._laps[level](phi))
        rhs_c = restrict_half_weight(defect, self._bcs[level])
        err_c = phi.new_zeros(self._shapes[level + 1])
        err_c = self._vcycle(level + 1, err_c, rhs_c)
        if self.cycle in ("mgw", "w"):                 # W-cycle: recurse twice
            err_c = self._vcycle(level + 1, err_c, rhs_c)
        phi = phi + prolong_multilinear(err_c, self._bcs[level])
        if self._bcs[level] is not None:
            phi = clamp_dirichlet(phi, self._bcs[level])
        return self._post[level](phi, rho)

    def _fmg(self, rho: torch.Tensor) -> torch.Tensor:
        """Full multigrid (mgFMG, src/multigrid.c:1652-1673): solve the
        coarsest level first, prolong up, a V-cycle on each level."""
        rhs = [rho]
        for lv in range(1, self.n_levels):
            rhs.append(restrict_half_weight(rhs[-1], self._bcs[lv - 1]))
        phi = self._coarse(rho.new_zeros(self._shapes[-1]), rhs[-1])
        for lv in range(self.n_levels - 2, -1, -1):
            phi = prolong_multilinear(phi, self._bcs[lv])
            phi = self._vcycle(lv, phi, rhs[lv])
        return phi

    # --------------------------------------------------------------- solve
    def __call__(self, rho: torch.Tensor,
                 phi0: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.solve_with_stats(rho, phi0)[0]

    def _rms2(self, phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        r = rho + self._laps[0](phi)
        if self._resid_mask is not None:
            r = torch.where(self._resid_mask.on(r.device), r,
                            torch.zeros((), dtype=r.dtype, device=r.device))
        return torch.mean(torch.square(r.float()))

    def solve_with_stats(self, rho: torch.Tensor,
                         phi0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, int, torch.Tensor]:
        """-> (phi, n_cycles, rms_residual): the V-cycles run to reach the
        tolerance (what the reference's mgMode writes to timer.xy.h5,
        src/multigrid.c:1998-2004) and the final RMS residual, a 0-d
        tensor on rho's device.  One host sync a cycle."""
        rho = rho.to(self.dtype)
        if self._has_nullspace:
            rho = _neutral(rho)
        if phi0 is None:
            phi0 = rho.new_zeros(self.shape)
        if self.bc is not None:
            phi0 = clamp_dirichlet(phi0, self.bc)
        if self.cycle in ("mgfmg", "fmg"):
            phi0 = self._fmg(rho)
        # the while_loop of pinc_tpu, its f32 comparison r2 > tol^2
        tol2 = float(np.float32(self.tol ** 2))
        phi, n_cycles = phi0, 0
        r2 = self._rms2(phi, rho)
        while n_cycles < self.max_cycles and float(r2) > tol2:
            phi = self._vcycle(0, phi, rho)
            n_cycles += 1
            r2 = self._rms2(phi, rho)
        if self._has_nullspace:
            phi = _neutral(phi)
        if self.bc is not None:
            phi = clamp_dirichlet(phi, self.bc)
        return phi, n_cycles, torch.sqrt(r2)


# ---------------------------------------------------------------------------
# Registry binding — reads the [multigrid] ini section
# (mgSetSolver/getMgAlgo, src/multigrid.c:28-125)
# ---------------------------------------------------------------------------

def make_from_config(cfg: PincConfig) -> MultigridSolver:
    from ..grid import GridSpec
    spec = GridSpec.from_config(cfg)
    default_tol = 1e-10 if spec.dtype == torch.float64 else 5e-6
    bc = BCSpec.from_config(cfg)
    return MultigridSolver(
        shape=spec.global_size,
        n_levels=cfg.get_int("multigrid:mglevels", 4),
        n_pre=cfg.get_int("multigrid:npresmooth", 10),
        n_post=cfg.get_int("multigrid:npostsmooth", 10),
        n_coarse=cfg.get_int("multigrid:ncoarsesolve", 10),
        cycle=cfg.get_str("multigrid:cycle", "mgVRecursive"),
        smoother=cfg.get_str("multigrid:presmooth", "gaussSeidelRB"),
        max_cycles=cfg.get_int("multigrid:mgcycles", 15),
        tol=cfg.get_double("multigrid:tol", default_tol),
        bc=None if bc.periodic else bc,
        dtype=spec.dtype,
    )


SOLVERS.register("mgSolve")(make_from_config)
SOLVERS.register("mgSolver")(make_from_config)
SOLVERS.register("multigrid")(make_from_config)
