"""The sharded geometric multigrid (the counterpart of
``pinc_tpu/parallel/mg.py``): the single-block solver's cycle on per-shard
blocks, with explicit halo planes between the shards.

The communication mirrors the reference's distributed multigrid:

* the per-colour halo refresh of the red-black smoother, ``gHaloOp`` +
  ``gBnd`` after every half sweep (mgGS3D, src/multigrid.c:683-767): one
  two-sided plane exchange a colour (``_exchange``);
* the halo refreshes of restriction and prolongation (mgHalfRestrict3D,
  mgBilinProl3D, src/multigrid.c:844-911, 1127-1238): one plane around
  the stencil;
* ``gNeutralizeGrid``'s MPI_Allreduce (src/grid.c:730-752): each shard's
  sum, added in mesh order (``MeshCtx.sum``), as ``pinc_tpu``'s psum of
  the shards' sums.

The shards advance in lockstep in the calling thread: the blocks of the
shards on one device are stacked along a leading axis, so every stage is
one launch a device (a mesh of one card runs the single-device launch
count), and a neighbour's plane is an index select inside a device or a
copy (``Tensor.to``) between devices.  Ghost planes come from the
neighbours in the interior and from the BC formulas (Dirichlet mirror,
Neumann offset ghost) at the global edges, so each stencil is the
single-device one on the padded block.  Over several processes a process
steps its own shards, grouped by device, and a neighbour's plane that
another process holds arrives point to point (``MeshCtx.fetch``).

Below the per-subdomain divisibility clamp the coarse grid is gathered
(``_gather_global``) and the hierarchy continues with the single-device
solver, once for each distinct device, cut back to the shards
(``_slice_local``): the agglomerated bottom.

The tolerance loop reads the summed RMS residual on the host once a cycle,
as the single-device solver does (``pinc_tpu`` runs a ``lax.while_loop``),
and stops at the same cycle.

Deviations kept from ``pinc_tpu`` (its behaviour, not the reference's):

* FMG's first coarse solve smooths on the sharded coarsest level and skips
  the agglomerated bottom (``pinc_tpu/parallel/mg.py:385``);
* below the clamp the W-cycle recurses as a V-cycle: the bottom solver is
  built with ``cycle="mgvrecursive"`` (``:107``);
* the bottom's depth stops silently where its extents stop dividing
  (``:100``), below the deck's ``mgLevels``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bc import BCSpec
from ..grid import BndType
from ..solvers.multigrid import MultigridSolver
from .mesh import MeshCtx

Blocks = List[torch.Tensor]      # one block a shard, in mesh order
Fields = List[torch.Tensor]      # one (n_g, *local) stack a distinct device


class ShardedMultigridSolver:
    """Callable ``phi_blocks = solve(rho_blocks)`` on a sharded field.
    Level geometry is static per shard; the cycle recurses over the static
    level list like the single-block MultigridSolver."""

    def __init__(self, ctx: MeshCtx, n_levels: int = 4, n_pre: int = 10,
                 n_post: int = 10, n_coarse: int = 10,
                 cycle: str = "mgvrecursive", max_cycles: int = 15,
                 tol: float = 1e-10, bc: Optional[BCSpec] = None,
                 dtype=torch.float32, n_bottom_levels: int = 1):
        self.ctx = ctx
        self.dtype = dtype
        self.cycle = cycle.lower()
        self.max_cycles = max_cycles
        self.tol = tol
        self.n_pre, self.n_post, self.n_coarse = n_pre, n_post, n_coarse
        # every level's local extent must stay a whole number of nodes:
        # the mgAllocSubGrids check (src/multigrid.c:317-329) per subdomain
        for t in ctx.true_size:
            if t % (1 << (n_levels - 1)) != 0:
                raise ValueError(
                    f"local grid extent {t} not divisible by "
                    f"2^{n_levels - 1} (per-subdomain mgAllocSubGrids "
                    "check, src/multigrid.c:317-329)")
        self.n_levels = n_levels
        if bc is not None and bc.periodic:
            bc = None
        self.bc = bc
        self._has_nullspace = bc is None or not any(
            b is BndType.DIRICHLET for b in bc.lower + bc.upper)
        self._local_shapes: List[Tuple[int, ...]] = [
            tuple(t >> lv for t in ctx.true_size) for lv in range(n_levels)]
        self._bcs: List[Optional[BCSpec]] = [
            bc if lv == 0 else (None if bc is None else bc.homogeneous())
            for lv in range(n_levels)]
        self._n_global = [math.prod(s) * ctx.n_devices
                          for s in self._local_shapes]
        self._cache: dict = {}
        self._group_layout()
        # coarse-grid agglomeration: below the clamp, the bottom level is
        # gathered (it is tiny by then) and the hierarchy continues with
        # the single-device solver (beyond the reference, whose hierarchy
        # stops at the subdomain clamp)
        self._bottom = None
        if n_bottom_levels > 1:
            bshape = tuple(t * n >> (n_levels - 1) for t, n in
                           zip(ctx.true_size, ctx.n_subdomains))
            nb = 1
            while (nb < n_bottom_levels
                   and all(s % (1 << nb) == 0 for s in bshape)
                   and min(s >> nb for s in bshape) >= 2):
                nb += 1
            if nb > 1:
                self._bottom = MultigridSolver(
                    bshape, n_levels=nb, n_pre=n_pre, n_post=n_post,
                    n_coarse=n_coarse, cycle="mgvrecursive",
                    max_cycles=1, tol=0.0, bc=self._bcs[-1], dtype=dtype)

    # ------------------------------------------------------------ groups
    def _group_layout(self):
        """This process's shards, grouped by device and stacked along a
        leading axis (a field is one (n_g, *local) tensor a device): on one
        card every shard's stage is one launch."""
        ctx = self.ctx
        devs = ctx.devices
        self._devs = ctx.distinct_devices()
        self._groups = [[i for i in ctx.local if devs[i] == dev]
                        for dev in self._devs]
        self._where = {}
        for g, idx in enumerate(self._groups):
            for k, i in enumerate(idx):
                self._where[i] = (g, k)

    def _stack(self, blocks: Blocks) -> Fields:
        return [torch.stack([blocks[i] for i in idx])
                for idx in self._groups]

    def _unstack(self, xs: Fields) -> Blocks:
        out: List[Optional[torch.Tensor]] = [None] * self.ctx.n_devices
        for idx, x in zip(self._groups, xs):
            for k, i in enumerate(idx):
                out[i] = x[k]
        return out

    def _from(self, planes: Fields, d: int, shift: int) -> Fields:
        """Each shard's copy of the plane that the shard ``shift`` away
        along mesh axis d holds (the receive side of a ppermute): an index
        select inside a device, copies between devices, and over several
        processes a point-to-point exchange of the planes that cross
        them."""
        if self.ctx.world > 1:
            return self._from_processes((planes, d, shift))[0]
        key = ("from", d, shift)
        if key not in self._cache:
            plan = []
            for g, idx in enumerate(self._groups):
                src = [self._where[self.ctx.neighbor(i, d, shift)]
                       for i in idx]
                local = all(gg == g for gg, _ in src)
                plan.append((local, torch.tensor(
                    [k for _, k in src], device=self._devs[g])
                    if local else src))
            self._cache[key] = plan
        out = []
        for g, (local, src) in enumerate(self._cache[key]):
            if local:
                out.append(planes[g].index_select(0, src))
            else:
                out.append(torch.cat([planes[gg][k:k + 1].to(
                    self._devs[g], copy=True) for gg, k in src]))
        return out

    def _from_both(self, last: Fields, first: Fields, d: int):
        """(_from(last, d, -1), _from(first, d, 1)): over several
        processes in one exchange."""
        if self.ctx.world > 1:
            return self._from_processes((last, d, -1), (first, d, 1))
        return self._from(last, d, -1), self._from(first, d, 1)

    def _from_processes(self, *requests) -> List[Fields]:
        """_from of each (planes, d, shift) request, the planes that cross
        processes sent and received in one exchange."""
        ctx = self.ctx
        boards = [self._unstack(planes) for planes, _, _ in requests]
        srcs = [(lambda j, d=d, shift=shift: ctx.neighbor(j, d, shift))
                for _, d, shift in requests]
        got = ctx.fetch(*zip(boards, srcs))
        return [[torch.stack([g[i] if i in g
                              else board[src(i)].to(dev, copy=True)
                              for i in idx])
                 for idx, dev in zip(self._groups, self._devs)]
                for board, src, g in zip(boards, srcs, got)]

    def _edge(self, d: int, top: bool) -> List[torch.Tensor]:
        """Per group, (n_g, 1, ..) booleans: the shards at the global bottom
        (top) along mesh axis d."""
        key = ("edge", d, top)
        if key not in self._cache:
            n = self.ctx.n_subdomains[d]
            nd = len(self.ctx.n_subdomains)
            self._cache[key] = [torch.tensor(
                [self.ctx.axis_index(d, i) == (n - 1 if top else 0)
                 for i in idx], device=dev).reshape((-1,) + (1,) * nd)
                for idx, dev in zip(self._groups, self._devs)]
        return self._cache[key]

    # ------------------------------------------------------ halo planes
    def _exchange(self, xs: Fields, level: int) -> Fields:
        """Pad one ghost plane a side a dim: the neighbours' planes in the
        interior, the BC ghosts (bc.pad_bc's formulas) at non-periodic
        global edges.  Dim by dim, so corner ghosts carry the dims already
        exchanged (gHaloOpDim's sweep order, src/grid.c:340-406)."""
        bc = self._bcs[level]
        for d, n in enumerate(self.ctx.n_subdomains):
            a = d + 1
            t = xs[0].shape[a]
            first = [x.narrow(a, 0, 1) for x in xs]
            last = [x.narrow(a, t - 1, 1) for x in xs]
            lo, hi = (self._from_both(last, first, d) if n > 1
                      else (last, first))
            if bc is not None:
                if bc.lower[d] is not BndType.PERIODIC:
                    v = bc.lower_value[d]
                    dirichlet = bc.lower[d] is BndType.DIRICHLET
                    ghost = [(2.0 * v - x.narrow(a, min(1, t - 1), 1))
                             if dirichlet else
                             (x.narrow(a, min(1, t - 1), 1) - 2.0 * v)
                             for x in xs]
                    lo = [torch.where(m, gh, l) for m, gh, l in
                          zip(self._edge(d, False), ghost, lo)]
                if bc.upper[d] is not BndType.PERIODIC:
                    v = bc.upper_value[d]
                    dirichlet = bc.upper[d] is BndType.DIRICHLET
                    ghost = [(2.0 * v - x.narrow(a, max(t - 2, 0), 1))
                             if dirichlet else
                             (x.narrow(a, max(t - 2, 0), 1) - 2.0 * v)
                             for x in xs]
                    hi = [torch.where(m, gh, h) for m, gh, h in
                          zip(self._edge(d, True), ghost, hi)]
            xs = [torch.cat([l, x, h], dim=a) for l, x, h in zip(lo, xs, hi)]
        return xs

    def _exchange_zero_edges(self, xs: Fields, level: int) -> Fields:
        """Halo pad whose ghosts at non-periodic global edges are zeros
        (defects vanish at clamped boundaries), the counterpart of
        restrict_half_weight's _pad_zero_or_wrap; interior shard
        boundaries still exchange neighbour planes."""
        bc = self._bcs[level]
        for d, n in enumerate(self.ctx.n_subdomains):
            a = d + 1
            t = xs[0].shape[a]
            first = [x.narrow(a, 0, 1) for x in xs]
            last = [x.narrow(a, t - 1, 1) for x in xs]
            lo, hi = (self._from_both(last, first, d) if n > 1
                      else (last, first))
            if bc is not None and not (bc.lower[d] is BndType.PERIODIC
                                       and bc.upper[d] is BndType.PERIODIC):
                lo = [torch.where(m, torch.zeros_like(l), l) for m, l in
                      zip(self._edge(d, False), lo)]
                hi = [torch.where(m, torch.zeros_like(h), h) for m, h in
                      zip(self._edge(d, True), hi)]
            xs = [torch.cat([l, x, h], dim=a) for l, x, h in zip(lo, xs, hi)]
        return xs

    @staticmethod
    def _nsum_from_pad(p: torch.Tensor, shape) -> torch.Tensor:
        """Face-neighbour sum from the (+1 a side) padded stack; shape is
        the stack's, (n_g, *local)."""
        nd = len(shape) - 1
        out = None
        for d in range(1, nd + 1):
            n = p.shape[d]
            s = p.narrow(d, 2, n - 2) + p.narrow(d, 0, n - 2)
            for dd in range(1, nd + 1):
                if s.shape[dd] != shape[dd]:
                    s = s.narrow(dd, 1, s.shape[dd] - 2)
            out = s if out is None else out + s
        return out

    # --------------------------------------------------- static per shard
    def _masks(self, level: int):
        """Per group (interior or None, (red, black) update masks, the
        Dirichlet values on the interior's complement or None): the local
        checkerboard offset by each shard's node offset (global parity),
        Dirichlet planes only on edge shards (later dims win on corners,
        as clamp_dirichlet)."""
        key = ("masks", level)
        if key not in self._cache:
            shape = self._local_shapes[level]
            bc = self._bcs[level]
            nd = len(shape)
            out = []
            for idx, dev in zip(self._groups, self._devs):
                reds, inters, vals = [], [], []
                for i in idx:
                    coords = self.ctx.coords(i)
                    acc = np.zeros(shape, np.int64)
                    interior = np.ones(shape, bool)
                    val = np.zeros(shape, np.float32)
                    for d in range(nd):
                        t = shape[d]
                        sh = [1] * nd
                        sh[d] = t
                        gidx = (coords[d] * t + np.arange(t)).reshape(sh)
                        acc = acc + gidx
                        if bc is None:
                            continue
                        G = t * self.ctx.n_subdomains[d]
                        for kind, v, at in (
                                (bc.lower[d], bc.lower_value[d], 0),
                                (bc.upper[d], bc.upper_value[d], G - 1)):
                            if kind is BndType.DIRICHLET:
                                plane = np.broadcast_to(gidx == at, shape)
                                interior &= ~plane
                                val[plane] = v
                    reds.append(acc % 2 == 0)
                    inters.append(interior)
                    vals.append(val)
                red, inter = np.stack(reds), np.stack(inters)
                upd = (red & inter, ~red & inter)
                has_walls = bc is not None
                out.append((torch.from_numpy(inter).to(dev)
                            if has_walls else None,
                            tuple(torch.from_numpy(m).to(dev) for m in upd),
                            torch.from_numpy(np.stack(vals)).to(dev)
                            if has_walls and not inter.all() else None))
            self._cache[key] = out
        return self._cache[key]

    def _clamp(self, xs: Fields, level: int) -> Fields:
        """Set the Dirichlet planes to their values (edge shards only)."""
        return [x if val is None else torch.where(inter, x, val.to(x.dtype))
                for x, (inter, _, val) in zip(xs, self._masks(level))]

    def _mesh_sum(self, per_shard: Fields) -> torch.Tensor:
        """Each shard's sum of its block, added in mesh order on every
        process (the same numbers whatever the grouping: a group's one
        row reduction, ``x.flatten(1).sum(1)``, is not its rows' sums bit
        for bit, on the card or a multithreaded CPU)."""
        sums = self._unstack([torch.stack([v.sum() for v in x])
                              for x in per_shard])
        return self.ctx.sum(sums)

    def _gmean(self, xs: Fields, level: int) -> torch.Tensor:
        s = self._mesh_sum([x.float() for x in xs])
        return s / self._n_global[level]

    def _neutral(self, xs: Fields, level: int) -> Fields:
        if not self._has_nullspace:
            return xs
        m = self._gmean(xs, level)
        return [x - m.to(x.device) for x in xs]

    # ------------------------------------------------------------ stages
    def _smooth(self, xs: Fields, rhos: Fields, level: int,
                n_iter: int) -> Fields:
        """Red-black Gauss-Seidel with a halo exchange a colour pass
        (mgGS3D's per-colour gHaloOp, src/multigrid.c:683-767)."""
        upd_masks = [m[1] for m in self._masks(level)]
        inv2d = 1.0 / (2.0 * (xs[0].dim() - 1))
        for _ in range(n_iter):
            for colour in (0, 1):
                ps = self._exchange(xs, level)
                xs = [torch.where(m[colour],
                                  (self._nsum_from_pad(p, x.shape) + r)
                                  * inv2d, x)
                      for p, r, x, m in zip(ps, rhos, xs, upd_masks)]
        return xs

    def _lap(self, xs: Fields, level: int) -> Fields:
        ps = self._exchange(xs, level)
        return [self._nsum_from_pad(p, x.shape) - 2.0 * (x.dim() - 1) * x
                for p, x in zip(ps, xs)]

    def _restrict(self, fine: Fields, level: int) -> Fields:
        """Half weighting with the ghost planes fetched once
        (mgHalfRestrict3D, src/multigrid.c:844-911).  The even-node samples
        are globally aligned: local extents are even at every restricted
        level."""
        D = fine[0].dim() - 1
        ps = self._exchange_zero_edges(fine, level)
        out = []
        for p, f in zip(ps, fine):
            st = 0.5 * f + (0.25 / D) * self._nsum_from_pad(p, f.shape)
            out.append(st[(slice(None),) + (slice(None, None, 2),) * D]
                       .contiguous())
        return out

    def _prolong(self, coarse: Fields, level: int) -> Fields:
        """Multilinear prolongation (mgBilinProl3D,
        src/multigrid.c:1127-1238): zero-stuff, then the odd nodes filled
        dim by dim; the last odd plane's + neighbour even plane arrives by
        one permute (the edge clamp at bounded global tops)."""
        bc = self._bcs[level]
        D = coarse[0].dim() - 1
        fine = []
        for c in coarse:
            f = c.new_zeros((c.shape[0],) + tuple(2 * s for s in c.shape[1:]))
            f[(slice(None),) + (slice(None, None, 2),) * D] = c
            fine.append(f)
        for d in range(D):
            a = d + 1
            n2 = fine[0].shape[a]
            plane0 = [f.narrow(a, 0, 1) for f in fine]
            ghost = (self._from(plane0, d, 1)
                     if self.ctx.n_subdomains[d] > 1 else plane0)
            if bc is not None and not (bc.lower[d] is BndType.PERIODIC
                                       and bc.upper[d] is BndType.PERIODIC):
                ghost = [torch.where(m, f.narrow(a, n2 - 2, 1), gh)
                         for m, f, gh in zip(self._edge(d, True), fine,
                                             ghost)]
            out = []
            for f, gh in zip(fine, ghost):
                # nxt[i] = fine[i+2] at the even positions read below; the
                # last even position reads the ghost plane
                nxt = torch.cat([f.narrow(a, 2, n2 - 2), gh, gh],
                                dim=a).narrow(a, 0, n2)
                avg = 0.5 * (f + nxt)
                odd = [slice(None)] * (D + 1)
                odd[a] = slice(1, None, 2)
                even = [slice(None)] * (D + 1)
                even[a] = slice(0, None, 2)
                f = f.clone()
                f[tuple(odd)] = avg[tuple(even)]
                out.append(f)
            fine = out
        return fine

    def _gather_global(self, blocks: Blocks, device) -> torch.Tensor:
        """The full (tiny) bottom-level grid on ``device``: every shard's
        block (``MeshCtx.complete``: over several processes gathered
        first) concatenated in mesh-block order (``lax.all_gather``)."""
        shape = blocks[0].shape
        g = torch.empty(tuple(s * n for s, n in
                              zip(shape, self.ctx.n_subdomains)),
                        dtype=blocks[0].dtype, device=device)
        for i, b in enumerate(blocks):
            g[tuple(slice(c * s, (c + 1) * s) for c, s in
                    zip(self.ctx.coords(i), shape))].copy_(b)
        return g

    def _slice_local(self, g: torch.Tensor, level: int, idx, device
                     ) -> torch.Tensor:
        """The stacked blocks of shards ``idx`` of a global level-``level``
        field, on ``device``."""
        shape = self._local_shapes[level]
        return torch.stack([g[tuple(slice(c * s, (c + 1) * s) for c, s in
                                    zip(self.ctx.coords(i), shape))]
                            for i in idx]).to(device, copy=True)

    # ------------------------------------------------------------- cycles
    def _vcycle(self, level: int, phi: Fields, rho: Fields) -> Fields:
        if level == self.n_levels - 1:
            if self._bottom is not None:
                # agglomerated bottom: gather phi and rho, one V-cycle of
                # the single-device recursion on each distinct device, cut
                # back
                out = []
                phi_b, rho_b = (self.ctx.complete(self._unstack(x))
                                for x in (phi, rho))
                for idx, dev in zip(self._groups, self._devs):
                    with self.ctx.scope(idx[0]):
                        gl = self._bottom._vcycle(
                            0, self._gather_global(phi_b, dev),
                            self._gather_global(rho_b, dev))
                        out.append(self._slice_local(gl, level, idx, dev))
                return out
            return self._smooth(phi, rho, level, self.n_coarse)
        phi = self._smooth(phi, rho, level, self.n_pre)
        defect = self._neutral([r + l for r, l in
                                zip(rho, self._lap(phi, level))], level)
        rhs_c = self._restrict(defect, level)
        err_c = [p.new_zeros((p.shape[0],) + self._local_shapes[level + 1])
                 for p in phi]
        err_c = self._vcycle(level + 1, err_c, rhs_c)
        if self.cycle in ("mgw", "w"):
            err_c = self._vcycle(level + 1, err_c, rhs_c)
        phi = [p + e for p, e in zip(phi, self._prolong(err_c, level))]
        phi = self._clamp(phi, level)
        return self._smooth(phi, rho, level, self.n_post)

    def _fmg(self, rho: Fields) -> Fields:
        rhs = [rho]
        for lv in range(1, self.n_levels):
            rhs.append(self._restrict(rhs[-1], lv - 1))
        phi = [r.new_zeros((r.shape[0],) + self._local_shapes[-1])
               for r in rho]
        phi = self._smooth(phi, rhs[-1], self.n_levels - 1, self.n_coarse)
        for lv in range(self.n_levels - 2, -1, -1):
            phi = self._prolong(phi, lv)
            phi = self._vcycle(lv, phi, rhs[lv])
        return phi

    def _rms2(self, phi: Fields, rho: Fields) -> torch.Tensor:
        sq = []
        for r, l, (inter, _, _) in zip(rho, self._lap(phi, 0),
                                       self._masks(0)):
            res = r + l
            if inter is not None:
                res = torch.where(inter, res, torch.zeros_like(res))
            sq.append(torch.square(res.float()))
        return self._mesh_sum(sq) / self._n_global[0]

    # --------------------------------------------------------------- solve
    def __call__(self, rho: Blocks) -> Blocks:
        return self.solve_with_stats(rho)[0]

    def solve_with_stats(self, rho: Blocks):
        """(phi blocks, n_cycles, residual): the measured solve-to-tolerance
        cycle count, as MultigridSolver.solve_with_stats, so mgMode writes
        the same timer.xy.h5 stats on the decomposed grid
        (src/multigrid.c:1998-2004).  One host sync a cycle."""
        rho = self._stack([None if r is None else r.to(self.dtype)
                           for r in rho])
        if self._has_nullspace:
            rho = self._neutral(rho, 0)
        phi = self._clamp([r.new_zeros(r.shape) for r in rho], 0)
        if self.cycle in ("mgfmg", "fmg"):
            phi = self._fmg(rho)
        # the while_loop of pinc_tpu, its f32 comparison r2 > tol^2
        tol2 = float(np.float32(self.tol ** 2))
        n_cycles = 0
        r2 = self._rms2(phi, rho)
        while n_cycles < self.max_cycles and float(r2) > tol2:
            phi = self._vcycle(0, phi, rho)
            n_cycles += 1
            r2 = self._rms2(phi, rho)
        if self._has_nullspace:
            phi = self._neutral(phi, 0)
        return self._unstack(self._clamp(phi, 0)), n_cycles, torch.sqrt(r2)


def from_single(solver: MultigridSolver, ctx: MeshCtx, cfg,
                dtype) -> ShardedMultigridSolver:
    """The sharded solver with the single-block solver's parameters (read
    from the deck's [multigrid] section).  Levels beyond the per-subdomain
    clamp continue on the agglomerated bottom grid, so the deck's depth is
    kept."""
    n_sh = min(solver.n_levels, _max_levels(ctx))
    return ShardedMultigridSolver(
        ctx,
        n_levels=n_sh,
        n_pre=cfg.get_int("multigrid:npresmooth", 10),
        n_post=cfg.get_int("multigrid:npostsmooth", 10),
        n_coarse=cfg.get_int("multigrid:ncoarsesolve", 10),
        cycle=solver.cycle, max_cycles=solver.max_cycles, tol=solver.tol,
        bc=solver.bc, dtype=dtype,
        n_bottom_levels=max(1, solver.n_levels - n_sh + 1))


def _max_levels(ctx: MeshCtx) -> int:
    """Deepest hierarchy whose local extents stay whole at every level."""
    L = 1
    while all(t % (1 << L) == 0 for t in ctx.true_size):
        L += 1
    return L
