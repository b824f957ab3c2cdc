"""The solver dispatch of the sharded simulations and the distributed
(pencil-decomposed) FFT Poisson solver (the counterpart of
``pinc_tpu/parallel/pencil_fft.py``).

A sharded solver is a callable ``phi_blocks = solve(rho_blocks)`` on the
per-shard lists of ``parallel/mesh.py``:

* ``parallel:shardedMG`` (default true) on an ``mgSolve`` deck whose local
  extents are even: the sharded multigrid (``parallel/mg.py``);
* a spectral deck with ``parallel:pencilFFT`` (default: on above 64 MB
  grids) whose x and y extents divide the shard count: the pencil FFT;
* otherwise the replicated solve: the global rho on each distinct device
  of the mesh, the single-device solver once there, its phi cut into that
  device's shards (``pinc_tpu`` runs the full solve on every device; the
  result is the same everywhere).

The pencil solve keeps the field distributed: x-slabs (axis 0 split over
all shards in mesh order), ``rfft2`` over axes (1, 2), a slab-to-slab
all-to-all onto y-slabs, ``fft`` over axis 0, 1/k^2 (``_inv_k2``'s
numbers, DC zeroed), and back.  Over several processes a slab is
transformed by the process that holds its shard, and the all-to-alls send
the pieces that cross processes point to point.  The reference's FFTW
solver is 1-D and single-rank only (src/spectral.c:80-90).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..solvers.spectral import _inv_k2
from ..utils import multihost as mh
from .mesh import MeshCtx

Box = Tuple[Tuple[int, int], ...]


def _reshard(ctx: MeshCtx, src: Sequence[Optional[torch.Tensor]],
             src_boxes: Sequence[Box], dst_boxes: Sequence[Box],
             dst_devices) -> List[Optional[torch.Tensor]]:
    """Move the pieces of a global field from one decomposition to another
    (piece k of each held by shard k): each of this process's destination
    boxes is filled from every source piece it meets, ``copy_`` across
    devices, and the pieces another process holds sent and received point
    to point (``multihost.exchange``).  Boxes cover the leading
    dims."""
    def meet(box, sbox):
        lo = [max(a[0], b[0]) for a, b in zip(box, sbox)]
        hi = [min(a[1], b[1]) for a, b in zip(box, sbox)]
        if any(h <= l for l, h in zip(lo, hi)):
            return None
        return (tuple(slice(l - b[0], h - b[0]) for l, h, b in
                      zip(lo, hi, box)),
                tuple(slice(l - b[0], h - b[0]) for l, h, b in
                      zip(lo, hi, sbox)))

    n = len(dst_boxes)
    like = next(s for s in src if s is not None)
    tail = tuple(like.shape[len(dst_boxes[0]):])
    sends, recvs = defaultdict(list), defaultdict(list)
    # the pieces that cross processes, in (destination, source) order on
    # both sides
    for k in range(n):
        for s in range(n):
            m = meet(dst_boxes[k], src_boxes[s])
            if m is None or ctx.is_local(k) == ctx.is_local(s):
                continue
            if ctx.is_local(s):
                sends[ctx.owner(k)].append(src[s][m[1]].contiguous())
            else:
                shape = tuple(sl.stop - sl.start for sl in m[0]) + tail
                recvs[ctx.owner(s)].append(torch.empty(
                    shape, dtype=like.dtype, device=dst_devices[k]))
    got = {q: iter(v) for q, v in mh.exchange(sends, recvs).items()}
    out: List[Optional[torch.Tensor]] = [None] * n
    for k in ctx.local:
        box = dst_boxes[k]
        shape = tuple(hi - lo for lo, hi in box) + tail
        o = torch.empty(shape, dtype=like.dtype, device=dst_devices[k])
        for s in range(n):
            m = meet(box, src_boxes[s])
            if m is None:
                continue
            o[m[0]].copy_(src[s][m[1]] if ctx.is_local(s)
                          else next(got[ctx.owner(s)]))
        out[k] = o
    return out


def _mesh_boxes(ctx: MeshCtx) -> List[Box]:
    return [tuple((s.start, s.stop) for s in ctx.block_slices(i))
            for i in range(ctx.n_devices)]


def _slab_boxes(shape: Sequence[int], n: int, axis: int) -> List[Box]:
    w = shape[axis] // n
    return [tuple((k * w, (k + 1) * w) if d == axis else (0, s)
                  for d, s in enumerate(shape)) for k in range(n)]


def make_sharded_solver(solver, ctx: MeshCtx, cfg, dtype):
    """The sharded simulations' solver: ``phi_blocks = f(rho_blocks)``
    (dispatch above)."""
    from ..solvers.multigrid import MultigridSolver
    from ..solvers.spectral import SpectralSolver

    if not isinstance(solver, SpectralSolver):
        if (isinstance(solver, MultigridSolver)
                and cfg.get_bool("parallel:shardedmg", True)
                and all(t % 2 == 0 for t in ctx.true_size)):
            from . import mg as _mg
            return _mg.from_single(solver, ctx, cfg, dtype)

        def solve_mg(rho_blocks):
            return ctx.replicated(solver, rho_blocks)
        return solve_mg

    big = math.prod(ctx.global_size) * 4 > (64 << 20)
    # the pencil path flattens every mesh axis into one slab axis: any
    # mesh qualifies where the grid's x and y extents divide the shards
    divides = (len(ctx.global_size) == 3 and not any(
        g % ctx.n_devices for g in ctx.global_size[:2]))
    if divides and cfg.get_bool("parallel:pencilfft", big):
        return PencilSpectralSolver(ctx.global_size, ctx, fd=solver.fd,
                                    dtype=dtype)

    def solve_replicated(rho_blocks):
        return ctx.replicated(solver, rho_blocks)
    return solve_replicated


class PencilSpectralSolver:
    """Callable phi_blocks = solve(rho_blocks) on a sharded 3-D periodic
    grid."""

    def __init__(self, shape: Sequence[int], ctx: MeshCtx, fd: bool = False,
                 dtype=torch.float32):
        assert len(shape) == 3, "pencil FFT is 3D"
        self.shape = tuple(shape)
        self.ctx = ctx
        self.dtype = dtype
        n = ctx.n_devices
        if self.shape[0] % n or self.shape[1] % n:
            raise ValueError(
                f"pencil FFT needs grid x/y extents divisible by the "
                f"device count {n}, got {self.shape[:2]}")
        self._mesh = _mesh_boxes(ctx)
        self._xslab = _slab_boxes(self.shape, n, 0)
        half = self.shape[:2] + (self.shape[2] // 2 + 1,)
        self._cx = _slab_boxes(half, n, 0)
        self._cy = _slab_boxes(half, n, 1)
        inv = _inv_k2(self.shape, fd, np.float32)
        w = half[1] // n
        # each local y-slab's part of the 1/k^2 table, on its device
        self._inv_k2 = [torch.from_numpy(np.ascontiguousarray(
            inv[:, k * w:(k + 1) * w])).to(dev) if ctx.is_local(k) else None
            for k, dev in enumerate(ctx.devices)]

    def __call__(self, rho_blocks: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
        ctx = self.ctx
        devs = ctx.devices
        x = _reshard(ctx, [None if r is None else r.float()
                           for r in rho_blocks], self._mesh, self._xslab,
                     devs)
        c = ctx.map(lambda s: torch.fft.rfft2(s, dim=(1, 2)), x)
        c = _reshard(ctx, c, self._cx, self._cy, devs)
        c = ctx.map(lambda s, k: torch.fft.ifft(
            torch.fft.fft(s, dim=0) * k, dim=0), c, self._inv_k2)
        c = _reshard(ctx, c, self._cy, self._cx, devs)
        phi = ctx.map(lambda s: torch.fft.irfft2(
            s, s=self.shape[1:], dim=(1, 2)), c)
        phi = _reshard(ctx, phi, self._xslab, self._mesh, devs)
        return [None if p is None else p.to(self.dtype) for p in phi]
