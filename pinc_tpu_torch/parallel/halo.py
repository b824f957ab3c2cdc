"""Halo exchange between shards (the counterpart of
``pinc_tpu/parallel/halo.py``).

The reference's ``gHaloOp``/``gHaloOpDim`` (src/grid.c:340-406) extract a
slice, MPI_Sendrecv it to the +-1 neighbour and set or add it into the
ghost layer.  Here each direction is one ``MeshCtx.ppermute`` of a plane
inside ``MeshCtx.shard_map``; these functions run in a shard's thread on
its local block, as ``pinc_tpu``'s run inside ``shard_map``.

* :func:`pad_plus` (TOHALO / setSlice): append the + neighbour's first
  plane as a ghost plane, so a CIC gather at local index t can read it.
* :func:`fold_plus` (FROMHALO / addSlice): send the overflow plane of a
  padded deposition block to the + neighbour and add it into its first
  plane.
* :func:`shifted_tiles`: ``torch.roll`` along a tile axis, with the plane
  that wraps fetched from the neighbouring shard.

The first two go dimension by dimension, so corner contributions flow as
in the reference's sequential gHaloOpDim sweeps.  CIC support is one cell
in the + direction (a particle in cell i touches nodes i and i+1), so
only +1 planes are exchanged.  Every shard takes part in every permute,
also where its own result does not use it (the bounded edges).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import MeshCtx


def _perm(n: int, shift: int):
    """Cyclic permutation pairs (src, dst) shifting data by `shift`."""
    return [(i, (i + shift) % n) for i in range(n)]


def pad_plus(block: torch.Tensor, ctx: MeshCtx,
             bounded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Append one ghost plane at the high end of every spatial dim, filled
    with the + neighbour's plane 0.  block: (*t[, C]) -> (*t+1[, C]).

    bounded[d]: non-periodic upper edge along dim d; the global top
    shard's ghost plane is its own last plane, the single-device CIC clamp
    (ops/cic._corner_indices with periodic=False)."""
    for d, n in enumerate(ctx.n_subdomains):
        first = block.narrow(d, 0, 1)
        # receive plane 0 of the +1 neighbour == send ours to -1
        ghost = ctx.ppermute(first, d, -1) if n > 1 else first
        if bounded is not None and bounded[d]:
            if n == 1 or ctx.axis_index(d) == n - 1:
                ghost = block.narrow(d, block.shape[d] - 1, 1)
        block = torch.cat([block, ghost], dim=d)
    return block


def shifted_tiles(x: torch.Tensor, axis: int, shift: int, ctx: MeshCtx,
                  d: int) -> torch.Tensor:
    """Roll a per-tile array one step along local tile axis ``axis``, with
    the plane that wraps fetched from the neighbouring shard along mesh
    axis d (periodic globally).  One shard along d is the plain roll.

    shift=+1: data moves to higher tiles, plane 0 receives the -1
    neighbour's last plane.  shift=-1: the converse."""
    y = torch.roll(x, shift, axis)
    if ctx.n_subdomains[d] <= 1:
        return y
    L = x.shape[axis]
    if shift == 1:
        plane = ctx.ppermute(x.narrow(axis, L - 1, 1), d, 1)
        return torch.cat([plane, y.narrow(axis, 1, L - 1)], dim=axis)
    plane = ctx.ppermute(x.narrow(axis, 0, 1), d, -1)
    return torch.cat([y.narrow(axis, 0, L - 1), plane], dim=axis)


def fold_plus(block: torch.Tensor, ctx: MeshCtx,
              bounded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Deposition halo-add: block has one overflow plane at the high end of
    every spatial dim (*t+1[, C]); fold each into the + neighbour's plane 0
    and drop it.  Returns (*t[, C]).

    bounded[d]: non-periodic upper edge; the global top shard folds its
    overflow into its own last plane (the single-device scatter clamps
    node L to L-1), and the global bottom shard discards the plane that
    wraps in."""
    for d, n in enumerate(ctx.n_subdomains):
        t = block.shape[d] - 1
        body = block.narrow(d, 0, t)
        over_own = block.narrow(d, t, 1)
        over = ctx.ppermute(over_own, d, 1) if n > 1 else over_own
        if bounded is not None and bounded[d]:
            c = ctx.axis_index(d)
            is_top = n == 1 or c == n - 1
            if n == 1 or c == 0:
                over = torch.zeros_like(over)
            add_last = over_own if is_top else torch.zeros_like(over_own)
            last = body.narrow(d, t - 1, 1) + add_last
            mid = body.narrow(d, 1, t - 2)
            first = body.narrow(d, 0, 1) + over
            block = torch.cat([first, mid, last], dim=d)
        else:
            first = body.narrow(d, 0, 1) + over
            block = torch.cat([first, body.narrow(d, 1, t - 1)], dim=d)
    return block
