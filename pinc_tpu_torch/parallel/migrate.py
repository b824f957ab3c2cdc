"""Particle migration between shards (the counterpart of
``pinc_tpu/parallel/migrate.py``).

The reference's emigrant machinery (``puExtractEmigrants3D``/``ND`` +
``puMigrate``, src/pusher.c:782-1035) sorts particles into 3^D-1
neighbour bins with dynamically sized buffers.  ``pinc_tpu`` replaces it
with fixed shapes, and so does the port:

* migration goes dimension by dimension (x, then y, then z); a corner
  crossing hops two shards in two sub-exchanges, which equals the 3^D
  neighbourhood while a step moves less than one subdomain;
* emigrants are compacted by cumsum rank into fixed-capacity buffers
  (``parallel:migrationCap``), sent with one ``MeshCtx.ppermute`` a
  direction, and scattered into the free slots found by a second cumsum;
* a buffer overflow, or an arrival that finds no free slot, is counted
  (the lost count, summed over the mesh) instead of corrupting memory.

Particles carry global (unwrapped) cell coordinates during the exchange;
ownership tests use the local frame (cell - offset), and the global
periodic wrap is applied once at the end.  These run in a shard's thread
inside ``MeshCtx.shard_map``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..population import Particles
from .mesh import MeshCtx


def _perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def _pack(arrs, mask: torch.Tensor, K: int):
    """Compact the rows of each array where mask is set into the first rows
    of a (K,)-capacity buffer.  Returns (buffers, valid (K,), overflow)."""
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    idx = torch.where(mask & (rank < K), rank,
                      torch.full_like(rank, K)).long()     # K = drop slot
    bufs = []
    for a in arrs:
        m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
        b = a.new_zeros((K + 1,) + tuple(a.shape[1:]))
        b[idx] = torch.where(m, a, torch.zeros_like(a))
        bufs.append(b[:K])
    valid = torch.zeros((K + 1,), dtype=torch.bool, device=mask.device)
    valid[idx] = mask
    n_sent = valid[:K].sum()
    overflow = mask.sum() - n_sent
    return bufs, valid[:K], overflow


def _unpack(arrs, alive: torch.Tensor, bufs, valid: torch.Tensor):
    """Scatter the valid buffer rows into free (dead) slots.  Returns
    (arrays, alive, n_dropped)."""
    cap = alive.shape[0]
    K = valid.shape[0]
    dev = alive.device
    free = ~alive
    frank = torch.cumsum(free.to(torch.int32), 0) - 1
    # slot_of_rank[r] = index of the r-th free slot (cap if there is none)
    sidx = torch.where(free & (frank < K), frank,
                       torch.full_like(frank, K)).long()
    slot_of_rank = torch.full((K + 1,), cap, dtype=torch.int64, device=dev)
    slot_of_rank[sidx] = torch.arange(cap, dtype=torch.int64, device=dev)
    tgt = torch.where(valid, slot_of_rank[:K],
                      torch.full((K,), cap, dtype=torch.int64, device=dev))
    dropped = (valid & (tgt >= cap)).sum()
    out = []
    for a, b in zip(arrs, bufs):
        # row cap takes the rows that found no slot, and is cut off
        ext = torch.cat([a, a[:1]])
        ext[tgt] = b
        out.append(ext[:cap])
    ext = torch.cat([alive, alive[:1]])
    ext[tgt] = True
    return out, ext[:cap], dropped


def migrate_species(cell: torch.Tensor, frac: torch.Tensor,
                    vel: torch.Tensor, alive: torch.Tensor, ctx: MeshCtx,
                    offset: Sequence[int], K: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """One species' per-dimension exchange.  cell/frac/vel: (cap, D),
    alive: (cap,).  Returns the updated arrays + the lost count."""
    lost = torch.zeros((), dtype=torch.int32, device=cell.device)
    for d, (n, t) in enumerate(zip(ctx.n_subdomains, ctx.true_size)):
        lc = cell[:, d] - offset[d]
        for shift, mask in ((-1, alive & (lc < 0)), (+1, alive & (lc >= t))):
            bufs, valid, over = _pack([cell, frac, vel], mask, K)
            alive = alive & ~mask
            if n > 1:
                *bufs, valid = ctx.ppermute((*bufs, valid), d, shift)
            (cell, frac, vel), alive, dropped = _unpack(
                [cell, frac, vel], alive, bufs, valid)
            lost = lost + over.to(torch.int32) + dropped.to(torch.int32)
    # the global periodic wrap (shiftImmigrants, src/pusher.c:941-964)
    L = torch.tensor(ctx.global_size, dtype=cell.dtype, device=cell.device)
    cell = torch.where(alive[:, None], torch.remainder(cell, L), cell)
    return cell, frac, vel, alive, lost


def migrate(p: Particles, ctx: MeshCtx, offset: Sequence[int],
            K: int) -> Tuple[Particles, torch.Tensor]:
    """All-species migration (puMigrate, src/pusher.c:1030-1035), in a
    shard's thread; returns (particles, the lost count summed over the
    mesh)."""
    S = p.cell.shape[0]
    cells, fracs, vels, alives = [], [], [], []
    lost = torch.zeros((), dtype=torch.int32, device=p.cell.device)
    for s in range(S):
        c, f, v, a, n_lost = migrate_species(p.cell[s], p.frac[s], p.vel[s],
                                             p.alive[s], ctx, offset, K)
        cells.append(c)
        fracs.append(f)
        vels.append(v)
        alives.append(a)
        lost = lost + n_lost
    p = Particles(cell=torch.stack(cells), frac=torch.stack(fracs),
                  vel=torch.stack(vels), alive=torch.stack(alives))
    return p, ctx.psum(lost)
