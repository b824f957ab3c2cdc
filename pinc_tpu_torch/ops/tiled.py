"""Tiled (bucketed) particle layout, the counterpart of
``pinc_tpu/ops/tiled.py``.

* The grid is split into tiles of ``T^D`` cells; particles live in
  fixed-capacity per-tile buckets of ``B`` slots, positions stored
  tile-local.
* Each tile deposits onto a padded node block of ``P = T + 1 + 2M`` nodes
  per dim (the margin M lets particles wander M cells past their tile
  between re-buckets); the blocks fold into the global grid with
  roll/concat overlap-adds, and the field is cut back into padded blocks
  for the gather.
* Bucketing is a stable sort by tile id plus index gathers, with the same
  fixed within-tile slot permutation as ``pinc_tpu``, so both packages
  place every particle in the same slot.

``deposit_tiled`` and ``gather_tiled`` are the plain references of the
layout; the step itself runs the kernels of ``ops/tiled_kernels.py``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TileSpec:
    grid: Tuple[int, ...]       # global nodes per dim
    T: int                      # tile edge (cells)
    M: int                      # wander margin (cells)
    B: int                      # bucket capacity (slots per tile)

    @property
    def n_dims(self) -> int:
        return len(self.grid)

    @property
    def ntiles(self) -> Tuple[int, ...]:
        return tuple(g // self.T for g in self.grid)

    @property
    def NT(self) -> int:
        return math.prod(self.ntiles)

    @property
    def P(self) -> int:
        return self.T + 1 + 2 * self.M

    def validate(self):
        for g in self.grid:
            if g % self.T != 0:
                raise ValueError(f"grid extent {g} not divisible by tile {self.T}")


def tile_origins(ts: TileSpec, device="cpu") -> torch.Tensor:
    """(NT, D) global node coordinate of each tile's origin, float32."""
    axes = [np.arange(n) * ts.T for n in ts.ntiles]
    mesh = np.meshgrid(*axes, indexing="ij")
    org = np.stack([m.ravel() for m in mesh], axis=-1).astype(np.float32)
    return torch.from_numpy(org).to(device)


# ---------------------------------------------------------------------------
# Bucketing: global positions -> per-tile slots (stable sort + gathers)
# ---------------------------------------------------------------------------

_SLOT_ORDER_CACHE: dict = {}


def _slot_order(B: int) -> np.ndarray:
    """Within-tile slot assignment order: the fixed pseudo-random
    permutation of ``pinc_tpu.ops.tiled._slot_order`` when B % 8 == 0 (so
    free slots spread evenly over the slab), else the identity.  Copied
    exactly so that both packages fill the same slots."""
    if B % 8:
        return np.arange(B)
    order = _SLOT_ORDER_CACHE.get(B)
    if order is None:
        order = np.random.default_rng(0x5107 ^ B).permutation(B)
        _SLOT_ORDER_CACHE[B] = order
    return order


def _tile_ids(pos: torch.Tensor, alive: torch.Tensor,
              ts: TileSpec) -> torch.Tensor:
    """(N,) int64 tile id of each position; dead slots get NT (sort last)."""
    nt = torch.tensor(ts.ntiles, dtype=torch.int64, device=pos.device)
    tcoord = torch.floor(pos / ts.T).to(torch.int64)
    tcoord = torch.clamp(tcoord, torch.zeros_like(nt), nt - 1)
    tid = tcoord[:, 0]
    for d in range(1, ts.n_dims):
        tid = tid * ts.ntiles[d] + tcoord[:, d]
    return torch.where(alive, tid, torch.full_like(tid, ts.NT))


def _slot_map(tid_s: torch.Tensor, ts: TileSpec):
    """sorted tile ids -> (src (NT,B) sorted index per slot, valid mask,
    dropped count)."""
    dev = tid_s.device
    bounds = torch.searchsorted(
        tid_s, torch.arange(ts.NT + 1, dtype=tid_s.dtype, device=dev))
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    order = torch.from_numpy(_slot_order(ts.B)).to(dev)
    src = starts[:, None] + order[None, :]                     # (NT, B)
    valid = order[None, :] < counts[:, None]
    dropped = torch.clamp(counts - ts.B, min=0).sum()
    return src.clamp_(0, tid_s.shape[0] - 1), valid, dropped


def bucket(pos: torch.Tensor, vel: torch.Tensor, alive: torch.Tensor,
           ts: TileSpec):
    """pos (N, D) float global, vel (N, D), alive (N,) bool.
    Returns (lpos (NT,B,D), vel (NT,B,D), alive (NT,B) bool, n_dropped)."""
    lpos, valid, tid, dropped = bucket_positions(pos, alive, ts)
    return lpos, bucket_payload(tid, vel, ts), valid, dropped


def bucket_positions(pos: torch.Tensor, alive: torch.Tensor, ts: TileSpec):
    """Phase A of two-phase bucketing: positions only.
    Returns (lpos (NT,B,D), valid (NT,B), tid (N,) UNSORTED, dropped) —
    phase B re-sorts any payload with the same (stable) tid key and
    lands on the identical permutation."""
    tid = _tile_ids(pos, alive, ts)
    tid_s, perm = torch.sort(tid, stable=True)
    src, valid, dropped = _slot_map(tid_s, ts)
    org = tile_origins(ts, pos.device).to(pos.dtype)
    lpos = pos[perm[src]] - org[:, None, :]
    del perm, src
    lpos = torch.where(valid[..., None], lpos,
                       torch.full((), -2.0 * ts.M - 2.0, dtype=pos.dtype,
                                  device=pos.device))
    return lpos.float(), valid, tid, dropped


def bucket_payload(tid: torch.Tensor, payload: torch.Tensor, ts: TileSpec):
    """Phase B: route any (N, D) payload through the same stable-sort
    permutation as bucket_positions (identical tid key)."""
    tid_s, perm = torch.sort(tid, stable=True)
    src, valid, _ = _slot_map(tid_s, ts)
    out = payload[perm[src]]
    out = torch.where(valid[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.float()


def global_positions(lpos: torch.Tensor, ts: TileSpec) -> torch.Tensor:
    """(NT, B, D) local -> global float positions (periodic wrap)."""
    g = lpos + tile_origins(ts, lpos.device)[:, None, :]
    return torch.remainder(g, torch.tensor(ts.grid, dtype=g.dtype,
                                           device=g.device))


# ---------------------------------------------------------------------------
# Fold: padded tile blocks -> global grid (periodic overlap-add)
# ---------------------------------------------------------------------------

def _fold_axis(x: torch.Tensor, tile_ax: int, node_ax: int,
               ts: TileSpec) -> torch.Tensor:
    """Overlap-add one dimension: node range [-M, T+M] -> [0, T) with the
    M low planes rolled to the previous tile and the M+1 high planes rolled
    to the next (periodic tile wrap)."""
    M, T = ts.M, ts.T

    def zeros(n):
        shape = list(x.shape)
        shape[node_ax] = n
        return x.new_zeros(shape)

    out = x.narrow(node_ax, M, T)                      # offsets 0..T-1
    if M > 0:
        # low planes (offsets -M..-1) land at the previous tile's T-M..T-1
        low = torch.roll(x.narrow(node_ax, 0, M), -1, dims=tile_ax)
        out = out + torch.cat([zeros(T - M), low], dim=node_ax)
    # high planes (offsets T..T+M) land at the next tile's 0..M
    high = torch.roll(x.narrow(node_ax, T + M, M + 1), 1, dims=tile_ax)
    return out + torch.cat([high, zeros(T - M - 1)], dim=node_ax)


def fold_to_global(tiles: torch.Tensor, ts: TileSpec) -> torch.Tensor:
    """(NT, P..P) padded tile blocks -> (X, Y, ...) global grid."""
    D = ts.n_dims
    x = tiles.reshape(ts.ntiles + (ts.P,) * D)
    for d in range(D):
        x = _fold_axis(x, tile_ax=d, node_ax=D + d, ts=ts)
    # interleave (n0, n1, .., T, T, ..) -> (n0, T, n1, T, ...)
    perm = []
    for d in range(D):
        perm += [d, D + d]
    return x.permute(perm).reshape(ts.grid)


def pad_tiles(field: torch.Tensor, ts: TileSpec) -> torch.Tensor:
    """Global (grid..., C) or (grid...) -> (NT, P.., [C]) padded blocks
    (periodic).  Sequential per dim so corners are correct."""
    D = ts.n_dims
    nt = ts.ntiles
    vec = field.ndim == D + 1
    C = field.shape[-1] if vec else None
    shape = []
    for d in range(D):
        shape += [nt[d], ts.T]
    if vec:
        shape.append(C)
    x = field.reshape(shape)
    # bring tile axes first: (n0, n1, .., T0, T1, .. [,C])
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    if vec:
        perm.append(2 * D)
    x = x.permute(perm)
    for d in range(D):
        node_ax = D + d
        n = x.shape[node_ax]
        lo = torch.roll(x.narrow(node_ax, n - ts.M, ts.M), 1, dims=d)
        hi = torch.roll(x.narrow(node_ax, 0, ts.M + 1), -1, dims=d)
        x = torch.cat([lo, x, hi], dim=node_ax)
    return x.reshape((ts.NT,) + (ts.P,) * D + ((C,) if vec else ()))


# ---------------------------------------------------------------------------
# Plain tiled deposit / gather (any D): the layout's own references
# ---------------------------------------------------------------------------

def _hat_weights(x: torch.Tensor, ts: TileSpec, order: int = 1) -> torch.Tensor:
    """x (...) local coords -> (..., P) weights over padded nodes
    [-M .. T+M]: CIC hat weights (order 1) or the NGP round-half-up
    indicator (order 0).  Out-of-support positions get weight 0."""
    a = torch.arange(-ts.M, ts.T + ts.M + 1, dtype=x.dtype, device=x.device)
    d = x[..., None] - a
    if order == 0:
        return ((d >= -0.5) & (d < 0.5)).to(x.dtype)
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _deposit_tiles(lpos: torch.Tensor, value: torch.Tensor, ts: TileSpec,
                   order: int = 1, chunk: int = 32) -> torch.Tensor:
    """lpos (NT, B, D), value (NT, B) -> padded tile densities
    (NT, P, ..., P) by the separable weight contraction, ``chunk`` tiles
    at a time (bounds the dense weight intermediates)."""
    D, P = ts.n_dims, ts.P
    out = []
    for t0 in range(0, ts.NT, chunk):
        lp = lpos[t0:t0 + chunk]
        ws = [_hat_weights(lp[..., d], ts, order) for d in range(D)]
        ws[0] = ws[0] * value[t0:t0 + chunk, :, None]
        if D == 1:
            o = ws[0].sum(dim=1)
        elif D == 2:
            o = torch.einsum("cbx,cby->cxy", ws[0], ws[1])
        else:
            wyz = torch.einsum("cby,cbz->cbyz", ws[1], ws[2]).reshape(
                lp.shape[0], lp.shape[1], P * P)
            o = torch.einsum("cbx,cbk->cxk", ws[0], wyz)
        out.append(o.reshape((lp.shape[0],) + (P,) * D))
    return torch.cat(out)


def deposit_tiled(lpos: torch.Tensor, alive: torch.Tensor, charge,
                  ts: TileSpec, order: int = 1,
                  chunk: int = 32) -> torch.Tensor:
    """Full tiled CIC/NGP deposition for one species: (NT,B,D) local
    positions -> (grid) charge density."""
    value = torch.where(alive, torch.tensor(float(charge), device=lpos.device),
                        torch.zeros((), device=lpos.device))
    return fold_to_global(_deposit_tiles(lpos, value, ts, order, chunk), ts)


def gather_tiled(field_pad: torch.Tensor, lpos: torch.Tensor,
                 ts: TileSpec, order: int = 1) -> torch.Tensor:
    """field_pad (NT, P.., C); lpos (NT, B, D) -> (NT, B, C).
    2^D-corner CIC gather with tile-local indices (idx = floor(lpos) + M,
    clipped to [0, P-2]); order=0 reads the nearest node instead
    (puInterpND0, src/pusher.c:1164-1178)."""
    D = ts.n_dims
    rows = torch.arange(ts.NT, device=lpos.device)[:, None]
    if order == 0:
        near = (torch.floor(lpos + 0.5).long() + ts.M).clamp(0, ts.P - 1)
        return field_pad[(rows,) + tuple(near[..., d] for d in range(D))]
    base = (torch.floor(lpos).long() + ts.M).clamp(0, ts.P - 2)
    frac = lpos - torch.floor(lpos)
    out = None
    for offs in itertools.product((0, 1), repeat=D):
        idx = tuple(base[..., d] + offs[d] for d in range(D))
        w = None
        for d, o in enumerate(offs):
            wd = frac[..., d] if o else 1.0 - frac[..., d]
            w = wd if w is None else w * wd
        contrib = w[..., None] * field_pad[(rows,) + idx]
        out = contrib if out is None else out + contrib
    return out
