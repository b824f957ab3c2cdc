"""The exchange re-bucket's entry point — the part of
``pinc_tpu/ops/pallas_exchange.py`` that the gather path needs.

``rebucket_exchange_planes`` keeps pinc_tpu's routing: with the per-row
kernels selected (``rows``) on a 3-D tile grid it takes the gather
exchange of ``ops/gather_exchange.py`` (K8-K10) whenever B % 1024 == 0, or
when ``impl="gather"`` asks for it.  Every other case reaches pinc_tpu's
one-hot exchange kernels (K11), which are not ported: it raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import gather_exchange as gx

_K11 = ("the one-hot exchange kernels (K11, pinc_tpu/ops/pallas_exchange.py), "
        "which pinc_tpu takes when B % 1024 != 0, the per-row gate fails or "
        "tiles:exchangeImpl=onehot, are not ported to pinc_tpu_torch yet "
        "(ROADMAP.md, 'Still to port'); run with the override "
        "tiles:rebucket=sort")


def default_row_cap(K: int, B: int) -> int:
    """Per-row face cap: K/4 (2x head room over the even K/8 share),
    rounded to the lane quantum."""
    q = 64 if B >= 4096 else 8
    return max(q, -(-K // 4 // q) * q)


def require_gather(B: int, ntiles: Tuple[int, ...], rows: bool,
                   impl: str = "auto") -> None:
    """Raise unless pinc_tpu's rebucket_exchange_planes would take the
    gather kernels for these arguments: NotImplementedError for its
    one-hot branches, ValueError for impl="gather" with B % 1024 != 0
    (an assertion in pinc_tpu)."""
    if impl != "onehot" and rows and len(ntiles) == 3:
        if gx.supported(B):
            return
        if impl == "gather":
            raise ValueError(f"tiles:exchangeImpl=gather needs B % 1024 == 0, "
                             f"got B = {B}")
    raise NotImplementedError(
        f"exchange re-bucket with B = {B}, rows = {rows}, impl = {impl}: "
        + _K11)


def rebucket_exchange_planes(planes, alive: torch.Tensor,
                             ntiles: Tuple[int, ...], T: int, K: int,
                             rows: bool = False, fused: bool = True,
                             impl: str = "auto", ku: int = None):
    """3-D re-bucket on component planes (x, y, z, vx, vy, vz), each
    (NT, B), with alive (NT, B) f32.  fused=True takes the single-pass
    exchange; otherwise three per-axis sweeps (corner movers ride two or
    three of them).  K is the tile-level face cap (the per-row face cap is
    derived from it); ku overrides the total cap.  Returns (planes,
    alive', n_dropped); the planes are updated in place."""
    NT, B = alive.shape
    require_gather(B, ntiles, rows, impl)
    Ks = gx.round_cap(default_row_cap(K, B))
    if fused:
        return gx.rebucket_exchange_all_rows_g(
            planes, alive, ntiles, T, Ks, KU=ku if ku else gx.total_cap(Ks, K))
    n0 = alive.to(torch.int32).sum()
    for d in range(3):
        planes, alive = gx.exchange_dim_g(planes, alive, ntiles, d, T, Ks)
    dropped = n0 - alive.to(torch.int32).sum()
    return planes, alive, dropped
