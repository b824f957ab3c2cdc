"""The exchange re-bucket's entry point — the counterpart of
``pinc_tpu/ops/pallas_exchange.rebucket_exchange_planes``.

``rebucket_exchange_planes`` keeps pinc_tpu's routing: with the per-row
kernels selected (``rows``) on a 3-D tile grid it takes the gather exchange
of ``ops/gather_exchange.py`` (K8-K10) whenever B % 1024 == 0, or when
``impl="gather"`` asks for it (which needs B % 1024 == 0: ValueError, an
assertion in pinc_tpu); every other case takes the one-hot exchange of
``ops/onehot_exchange.py`` (K11): its fused all-axes pass when ``rows`` and
``fused`` hold on a 3-D grid with B % 8 == 0, else three per-axis sweeps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import gather_exchange as gx
from . import onehot_exchange as ox


def rebucket_exchange_planes(planes, alive: torch.Tensor,
                             ntiles: Tuple[int, ...], T: int, K: int,
                             roll_fns=None, ks: int = None,
                             rows: bool = False, fused: bool = True,
                             impl: str = "auto", ku: int = None):
    """3-D re-bucket on component planes (x, y, z, vx, vy, vz), each
    (NT, B), with alive (NT, B) f32.  fused=True takes the single-pass
    exchange; otherwise three per-axis sweeps (corner movers ride two or
    three of them).  K is the tile-level face cap, ks overrides the per-row
    face cap derived from it, ku the gather exchange's total cap; roll_fns
    are per-axis replacements of torch.roll over the tile grid (for a
    sharded grid).  impl: "gather", "onehot" or "auto" (gather whenever
    B % 1024 == 0).  Returns (planes, alive', n_dropped); the planes are
    updated in place."""
    NT, B = alive.shape
    if impl != "onehot" and rows and len(ntiles) == 3:
        if gx.supported(B) or impl == "gather":
            if not gx.supported(B):
                raise ValueError(f"tiles:exchangeImpl=gather needs "
                                 f"B % 1024 == 0, got B = {B}")
            Ks = gx.round_cap(ks or ox.default_row_cap(K, B))
            if fused:
                return gx.rebucket_exchange_all_rows_g(
                    planes, alive, ntiles, T, Ks, roll_fns=roll_fns,
                    KU=ku if ku else gx.total_cap(Ks, K))
            n0 = alive.to(torch.int32).sum()
            for d in range(3):
                planes, alive = gx.exchange_dim_g(
                    planes, alive, ntiles, d, T, Ks,
                    roll_fn=roll_fns[d] if roll_fns else None)
            dropped = n0 - alive.to(torch.int32).sum()
            return planes, alive, dropped
    if rows and fused and B % 8 == 0 and len(ntiles) == 3:
        Ks = ks or ox.default_row_cap(K, B)
        return ox.rebucket_exchange_all_rows(planes, alive, ntiles, T, Ks,
                                             roll_fns=roll_fns)
    n0 = alive.to(torch.int32).sum()
    for d in range(3):
        planes, alive = ox.exchange_dim(
            planes, alive, ntiles, d, T, K,
            roll_fn=roll_fns[d] if roll_fns else None, ks=ks, rows=rows)
    dropped = n0 - alive.to(torch.int32).sum()
    return planes, alive, dropped
