"""State carried across from ``pinc_tpu``: its ``TiledState`` and
``Particles`` as numpy arrays (``np.asarray`` of each field) in, the
port's tensors out, and back — so a test or a user can start both
packages from the identical state.  The sharded states of its
``parallel/`` classes map onto the port's per-shard lists."""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .population import Particles
from .tiled_sim import TiledState


def tiled_state_from_numpy(lpos, vel, alive, device="cpu") -> TiledState:
    """lpos, vel (S, D, NT, B) and alive (S, NT, B) (f32 0/1 or bool) ->
    TiledState of contiguous float32 tensors on ``device``."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)
    return TiledState(lpos=t(lpos), vel=t(vel), alive=t(alive))


def tiled_state_to_numpy(st: TiledState) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """TiledState -> (lpos, vel, alive) float32 numpy arrays."""
    return (st.lpos.cpu().numpy(), st.vel.cpu().numpy(),
            st.alive.cpu().numpy())


def particles_from_numpy(cell, frac, vel, alive, device="cpu") -> Particles:
    """cell (S, cap, D) int32, frac and vel (S, cap, D) float, alive
    (S, cap) bool -> Particles on ``device`` (dtypes kept, cell int32)."""
    return Particles(
        cell=torch.as_tensor(np.asarray(cell, dtype=np.int32), device=device),
        frac=torch.as_tensor(np.asarray(frac), device=device),
        vel=torch.as_tensor(np.asarray(vel), device=device),
        alive=torch.as_tensor(np.asarray(alive, dtype=bool), device=device))



# ---------------------------------------------------------------------------
# pinc_tpu's sharded states (parallel/pic.py, parallel/tiled_pic.py) <->
# the port's per-shard lists, in mesh order
# ---------------------------------------------------------------------------

def sharded_particles_from_numpy(cell, frac, vel, alive, devices
                                 ) -> List[Particles]:
    """pinc_tpu's ShardedSimulation particles, global (S, n * cap_local, D)
    arrays whose capacity axis holds the n shards' slabs in mesh order ->
    one Particles a shard on its device (``devices``, mesh order)."""
    n = len(devices)
    cap = np.asarray(alive).shape[1] // n
    return [particles_from_numpy(*(np.asarray(a)[:, i * cap:(i + 1) * cap]
                                   for a in (cell, frac, vel, alive)),
                                 device=dev)
            for i, dev in enumerate(devices)]


def sharded_particles_to_numpy(parts: Sequence[Particles]):
    """The inverse: (cell, frac, vel, alive) numpy arrays with the shards'
    slabs concatenated in mesh order."""
    return tuple(np.concatenate([getattr(p, k).cpu().numpy() for p in parts],
                                axis=1)
                 for k in ("cell", "frac", "vel", "alive"))


def _tile_blocks(n_subdomains, lnt):
    for c in itertools.product(*(range(n) for n in n_subdomains)):
        yield tuple(slice(ci * ni, (ci + 1) * ni) for ci, ni in zip(c, lnt))


def sharded_tiled_state_from_numpy(lpos, vel, alive, n_subdomains,
                                   devices) -> List[TiledState]:
    """pinc_tpu's ShardedTiledSimulation state, lpos and vel (S, D, *nt, B)
    and alive (S, *nt, B) over the global tile grid nt -> one TiledState
    (S, D, NT_local, B) a shard, each shard's cuboid of tiles (mesh order,
    last dim fastest) on its device."""
    lpos, vel, alive = (np.asarray(a) for a in (lpos, vel, alive))
    S, D = lpos.shape[:2]
    B = lpos.shape[-1]
    lnt = tuple(g // n for g, n in zip(lpos.shape[2:-1], n_subdomains))
    out = []
    for blk, dev in zip(_tile_blocks(n_subdomains, lnt), devices):
        out.append(tiled_state_from_numpy(
            lpos[(slice(None),) * 2 + blk].reshape(S, D, -1, B),
            vel[(slice(None),) * 2 + blk].reshape(S, D, -1, B),
            alive[(slice(None),) + blk].reshape(S, -1, B), device=dev))
    return out


def sharded_tiled_state_to_numpy(states: Sequence[TiledState],
                                 n_subdomains, local_ntiles):
    """The inverse: (lpos, vel, alive) float32 numpy arrays over the global
    tile grid, pinc_tpu's sharded layout."""
    S, D, _, B = states[0].lpos.shape
    gnt = tuple(n * t for n, t in zip(n_subdomains, local_ntiles))
    lpos = np.empty((S, D) + gnt + (B,), np.float32)
    vel = np.empty_like(lpos)
    alive = np.empty((S,) + gnt + (B,), np.float32)
    for blk, st in zip(_tile_blocks(n_subdomains, local_ntiles), states):
        lp, v, al = tiled_state_to_numpy(st)
        lpos[(slice(None),) * 2 + blk] = lp.reshape((S, D) + local_ntiles
                                                    + (B,))
        vel[(slice(None),) * 2 + blk] = v.reshape((S, D) + local_ntiles
                                                  + (B,))
        alive[(slice(None),) + blk] = al.reshape((S,) + local_ntiles + (B,))
    return lpos, vel, alive
