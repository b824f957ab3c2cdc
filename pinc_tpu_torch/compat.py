"""State carried across from ``pinc_tpu``: its ``TiledState`` and
``Particles`` as numpy arrays (``np.asarray`` of each field) in, the
port's tensors out, and back — so a test or a user can start both
packages from the identical state."""

from __future__ import annotations

from typing import Tuple

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

