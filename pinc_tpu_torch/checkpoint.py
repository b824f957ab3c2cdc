"""Checkpoint / resume (the counterpart of ``pinc_tpu/checkpoint.py``, in
its file format: either package resumes the other's checkpoint).

The reference has no real restart mechanism: fields can be re-read from the
per-step grid datasets (``gReadH5``, src/grid.c:1183-1202) and the ini files
carry a ``time:startTime`` key "in case of continuing a simulation"
(test.ini:21), but nothing consumes it and there is no particle-state
restore.  Here the simulation state goes to one HDF5 file,
``<prefix><sep>checkpoint.chk.h5``, with attributes ``step`` and
``format_version`` (1), and ``layout`` = "tiled" for the tiled state; on
an object deck also the dataset ``rho_obj``, the persistent object surface
charge on the grid (restored on resume):

* flat: datasets ``cell`` (S, cap, D) int32, ``frac``, ``vel`` (S, cap, D)
  and ``alive`` (S, cap) bool;
* tiled: ``lpos``, ``vel`` (S, D, NT, B) and ``alive`` (S, NT, B) float32,
  the tile planes verbatim, slot assignment included, and what
  ``TiledSimulation.retune`` has set (attributes ``tuning:*``: the
  re-bucket cadences, the exchange face cap, its escalation and the
  per-row gate), so that a resumed run is bit for bit the uninterrupted
  one, a retune before the checkpoint included.  pinc_tpu writes no
  ``tuning:*`` and reads none: it resumes on its deck's cadences, and so
  does the port from a checkpoint without them.

Enabled by deck keys:

* ``files:checkpointEvery = N`` — write every N steps (0 = off); the final
  state is always written when enabled.
* ``time:resume = true`` or ``time:startTime`` > 0 — restore from the
  checkpoint file and continue the step numbering.

h5py is needed (and not installed by the port).  Tensors are fetched to
the host to be written and put on the simulation's device when read.

Over several processes (``utils/multihost.py``, as
``pinc_tpu/checkpoint.py:45-58,112-120``): the state comes gathered from
every process, process 0 alone writes the one file, and every process
returns its path once it is written (a shared file system, as MPI-IO
assumes).  A resume reads the file on every process, and each keeps its
own shards.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .config import PincConfig
from .io_h5 import fetch_global, h5_path
from .population import Particles
from .utils import multihost as mh
from .utils.logging import STATUS, msg

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

FORMAT_VERSION = 1


def _h5():
    if h5py is None:
        raise RuntimeError("h5py is required for checkpoints")
    return h5py


def checkpoint_path(cfg: PincConfig) -> Path:
    return h5_path(cfg, "checkpoint", "chk")


def _write(path: Path, step: int, datasets: dict, layout=None,
           attrs: Optional[dict] = None) -> bool:
    """The file, on the primary only (every process fetched the datasets,
    the collective part); every process waits until it is written.
    Returns True where this process wrote it."""
    _h5()                              # every process raises without h5py
    if not mh.is_primary():
        mh.barrier()
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    with _h5().File(path, "w") as f:
        f.attrs["step"] = int(step)
        f.attrs["format_version"] = FORMAT_VERSION
        if layout is not None:
            f.attrs["layout"] = layout
        for name, value in (attrs or {}).items():
            f.attrs[name] = value
        for name, data in datasets.items():
            f.create_dataset(name, data=data)
    mh.barrier()
    return True


def _open_layout(cfg: PincConfig, layout: str):
    """The checkpoint file, opened for reading; raises unless it exists
    and holds the given layout."""
    path = checkpoint_path(cfg)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    f = _h5().File(path, "r")
    found = str(f.attrs.get("layout", "flat"))
    if found != layout:
        f.close()
        raise ValueError(
            f"{path} is a {found!r}-layout checkpoint; resume it with the "
            f"matching methods:layout")
    return path, f


def _with_rho_obj(datasets: dict, rho_obj) -> dict:
    if rho_obj is not None:
        datasets["rho_obj"] = fetch_global(rho_obj)
    return datasets


def _read_rho_obj(f, device) -> Optional[torch.Tensor]:
    if "rho_obj" not in f:
        return None
    return torch.as_tensor(np.asarray(f["rho_obj"]), device=device)


def save(cfg: PincConfig, step: int, particles: Particles,
         rho_obj=None) -> Path:
    path = checkpoint_path(cfg)
    if _write(path, step, _with_rho_obj(
            {k: fetch_global(getattr(particles, k))
             for k in ("cell", "frac", "vel", "alive")}, rho_obj)):
        msg(STATUS, "checkpoint written: %s (step %d)", path, step)
    return path


def load(cfg: PincConfig, device="cpu"
         ) -> Tuple[int, Particles, Optional[torch.Tensor]]:
    """-> (step, particles, rho_obj or None) on ``device``."""
    path, f = _open_layout(cfg, "flat")
    with f:
        step = int(f.attrs["step"])
        particles = Particles(**{
            k: torch.as_tensor(np.asarray(f[k]), device=device)
            for k in ("cell", "frac", "vel", "alive")})
        rho_obj = _read_rho_obj(f, device)
    msg(STATUS, "checkpoint restored: %s (step %d)", path, step)
    return step, particles, rho_obj


def peek_layout(cfg: PincConfig) -> Optional[str]:
    """Layout tag of the on-disk checkpoint ('flat'/'tiled'), or None if
    no checkpoint exists."""
    path = checkpoint_path(cfg)
    if not path.exists():
        return None
    with _h5().File(path, "r") as f:
        return str(f.attrs.get("layout", "flat"))


def save_tiled(cfg: PincConfig, step: int, state,
               tuning: Optional[dict] = None, rho_obj=None) -> Path:
    """Tiled-layout checkpoint: the (S, D, NT, B) component planes are
    stored verbatim (slot assignment included), so a resumed run replays
    the original bit for bit — converting through the flat Particles
    layout would re-bucket on restore and reorder the per-tile sums.
    tuning: ``TiledSimulation.tuning()``, stored as ``tuning:<key>``."""
    path = checkpoint_path(cfg)
    if _write(path, step, _with_rho_obj({k: fetch_global(getattr(state, k))
                                         for k in ("lpos", "vel", "alive")},
                                        rho_obj),
              layout="tiled",
              attrs={f"tuning:{k}": v for k, v in (tuning or {}).items()}):
        msg(STATUS, "checkpoint written: %s (step %d, tiled)", path, step)
    return path


def load_tiled(cfg: PincConfig, expect_shape=None, device="cpu"):
    """-> (step, TiledState with (S, D, NT, B) axes on ``device``, the
    saved tuning: a dict, empty where the file holds none, rho_obj or
    None)."""
    from .tiled_sim import TiledState

    path, f = _open_layout(cfg, "tiled")
    with f:
        step = int(f.attrs["step"])
        lpos = np.asarray(f["lpos"])
        if expect_shape is not None and lpos.shape != tuple(expect_shape):
            raise ValueError(
                f"checkpoint state shape {lpos.shape} != deck-derived "
                f"{tuple(expect_shape)} — the [tiles] section (tileSize/"
                "margin/slack) or the population capacity changed since "
                "the checkpoint was written")

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                   device=device)
        state = TiledState(lpos=t(lpos), vel=t(np.asarray(f["vel"])),
                           alive=t(np.asarray(f["alive"])))
        tuning = {k[len("tuning:"):]: v for k, v in f.attrs.items()
                  if k.startswith("tuning:")}
        rho_obj = _read_rho_obj(f, device)
    msg(STATUS, "checkpoint restored: %s (step %d, tiled)", path, step)
    return step, state, tuning, rho_obj
