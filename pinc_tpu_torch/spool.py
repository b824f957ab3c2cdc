"""Python side of the native async snapshot spooler (``native/spool.cpp``):
writer wrapper, spool reader, and spool -> PINC .h5 converter (the
counterpart of ``pinc_tpu/spool.py``; the record format is the same, so
either package reads the other's spools).

Enable with ``files:async = true``: per-step field/particle snapshots are
handed to the background C++ writer thread instead of being written to HDF5
synchronously; ``convert()`` (run automatically at close) produces the
standard layout afterwards.  Arrays are numpy arrays on the host: the
writer (``io_h5.OutputWriter``) fetches tensors first.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from . import native

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.uint8}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                np.dtype(np.int32): 2, np.dtype(np.uint8): 3,
                np.dtype(np.bool_): 3}
_MAGIC = 0x50494E43            # "PINC"


class SpoolWriter:
    def __init__(self, path: str | Path):
        L = native.lib()
        if L is None:
            raise RuntimeError("native library unavailable")
        self._L = L
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._h = L.pinc_spool_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open spool {path}")

    def write(self, name: str, step: float, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODES[arr.dtype]
        if arr.dtype == np.bool_:
            arr = arr.astype(np.uint8)
        dims = (ctypes.c_uint64 * arr.ndim)(*arr.shape)
        self._L.pinc_spool_write(
            self._h, name.encode(), float(step), code, arr.ndim, dims,
            arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)

    def pending(self) -> int:
        return int(self._L.pinc_spool_pending(self._h))

    def close(self) -> int:
        if self._h:
            n = int(self._L.pinc_spool_close(self._h))
            self._h = None
            return n
        return 0


def read_spool(path: str | Path) -> Iterator[Tuple[str, float, np.ndarray]]:
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            magic, nlen = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise ValueError(f"bad spool record magic {magic:#x}")
            name = f.read(nlen).decode()
            step, dtype, ndim = struct.unpack("<dII", f.read(16))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            dt = np.dtype(_DTYPES[dtype])
            count = int(np.prod(dims)) if ndim else 1
            data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
            yield name, step, data.reshape(dims)


def convert(spool_path: str | Path, cfg, n_dims: int,
            units=None, pop_name: str = "pop") -> Dict[str, int]:
    """Convert a spool file into the standard PINC .h5 layout
    (grid files per field + pop file; pop_name: the population file's
    name, pop.p<idx> for one process of several)."""
    from .io_h5 import GridFile, PopFile

    grids: Dict[str, GridFile] = {}
    pop: Optional[PopFile] = None
    counts: Dict[str, int] = {}
    length = getattr(units, "length", 1.0) if units else 1.0
    velocity = getattr(units, "velocity", 1.0) if units else 1.0
    for name, step, arr in read_spool(spool_path):
        counts[name] = counts.get(name, 0) + 1
        if name.startswith("pop/"):
            # records: pop/pos/<s> and pop/vel/<s>, alive mask pre-applied
            _, kind, s = name.split("/")
            if pop is None:
                ns = int(cfg.get_int("population:nspecies"))
                pop = PopFile(cfg, pop_name, ns, pos_denorm=length,
                              vel_denorm=velocity)
            ds = f"{kind}/specie {s}/n={float(step):.1f}"
            if ds in pop.f:
                del pop.f[ds]
            pop.f.create_dataset(ds, data=arr.astype(np.float64))
        else:
            if name not in grids:
                grids[name] = GridFile(cfg, name, n_dims,
                                       axis_denorm=length, denorm=1.0)
            grids[name].write(step, arr)
    for g in grids.values():
        g.close()
    if pop is not None:
        pop.close()
    return counts
