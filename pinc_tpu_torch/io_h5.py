"""HDF5 output with the reference's file conventions (the counterpart of
``pinc_tpu/io_h5.py``: the same files, dataset names, shapes and
attributes, so the reference's and ``script/plot/``'s readers take either
package's output).

* File naming ``<prefix><sep><name>.<kind>.h5`` where sep is '/' if the
  prefix is '.', '_' if the prefix does not end in '/'
  (``openH5File``, src/io.c:566-604).
* Grid files (``gOpenH5``/``gWriteH5``, src/grid.c:1161-1270): one dataset
  ``/n=<t>.1f`` per step, dims *reversed* relative to (x,y,...) ordering
  with a trailing values dimension, plus the "Axis/Quantity denormalization
  factor" attributes.
* Population files (``pOpenH5``/``pWriteH5``, src/population.c:497-651):
  ``/pos/specie i/n=<t>.1f`` and ``/vel/specie i/n=<t-0.5>.1f`` datasets of
  shape (nParticles, nDims), global frame.
* Time-series ``.xy.h5`` files (``xyCreateDataset``/``xyWrite``,
  src/io.c:666-736): unlimited (T,2) float64 datasets of (x, y) rows; the
  canonical one is ``history.xy.h5:/energy/...``
  (``pCreateEnergyDatasets``, src/population.c:658-698).

Writes happen on the host after fetching the step's tensors
(``tensor.detach().cpu().numpy()``), on the cadence ``files:writeFrequency``
(default 1, the reference's every step).  Over several processes the
discipline of ``pinc_tpu`` (``utils/multihost.py``): process 0 alone opens
and writes the grid files and history.xy.h5 (the fields gathered from
every process), and each process writes the particles of its own shards
to ``<prefix>_pop.p<idx>.pop.h5`` (``_owned_rows``); with one process the
file names are the reference's.  h5py is needed and is not installed by
the port: without it the writer raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .config import PincConfig
from .utils import multihost as mh

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def h5_path(cfg: PincConfig, name: str, kind: str) -> Path:
    prefix = cfg.get_str("files:output", "")
    sep = ""
    if prefix == ".":
        sep = "/"
    elif prefix and not prefix.endswith("/"):
        sep = "_"
    return Path(f"{prefix}{sep}{name}.{kind}.h5")


def _open(path: Path) -> "h5py.File":
    if h5py is None:
        raise RuntimeError("h5py is required for HDF5 output")
    path.parent.mkdir(parents=True, exist_ok=True)
    return h5py.File(path, "a")


#: a tensor or array on the host; a process-sharded list gathered from
#: every process
fetch_global = mh.fetch_global


def _grid_to_file_layout(arr: np.ndarray, n_dims: int) -> np.ndarray:
    """(x, y, ..., [C]) -> reversed spatial dims + trailing values dim
    (the 'HDF5 indices needs to be reversed' convention, grid.c:1243-1248)."""
    if arr.ndim == n_dims:           # scalar: add nValues=1 axis
        arr = arr[..., None]
    perm = tuple(range(n_dims - 1, -1, -1)) + (n_dims,)
    return np.ascontiguousarray(np.transpose(arr, perm).astype(np.float64))


class GridFile:
    def __init__(self, cfg: PincConfig, name: str, n_dims: int,
                 axis_denorm: float = 1.0, denorm: float = 1.0):
        self.n_dims = n_dims
        self.f = _open(h5_path(cfg, name, "grid"))
        self.f.attrs["Axis denormalization factor"] = np.float64(axis_denorm)
        self.f.attrs["Quantity denormalization factor"] = np.float64(denorm)

    def write(self, n: float, arr: np.ndarray) -> None:
        ds = f"n={float(n):.1f}"
        if ds in self.f:
            del self.f[ds]
        self.f.create_dataset(ds, data=_grid_to_file_layout(arr, self.n_dims))

    def read(self, n: float) -> np.ndarray:
        """Inverse of write: file layout -> (x, y, ..., C) (gReadH5)."""
        data = np.asarray(self.f[f"n={float(n):.1f}"])
        nd = self.n_dims
        perm = tuple(range(nd - 1, -1, -1)) + (nd,)
        out = np.transpose(data, perm)
        return out[..., 0] if out.shape[-1] == 1 else out

    def close(self):
        self.f.close()


class PopFile:
    def __init__(self, cfg: PincConfig, name: str, n_species: int,
                 pos_denorm: float = 1.0, vel_denorm: float = 1.0):
        self.f = _open(h5_path(cfg, name, "pop"))
        self.f.attrs["Position denormalization factor"] = np.float64(pos_denorm)
        self.f.attrs["Velocity denormalization factor"] = np.float64(vel_denorm)
        for s in range(n_species):
            self.f.require_group(f"pos/specie {s}")
            self.f.require_group(f"vel/specie {s}")

    def write(self, pos_n: float, vel_n: float, pos: np.ndarray,
              vel: np.ndarray, alive: np.ndarray) -> None:
        """pos/vel: (S, cap, D); only alive rows are stored (the reference
        stores exactly iStop-iStart rows per species)."""
        S = pos.shape[0]
        for s in range(S):
            m = alive[s]
            for grp, n, data in (("pos", pos_n, pos[s][m]),
                                 ("vel", vel_n, vel[s][m])):
                ds = f"{grp}/specie {s}/n={float(n):.1f}"
                if ds in self.f:
                    del self.f[ds]
                self.f.create_dataset(ds, data=data.astype(np.float64))

    def close(self):
        self.f.close()


class XYFile:
    """Extendable (x,y) time-series file (.xy.h5)."""

    def __init__(self, cfg: PincConfig, name: str):
        self.f = _open(h5_path(cfg, name, "xy"))

    def create(self, name: str) -> None:
        if name not in self.f:
            self.f.create_dataset(name, shape=(0, 2), maxshape=(None, 2),
                                  chunks=(1, 2), dtype=np.float64)

    def append(self, name: str, x: float, y: float) -> None:
        ds = self.f[name]
        n = ds.shape[0]
        ds.resize((n + 1, 2))
        ds[n] = (x, y)

    def close(self):
        self.f.close()


class OutputWriter:
    """Facade used by Simulation.run: owns the rho/phi/E grid files, the pop
    file and history.xy.h5 (the file set opened at src/main.c:121-131).
    Deck keys: files:writeFields, files:writePop (default true),
    files:writeFrequency (default 1) and files:async (default false: the
    native spooler, converted to the .h5 layout at close; synchronous
    writes with a WARNING where it cannot be built).  Over several
    processes the grids and the history are the primary's, and each
    process writes its own population file, pop.p<idx> (its spool
    likewise: the fields in the primary's, its particles in each
    process's own)."""

    def __init__(self, cfg: PincConfig, sim) -> None:
        self.cfg = cfg
        self.n_dims = sim.spec.n_dims
        self.every = cfg.get_int("files:writefrequency", 1)
        self.write_fields = cfg.get_bool("files:writefields", True)
        self.write_pop = cfg.get_bool("files:writepop", True)
        # the multi-process discipline (pinc_tpu/io_h5.py:149-246)
        self.primary = mh.is_primary()
        self.pidx = mh.process_index()
        self.nproc = mh.process_count()
        u = sim.units
        self.units = u
        ns = sim.params.charge.shape[0]
        self.n_species = ns
        # history first: without h5py the writer raises before it starts
        # the spooler's thread (a secondary, which opens none, checks)
        self.history = XYFile(cfg, "history") if self.primary else None
        if self.history is None and h5py is None:
            raise RuntimeError("h5py is required for HDF5 output")
        if self.history is not None:
            for kind in ("potential", "kinetic"):
                self.history.create(f"/energy/{kind}/total")
                for s in range(ns):
                    self.history.create(f"/energy/{kind}/specie {s}")
        # per-process population file; the single-process name is the
        # reference's
        self.pop_name = "pop" if self.nproc == 1 else f"pop.p{self.pidx}"

        # async mode: snapshots go to the native background spooler and are
        # converted to the standard .h5 layout at close (files:async=true)
        self.spool = None
        if cfg.get_bool("files:async", False):
            try:
                from .spool import SpoolWriter
                p = h5_path(cfg, "snapshots" if self.nproc == 1
                            else f"snapshots.p{self.pidx}", "spool")
                self.spool_path = p.with_name(p.name.replace(".spool.h5",
                                                             ".spool"))
                self.spool = SpoolWriter(self.spool_path)
            except (RuntimeError, OSError) as e:  # no compiler or no file:
                # fall back to synchronous writes
                from .utils.logging import WARNING, msg
                msg(WARNING, "files:async requested but native spooler "
                    "unavailable (%s); writing synchronously", e)

        self.grids = {}
        if self.write_fields and self.spool is None and self.primary:
            for name in ("rho", "phi", "E"):
                self.grids[name] = GridFile(cfg, name, self.n_dims,
                                            axis_denorm=u.length, denorm=1.0)
        self.pop: Optional[PopFile] = None
        if self.write_pop and self.spool is None:
            self.pop = PopFile(cfg, self.pop_name, ns, pos_denorm=u.length,
                               vel_denorm=u.velocity)

    def writes(self, n: int) -> bool:
        """Whether write_step(n, ...) writes anything: the run builds a
        step's output only then."""
        return (self.write_fields or self.write_pop) and (
            not self.every or n % self.every == 0)

    def _owned_rows(self, arr, axis: int = 1) -> np.ndarray:
        """This process's rows of the population along ``axis``: the whole
        array (one process, or a replicated one), or the concatenated
        shards this process holds of a process-sharded list
        (``multihost.fetch_local``)."""
        return mh.fetch_local(arr, axis)

    def _population(self, p):
        """(pos, vel, alive) of the rows this process writes: p is
        Particles, or over several processes the shards' list of them."""
        if isinstance(p, list):
            return tuple(self._owned_rows([None if q is None else f(q)
                                           for q in p])
                         for f in (lambda q: q.pos(), lambda q: q.vel,
                                   lambda q: q.alive))
        return tuple(self._owned_rows(x) for x in (p.pos(), p.vel, p.alive))

    def write_step(self, n: int, out) -> None:
        """out: the step's StepOutput (particles None unless the writer
        writes the population; the fields global, gathered on every
        process)."""
        if self.every and n % self.every != 0:
            return
        if self.spool is not None:
            if self.write_fields and self.primary:
                self.spool.write("rho", n, fetch_global(out.rho))
                self.spool.write("phi", n, fetch_global(out.phi))
                self.spool.write("E", n, fetch_global(out.E))
            if self.write_pop:
                pos, vel, alive = self._population(out.particles)
                for s in range(pos.shape[0]):
                    m = alive[s]
                    self.spool.write(f"pop/pos/{s}", n, pos[s][m])
                    self.spool.write(f"pop/vel/{s}", n - 0.5, vel[s][m])
            return
        if self.write_fields and self.primary:
            self.grids["rho"].write(n, fetch_global(out.rho))
            self.grids["phi"].write(n, fetch_global(out.phi))
            self.grids["E"].write(n, fetch_global(out.E))
        if self.pop is not None:
            self.pop.write(n, n - 0.5, *self._population(out.particles))

    def write_energy(self, n: int, ke: np.ndarray, pe: float) -> None:
        if self.history is None:
            return
        self.history.append("/energy/kinetic/total", n, float(ke.sum()))
        self.history.append("/energy/potential/total", n, float(pe))
        for s in range(self.n_species):
            self.history.append(f"/energy/kinetic/specie {s}", n, float(ke[s]))
            # per-species PE mirrors the reference: gPotEnergy fills only the
            # total slot (src/grid.c:1276-1293), species entries stay 0.
            self.history.append(f"/energy/potential/specie {s}", n, 0.0)

    def close(self):
        for g in self.grids.values():
            g.close()
        if self.pop is not None:
            self.pop.close()
        if self.history is not None:
            self.history.close()
        if self.spool is not None:
            from .spool import convert
            from .utils.logging import STATUS, msg
            n = self.spool.close()
            msg(STATUS, "spool closed (%d records); converting to .h5", n)
            convert(self.spool_path, self.cfg, self.n_dims, self.units,
                    pop_name=self.pop_name)
