"""The device mesh (the counterpart of ``pinc_tpu/parallel/mesh.py``): the
deck's ``grid:nSubdomains`` Cartesian decomposition (the reference's
``MpiInfo``, src/core.h:112-138, and ``getSubdomain``, src/grid.c:149-176)
over a list of ``torch.device``s driven by one process.

A mesh is a numpy object array of devices shaped ``grid:nSubdomains``, with
``pinc_tpu``'s axis names and its mixed-radix order (last dimension
fastest).  A sharded field or particle state is a list of per-shard
tensors in that order, each on its shard's device.  A device may appear
more than once: ``[torch.device("cpu")] * 8`` is the counterpart of
``pinc_tpu``'s virtual host devices, and ``[cuda:0] * N`` runs every shard
of a decomposed deck on one card.

Two ways to run per-shard code:

* ``MeshCtx.map(fn, *lists)`` runs ``fn`` on each shard in turn, in this
  thread: for code that exchanges data only between calls (the pencil
  FFT; the sharded multigrid likewise steps its shards in lockstep, on
  each device's shards stacked).
* ``MeshCtx.shard_map(fn, *lists)`` is ``shard_map``: one thread a shard
  runs ``fn`` on its blocks, and the collectives inside it
  (``ppermute``, ``psum``) meet across the threads, which take turns
  (one runs at a time, up to its next collective).  The exchange drivers
  reach their neighbours through ``roll_fns`` in the middle of a
  per-shard program, so only this form can run them.

Either way a shard's work runs under ``device_scope`` of its device: its
card is the current device (a kernel launches on the current device's
stream), and the thread knows its shard (``current_shard``).  The
collectives:

* ``lax.ppermute`` -> a copy of the sent plane onto the receiving shard's
  device (``Tensor.to(dst, copy=True)``, never an alias); PyTorch's
  cross-device copies order both devices' current streams.
* ``lax.psum`` -> a sum over the shards in mesh order on the first shard's
  device.
* ``lax.all_gather`` -> ``gather``: the blocks concatenated in mesh-block
  order.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("x", "y", "z", "w", "v", "u")

_LOCAL = threading.local()
# a shard waits this long for its turn before the shard_map fails (a
# first kernel call builds the library inside one shard's turn)
_TURN_TIMEOUT_S = 3600.0
_LOCK = threading.Lock()
_POOLS: Dict[int, ThreadPoolExecutor] = {}

#: kernel launches made inside a shard's work, per shard:
#: SHARD_LAUNCHES[shard][kernel name] (``note_launch``)
SHARD_LAUNCHES: Dict[int, Counter] = defaultdict(Counter)


def current_shard() -> Optional[int]:
    """The shard whose work this thread runs (None outside a shard)."""
    return getattr(_LOCAL, "shard", None)


def note_launch(name: str) -> None:
    """Count one launch of the kernel ``name`` (its LAUNCHES key) for the
    running shard (nothing outside a shard)."""
    shard = current_shard()
    if shard is not None:
        with _LOCK:
            SHARD_LAUNCHES[shard][name] += 1


def reset_shard_launches() -> None:
    with _LOCK:
        SHARD_LAUNCHES.clear()


def device_scope(device: torch.device):
    """The context a shard's work runs in: its card made the current
    device; nothing on the CPU."""
    if device.type == "cpu":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Aborted(Exception):
    """Another shard of the same shard_map raised."""


class _Spmd:
    """The meeting point of one mesh's shard threads.  The threads take
    turns (shard 0, 1, ..., n-1, 0, ...): one runs at a time, up to its
    next collective, where it posts its value and hands the turn on, so
    the shards never contend for the interpreter lock.  When shard 0 has
    the turn again every shard has posted; round r posts to board r % 2,
    so a shard still reading round r is never overwritten."""

    def __init__(self, n: int):
        self.n = n
        self.turns = [threading.Event() for _ in range(n)]
        self.boards = ([None] * n, [None] * n)
        self.rounds = [0] * n
        self.aborted = False

    def reset(self) -> None:
        for e in self.turns:
            e.clear()
        self.turns[0].set()
        self.rounds = [0] * self.n
        self.aborted = False

    def wait_turn(self, i: int) -> None:
        if not self.turns[i].wait(_TURN_TIMEOUT_S):
            self.abort()
            raise RuntimeError(
                f"shard {i} waited {_TURN_TIMEOUT_S} s for its turn: the "
                "shards' collectives do not match")
        self.turns[i].clear()
        if self.aborted:
            raise _Aborted()

    def pass_turn(self, i: int) -> None:
        self.turns[(i + 1) % self.n].set()

    def abort(self) -> None:
        self.aborted = True
        for e in self.turns:
            e.set()

    def exchange(self, value) -> list:
        """Every shard posts ``value``; each gets all n posts."""
        if self.n == 1:
            return [value]
        i = current_shard()
        board = self.boards[self.rounds[i] % 2]
        self.rounds[i] += 1
        board[i] = value
        self.pass_turn(i)
        self.wait_turn(i)
        return list(board)


def _copy_to(x, dev: torch.device):
    if isinstance(x, (tuple, list)):
        return type(x)(_copy_to(v, dev) for v in x)
    return x.to(dev, copy=True)


@dataclass(frozen=True, eq=False)
class MeshCtx:
    """Static mesh context threaded through the sharded step."""
    mesh: np.ndarray                # object array of devices, n_subdomains
    axes: Tuple[str, ...]           # one name per spatial dim
    n_subdomains: Tuple[int, ...]   # mesh extent per spatial dim
    true_size: Tuple[int, ...]      # local grid nodes per subdomain
    _spmd: _Spmd = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_spmd", _Spmd(self.n_devices))

    @property
    def n_devices(self) -> int:
        return math.prod(self.n_subdomains)

    @property
    def global_size(self) -> Tuple[int, ...]:
        return tuple(n * t for n, t in zip(self.n_subdomains, self.true_size))

    @property
    def devices(self) -> List[torch.device]:
        """The shards' devices in mesh order."""
        return list(self.mesh.ravel())

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in order of its first shard."""
        out: List[torch.device] = []
        for dev in self.devices:
            if dev not in out:
                out.append(dev)
        return out

    def coords(self, i: Optional[int] = None) -> Tuple[int, ...]:
        """Mesh coordinates of shard i (default: the running shard)."""
        i = current_shard() if i is None else i
        return tuple(int(c) for c in np.unravel_index(i, self.n_subdomains))

    def axis_index(self, d: int, i: Optional[int] = None) -> int:
        """``lax.axis_index`` of mesh axis d for shard i (default: the
        running shard)."""
        return self.coords(i)[d]

    def neighbor(self, i: int, d: int, shift: int) -> int:
        """The shard ``shift`` steps from shard i along mesh axis d
        (cyclic)."""
        c = list(self.coords(i))
        c[d] = (c[d] + shift) % self.n_subdomains[d]
        return int(np.ravel_multi_index(c, self.n_subdomains))

    def block_slices(self, i: int) -> Tuple[slice, ...]:
        """Shard i's block of a global field."""
        return tuple(slice(c * t, (c + 1) * t)
                     for c, t in zip(self.coords(i), self.true_size))

    def scope(self, i: int):
        """Enter shard i: its device's scope, and the thread's shard."""
        return _ShardScope(i, self.devices[i])

    # ------------------------------------------------------------ running
    def map(self, fn, *lists) -> list:
        """fn on each shard's items in turn, under the shard's scope."""
        out = []
        for i in range(self.n_devices):
            with self.scope(i):
                out.append(fn(*(a[i] for a in lists)))
        return out

    def shard_map(self, fn, *lists) -> list:
        """``shard_map``: one thread a shard runs fn on its items (under its
        scope); the collectives inside fn meet across the threads.
        Returns the per-shard results in mesh order."""
        n = self.n_devices
        if current_shard() is not None:
            raise RuntimeError("shard_map inside a shard's work")
        if n == 1:
            return self.map(fn, *lists)
        spmd = self._spmd
        spmd.reset()
        n_threads = torch.get_num_threads()
        cpu = any(dev.type == "cpu" for dev in self.devices)
        fresh = []

        def run(i):
            try:
                spmd.wait_turn(i)
                if cpu and not getattr(_LOCAL, "one_thread", False):
                    # one intra-op thread a shard thread: an OpenMP team
                    # a thread would spin on the cores between the turns
                    torch.set_num_threads(1)
                    _LOCAL.one_thread = True
                    fresh.append(i)
                with self.scope(i):
                    out = fn(*(a[i] for a in lists))
            except BaseException:
                spmd.abort()
                raise
            spmd.pass_turn(i)
            return out

        with _LOCK:
            pool = _POOLS.get(n)
            if pool is None:
                pool = _POOLS[n] = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"shard{n}")
        futures = [pool.submit(run, i) for i in range(n)]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:       # noqa: BLE001 (re-raised)
                errors.append(e)
        if fresh:      # set_num_threads is process-wide for new threads
            torch.set_num_threads(n_threads)
        if errors:
            first = [e for e in errors if not isinstance(e, _Aborted)]
            raise (first or errors)[0]
        return results

    # -------------------------------------- collectives (inside shard_map)
    def ppermute(self, x, d: int, shift: int):
        """``lax.ppermute(x, axis d, _perm(n, shift))``: x (a tensor or a
        tuple of them) moves ``shift`` shards along mesh axis d; returns
        what this shard receives, copied onto its device."""
        i = current_shard()
        posts = self._spmd.exchange(x)
        src = self.neighbor(i, d, -shift)
        return _copy_to(posts[src], self.devices[i])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` over every mesh axis: the shards' values summed in
        mesh order on the first shard's device, returned on this shard's
        device."""
        posts = self._spmd.exchange(x)
        dev0 = self.devices[0]
        s = posts[0].to(dev0)
        for v in posts[1:]:
            s = s + v.to(dev0)
        own = self.devices[current_shard()]
        return s if own == dev0 else s.to(own)

    # ----------------------------------------- layout (between the maps)
    def gather(self, blocks: Sequence[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
        """The global field of per-shard blocks (each (*true_size, ...)),
        on ``device`` (default the first shard's)."""
        dev = self.devices[0] if device is None else device
        b0 = blocks[0]
        tail = tuple(b0.shape[len(self.true_size):])
        out = torch.empty(self.global_size + tail, dtype=b0.dtype,
                          device=dev)
        for i, b in enumerate(blocks):
            out[self.block_slices(i)].copy_(b)
        return out

    def split(self, g: torch.Tensor, shards=None) -> List[torch.Tensor]:
        """Per-shard blocks of a global field, each a contiguous copy on
        its shard's device (shards: the indices to cut, default all)."""
        idx = range(self.n_devices) if shards is None else shards
        return [g[self.block_slices(i)].to(self.devices[i], copy=True)
                .contiguous() for i in idx]

    def replicated(self, fn, blocks: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """fn on the gathered global field, once for each distinct device
        of the mesh; its global result cut into the shards on that
        device."""
        out: List[Optional[torch.Tensor]] = [None] * self.n_devices
        for dev in self.distinct_devices():
            mine = [i for i, d in enumerate(self.devices) if d == dev]
            with self.scope(mine[0]):
                g = fn(self.gather(blocks, dev))
                for i, b in zip(mine, self.split(g, mine)):
                    out[i] = b
        return out

    def synchronize(self) -> None:
        """Wait for every card of the mesh."""
        for dev in self.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def sum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """``psum`` of per-shard values, outside shard_map: summed in mesh
        order on the first shard's device."""
        dev0 = self.devices[0]
        s = values[0].to(dev0)
        for v in values[1:]:
            s = s + v.to(dev0)
        return s


class _ShardScope:
    def __init__(self, i: int, device: torch.device):
        self.i, self.cm = i, device_scope(device)

    def __enter__(self):
        self.prev = current_shard()
        _LOCAL.shard = self.i
        self.cm.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self.cm.__exit__(*exc)
        finally:
            _LOCAL.shard = self.prev


def make_mesh(n_subdomains: Sequence[int], true_size: Sequence[int],
              devices=None) -> MeshCtx:
    """The mesh of a deck's decomposition.  devices: a list of devices (a
    device may repeat); None means the visible cards, cuda:0..N-1.  Raises
    ValueError when there are fewer than the deck needs."""
    nsub = tuple(int(n) for n in n_subdomains)
    need = math.prod(nsub)
    if devices is None:
        devices = ([torch.device("cuda", k)
                    for k in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [_normalize(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"deck wants {need} devices "
                         f"(grid:nSubdomains={nsub}) but only "
                         f"{len(devices)} available")
    arr = np.empty(need, dtype=object)
    for k, dev in enumerate(devices[:need]):
        arr[k] = dev
    return MeshCtx(mesh=arr.reshape(nsub), axes=AXIS_NAMES[:len(nsub)],
                   n_subdomains=nsub,
                   true_size=tuple(int(t) for t in true_size))


def mesh_devices(device, n: int):
    """``make_mesh``'s devices for an entry point run on ``device``: n times
    the CPU for a CPU run, else None (the visible cards)."""
    return [torch.device("cpu")] * n if torch.device(device).type == "cpu" \
        else None


def subdomain_offset(ctx: MeshCtx, i: Optional[int] = None
                     ) -> Tuple[int, ...]:
    """Shard i's (default: the running shard's) global node offset per dim
    (mpiInfo->offset; pToGlobalFrame adds it, src/population.c:746-763)."""
    return tuple(c * t for c, t in zip(ctx.coords(i), ctx.true_size))
