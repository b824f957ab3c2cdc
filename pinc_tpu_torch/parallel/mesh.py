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

Over several processes (``utils/multihost.py``; torchrun), each process
holds a contiguous block of ``n_shards / P`` shards in mixed-radix order,
as JAX orders a mesh's devices by process, on its own device
(``multihost.local_device``).  A sharded list then holds this process's
shards and None where another process holds one; the mesh lists another
process's shard on this process's first device, where its data lands when
it arrives.  Local shards keep the turn-taking threads, and
``_Spmd.exchange`` stays the one point where shards meet: the local posts,
then, in the thread that holds the last local turn (so one thread at a
time talks to the process group), one exchange across processes of the
posts a remote shard needs: point to point (``multihost.exchange``) for
``ppermute``, an all-gather (``multihost.all_gather``) for ``psum``.
``psum``, ``sum``, ``gather`` and ``replicated`` gather the values and
work on them in mesh order, so a run over P processes is the
single-process mesh bit for bit.
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

from ..utils import multihost as mh

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
    """The meeting point of one mesh's local shard threads.  The threads
    take turns (local shard 0, 1, ..., m-1, 0, ...): one runs at a time, up
    to its next collective, where it posts its value and hands the turn
    on, so the shards never contend for the interpreter lock.  When the
    first local shard has the turn again every local shard has posted;
    round r posts to board r % 2, so a shard still reading round r is
    never overwritten.  Over several processes the last local shard,
    holding the turn, fetches the remote posts into the board
    (``cross``)."""

    def __init__(self, shards: Sequence[int], n_all: int):
        self.n = len(shards)
        self.pos = {i: k for k, i in enumerate(shards)}
        self.turns = [threading.Event() for _ in range(self.n)]
        self.boards = ([None] * n_all, [None] * n_all)
        self.rounds = [0] * self.n
        self.aborted = False

    def reset(self) -> None:
        for e in self.turns:
            e.clear()
        self.turns[0].set()
        self.rounds = [0] * self.n
        self.aborted = False

    def wait_turn(self, k: int) -> None:
        if not self.turns[k].wait(_TURN_TIMEOUT_S):
            self.abort()
            raise RuntimeError(
                f"local shard {k} waited {_TURN_TIMEOUT_S} s for its turn: "
                "the shards' collectives do not match")
        self.turns[k].clear()
        if self.aborted:
            raise _Aborted()

    def pass_turn(self, k: int) -> None:
        self.turns[(k + 1) % self.n].set()

    def abort(self) -> None:
        self.aborted = True
        for e in self.turns:
            e.set()

    def exchange(self, value, cross=None) -> list:
        """Every shard posts ``value``; each gets the board of all posts,
        indexed by shard (cross(board) fills in the remote ones a shard
        reads)."""
        if self.n == 1 and cross is None:
            return [value]
        i = current_shard()
        k = self.pos[i]
        board = self.boards[self.rounds[k] % 2]
        self.rounds[k] += 1
        board[i] = value
        if cross is not None and k == self.n - 1:
            cross(board)
        if self.n > 1:
            self.pass_turn(k)
            self.wait_turn(k)
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
    rank: int = 0                   # this process, of world
    world: int = 1
    _spmd: _Spmd = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_spmd", _Spmd(self.local, self.n_devices))

    @property
    def n_devices(self) -> int:
        return math.prod(self.n_subdomains)

    @property
    def local(self) -> Tuple[int, ...]:
        """This process's shards: a contiguous block in mesh order."""
        per = self.n_devices // self.world
        return tuple(range(self.rank * per, (self.rank + 1) * per))

    def is_local(self, i: int) -> bool:
        return self.owner(i) == self.rank

    def owner(self, i: int) -> int:
        """The process that holds shard i."""
        return i // (self.n_devices // self.world)

    def first(self, values: Sequence):
        """This process's first shard's entry of a per-shard list (a value
        summed over the mesh is the same on every shard)."""
        return values[self.local[0]]

    @property
    def global_size(self) -> Tuple[int, ...]:
        return tuple(n * t for n, t in zip(self.n_subdomains, self.true_size))

    @property
    def devices(self) -> List[torch.device]:
        """The shards' devices in mesh order."""
        return list(self.mesh.ravel())

    def distinct_devices(self) -> List[torch.device]:
        """Each device of this process's shards once, in order of its first
        shard."""
        out: List[torch.device] = []
        for i in self.local:
            if self.devices[i] not in out:
                out.append(self.devices[i])
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
        """fn on each local shard's items in turn, under the shard's scope;
        None for another process's shards."""
        out: list = [None] * self.n_devices
        for i in self.local:
            with self.scope(i):
                out[i] = fn(*(a[i] for a in lists))
        return out

    def shard_map(self, fn, *lists) -> list:
        """``shard_map``: one thread a local shard runs fn on its items
        (under its scope); the collectives inside fn meet across the
        threads and the processes.  Returns the per-shard results in mesh
        order (None for another process's shards)."""
        if current_shard() is not None:
            raise RuntimeError("shard_map inside a shard's work")
        local = self.local
        if len(local) == 1:
            return self.map(fn, *lists)
        spmd = self._spmd
        spmd.reset()
        n_threads = torch.get_num_threads()
        cpu = any(self.devices[i].type == "cpu" for i in local)
        fresh = []

        def run(k, i):
            try:
                spmd.wait_turn(k)
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
            spmd.pass_turn(k)
            return out

        n = len(local)
        with _LOCK:
            pool = _POOLS.get(n)
            if pool is None:
                pool = _POOLS[n] = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"shard{n}")
        futures = [pool.submit(run, k, i) for k, i in enumerate(local)]
        results: list = [None] * self.n_devices
        errors = []
        for i, f in zip(local, futures):
            try:
                results[i] = f.result()
            except BaseException as e:       # noqa: BLE001 (re-raised)
                errors.append(e)
        if fresh:      # set_num_threads is process-wide for new threads
            torch.set_num_threads(n_threads)
        if errors:
            first = [e for e in errors if not isinstance(e, _Aborted)]
            raise (first or errors)[0]
        return results

    # ------------------------------------------- across processes (P > 1)
    def complete(self, values: Sequence) -> list:
        """A per-shard list with every shard's entry: another process's
        fetched from it (one all-gather).  Every process calls it."""
        values = list(values)
        if self.world == 1:
            return values
        got = mh.all_gather_values([values[i] for i in self.local])
        per = len(self.local)
        for q, vals in enumerate(got):
            if q != self.rank:
                values[q * per:(q + 1) * per] = vals
        return values

    def fetch(self, *requests) -> List[Dict[int, object]]:
        """Each request (board, src_of): {local shard j: board[src_of(j)]}
        for the j whose source is another process's shard, all fetched in
        one point-to-point exchange; this process sends its posts that
        another process's shards read.  src_of must be the same function
        on every process."""
        sends: Dict[int, list] = defaultdict(list)
        recvs: Dict[int, list] = defaultdict(list)
        order: Dict[int, list] = defaultdict(list)
        for r, (board, src_of) in enumerate(requests):
            for j in range(self.n_devices):      # the receivers, in order
                s = src_of(j)
                if self.is_local(s) == self.is_local(j):
                    continue
                if self.is_local(s):
                    sends[self.owner(j)].extend(mh.leaves(board[s]))
                else:
                    recvs[self.owner(s)].extend(mh.leaves(board[j]))
                    order[self.owner(s)].append((r, j))
        got = mh.exchange(sends, recvs)
        out: List[Dict[int, object]] = [{} for _ in requests]
        for q, rjs in order.items():
            it = iter(got[q])
            for r, j in rjs:
                # the shapes of a shard's post are its neighbours'
                out[r][j] = mh.rebuild(requests[r][0][j], it)
        return out

    # -------------------------------------- collectives (inside shard_map)
    def ppermute(self, x, d: int, shift: int):
        """``lax.ppermute(x, axis d, _perm(n, shift))``: x (a tensor or a
        tuple of them) moves ``shift`` shards along mesh axis d; returns
        what this shard receives, copied onto its device."""
        i = current_shard()

        def src_of(j):
            return self.neighbor(j, d, -shift)

        def cross(board):
            for j, v in self.fetch((board, src_of))[0].items():
                board[src_of(j)] = v
        posts = self._spmd.exchange(x, None if self.world == 1 else cross)
        return _copy_to(posts[src_of(i)], self.devices[i])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` over every mesh axis: the shards' values summed in
        mesh order on this process's first device, returned on this
        shard's device."""
        def cross(board):
            board[:] = self.complete(board)
        posts = self._spmd.exchange(x, None if self.world == 1 else cross)
        s = self._sum(posts)
        own = self.devices[current_shard()]
        return s if own == s.device else s.to(own)

    def _sum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        dev0 = self.devices[self.local[0]]
        s = values[0].to(dev0)
        for v in values[1:]:
            s = s + v.to(dev0)
        return s

    # ----------------------------------------- layout (between the maps)
    def gather(self, blocks: Sequence[Optional[torch.Tensor]],
               device: Optional[torch.device] = None) -> torch.Tensor:
        """The global field of per-shard blocks (each (*true_size, ...)),
        on ``device`` (default this process's first shard's), on every
        process."""
        return self._assemble(self.complete(blocks), device)

    def _assemble(self, blocks: Sequence[torch.Tensor],
                  device: Optional[torch.device] = None) -> torch.Tensor:
        dev = self.devices[self.local[0]] if device is None else device
        b0 = blocks[0]
        tail = tuple(b0.shape[len(self.true_size):])
        out = torch.empty(self.global_size + tail, dtype=b0.dtype,
                          device=dev)
        for i, b in enumerate(blocks):
            out[self.block_slices(i)].copy_(b)
        return out

    def split(self, g: torch.Tensor, shards=None) -> list:
        """Per-shard blocks of a global field, each a contiguous copy on
        its shard's device: shards None gives the per-shard list (None for
        another process's shards), else the listed shards' blocks."""
        def cut(i):
            return g[self.block_slices(i)].to(self.devices[i], copy=True) \
                .contiguous()
        if shards is not None:
            return [cut(i) for i in shards]
        out: list = [None] * self.n_devices
        for i in self.local:
            out[i] = cut(i)
        return out

    def replicated(self, fn, blocks: Sequence[Optional[torch.Tensor]]
                   ) -> list:
        """fn on the gathered global field, once for each distinct device
        of this process's shards; its global result cut into the shards on
        that device."""
        full = self.complete(blocks)
        out: list = [None] * self.n_devices
        for dev in self.distinct_devices():
            mine = [i for i in self.local if self.devices[i] == dev]
            with self.scope(mine[0]):
                g = fn(self._assemble(full, dev))
                for i, b in zip(mine, self.split(g, mine)):
                    out[i] = b
        return out

    def synchronize(self) -> None:
        """Wait for every card of this process's shards."""
        for dev in self.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def sum(self, values: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """``psum`` of per-shard values, outside shard_map: summed in mesh
        order on this process's first device."""
        return self._sum(self.complete(values))


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
    """The mesh of a deck's decomposition over this run's processes.
    devices: a list of devices, one a shard (a device may repeat); None
    means the visible cards, cuda:0..N-1, with one process, and this
    process's card (``multihost.local_device``) for each of its shards
    with several.  Raises ValueError when there are fewer devices than the
    deck needs, or when the process count does not divide the shards."""
    nsub = tuple(int(n) for n in n_subdomains)
    need = math.prod(nsub)
    world, rank = mh.process_count(), mh.process_index()
    if need % world:
        raise ValueError(f"{world} processes do not divide the deck's "
                         f"{need} shards (grid:nSubdomains={nsub})")
    if devices is None:
        if world > 1:
            devices = [mh.local_device()] * need
        else:
            devices = ([torch.device("cuda", k)
                        for k in range(torch.cuda.device_count())]
                       if torch.cuda.is_available() else [])
    devices = [_normalize(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"deck wants {need} devices "
                         f"(grid:nSubdomains={nsub}) but only "
                         f"{len(devices)} available")
    per = need // world
    first = devices[rank * per]
    arr = np.empty(need, dtype=object)
    for k in range(need):
        # another process's shard: where its data lands on this process
        arr[k] = devices[k] if k // per == rank else first
    return MeshCtx(mesh=arr.reshape(nsub), axes=AXIS_NAMES[:len(nsub)],
                   n_subdomains=nsub,
                   true_size=tuple(int(t) for t in true_size),
                   rank=rank, world=world)


def mesh_devices(device, n: int):
    """``make_mesh``'s devices for an entry point run on ``device``: n times
    the CPU for a CPU run, n times this process's device over several
    processes, else None (the visible cards)."""
    dev = torch.device(device)
    if dev.type == "cpu" or mh.process_count() > 1:
        return [dev] * n
    return None


def subdomain_offset(ctx: MeshCtx, i: Optional[int] = None
                     ) -> Tuple[int, ...]:
    """Shard i's (default: the running shard's) global node offset per dim
    (mpiInfo->offset; pToGlobalFrame adds it, src/population.c:746-763)."""
    return tuple(c * t for c, t in zip(ctx.coords(i), ctx.true_size))
