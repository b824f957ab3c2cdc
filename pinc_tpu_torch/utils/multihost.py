"""Runs over several processes (the counterpart of
``pinc_tpu/utils/multihost.py``), on ``torch.distributed``.

``pinc_tpu`` runs on a pod as JAX does: every process runs the same
program and ``jax.devices()`` spans them all.  The port runs the same way
under PyTorch's launcher::

    torchrun --standalone --nproc-per-node=2 -m pinc_tpu_torch deck.ini

``init()`` joins the process group that torchrun's environment describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``); ``parallel/mesh.py`` then gives each
process a contiguous block of the deck's shards.  With one process (no
``WORLD_SIZE``, or 1) nothing is joined and every function here is the
single-process case.

The I/O discipline is ``pinc_tpu``'s (the reference's collective MPI-IO,
src/grid.c:1161-1180, src/population.c:538-651, rebuilt as serial files):

* replicated and small outputs (history.xy.h5, timer.xy.h5, the grid
  fields, the checkpoint) are written by process 0 only;
* sharded fields are gathered to every process before process 0 writes;
* each process writes the particles of its own shards to
  ``<prefix>_pop.p<idx>.pop.h5``; a reader concatenates.

The backend is explicit: ``nccl`` where every rank of a host has its own
card, ``gloo`` on the CPU and where ranks share a card (NCCL refuses two
ranks on one GPU).  Gloo carries CUDA tensors through host memory: pinned
copies, in ``_to_wire``/``_from_wire``.  Asking for ``nccl`` on a shared
card raises; nothing switches from one backend to the other by itself.

A process-sharded array is a list over the mesh's shards, in mesh order,
holding this process's shards and None where another process holds one
(``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the deadline of a wait on another process (the process group's timeout):
#: a mismatched collective fails after it instead of hanging
DEFAULT_TIMEOUT_S = 300.0

_STATE: dict = {"backend": None, "device": None, "timeout": None}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_primary() -> bool:
    """True on the process that owns single-file outputs."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend (None with one process)."""
    return _STATE["backend"] if _initialized() else None


def local_device(device=None) -> torch.device:
    """The device this process runs on: ``device`` where the caller gives
    one (e.g. "cpu"), else card ``LOCAL_RANK % device_count`` under a
    launcher and the current card otherwise.  Raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is false): "
            "pinc_tpu_torch runs on the card; pass device=\"cpu\" to run "
            "the kernels' plain PyTorch versions on the CPU")
    if "LOCAL_RANK" not in os.environ:
        return torch.device("cuda")
    return torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())


def choose_backend(requested: Optional[str], device: torch.device,
                   local_world: int, n_cards: int) -> str:
    """The rule: gloo on the CPU; on cards nccl where each of a host's
    ``local_world`` ranks has its own of the ``n_cards``, gloo where they
    share.  ``requested``: the caller's choice, checked against it."""
    shared = device.type == "cuda" and local_world > n_cards
    want = requested.lower() if requested else None
    if device.type == "cpu":
        if want not in (None, "gloo"):
            raise ValueError(f"backend {requested!r} cannot carry CPU "
                             "tensors; use backend='gloo'")
        return "gloo"
    if want is None:
        return "gloo" if shared else "nccl"
    if want == "nccl" and shared:
        raise ValueError(
            f"backend 'nccl' with {local_world} ranks on {n_cards} card(s): "
            "NCCL refuses two ranks on one GPU; use backend='gloo', which "
            "carries the card's tensors through host memory")
    if want not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {requested!r} (nccl or gloo)")
    return want


def init(backend: Optional[str] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S, device=None,
         init_method: Optional[str] = None) -> bool:
    """Join the process group of torchrun's environment.  A no-op with
    ``WORLD_SIZE`` unset or 1, or when a group exists already.  backend:
    None for the rule of ``choose_backend``; device: this process's device
    (``local_device``'s argument); init_method: the rendezvous (default
    ``env://``, MASTER_ADDR/MASTER_PORT).  Each rank logs its rank, device
    and backend.  Returns True where this call created the group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or _initialized():
        return False
    rank = int(os.environ["RANK"])
    dev = local_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    chosen = choose_backend(backend, dev, local_world, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(chosen, init_method=init_method or "env://",
                            world_size=world, rank=rank, timeout=timeout)
    _STATE.update(backend=chosen, device=dev, timeout=timeout)
    from .logging import STATUS, msg
    msg(STATUS, "process %d of %d on %s, backend %s%s", rank, world, dev,
        chosen, " (ranks share the card: host-memory transport)"
        if chosen == "gloo" and dev.type == "cuda" else "", all_ranks=True)
    return True


def shutdown(barrier: bool = True) -> None:
    """Leave the process group, after a barrier unless ``barrier`` is
    False (the way out after an error)."""
    if _initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None, timeout=None)


def barrier() -> None:
    if _initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ------------------------------------------------------------- transport
def leaves(x) -> List[torch.Tensor]:
    """The tensors of a value (a tensor, None, a tuple or list, or a
    dataclass such as Particles), in order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    raise TypeError(f"cannot send a {type(x).__name__}")


def rebuild(template, it):
    """A value shaped as ``template`` whose tensors come from ``it``."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: rebuild(getattr(template, f.name),
                                                 it)
                                 for f in dataclasses.fields(template)})
    return type(template)(rebuild(v, it) for v in template)


_ALIGN = 16


def _nbytes(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN


def _bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    return t.view(torch.uint8)


def _wire_device() -> torch.device:
    """Where messages travel: the card for nccl, host memory for gloo."""
    if _STATE["backend"] == "nccl":
        return _STATE["device"]
    return torch.device("cpu")


def _to_wire(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one buffer, each at a 16-byte offset: on the
    card for nccl; in pinned host memory for gloo where any comes from a
    card (the one staging copy of the host-memory transport)."""
    dev = _wire_device()
    pin = dev.type == "cpu" and any(t.is_cuda for t in tensors)
    buf = torch.empty(sum(_nbytes(t) for t in tensors), dtype=torch.uint8,
                      device=dev, pin_memory=pin)
    off = 0
    for t in tensors:
        b = _bytes(t)
        buf[off:off + b.numel()].copy_(b)
        off += _nbytes(t)
    return buf


def _from_wire(buf: torch.Tensor, templates: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Tensors shaped, typed and placed as ``templates`` from a buffer of
    ``_to_wire``."""
    out, off = [], 0
    for t in templates:
        n = t.numel() * t.element_size()
        raw = buf[off:off + n]
        if t.is_complex():
            real = raw.view(torch.float32 if t.dtype == torch.complex64
                            else torch.float64)
            v = torch.view_as_complex(real.reshape(t.shape + (2,)))
        else:
            v = raw.view(t.dtype).reshape(t.shape)
        out.append(v.to(t.device, copy=True))
        off += _nbytes(t)
    return out


def _wire_like(templates: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = _wire_device()
    pin = dev.type == "cpu" and any(t.is_cuda for t in templates)
    return torch.empty(sum(_nbytes(t) for t in templates),
                       dtype=torch.uint8, device=dev, pin_memory=pin)


def all_gather(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every process's ``tensors`` (each process passes tensors of the same
    shapes and dtypes), indexed by process, placed as this process's."""
    P = process_count()
    if P == 1:
        return [list(tensors)]
    buf = _to_wire(tensors)
    bufs = [torch.empty_like(buf) for _ in range(P)]
    dist.all_gather(bufs, buf)
    me = process_index()
    return [list(tensors) if q == me else _from_wire(b, tensors)
            for q, b in enumerate(bufs)]


def exchange(sends: Dict[int, List[torch.Tensor]],
             recvs: Dict[int, List[torch.Tensor]]
             ) -> Dict[int, List[torch.Tensor]]:
    """Point to point: ``sends[q]`` to process q, and from each process q
    the tensors shaped as ``recvs[q]`` (templates: shape, dtype, device),
    one message each way a pair, in one ``batch_isend_irecv``."""
    sends = {q: v for q, v in sends.items() if v}
    recvs = {q: v for q, v in recvs.items() if v}
    if not sends and not recvs:
        return {}
    ops, inbox = [], {}
    for q in sorted(sends):
        ops.append(dist.P2POp(dist.isend, _to_wire(sends[q]), q))
    for q in sorted(recvs):
        inbox[q] = _wire_like(recvs[q])
        ops.append(dist.P2POp(dist.irecv, inbox[q], q))
    timeout = _STATE["timeout"]
    for w in dist.batch_isend_irecv(ops):
        if timeout is None:
            w.wait()
        else:
            w.wait(timeout)
    return {q: _from_wire(inbox[q], recvs[q]) for q in inbox}


def all_gather_values(values: Sequence) -> List[list]:
    """``all_gather`` of values (tensors, tuples, dataclasses): every
    process's list of values, indexed by process."""
    flat = [t for v in values for t in leaves(v)]
    got = all_gather(flat)
    out = []
    for q, ts in enumerate(got):
        it = iter(ts)
        out.append([rebuild(v, it) for v in values])
    return out


# ------------------------------------------------------------- fetching
def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_sharded(x) -> bool:
    return isinstance(x, list)


def fetch_global(x, axis: int = 0) -> np.ndarray:
    """The global array on the host of every process.  A tensor or an
    array (replicated, or one process): its host copy.  A process-sharded
    list: every shard's block, gathered from the processes that hold them
    (``process_allgather``), concatenated along ``axis`` in mesh order."""
    if not _is_sharded(x):
        return _host(x)
    per = len(x) // process_count()
    mine = [v for v in x if v is not None]
    got = all_gather(mine)
    blocks = [None] * len(x)
    for q, ts in enumerate(got):
        blocks[q * per:(q + 1) * per] = ts
    return np.concatenate([_host(b) for b in blocks], axis=axis)


def fetch_local(x, axis: int = 0) -> np.ndarray:
    """This process's rows: a process-sharded list's own shards
    concatenated along ``axis`` in mesh order; a tensor or array whole."""
    if not _is_sharded(x):
        return _host(x)
    return np.concatenate([_host(v) for v in x if v is not None], axis=axis)
