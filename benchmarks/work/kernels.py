"""Bytes each kernel of the tiled layout must move, each input read once
and each output written once, and the least time they take at a card's
memory bandwidth: a frozen copy of the repository's ``chip_smoke.py``
arithmetic (``bound_ms``, the K1-K4 bounds of its phase 2, and
``exchange_bytes`` with ``merge_prefix``) for the per-layer readers.

``ts`` is a tile layout with ``NT`` tiles of ``B`` slots and padded blocks
of ``P`` nodes a side.  The exchange's bytes depend on the data (the
leavers a call copies, the arrivals it places): ``exchange_bytes`` takes a
call's arguments and outputs, which no reader has yet (PERF.md, Open
questions: roofline.exchange).
"""

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet, at 700 W


def bound_ms(nbytes: float, bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    return nbytes / bytes_per_s * 1e3


def _blocks(ts) -> float:
    """Bytes of one float32 padded block a tile."""
    return ts.NT * ts.P ** 3 * 4.0


def deposit_bytes(ts) -> float:
    """K1 deposit: x (12 B) and the value (4 B) a slot read; the blocks
    written."""
    return ts.NT * ts.B * 16.0 + _blocks(ts)


def deposit_move_bytes(ts) -> float:
    """K2 deposit_move: x, v, alive read and x written a slot (40 B); the
    blocks and a partial a tile written."""
    return ts.NT * ts.B * 40.0 + _blocks(ts) + ts.NT * 4.0


def gather_bytes(ts) -> float:
    """K3 gather: x read and E written a slot (24 B); the E blocks read."""
    return ts.NT * ts.B * 24.0 + 3 * _blocks(ts)


def gather_kick_bytes(ts) -> float:
    """K4 gather_kick: x, alive, v read and v written a slot (40 B); the E
    blocks read, a partial a tile written."""
    return ts.NT * ts.B * 40.0 + 3 * _blocks(ts) + ts.NT * 4.0


def merge_prefix(alive, inc) -> float:
    """Slots of alive the one-hot merge must read: in each segment (row,
    or tile for R = 1) up to the free slot its last placed arrival takes."""
    import torch
    NT, B = alive.shape
    R = inc.shape[2]
    free = (alive <= 0.5).reshape(NT, R, B // R)
    need = torch.minimum((inc[:, 6] > 0.5).sum(-1), free.sum(-1))
    return float(((torch.cumsum(free, -1) < need[..., None]).sum(-1)
                  + (need > 0)).sum())


def _leaves(x) -> list:
    return ([t for y in x for t in _leaves(y)] if isinstance(x, tuple)
            else [x])


def exchange_bytes(kind: str, args, out) -> float:
    """Bytes an exchange kernel call must move (each input read once, each
    output written once; where the work depends on the data, what this
    data needs).  kind: extract, onehot_extract_rows, onehot_extract_tile,
    cleanup, onehot_cleanup, merge, onehot_merge_*."""
    import torch
    if kind == "extract":
        alive, planes = args[0], args[1]
        buf, alive2 = out
        leavers = float((alive > 0.5).sum() - (alive2 > 0.5).sum())
        return alive.numel() * 20.0 + leavers * 12.0 + buf.numel() * 4.0
    if kind in ("onehot_extract_rows", "onehot_extract_tile"):
        alive, buf = args[1], out[0]
        one_axis = isinstance(args[0], torch.Tensor)
        copied = float((buf[:, 6] > 0.5).sum())
        return (alive.numel() * (12.0 if one_axis else 20.0)
                + copied * (20.0 if one_axis else 12.0) + buf.numel() * 4.0)
    if kind in ("cleanup", "onehot_cleanup"):
        inc = args[0]
        valid = float((inc[:, 6] > 0.5).sum())
        return (inc[:, 6].numel() * 4.0 + valid * 24.0
                + sum(t.numel() for t in _leaves(out)) * 4.0)
    alive, inc = args[0], args[1]
    placed = float((out[1] > 0.5).sum() - (alive > 0.5).sum())
    if kind.startswith("onehot_merge"):
        return (merge_prefix(alive, inc) * 4.0 + inc[:, 6].numel() * 4.0
                + placed * 52.0)
    NT, B = alive.shape                                 # the gather merge
    free = (alive <= 0.5).reshape(NT, 8, B // 8)
    need = torch.minimum((inc[:, 6] > 0.5).sum(-1), free.sum(-1))
    prefix = (torch.cumsum(free, -1) < need[..., None]).sum(-1) + (need > 0)
    return (float(prefix.sum()) * 4.0 + inc[:, 6].numel() * 4.0
            + placed * 52.0)
