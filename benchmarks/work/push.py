"""The push-and-deposit work of one step on the tiled layout: the bytes it
must move and the operations it must do, whatever kernels do it (K5 alone
in the scan window; K2 and K4 in ``run()``; K1, K3 and PyTorch on an object
deck).

Bytes, each input read once and each output written once: per slot and
species x, v and alive read (28 B) and x and v written (24 B); the padded E
tiles read once (3 field values of ``e_bytes`` a node); the padded density
blocks (4 B a node) and two float32 partial sums a species and tile
written.  A frozen copy of the repository's ``chip_smoke.step_bytes``.

Operations, per slot and species: the six 1-D CIC weights (6); the eight
(y, z) products of the gather and the deposit (16); the gather, 8 nodes x 3
components, a multiply and an add each (48); the kick and its v.v' sum
(12); the drift (3); the deposit, 8 nodes, two multiplies and an add each
(24): 109 in all.
"""

FLOPS_PER_SLOT = 109


def slots(ts) -> int:
    return ts.NT * ts.B


def step_bytes(ts, S: int, e_bytes: int) -> float:
    return (S * ts.NT * ts.B * 52.0 + ts.NT * 3 * ts.P ** 3 * e_bytes
            + ts.NT * ts.P ** 3 * 4.0 + 2 * S * ts.NT * 4.0)


def step_flops(ts, S: int) -> float:
    return float(S * slots(ts) * FLOPS_PER_SLOT)


def bound_s(ts, S: int, e_bytes: int, peaks: dict) -> float:
    """The least time of the work on a card of these peaks: its bytes at
    the memory bandwidth, or its operations at the float32 rate where
    that is longer."""
    return max(step_bytes(ts, S, e_bytes) / peaks["hbm_bytes_per_s"],
               step_flops(ts, S) / peaks["fp32_flops_per_s"])
