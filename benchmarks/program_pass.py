"""The program's ranges in a traced span: the device-idle time inside the
``pinc.*`` ranges that ``pinc_tpu_torch.utils.timer`` opens when its
tracer is on, and each idle gap named by the program's own site.

A pass of its own beside ``trace.reduce_events``, whose numbers it leaves
as they are: it takes the idle time of the traced window (the gaps of the
union of device operations) and intersects it with the program's
``pinc.*`` ranges on the profiler's clock, per ``pinc.sync.<site>`` and
for any ``pinc.*`` range, and names each gap by the innermost ``pinc.*``
range open at its start and the innermost host operation, e.g.
``pinc.sync.retune_sample/cudaMemcpyAsync``.  The reader of
``sync_idle_ms_per_step.run`` takes its ``sync_s`` from ``ctx.program_pass``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from . import trace as tr

SYNC = "pinc.sync."
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def _overlap(gaps, spans) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    out, j = 0.0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            out += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return out


def program_pass(events, top: int = 10) -> dict:
    """Device-idle seconds of the traced window inside the program's
    ranges: ``idle_s`` (all of it), ``in_pinc_s`` (inside any ``pinc.*``
    range), ``sync_s`` (per ``pinc.sync.<site>``, by site), ``by_range``
    (by the innermost ``pinc.*`` range over it: each range's own idle
    time, its children's left out) and ``gaps`` (the ``top`` largest by
    name, ``<innermost pinc.* range>/<innermost host operation>`` at the
    gap's start).  Ranges and host operations are those of the thread
    that opened the window."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == tr.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main = win[0].get("tid")
    busy = tr._merge((max(float(e["ts"]), w0),
                      min(float(e["ts"]) + float(e["dur"]), w1))
                     for e in xs if e.get("cat") in tr.DEVICE_CATS
                     and float(e["ts"]) < w1
                     and float(e["ts"]) + float(e["dur"]) > w0)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    pinc = _ranges(e for e in xs if e.get("tid") == main
                   and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("pinc."))
    sites: Dict[str, List[Tuple[float, float]]] = {}
    for a, b, name in pinc:
        if name.startswith(SYNC):
            sites.setdefault(name[len(SYNC):], []).append((a, b))
    sync_s = {site: _overlap(gaps, tr._merge(iv)) * 1e-6
              for site, iv in sorted(sites.items())}
    in_pinc = _overlap(gaps, tr._merge((a, b) for a, b, _ in pinc))
    host = _ranges(e for e in xs if e.get("tid") == main
                   and e.get("cat") in HOST_CATS
                   and e.get("name") != tr.WINDOW)
    pinc_at, host_at = [r[0] for r in pinc], [r[0] for r in host]
    named: Dict[str, float] = {}
    by_range: Dict[str, float] = {}
    for a, b in gaps:
        # each piece of the gap to the innermost pinc.* range open over it
        lo, hi = bisect.bisect_left(pinc_at, a), bisect.bisect_left(
            pinc_at, b)
        cuts = sorted({a, b} | {x for r in pinc[max(lo - 256, 0):hi]
                                for x in r[:2] if a < x < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            name = _innermost(pinc, pinc_at, (c0 + c1) / 2,
                              "outside pinc.*", open_=True)
            by_range[name] = by_range.get(name, 0.0) + (c1 - c0) * 1e-6
        outer = _innermost(pinc, pinc_at, a, "")
        inner = _innermost(host, host_at, a, "host (between operations)")
        name = inner if not outer or inner == outer else f"{outer}/{inner}"
        named[name] = named.get(name, 0.0) + (b - a) * 1e-6
    return {"idle_s": sum(b - a for a, b in gaps) * 1e-6,
            "in_pinc_s": in_pinc * 1e-6, "sync_s": sync_s,
            "by_range": dict(sorted(by_range.items(), key=lambda x: -x[1])),
            "gaps": sorted(named.items(), key=lambda x: -x[1])[:top]}


def _ranges(events):
    """(start, end, name) of the events, by start, the outer of two that
    start together first."""
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events),
                  key=lambda r: (r[0], -r[1]))


def _innermost(ops, starts, t: float, default: str,
               open_: bool = False) -> str:
    """The name of the latest-starting operation of ops (_ranges; starts:
    their starts) still open at t (strictly, with open_), looked for among
    the 256 that start before it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if ops[j][1] > t or (ops[j][1] == t and not open_):
            return ops[j][2]
    return default
