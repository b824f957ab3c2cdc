"""The traced span: ``torch.profiler`` over a fixed number of steps with
``record_function`` ranges around the port's layer entries (``spans/``),
and the reduction of its trace to device busy time, the device time of
each range and the kernel count (``program_pass`` names the idle gaps).

The trace is exported to a temporary file under ``TMPDIR``, read back and
deleted.  Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; a device operation belongs to a range when the host
call that launched it (found by its correlation id) lies inside the range
on the same thread.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: float                    # sum of device operation times
    n_kernels: int
    range_s: Dict[str, float]          # device seconds launched per range
    range_calls: Dict[str, int]        # times each range opened
    ops: List[Tuple[str, float]]       # device seconds by operation name
    steps: int = 0
    events: Optional[list] = None      # the raw trace events (profile)


@contextlib.contextmanager
def spans(sim, span_attrs: Dict[str, str]):
    """Wrap each named attribute of ``sim`` (an instance attribute, so the
    program's own calls go through it) in a ``record_function`` range."""
    import torch
    saved = {}
    for name, attr in span_attrs.items():
        fn = getattr(sim, attr)
        saved[attr] = attr in vars(sim), fn

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)
        setattr(sim, attr, wrapped)
    try:
        yield
    finally:
        for attr, (own, fn) in saved.items():
            if own:
                setattr(sim, attr, fn)
            else:
                delattr(sim, attr)


def profile(body, range_names) -> TraceSummary:
    """Run body() under torch.profiler inside a WINDOW range, the device
    synchronised before the range closes, and reduce the trace (on a host
    without a card: the host's operations alone); the summary keeps the
    trace's events for other passes over them."""
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            body()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = reduce_events(events, range_names)
    summary.events = events
    return summary


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, range_names) -> TraceSummary:
    """Reduce chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e.get("tid"), float(e["ts"]))
    # host ranges by thread, sorted by start, for the launch lookup
    ranges: Dict[object, List[Tuple[float, float, str]]] = {}
    for e in xs:
        if e.get("cat") == "user_annotation" and e.get("name") in range_names:
            ranges.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
    starts = {}
    for tid in ranges:
        ranges[tid].sort()
        starts[tid] = [r[0] for r in ranges[tid]]
    range_s = {n: 0.0 for n in range_names}
    range_calls = {n: sum(r[2] == n for rs in ranges.values() for r in rs)
                   for n in range_names}
    ops: Dict[str, float] = {}
    intervals, device_us, n_kernels = [], 0.0, 0
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        intervals.append((a, b))
        device_us += b - a
        n_kernels += e.get("cat") == "kernel"
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a)
        host = launch.get(e.get("args", {}).get("correlation"))
        if host is None or host[0] not in ranges:
            continue
        tid, t = host
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and ranges[tid][i][1] >= t:
            range_s[ranges[tid][i][2]] += (b - a) * 1e-6
    merged = _merge(intervals)
    busy_us = sum(b - a for a, b in merged)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        device_s=device_us * 1e-6, n_kernels=n_kernels, range_s=range_s,
        range_calls=range_calls,
        ops=sorted(((n, t * 1e-6) for n, t in ops.items()),
                   key=lambda x: -x[1])[:10])
