"""Nanosecond-accumulating timer — the reference's ``Timer``
(src/core.h:439-442; tAlloc/tStart/tStop/tMsg, src/aux.c:48-89) plus a
device timer built on CUDA events, since PyTorch launches asynchronously
and a host clock alone measures the enqueue — and the program's tracer:
named spans and counters at the layer boundaries of the step loop.

The tracer is off unless a caller turns it on with ``tracing(True)``.
Off, ``span`` returns one shared no-op context and ``count`` and
``count_device`` return at once: no profiler call, no timestamp, no
launch, no host sync.  On, a span adds its host time
(``time.perf_counter_ns``) to a per-name total and opens a
``torch.profiler.record_function`` range of the same name, which lands in
any active profiler trace, so the spans and the device operations share
the profiler's clock; ``count_device`` keeps a reference to a small
device tensor the program already computed and sums it only in
``report()``.  Names: ``pinc.step``, ``pinc.rebucket``, ``pinc.solve``,
``pinc.objects``, ``pinc.retune``, ``pinc.sync.<site>`` (one a host sync
of the step loop), ``pinc.setup.build``, ``pinc.setup.bucket``,
``pinc.setup.objects``; counters ``pinc.margin_hits``,
``pinc.rebuckets``, ``pinc.retunes_changed``, ``pinc.past_margin``."""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List, Optional

import torch

from .logging import TIMER, msg


class Timer:
    """Accumulating wall timer.  ``total`` is in nanoseconds like the
    reference's ``Timer.total``."""

    def __init__(self, rank: int = 0):
        self.total = 0          # ns
        self._start: Optional[int] = None
        self.rank = rank

    def start(self) -> None:                    # tStart
        self._start = time.perf_counter_ns()

    def stop(self) -> None:                     # tStop
        if self._start is not None:
            self.total += time.perf_counter_ns() - self._start
            self._start = None

    def reset(self) -> None:                    # tReset
        self.total = 0
        self._start = None

    def msg(self, fmt: str = "Time spent: %s") -> None:     # tMsg
        msg(TIMER, fmt, f"{self.total / 1e9:.6f} s")


class DeviceTimer(Timer):
    """Accumulates device time between ``start`` and ``stop`` with CUDA
    events on the current stream (``stop`` synchronises on the end
    event).  On a CPU device it is the wall timer."""

    def __init__(self, device: torch.device | str = "cpu", rank: int = 0):
        super().__init__(rank)
        self.device = torch.device(device)
        self._events = None

    def start(self) -> None:
        if self.device.type != "cuda":
            return super().start()
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._events[0].record()

    def stop(self) -> None:
        if self.device.type != "cuda":
            return super().stop()
        if self._events is None:
            return
        begin, end = self._events
        end.record()
        end.synchronize()
        self.total += int(begin.elapsed_time(end) * 1e6)   # ms -> ns
        self._events = None


# ------------------------------------------------------------------ tracer
_on = False
_lock = threading.Lock()
_spans: Dict[str, List[int]] = {}      # name -> [calls, host ns]
_counts: Dict[str, int] = {}
_device: Dict[str, list] = {}          # name -> device tensors to sum
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        dt = time.perf_counter_ns() - self._t0
        with _lock:
            row = _spans.setdefault(self.name, [0, 0])
            row[0] += 1
            row[1] += dt


def span(name: str):
    """A context manager timing its block under ``name`` while the tracer
    is on; a shared no-op context while it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call is a span of ``name`` (the same single
    flag check as ``span`` while the tracer is off)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add the host integer n to the counter ``name`` (tracer on)."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the elements of the device tensor t, which the program already
    computed, to the counter ``name`` when the report is read (tracer
    on): a reference is kept, nothing is launched or synchronised."""
    if _on:
        with _lock:
            _device.setdefault(name, []).append(t)


@contextlib.contextmanager
def tracing(on: bool = True):
    """Turn the tracer on (or off) for the block, then back to what it
    was.  It nests with ``torch.profiler.profile`` either way round."""
    global _on
    before, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = before


def report() -> dict:
    """What the tracer holds: ``{"spans": {name: {"calls", "seconds"}},
    "counts": {name: n}}``, the device counters summed here (one host
    sync a counter, none in the step)."""
    with _lock:
        spans = {k: {"calls": c, "seconds": ns * 1e-9}
                 for k, (c, ns) in _spans.items()}
        counts = dict(_counts)
        device = {k: list(v) for k, v in _device.items()}
    for k, ts in device.items():
        total = torch.cat([t.reshape(-1).to(ts[0].device, torch.float64)
                           for t in ts]).sum()
        counts[k] = counts.get(k, 0) + int(round(float(total)))
    return {"spans": spans, "counts": counts}


def reset() -> None:
    """Forget every span total and counter."""
    with _lock:
        _spans.clear()
        _counts.clear()
        _device.clear()
