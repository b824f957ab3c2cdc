"""Nanosecond-accumulating timer — the reference's ``Timer``
(src/core.h:439-442; tAlloc/tStart/tStop/tMsg, src/aux.c:48-89) plus a
device timer built on CUDA events, since PyTorch launches asynchronously
and a host clock alone measures the enqueue, and ``profile_trace``, a
torch.profiler trace of a block."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record a torch.profiler trace (CPU and, where there is a card, CUDA
    activities) of the block into ``log_dir``, as a TensorBoard trace file;
    nothing when log_dir is None or empty (the rebuild's answer to the
    reference's gprof workflow, doc/introduction/main.tex:568)."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
