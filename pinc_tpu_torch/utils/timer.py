"""Nanosecond-accumulating timer — the reference's ``Timer``
(src/core.h:439-442; tAlloc/tStart/tStop/tMsg, src/aux.c:48-89) plus a
device timer built on CUDA events, since PyTorch launches asynchronously
and a host clock alone measures the enqueue."""

from __future__ import annotations

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
