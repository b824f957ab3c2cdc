"""The frozen work counts give the bounds the repository measured its
kernels against (PERF.md, the kernel table) at the main path's shapes."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from bench_fixture import REPO  # noqa: F401 (sys.path)

from benchmarks.harness import Bench


def layout(M, T=8, B=17408, grid=128):
    return SimpleNamespace(NT=(grid // T) ** 3, B=B, T=T, M=M,
                           P=T + 1 + 2 * M)


@pytest.fixture(scope="module")
def work():
    bench = Bench(REPO)
    return bench.module("work", "push"), bench.module("work", "kernels")


@pytest.mark.parametrize("M,ms", [(2, 2.2405), (1, 2.2299)])
def test_k5_bound(work, M, ms):
    push, kernels = work
    assert round(kernels.bound_ms(push.step_bytes(layout(M), 2, 2)), 4) == ms


@pytest.mark.parametrize("fn,ms", [("deposit_move_bytes", 0.8579),
                                   ("gather_kick_bytes", 0.8709),
                                   ("deposit_bytes", 0.3471)])
def test_k1_k2_k4_bounds(work, fn, ms):
    _, kernels = work
    assert round(kernels.bound_ms(getattr(kernels, fn)(layout(1))), 4) == ms


def test_push_bound_is_bytes(work):
    """At the bench shapes the push is bound by its bytes, its operations
    needing ~0.23 ms at 67 TFLOP/s."""
    push, _ = work
    ts = layout(2)
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    assert math.isclose(push.bound_s(ts, 2, 2, peaks),
                        push.step_bytes(ts, 2, 2) / 3.35e12)
    assert push.step_flops(ts, 2) / 67e12 < 0.3e-3
