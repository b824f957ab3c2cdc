"""The program's ranges in a traced span: trace.reduce_events reads the
benchmark's ranges as before with them present, program_pass takes the
device-idle time inside the pinc.sync.* ranges and names each gap by its
innermost pinc.* range, and the readers of the program's metrics say
nothing without the tracer's reports and read them, on the CPU at tiny
sizes, where a run gives them."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from bench_fixture import make_tree  # noqa: F401

from benchmarks import harness as h
from benchmarks import program_pass as pt
from benchmarks import trace as tr

SEED = 2_400_000_019


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launched(name, ts, dev_ts, dur, corr):
    """A launch on the host at ts and its kernel on the card at dev_ts."""
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 1, corr=corr),
            _x(name, "kernel", dev_ts, dur, tid=7, corr=corr)]


def _events():
    """A window [0, 200]: a step whose re-bucket (a bench range around the
    program's) and solve launch kernels, a host copy between them that
    leaves the card idle, and a retune after them with another."""
    ev = [_x(tr.WINDOW, "user_annotation", 0, 200)]
    ev += [_x("bench.rebucket", "user_annotation", 10, 20),
           _x("bench.solve", "user_annotation", 70, 10)]
    ev += _launched("extract", 12, 20, 30, 1)
    ev += _launched("merge", 25, 50, 10, 2)
    ev += [_x("cudaMemcpyAsync", "cuda_runtime", 58, 12)]
    ev += _launched("fft", 72, 72, 28, 3)
    ev += [_x("cudaMemcpyAsync", "cuda_runtime", 99.5, 61.5)]
    ev += _launched("push", 170, 170, 20, 4)
    return ev


def _program_ranges():
    return [_x("pinc.step", "user_annotation", 5, 190),
            _x("pinc.rebucket", "user_annotation", 11, 18),
            _x("pinc.sync.drops", "user_annotation", 57, 14),
            _x("pinc.solve", "user_annotation", 71, 8),
            _x("pinc.retune", "user_annotation", 98, 67),
            _x("pinc.sync.retune_sample", "user_annotation", 99, 63)]


# device busy [20, 60], [72, 100], [170, 190]: idle [0, 20], [60, 72],
# [100, 170], [190, 200]
def test_reduce_events_unchanged_by_program_ranges():
    """The benchmark's own reduction gives the same numbers with the
    program's ranges nested in and between its ranges: no device operation
    leaves its bench.* range, and the busy time is the same."""
    names = ["bench.rebucket", "bench.solve"]
    before = tr.reduce_events(_events(), names)
    after = tr.reduce_events(_events() + _program_ranges(), names)
    assert before.range_s == pytest.approx({"bench.rebucket": 40e-6,
                                            "bench.solve": 28e-6})
    for f in dataclasses.fields(tr.TraceSummary):
        assert getattr(after, f.name) == getattr(before, f.name), f.name


def test_program_pass_counts_idle_inside_sync_ranges():
    """Idle time inside a pinc.sync.<site> range counts for its site;
    idle time outside every sync range counts for none, but for pinc.*
    when a pinc.* range holds it, and for the innermost range over it."""
    out = pt.program_pass(_events() + _program_ranges())
    assert out["idle_s"] == pytest.approx(112e-6)
    assert out["sync_s"] == pytest.approx({"drops": 11e-6,
                                           "retune_sample": 62e-6})
    # pinc.step holds [5, 195]
    assert out["in_pinc_s"] == pytest.approx(102e-6)
    assert out["by_range"] == pytest.approx({
        "outside pinc.*": 10e-6, "pinc.step": 16e-6, "pinc.rebucket": 9e-6,
        "pinc.sync.drops": 11e-6, "pinc.solve": 1e-6,
        "pinc.sync.retune_sample": 62e-6, "pinc.retune": 3e-6})
    assert pt.program_pass(_events())["sync_s"] == {}
    assert pt.program_pass(_events())["in_pinc_s"] == 0


def test_gap_names_take_the_program_prefix():
    """A gap is named by the innermost pinc.* range open at its start and
    the innermost host operation; without program ranges the names are
    the host operations' alone."""
    gaps = dict(pt.program_pass(_events() + _program_ranges())["gaps"])
    assert gaps == pytest.approx({
        "pinc.sync.drops/cudaMemcpyAsync": 12e-6,
        "pinc.sync.retune_sample/cudaMemcpyAsync": 70e-6,
        "pinc.step": 10e-6, "host (between operations)": 20e-6})
    plain = dict(pt.program_pass(_events())["gaps"])
    assert plain == pytest.approx({"cudaMemcpyAsync": 82e-6,
                                   "host (between operations)": 30e-6})


#: the program's metrics, and the cells of the tiny tree they read in
PROGRAM = {"retune_ms_per_step.run": ".run", "sync_idle_ms_per_step.run": ".run",
           "margin_hits_per_step.run": ".run", "rebuckets_per_step.run": ".run",
           "past_margin_per_step": ".scan", "setup_build_s": None,
           "setup_bucket_s": "", "setup_objects_s": "tinysphere"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    return make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_reader_silent_without_the_program(tree, name):
    """On the context the harness gives today (no program_setup, program
    or program_pass), each reader returns nothing and does not raise."""
    summary = tr.TraceSummary(window_s=1.0, busy_s=0.5, device_s=0.5,
                              n_kernels=3, range_s={}, range_calls={},
                              ops=[], steps=10)
    ctx = SimpleNamespace(trace=summary, step_seconds=[0.01] * 10,
                          steps=10, setup_s=1.0)
    assert h.Bench(tree).module("metrics", name).read(ctx) is None


def _traced_cell(tree, cell, monkeypatch):
    """A tiny cell run by run_cell with --trace 1: the context its readers
    took (kept by a spy on the reader modules) and the result line."""
    seen = []
    module = h.Bench.module

    def spied(self, kind, name):
        mod = module(self, kind, name)
        if kind == "metrics":
            read = mod.read
            mod.read = lambda ctx: (seen.append(ctx), read(ctx))[1]
        return mod
    monkeypatch.setattr(h.Bench, "module", spied)
    out = h.run_cell(tree, cell, SEED, 0.2, True, device="cpu")
    assert out["correct"], out["check"]
    return seen[0], out


@pytest.mark.parametrize("cell", ["tiny16.run", "tinysphere16.run",
                                  "tiny16.scan"])
def test_readers_read_the_program(tree, cell, monkeypatch):
    """Each reader reads its span or counter in the cells whose layers
    have it, per traced step, and nothing in the others."""
    ctx, out = _traced_cell(tree, cell, monkeypatch)
    bench = h.Bench(tree)
    m = {k: bench.module("metrics", k).read(ctx) for k in PROGRAM}
    for name, where in PROGRAM.items():
        assert (m[name] is not None) == (where is not None and where in cell), \
            name
        if name in out["metrics"]:
            assert out["metrics"][name]["value"] == m[name], name
    assert dict(out["breakdown"]["idle_gaps"]) == \
        dict(ctx.program_pass["gaps"])
    counts, spans = ctx.program["counts"], ctx.program["spans"]
    assert m["setup_bucket_s"] == \
        ctx.program_setup["spans"]["pinc.setup.bucket"]["seconds"] > 0
    if cell.endswith(".run"):
        steps = spans["pinc.step"]["calls"]
        assert steps == ctx.trace.steps == 10
        assert m["rebuckets_per_step.run"] == \
            counts.get("pinc.rebuckets", 0) / steps
        assert m["margin_hits_per_step.run"] == \
            counts.get("pinc.margin_hits", 0) / steps
        assert m["retune_ms_per_step.run"] == pytest.approx(
            spans.get("pinc.retune", {"seconds": 0})["seconds"] / steps * 1e3)
        assert m["sync_idle_ms_per_step.run"] == pytest.approx(
            sum(ctx.program_pass["sync_s"].values()) / steps * 1e3)
        # no card here: the sync ranges are idle, and no longer than the
        # report's host times, which add the ranges' own bookkeeping
        assert 0 < m["sync_idle_ms_per_step.run"] <= sum(
            v["seconds"] for k, v in spans.items()
            if k.startswith("pinc.sync.")) / steps * 1e3
    else:
        assert m["past_margin_per_step"] == \
            counts["pinc.past_margin"] / ctx.trace.steps
        assert spans["pinc.solve"]["calls"] >= ctx.trace.steps


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tiny16.run", "tiny16.scan"])
def test_tracer_off_in_window_and_capture(tree, cell, trace, monkeypatch):
    """Each solve of a run notes whether the program's tracer was on: off
    all through an untraced run; in a traced one on over set-up and the
    profiled span alone, off over the measured window and the capture."""
    from pinc_tpu_torch.utils import timer
    phase, seen = ["set-up"], []
    make_sim, profile = h.make_sim, tr.profile

    def spied_sim(*a, **k):
        sim = make_sim(*a, **k)
        solver = sim.solver

        def solve(rho):
            seen.append((phase[0], timer._on))
            return solver(rho)
        sim.solver = solve
        return sim

    def spied_profile(*a, **k):
        phase[0] = "trace"
        try:
            return profile(*a, **k)
        finally:
            phase[0] = "after the trace"
    monkeypatch.setattr(h, "make_sim", spied_sim)
    monkeypatch.setattr(tr, "profile", spied_profile)
    entry = h.ENTRIES[cell.rsplit(".", 1)[1]]
    for name in ("warmup", "capture"):
        method = getattr(entry, name)

        def spied(self, *a, _method=method, _name=name, **k):
            phase[0] = _name
            try:
                return _method(self, *a, **k)
            finally:
                phase[0] = "window" if _name == "warmup" else "done"
        monkeypatch.setattr(entry, name, spied)
    out = h.run_cell(tree, cell, SEED, 0.2, trace, device="cpu")
    assert out["correct"], out["check"]
    on = {}
    for p, o in seen:
        on.setdefault(p, set()).add(o)
    assert {"warmup", "window", "capture"} <= set(on)
    expect = {"warmup": {trace}, "window": {False}, "trace": {True},
              "capture": {False}}
    for p, o in on.items():
        assert o == expect[p], p
    assert ("trace" in on) == trace
    assert not timer._on and timer.report() == {"spans": {}, "counts": {}}
