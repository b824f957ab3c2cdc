"""The port's tracer (pinc_tpu_torch/utils/timer.py): off it does nothing
at all; on, the spans of a tiled run() nest, its counters agree with what
the step loop did, the window counts K5's slots past the margin, the
ranges land in a profiler trace on the report's clock, and each set-up
span fires once."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import _cuda_build
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.tiled_sim import TiledSimulation
from pinc_tpu_torch.utils import timer

#: 16^3, 4 a cell a species; thermal 0.1/0.05 at margin 2 and every
#: species re-bucketed every 8 steps, so slots wander past the margin and
#: run() re-buckets early on some steps
DECK = """
[time]
nTimeSteps = 24
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.05
drift = 0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 8
mxuDtype = bf16
slack = 1.25
rebucketEvery = 8
"""

SPHERE = DECK.replace("thermalVelocity = 0.1,0.05",
                      "thermalVelocity = 0.02,0.0005").replace(
    "rebucketEvery = 8\n", "") + """
[objects]
objects = sphere16.grid.h5
collisionType = absorb,absorb
"""


@pytest.fixture(autouse=True)
def clean_tracer():
    timer.reset()
    yield
    timer.reset()


def _sim(deck=DECK, **kw):
    torch.manual_seed(0)
    return TiledSimulation(PincConfig.from_string(deck), seed=3,
                           device="cpu", **kw)


class _Ops(TorchDispatchMode):
    """Records the name of every operator dispatched in its block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("pinc.")]


def test_off_makes_no_call(monkeypatch):
    """Off (the default): span returns one shared no-op context and calls
    no record_function, takes no timestamp and dispatches no operator;
    count and count_device dispatch none and keep nothing; a run() leaves
    the report empty."""
    calls = {"range": 0, "clock": 0}

    def record_function(name):
        calls["range"] += 1
        return torch.autograd.profiler.record_function(name)

    def clock():
        calls["clock"] += 1
        return 0
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(timer, "time",
                        types.SimpleNamespace(perf_counter_ns=clock))
    assert timer.span("pinc.step") is timer.span("pinc.solve")
    n_out = torch.ones(2)
    with _Ops() as seen:
        with timer.span("pinc.step"):
            timer.count("pinc.margin_hits", 3)
            timer.count_device("pinc.past_margin", n_out)
        timer.spanned("pinc.retune")(lambda: None)()
    assert seen.ops == []
    _sim().run(progress_every=0)
    assert calls == {"range": 0, "clock": 0}
    assert timer.report() == {"spans": {}, "counts": {}}


def test_tracer_adds_no_operator():
    """A tiled run() and a mega scan window dispatch the same operators,
    in the same order, with the tracer on as off: on, it adds only the
    profiler's range markers (no kernel to launch, no copy to the host);
    count_device sums only in report(), after the block."""
    deck = DECK.replace("nTimeSteps = 24", "nTimeSteps = 12")
    seqs = {}
    for on in (False, True):
        sim = _sim(deck)
        with _Ops() as seen, timer.tracing(on):
            sim.run(progress_every=0)
            sim.make_scan_steps(8, fresh=True)(sim.state)
        seqs[on] = seen.ops
    assert not [op for op in seqs[False] if op.startswith("profiler.")]
    marks = [op for op in seqs[True] if op.startswith("profiler.")]
    assert len(marks) > 2 * 12
    assert [op for op in seqs[True] if not op.startswith("profiler.")] == \
        seqs[False]
    counts = timer.report()["counts"]
    assert counts["pinc.rebuckets"] > 0 and "pinc.past_margin" in counts


def test_tracing_nests_and_restores():
    """tracing() turns the tracer on or off for its block and restores the
    state before it; report() sums host and device counters; reset()
    forgets them."""
    with timer.tracing(True):
        timer.count("a", 2)
        with timer.tracing(False):
            timer.count("a", 100)
            assert timer.span("x") is timer.span("y")
        timer.count("a")
        timer.count_device("b", torch.tensor([1.0, 2.0]))
        timer.count_device("b", torch.tensor(4.0))
        with timer.span("x"):
            pass
    timer.count("a", 100)
    rep = timer.report()
    assert rep["counts"] == {"a": 3, "b": 7}
    assert rep["spans"]["x"]["calls"] == 1
    assert rep["spans"]["x"]["seconds"] >= 0.0
    timer.reset()
    assert timer.report() == {"spans": {}, "counts": {}}


def test_run_spans_nest_and_count(tmp_path):
    """On, under the profiler, a tiled run(): every step's solve and
    re-buckets lie inside its pinc.step; pinc.margin_hits is the number of
    steps whose margin count was nonzero; pinc.rebuckets the species
    re-bucketed on the schedule plus every species at each margin hit;
    pinc.retunes_changed the retunes that returned True; and the ranges'
    durations in the trace agree with the report's host times."""
    sim = _sim()
    seen = []            # per step: (the cadences it was scheduled by, n_lost)
    step, retune = sim._tiled_step, sim.retune
    changed = []

    def tiled_step(st):
        out = step(st)
        seen.append((list(sim.rebucket_every_s), int(out[4].n_lost)))
        return out

    def counted_retune(*a, **k):
        changed.append(retune(*a, **k))
        return changed[-1]
    sim._tiled_step, sim.retune = tiled_step, counted_retune
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.tracing(True):
            hist = sim.run(progress_every=0)
    rep = timer.report()
    events = _trace(prof, tmp_path)
    S, n = 2, len(seen)
    assert n == 24 and len(hist["step_seconds"]) == n
    hits = sum(lost != 0 for _, lost in seen)
    assert 0 < hits < n
    due = sum(S if lost else sum((k + 1) % R == 0 for R in cad)
              for k, (cad, lost) in enumerate(seen))
    counts = rep["counts"]
    assert counts["pinc.margin_hits"] == hits
    assert counts["pinc.rebuckets"] == due
    assert counts.get("pinc.retunes_changed", 0) == sum(changed)
    spans = rep["spans"]
    assert spans["pinc.step"]["calls"] == n
    assert spans["pinc.solve"]["calls"] == n + 1        # and the half kick
    assert spans["pinc.rebucket"]["calls"] == due
    assert spans["pinc.sync.drops"]["calls"] == due
    assert spans["pinc.sync.margin"]["calls"] == n
    assert spans["pinc.sync.energy"]["calls"] == n
    assert spans["pinc.retune"]["calls"] == len(changed) >= hits
    assert spans["pinc.sync.retune_sample"]["calls"] == len(changed)
    steps = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "pinc.step"]
    assert len(steps) == n

    def inside(e):
        return any(t == e["tid"] and a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for t, a, b in steps)
    for name, k in (("pinc.solve", n), ("pinc.rebucket", due),
                    ("pinc.retune", len(changed)),
                    ("pinc.sync.margin", n)):
        assert sum(inside(e) for e in events if e["name"] == name) == k
    # the report's host times bracket the ranges: they add the ranges'
    # own bookkeeping, up to a millisecond a call on a loaded host
    for name, row in spans.items():
        durs = [e["dur"] for e in events if e["name"] == name]
        assert len(durs) == row["calls"]
        prof_s = sum(durs) * 1e-6
        assert abs(prof_s - row["seconds"]) <= 0.05 * prof_s + \
            1e-3 * row["calls"], name


def test_window_counts_slots_past_margin(monkeypatch):
    """On, a mega scan window: pinc.past_margin is the sum of K5's n_out
    over its steps; off, the same window keeps nothing."""
    sim = _sim()
    assert sim._use_mega
    pic_step, n_out = tk.pic_step, []

    def counted(*a, **k):
        out = pic_step(*a, **k)
        n_out.append(float(out[4].sum()))
        return out
    monkeypatch.setattr(tk, "pic_step", counted)
    run_n = sim.make_scan_steps(16, fresh=True)
    st = run_n(sim.state)[0]
    assert timer.report()["counts"] == {}
    off = sum(n_out)
    n_out.clear()
    with timer.tracing(True):
        run_n(st)
    counts = timer.report()["counts"]
    assert sum(n_out) > 0 and off >= 0
    assert counts["pinc.past_margin"] == round(sum(n_out))
    assert counts["pinc.rebuckets"] == sum(
        len(arg) for kind, arg in run_n.plan if kind == "rebucket")


def test_setup_spans_fire_once(monkeypatch):
    """pinc.setup.bucket and pinc.setup.objects once a simulation;
    pinc.setup.build once a process, at the library's first load."""
    from pinc_tpu_torch.objects import make_sphere
    with timer.tracing(True):
        _sim()
        spans = timer.report()["spans"]
        assert spans["pinc.setup.bucket"]["calls"] == 1
        assert "pinc.setup.objects" not in spans
        timer.reset()
        sim = _sim(SPHERE, domain=make_sphere((16,) * 3, (8, 8, 8), 3))
        spans = timer.report()["spans"]
        assert spans["pinc.setup.bucket"]["calls"] == 1
        assert spans["pinc.setup.objects"]["calls"] == 1
        assert sim.objects.setup["matrix_s"] <= \
            spans["pinc.setup.objects"]["seconds"]

        class Lib:
            def __getattr__(self, name):
                fn = types.SimpleNamespace()
                setattr(self, name, fn)
                return fn
        monkeypatch.setattr(_cuda_build, "_lib", None)
        monkeypatch.setattr(_cuda_build, "build",
                            lambda verbose=False: "libstub.so")
        monkeypatch.setattr(_cuda_build, "ctypes", types.SimpleNamespace(
            CDLL=lambda path: Lib(), c_int=_cuda_build.ctypes.c_int))
        for _ in range(3):
            _cuda_build.load()
        spans = timer.report()["spans"]
    assert spans["pinc.setup.build"]["calls"] == 1


def test_object_run_spans():
    """On, an object deck's run(): pinc.objects once a step and at the
    start's cull, two pinc.solve a step and one for the half kick, and
    the object step's trajectory the same as with the tracer off."""
    from pinc_tpu_torch.objects import make_sphere
    dom = make_sphere((16,) * 3, (8, 8, 8), 3)
    off = _sim(SPHERE, domain=dom).run(progress_every=0)
    sim = _sim(SPHERE, domain=dom)
    with timer.tracing(True):
        on = sim.run(progress_every=0)
    spans = timer.report()["spans"]
    n = len(on["step_seconds"])
    assert spans["pinc.objects"]["calls"] == n + 1
    assert spans["pinc.solve"]["calls"] == 2 * n + 1
    assert spans["pinc.step"]["calls"] == n
    np.testing.assert_array_equal(on["kinetic"], off["kinetic"])
    np.testing.assert_array_equal(on["potential"], off["potential"])
