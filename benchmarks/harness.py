"""The benchmark of ``pinc_tpu_torch``: one cell, one run.

Everything of a cell is found by name under the benchmark's folder:
``configs/<config>.json`` (the deck, its source and cuts, the object),
``traffic/<mix>.json`` (the entry, the deck keys the mix sets, the layout
it expects the program to set up, the window, trace and capture rules),
``metrics/<metric>.py`` (one reader of a per-layer metric each), ``spans/<name>.json`` (a layer entry of the port
to wrap in a ``record_function`` range named ``bench.<name>``),
``limits/<workload>.json`` (the limit of each number ``correct``
compares) and ``work/<part>.py`` (a kernel's or a part's work count).

A run: the particles from the seed on the device, handed to the port in
place of its own initial state; set-up (``TiledSimulation`` on the deck,
the entry's warm-up); the measured window (``--seconds`` of the entry run
back to back); with ``--trace 1`` a traced span of the entry after it;
then, with the program's peak memory read, one more stretch of the same
entry on the same object, whose steps, one re-bucket and the start are
captured and judged by the plain reference (``check.py``).  A traced run
turns the program's tracer on over set-up and over the traced span alone,
and hands its reports to the per-layer readers (``ctx.program_setup``,
``ctx.program``, ``ctx.program_pass``); the window and the capture run
with it off, as every untraced run does throughout.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from . import check as chk
from . import reference as ref
from . import trace as tr
from .program_pass import program_pass

FORBIDDEN = ("jax", "jaxlib", "flax", "pinc_tpu")


class Bench:
    """The manifest and the files under the benchmark's folder."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmarks"

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> Dict[str, float]:
        return {k: float(v) for k, v in
                self._json("limits", workload)["limits"].items()}

    def spans(self) -> Dict[str, str]:
        return {f"bench.{p.stem}": json.loads(p.read_text())["attr"]
                for p in sorted((self.dir / "spans").glob("*.json"))}

    def module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmarks_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, workload: str, section: str):
        """The metrics of ``section`` (end_to_end or per_layer) that this
        workload reports."""
        return [m for m in self.manifest[section]
                if "workloads" not in m or workload in m["workloads"]]

    def peaks(self, kind: str) -> Optional[dict]:
        return json.loads((self.dir / "peaks.json").read_text())[
            "cards"].get(kind)


def merged_deck(config: dict, traffic: dict) -> Dict[str, Dict[str, str]]:
    deck = {sec: dict(keys) for sec, keys in config["deck"].items()}
    for sec, keys in traffic.get("deck", {}).items():
        deck.setdefault(sec, {}).update(keys)
    return deck


def deck_text(deck: Dict[str, Dict[str, str]]) -> str:
    return "".join(f"[{sec}]\n" + "".join(f"{k} = {v}\n"
                                           for k, v in keys.items())
                   for sec, keys in deck.items())


def make_particles(deck, seed: int, device):
    """Per species (S, N, 3) float32 positions, uniform in the box, and
    velocities, Maxwellian at the deck's thermal velocity (cells a step),
    from one generator on the device seeded with ``seed``."""
    L = [int(v) for v in deck["grid"]["trueSize"].split(",")]
    pop = deck["population"]
    S = int(pop["nSpecies"])
    N = int(ref.per_cell(pop["nParticles"]) * math.prod(L))
    vth = [float(v) for v in pop["thermalVelocity"].split(",")]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    box = torch.tensor(L, dtype=torch.float32, device=device)
    pos = torch.rand((S, N, 3), generator=gen, device=device) * box
    vel = torch.randn((S, N, 3), generator=gen, device=device)
    vel *= torch.tensor(vth, device=device)[:, None, None]
    return pos, vel


def domain_of(config: dict, deck) -> Optional[np.ndarray]:
    obj = config.get("object")
    if not obj:
        return None
    if obj["kind"] != "sphere":
        raise ValueError(f"unknown object kind {obj['kind']!r}")
    L = [int(v) for v in deck["grid"]["trueSize"].split(",")]
    return ref.sphere_domain(L, obj["center"], obj["radius"])


def make_sim(deck, pos, vel, seed: int, device, domain):
    """The port's TiledSimulation on the deck, its initial particles the
    given ones: the program buckets them (TiledSimulation._bucket_all)
    where it would have made its own."""
    from pinc_tpu_torch.config import PincConfig
    from pinc_tpu_torch.population import Particles
    from pinc_tpu_torch.tiled_sim import TiledSimulation

    cell = torch.floor(pos)
    given = [Particles(cell=cell.to(torch.int32), frac=pos - cell, vel=vel,
                       alive=torch.ones(pos.shape[:2], dtype=torch.bool,
                                        device=pos.device))]
    del cell

    class Seeded(TiledSimulation):
        def _bucket_all(self, p):
            return super()._bucket_all(given[0])

        def _bucket_all_generate(self, seed_):
            return super()._bucket_all(given[0])

    cfg = PincConfig.from_string(deck_text(deck))
    try:
        return Seeded(cfg, seed=int(seed) % (1 << 31), device=device,
                      domain=domain)
    finally:
        given.clear()


def _tracing(on: bool):
    """The program's tracer (``pinc_tpu_torch.utils.timer``) on over the
    block where ``on``; else nothing, the tracer left off."""
    if not on:
        return contextlib.nullcontext()
    from pinc_tpu_torch.utils import timer
    return timer.tracing(True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _alive_count(st) -> int:
    """Alive slots of a tiled state (a host sync)."""
    return int((st.alive > 0.5).sum())


def _seeded(seed: int, n: int) -> int:
    return int(np.random.default_rng(int(seed) % (1 << 63)).integers(n))


# ------------------------------------------------------------------ entries
class ScanEntry:
    """make_scan_steps(W, donate=True, fresh=True), the windows run back to
    back; retune (and a rebuilt window) only after drops."""

    def __init__(self, sim, traffic):
        self.sim, self.traffic = sim, traffic
        Rs = sim.rebucket_every_s
        W = traffic["window"]
        self.W = max(Rs) if W == "slow_cadence" else int(W)
        self.run_n = sim.make_scan_steps(self.W, donate=True, fresh=True)
        self.st = sim.state
        sim.state = None
        self.nonfinite = 0

    def advance(self):
        """One window.  Returns (steps, particle-steps, drops)."""
        n_alive = _alive_count(self.st)
        self.st, (ke, pe, dropped) = self.run_n(self.st)
        d = int(dropped)
        self.nonfinite += int((~torch.isfinite(ke)).sum()
                              + (~torch.isfinite(pe)).sum())
        if d and self.sim.retune(self.st, drops=d):
            self.run_n = self.sim.make_scan_steps(self.W, donate=True,
                                                  fresh=True)
        return self.W, self.W * n_alive, d

    def warmup(self):
        self.advance()

    def traced(self):
        """trace_windows windows; returns their steps."""
        n = int(self.traffic["trace_windows"])
        for _ in range(n):
            self.advance()
        return n * self.W

    def capture(self, seed, on_step, hook):
        """One more window with the solver, K5 (for its count of slots past
        the margin) and the re-bucket events wrapped.  Step j, drawn from
        the seed among the window's steps, is judged: on_step(0, c0) with
        the state it took in (after any re-bucket before it) and the field
        of the solve before it, then on_step(1, c1) with the state, rho,
        phi and count it gave out; hook (a _RebucketHook) judges each
        species' first re-bucket after it.  Returns (j, the window's
        steps, the program's working margins (mg, md) of each species at
        step j)."""
        from pinc_tpu_torch.ops import tiled_kernels as tk
        plan = self.run_n.plan
        margins = [arg for kind, arg in plan if kind == "step"]
        j = 1 + _seeded(seed, len(margins))
        sim, solver, event = self.sim, self.sim.solver, \
            self.sim._rebucket_event
        pic_step = tk.pic_step
        state = {"i": 0, "c0": None, "n_out": None}

        def counted_pic_step(*a, **k):
            out = pic_step(*a, **k)
            state["n_out"] = out[4].clone()
            return out

        def solve(rho):
            phi = solver(rho)
            i = state["i"]
            state["i"] += 1
            if i == j - 1:
                state["c0"] = _capture(self.st, rho, phi)
            elif i == j:
                c1 = _capture(self.st, rho, phi)
                c1["n_out"] = state["n_out"]
                on_step(0, state["c0"])
                on_step(1, c1)
            return phi

        def rebucket_event(st, species):
            hook.event(species, armed=state["i"] > j)
            out = event(st, species)
            if state["i"] == j:         # between the solves of j-1 and j
                c0 = state["c0"]
                c0.update(_capture(st, c0["rho"], c0["phi"]))
            return out
        sim.solver = solve
        sim._rebucket_event = rebucket_event
        tk.pic_step = counted_pic_step
        hook.attach(sim)
        try:
            for _ in range(4):          # on to each species' re-bucket
                self.advance()
                if hook.done:
                    break
        finally:
            sim.solver = solver
            tk.pic_step = pic_step
            del sim._rebucket_event
            hook.close()
        return j, len(margins), margins[j - 1]

    def release(self):
        self.st = self.run_n = None


class RunEntry:
    """TiledSimulation.run(), continued in chunks through resume()."""

    def __init__(self, sim, traffic):
        self.sim, self.traffic = sim, traffic
        self.step = 0
        self.step_seconds = []
        self.objects = sim.objects is not None
        self.nonfinite = 0
        self.lost = 0

    def _chunk(self, n: int, writer=None):
        sim = self.sim
        if self.step:
            sim.resume(self.step, sim.state, sim.tuning(),
                       sim.rho_obj if self.objects else None)
        a0 = _alive_count(sim.state) if self.step else None
        sim.n_time_steps = self.step + n
        hist = sim.run(writer=writer)
        a1 = _alive_count(sim.state)
        self.nonfinite += int((~np.isfinite(hist["kinetic"])).sum()
                              + (~np.isfinite(hist["potential"])).sum())
        self.lost += int(hist["n_lost"])
        self.step += n
        a0 = a1 if a0 is None else a0
        return n, n * (a0 + a1) / 2.0, int(hist["dropped"]), hist

    def warmup(self):
        self._chunk(int(self.traffic["warmup_steps"]))

    def advance(self):
        n, ps, d, hist = self._chunk(int(self.traffic["chunk_steps"]))
        self.step_seconds.extend(hist["step_seconds"].tolist())
        return n, ps, d

    def traced(self):
        """trace_steps more steps; returns them."""
        return self._chunk(int(self.traffic["trace_steps"]))[0]

    def capture(self, seed, on_step, hook):
        """Some more steps with TiledSimulation._write (run() calls it
        after each step when given a writer) and _rebucket wrapped.  Step
        j, drawn from the seed among the next capture_steps, is judged:
        on_step(0, c0) with the state written after step j - 1,
        on_step(1, c1) with the state of step j before any re-bucket of it,
        the fields written after it and its count of slots past the
        margin; hook (a _RebucketHook) judges each species' first
        re-bucket after that.  Returns (j, None, None): the steps run at
        the layout margin."""
        sim = self.sim
        C = int(self.traffic["capture_steps"])
        j = self.step + 2 + _seeded(seed, C - 1)
        state = {"n": None, "c0": None, "c1": None}
        inner_rebucket = sim._rebucket

        def rebucket(st, species=None):
            if state["n"] == j - 1 and state["c1"] is None:
                state["c1"] = _capture(st)
            species = range(st.lpos.shape[0]) if species is None \
                else species
            hook.event(species, armed=state["c1"] is not None)
            return inner_rebucket(st, species)

        def write(writer, n, st, fields, diag, ke, pe, rho_obj=None,
                  obj_phi=None):
            state["n"] = n
            if n == j - 1:
                state["c0"] = _capture(st, *fields, rho_obj, obj_phi)
            elif n == j:
                c1 = _capture(st, *fields, rho_obj, obj_phi)
                if state["c1"] is not None:       # re-bucketed in step j
                    for key in ("lpos", "vel", "alive"):
                        c1[key] = state["c1"][key]
                c1["n_out"] = diag.n_lost.clone()
                state["c1"] = c1
                on_step(0, state["c0"])
                on_step(1, c1)
        sim._write, sim._rebucket = write, rebucket
        hook.attach(sim)
        # run to step j, then on to each species' first re-bucket after it
        # (its scheduled one, unless a margin hit comes first)
        try:
            self._chunk(j - self.step, writer=object())
            for _ in range(16):
                if hook.done:
                    break
                Rs = sim.rebucket_every_s
                due = min((self.step // Rs[s] + 1) * Rs[s]
                          for s in hook.todo)
                self._chunk(due - self.step, writer=object())
        finally:
            del sim._write, sim._rebucket
            hook.close()
        return j, None, None

    def release(self):
        pass


ENTRIES = {"scan": ScanEntry, "run": RunEntry}


def _capture(st, rho=None, phi=None, E=None, rho_obj=None,
             obj_phi=None) -> dict:
    """Copies of a tiled state and of the step's fields given."""
    out = {"lpos": st.lpos.clone(), "vel": st.vel.clone(),
           "alive": st.alive.clone()}
    if rho is not None:
        out["rho"] = rho.clone()
    if phi is not None:
        out["phi"] = phi.clone()
    if E is not None:
        out["E"] = E.clone()
    if rho_obj is not None:
        out["rho_obj"] = rho_obj.clone()
    if obj_phi is not None:
        out["obj_phi"] = obj_phi.clone()
    return out


class _RebucketHook:
    """Wraps sim._rebucket_one for the capture: each species' first
    re-bucket once the judged step is past is handed to judge(s, lpos,
    vel, alive, call), call() running the program's.  The entry's event
    wrapper tells it, before each event, the species in the order the
    event re-buckets them and whether it is armed."""

    def __init__(self, n_species: int, judge):
        self.todo = set(range(n_species))
        self.judge = judge
        self.order, self.armed = [], False
        self.sim = None

    @property
    def done(self) -> bool:
        return not self.todo

    def event(self, species, armed: bool):
        self.order, self.armed = list(species), armed

    def attach(self, sim):
        self.sim = sim
        inner = sim._rebucket_one

        def wrapped(lpos_s, vel_s, alive_s, *a, **k):
            s = self.order.pop(0) if self.order else None
            call = lambda: inner(lpos_s, vel_s, alive_s, *a, **k)  # noqa
            if not self.armed or s not in self.todo:
                return call()
            self.todo.discard(s)
            return self.judge(s, lpos_s, vel_s, alive_s, call)
        sim._rebucket_one = wrapped

    def close(self):
        del self.sim._rebucket_one


def _layout_off(sim, expect: dict) -> int:
    """How many of the layout's margin, cadences, bucket size and face cap,
    as the program set them up, differ from those the mix states."""
    got = {"margin": sim.ts.M, "cadences": list(sim.rebucket_every_s),
           "bucket": sim.ts.B, "face_cap": sim._exchange_cap}
    return sum(got[k] != v for k, v in expect.items())


def _escapes(caps, T: int, margins) -> str:
    """Alive slots, per species, whose CIC stencil reaches past the working
    margins of the judged step (x < -m or x > T + m): the gather's (mg) at
    the positions it took in, the deposit's (md) at those it gave out."""
    S = caps[0]["lpos"].shape[0]
    out = []
    for name, c, k in (("gather", caps[0], 0), ("deposit", caps[1], 1)):
        n = []
        for s in range(S):
            m = float(margins[s][k])
            x = c["lpos"][s]
            bad = ((x < -m) | (x > T + m)).any(dim=0) & (c["alive"][s]
                                                         > 0.5)
            n.append(int(bad.sum()))
        out.append(f"{name} past its margins {n}")
    return f"margins {list(margins)}, " + ", ".join(out)


def _range_ms(summary, name: str):
    """Device ms a traced step launched inside the range ``name``;
    nothing where nothing was traced or the range never opened."""
    if summary is None or not summary.steps \
            or not summary.range_calls.get(name):
        return None
    return summary.range_s[name] / summary.steps * 1e3


# ---------------------------------------------------------------- one cell
def log(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", control: bool = False,
             t_start: float = None) -> dict:
    """Run one cell once; returns the result line (a dict).  t_start: the
    process's start on the monotonic clock (default: now)."""
    t_start = time.monotonic() if t_start is None else t_start
    bench = Bench(root)
    wl = bench.workload(workload)
    config = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    deck = merged_deck(config, traffic)
    limits = bench.limits(workload)
    dev = torch.device(device)
    domain = domain_of(config, deck)
    expect = traffic.get("expect", {})
    geo = chk.Geometry(deck, domain, dev, expect)
    excluded = 0.0           # the reference's share of set-up, left out

    pos, vel = make_particles(deck, seed, dev)
    t0 = time.monotonic()
    start_ref = [ref.bucketed_fingerprints(pos[s], vel[s], geo.grid, geo.T)
                 for s in range(pos.shape[0])]
    sync(dev)
    excluded += time.monotonic() - t0
    # a traced run keeps the program's tracer report of set-up; an
    # untraced one leaves the tracer off throughout
    if trace:
        from pinc_tpu_torch.utils import timer
        timer.reset()
    with _tracing(trace):
        sim = make_sim(deck, pos, vel, seed, dev, domain)
    del pos, vel
    t0 = time.monotonic()
    st = sim.state
    start_off = sum(int((ref.layout_fingerprints(st.lpos[s], st.vel[s],
                                                 st.alive[s])
                         != start_ref[s]).sum())
                    for s in range(st.lpos.shape[0]))
    del start_ref, st
    sync(dev)
    excluded += time.monotonic() - t0
    layout_off = _layout_off(sim, expect)
    log(f"layout: M = {sim.ts.M}, B = {sim.ts.B}, cadences "
        f"{sim.rebucket_every_s}, face cap {sim._exchange_cap} (the mix "
        f"expects {expect})")

    with _tracing(trace):
        entry = ENTRIES[traffic["entry"]](sim, traffic)
        entry.warmup()
    sync(dev)
    gc.collect()
    setup_s = time.monotonic() - t_start - excluded
    program_setup = timer.report() if trace else None

    # the measured window; the peak memory is the program's over it (the
    # benchmark's own copy of the initial particles is gone by now)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = psteps = drops = 0
    t0 = time.monotonic()
    while True:
        n, ps, d = entry.advance()
        steps, psteps, drops = steps + n, psteps + ps, drops + d
        if time.monotonic() - t0 >= seconds:
            break
    sync(dev)
    wall = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"window: {steps} steps, {psteps:.0f} particle-steps, "
        f"{wall:.3f} s, {drops} dropped")

    summary = program = passed = None
    if trace:
        span_attrs = bench.spans()
        box = {}
        timer.reset()
        with tr.spans(sim, span_attrs), _tracing(True):
            summary = tr.profile(lambda: box.setdefault("n", entry.traced()),
                                 list(span_attrs))
        summary.steps = box["n"]
        program = timer.report()
        timer.reset()
        passed = program_pass(summary.events)
        summary.events = None

    # the check: one more stretch of the entry, captured
    step_seconds = np.asarray(getattr(entry, "step_seconds", []) or [])
    nonfinite = entry.nonfinite
    ts, n_species = sim.ts, len(sim.rebucket_every_s)
    caps, rb = {}, {}

    def on_step(j, cap):
        caps[j] = cap

    def judge_rebucket(s, lpos_s, vel_s, alive_s, call):
        fp_ref = ref.rebucketed_fingerprints(lpos_s, vel_s, alive_s,
                                             geo.grid, geo.T)
        fp_ctl = ref.rebucketed_fingerprints(
            lpos_s, vel_s, alive_s, geo.grid, geo.T,
            sdt=ref.state_dtype("control"))
        out = call()
        fp_prog = ref.layout_fingerprints(lpos_s, vel_s, alive_s)
        rb[s] = {"prog": int((fp_prog != fp_ref).sum()) + int(out),
                 "control": int((fp_ctl != fp_ref).sum())}
        return out
    hook = _RebucketHook(n_species, judge_rebucket)
    lost = getattr(entry, "lost", None)
    j, n_window, prog_margins = entry.capture(seed, on_step, hook)
    entry.release()
    del entry, sim
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    margins = geo.step_margins(traffic["entry"], n_window, j)
    numbers = {"start_tiles_off": float(start_off),
               "layout_off": float(layout_off),
               "window_drops": float(drops),
               "window_nonfinite": float(nonfinite),
               "margins_off": float(0 if prog_margins is None else sum(
                   tuple(p) != tuple(m)
                   for p, m in zip(prog_margins, margins)))}
    judged = {"step": j, "past_margin": float(caps[1]["n_out"].sum())}
    log(f"judged step {j}: {_escapes(caps, ts.T, margins)}; the program "
        f"counted {judged['past_margin']:.0f} past the margin; "
        f"margin hits in run()'s chunks: {lost}; re-buckets judged "
        f"{sorted(rb)}")
    c1 = caps[1]
    if control:
        c1 = chk.control_step(traffic["entry"], geo, caps[0], margins)
    numbers.update(chk.step_numbers(traffic["entry"], geo, caps[0], c1,
                                    margins))
    side = "control" if control else "prog"
    numbers["rebucket_tiles_off"] = float(
        sum(r[side] for r in rb.values()) + n_species - len(rb))
    del caps, c1
    verdict = chk.judge(numbers, limits)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = SimpleNamespace(
        trace=summary, step_seconds=step_seconds, ts=ts,
        n_species=n_species, e_bytes=ref.weight_dtype(deck).itemsize,
        peaks=bench.peaks(kind), work=lambda n: bench.module("work", n),
        psteps=psteps, wall=wall, setup_s=setup_s, steps=steps,
        range_ms_per_step=lambda name: _range_ms(summary, name),
        program_setup=program_setup, program=program, program_pass=passed)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(workload, section):
        v = bench.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(verdict["ok"]), "attempted": int(psteps),
           "failed": int(drops), "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in summary.ops],
                            "idle_gaps": [list(x) for x in passed["gaps"]]}
    out["judged"] = judged
    out["check"] = verdict["table"]
    return out
