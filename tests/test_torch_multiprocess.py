"""Runs over several processes (utils/multihost.py, a mesh whose shards span
processes): two gloo processes, spawned with a FileStore, run the decks of
tests/multiprocess_cases.py in turn, one process a block of the shards;
each case is held bit for bit to the port's single-process mesh over
``["cpu"] * n`` (which tests/test_torch_parallel.py,
tests/test_torch_tiled_sharded.py and the sharded object tests hold to
pinc_tpu's sharded classes).  The join has a deadline past which the processes are killed.

* (a) the tiled 16^3-a-shard deck over (2, 1, 1), one shard a process,
  and (b) over (2, 2, 1), two shards a process: run() (re-buckets, the
  margin count, the drops), a window from its state, one step's rho and
  phi, the gathered state; (a)'s run() also against pinc_tpu's sharded
  window (KE within 1e-4, PE within 1e-3: tests/test_torch_tiled_sharded.py's
  tolerances).
* (c) a flat (1, 2, 2) deck with mgSolve through the sharded multigrid:
  energies, the cycles of every solve, the population, rho and phi; also
  against pinc_tpu's sharded run (KE 1e-4, PE 1e-3:
  tests/test_torch_parallel.py's); and mgMode through the CLI, its timer
  file written once.  (b) and (c) run the methods:debug guards, which
  read the gathered state on every process.
* (d) the pencil FFT: a solve and two steps of a deck that solves with it.
* (e) the sphere deck on the flat (absorb) and the tiled layout (ions
  emitting electrons): energies, rho_obj, phi_c, the state.
* (f) the CLI's output over 2 processes, tiled and flat with files:async:
  the grids and history from process 0 only, pop.p0 and pop.p1, whose
  particles together are the single-process pop file's, as a multiset, at
  each step.
* (g) a checkpoint written once by process 0, equal to the single-process
  one, and a resume over 2 processes equal to the uninterrupted run.
* A process that leaves while the other enters a collective: the
  collective fails, in well under the deadline.
"""

import time

import h5py
import numpy as np
import pytest
import torch

import multiprocess_cases as mc
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.parallel.pic import ShardedSimulation as JSharded
from pinc_tpu.parallel.tiled_pic import \
    ShardedTiledSimulation as JShardedTiled
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.parallel.pic import make_simulation

DEADLINE_S = 240.0
NUMERIC = ["tiled_211", "tiled_221", "flat_mg", "mgmode", "pencil",
           "objects_flat", "objects_tiled", "checkpoint"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    """The two processes' results, the single-process mesh's, and
    pinc_tpu's for (a) and (c), computed while the processes run."""
    tmp = tmp_path_factory.mktemp("multiprocess")
    multi = tmp / "multi"
    procs = mc.spawn(multi, list(mc.CASES))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {name: fn(tmp / "ref" / name)
                for name, fn in mc.CASES.items()}
        # the uninterrupted run that (g) resumes into
        refs["uninterrupted"] = mc._hist(make_simulation(
            PincConfig.from_string(mc.tiled_deck(
                "2,1,1", "16,16,16", steps=mc.STEPS + 2)),
            seed=7, device="cpu").run(progress_every=0))
        j = JShardedTiled(JConfig.from_string(mc.tiled_deck(
            "2,1,1", "16,16,16")), seed=7, devices=cpu_devices[:2])
        _, (ke, pe, dropped) = j.make_scan_steps(mc.STEPS)(j.state)
        jtiled = dict(ke=np.asarray(ke), pe=np.asarray(pe),
                      dropped=int(dropped))
        jflat = JSharded(JConfig.from_string(mc.flat_deck(
            "1,2,2", "16,8,8", solver="mgSolve")), seed=3,
            devices=cpu_devices[:4]).run(progress_every=0)
    finally:
        torch.set_num_threads(n)
        t0 = time.monotonic()
        codes = mc.join(procs, DEADLINE_S)
    errors = [p.read_text() for p in sorted(multi.glob("error.r*.txt"))]
    return dict(tmp=tmp, multi=multi, codes=codes, errors=errors,
                refs=refs, jtiled=jtiled, jflat=jflat,
                join_s=time.monotonic() - t0)


def _got(runs, name):
    return [mc.load(runs["multi"], name, r) for r in range(mc.WORLD)]


def test_processes_finish(runs):
    assert runs["codes"] == [0] * mc.WORLD, runs["errors"]
    assert not runs["errors"]


@pytest.mark.parametrize("name", NUMERIC)
def test_equals_single_process_mesh(runs, name):
    """Every number of the case, on both processes, bit for bit."""
    ref = runs["refs"][name]
    for got in _got(runs, name):
        for k, want in ref.items():
            if k.startswith("proc_"):
                continue
            np.testing.assert_array_equal(got[k], np.asarray(want),
                                          err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name,held", [("tiled_211", 1), ("tiled_221", 2)])
def test_each_process_holds_its_block(runs, name, held):
    assert runs["refs"][name]["proc_held"] == mc.WORLD * held
    assert [int(g["proc_held"]) for g in _got(runs, name)] == [held] * 2


def _close(ke_ref, pe_ref, ke, pe, ke_tol=1e-4, pe_tol=1e-3):
    ke_ref, ke = np.asarray(ke_ref).sum(-1), np.asarray(ke).sum(-1)
    assert np.abs(ke - ke_ref).max() / np.abs(ke_ref).max() < ke_tol
    pe_ref, pe = np.asarray(pe_ref), np.asarray(pe)
    assert np.abs(pe - pe_ref).max() / np.abs(pe_ref).max() < pe_tol


def test_tiled_matches_pinc_tpu(runs):
    """(a)'s run() over two processes against pinc_tpu's sharded window
    (run()'s step is the window's step)."""
    j = runs["jtiled"]
    for got in _got(runs, "tiled_211"):
        assert int(got["dropped"]) == j["dropped"] == 0
        _close(j["ke"], j["pe"], got["ke"][1:], got["pe"][1:])


def test_flat_multigrid_matches_pinc_tpu(runs):
    j = runs["jflat"]
    for got in _got(runs, "flat_mg"):
        _close(j["kinetic"], j["potential"], got["ke"], got["pe"])
        assert got["cycles"].size == mc.STEPS + 2      # the half kick too
        assert int(got["alive"].sum()) == 2 * 8 * 16 ** 3


def test_mgmode_timer_file_once(runs):
    """mgMode over two processes wrote the one timer file, the single
    process's dataset for dataset."""
    out = runs["multi"] / "mgmode" / "out"
    ref = runs["tmp"] / "ref" / "mgmode" / "out"
    assert _files(out) == _files(ref) == ["run_timer.xy.h5"]
    a, b = (_datasets(d / "run_timer.xy.h5") for d in (ref, out))
    assert sorted(a) == sorted(b) == ["cycles", "time"]
    np.testing.assert_array_equal(a["cycles"], b["cycles"])
    assert a["time"].shape == b["time"].shape == (1, 2)


def test_multigrid_cycles_every_solve(runs):
    ref = runs["refs"]["flat_mg"]["cycles"]
    assert ref.min() >= 1
    for got in _got(runs, "flat_mg"):
        np.testing.assert_array_equal(got["cycles"], ref)


def _files(d):
    return sorted(p.name for p in d.iterdir())


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
        out.update({f"attr:{k}": v for k, v in f.attrs.items()})
    return out


def _rows(pop: dict, s: int, n: float) -> np.ndarray:
    """A step's (pos, vel) rows of species s, sorted (a multiset)."""
    rows = np.concatenate([pop[f"pos/specie {s}/n={n:.1f}"],
                           pop[f"vel/specie {s}/n={n - 0.5:.1f}"]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("name", ["output", "output_async"])
def test_output_over_processes(runs, name):
    """Process 0's grids and history equal the single process's; pop.p0
    and pop.p1 together hold its population at every written step."""
    out = runs["multi"] / name / "out"
    ref = runs["tmp"] / "ref" / name / "out"
    want = _files(ref)
    # a file of each process in place of the single process's population
    # (and of its spool, each process spooling its own particles)
    per_process = {"run_pop.pop.h5", "run_snapshots.spool"} & set(want)
    assert _files(out) == sorted(
        set(want) - per_process
        | {f.replace("pop.pop", f"pop.p{r}.pop").replace(
            "snapshots.spool", f"snapshots.p{r}.spool")
           for f in per_process for r in range(2)})
    assert ("run_snapshots.spool" in want) == (name == "output_async")
    for f in want:
        if f not in per_process:
            a, b = _datasets(ref / f), _datasets(out / f)
            assert sorted(a) == sorted(b), f
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pop = _datasets(ref / "run_pop.pop.h5")
    parts = [_datasets(out / f"run_pop.p{r}.pop.h5") for r in range(2)]
    steps = sorted({float(k.split("n=")[1]) for k in pop
                    if k.startswith("pos/")})
    assert steps == [0.0, 2.0, 4.0]
    for s in range(2):
        for n in steps:
            both = np.concatenate([_rows(p, s, n) for p in parts])
            np.testing.assert_array_equal(
                both[np.lexsort(both.T[::-1])], _rows(pop, s, n))
    assert all(len(p) > 2 for p in parts)       # each wrote its particles


def test_checkpoint_once_and_resume(runs):
    """Process 0 wrote the one checkpoint (the single process's, dataset
    for dataset); the resume over two processes continued from step 4 into
    the uninterrupted run's steps 5 and 6."""
    d, ref = runs["multi"] / "checkpoint", runs["tmp"] / "ref" / "checkpoint"
    assert _files(d) == _files(ref) == ["run_checkpoint.chk.h5"]
    a, b = (_datasets(p / "run_checkpoint.chk.h5") for p in (ref, d))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    full = runs["refs"]["uninterrupted"]
    for got in _got(runs, "checkpoint"):
        assert int(got["start"]) == mc.STEPS
        np.testing.assert_array_equal(got["ke"], full["ke"][-2:])
        np.testing.assert_array_equal(got["pe"], full["pe"][-2:])


def test_mismatched_collective_fails(runs):
    """The mismatch ran last: process 1 left, and process 0's collective
    raised instead of waiting for it."""
    got = mc.load(runs["multi"], "mismatch", 0)
    assert "error" in got and float(got["seconds"]) < mc.TIMEOUT_S
    assert runs["join_s"] < DEADLINE_S
