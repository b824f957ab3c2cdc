"""The benchmark's harness on the CPU at tiny sizes: the reference agrees
with the port, the control and each fault of the timed path come out not
correct, and a configuration, a mix and a per-layer metric added as files
are found by name."""

from __future__ import annotations

import json

import pytest
import torch

from bench_fixture import TINY, TINY_LIMITS, make_tree  # noqa: F401

from benchmarks.harness import run_cell

SEED = 2_400_000_017      # above 2**31, as a run's seed may be


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    return make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_agrees_with_port(tree, cell):
    out = run_cell(tree, cell, SEED, 0.5, False, device="cpu")
    bad = {k: v for k, v in out["check"].items()
           if not v["value"] <= v["limit"]}
    assert out["correct"], bad
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(tree, cell):
    out = run_cell(tree, cell, SEED + 1, 0.5, False, device="cpu",
                   control=True)
    assert not out["correct"]
    failing = [k for k, v in out["check"].items()
               if not v["value"] <= v["limit"]]
    # the control is one precision step lower in every stage it computes;
    # a multigrid's phi is told from it by its residual
    solve = "phi_resid" if "phi_resid" in out["check"] else "phi_err"
    assert {"vel_err", "rho_err", solve, "pos_err"} <= set(failing)


# ------------------------------------------------- slots past the margin
def _planted_state(sim, T, M):
    """The program's bucketed state with 40 electrons of tile 0 moved to
    the far x edge of the layout margin (x = T + M + 0.05, y = z = 4)
    with x velocity 0.15: their stencils reach past the margin before the
    step and after its drift."""
    st = sim.state
    lpos, vel = st.lpos.clone(), st.vel.clone()
    slots = torch.nonzero(st.alive[0, 0] > 0.5).reshape(-1)[:40]
    lpos[0, 0, 0, slots] = T + M + 0.05
    lpos[0, 1:, 0, slots] = 4.0
    vel[0, :, 0, slots] = 0.0
    vel[0, 0, 0, slots] = 0.15
    return type(st)(lpos=lpos, vel=vel, alive=st.alive.clone())


def _one_step(sim, st, entry):
    """c0, c1 of one step of the program from st: the scan entry's
    window of one step (make_scan_steps), or run()'s step."""
    from pinc_tpu_torch.ops import tiled_kernels as tk
    c0 = {"lpos": st.lpos.clone(), "vel": st.vel.clone(),
          "alive": st.alive.clone()}
    if entry == "scan":
        seen, solver, pic_step = [], sim.solver, tk.pic_step

        def solve(rho):
            phi = solver(rho)
            seen.append((rho.clone(), phi.clone()))
            return phi

        def counted(*a, **k):
            out = pic_step(*a, **k)
            seen.append(out[4].clone())
            return out
        sim.solver, tk.pic_step = solve, counted
        try:
            st1, _ = sim.make_scan_steps(1)(st)
        finally:
            sim.solver, tk.pic_step = solver, pic_step
        c0["rho"], c0["phi"] = seen[0]
        c1 = {"lpos": st1.lpos, "vel": st1.vel, "alive": st1.alive,
              "rho": seen[2][0], "phi": seen[2][1], "n_out": seen[1]}
        return c0, c1
    if sim.objects is None:
        st1, rho, phi, E, diag = sim._tiled_step(st)
        extra = {}
    else:
        c0["rho_obj"] = sim._zeros()
        (st1, rho, phi, E, diag, rho_obj,
         obj_phi) = sim._tiled_step_obj(st, c0["rho_obj"])
        extra = {"rho_obj": rho_obj, "obj_phi": obj_phi}
    c1 = dict(lpos=st1.lpos, vel=st1.vel, alive=st1.alive, rho=rho,
              phi=phi, E=E, n_out=diag.n_lost, **extra)
    return c0, c1


@pytest.mark.parametrize("cell", ["tiny16.scan", "tiny16.run",
                                  "tinysphere16.run"])
def test_reference_follows_the_margin_rule(tree, cell):
    """With slots planted past the layout margin, the reference on the
    tiled layout's rule (a stencil node outside [-m, T + m] of the slot's
    tile weighs nothing) agrees with the program's step, count included,
    and the whole CIC stencil does not."""
    from benchmarks import check as chk
    from benchmarks import harness as h
    from benchmarks import reference as ref
    bench = h.Bench(tree)
    wl = bench.workload(cell)
    config, traffic = bench.config(wl["config"]), bench.traffic(wl["traffic"])
    deck = h.merged_deck(config, traffic)
    domain = h.domain_of(config, deck)
    pos, vel = h.make_particles(deck, SEED, "cpu")
    sim = h.make_sim(deck, pos, vel, SEED, "cpu", domain)
    T, M = sim.ts.T, sim.ts.M
    g = chk.Geometry(deck, domain, "cpu", {"margin": M})
    c0, c1 = _one_step(sim, _planted_state(sim, T, M), traffic["entry"])
    margins = [(M, M)] * 2
    assert float(c1["n_out"].sum()) >= 40
    nums = chk.step_numbers(traffic["entry"], g, c0, c1, margins)
    limits = TINY_LIMITS[cell]
    assert all(nums[k] <= limits[k] for k in nums), nums
    whole = ref.deposit(c1["lpos"], c1["alive"], g.charges, g.grid, g.T,
                        ref.weight_dtype(deck))
    keep = torch.ones(whole.shape, dtype=torch.bool)
    if g.surface is not None:
        keep.view(-1)[g.surface] = False
    rho = c1["rho"].double() - c1.get("rho_obj", torch.zeros(())).double()
    assert chk._rel(rho[keep], whole[keep]) > 100 * nums["rho_err"]


# ----------------------------------------------------------------- faults
def _state_unchanged(mp, tk, ex, TiledSimulation, TiledState):
    """Every step hands back the state it took in."""
    pic_step = tk.pic_step

    def frozen_pic_step(E, lpos, vel, *a, **k):
        keep = lpos.clone(), vel.clone()
        out = pic_step(E, lpos, vel, *a, **k)
        lpos.copy_(keep[0])
        vel.copy_(keep[1])
        return out
    mp.setattr(tk, "pic_step", frozen_pic_step)
    for name in ("_tiled_step_fused", "_tiled_step_obj"):
        step = getattr(TiledSimulation, name)

        def frozen(self, st, *a, _step=step):
            keep = TiledState(lpos=st.lpos.clone(), vel=st.vel.clone(),
                              alive=st.alive.clone())
            out = _step(self, st, *a)
            return (keep,) + tuple(out[1:])
        mp.setattr(TiledSimulation, name, frozen)


def _half_batch(mp, tk, ex, TiledSimulation, TiledState):
    """Every deposit keeps the even tiles' density, doubled (the mean over
    the half that is left)."""
    def halve(tiles):
        tiles = tiles.clone()
        tiles[1::2] = 0.0
        tiles[0::2] *= 2.0
        return tiles
    for name, at in (("pic_step", 0), ("deposit_move", 0), ("deposit", None)):
        fn = getattr(tk, name)

        def wrapped(*a, _fn=fn, _at=at, **k):
            out = _fn(*a, **k)
            if _at is None:
                return halve(out)
            return (halve(out[0]),) + tuple(out[1:])
        mp.setattr(tk, name, wrapped)


def _no_exchange(mp, tk, ex, TiledSimulation, TiledState):
    """The re-bucket exchange moves nothing."""
    def none(planes, alive, *a, **k):
        return planes, alive, torch.zeros((), dtype=torch.int64)
    mp.setattr(ex, "rebucket_exchange_planes", none)


def _answer_altered(mp, tk, ex, TiledSimulation, TiledState):
    """The kick alters the velocities of one tile where it produces them."""
    pic_step = tk.pic_step

    def pic(E, lpos, vel, *a, **k):
        out = pic_step(E, lpos, vel, *a, **k)
        vel[0, 0, 0] += 1e-2
        return out
    mp.setattr(tk, "pic_step", pic)
    gather_kick = tk.gather_kick

    def gk(*a, **k):
        nv, vdot = gather_kick(*a, **k)
        nv = nv.clone()
        nv[0, 0] += 1e-2
        return nv, vdot
    mp.setattr(tk, "gather_kick", gk)
    kick_planes = tk.kick_planes

    def kp(vs, Ecs, qm, boris=None):
        outs, vdot = kick_planes(vs, Ecs, qm, boris)
        outs = [outs[0].clone()] + list(outs[1:])
        outs[0][0] += 1e-2
        return outs, vdot
    mp.setattr(tk, "kick_planes", kp)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(tree, monkeypatch, cell, fault):
    from pinc_tpu_torch.ops import exchange as ex
    from pinc_tpu_torch.ops import tiled_kernels as tk
    from pinc_tpu_torch.tiled_sim import TiledSimulation, TiledState
    FAULTS[fault](monkeypatch, tk, ex, TiledSimulation, TiledState)
    out = run_cell(tree, cell, SEED + 2, 0.3, False, device="cpu")
    assert not out["correct"], out["check"]


# ------------------------------------------------- found by name as files
def test_added_files_are_found(tmp_path):
    """A configuration, a mix and a per-layer metric that exist only as new
    files and manifest entries run as a cell."""
    root = make_tree(tmp_path)
    bench = root / "benchmarks"
    cfg = json.loads((bench / "configs" / "tiny16.json").read_text())
    cfg["deck"]["population"]["nParticles"] = "2 pc"
    cfg["deck"]["population"]["nAlloc"] = "2 pc"
    (bench / "configs" / "added16.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny_run.json").read_text())
    mix["chunk_steps"] = 5
    mix["expect"] = {"margin": 1}       # the cadences follow the sample
    (bench / "traffic" / "added_run.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    limits = json.loads((bench / "limits" / "tiny16.run.json").read_text())
    (bench / "limits" / "added16.added.json").write_text(json.dumps(limits))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "added16", "source": "test",
                           "file": "benchmarks/configs/added16.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "added16.added", "config": "added16",
                             "traffic": "added_run", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "steps_traced", "unit": "steps",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "psteps_per_s",
                             "workloads": ["added16.added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = run_cell(root, "added16.added", SEED, 0.2, True, device="cpu")
    assert out["correct"], out["check"]
    assert out["metrics"]["steps_traced"]["value"] == mix["trace_steps"]
    # 2 per cell at 16^3, two species
    assert out["attempted"] % (2 * 2 * 16 ** 3) == 0


@pytest.mark.cuda
def test_cell_on_card():
    """The first cell as benchmarks.run runs it, briefly (on a card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_fixture import REPO
    name = json.loads((REPO / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    out = run_cell(REPO, name, SEED, 1.0, False, device="cuda")
    assert out["correct"], out["check"]
