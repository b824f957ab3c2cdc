"""The field solve is judged against the reference's solve of the deck's own
method: the 7-point stencil's exact solve for the multigrid, which a sound
multigrid cell meets and a multigrid cut short, a spectral solve in its
place or a shifted phi do not; the continuum spectral solve, as before,
for sSolve; and a deck the reference cannot judge is refused before its
particles are made."""

from __future__ import annotations

import json

import pytest
import torch

from bench_fixture import make_tree  # noqa: F401

from benchmarks import check as chk
from benchmarks import harness as h
from benchmarks import reference as ref

SEED = 2_400_000_031


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    return make_tree(tmp_path_factory.mktemp("bench"))


def test_solve_fd_meets_the_stencil():
    """The 7-point Laplacian of solve_fd(rho) is -rho, rho's mean taken out,
    to 1e-10, and its mean is zero."""
    gen = torch.Generator().manual_seed(7)
    rho = torch.randn((8, 8, 8), generator=gen, dtype=torch.float64)
    rho -= rho.mean()
    phi = ref.solve_fd(rho)
    lap = sum(torch.roll(phi, 1, d) + torch.roll(phi, -1, d)
              for d in range(3)) - 6.0 * phi
    assert chk._rel(lap, -rho) < 1e-10
    assert abs(float(phi.mean())) < 1e-12 * float(phi.abs().max())
    assert ref.fd_residual(phi, rho) < 1e-12
    # it is not the continuum solve: the two differ at every size
    assert chk._rel(ref.solve(rho), phi) > 1e-2


def _one_cycle(mp, mg):
    solve = mg.MultigridSolver.solve_with_stats

    def once(self, rho, phi0=None):
        self.max_cycles = 1
        return solve(self, rho, phi0)
    mp.setattr(mg.MultigridSolver, "solve_with_stats", once)


def _spectral(mp, mg):
    def spectral(self, rho, phi0=None):
        phi = ref.solve(rho.double()).to(rho.dtype)
        return phi, 1, torch.zeros((), device=rho.device)
    mp.setattr(mg.MultigridSolver, "solve_with_stats", spectral)


def _shifted(mp, mg):
    finish = mg.MultigridSolver._finish

    def shifted(self, phi):
        phi = finish(self, phi)
        return phi + 0.01 * phi.abs().max()
    mp.setattr(mg.MultigridSolver, "_finish", shifted)


SOLVE_FAULTS = {"one_cycle": _one_cycle, "spectral": _spectral,
                "shifted": _shifted}


@pytest.mark.parametrize("fault", sorted(SOLVE_FAULTS))
def test_multigrid_fault_is_not_correct(tree, monkeypatch, fault):
    """A multigrid cut to one V-cycle, the spectral solve in its place, and
    phi shifted by a constant (1% of its largest value) each fail the
    solve's numbers."""
    from pinc_tpu_torch.solvers import multigrid as mg
    SOLVE_FAULTS[fault](monkeypatch, mg)
    out = h.run_cell(tree, "tinymg16.run", SEED, 0.3, False, device="cpu")
    assert not out["correct"]
    failing = {k for k, v in out["check"].items()
               if not v["value"] <= v["limit"]}
    assert failing & {"phi_resid", "phi_mean"}, out["check"]


@pytest.mark.parametrize("cell", ["tiny16.scan", "tiny16.run",
                                  "tinysphere16.run"])
def test_spectral_cells_judged_as_before(tree, monkeypatch, cell):
    """An sSolve cell's solve is the continuum spectral one, its phi_err
    that of ref.solve to the last bit, and it has no residual number."""
    seen = []
    numbers = chk.step_numbers

    def spied(entry, g, c0, c1, margins):
        seen.append((g, c1))
        return numbers(entry, g, c0, c1, margins)
    monkeypatch.setattr(chk, "step_numbers", spied)
    out = h.run_cell(tree, cell, SEED, 0.2, False, device="cpu")
    g, c1 = seen[0]
    assert g.solve is ref.solve and "phi_resid" not in out["check"]
    assert out["check"]["phi_err"]["value"] == \
        chk._rel(c1["phi"], ref.solve(c1["rho"].double()))


def _refused(tree, name, edit):
    """A copy of tiny16 edited by edit(deck), as a cell of the tree."""
    bench = tree / "benchmarks"
    cfg = json.loads((bench / "configs" / "tiny16.json").read_text())
    edit(cfg["deck"])
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{name}.run.json").write_text(
        (bench / "limits" / "tiny16.run.json").read_text())
    man = json.loads((tree / "BENCHMARK.json").read_text())
    if not any(w["name"] == f"{name}.run" for w in man["workloads"]):
        man["workloads"].append({"name": f"{name}.run", "config": name,
                                 "traffic": "tiny_run", "chips": 1,
                                 "why": "test"})
        (tree / "BENCHMARK.json").write_text(json.dumps(man))
    return f"{name}.run"


def _bounded(deck):
    deck["grid"]["boundaries"] = ("DIRICHLET,PERIODIC,PERIODIC,"
                                  "DIRICHLET,PERIODIC,PERIODIC")


def _unknown_method(deck):
    deck["methods"]["poisson"] = "spectralFD"


@pytest.mark.parametrize("edit,key", [(_bounded, "grid:boundaries"),
                                      (_unknown_method, "methods:poisson")])
def test_unjudgeable_deck_refused(tree, monkeypatch, edit, key):
    """A bounded deck, and one whose Poisson method the reference has no
    solve of, raise naming the key before any particle is made."""
    cell = _refused(tree, f"refused_{edit.__name__.strip('_')}", edit)

    def made(*a, **k):
        raise AssertionError("particles made for a deck that is refused")
    monkeypatch.setattr(h, "make_particles", made)
    with pytest.raises(ValueError, match=key):
        h.run_cell(tree, cell, SEED, 0.2, False, device="cpu")
