"""pinc_tpu_torch's bc.py and solvers/multigrid.py against pinc_tpu's, and
the mgMode / mgModeErrorScaling run modes.

The same numpy inputs, drawn from a seed, go through both packages:

* bc.py: BCSpec.from_config, clamp_dirichlet, interior_mask, pad_bc,
  neighbor_sum_bc, laplacian_bc, gradient_bc and apply_bnd on periodic,
  Dirichlet, Neumann and mixed boundaries (per dim and per edge), in 1-D,
  2-D and 3-D.  Tolerance: 1e-6 of the largest magnitude (the same float32
  operations; XLA may fuse them otherwise).
* The smoothers (red-black Gauss-Seidel, damped Jacobi), the restriction
  and the prolongation on each kind of boundary: 1e-6 of the largest
  magnitude.
* MultigridSolver.solve_with_stats on every cycle (V-recursive, V-regular,
  W, FMG) at 16^3, 32^2 and 64 with 2-3 levels, periodic, Dirichlet and
  Neumann: the cycle counts equal (the port tests the tolerance on the
  host), phi within 1e-5 of max|phi| and the final RMS residual within
  1e-3 relative (float32 sums in another order over up to 12 cycles).
* mgMode and mgModeErrorScaling through each package's CLI on the CPU:
  equal cycle counts, the RMS error against the analytic solution within
  1e-3 relative, the order of the error study above
  tests/test_solvers.py:88's bound (1.5) and within 1e-3 of pinc_tpu's;
  mgMode's timer.xy.h5 with the same datasets and cycles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu import bc as jbc
from pinc_tpu import simulation as _jsimulation   # noqa: F401 (registry)
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.grid import BndType as JBnd
from pinc_tpu.registry import RUN_MODES as JRUN_MODES
from pinc_tpu.solvers import multigrid as jmg
from pinc_tpu_torch import bc
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.grid import BndType
from pinc_tpu_torch.registry import SOLVERS
from pinc_tpu_torch.solvers import multigrid as mg

P, D, N = "PERIODIC", "DIRICHLET", "NEUMANN"
# per dim (lower, upper) boundary types
KINDS = {
    "periodic": lambda nd: [(P, P)] * nd,
    "dirichlet": lambda nd: [(D, D)] * nd,
    "neumann": lambda nd: [(N, N)] * nd,
    "mixed": lambda nd: [(D, N), (P, P), (N, N)][:nd] if nd > 1
    else [(D, N)],
}
SHAPES = {1: (12,), 2: (10, 8), 3: (6, 8, 4)}


def _specs(kind: str, nd: int):
    """(pinc_tpu's BCSpec, the port's) with seeded boundary values."""
    types = KINDS[kind](nd)
    vals = np.random.default_rng(nd).uniform(-1, 1, 2 * nd).round(3)
    out = []
    for B, S in ((JBnd, jbc.BCSpec), (BndType, bc.BCSpec)):
        out.append(S(lower=tuple(B(lo) for lo, _ in types),
                     upper=tuple(B(hi) for _, hi in types),
                     lower_value=tuple(vals[:nd]),
                     upper_value=tuple(vals[nd:])))
    return out


def _close(mine, ref, rel=1e-6):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_bc_functions_match_pinc_tpu(nd, kind):
    jspec, spec = _specs(kind, nd)
    phi = np.random.default_rng(10 + nd).standard_normal(
        SHAPES[nd]).astype(np.float32)
    x, jx = torch.from_numpy(phi), jnp.asarray(phi)
    assert spec.periodic == jspec.periodic
    np.testing.assert_array_equal(bc.interior_mask(phi.shape, spec),
                                  jbc.interior_mask(phi.shape, jspec))
    for name in ("clamp_dirichlet", "pad_bc", "neighbor_sum_bc",
                 "laplacian_bc", "gradient_bc", "apply_bnd"):
        _close(getattr(bc, name)(x, spec), getattr(jbc, name)(jx, jspec))
    zero_mine, zero_ref = spec.homogeneous(), jspec.homogeneous()
    _close(bc.pad_bc(x, zero_mine), jbc.pad_bc(jx, zero_ref))
    assert torch.equal(x, torch.from_numpy(phi))        # inputs untouched


@pytest.mark.parametrize("values", [None, "0.5,-1,0,2,3,-0.25"])
def test_bcspec_from_config(values):
    deck = ("[grid]\nnDims = 3\n"
            "boundaries = DIRICHLET,NEUMANN,PERIODIC,DIRICHLET,NEUMANN,"
            "PERIODIC\n" + (f"bndValues = {values}\n" if values else ""))
    mine = bc.BCSpec.from_config(PincConfig.from_string(deck))
    ref = jbc.BCSpec.from_config(JConfig.from_string(deck))
    assert [b.value for b in mine.lower + mine.upper] == \
        [b.value for b in ref.lower + ref.upper]
    assert mine.lower_value == ref.lower_value
    assert mine.upper_value == ref.upper_value


@pytest.mark.parametrize("kind", ["periodic", "dirichlet", "neumann",
                                  "mixed"])
@pytest.mark.parametrize("smoother", ["gaussseidelrb", "jacobi"])
def test_smoothers_match_pinc_tpu(smoother, kind):
    shape = (8, 8, 8)
    jspec, spec = _specs(kind, 3)
    rng = np.random.default_rng(3)
    phi = rng.standard_normal(shape).astype(np.float32)
    rho = rng.standard_normal(shape).astype(np.float32)
    mine = mg.SMOOTHERS[smoother](shape, 3, spec)(torch.from_numpy(phi),
                                                  torch.from_numpy(rho))
    ref = jmg.SMOOTHERS[smoother](shape, 3, jspec)(jnp.asarray(phi),
                                                   jnp.asarray(rho))
    _close(mine, ref)


@pytest.mark.parametrize("kind", ["periodic", "dirichlet", "mixed"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_transfer_operators_match_pinc_tpu(nd, kind):
    jspec, spec = _specs(kind, nd)
    shape = {1: (16,), 2: (8, 16), 3: (8, 4, 8)}[nd]
    fine = np.random.default_rng(nd).standard_normal(shape).astype(
        np.float32)
    coarse = fine[(slice(None, None, 2),) * nd].copy()
    _close(mg.restrict_half_weight(torch.from_numpy(fine), spec),
           jmg.restrict_half_weight(jnp.asarray(fine), jspec))
    _close(mg.prolong_multilinear(torch.from_numpy(coarse), spec),
           jmg.prolong_multilinear(jnp.asarray(coarse), jspec))
    _close(mg.restrict_half_weight(torch.from_numpy(fine)),
           jmg.restrict_half_weight(jnp.asarray(fine)))


def _rho(shape, seed):
    """A smooth mode plus noise: the tolerance loop runs several cycles."""
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    smooth = np.prod([np.sin(2 * np.pi * a / n + 0.3)
                      for a, n in zip(axes, shape)], axis=0)
    return (smooth + 0.1 * rng.standard_normal(shape)).astype(np.float32)


# (cycle, shape, levels, boundary kind, smoother, tol, cycles): every
# cycle, size and boundary kind at least once; each tol lies between two
# cycles' residuals, a factor 1.1 or more from both, so the loop stops
# early, or never (the last case: the cap of 12)
SOLVES = [
    ("mgVRecursive", (16, 16, 16), 3, "periodic", "gaussSeidelRB", 1e-4, 8),
    ("mgVRegular", (32, 32), 3, "dirichlet", "gaussSeidelRB", 4.5e-2, 7),
    ("mgW", (64,), 3, "neumann", "gaussSeidelRB", 5.5e-1, 5),
    ("mgFMG", (16, 16, 16), 2, "dirichlet", "gaussSeidelRB", 4e-3, 5),
    ("mgW", (32, 32), 2, "periodic", "jacobi", 1.6e-1, 5),
    ("mgFMG", (32, 32), 3, "neumann", "gaussSeidelRB", 1.1e-1, 9),
    ("mgVRecursive", (64,), 2, "dirichlet", "jacobi", 1e-6, 12),
]


@pytest.mark.parametrize("cycle, shape, levels, kind, smoother, tol, cycles",
                         SOLVES)
def test_solver_matches_pinc_tpu(cycle, shape, levels, kind, smoother, tol,
                                 cycles):
    nd = len(shape)
    jspec, spec = _specs(kind, nd)
    if kind == "neumann":       # a consistent problem: zero fluxes
        jspec, spec = jspec.homogeneous(), spec.homogeneous()
    kw = dict(n_levels=levels, n_pre=3, n_post=3, n_coarse=10, cycle=cycle,
              smoother=smoother, max_cycles=12, tol=tol)
    rho = _rho(shape, nd)
    ref = jmg.MultigridSolver(shape, bc=jspec, **kw).solve_with_stats(
        jnp.asarray(rho))
    phi, n_cycles, resid = mg.MultigridSolver(
        shape, bc=spec, **kw).solve_with_stats(torch.from_numpy(rho))
    assert isinstance(n_cycles, int)
    assert n_cycles == int(ref[1]) == cycles
    _close(phi, ref[0], rel=1e-5)
    np.testing.assert_allclose(float(resid), float(ref[2]), rtol=1e-3)


def test_make_from_config():
    """The [multigrid] section read as pinc_tpu reads it, the float32
    default tolerance 5e-6, and the three registry names."""
    deck = ("[grid]\nnDims = 2\ntrueSize = 32,16\nnSubdomains = 1,1\n"
            "boundaries = DIRICHLET\n[multigrid]\nmgLevels = 3\n"
            "mgCycles = 7\nnPreSmooth = 4\nnPostSmooth = 5\n"
            "nCoarseSolve = 6\ncycle = mgW\npreSmooth = jacobi\n")
    mine = mg.make_from_config(PincConfig.from_string(deck))
    ref = jmg.make_from_config(JConfig.from_string(deck))
    for key in ("shape", "n_levels", "cycle", "max_cycles", "tol",
                "_has_nullspace", "_shapes"):
        assert getattr(mine, key) == getattr(ref, key), key
    assert mine.tol == 5e-6 and mine.bc.lower_value == (1.0, 1.0)
    for name in ("mgSolve", "mgSolver", "multigrid"):
        cfg = PincConfig.from_string(deck + f"[methods]\npoisson = {name}\n")
        assert isinstance(SOLVERS.select(cfg, "methods:poisson"),
                          mg.MultigridSolver)


MG_DECK = """
[time]
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = {bounds}
bndValues = 0,0,0,0,0,0
[population]
nSpecies = 2
nParticles = 1 pc
nAlloc = 1 pc
charge = -1,1
mass = 1,1836
[methods]
mode = {mode}
poisson = mgSolve
[multigrid]
mgLevels = 3
mgCycles = 15
nPreSmooth = 4
nPostSmooth = 4
nCoarseSolve = 10
nRepetitions = 2
"""


def _both(tmp_path, monkeypatch, mode, bounds, *extra):
    """(pinc_tpu's result, the port's) of the run mode: pinc_tpu's
    registry entry (its CLI returns no result), the port's CLI."""
    deck = tmp_path / "mg.ini"
    deck.write_text(MG_DECK.format(mode=mode, bounds=bounds))
    runs = []
    for where in ("jax", "torch"):
        d = tmp_path / where
        d.mkdir()
        monkeypatch.chdir(d)
        if where == "jax":
            cfg = JConfig.from_file(str(deck), list(extra))
            runs.append(JRUN_MODES.select(cfg, "methods:mode")())
        else:
            out = {}
            assert main([str(deck), *extra], out=out, device="cpu") == 0
            runs.append(out)
    return runs


def test_mg_mode_matches_pinc_tpu(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    ref, mine = _both(tmp_path, monkeypatch, "mgMode", "PERIODIC",
                      "files:output=out/")
    assert mine["cycles"] == ref["cycles"] >= 2
    assert mine["seconds"] > 0
    np.testing.assert_allclose(mine["rms_error"], ref["rms_error"],
                               rtol=1e-3)
    files = [h5py.File(tmp_path / w / "out" / "timer.xy.h5", "r")
             for w in ("jax", "torch")]
    with files[0] as j, files[1] as t:
        assert sorted(j) == sorted(t) == ["cycles", "time"]
        np.testing.assert_array_equal(t["cycles"][:], j["cycles"][:])
        assert t["time"].shape == (1, 2) and t["time"][0, 1] > 0


@pytest.mark.parametrize("bounds", ["PERIODIC", "DIRICHLET"])
def test_mg_error_scaling_matches_pinc_tpu(tmp_path, monkeypatch, bounds):
    ref, mine = _both(tmp_path, monkeypatch, "mgModeErrorScaling", bounds)
    assert mine["fixture"] == ref["fixture"]
    assert mine["sizes"] == ref["sizes"]
    np.testing.assert_allclose(mine["errors"], ref["errors"], rtol=1e-3)
    assert mine["order"] > 1.5
    assert abs(mine["order"] - ref["order"]) < 1e-3


def test_mg_modes_refuse_decomposed_decks(tmp_path, monkeypatch):
    """A decomposed deck's mg modes run the sharded solver on a mesh; on a
    card host with fewer cards than subdomains they raise pinc_tpu's
    "deck wants N devices" and do not fall back to the CPU."""
    deck = tmp_path / "mg.ini"
    deck.write_text(MG_DECK.format(mode="mgMode", bounds="PERIODIC"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    for mode in ("mgMode", "mgModeErrorScaling"):
        with pytest.raises(ValueError, match="deck wants 2 devices"):
            main([str(deck), f"methods:mode={mode}",
                  "grid:nSubdomains=2,1,1"], device="cuda")
