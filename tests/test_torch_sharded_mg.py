"""pinc_tpu_torch's sharded multigrid (parallel/mg.py) against pinc_tpu's
ShardedMultigridSolver, on CPU meshes (the port's over ``["cpu"] * n``,
pinc_tpu's over the conftest's virtual CPU devices), with
tests/test_sharded_mg.py's parameters: 3 levels, 4/4 sweeps, 20 coarse
sweeps, 8 cycles at an unreachable tolerance (both run all 8).

* Periodic on (2, 2, 2) and (1, 2, 2) meshes, inhomogeneous Dirichlet
  walls, mixed (periodic x, y, Neumann z), the W and FMG cycles, and the
  agglomerated bottom (24^3 over (2, 2, 2): 3 sharded levels + 2 on the
  gathered 6^3 grid): phi within 2e-5 of max|phi| (the JAX tests' bound
  for sharded against single), the same cycle count.
* The solve to tolerance (tol 1e-4, 11 cycles) with the agglomerated
  bottom: the
  same cycle count as pinc_tpu's sharded solver and as the port's single
  device solver.
* _max_levels and from_single's clamp and agglomeration, as pinc_tpu's.
* The sharded mgMode and mgModeErrorScaling through the CLI on a CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.bc import BCSpec as JBCSpec
from pinc_tpu.grid import BndType as JBnd
from pinc_tpu.parallel.mesh import make_mesh as j_make_mesh
from pinc_tpu.parallel.mg import ShardedMultigridSolver as JShardedMG
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.bc import BCSpec
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.grid import BndType, GridSpec, fill_sin, \
    fill_sin_dirichlet
from pinc_tpu_torch.parallel.mesh import make_mesh
from pinc_tpu_torch.parallel.mg import ShardedMultigridSolver, _max_levels
from pinc_tpu_torch.parallel.pencil_fft import make_sharded_solver
from pinc_tpu_torch.solvers.multigrid import MultigridSolver, \
    make_from_config

PARAMS = dict(n_levels=3, n_pre=4, n_post=4, n_coarse=20, max_cycles=8,
              tol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(n, periodic=True):
    b = BndType.PERIODIC if periodic else BndType.DIRICHLET
    return GridSpec(n_dims=3, true_size=(n, n, n), n_subdomains=(1, 1, 1),
                    boundaries=(b,) * 6)


def _jbc(bc):
    if bc is None:
        return None
    conv = {BndType.PERIODIC: JBnd.PERIODIC, BndType.DIRICHLET:
            JBnd.DIRICHLET, BndType.NEUMANN: JBnd.NEUMANN}
    return JBCSpec(lower=tuple(conv[b] for b in bc.lower),
                   upper=tuple(conv[b] for b in bc.upper),
                   lower_value=bc.lower_value, upper_value=bc.upper_value)


def _pair(rho, nsub, cpu_devices, bc=None, cycle="mgvrecursive", **kw):
    """(port phi, its cycles, pinc_tpu phi, its cycles) of the sharded
    solve of rho."""
    params = dict(PARAMS, **kw)
    n = rho.shape[0]
    local = tuple(n // s for s in nsub)
    ctx = make_mesh(nsub, local, devices=["cpu"] * int(np.prod(nsub)))
    mine = ShardedMultigridSolver(ctx, cycle=cycle, bc=bc, **params)
    phi, cyc, _ = mine.solve_with_stats(ctx.split(torch.from_numpy(rho)))
    jctx = j_make_mesh(nsub, local,
                       devices=cpu_devices[:int(np.prod(nsub))])
    ref = JShardedMG(jctx, cycle=cycle, bc=_jbc(bc), **params)
    jphi, jcyc, _ = jax.jit(ref.solve_with_stats)(jax.device_put(
        jnp.asarray(rho), jctx.sharding(jctx.field_spec())))
    return ctx.gather(phi).numpy(), cyc, np.asarray(jphi), int(jcyc), mine


def _close(a, b, bound=2e-5):
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a - b).max() < bound * scale, (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("nsub", [(2, 2, 2), (1, 2, 2)])
def test_periodic_matches_pinc_tpu(cpu_devices, nsub):
    rho = fill_sin(_spec(16))[0].astype(np.float32)
    phi, cyc, jphi, jcyc, _ = _pair(rho, nsub, cpu_devices)
    _close(phi, jphi)
    assert cyc == jcyc == 8


def test_dirichlet_matches_pinc_tpu(cpu_devices):
    """Inhomogeneous Dirichlet values: the edge shards clamp and ghost as
    the single-block pad_bc does."""
    bc = BCSpec(lower=(BndType.DIRICHLET,) * 3,
                upper=(BndType.DIRICHLET,) * 3,
                lower_value=(0.5, 0.0, -0.25), upper_value=(1.0, 0.25, 0.0))
    rho = fill_sin_dirichlet(_spec(16, periodic=False))[0].astype(
        np.float32)
    phi, cyc, jphi, jcyc, _ = _pair(rho, (2, 2, 2), cpu_devices, bc=bc)
    _close(phi, jphi)
    assert cyc == jcyc


def test_mixed_bc_matches_pinc_tpu(cpu_devices):
    """Periodic x, y with Neumann z walls."""
    bc = BCSpec(lower=(BndType.PERIODIC, BndType.PERIODIC, BndType.NEUMANN),
                upper=(BndType.PERIODIC, BndType.PERIODIC, BndType.NEUMANN),
                lower_value=(0.0, 0.0, 0.1), upper_value=(0.0, 0.0, 0.1))
    rho = fill_sin(_spec(16))[0].astype(np.float32)
    phi, cyc, jphi, jcyc, _ = _pair(rho, (2, 2, 1), cpu_devices, bc=bc)
    _close(phi, jphi)
    assert cyc == jcyc


@pytest.mark.parametrize("cycle", ["mgW", "mgFMG"])
def test_cycles_match_pinc_tpu(cpu_devices, cycle):
    rho = fill_sin(_spec(16))[0].astype(np.float32)
    phi, cyc, jphi, jcyc, _ = _pair(rho, (2, 2, 2), cpu_devices, cycle=cycle,
                                    max_cycles=3)
    _close(phi, jphi)
    assert cyc == jcyc == 3


def test_agglomerated_bottom_matches_pinc_tpu(cpu_devices):
    """24^3 over (2, 2, 2): the clamp stops the sharded hierarchy at 3
    levels (12 % 8 != 0); the bottom continues 2 levels on the gathered
    6^3 grid."""
    rho = fill_sin(_spec(24))[0].astype(np.float32)
    phi, cyc, jphi, jcyc, mine = _pair(rho, (2, 2, 2), cpu_devices,
                                       n_bottom_levels=2, max_cycles=4)
    assert mine._bottom is not None and mine._bottom.shape == (6, 6, 6)
    assert mine._bottom.n_levels == 2
    _close(phi, jphi)
    assert cyc == jcyc == 4


def test_solve_to_tolerance_cycle_count(cpu_devices):
    """tol 1e-4 with the agglomerated bottom: the measured cycle count is
    pinc_tpu's, and the single-device 4-level solver's (11; the residual
    ends ~30% below the tolerance)."""
    rho = fill_sin(_spec(24))[0].astype(np.float32)
    phi, cyc, jphi, jcyc, _ = _pair(rho, (2, 2, 2), cpu_devices,
                                    n_bottom_levels=2, max_cycles=15,
                                    tol=1e-4)
    single = MultigridSolver((24,) * 3, n_levels=4, n_pre=4, n_post=4,
                             n_coarse=20, max_cycles=15, tol=1e-4)
    _, cyc1, _ = single.solve_with_stats(torch.from_numpy(rho))
    assert cyc == jcyc == cyc1 < 15
    _close(phi, jphi)


def test_max_levels_and_from_single():
    assert _max_levels(make_mesh((1, 1, 1), (16, 16, 16), ["cpu"])) == 5
    assert _max_levels(make_mesh((1, 1, 1), (16, 8, 16), ["cpu"])) == 4
    deck = """
[grid]
nDims = 3
nSubdomains = 2,2,2
trueSize = 12,12,12
stepSize = 1
boundaries = PERIODIC
[multigrid]
mgLevels = 4
"""
    cfg = PincConfig.from_string(deck)
    ctx = make_mesh((2, 2, 2), (12, 12, 12), ["cpu"] * 8)
    sharded = make_sharded_solver(make_from_config(cfg), ctx, cfg,
                                  torch.float32)
    assert isinstance(sharded, ShardedMultigridSolver)
    assert sharded.n_levels == 3          # 12 % 8 != 0 clamps at 3
    assert sharded._bottom is not None and sharded._bottom.shape == (6,) * 3
    cfg.set_str("parallel:shardedmg", "false")
    assert not isinstance(make_sharded_solver(make_from_config(cfg), ctx,
                                              cfg, torch.float32),
                          ShardedMultigridSolver)


MG_DECK = """
[time]
nTimeSteps = 1
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 1 pc
nAlloc = 1 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
temperature = 0
[methods]
mode = {mode}
poisson = mgSolve
[multigrid]
mgLevels = 3
mgCycles = 20
nPreSmooth = 4
nPostSmooth = 4
nCoarseSolve = 20
nRepetitions = 1
"""


def test_mg_mode_sharded(tmp_path):
    """mgMode on a decomposed deck runs the sharded solver on a CPU mesh:
    its cycles are the single-device solve's of the same deck."""
    outs = []
    for nsub, ts in (("2,2,2", "8,8,8"), ("1,1,1", "16,16,16")):
        deck = tmp_path / f"mg{len(outs)}.ini"
        deck.write_text(MG_DECK.format(nsub=nsub, ts=ts, mode="mgMode"))
        out = {}
        assert main([str(deck)], out=out, device="cpu") == 0
        outs.append(out)
    assert 0 < outs[0]["cycles"] == outs[1]["cycles"] <= 20
    assert outs[0]["rms_error"] < 0.1
    np.testing.assert_allclose(outs[0]["rms_error"], outs[1]["rms_error"],
                               rtol=1e-3)


def test_mg_error_scaling_sharded(tmp_path):
    deck = tmp_path / "mg.ini"
    deck.write_text(MG_DECK.format(nsub="2,2,1", ts="8,8,16",
                                   mode="mgModeErrorScaling"))
    out = {}
    assert main([str(deck)], out=out, device="cpu") == 0
    assert out["order"] > 1.5, out
