"""pinc_tpu_torch's multi-device layer (parallel/: mesh, halo, migrate, the
sharded flat simulation, the pencil FFT, the factory) against pinc_tpu's,
on CPU meshes: the port's over ``["cpu"] * n``, pinc_tpu's over the
conftest's virtual CPU devices.

* pad_plus, fold_plus and shifted_tiles on a (2, 2, 2) mesh, periodic and
  bounded: bit for bit.
* 1-D migration over 4 shards (emigrants both ways, a buffer overflow, a
  full slab): the shards' arrays and the lost count bit for bit.
* ShardedSimulation on tests/test_parallel.py's DECK_3D, (2, 2, 2) at 8^3
  local, sSolve and mgSolve, against pinc_tpu's ShardedSimulation and the
  port's single-block Simulation: KE within 1e-4 and PE within 1e-3 of
  their maxima (tests/test_parallel.py's tolerances), alive and lost
  counts equal.
* Simulation.make_scan_steps (flat) against pinc_tpu's: ke, pe rtol 1e-5.
* The walled mixed deck of tests/test_sharded_bc.py (z Dirichlet) against
  pinc_tpu's sharded run: KE rtol 1e-3, PE rtol 1e-2 + atol 1e-6 (that
  test's own), the particles inside the walls.
* The pencil FFT against the port's replicated solve and pinc_tpu's pencil:
  within 1e-5 of max|phi|.
* make_simulation's routing (an object deck over more than one subdomain
  to the sharded class with its objects) and its raise (too few devices);
  the CLI on the CPU meshes n CPU devices; a shard's error ends its
  shard_map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.parallel import halo as jhalo
from pinc_tpu.parallel.mesh import make_mesh as j_make_mesh
from pinc_tpu.parallel.mesh import subdomain_offset as j_offset
from pinc_tpu.parallel.migrate import migrate as j_migrate
from pinc_tpu.parallel.pic import ShardedSimulation as JSharded
from pinc_tpu.parallel.pic import _shard_map
from pinc_tpu.population import Particles as JParticles
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu_torch import compat
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.parallel import halo
from pinc_tpu_torch.parallel.mesh import make_mesh, subdomain_offset
from pinc_tpu_torch.parallel.migrate import migrate
from pinc_tpu_torch.parallel.pencil_fft import (PencilSpectralSolver,
                                                make_sharded_solver)
from pinc_tpu_torch.parallel.pic import ShardedSimulation, make_simulation
from pinc_tpu_torch.parallel.tiled_pic import ShardedTiledSimulation
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.solvers.spectral import SpectralSolver
from pinc_tpu_torch.tiled_sim import TiledSimulation

CPU8 = ["cpu"] * 8

DECK_3D = """
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 16 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.3
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = {solver}
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrants3D
[multigrid]
mgLevels = 2
mgCycles = 15
nPreSmooth = 3
nPostSmooth = 3
nCoarseSolve = 10
"""
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deck(nsub, ts, solver="sSolve", steps=STEPS):
    return DECK_3D.format(steps=steps, nsub=nsub, ts=ts, solver=solver)


def _blocks(ctx, g):
    return [torch.from_numpy(np.ascontiguousarray(g[ctx.block_slices(i)]))
            for i in range(ctx.n_devices)]


# ------------------------------------------------------------------ halo

HALO_CASES = {
    "pad_plus": (lambda b, c, bnd: halo.pad_plus(b, c, bounded=bnd),
                 lambda b, c, bnd: jhalo.pad_plus(b, c.axes, c.n_subdomains,
                                                  bounded=bnd), 0),
    "fold_plus": (lambda b, c, bnd: halo.fold_plus(b, c, bounded=bnd),
                  lambda b, c, bnd: jhalo.fold_plus(b, c.axes,
                                                    c.n_subdomains,
                                                    bounded=bnd), 1),
}


@pytest.mark.parametrize("bounded", [None, (True, False, True)],
                         ids=["periodic", "bounded"])
@pytest.mark.parametrize("case", ["pad_plus", "fold_plus"])
def test_halo_matches_pinc_tpu(cpu_devices, case, bounded):
    """Each shard's padded (pad_plus, a 2-component field) or folded
    (fold_plus, a +1-padded block) result, bit for bit."""
    mine, ref, extra = HALO_CASES[case]
    nsub, t = (2, 2, 2), (4, 3, 5)
    jctx = j_make_mesh(nsub, t, devices=cpu_devices[:8])
    ctx = make_mesh(nsub, t, devices=CPU8)
    rng = np.random.default_rng(1)
    lt = tuple(s + extra for s in t)
    tail = (2,) if case == "pad_plus" else ()
    blocks = rng.normal(size=(8,) + lt + tail).astype(np.float32)
    out = ctx.shard_map(lambda b: mine(b, ctx, bounded),
                        [torch.from_numpy(b) for b in blocks])
    # pinc_tpu: the same blocks laid out as its global sharded array
    g = np.zeros(tuple(n * s for n, s in zip(nsub, lt)) + tail, np.float32)
    for i, b in enumerate(blocks):
        c = np.unravel_index(i, nsub)
        g[tuple(slice(ci * s, (ci + 1) * s) for ci, s in zip(c, lt))] = b
    spec = jctx.field_spec(n_values=len(tail))
    res = np.asarray(jax.jit(_shard_map(lambda b: ref(b, jctx, bounded),
                                        jctx.mesh, in_specs=(spec,),
                                        out_specs=spec))(
        jax.device_put(jnp.asarray(g), jctx.sharding(spec))))
    for i, o in enumerate(out):
        c = np.unravel_index(i, nsub)
        sh = o.shape[:3]
        want = res[tuple(slice(ci * s, (ci + 1) * s) for ci, s in
                         zip(c, sh))]
        np.testing.assert_array_equal(o.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("d, shift", [(0, 1), (1, -1), (2, 1), (2, -1)])
def test_shifted_tiles_matches_pinc_tpu(cpu_devices, d, shift):
    """shifted_tiles along each mesh axis (the tiled path's roll_fns), bit
    for bit; the axis with one shard is the plain roll."""
    nsub, lnt = (2, 1, 4), (3, 2, 2)
    jctx = j_make_mesh(nsub, lnt, devices=cpu_devices[:8])
    ctx = make_mesh(nsub, lnt, devices=CPU8)
    rng = np.random.default_rng(2)
    g = rng.normal(size=tuple(n * s for n, s in zip(nsub, lnt))
                   + (5,)).astype(np.float32)
    out = ctx.shard_map(lambda b: halo.shifted_tiles(b, d, shift, ctx, d),
                        _blocks(ctx, g))
    spec = jctx.field_spec(n_values=1)
    res = np.asarray(jax.jit(_shard_map(
        lambda b: jhalo.shifted_tiles(b, d, shift, jctx.axes[d], nsub[d]),
        jctx.mesh, in_specs=(spec,), out_specs=spec))(
        jax.device_put(jnp.asarray(g), jctx.sharding(spec))))
    for i, o in enumerate(out):
        np.testing.assert_array_equal(o.numpy(), res[ctx.block_slices(i)])


def test_shard_map_raises_a_shards_error():
    """An error in one shard's work ends the shard_map with that error
    (the shards waiting at a collective give up), and the mesh runs the
    next shard_map."""
    ctx = make_mesh((4,), (2,), devices=["cpu"] * 4)

    def fn(x):
        y = ctx.psum(x)
        if ctx.axis_index(0) == 2:
            raise ValueError("shard 2 failed")
        return ctx.psum(y)
    with pytest.raises(ValueError, match="shard 2 failed"):
        ctx.shard_map(fn, [torch.ones(())] * 4)
    assert [float(r) for r in ctx.shard_map(ctx.psum, [torch.ones(())] * 4)] \
        == [4.0] * 4


# ------------------------------------------------------------- migration

def test_migration_1d_matches_pinc_tpu(cpu_devices):
    """4 shards of 8 cells, one species, 24 slots a shard: particles leave
    to both sides (cells -1..8 in the local frame), shard 1 sends more
    than the buffer holds (K = 4), shard 2 is full and drops arrivals."""
    n, t, cap, K = 4, 8, 24, 4
    rng = np.random.default_rng(3)
    cell = np.zeros((1, n * cap, 1), np.int32)
    alive = np.zeros((1, n * cap), bool)
    for i in range(n):
        m = cap if i == 2 else 12
        lc = rng.integers(-1, t + 1, size=m)
        if i == 1:
            lc[:6] = t          # six emigrants to the right, cap 4
        cell[0, i * cap:i * cap + m, 0] = i * t + lc
        alive[0, i * cap:i * cap + m] = True
    frac = rng.uniform(0, 1, (1, n * cap, 1)).astype(np.float32)
    vel = rng.normal(size=(1, n * cap, 1)).astype(np.float32)

    jctx = j_make_mesh((n,), (t,), devices=cpu_devices[:n])
    p3, p2 = jctx.particle_spec(True), jctx.particle_spec(False)
    pspec = JParticles(cell=p3, frac=p3, vel=p3, alive=p2)
    jp = JParticles(*(jax.device_put(jnp.asarray(a), jctx.sharding(s))
                      for a, s in zip((cell, frac, vel, alive),
                                      (p3, p3, p3, p2))))
    jres, jlost = jax.jit(_shard_map(
        lambda p: j_migrate(p, jctx, j_offset(jctx), K), jctx.mesh,
        in_specs=(pspec,), out_specs=(pspec, P())))(jp)

    ctx = make_mesh((n,), (t,), devices=["cpu"] * n)
    parts = compat.sharded_particles_from_numpy(cell, frac, vel, alive,
                                                ctx.devices)
    res = ctx.shard_map(
        lambda p: migrate(p, ctx, subdomain_offset(ctx), K), parts)
    got = compat.sharded_particles_to_numpy([r[0] for r in res])
    want = [np.asarray(getattr(jres, k))
            for k in ("cell", "frac", "vel", "alive")]
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)
    assert all(int(r[1]) == int(jlost) for r in res)
    assert int(jlost) > 0


# ------------------------------------------------------ the sharded step

@pytest.fixture(scope="module")
def flat_runs(cpu_devices):
    """pinc_tpu's sharded run, the port's sharded and single-block runs
    of DECK_3D, per solver."""
    out = {}
    for solver in ("sSolve", "mgSolve"):
        cfg2 = _deck("2,2,2", "8,8,8", solver)
        j = JSharded(JConfig.from_string(cfg2), seed=3,
                     devices=cpu_devices[:8])
        hj = j.run(progress_every=0)
        sim = ShardedSimulation(PincConfig.from_string(cfg2), seed=3,
                                devices=CPU8)
        h = sim.run(progress_every=0)
        one = Simulation(PincConfig.from_string(
            _deck("1,1,1", "16,16,16", solver)), seed=3, device="cpu")
        h1 = one.run(progress_every=0)
        out[solver] = (hj, np.asarray(j.particles.counts()).tolist(),
                       h, sim, h1)
    return out


def _close(ref, got, ke_tol=1e-4, pe_tol=1e-3):
    ke_r, ke_g = ref["kinetic"].sum(1), got["kinetic"].sum(1)
    assert np.abs(ke_r - ke_g).max() / np.abs(ke_r).max() < ke_tol
    pe_r, pe_g = ref["potential"], got["potential"]
    assert np.abs(pe_r - pe_g).max() / np.abs(pe_r).max() < pe_tol


@pytest.mark.parametrize("solver", ["sSolve", "mgSolve"])
def test_sharded_matches_pinc_tpu(flat_runs, solver):
    hj, j_counts, h, sim, _ = flat_runs[solver]
    _close(hj, h)
    counts = sim.gather_particles().counts().tolist()
    assert counts == j_counts == [8 * 16 ** 3] * 2
    assert not isinstance(sim._solve, PencilSpectralSolver)


@pytest.mark.parametrize("solver", ["sSolve", "mgSolve"])
def test_sharded_matches_single_block(flat_runs, solver):
    _, _, h, _, h1 = flat_runs[solver]
    _close(h1, h)


def test_flat_make_scan_steps_matches_pinc_tpu():
    """Simulation.make_scan_steps (the flat window) against pinc_tpu's
    lax.scan of its step, from the same half-kicked state."""
    deck = _deck("1,1,1", "8,8,8")
    j = JSimulation(JConfig.from_string(deck), seed=5)
    jout = j._half_kick(j.particles)
    (_, _), (jke, jpe) = j.make_scan_steps(4)(jout.particles)
    sim = Simulation(PincConfig.from_string(deck), seed=5, device="cpu")
    out = sim._half_kick(sim.particles)
    before = out.particles.vel.clone()
    (p, rho_obj), (ke, pe) = sim.make_scan_steps(4)(out.particles)
    assert rho_obj is None and ke.shape == (4, 2) and pe.shape == (4,)
    assert torch.equal(out.particles.vel, before)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jke), rtol=1e-5)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5,
                               atol=1e-9)


MIXED = """
[time]
nTimeSteps = 3
timeStep = 0.1
[grid]
nDims = 3
nSubdomains = {nsub}
trueSize = {ts}
stepSize = 1
boundaries = PERIODIC,PERIODIC,DIRICHLET,PERIODIC,PERIODIC,DIRICHLET
bndValues = 0,0,0,0,0,0
[population]
nSpecies = 2
nParticles = 2 pc
nAlloc = 6 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.03,0.001
drift = 0.02
[methods]
mode = regular
poisson = mgSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[multigrid]
mgLevels = 2
mgCycles = 8
nPreSmooth = 3
nPostSmooth = 3
nCoarseSolve = 12
"""


def test_walled_mixed_deck_matches_pinc_tpu(cpu_devices):
    """tests/test_sharded_bc.py's mixed deck (z walls) on (2, 2, 2): the
    half kick and three steps against pinc_tpu's sharded step."""
    deck = MIXED.format(nsub="2,2,2", ts="8,8,8")
    j = JSharded(JConfig.from_string(deck), seed=11,
                 devices=cpu_devices[:8])
    sim = ShardedSimulation(PincConfig.from_string(deck), seed=11,
                            devices=CPU8)
    jo, o = j._half_kick_jit(j.particles), sim._half_kick(sim.particles)
    for _ in range(3):
        jo, o = j._step_jit(jo.particles), sim._step(o.particles)
        ke_j = float(np.asarray(jo.diag.kin_energy).sum())
        assert np.isclose(float(o.diag.kin_energy.sum()), ke_j, rtol=1e-3)
        assert np.isclose(float(o.diag.pot_energy),
                          float(jo.diag.pot_energy), rtol=1e-2, atol=1e-6)
        assert int(o.diag.n_lost) == int(jo.diag.n_lost) == 0
    p = sim.gather_particles(o.particles)
    cell = p.cell.numpy()[p.alive.numpy()]
    assert cell[:, 2].min() >= 0 and cell[:, 2].max() <= 15
    assert (p.counts().numpy()
            == np.asarray(jo.particles.alive).sum(1)).all()


# ------------------------------------------------------------ the solves

def test_pencil_matches_replicated_and_pinc_tpu(cpu_devices):
    from pinc_tpu.parallel.pencil_fft import \
        PencilSpectralSolver as JPencil
    shape = (16, 16, 16)
    ctx = make_mesh((2, 2, 2), (8, 8, 8), devices=CPU8)
    rng = np.random.default_rng(0)
    rho = rng.normal(size=shape).astype(np.float32)
    rho -= rho.mean()
    blocks = _blocks(ctx, rho)
    pencil = ctx.gather(PencilSpectralSolver(shape, ctx)(blocks)).numpy()
    cfg = PincConfig.from_string(_deck("2,2,2", "8,8,8"))
    rep = make_sharded_solver(SpectralSolver(shape), ctx, cfg,
                              torch.float32)
    assert not isinstance(rep, PencilSpectralSolver)
    replicated = ctx.gather(rep(blocks)).numpy()
    jctx = j_make_mesh((2, 2, 2), (8, 8, 8), devices=cpu_devices[:8])
    jphi = np.asarray(jax.jit(JPencil(shape, jctx))(jax.device_put(
        jnp.asarray(rho), jctx.sharding(jctx.field_spec()))))
    scale = np.abs(jphi).max()
    assert np.abs(pencil - replicated).max() < 1e-5 * scale
    assert np.abs(pencil - jphi).max() < 1e-5 * scale
    cfg.set_str("parallel:pencilfft", "true")
    assert isinstance(make_sharded_solver(SpectralSolver(shape), ctx, cfg,
                                          torch.float32),
                      PencilSpectralSolver)


# --------------------------------------------------------------- routing

TILED = """
[tiles]
tileSize = 4
"""


def test_make_simulation_routes_and_raises(tmp_path, monkeypatch):
    one = PincConfig.from_string(_deck("1,1,1", "8,8,8", steps=1))
    assert type(make_simulation(one, device="cpu")) is Simulation
    flat = PincConfig.from_string(_deck("2,1,1", "8,8,8", steps=1))
    assert isinstance(make_simulation(flat, device="cpu"), ShardedSimulation)
    tiled = PincConfig.from_string(_deck("2,1,1", "8,8,8", steps=1)
                                   + TILED + "[methods]\nlayout = tiled\n")
    sim = make_simulation(tiled, device="cpu")
    assert isinstance(sim, ShardedTiledSimulation)
    assert isinstance(sim, TiledSimulation)
    # too few devices: pinc_tpu's error, and no fall-back to the CPU
    with pytest.raises(ValueError, match="deck wants 2 devices"):
        make_simulation(flat, devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="deck wants 2 devices"):
        make_simulation(flat, device="cuda")
    monkeypatch.undo()
    # an object deck over more than one subdomain builds the sharded class
    # with its objects (the grid given in memory)
    from pinc_tpu_torch.objects import make_sphere
    obj = PincConfig.from_string(_deck("2,1,1", "8,8,8", steps=1)
                                 + "[objects]\nobjects = sphere.grid.h5\n")
    sim = make_simulation(obj, device="cpu",
                          domain=make_sphere((16, 8, 8), (8, 4, 4), 2.5))
    assert isinstance(sim, ShardedSimulation) and sim.objects is not None
    assert sim.ctx.devices == [torch.device("cpu")] * 2
    # the CLI on the CPU meshes n CPU devices
    deck = tmp_path / "deck.ini"
    deck.write_text(_deck("2,1,1", "8,8,8", steps=2))
    out = {}
    assert main([str(deck)], out=out, device="cpu") == 0
    assert isinstance(out["sim"], ShardedSimulation)
    assert out["sim"].ctx.devices == [torch.device("cpu")] * 2
    assert np.isfinite(out["kinetic"]).all()


def test_sharded_flat_run_writes_global_output(tmp_path):
    """files:output on a decomposed flat deck writes the global fields
    (gathered from the shards): the single-block run's grid files within
    1e-4 of their maxima, and the whole population."""
    h5py = pytest.importorskip("h5py")
    files = {}
    for label, nsub, ts in (("one", "1,1,1", "16,16,16"),
                            ("sharded", "2,2,2", "8,8,8")):
        deck = tmp_path / f"{label}.ini"
        deck.write_text(_deck(nsub, ts, steps=2))
        out = {}
        assert main([str(deck), f"files:output={tmp_path}/{label}/run"],
                    out=out, device="cpu") == 0
        files[label] = tmp_path / label
    for name in ("rho.grid.h5", "phi.grid.h5", "E.grid.h5"):
        with h5py.File(files["one"] / f"run_{name}", "r") as f1, \
                h5py.File(files["sharded"] / f"run_{name}", "r") as fN:
            keys = [k for k in f1 if isinstance(f1[k], h5py.Dataset)]
            assert keys and sorted(keys) == sorted(
                k for k in fN if isinstance(fN[k], h5py.Dataset))
            for k in keys:
                a, b = f1[k][()], fN[k][()]
                assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
    with h5py.File(files["sharded"] / "run_pop.pop.h5", "r") as f:
        names = []
        f.visit(names.append)
        assert names
