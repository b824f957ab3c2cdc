"""pinc_tpu_torch's ShardedSimulation on object decks (the sharded object
branches of parallel/pic.py) against pinc_tpu's ShardedSimulation and the
port's single-device Simulation, on CPU meshes of ``["cpu"] * n``.

The deck is tests/test_sharded_objects.py's (16^3, a sphere of radius 2.5
at the centre, 8 per cell in 16 allocated, vth 0.2 / 0.02, masses 1 and
100, absorb).

* Over (2, 2, 2), step by step from pinc_tpu's state (the half kick from
  the shared initial population, then each step from pinc_tpu's previous
  one): alive counts per species equal, the lost counts equal; kinetic
  energy rtol 1e-5, field energy rtol 1e-4, rho_obj within 1e-5 of
  max|rho_obj| (+ 1e-7 max|q|), its sum within 1e-5 of the sum (+ 1e-7
  max|q|), phi_c within 1e-5 of
  max|phi| (+ 1e-7): tests/test_torch_tiled_objects.py's tolerances.
* The port's sharded run() against its single-device run() of the same
  deck: alive counts equal, and pinc_tpu's own tolerances
  (tests/test_sharded_objects.py): kinetic energy rtol 2e-3, rho_obj's
  sum rtol 1e-4, phi_c rtol 5e-3.
* mgSolve over (1, 2, 2) (the sharded multigrid with objects), step by
  step against pinc_tpu's as above, with phi_c within 1e-4 of max|phi|
  and field energy rtol 1e-3 (each multigrid stops at its own tolerance
  test, tests/test_torch_parallel.py's multigrid tolerances).
* make_scan_steps (rho_obj in the carry) against run(), the same numbers;
  the CLI's writer gets the global rho_obj and phi_c; a checkpoint of the
  sharded run (rho_obj in it) resumed to the
  uninterrupted run: alive counts per shard equal, energies and rho_obj
  within the tolerances above, phi_c rtol 1e-4 (the resume distributes the
  population anew, so the deposits add in another order; skips without
  h5py).
"""

import numpy as np
import pytest
import torch

import jax

from object_decks import L, sphere_domain
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.parallel.pic import ShardedSimulation as JSharded
from pinc_tpu_torch import compat
from pinc_tpu_torch import objects as po
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.io_h5 import OutputWriter
from pinc_tpu_torch.parallel.pic import ShardedSimulation, make_simulation
from pinc_tpu_torch.simulation import Simulation

STEPS = 4
KE_RTOL, PE_RTOL = 1e-5, 1e-4
RHO_RTOL = 1e-5
PHI_RTOL, PHI_ATOL = 1e-5, 1e-7

# tests/test_sharded_objects.py's _deck
DECK = """
[objects]
objects = {path}
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
mass = 1,100
multiplicity = auto
thermalVelocity = 0.2,0.02
[methods]
mode = regular
poisson = {solver}
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
{extra}"""

# input/sphereObject.ini's [multigrid] section at two levels
MG = """[multigrid]
cycle = mgVRegular
mgLevels = 2
mgCycles = 10
nPreSmooth = 5
nPostSmooth = 5
nCoarseSolve = 10
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    pytest.importorskip("h5py")
    path = str(tmp_path_factory.mktemp("sphere") / "sphere.grid.h5")
    po.save_domain(path, sphere_domain())
    return path


def _deck(path, nsub, steps=STEPS, solver="sSolve", extra=""):
    ts = ",".join(str(L // n) for n in nsub)
    return DECK.format(path=path, steps=steps, nsub=",".join(map(str, nsub)),
                       ts=ts, solver=solver,
                       extra=MG + extra if solver == "mgSolve" else extra)


def _check_step(out, jout, q, n, phi_rtol=PHI_RTOL, pe_rtol=PE_RTOL):
    parts = compat.sharded_particles_to_numpy(out.particles)
    jalive = np.asarray(jout.particles.alive)
    np.testing.assert_array_equal(parts[3].sum(1), jalive.sum(1))
    assert int(out.diag.n_lost) == int(jout.diag.n_lost), n
    np.testing.assert_allclose(out.diag.kin_energy.numpy(),
                               np.asarray(jout.diag.kin_energy),
                               rtol=KE_RTOL)
    np.testing.assert_allclose(float(out.diag.pot_energy),
                               float(jout.diag.pot_energy), rtol=pe_rtol)
    rho_obj, jrho = out.rho_obj.numpy(), np.asarray(jout.rho_obj)
    qmax = max(abs(v) for v in q)
    tol = RHO_RTOL * np.abs(jrho).max() + 1e-7 * qmax
    assert np.abs(rho_obj - jrho).max() <= tol, n
    total, jtotal = rho_obj.sum(dtype=np.float64), jrho.sum(dtype=np.float64)
    assert abs(total - jtotal) <= RHO_RTOL * abs(jtotal) + 1e-7 * qmax, n
    if jout.obj_potential is not None:
        phi_max = float(np.abs(np.asarray(jout.phi)).max())
        np.testing.assert_allclose(out.obj_potential.numpy(),
                                   np.asarray(jout.obj_potential), rtol=0,
                                   atol=phi_rtol * phi_max + PHI_ATOL)


def _steps_against_pinc_tpu(path, nsub, devices, solver="sSolve",
                            **tol):
    text = _deck(path, nsub, solver=solver)
    n = len(devices)
    jsim = JSharded(JConfig.from_string(text), seed=4, devices=devices)
    sim = ShardedSimulation(PincConfig.from_string(text), seed=4,
                            devices=["cpu"] * n)
    assert sim.objects is not None and sim.ctx.n_subdomains == nsub
    q = [float(v) for v in sim.params.charge]
    # the shards' initial slabs are pinc_tpu's
    for g, k in zip(compat.sharded_particles_to_numpy(sim.particles),
                    ("cell", "frac", "vel", "alive")):
        np.testing.assert_array_equal(g, np.asarray(getattr(jsim.particles,
                                                            k)))
    out = sim._half_kick(sim.particles)
    jout = jsim._half_kick_jit(jsim.particles)
    assert float(out.rho_obj.abs().sum()) == 0.0
    _check_step(out, jout, q, 0, **tol)
    jstep = jsim._step_jit
    for k in range(1, STEPS + 1):
        jp, jrho = jout.particles, jout.rho_obj
        parts = compat.sharded_particles_from_numpy(
            *(np.asarray(getattr(jp, a))
              for a in ("cell", "frac", "vel", "alive")), sim.ctx.devices)
        out = sim._step(parts, torch.from_numpy(np.array(jrho)))
        jout = jstep(jp, jrho)
        _check_step(out, jout, q, k, **tol)
    alive = compat.sharded_particles_to_numpy(out.particles)[3].sum()
    assert alive < 2 * 8 * L ** 3           # the sphere absorbed some
    assert float(out.obj_potential[0]) < 0.0
    return sim


def test_flat_steps_match_pinc_tpu(sphere, cpu_devices):
    _steps_against_pinc_tpu(sphere, (2, 2, 2), cpu_devices[:8])


def test_flat_mgsolve_matches_pinc_tpu(sphere, cpu_devices):
    sim = _steps_against_pinc_tpu(sphere, (1, 2, 2), cpu_devices[:4],
                                  solver="mgSolve", phi_rtol=1e-4,
                                  pe_rtol=1e-3)
    assert type(sim._solve).__name__ == "ShardedMultigridSolver"


def test_flat_matches_single_device(sphere):
    """The sharded run() against the single-device run() of the same deck
    (pinc_tpu's test of its own sharded path)."""
    one = Simulation(PincConfig.from_string(_deck(sphere, (1, 1, 1),
                                                  steps=6)),
                     seed=4, device="cpu")
    h1 = one.run(progress_every=0)
    sim = make_simulation(PincConfig.from_string(_deck(sphere, (2, 2, 2),
                                                       steps=6)),
                          seed=4, device="cpu")
    assert isinstance(sim, ShardedSimulation)
    h = sim.run(progress_every=0)
    np.testing.assert_array_equal(sim.gather_particles().counts().numpy(),
                                  one.particles.counts().numpy())
    np.testing.assert_allclose(h["kinetic"].sum(1), h1["kinetic"].sum(1),
                               rtol=2e-3)
    np.testing.assert_allclose(sim.last_rho_obj.sum(),
                               one.last_rho_obj.sum(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(sim.last_obj_potential,
                               one.last_obj_potential, rtol=5e-3,
                               atol=1e-6)
    assert sim.last_rho_obj.sum() < 0.0


def test_window_and_checkpoint(sphere, tmp_path, monkeypatch):
    """make_scan_steps from the half-kicked state against run() (the same
    numbers), and a checkpoint of the sharded run (rho_obj in it)
    resumed to the uninterrupted run bit for bit; the in-memory grid
    (domain=) in place of the file."""
    dom = sphere_domain()
    text = _deck(sphere, (2, 1, 1), steps=6)
    run_sim = ShardedSimulation(PincConfig.from_string(text),
                                devices=["cpu"] * 2, domain=dom)
    hist = run_sim.run(progress_every=0)
    sim = ShardedSimulation(PincConfig.from_string(text),
                            devices=["cpu"] * 2, domain=dom)
    out = sim._half_kick(sim.particles)
    (parts, rho_obj), (ke, pe) = sim.make_scan_steps(6)(out.particles)
    np.testing.assert_array_equal(ke.numpy(), hist["kinetic"][1:])
    np.testing.assert_array_equal(pe.numpy(), hist["potential"][1:])
    np.testing.assert_array_equal(rho_obj.numpy(), run_sim.last_rho_obj)
    ck = text.replace("[time]", f"[files]\noutput = {tmp_path / 'run'}\n"
                      "checkpointEvery = 3\n[time]")
    # the first half through the CLI: the writer gets the global rho_obj
    # and, after the half kick, phi_c
    written = []
    write_step = OutputWriter.write_step

    def spy(self, n, out):
        written.append((n, tuple(out.rho_obj.shape),
                        out.obj_potential is not None))
        return write_step(self, n, out)
    monkeypatch.setattr(OutputWriter, "write_step", spy)
    deck = tmp_path / "deck.ini"
    deck.write_text(ck.replace("nTimeSteps = 6", "nTimeSteps = 3"))
    out = {}
    assert main([str(deck)], out=out, device="cpu") == 0
    assert isinstance(out["sim"], ShardedSimulation)
    assert written == [(n, (L,) * 3, n > 0) for n in range(4)]
    res = ShardedSimulation(PincConfig.from_string(
        ck.replace("[time]", "[time]\nresume = true")), devices=["cpu"] * 2)
    assert res.start_step == 3 and float(res.rho_obj.abs().sum()) > 0.0
    h = res.run(progress_every=0)
    # the resumed run distributed the checkpoint's population anew (dead
    # slots last), so immigrants take other free slots and the deposits
    # add in another order: the uninterrupted run within the tolerances
    np.testing.assert_allclose(h["kinetic"], hist["kinetic"][4:],
                               rtol=KE_RTOL)
    np.testing.assert_allclose(h["potential"], hist["potential"][4:],
                               rtol=PE_RTOL)
    q = float(sim.params.charge.abs().max())
    assert np.abs(res.last_rho_obj - run_sim.last_rho_obj).max() <= (
        RHO_RTOL * np.abs(run_sim.last_rho_obj).max() + 1e-7 * q)
    np.testing.assert_allclose(res.last_obj_potential,
                               run_sim.last_obj_potential, rtol=1e-4)
    for a, b in zip(res.particles, run_sim.particles):
        np.testing.assert_array_equal(a.alive.sum(1).numpy(),
                                      b.alive.sum(1).numpy())
