"""pinc_tpu_torch's tiled layout operations, field solve and initial
conditions against pinc_tpu's, on inputs made from a seed with numpy.

Tolerances: bucketing, host initial conditions and device-init positions
exact (the same float32 arithmetic); fold / pad / global positions and
the plain tiled deposit / gather atol 1e-6 (float32 sums in another
order); the FFT solve rtol 1e-5 (two FFT libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.grid import (GridSpec as JGridSpec, gradient as j_gradient,
                           laplacian as j_laplacian)
from pinc_tpu.ops import tiled as jtl
from pinc_tpu.population import (device_species as j_device_species,
                                 initialize as j_initialize)
from pinc_tpu.solvers.spectral import SpectralSolver as JSpectral
from pinc_tpu.units import alloc_and_normalize as j_normalize
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.grid import GridSpec, gradient, laplacian
from pinc_tpu_torch.ops import tiled as tl
from pinc_tpu_torch.population import device_species, initialize
from pinc_tpu_torch.solvers.spectral import SpectralSolver
from pinc_tpu_torch.units import alloc_and_normalize


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(chunk=None, **kw):
    """pinc_tpu's TileSpec (with its deposition chunk, when given) and
    ours (whose deposit_tiled takes the chunk as an argument)."""
    jkw = kw if chunk is None else dict(kw, chunk=chunk)
    return jtl.TileSpec(**jkw), tl.TileSpec(**kw)


def _particles(n, L, seed=0, dead_every=13):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::dead_every] = False
    return pos, vel, alive


@pytest.mark.parametrize("B, n", [(128, 3000), (100, 3000), (8, 100)],
                         ids=["permuted", "identity-order", "overflow"])
def test_bucket_slot_for_slot(B, n):
    jts, ts = _specs(grid=(16, 16, 16), T=4, M=1, B=B, chunk=8)
    pos, vel, alive = _particles(n, 16.0)
    if n == 100:
        pos[:] = 1.5                       # everyone in one tile: overflow
    ref = jtl.bucket(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
                     jts)
    got = tl.bucket(torch.from_numpy(pos), torch.from_numpy(vel),
                    torch.from_numpy(alive), ts)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[3]) == int(ref[3])
    if n == 100:
        assert int(got[3]) == 92 - 8        # 92 live, 8 slots


def test_two_phase_bucketing_matches_bucket():
    _, ts = _specs(grid=(16, 16, 16), T=4, M=2, B=128)
    pos, vel, alive = (torch.from_numpy(a)
                       for a in _particles(3000, 16.0, seed=1))
    lp, lv, la, d = tl.bucket(pos, vel, alive, ts)
    lp2, la2, tid, d2 = tl.bucket_positions(pos, alive, ts)
    lv2 = tl.bucket_payload(tid, vel, ts)
    assert torch.equal(lp, lp2) and torch.equal(lv, lv2)
    assert torch.equal(la, la2) and int(d) == int(d2)


@pytest.mark.parametrize("M", [1, 2])
def test_fold_pad_and_global_positions(M):
    jts, ts = _specs(grid=(16, 8, 16), T=4, M=M, B=64)
    rng = np.random.default_rng(2)
    tiles = rng.normal(size=(ts.NT,) + (ts.P,) * 3).astype(np.float32)
    np.testing.assert_allclose(
        tl.fold_to_global(torch.from_numpy(tiles), ts).numpy(),
        np.asarray(jtl.fold_to_global(jnp.asarray(tiles), jts)),
        rtol=0, atol=1e-6)
    for shape in [(16, 8, 16), (16, 8, 16, 3)]:
        field = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            tl.pad_tiles(torch.from_numpy(field), ts).numpy(),
            np.asarray(jtl.pad_tiles(jnp.asarray(field), jts)),
            rtol=0, atol=1e-6)
    lpos = rng.uniform(-M, 4 + M, size=(ts.NT, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tl.global_positions(torch.from_numpy(lpos), ts).numpy(),
        np.asarray(jtl.global_positions(jnp.asarray(lpos), jts)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
def test_plain_tiled_deposit_and_gather(order):
    jts, ts = _specs(grid=(16, 16, 16), T=4, M=1, B=128, chunk=8)
    pos, vel, alive = _particles(3000, 16.0)
    lp, _, la, _ = jtl.bucket(jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(alive), jts)
    lp_t, la_t = torch.from_numpy(np.array(lp)), torch.from_numpy(np.array(la))
    np.testing.assert_allclose(
        tl.deposit_tiled(lp_t, la_t, 1.3, ts, order=order, chunk=8).numpy(),
        np.asarray(jtl.deposit_tiled(lp, la, 1.3, jts, order=order)),
        rtol=0, atol=1e-6)
    E = np.random.default_rng(3).normal(size=(16, 16, 16, 3)).astype(np.float32)
    Ep = jtl.pad_tiles(jnp.asarray(E), jts)
    np.testing.assert_allclose(
        tl.gather_tiled(torch.from_numpy(np.array(Ep)), lp_t, ts,
                        order=order).numpy(),
        np.asarray(jtl.gather_tiled(Ep, lp, jts, order=order)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("fd", [False, True], ids=["continuum", "fd"])
def test_spectral_solve(fd):
    shape = (16, 12, 8)
    rho = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ref = np.asarray(JSpectral(shape, fd=fd)(jnp.asarray(rho)))
    got = SpectralSolver(shape, fd=fd)(torch.from_numpy(rho)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    for mine, theirs in ((gradient, j_gradient), (laplacian, j_laplacian)):
        np.testing.assert_allclose(mine(torch.from_numpy(ref.copy())).numpy(),
                                   np.asarray(theirs(jnp.asarray(ref))),
                                   rtol=0, atol=1e-6)


DECK = """
[time]
nTimeSteps = 2
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 8,8,8
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 5 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.05
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
icPositions = {ic}
[methods]
acc = puAcc3D1KE
distr = puDistr3D1
poisson = sSolve
"""


def _normalized(ic):
    j = JConfig.from_string(DECK.format(ic=ic))
    t = PincConfig.from_string(DECK.format(ic=ic))
    j_normalize(j)
    alloc_and_normalize(t)
    return j, t


@pytest.mark.parametrize("ic", ["lattice", "uniform"])
def test_host_initialize_bit_identical(ic):
    j, t = _normalized(ic)
    jp, jparams = j_initialize(j, JGridSpec.from_config(j), seed=5)
    tp, tparams = initialize(t, GridSpec.from_config(t), seed=5)
    for k in ("cell", "frac", "vel", "alive"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    np.testing.assert_array_equal(tparams.charge.numpy(),
                                  np.asarray(jparams.charge))
    np.testing.assert_array_equal(tparams.mass.numpy(),
                                  np.asarray(jparams.mass))


def test_device_init_positions_and_velocity_statistics():
    """Device init: the same deterministic sub-lattice positions as
    pinc_tpu; velocities from a torch.Generator, so only their statistics
    are compared (drift 0.05, thermal 0.1, 2048 samples per component:
    mean within 5 sigma, std within 10%)."""
    j, t = _normalized("lattice")
    jspec, spec = JGridSpec.from_config(j), GridSpec.from_config(t)
    for s, vth in enumerate((0.1, 0.01)):
        jc, jf, _, ja = j_device_species(j, jspec, 5, s)
        c, f, v, a = device_species(t, spec, 5, s)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        live = v[a].numpy()
        assert live.shape == (4 * 512, 3)
        assert np.all(np.abs(live.mean(axis=0) - 0.05)
                      < 5 * vth / np.sqrt(len(live)))
        assert np.all(np.abs(live.std(axis=0) / vth - 1) < 0.1)
        assert not v[~a].any()
        c2, f2, _, _ = device_species(t, spec, 5, s, parts="pos")
        _, _, v2, _ = device_species(t, spec, 5, s, parts="vel")
        assert torch.equal(c2, c) and torch.equal(f2, f)
        assert torch.equal(v2, v)
