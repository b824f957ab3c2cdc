"""pinc_tpu_torch's embedded objects (objects.py, population.spawn and the
object step of the flat Simulation) against pinc_tpu's, on the CPU: the
same numpy inputs from a seed go through both packages.

* Geometry (find_interior, find_surface, surface_normals, make_sphere,
  make_box) is the same numpy code: exact, on one sphere, one box and two
  objects; the .grid.h5 files cross between the packages.
* The potential matrix A on tests/test_objects.py's cases, from the one
  Green's-function solve and from batched unit-charge solves (FFT):
  max|A - A_jax| <= 1e-6 * max|A_jax|.  ObjectSystem.build from a periodic
  sSolve deck and a Dirichlet mgSolve deck: equal interior and surface
  lists; C = A^-1 within cond(A) * 1e-6 (relative to max|C|); on the
  walled deck every batch's multigrid cycle counts equal pinc_tpu's
  (jax.vmap over its while_loop).
* _hash_uniform and the velocity bits it hashes: bit for bit, also at 0,
  0xFFFFFFFF and the constants' products.  cosine_directions,
  intersect_segments, collide_segments, collect_charge, apply_capacitance,
  _adhere, _emit_secondaries and spawn on the same particle arrays (the
  JAX side eager, op by op): masks, cells, slots and counts exact; floats
  atol 1e-6 (charges and rho rtol 1e-5 of their largest value).
* Flat runs (tests/test_collisions.py's sphere deck, 16^3, radius 2.5, 8
  per cell, 8 steps) with absorb, reflect, backscatter, adhere and
  secondary: each step of the port and of pinc_tpu's jitted step from the
  same state.  The alive masks must be equal every step; where one differs
  the particle must have met a cell face within float32 round-off
  (object_decks.assert_flip_within_roundoff: XLA fuses the bisection's
  products into FMAs, the port rounds each), and the port then continues
  from pinc_tpu's state.  The secondary deck continues from pinc_tpu's
  state every step: emission angles hash the impactor's velocity bits, so
  a field's last-bit round-off (pocketfft in XLA against PyTorch's FFT)
  gives other angles.  Per step: rho_obj within 1e-5 of max|rho_obj| (+
  1e-7 * max|q|), phi_c rtol 1e-4 (atol 1e-7), kinetic energy rtol 1e-5,
  field energy rtol 1e-4, positions and velocities of the particles alive
  in both atol 1e-5.  Total charge (particles and rho_obj) is conserved
  within 1e-5 of the gross charge.  The same deck through the port's CLI
  (main, device="cpu") gives the port's steps bit for bit.
* Dirichlet walls with the multigrid: the deck through main, flat and
  tiled, every particle inside the walls, charge conserved.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from object_decks import (L, assert_flip_within_roundoff, deck,
                          sphere_domain, total_charge)
from pinc_tpu import objects as jo
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.population import Particles as JParticles
from pinc_tpu.population import SpeciesParams as JParams
from pinc_tpu.population import spawn as jspawn
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.solvers.spectral import SpectralSolver as JSpectral
from pinc_tpu_torch import objects as po
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.population import (Particles, SpeciesParams,
                                       initialize, spawn)
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.solvers.spectral import SpectralSolver

h5py = pytest.importorskip("h5py")

FLOAT_ATOL = 1e-6       # per-particle functions on the same inputs
RHO_RTOL = 1e-5         # charges, rho, relative to their largest value
STATE_ATOL = 1e-5       # run positions and velocities
KE_RTOL, PE_RTOL = 1e-5, 1e-4
PHI_RTOL, PHI_ATOL = 1e-4, 1e-7
A_RTOL = 1e-6           # the potential matrix, relative to max|A|
CHARGE_RTOL = 1e-5      # charge conservation, relative to the gross charge


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, rtol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    scale = max(np.abs(b).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


# --------------------------------------------------------------- geometry
GEOMETRIES = {
    "sphere": lambda m: m.make_sphere((12,) * 3, (6, 6, 6), 2.0),
    "box": lambda m: m.make_box((8,) * 3, (3, 3, 3), (5, 5, 5)),
    "two": lambda m: m.make_box((16, 8, 8), (10, 2, 2), (12, 4, 4),
                                object_id=2,
                                domain=m.make_box((16, 8, 8), (2, 2, 2),
                                                  (4, 4, 4))),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_exact(name):
    dom, jdom = GEOMETRIES[name](po), GEOMETRIES[name](jo)
    np.testing.assert_array_equal(dom, jdom)
    n = int(dom.max())
    for f in ("find_interior", "find_surface"):
        got, want = getattr(po, f)(dom, n), getattr(jo, f)(dom, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    inside = po.find_interior(dom, n).any(axis=0)
    np.testing.assert_array_equal(po.surface_normals(inside),
                                  jo.surface_normals(inside))
    assert po.COLLISION_TYPES == jo.COLLISION_TYPES


def test_domain_files_cross_packages(tmp_path, monkeypatch):
    """Each package reads the other's .grid.h5; without h5py the port
    raises its HDF5 error."""
    dom = po.make_sphere((10, 8, 6), (5, 4, 3), 2.0)
    po.save_domain(str(tmp_path / "p.grid.h5"), dom)
    jo.save_domain(str(tmp_path / "j.grid.h5"), dom)
    np.testing.assert_array_equal(jo.load_domain(str(tmp_path / "p.grid.h5"),
                                                 3), dom)
    np.testing.assert_array_equal(po.load_domain(str(tmp_path / "j.grid.h5"),
                                                 3), dom)
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py is required"):
        po.load_domain(str(tmp_path / "j.grid.h5"), 3)


# ------------------------------------------------------- capacitance matrix
@pytest.mark.parametrize("periodic", [True, False],
                         ids=["green", "batched"])
def test_potential_matrix(periodic):
    """tests/test_objects.py:31-54's sphere: A from the one Green's solve
    and from unit-charge solves in batches of 8."""
    n = 12
    dom = po.make_sphere((n,) * 3, (6, 6, 6), 2.0)
    idx = np.flatnonzero(po.find_surface(dom, 1)[0].ravel())
    A = po.ObjectSystem._potential_matrix(
        idx, (n,) * 3, SpectralSolver((n,) * 3), torch.float32, periodic, 8)
    Aj = jo.ObjectSystem._potential_matrix(
        idx, (n,) * 3, JSpectral((n,) * 3), jnp.float32, periodic, 8)
    assert A.shape == Aj.shape == (len(idx), len(idx))
    _close(A, Aj, A_RTOL)


def test_two_objects_build():
    dom = GEOMETRIES["two"](po)
    obj = po.ObjectSystem.build(dom, SpectralSolver((16, 8, 8)))
    jobj = jo.ObjectSystem.build(dom, JSpectral((16, 8, 8)))
    assert obj.n_objects == jobj.n_objects == 2
    for a in range(2):
        np.testing.assert_array_equal(obj.surface_idx[a], jobj.surface_idx[a])
        _close(obj.inv_cap[a], jobj.inv_cap[a], 1e-5)
        assert obj.cap_sum[a] == pytest.approx(jobj.cap_sum[a], rel=1e-5)


def _jax_unit_solves(jsolver, idx, shape, batch=16):
    """pinc_tpu's batched unit-charge solves (objects.py:333-344) with
    each item's cycle count: jax.vmap over solve_with_stats."""
    solve = jax.jit(jax.vmap(jsolver.solve_with_stats))
    V = int(np.prod(shape))
    A = np.zeros((len(idx), len(idx)))
    cycles = []
    for start in range(0, len(idx), batch):
        chunk = idx[start:start + batch]
        rhs = np.zeros((len(chunk), V), np.float32)
        rhs[np.arange(len(chunk)), chunk] = 1.0
        phi, n_cyc, _ = solve(jnp.asarray(rhs.reshape((-1,) + shape)))
        A[:, start:start + len(chunk)] = np.asarray(
            phi, np.float64).reshape(len(chunk), -1)[:, idx].T
        cycles.append(np.asarray(n_cyc))
    return A, cycles


@pytest.mark.parametrize("walls", [False, True], ids=["periodic", "dirichlet"])
def test_build_from_deck(tmp_path, monkeypatch, walls):
    """ObjectSystem.build through the deck (objects.from_config inside
    Simulation): a periodic sSolve deck and the same deck in Dirichlet
    walls with the multigrid (the unit charges solved in batches of 16).
    The build's A is taken as _potential_matrix returns it."""
    from pinc_tpu.grid import GridSpec as JGridSpec
    from pinc_tpu.registry import SOLVERS as JSOLVERS
    from pinc_tpu.units import alloc_and_normalize
    path = str(tmp_path / "sphere.grid.h5")
    dom = sphere_domain()
    po.save_domain(path, dom)
    text = deck(path, walls=walls)
    built = []
    matrix = po.ObjectSystem._potential_matrix

    def spy(*args, **kw):
        built.append(matrix(*args, **kw))
        return built[-1]
    monkeypatch.setattr(po.ObjectSystem, "_potential_matrix",
                        staticmethod(spy))
    sim = Simulation(PincConfig.from_string(text), device="cpu")
    obj, (A,) = sim.objects, built
    jcfg = JConfig.from_string(text)
    alloc_and_normalize(jcfg)
    jsolver = JSOLVERS.select(jcfg, "methods:poisson")
    idx = np.flatnonzero(jo.find_surface(dom, 1)[0].ravel())
    np.testing.assert_array_equal(obj.surface_idx[0], idx)
    np.testing.assert_array_equal(
        obj.interior_id.numpy(), jo.find_interior(dom, 1)[0].astype(np.int32))
    assert obj.periodic == (not walls)
    if walls:
        Aj, jcycles = _jax_unit_solves(jsolver, idx, dom.shape)
        got = obj.setup["cycles"]
        assert len(got) == len(jcycles) == -(-len(idx) // 16)
        for g, w in zip(got, jcycles):
            np.testing.assert_array_equal(g, w)
    else:
        jobj = jo.from_config(jcfg, JGridSpec.from_config(jcfg), jsolver)
        np.testing.assert_array_equal(jobj.surface_idx[0], idx)
        Aj = jo.ObjectSystem._potential_matrix(
            idx, dom.shape, jsolver, jnp.float32, True, 16)
    _close(A, Aj, A_RTOL)
    Cj = np.linalg.inv(Aj)
    cond = np.linalg.cond(Aj)
    _close(obj.inv_cap[0], Cj, cond * A_RTOL)
    assert obj.cap_sum[0] == pytest.approx(1.0 / Cj.sum(),
                                           rel=cond * A_RTOL)


# ------------------------------------------------- per-particle functions
def test_hash_uniform_bit_exact():
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                  0x9E3779B1, 0xED5AD4BB, 0xAC4C1B51], np.uint64),
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64)])
    jb = jnp.asarray(bits.astype(np.uint32))
    pb = torch.as_tensor(bits.astype(np.int64))
    for k in range(3):
        cases = {
            "bits": (jo._hash_uniform(jb), po._hash_uniform(pb)),
            "odd": (jo._hash_uniform(jb + jnp.uint32(2 * k + 1)),
                    po._hash_uniform(pb + (2 * k + 1))),
            "golden": (jo._hash_uniform(jb * jnp.uint32(0x9E3779B1)
                                        + jnp.uint32(k)),
                       po._hash_uniform(po._mul32(pb, 0x9E3779B1) + k)),
        }
        for name, (want, got) in cases.items():
            want = np.asarray(want)
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32), err_msg=name)
    # the velocity bits: bitcast of float32, negative zero, infinities,
    # NaN and subnormals included
    v = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45,
                                  -1e-45, -1.0], np.float32),
                        rng.normal(size=5000).astype(np.float32)])
    want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(v),
                                                   jnp.uint32))
    np.testing.assert_array_equal(po.u32_bits(torch.as_tensor(v)).numpy(),
                                  want.astype(np.int64))


def test_cosine_directions():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(4000, 3))
    n[:1000, 2] = 10.0 * np.sign(n[:1000, 2])       # |n_z| >= 0.9 branch
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    u1, u2 = rng.random((2, 4000)).astype(np.float32)
    got = po.cosine_directions(_t(n), _t(u1), _t(u2)).numpy()
    want = np.asarray(jo.cosine_directions(jnp.asarray(n), jnp.asarray(u1),
                                           jnp.asarray(u2)))
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert ((got * n).sum(-1) >= 0).all()


def _wall():
    """tests/test_collisions.py's box wall: z >= 10 on 16^3."""
    dom = po.make_box((L,) * 3, (0, 0, 10), (L - 1, L - 1, L - 1))
    iid = (np.rint(dom) > 0.5).astype(np.int32)
    return dom, iid, po.surface_normals(iid > 0)


COLLISION_CASES = {
    # tests/test_collisions.py's plane, backscatter and miss cases
    "reflect_plane": ([[5.0, 5.0, 10.3]], [[0.2, -0.1, 0.8]], [True],
                      "reflect"),
    "backscatter": ([[5.0, 5.0, 10.4]], [[0.3, 0.0, 0.9]], [True],
                    "backscatter"),
    "miss": ([[1.0, 1.0, 1.0]], [[0.5, 0.0, 0.0]], [False], "reflect"),
}


def _random_hits(seed, n=3000):
    """Particles that moved into the wall of _wall() (and some that did
    not), velocities up to 0.9 a step."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                    rng.uniform(9.0, 11.5, n)], -1).astype(np.float32)
    vel = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    hit = pos[:, 2] >= 10.0
    return pos, vel, hit


@pytest.mark.parametrize("case", list(COLLISION_CASES) + ["random_reflect",
                                                          "random_backscatter"])
def test_collide_segments(case):
    _, iid, nrm = _wall()
    if case.startswith("random"):
        pos, vel, hit = _random_hits(2)
        method = case.split("_")[1]
    else:
        pos, vel, hit, method = COLLISION_CASES[case]
        pos, vel = np.float32(pos), np.float32(vel)
        hit = np.array(hit)
    t, x, n = po.intersect_segments(_t(pos), _t(vel), _t(iid), _t(nrm),
                                    (L,) * 3)
    tj, xj, nj = jo.intersect_segments(jnp.asarray(pos), jnp.asarray(vel),
                                       jnp.asarray(iid), jnp.asarray(nrm),
                                       (L,) * 3)
    for a, b in ((t, tj), (x, xj), (n, nj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FLOAT_ATOL)
    out = po.collide_segments(_t(pos), _t(vel), _t(hit), _t(iid), _t(nrm),
                              (L,) * 3, method)
    jout = jo.collide_segments(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(hit), jnp.asarray(iid),
                               jnp.asarray(nrm), (L,) * 3, method)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               atol=FLOAT_ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                               atol=FLOAT_ATOL)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    if case == "reflect_plane":
        assert not bool(out[2][0])
        assert out[1][0, 2] == pytest.approx(-0.8, abs=1e-5)
        assert out[0][0, 2] < 10.0
    if case == "miss":
        np.testing.assert_array_equal(out[0].numpy(), pos)


def _objects(dom, ctypes, **kw):
    shape = dom.shape
    return (po.ObjectSystem.build(dom, SpectralSolver(shape),
                                  collision_types=ctypes, **kw),
            jo.ObjectSystem.build(dom, JSpectral(shape),
                                  collision_types=ctypes, **kw))


def _particle_arrays(seed, cap, z_lo, z_hi, live=0.8):
    """Two species of cap slots: positions with z in [z_lo, z_hi), random
    velocities (the position is where the move ended), a live mask."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, L, (2, cap)), rng.uniform(0, L, (2, cap)),
                    rng.uniform(z_lo, z_hi, (2, cap))], -1)
    cell = np.floor(pos).astype(np.int32)
    frac = (pos - cell).astype(np.float32)
    vel = rng.uniform(-0.8, 0.8, (2, cap, 3)).astype(np.float32)
    vel[..., 2] = np.abs(vel[..., 2])                 # moving into +z
    alive = rng.random((2, cap)) < live
    return cell, frac, vel, alive


def _both(cell, frac, vel, alive, q=(-1.0, 1.0), m=(1.0, 1836.0)):
    return ((Particles(cell=_t(cell), frac=_t(frac), vel=_t(vel),
                       alive=_t(alive)),
             SpeciesParams(charge=torch.tensor(q), mass=torch.tensor(m))),
            (JParticles(cell=jnp.asarray(cell), frac=jnp.asarray(frac),
                        vel=jnp.asarray(vel), alive=jnp.asarray(alive)),
             JParams(charge=jnp.asarray(q, jnp.float32),
                     mass=jnp.asarray(m, jnp.float32))))


def _same_particles(p, pj):
    np.testing.assert_array_equal(p.alive.numpy(), np.asarray(pj.alive))
    live = p.alive.numpy()
    np.testing.assert_array_equal(p.cell.numpy()[live],
                                  np.asarray(pj.cell)[live])
    np.testing.assert_allclose(p.frac.numpy()[live], np.asarray(pj.frac)[live],
                               atol=FLOAT_ATOL)
    np.testing.assert_allclose(p.vel.numpy(), np.asarray(pj.vel),
                               atol=FLOAT_ATOL)


def test_collect_charge():
    dom = po.make_sphere((L,) * 3, (8, 8, 8), 3.0)
    obj, jobj = _objects(dom, ())
    (p, par), (pj, parj) = _both(*_particle_arrays(3, 4000, 4.0, 12.0))
    rho0 = np.random.default_rng(4).normal(size=(L,) * 3).astype(np.float32)
    p2, rho = obj.collect_charge(p, par, _t(rho0))
    pj2, rhoj = jobj.collect_charge(pj, parj, jnp.asarray(rho0))
    _same_particles(p2, pj2)
    assert int(p.alive.sum() - p2.alive.sum()) > 100       # absorbed some
    _close(rho - _t(rho0), np.asarray(rhoj) - rho0, RHO_RTOL)
    np.testing.assert_allclose(obj.object_charge(rho).numpy(),
                               np.asarray(jobj.object_charge(rhoj)),
                               rtol=RHO_RTOL)


def test_apply_capacitance_equipotential():
    """tests/test_objects.py's equipotential case: after the correction
    and a second solve the surface is an equipotential."""
    dom = po.make_sphere((L,) * 3, (8, 8, 8), 3.0)
    obj, jobj = _objects(dom, ())
    solver = SpectralSolver((L,) * 3)
    rho = 0.01 * np.random.default_rng(0).normal(
        size=(L,) * 3).astype(np.float32)
    phi = solver(_t(rho))
    rho2, phic = obj.apply_capacitance(_t(rho), phi)
    rho2j, phicj = jobj.apply_capacitance(jnp.asarray(rho),
                                          jnp.asarray(phi.numpy()))
    _close(rho2, rho2j, RHO_RTOL)
    np.testing.assert_allclose(phic.numpy(), np.asarray(phicj),
                               rtol=PHI_RTOL, atol=PHI_ATOL)
    phi2 = solver(rho2).numpy()
    surf = phi2.ravel()[obj.surface_idx[0]]
    assert surf.std() < 1e-6 * max(float(phi2.std()), 1e-12)
    assert surf.mean() == pytest.approx(float(phic[0]), rel=1e-4)


@pytest.mark.parametrize("ctypes, kw", [
    (("adhere", "adhere"), {}),
    (("absorb", "secondary"), dict(see_yield=2, see_vth=0.3, see_species=0)),
    (("secondary", "backscatter"), dict(see_yield=1, see_vth=0.1,
                                        see_species=1)),
    (("reflect", "adhere"), {}),
], ids=["adhere", "secondary_yield2", "secondary_self", "reflect_adhere"])
def test_collide_responses(ctypes, kw):
    """ObjectSystem.collide (_adhere, _emit_secondaries, collide_segments
    in the flat layout) on particles that moved into tests/test_collisions
    .py's wall, from the same arrays: masks, cells, the emitted slots and
    the failure count exact; rho_obj, fracs and velocities as stated."""
    dom, _, _ = _wall()
    obj, jobj = _objects(dom, ctypes, **kw)
    cell, frac, vel, alive = _particle_arrays(5, 2048, 9.0, 11.0, live=0.6)
    (p, par), (pj, parj) = _both(cell, frac, vel, alive)
    rho0 = np.zeros((L,) * 3, np.float32)
    p2, rho, nf = obj.collide(p, par, _t(rho0))
    pj2, rhoj, nfj = jobj.collide(pj, parj, jnp.asarray(rho0))
    _same_particles(p2, pj2)
    assert int(nf) == int(nfj)
    _close(rho, rhoj, RHO_RTOL)
    changed = (p2.alive.numpy() != alive).sum()
    assert changed > 100, "the responses must act on this input"
    if "secondary" in ctypes:
        # full target species: nothing emitted, nothing overwritten
        full = alive.copy()
        full[kw["see_species"]] = True
        (pf, _), (pfj, _) = _both(cell, frac, vel, full)
        p3, _, _ = obj.collide(pf, par, _t(rho0))
        pj3, _, _ = jobj.collide(pfj, parj, jnp.asarray(rho0))
        _same_particles(p3, pj3)


@pytest.mark.parametrize("fill", [0.5, 0.97], ids=["room", "overflow"])
def test_spawn(fill):
    rng = np.random.default_rng(7)
    cap, n = 512, 300
    cell, frac, vel, alive = _particle_arrays(8, cap, 0.0, float(L))
    alive = rng.random((2, cap)) < fill
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.7
    (p, _), (pj, _) = _both(cell, frac, vel, alive)
    got, ns, no = spawn(p, 1, _t(pos), _t(v), _t(mask))
    want, nsj, noj = jax.jit(jspawn, static_argnums=1)(
        pj, 1, jnp.asarray(pos), jnp.asarray(v), jnp.asarray(mask))
    for k in ("cell", "frac", "vel", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert (int(ns), int(no)) == (int(nsj), int(noj))
    assert (int(no) > 0) == (fill > 0.9)


# ------------------------------------------------------------------ runs
CTYPES = ["absorb", "reflect", "backscatter", "adhere", "secondary"]
RUN_STEPS = 8


def _port_particles(pj):
    return Particles(**{k: torch.as_tensor(np.asarray(getattr(pj, k)))
                        for k in ("cell", "frac", "vel", "alive")})


def _pos(p):
    return _np(p.cell).astype(np.float64) + _np(p.frac)


def _check_step(n, o, oj, pre_j, sim, q):
    """One step's comparison (see the module docstring); returns the
    number of particles whose alive flag differs (each checked to have
    met a cell face within float32 round-off)."""
    a, aj = o.particles.alive.numpy(), np.asarray(oj.particles.alive)
    flips = np.argwhere(a != aj)
    iid = sim.objects.interior_id.numpy()
    nrm = (None if sim.objects.normals is None
           else sim.objects.normals.numpy())
    for s, i in flips:
        assert_flip_within_roundoff(_pos(pre_j)[s, i],
                                    np.asarray(pre_j.vel)[s, i], iid, nrm)
    both = a & aj
    np.testing.assert_allclose(_pos(o.particles)[both],
                               _pos(oj.particles)[both], atol=STATE_ATOL)
    np.testing.assert_allclose(o.particles.vel.numpy()[both],
                               np.asarray(oj.particles.vel)[both],
                               atol=STATE_ATOL)
    rho_obj, rho_objj = o.rho_obj.numpy(), np.asarray(oj.rho_obj)
    scale = max(np.abs(rho_objj).max(), 1e-30) * RHO_RTOL + 1e-7 * max(
        abs(v) for v in q)
    diff = np.abs(rho_obj - rho_objj).max()
    # a flipped particle moves its charge between rho_obj and the plasma
    assert diff <= scale + len(flips) * max(abs(v) for v in q), (n, diff)
    np.testing.assert_allclose(o.obj_potential.numpy(),
                               np.asarray(oj.obj_potential),
                               rtol=PHI_RTOL, atol=PHI_ATOL)
    if not len(flips):
        np.testing.assert_allclose(o.diag.kin_energy.numpy(),
                                   np.asarray(oj.diag.kin_energy),
                                   rtol=KE_RTOL)
        np.testing.assert_allclose(float(o.diag.pot_energy),
                                   float(oj.diag.pot_energy), rtol=PE_RTOL)
    return len(flips)


@pytest.mark.parametrize("ctype", CTYPES)
def test_flat_run(tmp_path, ctype):
    path = str(tmp_path / "sphere.grid.h5")
    po.save_domain(path, sphere_domain())
    text = deck(path, ctype, steps=RUN_STEPS)
    # seed 1: the CLI's, so that main's run below starts from the same
    # particles
    sim = Simulation(PincConfig.from_string(text), device="cpu")
    jsim = JSimulation(JConfig.from_string(text))
    jstep = jax.jit(jsim._step)
    q = [float(v) for v in sim.params.charge]
    np.testing.assert_allclose(q, np.asarray(jsim.params.charge), rtol=1e-7)
    o, oj = sim._half_kick(sim.particles), jax.jit(jsim._half_kick)(
        jsim.particles)
    np.testing.assert_array_equal(o.particles.alive.numpy(),
                                  np.asarray(oj.particles.alive))
    gross = float(np.sum(np.abs(q) * o.particles.alive.sum(1).numpy()))
    q0 = total_charge(q, o.particles.alive.sum(1).numpy(), o.rho_obj)
    resync = ctype == "secondary"
    p, r, pj, rj = o.particles, o.rho_obj, oj.particles, oj.rho_obj
    port_steps, flips = [], 0
    for n in range(1, RUN_STEPS + 1):
        o, oj = sim._step(p, r), jstep(pj, rj)
        flips_n = _check_step(n, o, oj, pj, sim, q)
        flips += flips_n
        assert abs(total_charge(q, o.particles.alive.sum(1).numpy(),
                                o.rho_obj) - q0) <= CHARGE_RTOL * gross
        port_steps.append(o)
        if resync or flips_n:
            p, r = _port_particles(oj.particles), _t(oj.rho_obj)
        else:
            p, r = o.particles, o.rho_obj
        pj, rj = oj.particles, oj.rho_obj
    # the same deck through the port's CLI
    out = {}
    assert main([path_deck(tmp_path, text)], out=out, device="cpu") == 0
    run = out["sim"]
    assert type(run).__name__ == "Simulation" and run.objects is not None
    ke = np.stack([s.diag.kin_energy.numpy() for s in port_steps])
    if not (resync or flips):
        np.testing.assert_array_equal(out["kinetic"][1:], ke)
        np.testing.assert_array_equal(run.last_rho_obj,
                                      port_steps[-1].rho_obj.numpy())
        np.testing.assert_array_equal(run.last_obj_potential,
                                      port_steps[-1].obj_potential.numpy())
        np.testing.assert_array_equal(run.particles.alive.numpy(),
                                      port_steps[-1].particles.alive.numpy())
    assert np.isfinite(out["kinetic"]).all()
    assert abs(total_charge(q, run.particles.alive.sum(1).numpy(),
                            run.last_rho_obj) - q0) <= CHARGE_RTOL * gross
    if ctype == "absorb":
        # electrons are absorbed faster than ions: the sphere charges
        # negative (tests/test_objects.py's end-to-end check)
        assert float(run.objects.object_charge(run.last_rho_obj)[0]) < 0.0
        assert float(run.last_obj_potential[0]) < 0.0
    if ctype in ("reflect", "backscatter", "adhere"):
        iid = run.objects.interior_id.numpy()
        c = run.particles.cell.numpy()
        inside = iid[c[..., 0], c[..., 1], c[..., 2]] > 0
        assert not (run.particles.alive.numpy() & inside).any()


def path_deck(tmp_path, text) -> str:
    path = tmp_path / "deck.ini"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_walled_deck_through_main(tmp_path, layout):
    """Dirichlet walls (zero value) and the multigrid: the capacitance
    matrix from batched unit-charge solves (a 2^3 box, 26 surface nodes,
    to keep the CPU's solves short), the deck through main on the CPU,
    every particle inside the walls, charge conserved."""
    path = str(tmp_path / "box.grid.h5")
    po.save_domain(path, po.make_box((L,) * 3, (7, 7, 7), (8, 8, 8)))
    text = deck(path, "absorb", steps=3, layout=layout, vth="0.1,0.02",
                walls=True, extra="[tiles]\ntileSize = 4\nslack = 2\n"
                if layout == "tiled" else "")
    out = {}
    assert main([path_deck(tmp_path, text)], out=out, device="cpu") == 0
    sim = out["sim"]
    assert type(sim.solver).__name__ == "MultigridSolver"
    assert not sim.objects.periodic and sim.objects.setup["cycles"]
    if layout == "tiled":
        assert not sim._use_fused and not sim._use_mega
    p = sim.particles
    pos = _pos(p)[p.alive.numpy()]
    assert pos.min() >= 0.0 and pos.max() <= L - 1
    assert np.isfinite(out["kinetic"]).all()
    # charge after the initial cull (the CLI's seed-1 particles)
    q = [float(v) for v in sim.params.charge]
    p0, _ = initialize(sim.cfg, sim.spec, seed=1)
    iid = sim.objects.interior_id.numpy()
    c = p0.cell.numpy()
    kept = p0.alive.numpy() & (iid[c[..., 0], c[..., 1], c[..., 2]] == 0)
    q0 = total_charge(q, kept.sum(1), 0.0)
    gross = float(np.sum(np.abs(q) * kept.sum(1)))
    assert abs(total_charge(q, p.alive.sum(1).numpy(), sim.last_rho_obj)
               - q0) <= CHARGE_RTOL * gross
