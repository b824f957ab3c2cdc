"""pinc_tpu_torch's tiled object step (TiledSimulation._tiled_step_obj,
_absorb and its responses, run() and the window) and the object
checkpoints against pinc_tpu's, on the CPU.

* Runs through the port's CLI (main, device="cpu") on tests/test_tiled_
  objects.py's deck (16^3, a sphere of radius 2.5, 8 per cell, tiles of
  4, margin 1, re-bucket every 3, 6 steps; tiles:rebucket = sort, since
  pinc_tpu's interpret-mode exchange takes minutes): absorb against
  pinc_tpu's TiledSimulation on tiles:backend = pallas (its kernels in
  interpret mode); reflect against pinc_tpu's flat run, as its own
  tests/test_tiled_objects.py compares; adhere against its tiled XLA
  route (an adhered charge goes to the surface corner nearest the
  crossing, and the flat layout's cell + frac rounds the crossing
  otherwise than the tiles' lpos + origin, which can pick another corner).
  Each step's alive counts are equal; where a particle's absorption
  differs (particles matched by position and velocity before the step) it
  must have met a cell face within float32 round-off
  (tests/object_decks.py), and energies are then compared up to that step
  only.  Per step: rho_obj within 1e-5 of max|rho_obj| (+ |q| a flip);
  against the tiled runs phi_c within 1e-5 of max|phi| (+ 1e-7), kinetic
  energy rtol 1e-5, field energy rtol 1e-4; against the flat run 5e-3,
  2e-3 and 5e-3 (tests/test_tiled_objects.py's 2e-3 and 5e-3), on steps
  without a margin hit: the tiled deposit leaves out the charge of
  particles beyond the tile margin for the step that re-buckets them,
  the flat one does not.  Charge is conserved within 1e-5 of the gross
  charge.
* The responses on the tiled planes (_absorb: reflect, adhere, secondary
  emission into the same tile's free slots) against pinc_tpu's _absorb on
  the same hand-built state: alive and emitted slots exact, planes atol
  1e-6, the adhered charge rtol 1e-5; the per-object counters rtol 1e-3
  (pinc_tpu's segment_sum adds its lanes one by one in float32), the
  port's within 1e-5 of whole charges.
* The window (make_scan_steps, rho_obj in the carry) against run(): the
  same energies, rho_obj, phi_c and state, on a deck with no margin hit.
* Checkpoints with rho_obj, flat and tiled: the port's file restores in
  pinc_tpu (the state and rho_obj exact; the flat run continued there
  within the flat tolerances), and pinc_tpu's file (checkpoint.save and
  save_tiled) resumes in the port bit for bit the port's uninterrupted
  run.  They skip without h5py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from object_decks import (L, TILES, TILES_M2, deck, match_flips,
                          sphere_domain, total_charge)
from pinc_tpu import checkpoint as jckpt
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.simulation import Simulation as JSimulation
from pinc_tpu.tiled_sim import TiledSimulation as JTiledSimulation
from pinc_tpu.tiled_sim import TiledState as JTiledState
from pinc_tpu_torch import objects as po
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops.tiled import tile_origins
from pinc_tpu_torch.simulation import Simulation
from pinc_tpu_torch.tiled_sim import TiledSimulation, TiledState

RHO_RTOL = 1e-5
PHI_RTOL, PHI_ATOL = 1e-4, 1e-7
# (KE, PE, phi_c relative to max|phi|) against pinc_tpu's tiled and flat
ENERGY_RTOL = {"tiled": (1e-5, 1e-4, 1e-5), "flat": (2e-3, 5e-3, 5e-3)}
STATE_ATOL = 1e-5
CHARGE_RTOL = 1e-5
COUNTER_RTOL = 1e-3     # _absorb's per-object sums against pinc_tpu's
STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sphere(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "sphere.grid.h5")
    po.save_domain(path, sphere_domain())
    return path


def _write(tmp_path, text, name="deck.ini"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _tiled_deck(path, ctype, extra="", steps=STEPS, layout="tiled"):
    """tests/test_tiled_objects.py's deck (vth 0.2 / 0.02) with the sort
    re-bucket."""
    return deck(path, ctype, steps=steps, layout=layout, vth="0.2,0.02",
                extra=TILES + "rebucket = sort\n" + extra)


def _global(lpos, alive, ts):
    """Tile planes (S, D, NT, B) -> (pos (S, NT*B, D) wrapped, alive)."""
    org = tile_origins(ts).numpy()                         # (NT, D)
    g = np.mod(np.asarray(lpos) + org.T[None, :, :, None], L)
    S, D = g.shape[:2]
    return (np.moveaxis(g, 1, -1).reshape(S, -1, D),
            np.asarray(alive).reshape(S, -1) > 0.5)


def _record_port_tiled(monkeypatch):
    """Each _tiled_step_obj of the port: (pre pos, vel, alive), post
    alive, rho_obj, phi_c, ke, pe."""
    rec = []
    step = TiledSimulation._tiled_step_obj

    def spy(self, st, rho_obj):
        pos, alive = _global(st.lpos.numpy(), st.alive.numpy(), self.ts)
        vel = np.moveaxis(st.vel.numpy(), 1, -1).reshape(pos.shape).copy()
        out = step(self, st, rho_obj)
        rec.append(((pos, vel, alive),
                    out[0].alive.numpy().reshape(alive.shape) > 0.5,
                    out[5].numpy(), out[6].numpy(),
                    out[4].kin_energy.numpy(), float(out[4].pot_energy),
                    float(out[2].abs().max()), int(out[4].n_lost)))
        return out
    monkeypatch.setattr(TiledSimulation, "_tiled_step_obj", spy)
    return rec


def _record_jax_flat(jsim):
    rec = []
    step = jax.jit(jsim._step)

    def spy(p, rho_obj):
        pre = (np.asarray(p.cell) + np.asarray(p.frac), np.asarray(p.vel),
               np.asarray(p.alive))
        out = step(p, rho_obj)
        rec.append((pre, np.asarray(out.particles.alive),
                    np.asarray(out.rho_obj), np.asarray(out.obj_potential),
                    np.asarray(out.diag.kin_energy),
                    float(out.diag.pot_energy),
                    float(jnp.abs(out.phi).max())))
        return out
    jsim._step_jit = spy
    return rec


def _record_jax_tiled(jsim):
    rec = []
    step = jax.jit(jsim._tiled_step_obj)

    def spy(st, rho_obj):
        pos, alive = _global(st.lpos, st.alive, jsim.ts)
        vel = np.moveaxis(np.asarray(st.vel), 1, -1).reshape(pos.shape)
        out = step(st, rho_obj)
        rec.append(((pos, vel, alive),
                    np.asarray(out[0].alive).reshape(alive.shape) > 0.5,
                    np.asarray(out[5]), np.asarray(out[6]),
                    np.asarray(out[4].kin_energy),
                    float(out[4].pot_energy),
                    float(jnp.abs(out[2]).max())))
        return out
    jsim._tstep_obj_jit = spy
    return rec


def _compare_runs(rec, jrec, sim, q, against):
    """Step by step, as the module docstring states."""
    assert len(rec) == len(jrec) == STEPS
    iid = sim.objects.interior_id.numpy()
    nrm = None if sim.objects.normals is None else sim.objects.normals.numpy()
    ke_rtol, pe_rtol, phi_rtol = ENERGY_RTOL[against]
    qmax = max(abs(v) for v in q)
    flips = hits = 0
    pre0 = rec[0][0][2].sum(1)
    gross = float(np.sum(np.abs(q) * pre0))
    q0 = total_charge(q, pre0, 0.0)
    assert (pre0 == jrec[0][0][2].sum(1)).all(), "the initial cull differs"
    for n, ((pre, post, rho_obj, phi, ke, pe, _, n_lost),
            (jpre, jpost, jrho_obj, jphi, jke, jpe, jphi_max)) in enumerate(
                zip(rec, jrec), 1):
        flips += match_flips(pre, jpre, post, jpost, iid, nrm)
        diff = post.sum(1).astype(int) - jpost.sum(1).astype(int)
        assert np.abs(diff).sum() <= flips, (n, diff, flips)
        scale = np.abs(jrho_obj).max() * RHO_RTOL + 1e-7 * qmax
        assert np.abs(rho_obj - jrho_obj).max() <= scale + flips * qmax, n
        assert abs(total_charge(q, post.sum(1), rho_obj) - q0) \
            <= CHARGE_RTOL * gross
        if n_lost and against == "flat":
            # the tiled deposit withholds the charge of particles beyond
            # the tile margin for this step (they are re-bucketed after
            # it), the flat one does not: the fields differ by design
            hits += 1
            continue
        np.testing.assert_allclose(phi, jphi, rtol=0,
                                   atol=phi_rtol * jphi_max + PHI_ATOL)
        if not flips:
            np.testing.assert_allclose(ke, jke, rtol=ke_rtol)
            np.testing.assert_allclose(pe, jpe, rtol=pe_rtol)
    assert hits < STEPS // 2
    return flips


@pytest.mark.parametrize("ctype, against, backend", [
    ("absorb", "tiled", "pallas"), ("reflect", "flat", None),
    ("adhere", "tiled", "xla")])
def test_tiled_run(tmp_path, sphere, monkeypatch, ctype, against, backend):
    text = _tiled_deck(sphere, ctype)
    rec = _record_port_tiled(monkeypatch)
    out = {}
    assert main([_write(tmp_path, text)], out=out, device="cpu") == 0
    sim = out["sim"]
    assert isinstance(sim, TiledSimulation) and sim.objects is not None
    assert not sim._use_fused and not sim._use_mega
    assert sim._obj_tiles.numel() == sim.ts.NT     # 16^3 at T = 4: all
    q = [float(v) for v in sim.params.charge]
    if against == "tiled":
        jsim = JTiledSimulation(JConfig.from_string(
            text + f"backend = {backend}\n"))
        jrec = _record_jax_tiled(jsim)
        jsim.run(progress_every=0)
        np.testing.assert_allclose(sim.state.vel.numpy(),
                                   np.asarray(jsim.state.vel),
                                   atol=STATE_ATOL)
    else:
        jsim = JSimulation(JConfig.from_string(
            text.replace("layout = tiled", "layout = flat")))
        jrec = _record_jax_flat(jsim)
        jsim.run(progress_every=0)
    _compare_runs(rec, jrec, sim, q, against)
    # run() leaves its last step's rho_obj and phi_c behind
    np.testing.assert_array_equal(sim.last_rho_obj, rec[-1][2])
    np.testing.assert_array_equal(sim.last_obj_potential, rec[-1][3])
    np.testing.assert_array_equal(np.asarray(jsim.last_rho_obj), jrec[-1][2])
    assert float(sim.objects.object_charge(sim.last_rho_obj)[0]) < 0.0
    iid = sim.objects.interior_id.numpy()
    if ctype != "absorb":
        c = sim.particles.cell.numpy()
        assert not (sim.particles.alive.numpy()
                    & (iid[c[..., 0], c[..., 1], c[..., 2]] > 0)).any()
    if ctype == "adhere":
        sid = sim.objects.surface_id.numpy()
        assert (sim.last_rho_obj[sid == 0] == 0).all()


def _wall_sims(tmp_path, ctypes, see=""):
    """Both packages' TiledSimulation on tests/test_collisions.py's box wall
    (z >= 10), tiles of 4 at margin 2."""
    pytest.importorskip("h5py")
    path = str(tmp_path / "box.grid.h5")
    po.save_domain(path, po.make_box((L,) * 3, (0, 0, 10),
                                     (L - 1, L - 1, L - 1)))
    text = deck(path, "absorb", steps=2, layout="tiled",
                extra=TILES_M2 + "rebucket = sort\n").replace(
        "collisionType = absorb,absorb", f"collisionType = {ctypes}\n{see}")
    return (TiledSimulation(PincConfig.from_string(text), device="cpu"),
            JTiledSimulation(JConfig.from_string(text)))


def _wall_state(sim, seed=0):
    """A hand-built tiled state: in every tile of the wall's first layer
    (origin z = 8) a few ions and electrons that moved into the wall, the
    rest of the slots dead (room for secondaries) or alive outside."""
    ts = sim.ts
    rng = np.random.default_rng(seed)
    S, D = 2, 3
    lpos = rng.uniform(0.0, ts.T, (S, D, ts.NT, ts.B)).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, (S, D, ts.NT, ts.B)).astype(np.float32)
    alive = (rng.random((S, ts.NT, ts.B)) < 0.5).astype(np.float32)
    org = tile_origins(ts).numpy()
    wall = np.flatnonzero(org[:, 2] == 8)
    for s in range(S):
        for k in range(6):
            lpos[s, 2, wall, k] = 2.1 + 0.3 * k             # z in [10.1, 11.6]
            vel[s, 2, wall, k] = 0.2 + 0.1 * k
            alive[s, wall, k] = 1.0
    return lpos, vel, alive


@pytest.mark.parametrize("ctypes, see", [
    ("reflect,adhere", ""),
    ("absorb,secondary", "seeYield = 2\nseeVth = 0.3\nseeSpecies = 0"),
    ("secondary,backscatter", "seeYield = 1\nseeVth = 0.1\nseeSpecies = 1"),
], ids=["reflect_adhere", "secondary_yield2", "secondary_self"])
def test_absorb_tile_planes(tmp_path, ctypes, see):
    sim, jsim = _wall_sims(tmp_path, ctypes, see)
    lpos, vel, alive = _wall_state(sim)
    st, counter, rho_add = sim._absorb(TiledState(
        lpos=torch.from_numpy(lpos.copy()), vel=torch.from_numpy(vel.copy()),
        alive=torch.from_numpy(alive.copy())))
    jst, jcounter, jrho_add = jsim._absorb(JTiledState(
        lpos=jnp.asarray(lpos), vel=jnp.asarray(vel),
        alive=jnp.asarray(alive)))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    assert (st.alive.numpy() != alive).sum() > 50
    live = st.alive.numpy() > 0.5
    for got, want in ((st.lpos, jst.lpos), (st.vel, jst.vel)):
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1)[live],
                                   np.moveaxis(np.asarray(want), 1, -1)[live],
                                   atol=1e-6)
    # pinc_tpu's counter has a leading entry for "no object", and its
    # segment_sum adds the 41k lanes one by one in float32; the port's
    # masked sums are pairwise, within round-off of whole charges here
    np.testing.assert_allclose(counter.numpy(), np.asarray(jcounter)[1:],
                               rtol=COUNTER_RTOL)
    units = counter.numpy() / abs(sim._charge[0])
    np.testing.assert_allclose(units, np.rint(units), rtol=1e-5)
    assert (rho_add is None) == (jrho_add is None)
    if rho_add is not None:
        np.testing.assert_allclose(rho_add.numpy(), np.asarray(jrho_add),
                                   rtol=RHO_RTOL, atol=1e-7)


def test_window_matches_run(tmp_path, sphere):
    """make_scan_steps on an object deck (rho_obj in the carry) against
    run() from the same half-kicked state; donate=False leaves the input
    as it was."""
    text = deck(sphere, "reflect", steps=STEPS, layout="tiled",
                vth="0.1,0.02", extra=TILES_M2 + "rebucket = sort\n")
    cfg = PincConfig.from_string(text)
    run_sim = TiledSimulation(cfg, device="cpu")
    hist = run_sim.run(progress_every=0)
    assert hist["n_lost"] == 0 and hist["dropped"] == 0
    sim = TiledSimulation(PincConfig.from_string(text), device="cpu")
    st, *_ = sim._tiled_half_kick_obj(sim.state)
    run_n = sim.make_scan_steps(STEPS)
    assert [k for k, _ in run_n.plan].count("step") == STEPS
    before = st.lpos.clone()
    (st2, rho_obj), (ke, pe, dropped, phi_c) = run_n(st)
    assert torch.equal(st.lpos, before)
    assert int(dropped) == 0 and phi_c.shape == (STEPS, 1)
    np.testing.assert_allclose(ke.numpy(), hist["kinetic"][1:], rtol=1e-6)
    np.testing.assert_allclose(pe.numpy(), hist["potential"][1:], rtol=1e-6)
    np.testing.assert_allclose(rho_obj.numpy(), run_sim.last_rho_obj,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(phi_c[-1].numpy(), run_sim.last_obj_potential,
                               rtol=1e-6)
    np.testing.assert_array_equal(st2.alive.numpy(),
                                  run_sim.state.alive.numpy())
    (st3, rho3), _ = sim.make_scan_steps(STEPS, donate=True)(st)
    assert torch.equal(st3.lpos, st2.lpos) and torch.equal(rho3, rho_obj)


def _ckpt_deck(path, out, layout, steps, ck=0, resume=False):
    extra = (TILES_M2 + "rebucket = sort\n") if layout == "tiled" else ""
    text = deck(path, "absorb", steps=steps, layout=layout, vth="0.1,0.02",
                extra=extra)
    text = text.replace("[time]", f"[files]\noutput = {out}\n"
                        f"checkpointEvery = {ck}\n[time]")
    if resume:
        text = text.replace("[time]", "[time]\nresume = true")
    return text


def test_flat_checkpoint_cross_packages(tmp_path, sphere):
    out = str(tmp_path / "run")
    full = Simulation(PincConfig.from_string(
        _ckpt_deck(sphere, out + "_full", "flat", 6)), device="cpu")
    full.run(progress_every=0)
    # the port writes at step 3; pinc_tpu restores and continues
    Simulation(PincConfig.from_string(_ckpt_deck(sphere, out, "flat", 3,
                                                 ck=3)),
               device="cpu").run(progress_every=0)
    jsim = JSimulation(JConfig.from_string(
        _ckpt_deck(sphere, out, "flat", 6, resume=True)))
    assert jsim.start_step == 3 and jsim.rho_obj is not None
    part = Simulation(PincConfig.from_string(
        _ckpt_deck(sphere, out, "flat", 6, resume=True)), device="cpu")
    assert part.start_step == 3
    np.testing.assert_array_equal(np.asarray(jsim.rho_obj),
                                  part.rho_obj.numpy())
    np.testing.assert_array_equal(np.asarray(jsim.particles.alive),
                                  part.particles.alive.numpy())
    jsim.run(progress_every=0)
    part.run(progress_every=0)
    np.testing.assert_array_equal(part.particles.alive.numpy(),
                                  full.particles.alive.numpy())
    np.testing.assert_array_equal(part.last_rho_obj, full.last_rho_obj)
    np.testing.assert_array_equal(np.asarray(jsim.particles.alive).sum(1),
                                  full.particles.alive.numpy().sum(1))
    np.testing.assert_allclose(np.asarray(jsim.last_rho_obj),
                               full.last_rho_obj, rtol=0,
                               atol=RHO_RTOL * np.abs(full.last_rho_obj).max())
    # pinc_tpu's file, written from the port's step-3 state, resumes in
    # the port bit for bit
    mid = Simulation(PincConfig.from_string(_ckpt_deck(sphere, out, "flat",
                                                       3)), device="cpu")
    mid.run(progress_every=0)
    from pinc_tpu.population import Particles as JParticles
    jcfg = JConfig.from_string(_ckpt_deck(sphere, out + "_j", "flat", 3))
    jckpt.save(jcfg, 3, JParticles(**{
        k: jnp.asarray(getattr(mid.particles, k).numpy())
        for k in ("cell", "frac", "vel", "alive")}), mid.rho_obj.numpy())
    res = Simulation(PincConfig.from_string(
        _ckpt_deck(sphere, out + "_j", "flat", 6, resume=True)),
        device="cpu")
    res.run(progress_every=0)
    np.testing.assert_array_equal(res.last_rho_obj, full.last_rho_obj)
    np.testing.assert_array_equal(res.particles.frac.numpy(),
                                  full.particles.frac.numpy())


def test_tiled_checkpoint_cross_packages(tmp_path, sphere):
    out = str(tmp_path / "run")
    full = TiledSimulation(PincConfig.from_string(
        _ckpt_deck(sphere, out + "_full", "tiled", 6)), device="cpu")
    full.run(progress_every=0)
    first = TiledSimulation(PincConfig.from_string(
        _ckpt_deck(sphere, out, "tiled", 3, ck=3)), device="cpu")
    first.run(progress_every=0)
    # the port's file restores verbatim in pinc_tpu
    jsim = JTiledSimulation(JConfig.from_string(
        _ckpt_deck(sphere, out, "tiled", 6, resume=True)))
    assert jsim.start_step == 3
    np.testing.assert_array_equal(np.asarray(jsim.rho_obj),
                                  first.rho_obj.numpy())
    for k in ("lpos", "vel", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(jsim.state, k)),
                                      getattr(first.state, k).numpy())
    # and in the port, which continues to the uninterrupted run
    res = TiledSimulation(PincConfig.from_string(
        _ckpt_deck(sphere, out, "tiled", 6, resume=True)), device="cpu")
    res.run(progress_every=0)
    np.testing.assert_array_equal(res.last_rho_obj, full.last_rho_obj)
    np.testing.assert_array_equal(res.state.lpos.numpy(),
                                  full.state.lpos.numpy())
    # pinc_tpu's file (save_tiled from the port's step-3 state)
    jcfg = JConfig.from_string(_ckpt_deck(sphere, out + "_j", "tiled", 3))
    jckpt.save_tiled(jcfg, 3, JTiledState(**{
        k: jnp.asarray(getattr(first.state, k).numpy())
        for k in ("lpos", "vel", "alive")}), first.rho_obj.numpy())
    res = TiledSimulation(PincConfig.from_string(
        _ckpt_deck(sphere, out + "_j", "tiled", 6, resume=True)),
        device="cpu")
    res.run(progress_every=0)
    np.testing.assert_array_equal(res.last_rho_obj, full.last_rho_obj)
    np.testing.assert_array_equal(res.state.alive.numpy(),
                                  full.state.alive.numpy())
