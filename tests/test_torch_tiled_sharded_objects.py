"""pinc_tpu_torch's ShardedTiledSimulation on object decks (the sharded
object branches of parallel/tiled_pic.py) against pinc_tpu's and against
the port's single-device TiledSimulation, on a CPU mesh of
``["cpu"] * 2``.

The deck is tests/test_collisions.py's sphere deck (16^3, a sphere of
radius 2.5 at the centre, 8 per cell, vth 0.2 / 0.05, tiles of 4, margin
2, a re-bucket every 4 steps) over grid:nSubdomains = 2,1,1: the sphere
and its near-object tiles straddle the shard boundary.

* The object step (_tiled_step_obj) with absorb, reflect, adhere and
  absorb,secondary (ions emit electrons), step by step against pinc_tpu's
  jitted sharded step (its XLA route, the CPU's default), both from
  pinc_tpu's state after each step (so the secondary deck, whose emission
  angles hash velocity bits, is compared from one shared state a step);
  the re-buckets that run() would make between the steps are the port's
  (bit for bit pinc_tpu's exchange, tests/test_torch_tiled_sharded.py).
  The rules of tests/test_torch_tiled_objects.py: alive counts equal
  unless a particle whose absorption differs met a cell face within
  float32 round-off (tests/object_decks.py); rho_obj within 1e-5 of
  max|rho_obj| (+ 1e-7 max|q|, + |q| a flip), phi_c within 1e-5 of
  max|phi| (+ 1e-7), kinetic energy rtol 1e-5 and field energy rtol 1e-4
  on steps without a flip; the margin counts equal.  The guarantees of
  pinc_tpu's sharded tests hold at every step: no alive particle inside
  the object, the adhered charge on surface nodes only, and the total
  charge (particles plus rho_obj) conserved within 1e-5 of the gross
  charge with secondaries.
* The sharded window (make_scan_steps, rho_obj in the carry) against the
  sharded run(): the same energies, rho_obj, phi_c and alive flags.
* A sharded run() against the single-device tiled run() of the same
  global deck: alive counts equal, kinetic energy rtol 1e-5, field energy
  rtol 1e-4, rho_obj and phi_c as above.
* A resume from a sharded tiled object checkpoint is the uninterrupted
  run bit for bit (skips without h5py).
* The CLI (main, device="cpu") on the object deck with
  grid:nSubdomains = 2,1,1 and files:output: the writer gets the gathered
  fields, the global rho_obj and phi_c.
"""

import numpy as np
import pytest
import torch

import jax

from object_decks import (L, TILES_M2, deck, match_flips, sphere_domain,
                          total_charge)
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.parallel.tiled_pic import \
    ShardedTiledSimulation as JShardedTiled
from pinc_tpu_torch import compat
from pinc_tpu_torch import objects as po
from pinc_tpu_torch.__main__ import main
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.io_h5 import OutputWriter
from pinc_tpu_torch.ops.tiled import tile_origins
from pinc_tpu_torch.parallel.tiled_pic import ShardedTiledSimulation
from pinc_tpu_torch.tiled_sim import TiledSimulation

CPU2 = ["cpu"] * 2
NSUB = (2, 1, 1)
SPLIT = ["grid:nSubdomains=2,1,1", "grid:trueSize=8,16,16"]
STEPS = 4
RHO_RTOL = 1e-5
PHI_RTOL, PHI_ATOL = 1e-5, 1e-7
KE_RTOL, PE_RTOL = 1e-5, 1e-4
CHARGE_RTOL = 1e-5


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


def _text(path, ctype, steps=STEPS, vth="0.2,0.05", extra=""):
    return deck(path, ctype, steps=steps, layout="tiled", vth=vth,
                extra=TILES_M2 + extra)


def _cfg(cls, text, split=True):
    cfg = cls.from_string(text)
    if split:
        for o in SPLIT:
            k, v = o.split("=")
            cfg.set_str(k, v)
    return cfg


def _sharded(text, **kw):
    return ShardedTiledSimulation(_cfg(PincConfig, text), devices=CPU2,
                                  **kw)


def _planes(st):
    """pinc_tpu's sharded state (S, D, *nt, B) -> numpy (S, D, NT, B)
    planes over the global (x-major) tile grid."""
    S, D = st.lpos.shape[:2]
    B = st.lpos.shape[-1]
    return (np.asarray(st.lpos).reshape(S, D, -1, B),
            np.asarray(st.vel).reshape(S, D, -1, B),
            np.asarray(st.alive).reshape(S, -1, B))


def _global(lpos, vel, alive, ts):
    """Global planes -> (pos (S, N, D) wrapped, vel (S, N, D), alive)."""
    org = tile_origins(ts).numpy()
    g = np.mod(lpos + org.T[None, :, :, None], L)
    S, D = g.shape[:2]
    return (np.moveaxis(g, 1, -1).reshape(S, -1, D),
            np.moveaxis(vel, 1, -1).reshape(S, -1, D),
            alive.reshape(S, -1) > 0.5)


def _to_port(sim, jst):
    return compat.sharded_tiled_state_from_numpy(
        *(np.asarray(getattr(jst, k)) for k in ("lpos", "vel", "alive")),
        NSUB, sim.ctx.devices)


def _to_jax(sim, st, like):
    arrs = compat.sharded_tiled_state_to_numpy(st, NSUB,
                                               sim.ts_local.ntiles)
    return type(like)(*(jax.device_put(a, getattr(like, k).sharding)
                        for a, k in zip(arrs, ("lpos", "vel", "alive"))))


def _interior_alive(sim, pos, alive) -> int:
    iid = sim.objects.interior_id.numpy()
    c = np.clip(np.floor(pos).astype(np.int64), 0, L - 1)
    return int((alive & (iid[c[..., 0], c[..., 1], c[..., 2]] > 0)).sum())


@pytest.mark.parametrize("ctype", ["absorb", "reflect", "adhere",
                                   "secondary"])
def test_object_steps_match_pinc_tpu(sphere, cpu_devices, ctype):
    text = _text(sphere, ctype)
    jsim = JShardedTiled(_cfg(JConfig, text), seed=4,
                         devices=cpu_devices[:2])
    sim = _sharded(text, seed=4)
    assert sim.objects is not None and not sim._use_fused
    assert [int(t[0].numel()) for t in sim._shard_obj_tiles] == [32, 32]
    # the shards' initial states are pinc_tpu's
    got = compat.sharded_tiled_state_to_numpy(sim.state, NSUB,
                                              sim.ts_local.ntiles)
    for g, k in zip(got, ("lpos", "vel", "alive")):
        np.testing.assert_array_equal(g, np.asarray(getattr(jsim.state, k)))
    st, *_ = sim._tiled_half_kick_obj(sim.state)
    jst, *_ = jax.jit(jsim._tiled_half_kick_obj)(jsim.state)
    np.testing.assert_array_equal(
        compat.sharded_tiled_state_to_numpy(st, NSUB,
                                            sim.ts_local.ntiles)[2],
        np.asarray(jst.alive))
    jstep = jax.jit(jsim._tiled_step_obj)
    q = [float(v) for v in sim.params.charge]
    qmax = max(abs(v) for v in q)
    iid = sim.objects.interior_id.numpy()
    nrm = (None if sim.objects.normals is None
           else sim.objects.normals.numpy())
    jrho = jsim.spec.zeros()
    q0 = gross = None
    flips = 0
    for n in range(1, STEPS + 1):
        pre = _global(*_planes(jst), sim.ts)
        if q0 is None:
            gross = float(np.sum(np.abs(q) * pre[2].sum(1)))
            q0 = total_charge(q, pre[2].sum(1), 0.0)
        (st, rho, phi, E, diag, rho_obj, phi_c) = sim._tiled_step_obj(
            _to_port(sim, jst), torch.from_numpy(np.array(jrho)))
        jout = jstep(jst, jrho)
        jst, jrho = jout[0], jout[5]
        post = _global(*(a.numpy() for a in (
            sim._flat_state(st).lpos, sim._flat_state(st).vel,
            sim._flat_state(st).alive)), sim.ts)
        jpost = _global(*_planes(jst), sim.ts)
        flips += match_flips(pre, pre, post[2], jpost[2], iid, nrm)
        diff = post[2].sum(1).astype(int) - jpost[2].sum(1).astype(int)
        assert np.abs(diff).sum() <= flips, (n, diff, flips)
        rho_obj, jrho_np = rho_obj.numpy(), np.asarray(jrho)
        scale = np.abs(jrho_np).max() * RHO_RTOL + 1e-7 * qmax
        assert np.abs(rho_obj - jrho_np).max() <= scale + flips * qmax, n
        phi_max = float(np.abs(np.asarray(jout[2])).max())
        np.testing.assert_allclose(phi_c.numpy(), np.asarray(jout[6]),
                                   rtol=0,
                                   atol=PHI_RTOL * phi_max + PHI_ATOL)
        assert int(diag.n_lost) == int(jout[4].n_lost), n
        if not flips:
            np.testing.assert_allclose(diag.kin_energy.numpy(),
                                       np.asarray(jout[4].kin_energy),
                                       rtol=KE_RTOL)
            np.testing.assert_allclose(float(diag.pot_energy),
                                       float(jout[4].pot_energy),
                                       rtol=PE_RTOL)
        # pinc_tpu's guarantees, on the port's step
        assert _interior_alive(sim, post[0], post[2]) == 0, n
        if ctype == "adhere":
            sid = sim.objects.surface_id.numpy()
            assert (rho_obj[sid == 0] == 0).all()
        assert abs(total_charge(q, post[2].sum(1), rho_obj) - q0) \
            <= CHARGE_RTOL * gross, n
        # the re-buckets run() makes after this step (the port's)
        due = [s for s, R in enumerate(sim.rebucket_every_s) if n % R == 0]
        if int(diag.n_lost):
            due = list(range(len(q)))
        if due:
            st_p, dropped = sim._rebucket(_to_port(sim, jst), species=due)
            assert dropped == 0
            jst = _to_jax(sim, st_p, jst)
    assert float(np.asarray(jrho).sum()) < 0.0
    if ctype == "secondary":
        assert int(sim.see_emitted) > 0 and int(sim.see_overflow) == 0
    if ctype == "adhere":
        assert (np.asarray(jrho)[sid > 0] != 0).any()


def test_window_matches_run(sphere):
    """make_scan_steps on the mesh (rho_obj in the carry) against run()
    from the same half-kicked state; donate=False leaves the input as it
    was."""
    text = _text(sphere, "reflect", steps=6, vth="0.1,0.02")
    run_sim = _sharded(text)
    hist = run_sim.run(progress_every=0)
    assert hist["n_lost"] == 0 and hist["dropped"] == 0
    sim = _sharded(text)
    st, *_ = sim._tiled_half_kick_obj(sim.state)
    run_n = sim.make_scan_steps(6)
    before = [s.lpos.clone() for s in st]
    (st2, rho_obj), (ke, pe, dropped, phi_c) = run_n(st)
    assert all(torch.equal(s.lpos, b) for s, b in zip(st, before))
    assert int(dropped) == 0 and phi_c.shape == (6, 1)
    np.testing.assert_allclose(ke.numpy(), hist["kinetic"][1:], rtol=1e-6)
    np.testing.assert_allclose(pe.numpy(), hist["potential"][1:], rtol=1e-6)
    np.testing.assert_allclose(rho_obj.numpy(), run_sim.last_rho_obj,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(phi_c[-1].numpy(), run_sim.last_obj_potential,
                               rtol=1e-6)
    np.testing.assert_array_equal(sim._flat_state(st2).alive.numpy(),
                                  run_sim._flat_state(
                                      run_sim.state).alive.numpy())


def test_sharded_matches_single_device(sphere):
    """The sharded run() against the single-device tiled run() of the same
    global deck (the same host state; the sharded fold adds the halo
    planes in another order)."""
    text = _text(sphere, "absorb", steps=6, vth="0.1,0.02")
    one = TiledSimulation(_cfg(PincConfig, text, split=False), device="cpu")
    h1 = one.run(progress_every=0)
    sim = _sharded(text)
    h = sim.run(progress_every=0)
    np.testing.assert_array_equal(sim.particles.counts().numpy(),
                                  one.particles.counts().numpy())
    np.testing.assert_allclose(h["kinetic"], h1["kinetic"], rtol=KE_RTOL)
    np.testing.assert_allclose(h["potential"], h1["potential"],
                               rtol=PE_RTOL)
    q = float(sim.params.charge.abs().max())
    assert np.abs(sim.last_rho_obj - one.last_rho_obj).max() <= (
        RHO_RTOL * np.abs(one.last_rho_obj).max() + 1e-7 * q)
    phi_max = float(np.abs(one.last_obj_potential).max())
    np.testing.assert_allclose(sim.last_obj_potential,
                               one.last_obj_potential, rtol=0,
                               atol=1e-4 * phi_max)
    assert float(sim.objects.object_charge(sim.last_rho_obj)[0]) < 0.0


def _ckpt_text(path, out, steps, ck=0, resume=False):
    text = _text(path, "absorb", steps=steps, vth="0.1,0.02").replace(
        "[time]", f"[files]\noutput = {out}\ncheckpointEvery = {ck}\n[time]")
    if resume:
        text = text.replace("[time]", "[time]\nresume = true")
    return text


def test_checkpoint_resume_bit_for_bit(sphere, tmp_path):
    out = str(tmp_path / "run")
    full = _sharded(_ckpt_text(sphere, out + "_full", 6))
    full.run(progress_every=0)
    _sharded(_ckpt_text(sphere, out, 3, ck=3)).run(progress_every=0)
    res = _sharded(_ckpt_text(sphere, out, 6, resume=True))
    assert res.start_step == 3 and len(res.state) == 2
    assert float(res.rho_obj.abs().sum()) > 0.0
    res.run(progress_every=0)
    np.testing.assert_array_equal(res.last_rho_obj, full.last_rho_obj)
    np.testing.assert_array_equal(res.last_obj_potential,
                                  full.last_obj_potential)
    for k in ("lpos", "vel", "alive"):
        np.testing.assert_array_equal(
            getattr(res._flat_state(res.state), k).numpy(),
            getattr(full._flat_state(full.state), k).numpy())


def test_cli_runs_the_decomposed_object_deck(sphere, tmp_path,
                                             monkeypatch):
    """The CLI with files:output: the writer gets the gathered fields, the
    global rho_obj and, after the half kick, phi_c."""
    written = []
    write_step = OutputWriter.write_step

    def spy(self, n, out):
        written.append((n, tuple(out.rho.shape), tuple(out.rho_obj.shape),
                        out.obj_potential is not None))
        return write_step(self, n, out)
    monkeypatch.setattr(OutputWriter, "write_step", spy)
    path = tmp_path / "deck.ini"
    path.write_text(_text(sphere, "absorb", steps=3))
    out = {}
    assert main([str(path), *SPLIT, f"files:output={tmp_path / 'run'}"],
                out=out, device="cpu") == 0
    assert written == [(n, (L,) * 3, (L,) * 3, n > 0) for n in range(4)]
    sim = out["sim"]
    assert isinstance(sim, ShardedTiledSimulation) and sim.objects is not None
    assert sim.ctx.devices == [torch.device("cpu")] * 2
    assert np.isfinite(out["kinetic"]).all()
    assert np.isfinite(out["potential"]).all()
    assert np.isfinite(sim.last_obj_potential).all()
