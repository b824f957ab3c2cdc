"""pinc_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, and the tiled slice on the card
against the same run on the CPU.  Every test here needs a CUDA card and
skips without one.

This file imports neither jax nor pinc_tpu, so it also runs where only the
port is installed (the test conftest imports jax; skip it there):

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: deposits max|kernel - plain| <= 1e-5 * max|plain| (atomics
add in another order); gathered fields and velocities atol 1e-5; moved
planes and n_out exact; vdot rtol 1e-5.  pic_step's new positions and
velocities are exact too (it rounds each product and sum on its own, in
the plain version's order), its tiles and vdot as the deposits' and the
kicks'.  efield_tiles and fold_global are exact (the same float32
operations in the same order).  The exchange kernels (extract, cleanup,
merge) and the whole exchange re-bucket are exact: they copy bits and add
+-T in f32 as the plain versions do.  So are the one-hot exchange kernels
(extract R = 1 and 8, by axis, all axes or given ranks; merge R = 1 and 8,
by block table or given free ranks; the cleanup), compared bit pattern for
bit pattern since they turn -0.0 into +0.0.  The slice and the scan on the
card vs the CPU: energies rtol 1e-4 and state atol 1e-4 (cuFFT vs pocketfft and
atomic-order sums, over 6 or 8 steps)."""

import numpy as np
import pytest
import torch

from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import field_kernels as fk
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec, bucket

MXU = {"f32": torch.float32, "bf16": torch.bfloat16}
KICKS = {
    "leapfrog": dict(),
    "boris": dict(boris=((0.01, -0.02, 0.03), (0.0199, -0.0398, 0.0597))),
    "e_ext": dict(e_ext=(0.05, 0.0, -0.02)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fixture(dev):
    """tests/test_pallas_tiled.py's layout: 3000 uniform particles in a
    16^3 grid, T=4, M=1, B=128, every 13th dead, bucketed on ``dev``."""
    ts = TileSpec(grid=(16, 16, 16), T=4, M=1, B=128)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0, 16, (3000, 3)).astype(np.float32))
    alive = torch.ones(3000, dtype=torch.bool)
    alive[::13] = False
    lp, _, la, _ = bucket(pos.to(dev), torch.zeros_like(pos).to(dev),
                          alive.to(dev), ts)
    vel = rng.normal(scale=0.3, size=(3, ts.NT, ts.B)).astype(np.float32)
    field = rng.normal(size=(ts.NT, ts.P, ts.P, ts.P, 3)).astype(np.float32)
    return ts, dict(xyz=lp.permute(2, 0, 1).contiguous(),
                    vel=torch.from_numpy(vel).to(dev),
                    alive=la.float(),
                    field=torch.from_numpy(field).to(dev))


def _max_err(a, b):
    return (a - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 0], ids=["cic", "ngp"])
@pytest.mark.parametrize("dt", list(MXU))
def test_kernels_match_plain(cuda, dt, order):
    ts, d = _fixture(cuda)
    mdt = MXU[dt]
    before = dict(tk.LAUNCHES)
    value = d["alive"] * 1.3
    got = tk.deposit(d["xyz"], value, ts, mxu_dtype=mdt, order=order)
    ref = tk.deposit_plain(d["xyz"], value, ts, mxu_dtype=mdt, order=order)
    assert _max_err(got, ref) <= 1e-5 * ref.abs().max().item()
    t, x, n = tk.deposit_move(d["xyz"], d["vel"], d["alive"], -1.7, ts,
                              mxu_dtype=mdt, order=order)
    tr, xr, nr = tk.deposit_move_plain(d["xyz"], d["vel"], d["alive"], -1.7,
                                       ts, mxu_dtype=mdt, order=order)
    assert _max_err(t, tr) <= 1e-5 * tr.abs().max().item()
    assert torch.equal(x, xr) and float(n) == float(nr) > 0
    g = tk.gather(d["field"], d["xyz"], ts, mxu_dtype=mdt, order=order)
    gr = tk.gather_plain(d["field"], d["xyz"], ts, mxu_dtype=mdt, order=order)
    assert _max_err(g, gr) <= 1e-5
    for kw in KICKS.values():
        v, vd = tk.gather_kick(d["field"], d["xyz"], d["vel"], d["alive"],
                               -0.37, ts, mxu_dtype=mdt, order=order, **kw)
        vr, vdr = tk.gather_kick_plain(d["field"], d["xyz"], d["vel"],
                                       d["alive"], -0.37, ts, mxu_dtype=mdt,
                                       order=order, **kw)
        assert _max_err(v, vr) <= 1e-5
        assert abs(float(vd) - float(vdr)) <= 1e-5 * abs(float(vdr))
    torch.cuda.synchronize()
    assert {k: tk.LAUNCHES[k] - before[k] for k in before} == {
        "deposit": 1, "deposit_move": 1, "gather": 1, "gather_kick": 3,
        "pic_step": 0}


@pytest.mark.cuda
def test_wrappers_check_their_inputs(cuda):
    ts, d = _fixture(cuda)
    with pytest.raises(TypeError, match="float32"):
        tk.deposit(d["xyz"], d["alive"].double(), ts)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gather(d["field"], d["xyz"].transpose(1, 2).contiguous()
                  .transpose(1, 2), ts)
    with pytest.raises(ValueError, match="is on"):
        tk.deposit_move(d["xyz"], d["vel"].cpu(), d["alive"], 1.0, ts)


def _step_fixture(dev):
    """Two species on _fixture's layout (as tests/test_torch_pic_step.py),
    and random E tiles in efield_tiles' layout."""
    ts, d = _fixture(dev)
    rng = np.random.default_rng(1)
    E = rng.normal(size=(ts.NT, 3 * ts.P, ts.P ** 2)).astype(np.float32)
    vel = 0.3 * d["vel"]
    return ts, dict(E=torch.from_numpy(E).to(dev),
                    lpos=torch.stack([d["xyz"], d["xyz"] + 0.01]),
                    vel=torch.stack([vel, -vel]),
                    alive=torch.stack([d["alive"], d["alive"]]),
                    charge=(-1.0, 1.5), qm=(-0.5, 0.25))


STEP_KICKS = {
    "leapfrog": dict(),
    "boris_eext": dict(e_ext=(0.05, 0.0, -0.02),
                       boris_T=((0.01, -0.02, 0.03), (0.001, 0.002, 0.003)),
                       boris_S=((0.0199, -0.0398, 0.0597),
                                (0.002, 0.004, 0.006))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("order", [(1, 1), (0, 0), (1, 0)],
                         ids=["cic", "ngp", "cic_ngp"])
@pytest.mark.parametrize("dt", list(MXU))
def test_pic_step_matches_plain(cuda, dt, order):
    ts, d = _step_fixture(cuda)
    mdt = MXU[dt]
    E = d["E"].to(mdt)
    before = tk.LAUNCHES["pic_step"]
    calls = 0
    for kw in STEP_KICKS.values():
        for margins in (None, ((1, 1), (0, 1))):
            args = (E, d["lpos"], d["vel"], d["alive"], d["charge"],
                    d["qm"], ts)
            opts = dict(mxu_dtype=mdt, order_acc=order[0],
                        order_distr=order[1], margins=margins, **kw)
            t, x, v, vd, n = tk.pic_step(*args, **opts)
            tr, xr, vr, vdr, nr = tk.pic_step_plain(*args, **opts)
            calls += 1
            assert _max_err(t, tr) <= 1e-5 * tr.abs().max().item()
            assert torch.equal(x, xr) and torch.equal(v, vr)
            assert torch.equal(n, nr) and float(n[0]) > 0
            assert torch.allclose(vd, vdr, rtol=1e-5, atol=0)
    lpos, vel = d["lpos"].clone(), d["vel"].clone()
    t2, x2, v2, _, _ = tk.pic_step(E, lpos, vel, d["alive"], d["charge"],
                                   d["qm"], ts, mxu_dtype=mdt,
                                   order_acc=order[0], order_distr=order[1],
                                   inplace=True)
    calls += 1
    assert x2 is lpos and v2 is vel
    xr = tk.pic_step_plain(E, d["lpos"], d["vel"], d["alive"], d["charge"],
                           d["qm"], ts, mxu_dtype=mdt, order_acc=order[0],
                           order_distr=order[1])[1]
    assert torch.equal(lpos, xr)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["pic_step"] - before == calls


@pytest.mark.cuda
@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 24, 32)),
                                         (8, 2, (16, 24, 32)),
                                         (4, 2, (16, 8, 24))])
def test_field_kernels_match_plain(cuda, T, M, shape):
    ts = TileSpec(grid=shape, T=T, M=M, B=128)
    rng = np.random.default_rng(T + M)
    phi = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    tiles = torch.from_numpy(rng.normal(size=(ts.NT, ts.P, ts.P ** 2))
                             .astype(np.float32)).to(cuda)
    before = dict(fk.LAUNCHES)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fk.efield_tiles(phi, ts, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, fk.efield_tiles_plain(phi, ts,
                                                      out_dtype=out_dtype))
    assert torch.equal(fk.fold_global(tiles, ts),
                       fk.fold_global_plain(tiles, ts))
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in before} == {
        "efield_tiles": 2, "fold_global": 1}


@pytest.mark.cuda
def test_step_and_field_wrappers_check_their_inputs(cuda):
    ts, d = _step_fixture(cuda)
    args = (d["lpos"], d["vel"], d["alive"], d["charge"], d["qm"], ts)
    with pytest.raises(TypeError, match="E must be"):
        tk.pic_step(d["E"].half(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        tk.pic_step(d["E"], d["lpos"].transpose(2, 3).contiguous()
                    .transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="is on"):
        tk.pic_step(d["E"].cpu(), *args)
    with pytest.raises(ValueError, match="shape"):
        fk.fold_global(torch.zeros((ts.NT, ts.P, ts.P), device=cuda), ts)
    with pytest.raises(TypeError, match="float32"):
        fk.efield_tiles(torch.zeros(ts.grid, dtype=torch.float64,
                                    device=cuda), ts)


def _exchange_fixture(dev, seed=0):
    """8 tiles (2x2x2 of 4^3 cells), B = 2048 (rows of 256 slots): 80% of
    the slots alive, spread over [-1.5, T+1.5); in tile 0 the first 200
    slots of every row leave through -x, past the 128-wide row caps."""
    rng = np.random.default_rng(seed)
    NT, B = 8, 2048
    alive = (rng.uniform(size=(NT, B)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, 5.5, (NT, B)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(NT, B)).astype(np.float32) for _ in range(3)]
    planes[0][0].reshape(8, 256)[:, :200] = -0.5
    alive[0].reshape(8, 256)[:, :200] = 1.0
    return (torch.from_numpy(alive).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in planes))


def _clone(alive, planes):
    return alive.clone(), tuple(p.clone() for p in planes)


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_exchange_kernels_match_plain(cuda):
    alive, planes = _exchange_fixture(cuda)
    before = dict(gx.LAUNCHES)
    extracts = {
        "dim0": (lambda a, p: gx.extract_rows_g(0, a, p, 128, 4),
                 lambda a, p: gx.extract_rows_g_plain(0, a, p, 128, 4)),
        "dim2": (lambda a, p: gx.extract_rows_g(2, a, p, 128, 4),
                 lambda a, p: gx.extract_rows_g_plain(2, a, p, 128, 4)),
        "all": (lambda a, p: gx.extract_all_rows_g(a, p, 128, 4),
                lambda a, p: gx.extract_all_rows_g_plain(a, p, 128, 4)),
        "compact": (lambda a, p: gx.extract_compact_rows_g(a, p, 128, 4),
                    lambda a, p: gx.extract_compact_rows_g_plain(a, p, 128,
                                                                 4)),
    }
    for name, (kern, plain) in extracts.items():
        b, a2 = kern(alive, planes)
        br, a2r = plain(alive, planes)
        assert _equal(b, br) and _equal(a2, a2r), name
        if name != "dim2":     # tile 0 overflows its x-minus (first) run
            assert float(b[0, 6, :, :128].sum()) == 8 * 128, name
    buf, _ = gx.extract_compact_rows_g(alive, planes, 384, 4)
    for axes in ((0, 1, 2), (1, 2), (2,)):
        st, e = gx.cleanup_rows_g(buf, 128, 4, axes)
        str_, er = gx.cleanup_rows_g_plain(buf, 128, 4, axes)
        assert _equal(st, str_) and all(map(_equal, e, er)), axes
    _, faces = gx.cleanup_rows_g(buf, 128, 4, (0, 1, 2))
    inc = torch.cat(faces, -1)
    blocks = tuple((128 * i, 128) for i in range(6))
    # rows 0-3 full, rows 4-7 empty: rows 0-3's arrivals spill, and the
    # tiles have less room than arrivals, so some are dropped
    room = torch.zeros((8, 8, 256), device=cuda)
    room[:, :4] = 1.0
    a_k, p_k = _clone(room.reshape(8, 2048), planes)
    a_p, p_p = _clone(room.reshape(8, 2048), planes)
    gx.merge_rows_g(a_k, inc, p_k, blocks)
    gx.merge_rows_g_plain(a_p, inc, p_p, blocks)
    assert _equal(a_k, a_p) and all(map(_equal, p_k, p_p))
    placed = a_k.reshape(8, 8, 256)[:, 4:].sum(-1)
    assert float(placed.sum()) < float(inc[:, 6].sum())
    assert bool((placed == 256).any()) and bool((placed > inc[:, 6, 4:].sum(-1)).any())
    torch.cuda.synchronize()
    assert {k: gx.LAUNCHES[k] - before[k] for k in before} == {
        "extract": 5, "cleanup": 4, "merge": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_dim"])
def test_exchange_drivers_match_cpu(cuda, fused):
    """The drivers on the card (kernels) and on the CPU (plain versions):
    planes, alive and the drop count, bit for bit, including tile 0's
    overflow drops."""
    alive, planes = _exchange_fixture("cpu", seed=1)
    outs = {}
    for dev in ("cpu", cuda):
        a, p = _clone(alive.to(dev), tuple(q.to(dev) for q in planes))
        outs[str(dev)] = ex.rebucket_exchange_planes(
            p, a, (2, 2, 2), 4, K=256, rows=True, fused=fused)
    (p_c, a_c, d_c), (p_g, a_g, d_g) = outs.values()
    assert int(d_g) == int(d_c) > 0
    assert torch.equal(a_g.cpu(), a_c)
    assert all(torch.equal(g.cpu(), c) for g, c in zip(p_g, p_c))


@pytest.mark.cuda
def test_exchange_wrappers_check_their_inputs(cuda):
    alive, planes = _exchange_fixture(cuda)
    with pytest.raises(ValueError, match="B % 1024"):
        gx.extract_compact_rows_g(alive[:, :1536].contiguous(),
                                  tuple(p[:, :1536].contiguous()
                                        for p in planes), 384, 4)
    with pytest.raises(ValueError, match="axes"):
        gx.cleanup_rows_g(torch.zeros((8, 7, 8, 128), device=cuda), 128, 4,
                          (0, 2))
    with pytest.raises(ValueError, match="is on"):
        gx.merge_rows_g(alive, torch.zeros((8, 7, 8, 128)), planes,
                        ((0, 128),))


def _onehot_fixture(dev, seed=0, B=640):
    """8 tiles (2x2x2 of 4^3 cells), B = 640 (rows of 80 slots, not a
    multiple of 32) or any B: 80% alive over [-1.5, 5.5); for B % 8 == 0
    the first 40 slots of every row of tile 0 leave through -x, past the
    row and tile caps; every 7th vy and 9th y is -0.0."""
    rng = np.random.default_rng(seed)
    alive = (rng.uniform(size=(8, B)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, 5.5, (8, B)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(8, B)).astype(np.float32) for _ in range(3)]
    if B % 8 == 0:
        planes[0][0].reshape(8, B // 8)[:, :40] = -0.5
        alive[0].reshape(8, B // 8)[:, :40] = 1.0
    planes[4][:, ::7] = -0.0
    planes[1][:, ::9] = -0.0
    return (torch.from_numpy(alive).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in planes))


def _bits_equal(a, b):
    """Same shape and float32 bit patterns (so -0.0 != +0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _room(dev, B=640):
    """Destination alive: every row of every tile half full, rows 0-4
    full (for B % 8 == 0), so arrivals outnumber some rows' free slots."""
    rng = np.random.default_rng(3)
    alive = (rng.uniform(size=(8, B)) < 0.5).astype(np.float32)
    if B % 8 == 0:
        alive.reshape(8, 8, B // 8)[:, :5] = 1.0
    return torch.from_numpy(alive).to(dev)


@pytest.mark.cuda
def test_onehot_kernels_match_plain(cuda):
    alive, planes = _onehot_fixture(cuda)
    before = dict(ox.LAUNCHES)
    for d in range(3):
        for kern, plain, R, cap in (
                (ox.extract_fused, ox.extract_fused_plain, 1, 32),
                (ox.extract_rows, ox.extract_rows_plain, 8, 16)):
            b, a2 = kern(planes[d], alive, planes, cap, 4)
            br, a2r = plain(planes[d], alive, planes, cap, 4)
            assert _bits_equal(b, br) and _bits_equal(a2, a2r), (d, R)
            if d == 0:          # tile 0 overflows the minus run's cap
                assert float(b[0, 6, :, :cap].sum()) == R * cap
    b6, a6 = ox.extract_all_rows(planes, alive, 16, 4)
    assert _bits_equal(b6, ox.extract_all_rows_plain(planes, alive, 16, 4)[0])
    assert _bits_equal(a6, ox.extract_all_rows_plain(planes, alive, 16, 4)[1])
    assert float(b6[0, 6, :, :16].sum()) == 8 * 16
    # the x hop of the v5 exchange, then its cleanups (Ke = 2 overflows)
    roll = gx._torch_roll
    inc_x = torch.cat([ox._roll_blocked(b6[..., :16], (2, 2, 2), 0, -1, roll),
                       ox._roll_blocked(b6[..., 16:32], (2, 2, 2), 0, 1,
                                        roll)], -1)
    inc_x = gx._shift_block(inc_x, 0, 4, ((16, 1), (16, -1)))
    for axes in ((1, 2), (2,)):
        st, e = ox.cleanup_rows(inc_x, 32, 2, 4, axes)
        sr, er = ox.cleanup_rows_plain(inc_x, 32, 2, 4, axes)
        assert _bits_equal(st, sr) and all(map(_bits_equal, e, er)), axes
    # merges into rows that cannot take every arrival
    inc_r, _ = ox.extract_rows(planes[0], alive, planes, 16, 4)
    inc_t, _ = ox.extract_fused(planes[1], alive, planes, 32, 4)
    f = [b6[..., i * 16:(i + 1) * 16] for i in range(6)]
    inc_a = torch.cat([f[0], f[1], f[2], f[0][..., :8], f[3], f[1][..., :8],
                       f[4], f[2][..., :8], f[3][..., :8], f[5],
                       f[4][..., :8], f[5][..., :8]], -1).contiguous()
    blocks, off = [], 0
    for w in (32, 48, 16, 8, 8, 16, 8, 8):
        blocks.append((off, w))
        off += w
    merges = {
        "rows": (lambda a, p: ox.merge_rows(a, inc_r, p, 16),
                 lambda a, p: ox.merge_rows_plain(a, inc_r, p, 16)),
        "fused": (lambda a, p: ox.merge_fused(a, inc_t, p, 32),
                  lambda a, p: ox.merge_fused_plain(a, inc_t, p, 32)),
        "all_rows": (lambda a, p: ox.merge_all_rows(a, inc_a, p, blocks),
                     lambda a, p: ox.merge_all_rows_plain(a, inc_a, p,
                                                          blocks)),
    }
    for name, (kern, plain) in merges.items():
        a_k, p_k = _clone(_room(cuda), planes)
        a_p, p_p = _clone(_room(cuda), planes)
        kern(a_k, p_k)
        plain(a_p, p_p)
        assert _bits_equal(a_k, a_p) and all(map(_bits_equal, p_k, p_p)), name
        assert float(a_k.sum()) > float(_room(cuda).sum()), name
    torch.cuda.synchronize()
    assert {k: ox.LAUNCHES[k] - before[k] for k in before} == {
        "onehot_extract_rows": 5, "onehot_extract_tile": 4,
        "onehot_cleanup": 2, "onehot_merge_rows": 2, "onehot_merge_tile": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("active", ["flags", "none", "skip"])
def test_onehot_ranked_kernels_match_plain(cuda, active):
    """pinc_tpu's B % 8 != 0 kernels, at B = 100 and at B = 2100 (chunks
    of 4 slots for the active flags): ranks given, K = 16."""
    for B in (100, 2100):
        alive, planes = _onehot_fixture(cuda, seed=1, B=B)
        al = alive > 0.5
        lm, lp = al & (planes[2] < 0), al & (planes[2] >= 4)
        rm = torch.cumsum(lm, 1, dtype=torch.int32) - 1
        rp = torch.cumsum(lp, 1, dtype=torch.int32) - 1
        rank = torch.where(lm & (rm < 16), rm,
                           torch.where(lp & (rp < 16), 16 + rp,
                                       torch.full_like(rm, -1)))
        rank = torch.where((lm & (rm >= 16)) | (lp & (rp >= 16)),
                           torch.full_like(rm, 32), rank)
        b, a2 = ox.extract(rank, alive, planes, 32)
        br, a2r = ox.extract_plain(rank, alive, planes, 32)
        assert _bits_equal(b, br) and _bits_equal(a2, a2r)
        room = _room(cuda, B)
        free = room <= 0.5
        fr_incl = torch.cumsum(free, 1, dtype=torch.int32)
        frank = torch.where(free, fr_incl - 1, torch.full_like(fr_incl, -1))
        act = None
        if active != "none":
            CB = ox._chunk(B)
            ends = fr_incl[:, CB - 1::CB]
            base = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
            act = ((base < b[:, 6].sum((-2, -1))[:, None]) & (ends > base)
                   ).to(torch.int32)
            if active == "skip":
                act[::2] = 0
        outs = []
        for merge in (ox.merge, ox.merge_plain):
            a, p = _clone(room, planes)
            merge(frank, a, b, p, active=act)
            outs.append((a, p))
        (a_k, p_k), (a_p, p_p) = outs
        assert _bits_equal(a_k, a_p) and all(map(_bits_equal, p_k, p_p))
        assert float(a_k[1::2].sum()) > float(room[1::2].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["v5", "v5_overflow", "v4", "v3", "v2"])
def test_onehot_drivers_match_cpu(cuda, route):
    """The one-hot drivers on the card (kernels) and on the CPU (plain
    versions): planes, alive and the drop count, bit for bit."""
    B = 100 if route == "v2" else 640
    alive, planes = _onehot_fixture("cpu", seed=2, B=B)
    kw = {"v5": dict(K=64, rows=True), "v5_overflow": dict(K=16, rows=True),
          "v4": dict(K=64, rows=True, fused=False),
          "v3": dict(K=32), "v2": dict(K=16)}[route]
    outs = []
    for dev in ("cpu", cuda):
        a, p = _clone(alive.to(dev), tuple(q.to(dev) for q in planes))
        outs.append(ex.rebucket_exchange_planes(p, a, (2, 2, 2), 4, **kw))
    (p_c, a_c, d_c), (p_g, a_g, d_g) = outs
    assert int(d_g) == int(d_c) > 0
    assert _bits_equal(a_g.cpu(), a_c)
    assert all(_bits_equal(g.cpu(), c) for g, c in zip(p_g, p_c))


@pytest.mark.cuda
def test_onehot_wrappers_check_their_inputs(cuda):
    alive, planes = _onehot_fixture(cuda, B=100)
    with pytest.raises(ValueError, match="B % 8"):
        ox.extract_rows(planes[0], alive, planes, 16, 4)
    with pytest.raises(TypeError, match="int32"):
        ox.extract(torch.zeros((8, 100), dtype=torch.int64, device=cuda),
                   alive, planes, 32)
    with pytest.raises(ValueError, match="two runs"):
        ox.merge(torch.zeros((8, 100), dtype=torch.int32, device=cuda),
                 alive, torch.zeros((8, 7, 1, 31), device=cuda), planes)
    alive, planes = _onehot_fixture(cuda)
    with pytest.raises(ValueError, match="is on"):
        ox.merge_fused(alive, torch.zeros((8, 7, 1, 64)), planes, 32)


DECK = """
[time]
nTimeSteps = 6
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 8 pc
nAlloc = 8 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.1,0.01
drift = 0.05
perturbAmplitude = 0.01,0,0,0,0,0
perturbMode = 1,0,0,0,0,0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
layout = tiled
[tiles]
tileSize = 4
margin = 2
rebucketEvery = 2
rebucket = sort
"""


# the exchange routes of the slice deck (8 per cell, T = 4: 512 per tile)
# by slack: B = 1024 takes the gather exchange, B = 640 the per-tile
# one-hot sweeps (the row gate fails), B = 1152 the fused one-hot rows
SLACK = {"exchange": 2.0, "onehot_tile": 1.25, "onehot_rows": 2.25}


@pytest.mark.cuda
@pytest.mark.parametrize("rebucket", ["sort", "exchange", "onehot_tile",
                                      "onehot_rows"])
@pytest.mark.parametrize("dt", list(MXU))
def test_slice_on_the_card_matches_cpu(cuda, dt, rebucket):
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    deck = DECK + f"mxuDtype = {dt}\n"
    if rebucket != "sort":
        deck = deck.replace("rebucket = sort\n",
                            f"slack = {SLACK[rebucket]}\n")
    runs = {}
    for dev in ("cpu", cuda):
        for m in (tk, fk, gx, ox):
            m.reset_launches()
        sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device=dev)
        runs[str(dev)] = (sim.run(progress_every=0), sim,
                          {**tk.LAUNCHES, **fk.LAUNCHES, **gx.LAUNCHES,
                           **ox.LAUNCHES})
    (h_cpu, s_cpu, n_cpu), (h_gpu, s_gpu, n_gpu) = runs.values()
    assert s_gpu._rebucket_mode == rebucket.split("_")[0].replace(
        "onehot", "exchange")
    assert n_cpu == {k: 0 for k in n_cpu}
    events = 2 * 3                                    # 2 species x 3 events
    want = {"deposit": 2, "gather": 2, "deposit_move": 12, "gather_kick": 12,
            "fold_global": 7}
    want.update({
        "sort": {},
        "exchange": {"extract": events, "cleanup": 3 * events,
                     "merge": events},
        "onehot_tile": {"onehot_extract_tile": 3 * events,
                        "onehot_merge_tile": 3 * events},
        "onehot_rows": {"onehot_extract_rows": events,
                        "onehot_cleanup": 2 * events,
                        "onehot_merge_rows": events}}[rebucket])
    assert {k: v for k, v in n_gpu.items() if v} == want
    assert s_gpu.state.lpos.is_cuda and h_gpu["dropped"] == 0
    np.testing.assert_allclose(h_gpu["kinetic"], h_cpu["kinetic"], rtol=1e-4)
    np.testing.assert_allclose(h_gpu["potential"], h_cpu["potential"],
                               rtol=1e-4)
    assert torch.equal(s_gpu.state.alive.cpu(), s_cpu.state.alive)
    np.testing.assert_allclose(s_gpu.state.lpos.cpu().numpy(),
                               s_cpu.state.lpos.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_gpu.state.vel.cpu().numpy(),
                               s_cpu.state.vel.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mega, fresh", [(True, True), (True, False),
                                         (False, True)],
                         ids=["sched", "generic", "pairs"])
def test_scan_on_the_card_matches_cpu(cuda, mega, fresh):
    """make_scan_steps on tests/test_torch_scan.py's window (8 steps,
    cadences [2, 4], M = 2) with the default exchange re-bucket (slack 2.0,
    B = 1024), on the card and on the CPU."""
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    deck = (DECK.replace("rebucket = sort\n", "slack = 2.0\n")
            .replace("rebucketEvery = 2\n", "") + "mxuDtype = f32\n"
            + ("" if mega else "mega = false\n"))
    runs = {}
    for dev in ("cpu", cuda):
        sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device=dev)
        sim.rebucket_every_s, sim.rebucket_every = [2, 4], 2
        run_n = sim.make_scan_steps(8, donate=True, fresh=fresh)
        for m in (tk, fk, gx):
            m.reset_launches()
        st, out = run_n(sim.state)
        runs[str(dev)] = (st, out, run_n.plan,
                          {**tk.LAUNCHES, **fk.LAUNCHES, **gx.LAUNCHES})
    (s_c, o_c, plan, n_c), (s_g, o_g, plan_g, n_g) = runs.values()
    assert plan == plan_g and n_c == {k: 0 for k in n_c}
    events = sum(len(arg) for kind, arg in plan if kind == "rebucket")
    assert events == 6
    want = {"extract": events, "cleanup": 3 * events, "merge": events}
    if mega:
        want.update(deposit=2, pic_step=8, fold_global=9, efield_tiles=9)
    else:
        want.update(deposit_move=16, gather_kick=16, fold_global=8)
    assert {k: v for k, v in n_g.items() if v} == want
    assert s_g.lpos.is_cuda and int(o_g[2]) == int(o_c[2]) == 0
    np.testing.assert_allclose(o_g[0].cpu().numpy(), o_c[0].numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(o_g[1].cpu().numpy(), o_c[1].numpy(),
                               rtol=1e-4)
    assert torch.equal(s_g.alive.cpu(), s_c.alive)
    np.testing.assert_allclose(s_g.lpos.cpu().numpy(), s_c.lpos.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_g.vel.cpu().numpy(), s_c.vel.numpy(),
                               rtol=0, atol=1e-4)
