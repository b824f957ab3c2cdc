"""pinc_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, and the tiled slice on the card
against the same run on the CPU.  Every test here needs a CUDA card and
skips without one.

This file imports neither jax nor pinc_tpu, so it also runs where only the
port is installed (the test conftest imports jax; skip it there):

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: deposits max|kernel - plain| <= 1e-5 * max|plain| (the
kernels sum in fixed point, the plain versions in float32); gathered fields and velocities atol 1e-5; moved
planes and n_out exact; vdot rtol 1e-5.  pic_step's new positions and
velocities are exact too (it rounds each product and sum on its own, in
the plain version's order), its tiles and vdot as the deposits' and the
kicks', and its tiles are bit-identical across launches (integer sums), as
are deposit's and deposit_move's.
efield_tiles and fold_global are exact (the same float32 operations in
the same order).  The exchange kernels (extract, cleanup,
merge) and the whole exchange re-bucket are exact: they copy bits and add
+-T in f32 as the plain versions do.  So are the one-hot exchange kernels
(extract R = 1 and 8, by axis, all axes or given ranks; merge R = 1 and 8,
by block table or given free ranks; the cleanup), compared bit pattern for
bit pattern since they turn -0.0 into +0.0.  The kernel benchmark's
variants (ops/kbench_kernels.py): int8 bit for bit, the others as the
deposits and within 1e-5 of max|plain| for the gathers; its exchange
primitives (ops/kbench_prims.py: take, roll, plane_add, lane_prefix) bit
pattern for bit pattern, NaN and INT32_MIN fills included.  The slice and
the scan on the card vs the CPU: energies rtol 1e-4 and state atol 1e-4
(cuFFT vs pocketfft and atomic-order sums, over 6 or 8 steps).  The
multigrid solve on the card vs the CPU: the same cycle count, phi atol
1e-4 of max|phi|, the final residual rtol 1e-3."""

import numpy as np
import pytest
import torch

from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import field_kernels as fk
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch import kbench
from pinc_tpu_torch.ops import kbench_kernels as kb
from pinc_tpu_torch.ops import kbench_prims as kp
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
@pytest.mark.parametrize("shape", ["fixture", "production"])
def test_deposit_tiles_are_deterministic(cuda, shape):
    """K1 and K2 sum their densities in integers, so two launches on the
    same input give bit-identical tiles: at the fixture (f32 and bf16, CIC
    and NGP; K1 with vmax given and read from the values) and at the bench
    deck's production shape (4096 tiles x 17,408 slots, M = 1, bf16
    weights, its electrons' charge), where the tiles are held against the
    plain versions too."""
    if shape == "fixture":
        ts, d = _fixture(cuda)
        cases = [(mdt, o) for mdt in MXU.values() for o in (1, 0)]
        q = -1.7
    else:
        ts = TileSpec(grid=(128, 128, 128), T=8, M=1, B=17408)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(8)
        NT, B = ts.NT, ts.B
        alive = (torch.rand((NT, B), generator=gen, device=cuda)
                 < 16384 / 17408).float()
        xyz = torch.rand((3, NT, B), generator=gen, device=cuda) * (
            ts.T + 2 * ts.M) - ts.M
        d = dict(xyz=torch.where(alive.bool(), xyz, -4.0).contiguous(),
                 alive=alive,
                 vel=0.05 * torch.randn((3, NT, B), generator=gen,
                                        device=cuda))
        cases = [(torch.bfloat16, 1)]
        q = -0.2 ** 2 / 32
    value = d["alive"] * q
    for mdt, order in cases:
        kw = dict(mxu_dtype=mdt, order=order)
        first = tk.deposit(d["xyz"], value, ts, vmax=abs(q), **kw)
        assert torch.equal(first, tk.deposit(d["xyz"], value, ts, **kw))
        moved = tk.deposit_move(d["xyz"], d["vel"], d["alive"], q, ts, **kw)
        again = tk.deposit_move(d["xyz"], d["vel"], d["alive"], q, ts, **kw)
        assert torch.equal(moved[0], again[0])
        assert first.abs().max().item() > 0
        if shape == "production":
            want = tk.deposit_plain(d["xyz"], value, ts, **kw)
            assert _max_err(first, want) <= 1e-5 * want.abs().max().item()
            want = tk.deposit_move_plain(d["xyz"], d["vel"], d["alive"], q,
                                         ts, **kw)[0]
            assert _max_err(moved[0], want) <= 1e-5 * want.abs().max().item()


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
@pytest.mark.parametrize("shape", ["fixture", "production"])
def test_pic_step_tiles_are_deterministic(cuda, shape):
    """K5 sums its densities in integers, so two launches on the same
    input give bit-identical tiles: at the fixture (f32 and bf16, CIC and
    NGP) and at the bench deck's production shape (4096 tiles x 17,408
    slots, M = 2, bf16 weights and E, two species)."""
    if shape == "fixture":
        ts, d = _step_fixture(cuda)
        cases = [(mdt, o) for mdt in MXU.values() for o in ((1, 1), (0, 0))]
    else:
        ts = TileSpec(grid=(128, 128, 128), T=8, M=2, B=17408)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(7)
        NT, B = ts.NT, ts.B
        alive = (torch.rand((2, NT, B), generator=gen, device=cuda)
                 < 16384 / 17408).float()
        lpos = torch.rand((2, 3, NT, B), generator=gen, device=cuda) * (
            ts.T + 2 * ts.M - 1e-3) - ts.M
        q = -0.2 ** 2 / 32
        d = dict(lpos=lpos, alive=alive,
                 vel=0.05 * torch.randn((2, 3, NT, B), generator=gen,
                                        device=cuda),
                 E=torch.randn((NT, 3 * ts.P, ts.P ** 2), generator=gen,
                               device=cuda), charge=(q, -q),
                 qm=(-1.0, 1.0 / 1836.0))
        cases = [(torch.bfloat16, (1, 1))]
    for mdt, (oa, od) in cases:
        args = (d["E"].to(mdt), d["lpos"], d["vel"], d["alive"], d["charge"],
                d["qm"], ts)
        kw = dict(mxu_dtype=mdt, order_acc=oa, order_distr=od)
        first = tk.pic_step(*args, **kw)[0]
        second = tk.pic_step(*args, **kw)[0]
        assert torch.equal(first, second)
        assert first.abs().max().item() > 0
        if shape == "production":
            want = tk.pic_step_plain(*args, **kw)[0]
            assert _max_err(first, want) <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 24, 32)),
                                         (8, 2, (16, 24, 32)),
                                         (4, 2, (16, 8, 24)),
                                         (8, 1, (16, 16, 80)),
                                         (8, 2, (8, 16, 24)),
                                         (6, 1, (6, 12, 18))])
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
@pytest.mark.parametrize("T, M, shape", [(8, 1, (16, 8, 40)),
                                         (8, 2, (8, 8, 8)),
                                         (8, 1, (16, 8, 16)),
                                         (6, 2, (12, 6, 18)),
                                         (3, 2, (6, 6, 9)),
                                         (2, 2, (8, 8, 8)),
                                         (8, 1, (128, 128, 128)),
                                         (8, 2, (128, 128, 128))])
def test_fold_kernel_matches_plain(cuda, T, M, shape):
    """K7 bit for bit (float32 bit patterns): fold_kernel's runs of tiles
    along z with ntz = 5, 1, 2 (the run's z-neighbours wrapping into it or
    onto its one tile), T = 6 (rows of rho off a 16-byte boundary), T =
    3 <= 2M+1, the scan's 128^3 shapes; M >= T takes fold_generic_kernel.
    The CPU emulation of the same runs is
    tests/test_torch_field_kernels.py's fold_runs."""
    ts = TileSpec(grid=shape, T=T, M=M, B=128)
    tiles = torch.from_numpy(np.random.default_rng(T * 10 + M).normal(
        size=(ts.NT, ts.P, ts.P ** 2)).astype(np.float32)).to(cuda)
    before = fk.LAUNCHES["fold_global"]
    got = fk.fold_global(tiles, ts)
    assert _bits_equal(got, fk.fold_global_plain(tiles, ts))
    assert fk.LAUNCHES["fold_global"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("T, M, shape", [(8, 2, (16, 16, 80)),
                                         (8, 1, (8, 8, 56)),
                                         (4, 2, (8, 8, 28)),
                                         (4, 1, (8, 8, 72)),
                                         (6, 2, (6, 12, 30))])
def test_efield_runs_match_plain(cuda, T, M, shape, dt):
    """K6's runs of tiles along z (4 at T = 8, 8 at T = 4 and 6): ntz % run
    != 0 (ntz = 10, 7, 7, 18, 5), spans off a 16-byte boundary, T <= 2M+1,
    Z % 4 != 0, and P compiled in (13, 11) or not (9, 7)."""
    ts = TileSpec(grid=shape, T=T, M=M, B=128)
    phi = torch.from_numpy(np.random.default_rng(T * M).normal(size=shape)
                           .astype(np.float32)).to(cuda)
    got = fk.efield_tiles(phi, ts, out_dtype=MXU[dt])
    assert torch.equal(got, fk.efield_tiles_plain(phi, ts,
                                                  out_dtype=MXU[dt]))


@pytest.mark.cuda
def test_efield_tiles_at_128(cuda):
    """K6 at the scan's 128^3 shape, M = 1 and 2, f32 and bf16."""
    rng = np.random.default_rng(128)
    phi = torch.from_numpy(rng.normal(size=(128, 128, 128))
                           .astype(np.float32)).to(cuda)
    for M in (1, 2):
        ts = TileSpec(grid=(128, 128, 128), T=8, M=M, B=17408)
        for dt in MXU.values():
            assert torch.equal(fk.efield_tiles(phi, ts, out_dtype=dt),
                               fk.efield_tiles_plain(phi, ts, out_dtype=dt))


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


def _merge_case(dev, L, rows_full, seed):
    """A merge at rows of L slots, 2 tiles: ~12% of the slots free (the
    bench deck after an extract), rows 0-3 full where rows_full; arrivals
    in the fused driver's 8 blocks (K = 256), a prefix of random length in
    each, ~25% of a block's width in rows 0-3 of tile 0 (spill, and at
    rows_full drops)."""
    rng = np.random.default_rng(seed)
    NT, B = 2, 8 * L
    widths = (256, 512, 128, 128, 128, 128, 128, 128)
    offs = np.cumsum((0,) + widths[:-1])
    blocks = tuple(zip(offs.tolist(), widths))
    alive = (rng.uniform(size=(NT, 8, L)) > 0.12).astype(np.float32)
    if rows_full:
        alive[0, :4] = 1.0
    inc = np.zeros((NT, 7, 8, sum(widths)), np.float32)
    for t in range(NT):
        for r in range(8):
            for o, w in blocks:
                frac = 0.25 if (t == 0 and r < 4) else 0.06
                n = int(rng.integers(0, int(w * frac) + 1))
                inc[t, :6, r, o:o + n] = rng.normal(size=(6, n))
                inc[t, 6, r, o:o + n] = 1.0
    planes = tuple(torch.from_numpy(rng.normal(size=(NT, B))
                                    .astype(np.float32)).to(dev)
                   for _ in range(6))
    return (torch.from_numpy(alive.reshape(NT, B)).to(dev),
            torch.from_numpy(inc).to(dev), planes, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("L, rows_full", [(2176, False), (2176, True),
                                          (256, True), (128, False)])
def test_merge_kernel_matches_plain(cuda, L, rows_full):
    """K9 against its plain version, planes and alive bit for bit: the
    bench deck's rows (L = 2176) at its free density, and with rows 0-3 of
    tile 0 full (spill into rows 4-7); at L = 256 and 128 the rows have
    less room than arrivals (spill passes and drops)."""
    alive, inc, planes, blocks = _merge_case(cuda, L, rows_full, L)
    before = dict(gx.LAUNCHES)
    a_k, p_k = _clone(alive, planes)
    a_p, p_p = _clone(alive, planes)
    gx.merge_rows_g(a_k, inc, p_k, blocks)
    gx.merge_rows_g_plain(a_p, inc, p_p, blocks)
    torch.cuda.synchronize()
    assert _equal(a_k, a_p) and all(map(_equal, p_k, p_p))
    placed = float(a_k.sum() - alive.sum())
    assert placed > 0
    if L == 2176 and rows_full:
        rows = a_k.view(2, 8, L)[0, 4:] - alive.view(2, 8, L)[0, 4:]
        assert float(rows.sum()) > float(inc[0, 6, 4:].sum())     # spill
    if L < 2176:
        assert placed < float(inc[:, 6].sum())                    # drops
    assert gx.LAUNCHES["merge"] - before["merge"] == 1


@pytest.mark.cuda
def test_merge_kernel_needs_aligned_alive(cuda):
    """K9 walks alive in 16-byte groups from each row's start."""
    alive, inc, planes, blocks = _merge_case(cuda, 256, False, 3)
    shifted = torch.zeros(alive.numel() + 1, device=cuda)[1:].view(
        alive.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gx.merge_rows_g(shifted, inc, planes, blocks)


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
    # the extract's 16-byte loads: a plane one float past a boundary
    shifted = torch.zeros(8 * 2048 + 1, device=cuda)[1:].view(8, 2048)
    with pytest.raises(ValueError, match="16-byte"):
        gx.extract_rows_g(1, alive, (planes[0], shifted) + planes[2:], 128,
                          4)


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


# K11's merge_kernel<R> cases, shared with the CPU emulation of
# tests/test_torch_onehot_merge_vec.py: (alive (NT, B), inc (NT, 7, R, KT),
# 6 planes (NT, B)) made from a seed.  The flags of a block are set at
# random columns, not as a prefix of the block (no caller of the kernel
# guarantees a prefix), with payloads in every column, flagged or not; some
# payloads are -0.0, which the merge stores as +0.0.

# block tables: (offset, width) runs of a row of the buffer
MERGE_TABLES = {
    # merge_rows / merge_fused: minus [0, K), plus [K, 2K); K % 4 != 0
    "two": ((0, 13), (13, 13)),
    "one": ((0, 37),),
    # runs with a gap and out of column order
    "gaps": ((20, 9), (0, 6), (33, 11)),
    # merge_all_rows' eight runs (Wx, 2(Ks+Ke), Ks, Ke, Ke, Ks, Ke, Ke) at
    # Ks = 13, Ke = 5
    "eight": tuple(zip((0, 26, 62, 75, 80, 85, 98, 103),
                       (26, 36, 13, 5, 5, 13, 5, 5))),
}

# (fraction of free slots, fraction of flagged columns) per tile
MERGE_CASES = {
    "roomy": [(0.4, 0.3), (0.2, 0.5)],
    "overflow": [(0.02, 0.8), (0.0, 0.5), (0.05, 1.0)],   # arrivals drop
    "no arrivals": [(0.3, 0.0)],
    "all free": [(1.0, 0.6)],
}


def merge_inputs(B, R, table, case, seed):
    """alive, inc, planes, blocks of a named case: tile t has a fraction
    MERGE_CASES[case][t][0] of its slots free (in tile 0 of "roomy" rows 2
    and 5 full, row 6 all free) and a fraction [t][1] of each block's
    columns flagged."""
    blocks = MERGE_TABLES[table] if isinstance(table, str) else table
    rng = np.random.default_rng(seed)
    spec = MERGE_CASES[case]
    NT = len(spec)
    KT = max(o + w for o, w in blocks)
    alive = np.ones((NT, B), np.float32)
    inc = np.zeros((NT, 7, R, KT), np.float32)
    for t, (free, arr) in enumerate(spec):
        alive[t, rng.uniform(size=B) < free] = 0.0
        for o, w in blocks:
            inc[t, 6, :, o:o + w] = rng.uniform(size=(R, w)) < arr
    if case == "roomy":
        rows = alive[0].reshape(8, B // 8)
        rows[2] = rows[5] = 1.0
        rows[6] = 0.0
    inc[:, :6] = rng.normal(size=(NT, 6, R, KT))
    inc[:, 4, :, ::7] = -0.0
    inc[:, 0, :, 1::5] = -0.0
    planes = [rng.uniform(-1.0, 5.0, (NT, B)).astype(np.float32)
              for _ in range(6)]
    planes[3][:, ::5] = -0.0
    return alive, inc, planes, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["roomy", "overflow", "all free"])
@pytest.mark.parametrize("table", list(MERGE_TABLES))
@pytest.mark.parametrize("R, L", [(8, 81), (8, 960), (1, 81), (1, 816),
                                  (1, 323)])
def test_onehot_merge_kernel_matches_plain(cuda, R, L, table, case):
    """K11's merge_kernel<R> against its plain version, planes and alive
    bit pattern for bit pattern, on merge_inputs' cases
    (those the CPU emulation, tests/test_torch_onehot_merge_vec.py, holds
    against pinc_tpu): rows off a 16-byte boundary (L = 81, 323), the v5
    and v3 decks' rows (L = 960, 816), runs of 1, 2, 3 and 8 with KT % 4 !=
    0, flags not a prefix of their run, -0.0 payloads, more arrivals than
    free slots (drops) and every slot free."""
    alive, inc, planes, blocks = merge_inputs(8 * L, R, table, case,
                                              seed=L + R)
    a0 = torch.from_numpy(alive).to(cuda)
    inc = torch.from_numpy(inc).to(cuda)
    p0 = tuple(torch.from_numpy(p).to(cuda) for p in planes)
    name = "onehot_merge_rows" if R == 8 else "onehot_merge_tile"
    before = ox.LAUNCHES[name]
    a_k, p_k = _clone(a0, p0)
    a_p, p_p = _clone(a0, p0)
    ox._merge(name, a_k, inc, p_k, blocks, R)
    ox._merge_plain(a_p, inc, p_p, blocks)
    torch.cuda.synchronize()
    assert _bits_equal(a_k, a_p) and all(map(_bits_equal, p_k, p_p))
    assert ox.LAUNCHES[name] == before + 1
    placed = float(a_k.sum() - a0.sum())
    arrivals = float((inc[:, 6] > 0.5).sum())
    if case == "overflow":
        assert 0 < placed < arrivals


@pytest.mark.cuda
@pytest.mark.parametrize("active", ["flags", "none", "skip", "permuted"])
def test_onehot_ranked_kernels_match_plain(cuda, active):
    """pinc_tpu's B % 8 != 0 kernels, at B = 100 and at B = 2100 (chunks
    of 4 slots for the active flags) and 2101 (chunks of 1: the merge
    lists its active chunks in two windows): ranks given, K = 16.
    "permuted": the free ranks permuted within each tile (not monotone in
    slot order), the first two free slots of a tile sharing a rank, and
    the active flags of the chunks that hold a rank below the arrivals."""
    for B in (100, 2100, 2101):
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
        if active == "permuted":
            gen = torch.Generator(device=cuda)
            gen.manual_seed(B)
            for t in range(frank.shape[0]):
                slots = torch.nonzero(free[t]).flatten()
                frank[t, slots] = torch.randperm(
                    len(slots), generator=gen, device=cuda).int()
                frank[t, slots[1]] = frank[t, slots[0]]
            CB = ox._chunk(B)
            n_arr = b[:, 6].sum((-2, -1))[:, None, None]
            fr = frank.reshape(frank.shape[0], B // CB, CB)
            act = ((fr >= 0) & (fr < n_arr)).any(-1).to(torch.int32)
        elif active != "none":
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


def _spread_ranks(B, K2, seed, empty):
    """Ranks of ~half of each tile's slots at distinct random columns of
    [0, max(1.1 K2, 2 B)) (ranks >= K2 killed, not copied), -1 elsewhere;
    tile `empty` none."""
    rng = np.random.default_rng(seed)
    rank = np.full((8, B), -1, np.int32)
    for t in range(8):
        on = np.flatnonzero(rng.uniform(size=B) < 0.5)
        rank[t, on] = rng.choice(max(int(1.1 * K2), 2 * B), len(on),
                                 replace=False)
    if not (rank[0] == K2 - 1).any():          # the last column is reached
        rank[0, np.flatnonzero(rank[0] >= 0)[0]] = K2 - 1
    rank[empty] = -1
    return rank


@pytest.mark.cuda
@pytest.mark.parametrize("B, K2", [(101, 32), (101, 30), (2101, 9001),
                                   (640, 8192), (100, 4097)])
def test_onehot_ranked_extract_matches_plain(cuda, B, K2):
    """The ranked extract's staged columns: B % 8 != 0 (rows off a 16-byte
    boundary), K2 % 4 != 0, a K2 spanning two or three blocks of 4096
    columns, ranks >= K2, an empty tile; alive and alive' also read and
    written off rank's 16-byte offset (views one word into larger
    tensors: scalar accesses)."""
    alive, planes = _onehot_fixture(cuda, seed=B + K2, B=B)
    rank = torch.from_numpy(_spread_ranks(B, K2, K2, empty=3)).to(cuda)
    want = ox.extract_plain(rank, alive, planes, K2)
    got = ox.extract(rank, alive, planes, K2)
    assert all(map(_bits_equal, got, want))
    assert float(got[0][:, 6, 0, (K2 - 1) // 4096 * 4096:].sum()) > 0
    shifted = torch.empty(8 * B + 1, device=cuda)[1:].view(8, B)
    shifted.copy_(alive)
    got = ox.extract(rank, shifted, planes, K2)
    assert all(map(_bits_equal, got, want))


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


# extract_kernel and cleanup_kernel walk rows in 16-byte lane groups: rows
# that start on a 16-byte boundary (the gather exchange's B = 17,408, the
# one-hot B = 7680) and rows that do not (L = 81, 83: a scalar head and a
# short last group), tile 0 flooded past the caps (tests/
# test_torch_exchange_vec.py emulates the arithmetic on the CPU)
VEC_ROWS = {"aligned_L2176": 17408, "aligned_L960": 7680,
            "peeled_L81": 648, "peeled_L83": 664}


def _vec_state(dev, B, flood, seed=4):
    """8 tiles, 80% alive over [-1.5, 5.5); the first `flood` slots of
    every row of tile 0 leave through -x; every 7th vy is -0.0."""
    rng = np.random.default_rng(seed)
    alive = (rng.uniform(size=(8, B)) < 0.8).astype(np.float32)
    planes = [rng.uniform(-1.5, 5.5, (8, B)).astype(np.float32)
              for _ in range(3)]
    planes += [rng.normal(size=(8, B)).astype(np.float32) for _ in range(3)]
    planes[0][0].reshape(8, B // 8)[:, :flood] = -0.5
    alive[0].reshape(8, B // 8)[:, :flood] = 1.0
    planes[4][:, ::7] = -0.0
    return (torch.from_numpy(alive).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in planes))


def _vec_runs(dev, W_run, n_runs, seed=5):
    """A cleanup input (8, 7, 8, n_runs * W_run): each row's runs a valid
    prefix of random length over [-1.5, 5.5), zeros beyond."""
    rng = np.random.default_rng(seed)
    inc = np.zeros((8, 7, 8, W_run * n_runs), np.float32)
    for t in range(8):
        for r in range(8):
            for b in range(n_runs):
                n = int(rng.integers(0, W_run + 1))
                cols = slice(b * W_run, b * W_run + n)
                inc[t, :3, r, cols] = rng.uniform(-1.5, 5.5, (3, n))
                inc[t, 3:6, r, cols] = rng.normal(size=(3, n))
                inc[t, 6, r, cols] = 1.0
    return torch.from_numpy(inc).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(VEC_ROWS))
def test_vec_extracts_match_plain(cuda, shape):
    """Every extract_kernel instantiation the wrappers launch, bit pattern
    for bit pattern: K8's (R = 8) where B % 1024 == 0, K11's (R = 8 and
    1) at every shape."""
    B = VEC_ROWS[shape]
    alive, planes = _vec_state(cuda, B, flood=min(B // 8, 200))
    before = {**gx.LAUNCHES, **ox.LAUNCHES}
    calls = [(ox.extract_fused, ox.extract_fused_plain, (planes[d], alive,
                                                         planes, 32, 4))
             for d in range(3)]
    calls += [(ox.extract_rows, ox.extract_rows_plain, (planes[d], alive,
                                                        planes, 16, 4))
              for d in range(3)]
    calls.append((ox.extract_all_rows, ox.extract_all_rows_plain,
                  (planes, alive, 16, 4)))
    if gx.supported(B):
        calls += [(gx.extract_rows_g, gx.extract_rows_g_plain,
                   (d, alive, planes, 128, 4)) for d in range(3)]
        calls += [(f, fp, (alive, planes, 128, 4)) for f, fp in (
            (gx.extract_all_rows_g, gx.extract_all_rows_g_plain),
            (gx.extract_compact_rows_g, gx.extract_compact_rows_g_plain))]
    for kern, plain, args in calls:
        b, a2 = kern(*args)
        br, a2r = plain(*args)
        assert _bits_equal(b, br) and _bits_equal(a2, a2r), kern.__name__
    # tile 0's first run overflows its cap
    b, _ = ox.extract_rows(planes[0], alive, planes, 16, 4)
    assert float(b[0, 6, :, :16].sum()) == 8 * 16
    torch.cuda.synchronize()
    after = {**gx.LAUNCHES, **ox.LAUNCHES}
    assert after["onehot_extract_tile"] - before["onehot_extract_tile"] == 3
    assert after["onehot_extract_rows"] - before["onehot_extract_rows"] == 5
    assert after["extract"] - before["extract"] == (5 if gx.supported(B)
                                                    else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("W_run, n_runs, Ke", [(128, 3, 128), (64, 2, 16),
                                               (9, 2, 3), (65, 2, 5)],
                         ids=["aligned_W384", "aligned_W128", "peeled_W18",
                              "peeled_W130"])
def test_vec_cleanups_match_plain(cuda, W_run, n_runs, Ke):
    """cleanup_kernel, bit pattern for bit pattern: K10 (bit copies) at a
    width of 128s, K11's (x + 0.0) at every width; the fused exchange's
    first cleanup (no settled output) against the plain version's
    extras; edge caps overflowing."""
    inc = _vec_runs(cuda, W_run, n_runs)
    W = W_run * n_runs
    before = {**gx.LAUNCHES, **ox.LAUNCHES}
    for axes in ((0, 1, 2), (1, 2), (2,)):
        st, e = ox.cleanup_rows(inc, W, Ke, 4, axes)
        sr, er = ox.cleanup_rows_plain(inc, W, Ke, 4, axes)
        assert _bits_equal(st, sr) and all(map(_bits_equal, e, er)), axes
        if W % 128 == 0 and Ke % 128 == 0:
            st, e = gx.cleanup_rows_g(inc, Ke, 4, axes)
            sr, er = gx.cleanup_rows_g_plain(inc, Ke, 4, axes)
            assert _bits_equal(st, sr) and all(map(_bits_equal, e, er))
    if W % 128 == 0 and Ke % 128 == 0:
        faces = gx.cleanup_faces_g(inc, Ke, 4)
        want = gx.cleanup_rows_g_plain(inc, Ke, 4, (0, 1, 2))[1]
        assert len(faces) == 6 and all(map(_bits_equal, faces, want))
    if Ke < W_run:
        assert float(er[0][:, 6].sum(-1).max()) == Ke     # overflow
    torch.cuda.synchronize()
    after = {**gx.LAUNCHES, **ox.LAUNCHES}
    assert after["onehot_cleanup"] - before["onehot_cleanup"] == 3
    assert after["cleanup"] - before["cleanup"] == (
        4 if W % 128 == 0 and Ke % 128 == 0 else 0)


# the kernel benchmark's variants: tests/test_torch_kbench.py's fixture
# (16^3, T = 8, B = 256) at M = 1 and 2, and the archive probes'
# production shape (128^3, M = 1, B = 9216)
KB_SHAPES = {"fixture_m1": ((16, 16, 16), 1, 256),
             "fixture_m2": ((16, 16, 16), 2, 256),
             "production": ((128, 128, 128), 1, 9216)}


def _kb_inputs(dev, shape):
    grid, M, B = KB_SHAPES[shape]
    ts = TileSpec(grid=grid, T=8, M=M, B=B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(B + M)
    xyz = (torch.rand((3, ts.NT, B), generator=gen, device=dev)
           * (ts.T + 2 * M) - M)
    val = (torch.rand((ts.NT, B), generator=gen, device=dev) < 0.9).float()
    field = torch.randn((ts.NT, ts.P, ts.P, ts.P, 3), generator=gen,
                        device=dev)
    kron = torch.rand((ts.P ** 2, B // 8), generator=gen,
                      device=dev).bfloat16()
    return ts, xyz, val, field, kron


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(KB_SHAPES))
@pytest.mark.parametrize("mode", kb.DEPOSIT_MODES)
def test_kbench_deposit_variants_match_plain(cuda, mode, shape):
    """int8 bit for bit (exact int32 sums); the others within 1e-5 of
    max|plain| (atomics and the ceilings' sums in another order); the
    given plane random, so a misplaced plane column shows (the production
    shape's 1152 columns a row take 18 plane chunks)."""
    ts, xyz, val, _, kron = _kb_inputs(cuda, shape)
    before = dict(kb.LAUNCHES)
    got = kb.deposit_variant(xyz, val, ts, mode, kron=kron)
    want = kb.deposit_variant_plain(xyz, val, ts, mode, kron=kron)
    assert got.shape == (ts.NT, ts.P, ts.P ** 2)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        assert _max_err(got, want) <= 1e-5 * want.abs().max().item()
    torch.cuda.synchronize()
    assert {k: kb.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == f"kbench_deposit_{mode}") for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(KB_SHAPES))
@pytest.mark.parametrize("mode", kb.GATHER_MODES)
def test_kbench_gather_variants_match_plain(cuda, mode, shape):
    """int8 bit for bit (exact int32 sums, the two x terms added as the
    plain version does); the others within 1e-5 of max|plain| (the same
    products and sums in the same order, so bit-equal as well)."""
    ts, xyz, _, field, _ = _kb_inputs(cuda, shape)
    before = dict(kb.LAUNCHES)
    if mode == "int8":
        Eq, scale = kb.quantize_field(field)
        qc, sc = kb.quantize_field(field.cpu())
        assert torch.equal(Eq.cpu(), qc) and torch.equal(scale.cpu(), sc)
        got = kb.gather_variant(Eq, xyz, ts, mode, scale=scale)
        want = kb.gather_variant_plain(Eq, xyz, ts, mode, scale=scale)
        assert torch.equal(got, want)
    else:
        got = kb.gather_variant(field, xyz, ts, mode)
        want = kb.gather_variant_plain(field, xyz, ts, mode)
        assert _max_err(got, want) <= 1e-5 * want.abs().max().item()
    assert got.shape == (3, ts.NT, 8, ts.B // 8)
    torch.cuda.synchronize()
    assert {k: kb.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == f"kbench_gather_{mode}") for k in before}


@pytest.mark.cuda
def test_kbench_wrappers_check_their_inputs(cuda):
    ts, xyz, val, field, kron = _kb_inputs(cuda, "fixture_m1")
    with pytest.raises(ValueError, match="kron plane"):
        kb.deposit_variant(xyz, val, ts, "given_kron")
    with pytest.raises(ValueError, match="shape"):
        kb.deposit_variant(xyz, val, ts, "given_kron", kron=kron[:, :8])
    with pytest.raises(TypeError, match="bfloat16"):
        kb.deposit_variant(xyz, val, ts, "given_kron", kron=kron.float())
    with pytest.raises(ValueError, match="C = 3"):
        kb.gather_variant(field[..., :1].contiguous(), xyz, ts, "g_bf16")
    with pytest.raises(TypeError, match="int8"):
        kb.gather_variant(field, xyz, ts, "int8",
                          scale=torch.ones(ts.NT, device=cuda))
    with pytest.raises(ValueError, match="scale"):
        kb.gather_variant(kb.quantize_field(field)[0], xyz, ts, "int8")
    with pytest.raises(ValueError, match="B % 8"):
        kb.deposit_variant(xyz[:, :, :252].contiguous(), val[:, :252]
                           .contiguous(), TileSpec(grid=(16, 16, 16), T=8,
                                                   M=1, B=252), "int8")


def _prim_launched(before: dict, key: str, n: int = 1) -> None:
    torch.cuda.synchronize()
    assert {k: kp.LAUNCHES[k] - before[k] for k in before} == {
        k: n * (k == key) for k in before}


@pytest.mark.cuda
def test_kbench_prims_match_plain_at_the_probes_shapes(cuda):
    """kbench.check_prims: every call site's shapes, wrapping and filling
    indices, int32 words, the static row rolls p = 0..7, device shifts 5,
    -3, 261, plane_add with 13 tiles at G = 1, 4, 8, the prefix sum with
    -0.0 at B = 1000, rows of 130 words (no 16-byte loads)."""
    before = dict(kp.LAUNCHES)
    rows = kbench.check_prims(cuda)
    torch.cuda.synchronize()
    assert rows and all(r["ok"] for r in rows), [
        r["name"] for r in rows if not r["ok"]]
    assert all(kp.LAUNCHES[k] > before[k] for k in kp.LAUNCHES)


def _prim_gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["extract", "merge", "square", "rows"])
def test_kbench_take_matches_plain(cuda, shape):
    """The exchange's shapes, 4096 tiles of (8, 2176), with indices over
    [-n - 3, n + 3): some wrap, some fill (NaN)."""
    src_c, idx_c, axis = {"extract": (2176, 768, 2),
                          "merge": (768, 2176, 2),
                          "square": (2176, 2176, 2),
                          "rows": (2176, 2176, 1)}[shape]
    gen = _prim_gen(cuda, src_c + idx_c + axis)
    src = torch.randn((4096, 8, src_c), generator=gen, device=cuda)
    n = src.shape[axis]
    idx = torch.randint(-n - 3, n + 3, (4096, 8, idx_c), generator=gen,
                        device=cuda, dtype=torch.int32)
    before = dict(kp.LAUNCHES)
    got = kp.take(src, idx, axis)
    want = kp.take_plain(src, idx, axis)
    assert kbench.same_bits(got, want)
    assert torch.isnan(got).any()
    _prim_launched(before, "kbench_take")


#: take's blocks by chunk plan: (batch, source block, index block, axis)
TAKE_PLANS = {
    "lanes (256, 128), 8 CTAs a block": (4096, (256, 128), (256, 128), 2),
    "lanes (8, 128), 4 blocks a CTA": (4096, (8, 128), (8, 128), 2),
    "rows (8, 128), 4 blocks a CTA": (4096, (8, 128), (8, 128), 1),
    "rows (64, 130) by (40, 130), strips": (99, (64, 130), (40, 130), 1),
    "lanes (8, 130) by (8, 77), a word a thread": (99, (8, 130), (8, 77), 2),
    "lanes (8, 8192), above 227 KB": (64, (8, 8192), (8, 1000), 2),
    "rows (384, 256) by (200, 256), above 227 KB": (9, (384, 256),
                                                    (200, 256), 1),
    "lanes (3, 20000), direct": (5, (3, 20000), (3, 4097), 2),
    "rows (1000, 68), direct, batch 1": (1, (1000, 68), (77, 68), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAKE_PLANS))
def test_kbench_take_chunks_match_plain(cuda, case):
    """take at each kind of chunk plan (kp.take_layout): a large block
    over several CTAs, several small blocks a CTA, strips of columns,
    blocks above the 227 KB a CTA's shared memory holds, and chunks read
    through L1, each with 4 words a thread or (index rows not a multiple
    of 4 words) one; bit for bit with the plain version, with indices
    over [-n - 3, n + 3) (some wrap, some fill)."""
    batch, (rs, cs), (ri, ci), axis = TAKE_PLANS[case]
    plan = kp.take_layout(rs, cs, ri, ci, axis - 1)
    assert ("direct" in case) == (plan.smem_bytes == 0)
    gen = _prim_gen(cuda, rs * cs + ri * ci)
    src = torch.randn((batch, rs, cs), generator=gen, device=cuda)
    n = (rs, cs)[axis - 1]
    idx = torch.randint(-n - 3, n + 3, (batch, ri, ci), generator=gen,
                        device=cuda, dtype=torch.int32)
    before = dict(kp.LAUNCHES)
    got = kp.take(src, idx, axis)
    assert kbench.same_bits(got, kp.take_plain(src, idx, axis))
    assert torch.isnan(got).any()
    _prim_launched(before, "kbench_take")


@pytest.mark.cuda
def test_kbench_take_int32_fill(cuda):
    gen = _prim_gen(cuda, 3)
    src = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, 8, 300), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx = torch.randint(-303, 303, (64, 8, 100), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = kp.take(src, idx, 2)
    assert kbench.same_bits(got, kp.take_plain(src, idx, 2))
    assert (got == -2 ** 31).any()


@pytest.mark.cuda
@pytest.mark.parametrize("axis, shift", [(1, 1), (1, 7), (1, -9), (2, 5),
                                         (2, -3), (2, 261)])
@pytest.mark.parametrize("where", ["host", "device"])
def test_kbench_roll_matches_plain(cuda, axis, shift, where):
    """K9's spill shape (4096, 8, 2176) along the rows and the lanes."""
    x = torch.randn((4096, 8, 2176), generator=_prim_gen(cuda, 4),
                    device=cuda)
    s = shift if where == "host" else torch.tensor(
        [shift], dtype=torch.int32, device=cuda)
    before = dict(kp.LAUNCHES)
    got = kp.roll(x, s, axis)
    assert kbench.same_bits(got, kp.roll_plain(x, s, axis))
    assert kbench.same_bits(got, torch.roll(x, shift, axis))
    _prim_launched(before, "kbench_roll")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
def test_kbench_plane_add_matches_plain(cuda, G):
    """7 planes of 4099 tiles of (8, 2176): 4099 is no multiple of 4 or
    8, so the last block holds fewer tiles; and tiles of 7 words (no
    float4)."""
    gen = _prim_gen(cuda, G)
    before = dict(kp.LAUNCHES)
    for shape in ((4099, 8, 2176), (37, 7)):
        planes = [torch.randn(shape, generator=gen, device=cuda)
                  for _ in range(7)]
        got = kp.plane_add(planes, G)
        assert kbench.same_bits(got, kp.plane_add_plain(planes, G))
    _prim_launched(before, "kbench_plane_add", 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [9216, 1000, 777, kp.MAX_PREFIX_B, 1, 31, 33,
                               513])
@pytest.mark.parametrize("data", ["mask", "normal"])
def test_kbench_lane_prefix_matches_plain(cuda, B, data):
    """kbench7.py's (4096, 9216) and rows that are not a multiple of the
    kernel's W threads (1000, 777, 31, 33, 513; B = 1 has no pass), up to
    the widest row shared memory holds; bit for bit on any input (-0.0
    every 7th lane and a row of -0.0); torch.cumsum bit for bit on the
    mask."""
    gen = _prim_gen(cuda, B)
    NT = 4096 if B == 9216 else 64
    if data == "mask":
        m = (torch.rand((NT, B), generator=gen, device=cuda) < 0.01).float()
    else:
        m = torch.randn((NT, B), generator=gen, device=cuda)
        m[:, ::7] = -0.0
        m[0] = -0.0
    before = dict(kp.LAUNCHES)
    got = kp.lane_prefix(m)
    assert kbench.same_bits(got, kp.lane_prefix_plain(m))
    if data == "mask":
        assert kbench.same_bits(got, torch.cumsum(m, 1))
    _prim_launched(before, "kbench_lane_prefix")


@pytest.mark.cuda
def test_kbench_sweeps_on_the_card(cuda):
    """Every row of the kernel benchmark, untimed, at small sizes."""
    rows = kbench.run(device=cuda, time=False,
                      k12=dict(grid=(16, 16, 16), B=256, fill=170),
                      k13=dict(grid=(16, 16, 16), B=256), prims=dict(NT=64))
    assert len(rows) == 41 and all(r["ok"] for r in rows), [
        r["name"] for r in rows if not r["ok"]]


@pytest.mark.cuda
def test_kbench_prims_wrappers_check_their_inputs(cuda):
    x = torch.zeros((4, 8, 16), device=cuda)
    idx = torch.zeros((4, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="idx is on"):
        kp.take(x, idx, 2)
    with pytest.raises(ValueError, match="shift is on"):
        kp.roll(x, torch.tensor([1], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="contiguous"):
        kp.roll(x.transpose(1, 2), 1, 2)
    with pytest.raises(ValueError, match="planes\\[1\\] is on"):
        kp.plane_add([x, x.cpu()])


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


@pytest.mark.cuda
@pytest.mark.parametrize("walls", ["periodic", "dirichlet", "neumann_x"])
def test_multigrid_on_the_card_matches_cpu(cuda, walls):
    """solvers/multigrid.py on the card against the same solve on the CPU
    (16^3, 3 levels): the same cycle count (the tolerance is tested on the
    host after each cycle), phi within 1e-4 of max|phi|."""
    from pinc_tpu_torch.bc import BCSpec
    from pinc_tpu_torch.grid import BndType
    from pinc_tpu_torch.solvers.multigrid import MultigridSolver
    P, D, N = BndType.PERIODIC, BndType.DIRICHLET, BndType.NEUMANN
    zero = (0.0,) * 3
    bc = {"periodic": None,
          "dirichlet": BCSpec((D,) * 3, (D,) * 3, zero, zero),
          "neumann_x": BCSpec((N, P, P), (N, P, P), zero, zero)}[walls]
    rho = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (16, 16, 16)).astype(np.float32))
    kw = dict(n_levels=3, n_pre=4, n_post=4, n_coarse=10, max_cycles=10,
              tol=1e-4, bc=bc)
    phi_c, n_c, r_c = MultigridSolver((16,) * 3, **kw).solve_with_stats(rho)
    phi_g, n_g, r_g = MultigridSolver((16,) * 3, **kw).solve_with_stats(
        rho.to(cuda))
    assert phi_g.is_cuda and n_g == n_c
    np.testing.assert_allclose(phi_g.cpu().numpy(), phi_c.numpy(), rtol=0,
                               atol=1e-4 * float(phi_c.abs().max()))
    np.testing.assert_allclose(float(r_g), float(r_c), rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("walls", ["DIRICHLET", "NEUMANN"])
def test_bounded_step_on_the_card(cuda, walls):
    """Two steps of run() on the slice deck inside walls (zero values,
    mgSolve), on the card and on the CPU: the unfused step launches K1 and
    K3 per species a step (and in the half kick) and K7 once a step, never
    K2, K4 or K5; the state agrees as in test_slice_on_the_card_matches_cpu
    and stays inside [0, L-1]."""
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    deck = (DECK.replace("boundaries = PERIODIC",
                         f"boundaries = {walls}\nbndValues = 0,0,0,0,0,0")
            .replace("poisson = sSolve", "poisson = mgSolve")
            .replace("nTimeSteps = 6", "nTimeSteps = 2")
            + "mxuDtype = f32\n[multigrid]\nmgLevels = 2\nmgCycles = 4\n")
    runs = {}
    for dev in ("cpu", cuda):
        for m in (tk, fk, gx, ox):
            m.reset_launches()
        sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device=dev)
        runs[str(dev)] = (sim.run(progress_every=0), sim,
                          {**tk.LAUNCHES, **fk.LAUNCHES, **gx.LAUNCHES,
                           **ox.LAUNCHES})
    (h_cpu, s_cpu, _), (h_gpu, s_gpu, n_gpu) = runs.values()
    assert not s_gpu._use_fused
    assert {k: v for k, v in n_gpu.items() if v} == {
        "deposit": 6, "gather": 6, "fold_global": 3}
    np.testing.assert_allclose(h_gpu["kinetic"], h_cpu["kinetic"], rtol=1e-4)
    assert torch.equal(s_gpu.state.alive.cpu(), s_cpu.state.alive)
    np.testing.assert_allclose(s_gpu.state.lpos.cpu().numpy(),
                               s_cpu.state.lpos.numpy(), rtol=0, atol=1e-4)
    from pinc_tpu_torch.ops.tiled import tile_origins
    g = (s_gpu.state.lpos + tile_origins(s_gpu.ts, cuda).T[None, :, :, None])
    g = g.permute(1, 0, 2, 3)[:, s_gpu.state.alive > 0.5]       # (3, live)
    assert float(g.min()) >= 0.0 and float(g.max()) <= 15.0
