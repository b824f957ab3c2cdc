"""pinc_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, and the tiled slice on the card
against the same run on the CPU.  Every test here needs a CUDA card and
skips without one.

This file imports neither jax nor pinc_tpu, so it also runs where only the
port is installed (the test conftest imports jax; skip it there):

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: deposits max|kernel - plain| <= 1e-5 * max|plain| (atomics
add in another order); gathered fields and velocities atol 1e-5; moved
planes and n_out exact; vdot rtol 1e-5.  The slice on the card vs the CPU:
energies rtol 1e-4 and state atol 1e-4 (cuFFT vs pocketfft and
atomic-order sums, over 6 steps)."""

import numpy as np
import pytest
import torch

from pinc_tpu_torch.config import PincConfig
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
        "deposit": 1, "deposit_move": 1, "gather": 1, "gather_kick": 3}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(MXU))
def test_slice_on_the_card_matches_cpu(cuda, dt):
    from pinc_tpu_torch.tiled_sim import TiledSimulation
    deck = DECK + f"mxuDtype = {dt}\n"
    runs = {}
    for dev in ("cpu", cuda):
        tk.reset_launches()
        sim = TiledSimulation(PincConfig.from_string(deck), seed=3, device=dev)
        runs[str(dev)] = (sim.run(progress_every=0), sim, dict(tk.LAUNCHES))
    (h_cpu, s_cpu, n_cpu), (h_gpu, s_gpu, n_gpu) = runs.values()
    assert n_cpu == {k: 0 for k in n_cpu}
    assert n_gpu == {"deposit": 2, "gather": 2, "deposit_move": 12,
                     "gather_kick": 12}
    assert s_gpu.state.lpos.is_cuda and h_gpu["dropped"] == 0
    np.testing.assert_allclose(h_gpu["kinetic"], h_cpu["kinetic"], rtol=1e-4)
    np.testing.assert_allclose(h_gpu["potential"], h_cpu["potential"],
                               rtol=1e-4)
    assert torch.equal(s_gpu.state.alive.cpu(), s_cpu.state.alive)
    np.testing.assert_allclose(s_gpu.state.lpos.cpu().numpy(),
                               s_cpu.state.lpos.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_gpu.state.vel.cpu().numpy(),
                               s_cpu.state.vel.numpy(), rtol=0, atol=1e-4)
