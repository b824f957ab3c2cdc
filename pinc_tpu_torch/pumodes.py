"""Single-particle verification run modes (the counterpart of
``pinc_tpu/pumodes.py``).

The reference declares ``puModeParticle``/``puModeInterp``
(src/pusher.h:192-195) and ships verification scripts for them
(verification/puModeParticle.py), but never implemented the modes;
pinc_tpu implements them, and this is its port:

* ``puModeParticle`` — trajectory convergence: one particle in a harmonic
  electric field E = -k (x - x0) sampled on the grid (CIC reconstruction of
  a linear field is exact, so the error isolates the time integrator),
  against the analytic oscillation over a range of timesteps; expected
  order 2.
* ``puModeInterp`` — interpolation convergence: gather a sinusoidal E at
  off-grid positions with NGP and CIC against the exact field over a range
  of grid resolutions; expected orders ~1 (NGP) and ~2 (CIC).

Both run on the device the caller passes (the card by default).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import PincConfig
from .ops import cic, pusher
from .population import Particles, SpeciesParams
from .registry import RUN_MODES
from .utils.logging import STATUS, msg


def _single_particle(x0: float, v0: float, device) -> Particles:
    cell = np.floor([[[x0]]]).astype(np.int32)
    frac = np.asarray([[[x0]]]) - cell
    return Particles(
        cell=torch.as_tensor(cell, device=device),
        frac=torch.as_tensor(frac, dtype=torch.float32, device=device),
        vel=torch.tensor([[[v0]]], dtype=torch.float32, device=device),
        alive=torch.tensor([[True]], device=device))


def particle_convergence(L: int = 64, n_periods: float = 2.0,
                         dts: tuple = (0.2, 0.1, 0.05, 0.025),
                         device="cpu") -> Dict:
    """Leapfrog-vs-analytic error for a harmonic well at decreasing dt.

    Field (per unit dt): E = -k (x - L/2) with q = m = 1, so omega =
    sqrt(k); dt enters through the per-step kick scale k*dt^2 (dx = dt = 1
    internally, as the reference decks rescale time:timeStep).  The
    trajectory stays on the device and is read once per dt.
    """
    params = SpeciesParams(
        charge=torch.tensor([1.0], device=device),
        mass=torch.tensor([1.0], device=device))
    x0 = L / 2.0 + L / 8.0
    amp = L / 8.0
    errors = []
    for dt in dts:
        omega = dt                      # omega*dt_step = dt (one cell/step)
        k = omega ** 2
        xs = np.arange(L, dtype=np.float64)
        E = torch.as_tensor((-k * (xs - L / 2.0))[:, None],
                            dtype=torch.float32, device=device)
        p = _single_particle(x0, 0.0, device)
        p, _ = pusher.acc_leapfrog(p, params, 0.5 * E)
        n_steps = int(round(2 * np.pi * n_periods / omega))
        pos = []
        for _ in range(n_steps):
            p = pusher.move(p, (L,))
            p, _ = pusher.acc_leapfrog(p, params, E)
            pos.append(p.pos()[0, 0, 0])
        traj = np.concatenate([[x0], torch.stack(pos).cpu().numpy()])
        t = np.arange(n_steps + 1) * omega
        exact = L / 2.0 + amp * np.cos(t)
        err = np.sqrt(np.mean((traj - exact) ** 2)) / amp
        errors.append(err)
        msg(STATUS, "puModeParticle: dt=%g -> rms trajectory error %g",
            dt, err)
    orders = [float(np.log2(errors[i] / errors[i + 1]))
              for i in range(len(errors) - 1)]
    msg(STATUS, "puModeParticle: measured orders %s (expect ~2)",
        ["%.2f" % o for o in orders])
    return {"dts": list(dts), "errors": errors, "orders": orders}


def interp_convergence(sizes: tuple = (16, 32, 64, 128),
                       n_samples: int = 4096, device="cpu") -> Dict:
    """NGP vs CIC gather error against an exact sinusoidal field."""
    rng = np.random.default_rng(0)
    out = {"sizes": list(sizes), "ngp": [], "cic": []}
    for L in sizes:
        xs = np.arange(L, dtype=np.float64)
        k = 2.0 * np.pi / L
        E_grid = torch.as_tensor(np.sin(k * xs)[:, None],
                                 dtype=torch.float32, device=device)
        pos = rng.uniform(0, L, n_samples)
        cell = torch.as_tensor(np.floor(pos).astype(np.int32)[:, None],
                               device=device)
        frac = torch.as_tensor(
            (pos - np.floor(pos)).astype(np.float32)[:, None], device=device)
        exact = np.sin(k * pos)
        e_cic = cic.gather_cic(E_grid, cell, frac).cpu().numpy()[:, 0]
        e_ngp = cic.gather_ngp(E_grid, cell, frac).cpu().numpy()[:, 0]
        out["cic"].append(float(np.sqrt(np.mean((e_cic - exact) ** 2))))
        out["ngp"].append(float(np.sqrt(np.mean((e_ngp - exact) ** 2))))
        msg(STATUS, "puModeInterp: L=%d ngp=%g cic=%g", L,
            out["ngp"][-1], out["cic"][-1])
    out["order_ngp"] = float(np.log2(out["ngp"][0] / out["ngp"][1]))
    out["order_cic"] = float(np.log2(out["cic"][0] / out["cic"][1]))
    msg(STATUS, "puModeInterp: measured orders ngp=%.2f cic=%.2f "
        "(expect ~1 / ~2)", out["order_ngp"], out["order_cic"])
    return out


def _device(device):
    from .simulation import default_device
    return device or default_device()


@RUN_MODES.register("puModeParticle")
def _pu_particle_factory(cfg: PincConfig):
    def run(device=None):
        L = cfg.get_int("grid:truesize", 64)
        return particle_convergence(L=L, device=_device(device))
    return run


@RUN_MODES.register("puModeInterp")
def _pu_interp_factory(cfg: PincConfig):
    def run(device=None):
        return interp_convergence(device=_device(device))
    return run
