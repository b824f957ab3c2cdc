#!/usr/bin/env python3
"""Warm-plasma dispersion check — the counterpart of
``verification/dispersion.py`` (the BASELINE.json 'warm plasma dispersion'
criterion): run a warm 1D deck through the flat ``Simulation``'s half kick
and step, fetch phi(x, t) every step, Fourier-analyze it, and compare the
Langmuir-branch peaks against Bohm-Gross omega^2 = omega_p^2 + 3 k^2 v_th^2.
PASS when modes 1-2 are within 15%.

Usage: python -m pinc_tpu_torch.verification.dispersion [--steps 600]
       [--plot out.png]
"""

from __future__ import annotations

import argparse

import numpy as np

L = 64
DECK = """
[time]
nTimeSteps = {steps}
timeStep = {tau}
[grid]
nDims = 1
nSubdomains = 1
trueSize = {L}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 256 pc
nAlloc = 256 pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = {vth},0.002
[methods]
mode = regular
poisson = sSolve
acc = puAccND1KE
distr = puDistrND1
migrate = puExtractEmigrantsND
"""
MODES = (1, 2, 3, 4)
TOLERANCE = 0.15           # modes 1-2 within 15% of Bohm-Gross


def record_phi(steps: int, vth: float, tau: float, device=None) -> np.ndarray:
    """phi(x, t) of the half kick and each of ``steps`` steps, (steps + 1,
    L) float32, fetched to the host every step."""
    from ..config import PincConfig
    from ..simulation import Simulation
    cfg = PincConfig.from_string(DECK.format(steps=steps, tau=tau, L=L,
                                             vth=vth))
    sim = Simulation(cfg, seed=7, device=device)
    out = sim._half_kick(sim.particles)
    particles = out.particles
    phis = [out.phi.cpu().numpy()]
    for _ in range(steps):
        out = sim._step(particles, None)
        particles = out.particles
        phis.append(out.phi.cpu().numpy())
    return np.stack(phis)                      # (T, L)


def spectrum(data: np.ndarray):
    """(|rfft2| of the mean-free series, omega per frequency bin)."""
    spec = np.abs(np.fft.rfft2(data - data.mean()))  # (T freq, L/2+1)
    omegas = 2 * np.pi * np.fft.fftfreq(data.shape[0])[: spec.shape[0]]
    return spec, omegas


def analyze(data: np.ndarray, vth: float, tau: float) -> list:
    """Per mode m of MODES: (m, k, omega measured, omega Bohm-Gross, rel.
    error), omega measured at the spectrum's peak over positive bins."""
    spec, omegas = spectrum(data)
    n_t = data.shape[0]
    rows = []
    for m in MODES:
        k = 2 * np.pi * m / L
        col = spec[1: n_t // 2, m]
        w_meas = abs(omegas[1 + int(np.argmax(col))])
        w_bg = np.sqrt(tau ** 2 + 3 * (k * vth) ** 2)
        rows.append((m, k, w_meas, w_bg, abs(w_meas - w_bg) / w_bg))
    return rows


def passed(errs) -> bool:
    return all(e < TOLERANCE for e in errs[:2])


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--vth", type=float, default=0.1)
    ap.add_argument("--tau", type=float, default=0.2)  # omega_p * dt
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    data = record_phi(args.steps, args.vth, args.tau, device=device)
    rows = analyze(data, args.vth, args.tau)
    print("k (2pi m/L)   omega_measured   omega_BohmGross   rel.err")
    for m, k, w_meas, w_bg, err in rows:
        print(f"  m={m}: k={k:.4f}  {w_meas:.4f}  {w_bg:.4f}  {err:.2%}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        spec, omegas = spectrum(data)
        n_t = data.shape[0]
        plt.imshow(np.log10(spec[: n_t // 4, :16] + 1e-12), origin="lower",
                   aspect="auto", extent=[0, 16, 0, omegas[n_t // 4]])
        ks = 2 * np.pi * np.arange(16) / L
        plt.plot(np.arange(16), np.sqrt(args.tau**2 + 3 * (ks * args.vth)**2)
                 / (2 * np.pi / n_t), "w--", lw=1, label="Bohm-Gross")
        plt.xlabel("mode m")
        plt.ylabel("omega (rad/step) bin")
        plt.legend()
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"wrote {args.plot}")
    return [r[4] for r in rows]


if __name__ == "__main__":
    errs = main()
    ok = passed(errs)
    print("PASS" if ok else "FAIL", "(first two modes within 15%)")
    raise SystemExit(0 if ok else 1)
