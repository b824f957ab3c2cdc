#!/usr/bin/env python3
"""The energy-drift curve on the C reference's langmuirCold deck (32^3,
2 x 64 particles per cell, 10k steps) — the counterpart of
``cbaseline/tpu_drift.py`` and BASELINE.md's protocol step 4.

The deck is the repo's ``input/langmuirCold.ini`` with tpu_drift.py's
overrides (one subdomain, 32^3, no perturbation, the tiled layout, bf16
weights): the SAME deck the C reference ran with Maxwellian velocities
at the deck's thermalVelocity (lambda_D = 1.38 dx, the resolved regime
where leapfrog + CIC conserves energy).  The run takes DRIFT_STEPS steps
(default 10000) in chunks of DRIFT_CHUNK (default 500) through
``TiledSimulation.make_scan_steps`` with ``retune()`` between them, and
saves the (2, N) float64 curve (row 0 the step, row 1 the total energy in
simulation units) to ``--out`` after every chunk, so a run cut short
keeps its curve.  It prints E(1), the plateau drift over the second half
(per 1k steps), the total drift, the particles at the start and the end,
the drops and the particle-steps a second.

Usage: [DRIFT_STEPS=10000] [DRIFT_CHUNK=500] \
       python -m pinc_tpu_torch.cbaseline.drift [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
DECK = REPO_ROOT / "input" / "langmuirCold.ini"
#: tpu_drift.py's overrides (cbaseline/tpu_drift.py:35-41)
OVERRIDES = ("grid:nSubdomains=1,1,1",
             "grid:trueSize=32,32,32",
             "population:perturbAmplitude=0,0,0,0,0,0",
             "methods:layout=tiled",
             "tiles:mxuDtype=bf16")
#: the default --out, in a directory .gitignore lists
DEFAULT_OUT = REPO_ROOT / "chiprun_out" / "drift" / "torch_drift_curve.npy"


def make_sim(steps: int, device=None, extra=()):
    """The deck's TiledSimulation (seed 1); ``extra``: more overrides
    after tpu_drift.py's."""
    from ..config import PincConfig
    from ..tiled_sim import TiledSimulation
    cfg = PincConfig.from_file(DECK, [f"time:nTimeSteps={steps}",
                                      *OVERRIDES, *extra])
    return TiledSimulation(cfg, seed=1, device=device)


def _alive(st) -> int:
    return int((st.alive > 0.5).sum())


def _save(out, tot: np.ndarray) -> None:
    if out is None:
        return
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.save(out, np.stack([np.arange(1, len(tot) + 1, dtype=np.float64),
                           tot]))


def drift_figures(tot: np.ndarray) -> dict:
    """E(1), the plateau drift over the second half per 1k steps
    (tpu_drift.py's: the change over the half against its mean) and the
    total drift, both relative."""
    half = len(tot) // 2
    m = tot[half:].mean()
    per1k = (tot[-1] - tot[half]) / m / ((len(tot) - half) / 1000.0)
    return dict(e1=float(tot[0]), e_end=float(tot[-1]),
                plateau_per_1k=float(per1k),
                total=float((tot[-1] - tot[0]) / tot[0]),
                plateau_steps=len(tot) - half)


def run_chunks(sim, steps: int, chunk: int, out=None, log=print) -> dict:
    """``steps // chunk`` windows of ``chunk`` steps from ``sim.state``,
    ``sim.retune`` between them, the curve saved to ``out`` after each.
    Returns the total energy per step (float64) and the figures."""
    st = sim.state
    n0 = _alive(st)
    kes, pes, drops = [], [], 0
    run_ch = sim.make_scan_steps(chunk)
    t0 = time.monotonic()
    for c in range(steps // chunk):
        st, (ke, pe, dropped) = run_ch(st)
        kes.append(ke.double().sum(dim=1).cpu().numpy())
        pes.append(pe.double().cpu().numpy())
        drops += int(dropped)
        done = np.concatenate(kes) + np.concatenate(pes)
        log(f"chunk {c:3d}: E={done[-1]:.6e} drops_cum={drops} "
            f"({time.monotonic() - t0:.0f}s)")
        # incremental save: a long run killed mid-flight keeps its curve
        _save(out, done)
        if sim.retune(st):
            run_ch = sim.make_scan_steps(chunk)
    wall = time.monotonic() - t0
    tot = np.concatenate(kes) + np.concatenate(pes)
    n1 = _alive(st)
    return dict(tot=tot, n0=n0, n1=n1, dropped=drops, wall=wall,
                steps=len(tot), psteps=n0 * len(tot) / wall,
                **drift_figures(tot))


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="the (2, N) curve, .npy")
    args = ap.parse_args(argv)
    steps = int(os.environ.get("DRIFT_STEPS", "10000"))
    chunk = int(os.environ.get("DRIFT_CHUNK", "500"))

    def log(text):
        print(text, flush=True)

    t0 = time.monotonic()
    sim = make_sim(steps, device=device)
    log(f"setup {time.monotonic() - t0:.0f}s n={_alive(sim.state):,} "
        f"cadences={sim.rebucket_every_s} on {sim.device}")
    res = run_chunks(sim, steps, chunk, out=args.out, log=log)
    log(f"{res['steps']} steps in {res['wall']:.1f}s -> "
        f"{res['psteps']:.4e} psteps/s")
    log(f"E(1)={res['e1']:.6e} E[-1]={res['e_end']:.6e}; total drift "
        f"{res['total'] * 100:.4f}%; plateau-relative drift "
        f"{res['plateau_per_1k'] * 100:.4f}%/1k-steps over the last "
        f"{res['plateau_steps']} steps")
    log(f"particles {res['n0']:,} -> {res['n1']:,} "
        f"lost={res['n0'] - res['n1']} dropped={res['dropped']}")
    log(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
