#!/usr/bin/env python3
"""Energy-conservation sweep — the counterpart of ``verification/sweep.py``:
run Langmuir decks over a range of timeStep (or stepSize) values, read the
total energy series from ``history.xy.h5``, and report/plot the max
relative energy drift per setting (reference sweep.py:23-82).

``--inproc`` runs each deck in this process (``Pinc.run_inproc``) and
reads the series from the run's history instead of the file: the route on
a host without h5py, such as the card's.  The series is the one the file
holds, bit for bit.

Usage:
    python -m pinc_tpu_torch.verification.sweep dt [ini] [--plot out.png]
    python -m pinc_tpu_torch.verification.sweep dx [ini] [--inproc]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from ..script.framework.pinc import REPO_ROOT, Pinc


def _drift(tot: np.ndarray) -> float:
    tot = tot[1:]
    return float((tot.max() - tot.min()) / abs(tot.mean()))


def energy_series(history_file: Path) -> np.ndarray:
    """KE + PE per step, as ``history.xy.h5`` holds them (float64)."""
    import h5py
    with h5py.File(history_file) as f:
        ke = np.asarray(f["energy/kinetic/total"])[:, 1]
        pe = np.asarray(f["energy/potential/total"])[:, 1]
    return ke + pe


def history_series(hist: dict) -> np.ndarray:
    """KE + PE per step from a run's history, summed as the writer sums
    them (``io_h5.OutputWriter.write_energy``)."""
    ke = np.asarray([float(k.sum()) for k in hist["kinetic"]])
    pe = np.asarray([float(p) for p in hist["potential"]])
    return ke + pe


def energy_drift(history_file: Path) -> float:
    return _drift(energy_series(history_file))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["dt", "dx"])
    ap.add_argument("ini", nargs="?",
                    default=str(REPO_ROOT / "input" / "langmuirCold1D.ini"))
    ap.add_argument("--plot", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--inproc", action="store_true",
                    help="run in this process; read the run's history, "
                         "not history.xy.h5")
    args = ap.parse_args(argv)

    values = [0.05 * 2 ** k for k in range(4)] if args.what == "dt" else \
             [16 * 2 ** k for k in range(3)]
    drifts = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, v in enumerate(values):
            out = f"{tmp}/run{i}/"
            ov = {"files:output": out, "time:ntimesteps": args.steps,
                  "files:writepop": "false", "files:writefields": "false"}
            if args.what == "dt":
                ov["time:timestep"] = v
            else:
                ov["grid:truesize"] = int(v)
            run = Pinc(args.ini, ov, device=device)
            if args.inproc:
                d = _drift(history_series(run.run_inproc()))
            else:
                run.run()
                d = energy_drift(Path(out) / "history.xy.h5")
            drifts.append(d)
            print(f"{args.what}={v}: max relative energy drift = {d:.3e}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.loglog(values, drifts, "o-")
        plt.xlabel(args.what)
        plt.ylabel("max relative energy drift")
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"wrote {args.plot}")
    return values, drifts


if __name__ == "__main__":
    main()
