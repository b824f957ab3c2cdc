#!/usr/bin/env python3
"""Single-particle convergence studies — the counterpart of
``verification/pumode.py`` over the port's ``pumodes``: the trajectory
study (leapfrog against the analytic harmonic oscillation: order ~2) and
the interpolation study (NGP and CIC gathers of a sinusoidal field: orders
~1 / ~2).  Prints the measured orders, PASS when the trajectory order is
above 1.7 and the NGP / CIC orders above 0.7 / 1.7, and optionally writes
log-log plots.

Usage: python -m pinc_tpu_torch.verification.pumode [particle|interp|all]
       [--plot DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _loglog(xs, series, xlabel, title, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for label, ys in series:
        ax.loglog(xs, ys, "o-", label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("rms error")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    print("wrote", out)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("study", nargs="?", default="all",
                    choices=("particle", "interp", "all"))
    ap.add_argument("--plot", default=None,
                    help="directory to write convergence plots into")
    args = ap.parse_args(argv)

    from ..simulation import default_device
    from .. import pumodes

    device = device or default_device()
    ok = True
    if args.study in ("particle", "all"):
        res = pumodes.particle_convergence(device=device)
        print(f"puModeParticle: orders "
              f"{['%.2f' % o for o in res['orders']]} (expect ~2)")
        ok &= res["orders"][-1] > 1.7
        if args.plot:
            _loglog(res["dts"], [("leapfrog", res["errors"])],
                    "timestep", "trajectory convergence (order ~2)",
                    str(Path(args.plot) / "pumode_particle.png"))
    if args.study in ("interp", "all"):
        res = pumodes.interp_convergence(device=device)
        print(f"puModeInterp: orders ngp={res['order_ngp']:.2f} "
              f"cic={res['order_cic']:.2f} (expect ~1 / ~2)")
        ok &= res["order_ngp"] > 0.7 and res["order_cic"] > 1.7
        if args.plot:
            _loglog(res["sizes"],
                    [("NGP", res["ngp"]), ("CIC", res["cic"])],
                    "grid size", "gather convergence (orders ~1 / ~2)",
                    str(Path(args.plot) / "pumode_interp.png"))
    print("PASS" if ok else "FAIL: measured orders below expectation")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
