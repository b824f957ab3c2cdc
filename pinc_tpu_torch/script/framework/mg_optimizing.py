#!/usr/bin/env python3
"""Multigrid parameter search — the counterpart of
``script/framework/mg_optimizing.py`` (coordinate descent over nPreSmooth/
nPostSmooth/nCoarseSolve/mgLevels minimizing the measured solve time,
reference mgOptimizing.py:34-144): runs the in-process ``mgMode``, which
times the solve on the card by CUDA events and reports the measured cycle
count, once per candidate.

One deviation from the repo's tool: a setting that runs to the cycle cap
(``multigrid:mgCycles``) has not solved to the tolerance, so its time is
not a time to solution, and it never becomes the best (the repo's tool
takes it when it is fastest: on the card, maxwellian.ini at 32^3 would
pick 1/1/5/2 levels, 15 cycles, at 11 times the error of the deck's own
setting).  Its line says so.

Usage:
    python -m pinc_tpu_torch.script.framework.mg_optimizing deck.ini \
        [--rounds 2] [--json out.json] [key=value ...]

Prints the best (nPre, nPost, nCoarse, mgLevels) found and the s/solve
ladder explored.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def time_settings(ini, overrides, n_pre, n_post, n_coarse, levels,
                  device=None):
    from ...config import PincConfig
    from ...registry import RUN_MODES
    from ... import simulation  # noqa: F401 (registry)

    cfg = PincConfig.from_file(ini, list(overrides) + [
        f"multigrid:nPreSmooth={n_pre}",
        f"multigrid:nPostSmooth={n_post}",
        f"multigrid:nCoarseSolve={n_coarse}",
        f"multigrid:mgLevels={levels}",
        "methods:mode=mgMode",
    ])
    run = RUN_MODES.select(cfg, "methods:mode")
    res = run(device=device)
    return res["seconds"], res["cycles"], res["rms_error"]


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ini")
    ap.add_argument("--rounds", type=int, default=2,
                    help="coordinate-descent sweeps over all 4 parameters")
    ap.add_argument("--json", default=None, help="write results here")
    ap.add_argument("overrides", nargs="*", default=[])
    # overrides may follow the options: intermixed parsing, which
    # Python 3.12.3's parse_args refuses there
    args = ap.parse_intermixed_args(argv)

    from ...config import PincConfig
    from ...simulation import default_device
    device = device or default_device()
    cfg0 = PincConfig.from_file(args.ini, args.overrides)
    best = dict(n_pre=cfg0.get_int("multigrid:npresmooth", 10),
                n_post=cfg0.get_int("multigrid:npostsmooth", 10),
                n_coarse=cfg0.get_int("multigrid:ncoarsesolve", 10),
                levels=cfg0.get_int("multigrid:mglevels", 4))
    candidates = dict(
        n_pre=(1, 2, 3, 4, 6, 10, 15),
        n_post=(1, 2, 3, 4, 6, 10, 15),
        n_coarse=(5, 10, 20, 40),
        levels=tuple(range(2, 8)),
    )
    cap = cfg0.get_int("multigrid:mgcycles", 15)
    history = []

    def measure(s):
        try:
            sec, cyc, err = time_settings(args.ini, args.overrides,
                                          device=device, **s)
        except ValueError:        # level doesn't divide the grid
            return None
        rec = dict(s, seconds=sec, cycles=cyc, rms_error=err)
        history.append(rec)
        print(f"  {s} -> {sec * 1e3:.3f} ms/solve, {cyc} cycles, "
              f"err {err:.3g}"
              + ("" if cyc < cap else " (cycle cap: not solved to tol)"))
        return rec

    best_rec = measure(best)
    if best_rec is None:
        raise ValueError("baseline settings invalid for this grid")
    for r in range(args.rounds):
        print(f"== round {r + 1}/{args.rounds} ==")
        for key, vals in candidates.items():
            for v in vals:
                if v == best[key]:
                    continue
                trial = dict(best)
                trial[key] = v
                rec = measure(trial)
                if rec and rec["cycles"] < cap and (
                        best_rec["cycles"] >= cap
                        or rec["seconds"] < best_rec["seconds"]):
                    best, best_rec = trial, rec
                    print(f"  new best: {best} "
                          f"({rec['seconds'] * 1e3:.3f} ms)")
    best_t = best_rec["seconds"]
    print(f"BEST: {best} -> {best_t * 1e3:.3f} ms/solve")
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"best": best, "seconds": best_t, "history": history}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
