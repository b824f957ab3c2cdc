"""Run one cell of the benchmark of ``pinc_tpu_torch`` once:

    python3 -m benchmarks.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is the result (one JSON object); the last lines of
standard error are the numbers ``correct`` compared, each beside its
limit.  ``--control 1`` judges, in the program's place, the plain
reference one precision step lower (it has to come out not correct).
Exits with 3, printing no result, without a CUDA card or with fewer cards
than the cell asks for, and with 4 if JAX or ``pinc_tpu`` is loaded once
the run is over.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of the forbidden packages, compared whole."""
    from benchmarks.harness import FORBIDDEN
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmarks.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    # the port's kernels build into pinc_tpu_torch/_build inside the
    # checkout; any Triton cache goes to a fixed folder beside it
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "benchmarks" / ".cache" / "triton"))
    import torch
    from benchmarks.harness import Bench, run_cell
    wl = Bench(root).workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"no CUDA card for {args.workload} (wants {wl['chips']})",
              file=sys.stderr)
        return 3
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda",
                   control=bool(args.control), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, row in out["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
