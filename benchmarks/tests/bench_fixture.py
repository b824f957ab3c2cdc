"""A benchmark tree in a temporary folder for the CPU tests: the real
benchmark's files, the fixtures' tiny configurations and mixes, and a
manifest whose cells run them."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FIXTURES = Path(__file__).resolve().parent / "fixtures"

#: the tiny cells: (configuration, mix)
TINY = {
    "tiny16.scan": ("tiny16", "tiny_scan"),
    "tiny16.run": ("tiny16", "tiny_run"),
    "tinysphere16.run": ("tinysphere16", "tiny_run"),
    "tiny16.escape.scan": ("tiny16", "tiny_escape_scan"),
    "tiny16.escape.run": ("tiny16", "tiny_escape_run"),
    "tinymg16.run": ("tinymg16", "tiny_run"),
}

_EXACT = ("start_tiles_off", "layout_off", "window_drops", "window_nonfinite",
          "margins_off", "margin_count_off", "alive_off",
          "rebucket_tiles_off", "pos_err")
#: what each number is held to in the CPU tests: the exact ones at 0, the
#: rest between the sound CPU readings (rho, phi, E, the equipotential,
#: the surface's rho ~1e-7; the charges ~1e-5 particle charges; the
#: velocity, its f32 rounding against the ions' small kick, up to ~2e-3)
#: and the control's (1e-3 and more)
_SCAN = dict({k: 0.0 for k in _EXACT}, rho_err=1e-5, phi_err=1e-5,
             vel_err=1e-2)
_RUN = dict(_SCAN, efield_err=1e-5)
TINY_LIMITS = {
    "tiny16.scan": _SCAN,
    "tiny16.run": _RUN,
    "tinysphere16.run": dict(_RUN, equipotential_err=1e-5, charge_err=1e-2,
                             surface_rho_err=1e-5, total_charge_err=1e-2),
    "tiny16.escape.scan": _SCAN,
    "tiny16.escape.run": _RUN,
    # the multigrid's phi by its residual (sound 1.5e-4 to 4.7e-4 of rms
    # rho, the control 3.9e-3 and more) and its mean (sound 7e-9 of max
    # |phi| at most, the control 2e-7 and more)
    "tinymg16.run": dict({k: v for k, v in _RUN.items() if k != "phi_err"},
                         phi_resid=2e-3, phi_mean=3e-8),
}


def make_tree(tmp: Path, limits: dict = None) -> Path:
    """A checkout-like root in tmp: BENCHMARK.json with the tiny cells
    beside the real ones, and benchmarks/ with the fixtures added; limits
    (default TINY_LIMITS) by cell."""
    limits = TINY_LIMITS if limits is None else limits
    root = Path(tmp)
    shutil.copytree(REPO / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    for f in FIXTURES.glob("tiny*.json"):
        kind = "traffic" if f.stem.startswith("tiny_") else "configs"
        shutil.copy(f, root / "benchmarks" / kind / f.name)
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man = copy.deepcopy(man)
    for name, (config, traffic) in TINY.items():
        man["workloads"].append({"name": name, "config": config,
                                 "traffic": traffic, "chips": 1,
                                 "why": "test fixture"})
        (root / "benchmarks" / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": limits[name]}))
        kind = name.rsplit(".", 1)[1]           # scan or run
        for m in man["end_to_end"] + man["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind)
                                        for w in m["workloads"]):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
