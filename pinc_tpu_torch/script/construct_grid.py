#!/usr/bin/env python3
"""Object-grid generator — the counterpart of ``script/construct_grid.py``
over the port's ``objects``: voxelizes primitive shapes into object-id
grids and writes the ``.grid.h5`` files the objects module reads
(reference ConstructGrid.py:20-50; oOpenH5/oReadH5, src/object.c:721-756).
It runs on the CPU only, since it needs h5py; a host without h5py passes
the grid in memory instead (``objects.make_sphere``, ``make_box``).

Usage:
    python -m pinc_tpu_torch.script.construct_grid sphere out.grid.h5 \
        --size 64,64,64 --center 32,32,32 --radius 8
    python -m pinc_tpu_torch.script.construct_grid box out.grid.h5 \
        --size 64,64,64 --lo 10,10,10 --hi 20,20,20
Multiple shapes can be merged with --append (ids auto-increment).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..objects import load_domain, make_box, make_sphere, save_domain


def _ints(s):
    return [int(x) for x in s.split(",")]


def _floats(s):
    return [float(x) for x in s.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("shape", choices=["sphere", "box"])
    ap.add_argument("output")
    ap.add_argument("--size", type=_ints, required=True)
    ap.add_argument("--center", type=_floats)
    ap.add_argument("--radius", type=float)
    ap.add_argument("--lo", type=_ints)
    ap.add_argument("--hi", type=_ints)
    ap.add_argument("--id", type=int, default=None,
                    help="object id (default: next free id)")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing grid file")
    args = ap.parse_args(argv)

    domain = None
    if args.append and Path(args.output).exists():
        domain = load_domain(args.output, len(args.size))
    oid = args.id
    if oid is None:
        oid = 1 if domain is None else int(domain.max()) + 1

    if args.shape == "sphere":
        if args.center is None or args.radius is None:
            ap.error("sphere needs --center and --radius")
        domain = make_sphere(args.size, args.center, args.radius, oid, domain)
    else:
        if args.lo is None or args.hi is None:
            ap.error("box needs --lo and --hi")
        domain = make_box(args.size, args.lo, args.hi, oid, domain)

    save_domain(args.output, domain)
    n = int((np.rint(domain) == oid).sum())
    print(f"wrote {args.output}: object {oid} with {n} nodes "
          f"(grid {tuple(args.size)})")


if __name__ == "__main__":
    main()
