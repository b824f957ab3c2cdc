#!/usr/bin/env python3
"""Validation run on the card at production defaults — the counterpart of
``script/validate_tpu.py``: a hardware check of the exchange kernels, then
N steps (default 200) of the bench deck at 16 particles per cell through
``TiledSimulation.make_scan_steps``, checking particle conservation, the
drop count and the energy series' smoothness across re-bucket events.
Prints ``VALIDATION PASS`` or ``VALIDATION FAIL`` and exits non-zero on
FAIL.

Usage: python -m pinc_tpu_torch.script.validate [steps]
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

#: the exchange check's (rows, fused, impl) combinations: the one-hot tile
#: sweeps, row sweeps and fused rows (K11), the gather exchange's sweeps
#: and fused rows (K8-K10).  B = 2048 would take the gather kernels by
#: default (B % 1024 == 0), so each names its impl
EXCHANGE_CASES = ((False, False, "onehot"), (True, False, "onehot"),
                  (True, True, "onehot"), (True, False, "gather"),
                  (True, True, "gather"))
EXCHANGE_SHAPE = dict(nt=(4, 4, 4), T=8, B=2048, K=512)

DECK = """
[time]
nTimeSteps = {steps}
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = {n},{n},{n}
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = {ppc} pc
nAlloc = {ppc} pc
charge = -1,1
mass = 1,1836
multiplicity = auto
thermalVelocity = 0.02,0.0005
drift = 0
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
[tiles]
tileSize = 8
mxuDtype = bf16
slack = 1.0625
"""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _launches():
    from ..ops import gather_exchange as gx
    from ..ops import onehot_exchange as ox
    return (sum(gx.LAUNCHES.values()), sum(ox.LAUNCHES.values()))


def check_exchange_exact(device=None, nt=EXCHANGE_SHAPE["nt"],
                         T=EXCHANGE_SHAPE["T"], B=EXCHANGE_SHAPE["B"],
                         K=EXCHANGE_SHAPE["K"]) -> bool:
    """Hardware check of the exchange kernels: alive-count conservation,
    no drop, and bit-exact payload transport.  Velocities are never
    frame-shifted by the exchange, so the multiset of alive velocity
    triples must survive BITWISE.  On the card each combination must also
    take its route: the one-hot cases launch K11 and not K8-K10, the
    gather cases K8-K10 and not K11 (the plain versions on the CPU count
    no launches)."""
    from ..ops import exchange as ex
    from ..simulation import default_device

    device = torch.device(device or default_device())
    rng = np.random.default_rng(7)
    NT = int(np.prod(nt))
    ok = True
    for rows, fused, impl in EXCHANGE_CASES:
        alive = (rng.uniform(size=(NT, B)) < 0.6).astype(np.float32)
        pos = [rng.uniform(-1.5, T + 1.5, (NT, B)).astype(np.float32)
               for _ in range(3)]
        vel = [rng.normal(0, 0.37, (NT, B)).astype(np.float32)
               for _ in range(3)]
        m0 = alive > 0.5
        v0 = np.stack([v[m0] for v in vel], 1).astype(np.float32)
        # copies: the exchange updates the planes and alive in place
        planes = tuple(torch.tensor(p, device=device) for p in pos + vel)
        before = _launches()
        pl2, al2, d = ex.rebucket_exchange_planes(
            planes, torch.tensor(alive, device=device), nt, T, K=K,
            rows=rows, fused=fused, impl=impl)
        d = int(d)
        moved = [a - b for a, b in zip(_launches(), before)]
        route = True
        if device.type == "cuda":
            route = (moved[0] > 0 and moved[1] == 0 if impl == "gather"
                     else moved[1] > 0 and moved[0] == 0)
        m1 = al2.cpu().numpy() > 0.5
        n0, n1 = int(m0.sum()), int(m1.sum())
        v1 = np.stack([pl2[c].cpu().numpy()[m1] for c in (3, 4, 5)],
                      1).astype(np.float32)
        same = (collections.Counter(map(bytes, v0.view(np.uint8)
                                        .reshape(n0, -1)))
                == collections.Counter(map(bytes, v1.view(np.uint8)
                                           .reshape(n1, -1))))
        this = n0 == n1 + d and d == 0 and same and route
        ok &= this
        log(f"exchange impl={impl} rows={rows} fused={fused}: conserve="
            f"{n0 == n1 + d} dropped={d} payload_bitexact={same} "
            f"launches K8-K10 {moved[0]} K11 {moved[1]}"
            + ("" if device.type == "cuda" else " (plain versions)"))
    return ok


def validate(steps: int = 200, device=None, n: int = 128, ppc: int = 16,
             exchange: dict = EXCHANGE_SHAPE) -> dict:
    """The exchange check, then the window and its gates.  Returns the
    figures with ``ok``."""
    from ..config import PincConfig
    from ..simulation import default_device
    from ..tiled_sim import TiledSimulation

    device = torch.device(device or default_device())
    exch_ok = check_exchange_exact(device, **exchange)

    cfg = PincConfig.from_string(DECK.format(steps=steps, n=n, ppc=ppc))
    t0 = time.monotonic()
    sim = TiledSimulation(cfg, seed=1, device=device)
    n0 = int((sim.state.alive > 0.5).sum())
    setup = time.monotonic() - t0
    log(f"setup {setup:.0f}s; {n0:,} particles; "
        f"cadences={sim.rebucket_every_s}")
    run_n = sim.make_scan_steps(steps)
    t0 = time.monotonic()
    st, (ke, pe, dropped) = run_n(sim.state)
    ke = ke.double().sum(dim=1).cpu().numpy()
    pe = pe.double().cpu().numpy()
    wall = time.monotonic() - t0
    tot = ke + pe
    n1 = int((st.alive > 0.5).sum())
    dropped = int(dropped)
    log(f"{steps} steps in {wall:.1f}s "
        f"({n0 * steps / wall:.3e} psteps/s lower bound)")
    log(f"particles {n0:,} -> {n1:,}  dropped={dropped}")
    log(f"E0={tot[0]:.6e}  E[-1]={tot[-1]:.6e} "
        f"drift={(tot[-1]-tot[0])/tot[0]*100:.3f}%")
    # per-step relative changes; rebucket events should NOT stand out
    d = np.abs(np.diff(tot) / tot[:-1])
    R = min(sim.rebucket_every_s)
    at_rb = d[R - 1::R]
    others = np.delete(d, np.arange(R - 1, d.size, R))
    log(f"mean |dE/E| per step: rebucket-steps {at_rb.mean():.3e}  "
        f"other steps {others.mean():.3e}")
    # drops are counted honestly (the reference corrupts memory on the
    # same overflow, src/pusher.c:776,913); require them rare: < 5 ppm of
    # the population over the whole run
    ok = (exch_ok and n0 - n1 == dropped
          and dropped <= max(1, 5 * n0 // 1_000_000)
          and at_rb.mean() < 5.0 * max(others.mean(), 1e-12))
    log("VALIDATION " + ("PASS" if ok else "FAIL"))
    return dict(ok=ok, exchange_ok=exch_ok, n0=n0, n1=n1, dropped=dropped,
                steps=steps, wall=wall, setup=setup,
                psteps=n0 * steps / wall, e0=float(tot[0]),
                e_end=float(tot[-1]), rb_mean=float(at_rb.mean()),
                other_mean=float(others.mean()),
                cadences=list(sim.rebucket_every_s))


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 200
    return 0 if validate(steps, device=device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
