#!/usr/bin/env python3
"""The drift loop of both packages, from one state, on each scan body.

The port's loop is ``pinc_tpu_torch/cbaseline/drift.py``'s ``run_chunks``;
pinc_tpu's is ``cbaseline/tpu_drift.py``'s (windows of ``chunk`` steps of
``make_scan_steps`` with ``retune()`` between them), run here on the deck
``drift.make_sim`` reads.  Both start from pinc_tpu's initial tiled state,
carried across by ``compat.py``.  The bodies (``BODIES``):

* ``mega``: ``tiles:backend=pallas``, the mega scan body (pinc_tpu's
  Pallas kernels in interpret mode on the CPU; the port's K5);
* ``instep``: ``tiles:backend=pallas`` and ``tiles:mega=false``, the
  in-step fused body (the port's K2/K4);
* ``xla``: ``tiles:backend=xla``, the unfused step (pinc_tpu's CPU
  default).

On a 3-D deck both packages re-bucket through the exchange, the gather
exchange where B % 1024 == 0 (the full drift deck: B = 61,440).
``tests/test_torch_drift.py`` runs the loops at a small size; this script
runs them on the full 32^3 deck, each side in its own process, the curves
(float64 total energy a step) saved to DIR after every window:

    JAX_PLATFORMS=cpu python tests/drift_parity.py init DIR
    JAX_PLATFORMS=cpu python tests/drift_parity.py jax DIR BODY STEPS CHUNK
    python tests/drift_parity.py port DIR BODY STEPS CHUNK [THREADS]
    python tests/drift_parity.py report DIR

``init`` writes pinc_tpu's initial state (DIR/init.npz); ``jax`` and
``port`` write DIR/{jax,port}_BODY.npy (THREADS: the port's intra-op
threads); ``report`` prints, for each curve, its steps, E(1), the plateau
per 1k steps over the second half and the total drift
(``drift.drift_figures``), and for each body run on both sides the port's
figures over the common steps and the largest relative difference of the
two curves.  A CHUNK under 62, the ions' cadence, never re-buckets the
ions.  At 32^3 the port takes 4.5-6.5 s a step on two cores, pinc_tpu
19-42 s on two to four (either body) after a compile of ~8 minutes.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from pinc_tpu_torch.cbaseline import drift  # noqa: E402

BODIES = {"mega": ("tiles:backend=pallas",),
          "instep": ("tiles:backend=pallas", "tiles:mega=false"),
          "xla": ("tiles:backend=xla",)}
STATE_KEYS = ("lpos", "vel", "alive")


def jax_sim(steps: int, body: str, extra=()):
    """pinc_tpu's TiledSimulation of the drift deck (seed 1), with
    drift.make_sim's overrides."""
    from pinc_tpu.config import PincConfig
    from pinc_tpu.tiled_sim import TiledSimulation
    cfg = PincConfig.from_file(str(drift.DECK), [
        f"time:nTimeSteps={steps}", *drift.OVERRIDES, *extra,
        *BODIES[body]])
    return TiledSimulation(cfg, seed=1)


def jax_state(jsim) -> tuple:
    """pinc_tpu's tiled state as numpy (lpos, vel, alive)."""
    return tuple(np.array(getattr(jsim.state, k)) for k in STATE_KEYS)


def jax_loop(jsim, steps: int, chunk: int, out=None, log=None):
    """cbaseline/tpu_drift.py's loop from jsim.state.  Returns the total
    energy a step (float64) and the drops."""
    st, tots, drops = jsim.state, [], 0
    run_ch = jsim.make_scan_steps(chunk)
    t0 = time.monotonic()
    for c in range(steps // chunk):
        st, (ke, pe, dropped) = run_ch(st)
        drops += int(dropped)
        tots.append(np.asarray(ke, np.float64).sum(axis=1)
                    + np.asarray(pe, np.float64))
        if out is not None:
            np.save(out, np.concatenate(tots))
        if log is not None:
            log(f"chunk {c:3d}: E={tots[-1][-1]:.8e} drops_cum={drops} "
                f"alive={int(np.asarray(st.alive).sum())} "
                f"({time.monotonic() - t0:.0f}s)")
        if jsim.retune(st):
            run_ch = jsim.make_scan_steps(chunk)
    return np.concatenate(tots), drops


def port_sim(steps: int, body: str, init, extra=()):
    """The port's drift deck (drift.make_sim) on the CPU, its state
    pinc_tpu's (lpos, vel, alive)."""
    from pinc_tpu_torch import compat
    sim = drift.make_sim(steps, device="cpu",
                         extra=(*extra, *BODIES[body]))
    sim.state = compat.tiled_state_from_numpy(*init)
    return sim


def _log(text: str) -> None:
    print(text, flush=True)


def _describe(sim) -> str:
    return (f"B={sim.ts.B} M={sim.ts.M} cadences={sim.rebucket_every_s} "
            f"backend={sim._backend} mega={sim._use_mega} "
            f"rows={sim._exchange_rows} cap={sim._exchange_cap}")


def main(argv) -> int:
    cmd, d = argv[0], Path(argv[1])
    d.mkdir(parents=True, exist_ok=True)
    if cmd == "init":
        jsim = jax_sim(1, "xla")
        np.savez(d / "init.npz", **dict(zip(STATE_KEYS, jax_state(jsim))))
        return 0
    if cmd == "report":
        curves = {}
        for p in sorted(d.glob("*_*.npy")):
            tot = np.load(p)
            curves[p.stem] = tot[1] if tot.ndim == 2 else tot
        def figures(name, tot):
            f = drift.drift_figures(tot)
            print(f"{name}: {len(tot)} steps, E(1) {f['e1']:.8e}, plateau "
                  f"{f['plateau_per_1k'] * 100:+.5f}%/1k over the last "
                  f"{f['plateau_steps']}, total {f['total'] * 100:+.5f}%")
        for name, tot in curves.items():
            figures(name, tot)
        for body in BODIES:
            a, b = curves.get(f"jax_{body}"), curves.get(f"port_{body}")
            if a is not None and b is not None:
                n = min(len(a), len(b))
                figures(f"port_{body} over pinc_tpu's steps", b[:n])
                rel = np.abs(b[:n] / a[:n] - 1.0)
                print(f"{body}: port against pinc_tpu over {n} steps: max "
                      f"relative difference {rel.max():.3e} (step "
                      f"{int(rel.argmax()) + 1}), at the last step "
                      f"{rel[-1]:.3e}")
        return 0
    body, steps, chunk = argv[2], int(argv[3]), int(argv[4])
    init = np.load(d / "init.npz")
    init = tuple(init[k] for k in STATE_KEYS)
    if cmd == "jax":
        jsim = jax_sim(steps, body)
        _log(_describe(jsim))
        tot, drops = jax_loop(jsim, steps, chunk, out=d / f"jax_{body}.npy",
                              log=_log)
        _log(f"drops {drops}")
        return 0
    if cmd == "port":
        import torch
        if len(argv) > 5:
            torch.set_num_threads(int(argv[5]))
        sim = port_sim(steps, body, init)
        _log(_describe(sim))
        res = drift.run_chunks(sim, steps, chunk,
                               out=d / f"port_{body}.npy", log=_log)
        _log(f"lost {res['n0'] - res['n1']} dropped {res['dropped']} "
             f"wall {res['wall']:.0f}s")
        return 0
    raise SystemExit(f"unknown command {cmd}")


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
