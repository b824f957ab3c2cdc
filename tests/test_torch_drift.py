"""The drift loop on the full drift deck's re-bucket route, on each scan
body, against pinc_tpu's, on the CPU.

``cbaseline/drift.py``'s ``run_chunks`` against ``cbaseline/tpu_drift.py``'s
loop (``tests/drift_parity.py`` holds both), from pinc_tpu's initial tiled
state carried across by ``compat.py``, on the drift deck cut to 16^3 with 8
particles per cell and 16 allocated.  That sizes the buckets at B = 10,240
= 10 x 1024 with the per-row gate holding, so both packages re-bucket the
electrons every step through the gather exchange (on the card, K8-K10), as
the full 32^3 deck does at B = 61,440.  Two windows of 4 steps with
``retune()`` between them; the ions' cadence (61) is not reached.  Cases:

* ``mega``: the mega scan body (the port's K5; pinc_tpu's Pallas kernels
  in interpret mode, as its own tests run them);
* ``instep``: ``tiles:mega=false``, the in-step fused body (K2/K4);
* ``xla``: ``tiles:backend=xla``, the unfused step (pinc_tpu's CPU
  default).

The energy series agree within ENERGY_RTOL (1e-6, as the sort-route test of
``tests/test_torch_verification.py``; measured 8e-8 to 1.3e-7).  Each case
takes ~90-105 s on two cores, nearly all of it pinc_tpu's trace and
compile of its interpret-mode gather exchange.

``test_mega_series_is_the_instep_series_a_slot_later`` pins why the two
bodies' E(1) differ: the mega body's (ke, pe) of slot k is centred on step
k-1, so its series is the in-step series moved by one slot and its E(1) is
the energy of the initial state.
"""

import numpy as np
import pytest
import torch

import drift_parity
from pinc_tpu.ops import pallas_gather_exchange as jgx
from pinc_tpu_torch.cbaseline import drift
from pinc_tpu_torch.ops import gather_exchange as gx

ENERGY_RTOL = 1e-6     # the drift tool's energy series
SMALL = ("grid:trueSize=16,16,16", "population:nParticles=8 pc",
         "population:nAlloc=16 pc")
B_GATHER = 10 * 1024
STEPS, CHUNK = 8, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_calls(monkeypatch, module, name) -> list:
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("body", sorted(drift_parity.BODIES))
def test_drift_loop_matches_pinc_tpu_on_the_gather_exchange(body,
                                                            monkeypatch):
    jcalls = _count_calls(monkeypatch, jgx, "rebucket_exchange_all_rows_g")
    pcalls = _count_calls(monkeypatch, gx, "rebucket_exchange_all_rows_g")
    jsim = drift_parity.jax_sim(STEPS, body, SMALL)
    init = drift_parity.jax_state(jsim)
    ref, jdrops = drift_parity.jax_loop(jsim, STEPS, CHUNK)
    assert jdrops == 0 and len(ref) == STEPS
    assert jcalls                  # traced into pinc_tpu's window

    sim = drift_parity.port_sim(STEPS, body, init, SMALL)
    assert (sim.ts.B, sim.ts.M, sim.rebucket_every_s) == (
        jsim.ts.B, jsim.ts.M, list(jsim.rebucket_every_s))
    assert sim.ts.B == B_GATHER and gx.supported(sim.ts.B)
    assert sim._exchange_rows and jsim._exchange_rows
    assert sim._use_mega == jsim._use_mega == (body == "mega")
    assert sim._use_fused == (body != "xla")
    res = drift.run_chunks(sim, STEPS, CHUNK, log=lambda text: None)
    # the electrons re-bucketed after every step, all through the gather
    # exchange; the ions (cadence 61) not in these windows
    assert sim.rebucket_every_s[0] == 1 and sim.rebucket_every_s[1] > STEPS
    assert len(pcalls) == STEPS
    np.testing.assert_allclose(res["tot"], ref, rtol=ENERGY_RTOL)
    assert res["n0"] == res["n1"] == int(init[2].sum())
    assert res["dropped"] == 0


def test_mega_series_is_the_instep_series_a_slot_later():
    """The mega body kicks with the field of the previous step's deposit:
    the same leapfrog trajectory as the in-step body, its (ke, pe) of slot
    k centred on step k-1 (pinc_tpu/tiled_sim.py:1426-1433).  So mega[k]
    is instep[k-1], and mega's E(1) is the initial state's energy, not
    the first step's.  The port only, from one state."""
    jsim = drift_parity.jax_sim(STEPS, "xla", SMALL)
    init = drift_parity.jax_state(jsim)
    tot = {}
    for body in ("mega", "instep"):
        sim = drift_parity.port_sim(STEPS, body, init, SMALL)
        tot[body] = drift.run_chunks(sim, STEPS, CHUNK,
                                     log=lambda text: None)["tot"]
    np.testing.assert_allclose(tot["mega"][1:], tot["instep"][:-1],
                               rtol=ENERGY_RTOL)
    # without the shift the series part far beyond the agreement
    unshifted = np.abs(tot["mega"] / tot["instep"] - 1.0).max()
    assert unshifted > 100 * ENERGY_RTOL
