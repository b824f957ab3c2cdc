"""pinc_tpu_torch's puModeParticle / puModeInterp run modes (pumodes.py)
against pinc_tpu's, on the CPU.

* particle_convergence: the same single-particle leapfrog in both
  packages; each dt's RMS trajectory error within 1e-3 relative (float32
  trajectories of a few hundred steps, the same operations), the orders
  within 1e-2 of pinc_tpu's and above tests/test_pumodes.py's bound 1.8.
* interp_convergence: the same seeded sample positions gathered by NGP
  and CIC; errors within 1e-5 relative (the same float32 corner sums),
  the orders within 1e-3.
* Both modes through each package's entry (the port's CLI): the same
  keys, orders as above.
"""

import numpy as np
import pytest

from pinc_tpu import pumodes as jpumodes
from pinc_tpu import simulation as _jsimulation   # noqa: F401 (registry)
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.registry import RUN_MODES as JRUN_MODES
from pinc_tpu_torch import pumodes
from pinc_tpu_torch.__main__ import main

DECK = """
[grid]
nDims = 1
nSubdomains = 1
trueSize = 32
boundaries = PERIODIC
[methods]
mode = {mode}
"""


def test_particle_convergence_matches_pinc_tpu():
    kw = dict(L=32, n_periods=1.0, dts=(0.2, 0.1, 0.05))
    ref = jpumodes.particle_convergence(**kw)
    mine = pumodes.particle_convergence(device="cpu", **kw)
    assert mine["dts"] == ref["dts"]
    np.testing.assert_allclose(mine["errors"], ref["errors"], rtol=1e-3)
    np.testing.assert_allclose(mine["orders"], ref["orders"], atol=1e-2)
    assert all(o > 1.8 for o in mine["orders"])


def test_interp_convergence_matches_pinc_tpu():
    kw = dict(sizes=(16, 32, 64), n_samples=2048)
    ref = jpumodes.interp_convergence(**kw)
    mine = pumodes.interp_convergence(device="cpu", **kw)
    for key in ("ngp", "cic"):
        np.testing.assert_allclose(mine[key], ref[key], rtol=1e-5)
        assert abs(mine[f"order_{key}"] - ref[f"order_{key}"]) < 1e-3
    assert 0.8 < mine["order_ngp"] < 1.2 and 1.8 < mine["order_cic"] < 2.2


@pytest.mark.parametrize("mode, orders", [
    ("puModeParticle", ("orders",)), ("puModeInterp",
                                      ("order_ngp", "order_cic"))])
def test_run_modes_through_the_cli(tmp_path, mode, orders):
    deck = tmp_path / "pu.ini"
    deck.write_text(DECK.format(mode=mode))
    out = {}
    assert main([str(deck)], out=out, device="cpu") == 0
    ref = JRUN_MODES.select(JConfig.from_file(str(deck)), "methods:mode")()
    assert sorted(out) == sorted(ref)
    for key in orders:
        np.testing.assert_allclose(out[key], ref[key], atol=1e-2)
