"""The shipped Langmuir decks through pinc_tpu_torch's CLI on the CPU, at
their own sizes (langmuirWarm.ini: 32^3, 2 x 1,048,576 particles, flat
layout; langmuirCold1D.ini; langmuir2D.ini), 2 steps with files:output in
a temporary directory: every file pinc_tpu writes, with its dataset names,
shapes and attributes.  The 1-D and 2-D decks are also run through
pinc_tpu's CLI and their files compared (tests/test_torch_io.py's flat
tolerance: values within 1e-5 of each dataset's largest magnitude, the
energy history rtol 1e-5); langmuirWarm's final positions and velocities
are the run's own particles, bit for bit (float32 widened to float64).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from pinc_tpu.__main__ import main as jmain
from pinc_tpu_torch.__main__ import main
from test_torch_io import FILES, compare_files, datasets

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2


def _run(cli, deck, where, **kw):
    args = [str(ROOT / "input" / deck), f"time:nTimeSteps={STEPS}",
            f"files:output={where}/"]
    assert cli(args, **kw) == 0


@pytest.mark.parametrize("deck", ["langmuirCold1D.ini", "langmuir2D.ini"])
def test_small_decks_write_pinc_tpus_files(tmp_path, deck):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _run(main, deck, tmp_path / "torch", device="cpu")
    finally:
        torch.set_num_threads(n)
    _run(jmain, deck, tmp_path / "jax")
    assert (sorted(p.name for p in (tmp_path / "torch").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir())
            == sorted(FILES))
    compare_files(tmp_path / "torch", tmp_path / "jax", field_rtol=1e-5)


def test_langmuir_warm_writes_every_file(tmp_path):
    out = {}
    _run(main, "langmuirWarm.ini", tmp_path, out=out, device="cpu")
    sim = out["sim"]
    assert type(sim).__name__ == "Simulation"        # the flat layout
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(FILES)
    steps = [f"n={t:.1f}" for t in range(STEPS + 1)]
    for name, values in (("rho", 1), ("phi", 1), ("E", 3)):
        d = datasets(tmp_path / f"{name}.grid.h5")
        assert sorted(k for k in d if not k.startswith("@")) == steps
        assert all(d[k].shape == (32, 32, 32, values) for k in steps)
        assert d["@Axis denormalization factor"] == sim.units.length
        assert d["@Quantity denormalization factor"] == 1.0
    with h5py.File(tmp_path / "pop.pop.h5", "r") as f:
        assert (f.attrs["Position denormalization factor"]
                == sim.units.length)
        assert (f.attrs["Velocity denormalization factor"]
                == sim.units.velocity)
        pos = sim.particles.pos().numpy()
        vel = sim.particles.vel.numpy()
        alive = sim.particles.alive.numpy()
        for s in range(2):
            assert sorted(f[f"pos/specie {s}"]) == steps
            assert (sorted(f[f"vel/specie {s}"])
                    == [f"n={t - 0.5:.1f}" for t in range(STEPS + 1)])
            assert all(f[f"pos/specie {s}/{k}"].shape == (1_048_576, 3)
                       for k in steps)
            np.testing.assert_array_equal(
                f[f"pos/specie {s}/n={STEPS}.0"][()],
                pos[s][alive[s]].astype(np.float64))
            np.testing.assert_array_equal(
                f[f"vel/specie {s}/n={STEPS - 0.5:.1f}"][()],
                vel[s][alive[s]].astype(np.float64))
    d = datasets(tmp_path / "history.xy.h5")
    keys = sorted(k for k in d if not k.startswith("@"))
    assert keys == sorted(f"energy/{e}/{w}" for e in ("kinetic", "potential")
                          for w in ("total", "specie 0", "specie 1"))
    assert all(d[k].shape == (STEPS + 1, 2) for k in keys)
    np.testing.assert_allclose(d["energy/kinetic/total"][:, 1],
                               out["kinetic"].sum(1), rtol=1e-6)
