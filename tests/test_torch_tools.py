"""The port's framework tools (pinc_tpu_torch/script, mpinc.sh) against the
repo's, and the repo's plot scripts on the port's output files, on the
CPU.

* construct_grid: a sphere, a box and a box merged into the sphere's file
  with --append; the written .grid.h5 arrays equal script/construct_grid.py's
  bit for bit, and the printed line the same.
* Pinc.getnp on every deck in input/ equals pinc_tpu's (its getnp prints
  ``required_np``); Pinc with device="cpu" runs the CLI's main on the CPU.
* validate at small shapes (16^3, the exchange check at B = 1024) passes
  on the CPU's plain versions; each exchange combination takes its route;
  a FAIL exits non-zero; without a card the tools raise.
* mpinc.sh prints the deck's device demand, then runs the CLI.
* script/plot/* and script/h5tovtk.py, run as tests/test_scripts.py runs
  them, on files the port's OutputWriter wrote.
* No tool imports jax, pinc_tpu or the repo's scripts.
"""

import contextlib
import importlib.util
import io
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu.config import required_np as j_required_np
from pinc_tpu_torch.config import PincConfig
from pinc_tpu_torch.io_h5 import OutputWriter
from pinc_tpu_torch.ops import exchange as ex
from pinc_tpu_torch.ops import gather_exchange as gx
from pinc_tpu_torch.ops import onehot_exchange as ox
from pinc_tpu_torch.script import construct_grid, validate
from pinc_tpu_torch.script.framework.pinc import Pinc
from pinc_tpu_torch.simulation import Simulation

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DECKS = sorted(p.name for p in (REPO / "input").glob("*.ini"))
SMALL_EXCHANGE = dict(nt=(4, 4, 4), T=8, B=1024, K=512)


def _load(path):
    """A repo script as a module of its own name, prefixed ``ref_``."""
    name = "ref_" + Path(path).stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().replace(" ", "")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run there")


# ------------------------------------------------------------ construct_grid

GRID_CASES = {
    "sphere": [["sphere", "{out}", "--size", "16,12,10", "--center",
                "8,6,5", "--radius", "4"]],
    "box": [["box", "{out}", "--size", "16,12,10", "--lo", "2,3,1",
             "--hi", "9,7,4", "--id", "3"]],
    "append": [["sphere", "{out}", "--size", "16,12,10", "--center",
                "8,6,5", "--radius", "3"],
               ["box", "{out}", "--size", "16,12,10", "--lo", "0,0,0",
                "--hi", "4,4,4", "--append"]],
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_construct_grid_matches_the_repo_tool(tmp_path, case):
    ref = _load(REPO / "script/construct_grid.py")
    files = {}
    for who, main in (("port", construct_grid.main), ("ref", ref.main)):
        out = str(tmp_path / f"{who}.grid.h5")
        text = "".join(_printed(main, [a.format(out=out) for a in argv])
                       for argv in GRID_CASES[case])
        with h5py.File(out) as f:
            files[who] = (sorted(f.keys()), np.asarray(f["n=0.0"]),
                          text.replace(out, "OUT"))
    assert files["port"][0] == files["ref"][0] == ["n=0.0"]
    assert files["port"][1].dtype == files["ref"][1].dtype
    assert np.array_equal(files["port"][1], files["ref"][1])
    assert files["port"][2] == files["ref"][2]
    assert np.unique(files["port"][1]).size == (3 if case == "append" else 2)


# ---------------------------------------------------------------------- Pinc

@pytest.mark.parametrize("deck", DECKS)
def test_getnp_matches_pinc_tpu(deck):
    ini = REPO / "input" / deck
    assert Pinc(ini).getnp() == j_required_np(JConfig.from_file(str(ini)))


def test_pinc_cpu_run_and_clean(tmp_path):
    out = tmp_path / "data" / "run"
    run = Pinc(REPO / "input" / "langmuirCold1D.ini",
               {"time:nTimeSteps": 4, "files:output": str(out)},
               device="cpu")
    assert run.getnp() == 1
    assert run.run().returncode == 0
    assert (tmp_path / "data" / "run_history.xy.h5").exists()
    hist = run.run_inproc()
    assert hist["kinetic"].shape == (5, 2)
    run.clean()
    assert not (tmp_path / "data").exists()


def test_pinc_refuses_a_card_index_for_a_subprocess():
    with pytest.raises(ValueError, match="subprocess"):
        Pinc(REPO / "input" / "langmuirCold1D.ini", device="cuda:0").run()


# ------------------------------------------------------------------ validate

def test_validate_passes_at_small_shapes(capsys):
    res = validate.validate(20, device="cpu", n=16, ppc=16,
                            exchange=SMALL_EXCHANGE)
    err = capsys.readouterr().err
    assert res["ok"] and res["exchange_ok"], res
    assert res["n0"] == res["n1"] == 2 * 16 ** 3 * 16
    assert res["dropped"] == 0 and res["cadences"][0] < 20
    assert err.count("payload_bitexact=True") == len(validate.EXCHANGE_CASES)
    assert "VALIDATION PASS" in err


@pytest.mark.parametrize("rows, fused, impl", validate.EXCHANGE_CASES)
def test_validate_exchange_routes(monkeypatch, rows, fused, impl):
    """Each combination reaches the gather exchange's functions (K8-K10)
    or the one-hot exchange's (K11), as its impl names."""
    seen = []
    for mod, names in ((gx, ("rebucket_exchange_all_rows_g",
                             "exchange_dim_g")),
                       (ox, ("rebucket_exchange_all_rows", "exchange_dim"))):
        for name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _mod=mod, **kw):
                seen.append(_mod)
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(validate, "EXCHANGE_CASES", ((rows, fused, impl),))
    assert validate.check_exchange_exact("cpu", **SMALL_EXCHANGE)
    assert seen and set(seen) == {gx if impl == "gather" else ox}
    assert ex.rebucket_exchange_planes.__module__ == ex.__name__


def test_validate_fail_exits_nonzero(monkeypatch):
    monkeypatch.setattr(validate, "validate",
                        lambda steps, device=None: {"ok": False})
    assert validate.main(["3"], device="cpu") == 1


def test_tools_raise_without_a_card():
    _no_card()
    from pinc_tpu_torch.cbaseline import drift
    from pinc_tpu_torch.script.framework import mg_optimizing
    from pinc_tpu_torch.verification import pumode
    for call in (lambda: validate.main(["2"]),
                 lambda: pumode.main(["interp"]),
                 lambda: drift.main([]),
                 lambda: mg_optimizing.main(
                     [str(REPO / "input" / "maxwellian.ini")])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# ------------------------------------------------------------------ mpinc.sh

def test_mpinc_prints_the_demand_then_runs():
    _no_card()
    proc = subprocess.run(
        ["bash", str(REPO / "pinc_tpu_torch" / "mpinc.sh"),
         "input/maxwellian.ini", "time:nTimeSteps=1"],
        capture_output=True, text=True, timeout=120)
    # four devices asked; the run itself then needs the card
    assert "deck requests 4 device(s)" in proc.stderr
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    usage = subprocess.run(["bash", str(REPO / "pinc_tpu_torch" /
                                        "mpinc.sh")],
                           capture_output=True, text=True, timeout=60)
    assert usage.returncode == 2 and "usage" in usage.stderr


# -------------------------------------------------- the plot scripts' input

PLOT_DECK = """
[files]
output = {out}
[time]
nTimeSteps = 4
timeStep = 0.2
[grid]
nDims = 3
nSubdomains = 1,1,1
trueSize = 16,16,16
stepSize = 1
boundaries = PERIODIC
[population]
nSpecies = 2
nParticles = 4 pc
nAlloc = 4 pc
charge = -1,1
mass = 1,100
multiplicity = auto
thermalVelocity = 0.1,0.02
[methods]
mode = regular
poisson = sSolve
acc = puAcc3D1KE
distr = puDistr3D1
migrate = puExtractEmigrantsND
"""


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    """tests/test_scripts.py's deck, written by the port's OutputWriter."""
    out = str(tmp_path_factory.mktemp("port_plots")) + "/run/"
    cfg = PincConfig.from_string(PLOT_DECK.format(out=out))
    sim = Simulation(cfg, seed=2, device="cpu")
    writer = OutputWriter(cfg, sim)
    sim.run(writer=writer, progress_every=0)
    writer.close()
    return Path(out)


#: tests/test_scripts.py:45-160's calls: script, its arguments (d: the
#: output directory, o: the file to write), the accepted return codes
PLOTS = {
    "energy": ("script/plot/energy.py", "e.png",
               lambda d, o: [d / "history.xy.h5", o], (0, None)),
    "grid_slice": ("script/plot/grid_slice.py", "s.png",
                   lambda d, o: [d / "rho.grid.h5", "0", "2", o], (0, None)),
    "animate": ("script/plot/animate.py", "a.gif",
                lambda d, o: [d / "phi.grid.h5", o], (0,)),
    "distribution": ("script/plot/distribution.py", "d.png",
                     lambda d, o: [d / "pop.pop.h5", o], (0,)),
    "compare_xy": ("script/plot/compare_xy.py", "c.png",
                   lambda d, o: [d / "history.xy.h5", d / "history.xy.h5",
                                 "--out", o, "--rel"], (0,)),
    "plot_along_x": ("script/plot/plot_along_x.py", "x.png",
                     lambda d, o: [d / "phi.grid.h5", o, "--times",
                                   "first,last"], (0,)),
    "scatter": ("script/plot/scatter_particles.py", "p.png",
                lambda d, o: [d / "pop.pop.h5", o, "--phase"], (0,)),
    "simple_plot": ("script/plot/simple_plot.py", "sp.png",
                    lambda d, o: [d / "history.xy.h5",
                                  "/energy/kinetic/total", o], (0, None)),
    "grid_contourf": ("script/plot/grid_contourf.py", "cf.png",
                      lambda d, o: [d / "phi.grid.h5", "0", "2", "1", o],
                      (0, None)),
    "h5tovtk": ("script/h5tovtk.py", "phi.vtk",
                lambda d, o: [d / "phi.grid.h5", "2", o], (0,)),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_repo_scripts_read_the_port_files(port_out, tmp_path, name):
    path, out_name, args, rcs = PLOTS[name]
    mod = _load(REPO / path)
    out = tmp_path / out_name
    assert mod.main([str(a) for a in args(port_out, out)]) in rcs
    assert out.exists() and out.stat().st_size > 0
    if name == "h5tovtk":
        text = out.read_text().splitlines()
        assert "DIMENSIONS 16 16 16" in text
        with h5py.File(port_out / "phi.grid.h5") as f:
            phi = np.asarray(f["n=2.0"])[..., 0]
        vals = np.loadtxt(text[text.index("LOOKUP_TABLE default") + 1:])
        np.testing.assert_allclose(vals, phi.reshape(-1), rtol=1e-8,
                                   atol=1e-12)


# ------------------------------------------------------------------- imports

TOOLS = ("pinc_tpu_torch.script.framework.pinc",
         "pinc_tpu_torch.script.framework.mg_optimizing",
         "pinc_tpu_torch.script.construct_grid",
         "pinc_tpu_torch.script.validate",
         "pinc_tpu_torch.verification.sweep",
         "pinc_tpu_torch.verification.dispersion",
         "pinc_tpu_torch.verification.pumode",
         "pinc_tpu_torch.cbaseline.drift")


def test_tools_import_no_jax_pinc_tpu_or_repo_scripts():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {TOOLS!r}:
            importlib.import_module(name)
        from pinc_tpu_torch.verification import dispersion, sweep
        from pinc_tpu_torch.cbaseline import drift
        from pinc_tpu_torch.script import validate
        from pinc_tpu_torch.script.framework import mg_optimizing
        from pinc_tpu_torch import pumodes, simulation, tiled_sim
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pinc_tpu",
                                      "framework", "matplotlib",
                                      "verification", "script",
                                      "cbaseline")]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)
    for name in TOOLS:
        src = (REPO / (name.replace(".", "/") + ".py")).read_text()
        assert "sys.path" not in src and "pinc_tpu." not in src.replace(
            "pinc_tpu_torch.", ""), name
