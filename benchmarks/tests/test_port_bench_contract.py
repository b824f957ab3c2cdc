"""The manifest, the result line and the imports keep to the benchmark's
contract."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys

import pytest

from bench_fixture import REPO, make_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def man():
    path = REPO / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    return json.loads(path.read_text())


def test_manifest_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (REPO / p).is_dir() and not p.endswith("_torch")


def test_run_seconds_fit_the_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs_and_cells(man):
    dirs = man["paths"]
    used = {w["config"] for w in man["workloads"]}
    names = [c["name"] for c in man["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert set(names) == used
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert any(c["file"].startswith(d + "/") for d in dirs)
        assert json.loads((REPO / c["file"]).read_text())["deck"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    pairs = set()
    assert 1 <= len(man["workloads"]) <= 24
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "benchmarks" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (REPO / "benchmarks" / "limits"
                / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = [w["name"] for w in man["workloads"]]
    names = list(e2e) + [m["name"] for m in man["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (REPO / "benchmarks" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        reports = [m for m in man["end_to_end"]
                   if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reports] and len(reports) >= 2
        assert any(c in m.get("workloads", cells) for m in man["per_layer"])


def test_limits_are_numbers(man):
    for w in man["workloads"]:
        lim = json.loads((REPO / "benchmarks" / "limits"
                          / f"{w['name']}.json").read_text())["limits"]
        assert lim and all(math.isfinite(float(v)) and float(v) >= 0
                           for v in lim.values())


def test_result_line_shape(tmp_path):
    from benchmarks.harness import run_cell
    root = make_tree(tmp_path)
    out = run_cell(root, "tiny16.run", 3_000_000_001, 0.2, True,
                   device="cpu")
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(dev)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for key in ("device_ops", "idle_gaps"):
        assert len(out["breakdown"][key]) <= 10
    for row in out["check"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result;
    also in a folder that holds only the manifest and the benchmark."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd in (REPO, make_tree(tmp_path)):
        proc = subprocess.run(
            [sys.executable, "-m", "benchmarks.run", "--workload",
             "maxwell128.hot.scan", "--seed", "5", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


IMPORTS = """
import sys, json
import {mods}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("mods,banned", [
    ("benchmarks.reference, benchmarks.check",
     {"jax", "jaxlib", "flax", "pinc_tpu", "pinc_tpu_torch"}),
    ("benchmarks.harness, benchmarks.trace, benchmarks.run, "
     "pinc_tpu_torch.tiled_sim", {"jax", "jaxlib", "flax", "pinc_tpu"}),
])
def test_imports(mods, banned):
    proc = subprocess.run([sys.executable, "-c", IMPORTS.format(mods=mods)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert not set(json.loads(proc.stdout)) & banned


def test_forbidden_names_compared_whole(monkeypatch):
    from benchmarks import run
    mods = dict(sys.modules)
    for name in ("pinc_tpu_torch", "pinc_tpu_torch.ops", "pinc_tpux",
                 "jaxtyping"):
        mods.setdefault(name, None)
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    mods["pinc_tpu.ops"] = None
    mods["jax"] = None
    assert run.forbidden_modules() == ["jax", "pinc_tpu"]
