"""The kernel benchmark's deposit and gather variants of pinc_tpu_torch
(ops/kbench_kernels.py) against the Pallas kernels they port:
script/bench_kernels_tpu.py (K12) and the deposit/gather probes of
experiments/archive/kbench{,2,3,4,5,9}.py (K13), in interpret mode, on the
same numpy inputs.

The reference scripts are not a package: each is loaded by path into a
module of its own, its sizes (the module globals TS, NT, B, P, M) set to
the fixture's, and pl.pallas_call is patched to interpret mode for each
test only.  bench_kernels_tpu.py imports pallas_tiled._kron_rows, which no
longer exists: it is loaded with a stub in its place that raises if called
(its kron='iota' path never calls it), and with the JAX compilation cache
it switches on pointed at a temporary directory and switched back off.

Fixture: T = 8, 2x2x2 tiles (a 16^3 grid), B = 256 (rows of 32 slots), M
= 1 (and M = 2 for K12), C = 3.  On the CPU the probes' f32 dots are f32
(on a TPU they ran one bf16 pass: no precision=HIGHEST).

Tolerances: the int8 deposits bit for bit (exact int32 sums, then the same
f32 scale); the other deposits max|port - ref| <= 1e-5 max|ref| (sums in
another order); the gathers max|port - ref| <= 1e-5 max|ref| (the
reference's x reduction rounds differently, within an ulp).
"""

import ast
import contextlib
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pinc_tpu.ops import pallas_tiled
from pinc_tpu.ops.tiled import TileSpec as JTileSpec
from pinc_tpu_torch import kbench
from pinc_tpu_torch.ops import kbench_kernels as kb
from pinc_tpu_torch.ops import tiled_kernels as tk
from pinc_tpu_torch.ops.tiled import TileSpec

ROOT = Path(__file__).resolve().parent.parent
K12_FILE = "script/bench_kernels_tpu.py"
ARCHIVE = ("kbench", "kbench2", "kbench3", "kbench4", "kbench5", "kbench9")
GRID, T, B = (16, 16, 16), 8, 256
NT, L = 8, B // 8
_PALLAS_CALL = pl.pallas_call


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _cache_dir(path):
    """bench_kernels_tpu.py switches the JAX compilation cache on at
    import: point it at path, and put the settings back afterwards."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(path))
        try:
            yield
        finally:
            jax.config.update("jax_compilation_cache_dir", old[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              old[1])


def _no_kron_rows(*args, **kw):
    raise AssertionError("kron='repeat' is not ported: _kron_rows is gone")


@pytest.fixture(scope="module")
def k12(tmp_path_factory):
    with _cache_dir(tmp_path_factory.mktemp("jax_cache")), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_tiled, "_kron_rows", _no_kron_rows, raising=False)
        return _load(K12_FILE, "_ref_bench_kernels_tpu")


@pytest.fixture(scope="module")
def ar():
    """The archive probes, sized to the fixture at M = 1 (P = 11, the
    size kbench9.py builds its selection matrices for at import)."""
    jts = JTileSpec(grid=GRID, T=T, M=1, B=B)
    mods = {}
    for name in ARCHIVE:
        mod = _load(f"experiments/archive/{name}.py", f"_ref_{name}")
        mod.TS, mod.NT, mod.B, mod.P, mod.M = jts, NT, B, jts.P, 1
        mods[name] = mod
    return mods


def _ts(M):
    return TileSpec(grid=GRID, T=T, M=M, B=B), JTileSpec(grid=GRID, T=T,
                                                         M=M, B=B)


@pytest.fixture(scope="module")
def data():
    """The archive's inputs: slots uniform over [-M, T+M), 90% alive, a
    random field; a random kron plane (bf16) for deposit_constk."""
    rng = np.random.default_rng(5)
    P = T + 3
    return dict(
        xyz=rng.uniform(-1, T + 1, (3, NT, B)).astype(np.float32),
        val=(rng.uniform(size=(NT, B)) < 0.9).astype(np.float32),
        fld=rng.normal(size=(NT, P, P, P, 3)).astype(np.float32),
        kron=rng.uniform(size=(P * P, L)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, dtype=np.float32)
    got = got.numpy().reshape(ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _bits(got, ref):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_array_equal(got.numpy().reshape(ref.shape), ref)


# ---------------------------------------------------------------------------
# K12: bench_kernels_tpu.py (NT tiles, B slots, the first 170 live, the
# slots uniform over [0, T) as its gen())
# ---------------------------------------------------------------------------

def _k12_inputs(M):
    rng = np.random.default_rng(10 + M)
    P = T + 1 + 2 * M
    lp = rng.uniform(0, T, (3, NT, B)).astype(np.float32)
    value = np.broadcast_to((np.arange(B) < 170).astype(np.float32),
                            (NT, B)).copy()
    E = rng.normal(size=(NT, 3, P, P * P)).astype(np.float32)
    return lp, value, E


DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("M", [1, 2])
def test_k12_deposit_v(k12, M, dt):
    lp, value, _ = _k12_inputs(M)
    ts, jts = _ts(M)
    ref = k12.deposit_v(*(jnp.asarray(a) for a in lp), jnp.asarray(value),
                        jts, "iota", DT[dt][0])
    before = dict(tk.LAUNCHES)
    got = tk.deposit(_t(lp), _t(value), ts, mxu_dtype=DT[dt][1])
    assert tk.LAUNCHES == before            # CPU tensors: plain version
    assert got.shape == (NT, ts.P, ts.P ** 2)
    _close(got, ref)


@pytest.mark.parametrize("dt, stack", [("f32", False), ("bf16", False),
                                       ("bf16", True)])
@pytest.mark.parametrize("M", [1, 2])
def test_k12_gather_v(k12, M, dt, stack):
    lp, _, E = _k12_inputs(M)
    ts, jts = _ts(M)
    ref = k12.gather_v(jnp.asarray(E), *(jnp.asarray(a) for a in lp), jts,
                       "iota", stack, DT[dt][0])
    got = tk.gather(kb.field_pad_of(_t(E), ts.P), _t(lp), ts,
                    mxu_dtype=DT[dt][1])
    assert ref.shape == (3, NT, 8, L)
    _close(got, ref)


def test_k12_needs_kron_rows(tmp_path):
    """bench_kernels_tpu.py cannot be imported as it stands (its kron=
    'repeat' cases cannot run anywhere): if this starts to pass through,
    the reference was repaired and its FUNCTIONS rows want revisiting."""
    assert not hasattr(pallas_tiled, "_kron_rows")
    with _cache_dir(tmp_path), pytest.raises(ImportError,
                                             match="_kron_rows"):
        _load(K12_FILE, "_ref_bench_kernels_tpu_unpatched")


# ---------------------------------------------------------------------------
# K13: the archive's deposit/gather probes (M = 1)
# ---------------------------------------------------------------------------

_TS1, _JTS1 = _ts(1)
BF16 = torch.bfloat16


def _dep(mode=None, **kw):
    """The port of a deposit probe: K1 bf16, or the variant mode."""
    if mode is None:
        return lambda d: tk.deposit(_t(d["xyz"]), _t(d["val"]), _TS1,
                                    mxu_dtype=BF16)
    return lambda d: kb.deposit_variant(_t(d["xyz"]), _t(d["val"]), _TS1,
                                        mode, **{k: f(d) for k, f in
                                                 kw.items()})


def _gat(mode=None):
    """The port of a gather probe: K3 bf16, or a variant."""
    if mode is None:
        return lambda d: tk.gather(_t(d["fld"]), _t(d["xyz"]), _TS1,
                                   mxu_dtype=BF16)
    return lambda d: kb.gather_variant(_t(d["fld"]), _t(d["xyz"]), _TS1,
                                       mode)


def _gather_q(d):
    """kbench.gather_q's port: quantize_field (torch glue), then the int8
    gather."""
    Eq, scale = kb.quantize_field(_t(d["fld"]))
    return kb.gather_variant(Eq, _t(d["xyz"]), _TS1, "int8", scale=scale)


def _kron(d):
    return _t(d["kron"]).bfloat16()


def _xv(d):
    return jnp.asarray(d["xyz"]), jnp.asarray(d["val"])


def _fx(d):
    return jnp.asarray(d["fld"]), jnp.asarray(d["xyz"])


# id: (FUNCTIONS key, body or case, reference, port, bit-equal)
PROBES = {
    "kbench.deposit_q": (
        "kbench.deposit_q", "_deposit_kernel_q",
        lambda m, d: m["kbench"].deposit_q(*_xv(d), _JTS1),
        _dep("int8"), True),
    "kbench.gather_q": (
        "kbench.gather_q", "_gather_kernel_q",
        lambda m, d: m["kbench"].gather_q(*_fx(d), _JTS1),
        _gather_q, False),
    "kbench.deposit_2acc": (
        "kbench.deposit_2acc", "_deposit_kernel_2acc",
        lambda m, d: m["kbench"].deposit_2acc(*_xv(d), _JTS1),
        _dep(), False),
    "kbench2.deposit_constk": (
        "kbench2.deposit_constk", "_deposit_kernel_constk",
        lambda m, d: m["kbench2"].deposit_constk(
            *_xv(d), jnp.asarray(d["kron"]).astype(jnp.bfloat16), _JTS1),
        _dep("given_kron", kron=_kron), False),
    "kbench3.batched": (
        "kbench3.mk_dep", "_deposit_kernel_batched",
        lambda m, d: m["kbench3"].mk_dep(
            m["kbench3"]._deposit_kernel_batched)(*_xv(d)),
        _dep(), False),
    "kbench3.onedot": (
        "kbench3.mk_dep", "_deposit_kernel_onedot",
        lambda m, d: m["kbench3"].mk_dep(
            m["kbench3"]._deposit_kernel_onedot)(*_xv(d)),
        _dep(), False),
    "kbench3.vpuonly": (
        "kbench3.mk_dep", "_deposit_kernel_vpuonly",
        lambda m, d: m["kbench3"].mk_dep(
            m["kbench3"]._deposit_kernel_vpuonly)(*_xv(d)),
        _dep("weight_sums"), False),
    "kbench3.gat_batched": (
        "kbench3.mk_gat", "_gather_kernel_batched",
        lambda m, d: m["kbench3"].mk_gat(
            m["kbench3"]._gather_kernel_batched)(*_fx(d)),
        _gat(), False),
    "kbench3.gat_onedot": (
        "kbench3.mk_gat", "_gather_kernel_onedot",
        lambda m, d: m["kbench3"].mk_gat(
            m["kbench3"]._gather_kernel_onedot)(*_fx(d)),
        _gat(), False),
    "kbench4.dep_bf": (
        "kbench4.mk_dep", "_deposit_kernel_bf",
        lambda m, d: m["kbench4"].mk_dep(
            m["kbench4"]._deposit_kernel_bf)(*_xv(d)),
        _dep("bf16_native"), False),
    "kbench4.gat_bf": (
        "kbench4.mk_gat", "_gather_kernel_bf",
        lambda m, d: m["kbench4"].mk_gat(
            m["kbench4"]._gather_kernel_bf)(*_fx(d)),
        _gat("bf16_native"), False),
    "kbench4.gat_nored": (
        "kbench4.mk_gat", "_gather_kernel_nored",
        lambda m, d: m["kbench4"].mk_gat(
            m["kbench4"]._gather_kernel_nored)(*_fx(d)),
        _gat("no_xreduce"), False),
    "kbench4.gat_tdot": (
        "kbench4.mk_gat", "_gather_kernel_tdot",
        lambda m, d: m["kbench4"].mk_gat(
            m["kbench4"]._gather_kernel_tdot)(*_fx(d)),
        _gat(), False),
    "kbench5.dep_row": (
        "kbench5.dep_row", "_dep_row_kernel",
        lambda m, d: m["kbench5"].dep_row(*_xv(d)), _dep(), False),
    "kbench5.gat_row_f32": (
        "kbench5.gat_row", "gdtype=f32",
        lambda m, d: m["kbench5"].gat_row(*_fx(d)), _gat(), False),
    "kbench5.gat_row_bf16": (
        "kbench5.gat_row", "gdtype=bf16",
        lambda m, d: m["kbench5"].gat_row(*_fx(d), gdtype=jnp.bfloat16),
        _gat("g_bf16"), False),
    "kbench5.dep_row_q": (
        "kbench5.dep_row_q", "_dep_row_kernel_q",
        lambda m, d: m["kbench5"].dep_row_q(*_xv(d)),
        _dep("int8"), True),
    "kbench9.deposit_v4": (
        "kbench9.deposit_v4", "_deposit_kernel_v4",
        lambda m, d: m["kbench9"].deposit_v4(*_xv(d)), _dep(),
        False),
    "kbench9.gather_v4": (
        "kbench9.gather_v4", "_gather_kernel_v4",
        lambda m, d: m["kbench9"].gather_v4(*_fx(d)), _gat(), False),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_port_matches_reference(ar, data, probe):
    key, case, ref_fn, port_fn, exact = PROBES[probe]
    kernel = kb.FUNCTIONS[key][1][case][0]
    assert kernel in tk.LAUNCHES or kernel in kb.LAUNCHES
    ref = ref_fn(ar, data)
    before = (dict(tk.LAUNCHES), dict(kb.LAUNCHES))
    got = port_fn(data)
    assert (tk.LAUNCHES, kb.LAUNCHES) == before    # the plain versions
    assert float(np.abs(np.asarray(ref)).max()) > 0
    (_bits if exact else _close)(got, ref)


def test_deposit_novpu_does_not_trace(ar, data):
    """kbench2.py's VPU-only probe multiplies a (P*P, 1) by a (P, P*P):
    it has no function to port.  If it starts to trace, the reference
    was repaired and its FUNCTIONS row wants a port."""
    with pytest.raises(TypeError, match="incompatible shapes"):
        ar["kbench2"].deposit_novpu(*_xv(data), _JTS1)
    assert kb.FUNCTIONS["kbench2.deposit_novpu"][1][
        "_deposit_kernel_novpu"][0] is None


def _pallas_functions(rel: str):
    """{name: line} of the top-level functions of rel whose body reaches
    pl.pallas_call."""
    tree = ast.parse((ROOT / rel).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and any(
                isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                for n in ast.walk(node)):
            out[node.name] = node.lineno
    return out


def test_functions_point_at_pallas_calls():
    """FUNCTIONS names exactly the 16 functions of the six files that
    reach pl.pallas_call, each at its def; every port is a kernel with a
    launch counter, or None where the reference cannot run; REPLACES
    picks one function a variant kernel."""
    found = {}
    for stem, rel in [("bench_kernels_tpu", K12_FILE)] + [
            (n, f"experiments/archive/{n}.py") for n in ARCHIVE]:
        for name, line in _pallas_functions(rel).items():
            found[f"{stem}.{name}"] = f"{rel}:{line}"
    assert len(found) == 16
    assert {k: w for k, (w, _) in kb.FUNCTIONS.items()} == found
    unported = set()
    for key, (_, ports) in kb.FUNCTIONS.items():
        for case, (kernel, detail) in ports.items():
            if kernel is None:
                unported.add((key, case))
            else:
                assert kernel in tk.LAUNCHES or kernel in kb.LAUNCHES
    assert unported == {("bench_kernels_tpu.deposit_v", "kron='repeat'"),
                        ("bench_kernels_tpu.gather_v", "kron='repeat'"),
                        ("kbench2.deposit_novpu", "_deposit_kernel_novpu")}
    ported = {k for _, ports in kb.FUNCTIONS.values()
              for k, _ in ports.values()}
    assert set(kb.LAUNCHES) <= ported
    for key, where in kb.REPLACES.items():
        assert any(w == where and any(k == key for k, _ in p.values())
                   for w, p in kb.FUNCTIONS.values())
    tested = {(PROBES[p][0], PROBES[p][1]) for p in PROBES}
    assert tested == {(k, c) for k, (_, p) in kb.FUNCTIONS.items()
                      for c, (kern, _) in p.items()
                      if kern is not None and not k.startswith("bench_")}


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("mode", ["int8", "weight_sums", "given_kron"])
def test_deposit_modes_on_m2(mode):
    """The deposit variants at M = 2 (P = 13), against their definitions
    by numpy on the dense (P, B) weights of every node (wx and wyz rounded
    to bf16 for weight_sums and given_kron, as every probe's mxu_dtype
    does; given_kron one product a row with a bf16 plane)."""
    rng = np.random.default_rng(7)
    ts = TileSpec(grid=GRID, T=T, M=2, B=B)
    P = ts.P
    xyz = rng.uniform(-2, T + 2, (3, NT, B)).astype(np.float32)
    val = (rng.uniform(size=(NT, B)) < 0.9).astype(np.float32)
    kron = _bf16(rng.uniform(size=(P * P, L)).astype(np.float32))
    got = kb.deposit_variant(_t(xyz), _t(val), ts, mode,
                             kron=_t(kron).bfloat16()).numpy()
    nodes = np.arange(P, dtype=np.float32) - 2
    w = np.maximum(0, 1 - np.abs(xyz[:, :, None, :] - nodes[:, None]))
    wx = w[0] * val[:, None, :]                                 # (NT, P, B)
    wyz = (w[1][:, :, None] * w[2][:, None, :]).reshape(NT, P * P, B)
    if mode == "int8":
        q = np.einsum("tab,tkb->tak", np.rint(127 * wx).astype(np.int64),
                      np.rint(127 * wyz).astype(np.int64))
        want = q.astype(np.float32) * np.float32(kb.INV_127SQ)
    elif mode == "weight_sums":
        want = (_bf16(wx).astype(np.float64).sum(-1)[:, :, None]
                + _bf16(wyz).astype(np.float64).sum(-1)[:, None, :])
    else:
        rows = _bf16(wx).astype(np.float64).reshape(NT, P, 8, L)
        want = sum(rows[:, :, r] @ kron.astype(np.float64).T
                   for r in range(8))
    _close(torch.from_numpy(got), want)


def test_kbench_runs_every_row_on_the_cpu():
    """python -m pinc_tpu_torch.kbench's rows at the fixture's size,
    untimed (on the CPU the wrappers run the plain versions); the prims
    sweep's rows are tests/test_torch_kbench_prims.py's."""
    rows = kbench.run(device="cpu", time=False,
                      k12=dict(grid=GRID, B=B, fill=170),
                      k13=dict(grid=GRID, B=B),
                      prims=dict(NT=NT, L=L, W=L // 4, B=B))
    assert [r["name"] for r in rows if r["sweep"] != "prims"] == (
        [f"K12 {f} M={M} {dn}" for M in (1, 2)
         for f in ("deposit_v", "gather_v") for dn in ("f32", "bf16")]
        + ["K13 deposit bf16 (K1)"]
        + [f"K13 deposit {m}" for m in kb.DEPOSIT_MODES]
        + ["K13 gather bf16 (K3)"] + [f"K13 gather {m}"
                                      for m in kb.GATHER_MODES])
    assert [r["sweep"] for r in rows] == (
        ["k12"] * 8 + ["k13"] * 10 + ["prims"] * 23)
    assert all(r["ok"] and r["refs"] for r in rows)
    assert all(r["library_ms"] is None and r["library"] is None
               for r in rows if r["sweep"] != "prims")
    by = {r["name"]: r for r in rows}
    for m in kbench.CEILINGS:
        assert by[f"K13 {'gather' if m == 'no_xreduce' else 'deposit'} "
                  f"{m}"]["err_vs_prod"] is None
    assert by["K12 deposit_v M=2 bf16"]["err_vs_prod"] == 0.0
    assert 0 < by["K12 gather_v M=1 f32"]["err_vs_prod"] < 1e-2
    assert 0 < by["K13 deposit int8"]["err_vs_prod"] < 2e-2
    with pytest.raises(ValueError, match="CUDA card"):
        kbench.run(device="cpu")


def test_kbench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kbench.main(["1"])


def test_wrappers_reject_what_the_kernels_do_not_take(data):
    xyz, val = _t(data["xyz"]), _t(data["val"])
    with pytest.raises(ValueError, match="mode"):
        kb.deposit_variant(xyz, val, _TS1, "fp8")
    with pytest.raises(ValueError, match="mode"):
        kb.gather_variant(_t(data["fld"]), xyz, _TS1, "int4")
    with pytest.raises(ValueError, match="no kernel"):
        kb.deposit_variant(xyz.to("meta"), val.to("meta"), _TS1, "int8")
    assert kb.REPLACES["kbench_deposit_int8"] == \
        "experiments/archive/kbench.py:99"
