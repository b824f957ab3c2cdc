"""The kernel benchmark's exchange primitives of pinc_tpu_torch
(ops/kbench_prims.py: take, roll, plane_add, lane_prefix) against the
Pallas probes they port, K13's exchange-primitive family:
experiments/r4_gather_probe{,2,3}.py, experiments/r4_roll_probe.py,
experiments/r5_progoverhead.py and experiments/archive/kbench7.py, in
interpret mode, on the same numpy inputs, bit pattern for bit pattern.

The probe scripts are not a package, and two of them run at import:
r4_gather_probe.py times a 4096-tile gather (no __main__ guard) and
r5_progoverhead.py reads sys.argv, imports pinc_tpu.tiled_sim and times
2 GB of planes.  So their functions are taken from their source with ast:
for r4_gather_probe.py the imports, constants and defs (without the
module-level probe calls and if blocks), and ``gat`` built from ``kern2``
and ``row`` of its ``if ok_e and ok_m:`` block at a small NT; for
r5_progoverhead.py its ``NP``, ``_kernel`` and ``mk`` with small NT and L
and jax.jit in place of ``_jit``; for r4_gather_probe2.py its ``probe``
with the module's own calls, whose output is read from its
``np.array_equal`` check.  r4_gather_probe3.py, r4_roll_probe.py and
kbench7.py are loaded by path.  pl.pallas_call is patched to interpret
mode for each test only; r4_roll_probe.run passes ``interpret=`` itself,
so its kernel runs under a pallas_call built as ``run`` builds it.

On the CPU the wrappers run the plain versions (no launch is counted).
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pinc_tpu_torch import kbench
from pinc_tpu_torch.ops import kbench_prims as kp

ROOT = Path(__file__).resolve().parent.parent
GATHER = "experiments/r4_gather_probe.py"
PROBE2 = "experiments/r4_gather_probe2.py"
PROBE3 = "experiments/r4_gather_probe3.py"
ROLL = "experiments/r4_roll_probe.py"
PROGOVERHEAD = "experiments/r5_progoverhead.py"
KBENCH7 = "experiments/archive/kbench7.py"
FILES = {"r4_gather_probe": GATHER, "r4_gather_probe2": PROBE2,
         "r4_gather_probe3": PROBE3, "r4_roll_probe": ROLL,
         "r5_progoverhead": PROGOVERHEAD, "kbench7": KBENCH7}
_PALLAS_CALL = pl.pallas_call


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exec(rel: str, nodes, ns: dict) -> dict:
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]),
                 str(ROOT / rel), "exec"), ns)
    return ns


def _calls(node, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == name for n in ast.walk(node))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(got: torch.Tensor, ref) -> None:
    ref = np.array(ref)
    assert got.dtype == torch.from_numpy(ref).dtype
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.fixture
def no_launch():
    """The wrappers run their plain versions on the CPU: no launch."""
    before = dict(kp.LAUNCHES)
    yield
    assert kp.LAUNCHES == before


# ---------------------------------------------------------------------------
# r4_gather_probe.py: the four single-block gathers and the tiled gat
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gather_probe():
    """r4_gather_probe.py's imports, constants and defs, and its
    ``if ok_e and ok_m:`` block (for gat)."""
    tree = ast.parse((ROOT / GATHER).read_text())
    keep, block = [], None
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and not _calls(node.value,
                                                         "probe"):
            keep.append(node)
        elif isinstance(node, ast.If) and \
                ast.unparse(node.test) == "ok_e and ok_m":
            block = node
    ns = _exec(GATHER, keep, {"__name__": "_ref_r4_gather_probe"})
    return ns, block


def _replay(ns) -> np.random.Generator:
    """A generator in the state of the module's rng: it draws what a
    build_taa_* function is about to draw."""
    r = np.random.default_rng()
    r.bit_generator.state = ns["rng"].bit_generator.state
    return r


def _special_idx(rng, n: int, shape) -> np.ndarray:
    """Indices over [-n - 3, n + 3) with -1, -n, -n - 1, n and INT32_MIN
    among them: some wrap, some fill."""
    idx = rng.integers(-n - 3, n + 3, size=shape).astype(np.int32)
    idx.flat[:5] = [-1, -n, -n - 1, n, np.iinfo(np.int32).min]
    return idx


@pytest.mark.parametrize("indices", ["probe", "wrap_and_fill"])
def test_taa_extract_matches_reference(gather_probe, no_launch, monkeypatch,
                                       indices):
    ns, _ = gather_probe
    L, W = ns["L"], ns["W"]
    if indices == "wrap_and_fill":      # build_taa_extract reads the global
        monkeypatch.setitem(ns, "idx_np", _special_idx(
            np.random.default_rng(3), L, (8, W)))
    ref = ns["build_taa_extract"]()()
    got = kp.take(_t(ns["pay_np"]), _t(ns["idx_np"]), 1)
    _bits(got, ref)
    assert np.isnan(np.asarray(ref)).any() == (indices == "wrap_and_fill")


def test_taa_merge_matches_reference(gather_probe, no_launch):
    ns, _ = gather_probe
    ref = ns["build_taa_merge"]()()
    got = kp.take(_t(ns["pay_np"][:, :ns["W"]]), _t(ns["idx_small_np"]), 1)
    _bits(got, ref)


def test_taa_square_matches_reference(gather_probe, no_launch):
    ns, _ = gather_probe
    L = ns["L"]
    r = _replay(ns)
    f = ns["build_taa_square"]()
    idx = r.integers(0, L, size=(8, L)).astype(np.int32)
    _bits(kp.take(_t(ns["pay_np"]), _t(idx), 1), f())


def test_taa_sublane_matches_reference(gather_probe, no_launch):
    ns, _ = gather_probe
    r = _replay(ns)
    f = ns["build_taa_sublane"]()
    src = r.normal(size=(64, 128)).astype(np.float32)
    idx = r.integers(0, 64, size=(64, 128)).astype(np.int32)
    _bits(kp.take(_t(src), _t(idx), 0), f())


def test_gat_matches_reference(gather_probe, no_launch):
    """The module-level gat (one program a tile) at NT = 3, indices that
    wrap and fill included."""
    ns, block = gather_probe
    nodes = [n for n in block.body
             if isinstance(n, ast.FunctionDef) and n.name == "kern2"
             or isinstance(n, ast.Assign) and n.targets[0].id in ("row",
                                                                  "gat")]
    assert len(nodes) == 3
    gat = _exec(GATHER, nodes, dict(ns, NT=3))["gat"]
    L, W = ns["L"], ns["W"]
    rng = np.random.default_rng(5)
    pay = rng.normal(size=(3, 8, L)).astype(np.float32)
    idx = _special_idx(rng, L, (3, 8, W))
    ref = gat(jnp.asarray(pay), jnp.asarray(idx))
    _bits(kp.take(_t(pay), _t(idx), 2), ref)


# ---------------------------------------------------------------------------
# r4_gather_probe2.py: probe() at the module's own five calls
# ---------------------------------------------------------------------------

def _probe2_calls():
    tree = ast.parse((ROOT / PROBE2).read_text())
    calls = [n.value for n in tree.body if isinstance(n, ast.Expr)
             and isinstance(n.value, ast.Call)
             and getattr(n.value.func, "id", None) == "probe"]
    return [tuple(ast.literal_eval(a) for a in c.args)
            + tuple(ast.literal_eval(k.value) for k in c.keywords)
            for c in calls]


@pytest.mark.parametrize("args", _probe2_calls(), ids=lambda a: a[0])
def test_probe2_matches_reference(no_launch, args):
    """probe() makes its own inputs and checks against numpy: its inputs
    are read from its np.take_along_axis call and its output from its
    np.array_equal call."""
    tree = ast.parse((ROOT / PROBE2).read_text())
    ns = _exec(PROBE2, [n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.FunctionDef))],
        {"__name__": "_ref_r4_gather_probe2"})
    seen = {}
    taa, equal = np.take_along_axis, np.array_equal

    def spy_taa(src, idx, axis):
        seen["src"], seen["idx"], seen["axis"] = src, idx, axis
        return taa(src, idx, axis)

    def spy_equal(a, b, *rest, **kw):
        seen["got"] = a
        return equal(a, b, *rest, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "take_along_axis", spy_taa)
        mp.setattr(np, "array_equal", spy_equal)
        assert ns["probe"](*args) is True
    got = kp.take(_t(seen["src"]), _t(seen["idx"]), seen["axis"])
    _bits(got, seen["got"])


# ---------------------------------------------------------------------------
# r4_gather_probe3.py: int_gather, dyn_roll; run_extract does not trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probe3():
    """Loaded by path (its import runs int_gather and dyn_roll, which pass
    in interpret mode; run_extract sits behind __main__)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(_PALLAS_CALL, interpret=True))
        return _load(PROBE3, "_ref_r4_gather_probe3")


def test_int_gather_matches_reference(probe3, no_launch):
    src = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128)
    idx = torch.arange(127, -1, -1, dtype=torch.int32).expand(8, 128)
    _bits(kp.take(src, idx.contiguous(), 1), probe3.int_gather())


def _dyn_roll_with(probe3, shift: int):
    """dyn_roll with its shift constant 5 replaced by ``shift``."""
    tree = ast.parse((ROOT / PROBE3).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dyn_roll")
    fives = [n for n in ast.walk(fn)
             if isinstance(n, ast.Constant) and n.value == 5]
    assert len(fives) == 1
    fives[0].value = shift
    return _exec(PROBE3, [fn], dict(vars(probe3)))["dyn_roll"]


@pytest.mark.parametrize("shift", [5, -3, 261, 0])
def test_dyn_roll_matches_reference(probe3, no_launch, shift):
    """The shift on the device (the probe's SMEM scalar), taken mod n."""
    ref = probe3.dyn_roll() if shift == 5 else _dyn_roll_with(probe3,
                                                              shift)()
    x = torch.arange(8 * 256, dtype=torch.float32).reshape(8, 256)
    _bits(kp.roll(x, torch.tensor([shift], dtype=torch.int32), 1), ref)


def test_run_extract_does_not_trace(probe3, monkeypatch):
    """_binsearch indexes take_along_axis with float32 positions (tgt is
    f32): it has no function to port.  If it starts to trace, the
    reference was repaired and its FUNCTIONS row wants a port."""
    monkeypatch.setattr(probe3, "NT", 1)
    with pytest.raises(TypeError, match="take_along_axis indices must be "
                                        "of integer type"):
        probe3.run_extract()
    assert kp.FUNCTIONS["r4_gather_probe3.run_extract"][1][0] is None


# ---------------------------------------------------------------------------
# r4_roll_probe.py, r5_progoverhead.py, archive/kbench7.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def roll_probe():
    return _load(ROLL, "_ref_r4_roll_probe")


@pytest.mark.parametrize("p", range(8))
def test_roll_probe_matches_reference(roll_probe, no_launch, p):
    mod = roll_probe
    x = np.random.default_rng(p).normal(size=(8, 128)).astype(np.float32)
    ref = pl.pallas_call(
        functools.partial(mod.kernel, p=p),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
    )(jnp.asarray(x))
    _bits(kp.roll(_t(x), p, 0), ref)


@pytest.fixture(scope="module")
def progoverhead():
    """_kernel and mk of r5_progoverhead.py at NT = 8 tiles of (8, 40),
    NP from the module, jax.jit for pinc_tpu.tiled_sim._jit."""
    tree = ast.parse((ROOT / PROGOVERHEAD).read_text())
    nodes = [n for n in tree.body
             if isinstance(n, ast.Import) or isinstance(n, ast.ImportFrom)
             and not n.module.startswith("pinc_tpu")
             or isinstance(n, ast.FunctionDef) and n.name in ("_kernel", "mk")
             or isinstance(n, ast.Assign) and n.targets[0].id == "NP"]
    return _exec(PROGOVERHEAD, nodes, {"__name__": "_ref_r5_progoverhead",
                                       "NT": 8, "L": 40, "_jit": jax.jit})


@pytest.mark.parametrize("G", [1, 4, 8])
def test_progoverhead_matches_reference(progoverhead, no_launch, G):
    """mk(G)'s scan of 8 pass-throughs against 8 plane_add calls."""
    ns = progoverhead
    rng = np.random.default_rng(G)
    planes = [rng.normal(size=(8, 8, 40)).astype(np.float32)
              for _ in range(ns["NP"])]
    ref, _ = ns["mk"](G)(tuple(jnp.asarray(p) for p in planes))
    got = [_t(p) for p in planes]
    for _ in range(8):
        got = kp.plane_add(got, G)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        _bits(g, r)


@pytest.mark.parametrize("data", ["mask", "normal"])
def test_pallas_scan_matches_reference(no_launch, data):
    """kbench7.py's pallas_scan at (16, 1000): B not a power of two, so
    the last log step is partial; normal inputs with -0.0 every 7th lane
    (the reference adds 0.0 below s, which makes it +0.0)."""
    mod = _load(KBENCH7, "_ref_kbench7")
    mod.NT, mod.B = 16, 1000
    rng = np.random.default_rng(7)
    if data == "mask":
        m = (rng.uniform(size=(16, 1000)) < 0.01).astype(np.float32)
    else:
        m = rng.normal(size=(16, 1000)).astype(np.float32)
        m[:, ::7] = -0.0
    ref = mod.pallas_scan(jnp.asarray(m))
    _bits(kp.lane_prefix(_t(m)), ref)


def _lane_prefix_schedule(m: np.ndarray, W: int, R: int) -> np.ndarray:
    """numpy emulation of lane_prefix's kernel on rows m (NT, B) float32:
    element i = r * W + t in register r of thread t; pass s adds element
    i - s (0.0 below s), for s < 32 by a shuffle up within each warp whose
    first s lanes read their partner from the shared row buffer (written by
    each warp's last s lanes), for 32 <= s < W from the row in shared
    memory, for s >= W from register r - s/W; the buffers alternate
    between passes.  Elements past B are never stored or read."""
    NT, B = m.shape
    i = np.arange(R)[:, None] * W + np.arange(W)[None, :]     # (R, W)
    valid = i < B
    lane = np.broadcast_to(np.arange(W) & 31, i.shape)
    x = np.zeros((NT, R, W), np.float32)
    x[:, valid] = m[:, i[valid]]
    buf = [np.full((NT, B), np.nan, np.float32) for _ in range(2)]
    p, s = 0, 1
    while s < 32 and s < B:
        wrote = valid & (lane >= 32 - s)
        buf[p][:, i[wrote]] = x[:, wrote]
        y = x.reshape(NT, R, W // 32, 32).copy()
        y[..., s:] = x.reshape(NT, R, W // 32, 32)[..., :-s]
        y = y.reshape(NT, R, W)
        head = lane < s
        read = head & valid & (i >= s)
        y[:, read] = buf[p][:, i[read] - s]
        y[:, head & ~read] = 0.0
        x = x + y
        s, p = 2 * s, p ^ 1
    while s < W and s < B:
        buf[p][:, i[valid]] = x[:, valid]
        y = np.zeros_like(x)
        read = valid & (i >= s)
        y[:, read] = buf[p][:, i[read] - s]
        x = np.where(valid, x + y, x)
        s, p = 2 * s, p ^ 1
    mm = 1
    while mm < R and mm * W < B:
        y = np.zeros_like(x)
        y[:, mm:] = x[:, :-mm]
        x = x + y
        mm *= 2
    return x[:, valid][:, np.argsort(i[valid])]


@pytest.mark.parametrize("B", [1, 31, 32, 33, 511, 513, 777, 9216,
                               kp.MAX_PREFIX_B])
def test_lane_prefix_schedule_matches_plain(B):
    """The register-blocked pass schedule of lane_prefix's kernel, at its
    (W, R) for B, bit for bit with lane_prefix_plain on rows that hold
    -0.0 (a whole row, and every 7th lane), +-inf and NaN."""
    W, R = kp.lane_prefix_layout(B)
    rng = np.random.default_rng(B)
    m = rng.normal(size=(4, B)).astype(np.float32)
    m[:, ::7] = -0.0
    m[0] = -0.0
    m[1, min(3, B - 1)] = np.inf
    m[2, B // 2] = -np.inf
    m[3, B - 1] = np.nan
    with np.errstate(invalid="ignore"):
        got = _lane_prefix_schedule(m, W, R)
    _bits(_t(got), kp.lane_prefix_plain(_t(m)).numpy())


def test_lane_prefix_layout_covers_every_row():
    """For every B the kernel takes: W a power of two in [32, 1024] and R =
    ceil(B / W) <= MAX_PREFIX_R registers a thread, W <= 512 where R > 29
    (the kernel's launch bounds)."""
    for B in range(1, kp.MAX_PREFIX_B + 1):
        W, R = kp.lane_prefix_layout(B)
        assert 32 <= W <= 1024 and W & (W - 1) == 0
        assert (R - 1) * W < B <= R * W and R <= kp.MAX_PREFIX_R
        assert R <= 29 or W <= 512


# ---------------------------------------------------------------------------
# take's chunk plan
# ---------------------------------------------------------------------------

def _take_emulated(src, idx, lanes, plan):
    """numpy emulation of take's kernel on a (batch, Rs, Cs) stack under
    plan, CTA by CTA as the kernel maps them: CTA x takes chunk k = x %
    chunks of the plan.blocks blocks from (x // chunks) * blocks, source
    rows [r0, r0 + nr) (lanes) or columns [c0, c0 + nc) (rows), staged
    into at most plan.smem_bytes (or read in place when 0), then gathers
    its output words from the chunk alone.  Returns (output, the number of
    CTAs that wrote each output word)."""
    batch, Rs, Cs = src.shape
    _, Ri, Ci = idx.shape
    n = Cs if lanes else Rs
    fill = np.array(kp.FILL_BITS[torch.float32], np.uint32)
    out = np.zeros(idx.shape, np.uint32)
    hits = np.zeros(idx.shape, np.int64)
    bits = src.view(np.uint32)
    for x in range(plan.ctas(batch)):
        g, k = divmod(x, plan.chunks)
        b0 = g * plan.blocks
        b1 = min(b0 + plan.blocks, batch)
        r0, c0 = (k * plan.rows, 0) if lanes else (0, k * plan.cols)
        r1, c1 = (min(r0 + plan.rows, Rs), Cs) if lanes else \
            (Rs, min(c0 + plan.cols, Cs))
        chunk = bits[b0:b1, r0:r1, c0:c1]
        if plan.smem_bytes:
            assert chunk.size * 4 <= plan.smem_bytes
        o = (slice(b0, b1), slice(r0, r1), slice(None)) if lanes else \
            (slice(b0, b1), slice(None), slice(c0, c1))
        j = idx[o].astype(np.int64)
        j = np.where(j < 0, j + n, j)
        inside = (j >= 0) & (j < n)
        jc = np.clip(j, 0, n - 1)
        got = (np.take_along_axis(chunk, jc, axis=2) if lanes else
               np.take_along_axis(chunk, jc, axis=1))
        out[o] = np.where(inside, got, fill)
        hits[o] += 1
    return out.view(np.float32), hits


#: (batch, source block, index block, lanes): the exchange's shapes, the
#: check_prims shapes that PROBE_BLOCKS does not hold, blocks above the
#: 227 KB of shared memory a CTA has (the old limit of a staged block),
#: and blocks read through L1
TAKE_SHAPES = {
    "extract": (3, (8, 2176), (8, 768), 1),
    "merge": (3, (8, 768), (8, 2176), 1),
    "square": (2, (8, 2176), (8, 2176), 1),
    "rows (8, 2176)": (2, (8, 2176), (8, 2176), 0),
    "rows (64, 130) by (40, 130)": (3, (64, 130), (40, 130), 0),
    "lanes (8, 130) by (8, 77)": (5, (8, 130), (8, 77), 1),
    "int32 lanes (8, 256)": (5, (8, 256), (8, 256), 1),
    "lanes (8, 8192) by (8, 1000), above 227 KB": (2, (8, 8192), (8, 1000),
                                                   1),
    "rows (384, 256) by (200, 256), above 227 KB": (2, (384, 256),
                                                    (200, 256), 0),
    "lanes (3, 20000), direct": (2, (3, 20000), (3, 4097), 1),
    "rows (1000, 68), direct": (1, (1000, 68), (77, 68), 0),
    **{f"probe {m}": (9, rc, rc, ax)
       for m, rc, ax, _, _ in kbench.PROBE_BLOCKS},
}


def _check_take_plan(batch, rc_s, rc_i, lanes, seed):
    """take_layout's plan for the shapes: within shared memory, strips of
    whole TAKE_MIN_STRIP multiples, blocks a CTA only where a chunk is a
    block; and the kernel's emulation under it covers every output word
    exactly once and equals take_plain bit for bit."""
    (Rs, Cs), (Ri, Ci) = rc_s, rc_i
    plan = kp.take_layout(Rs, Cs, Ri, Ci, lanes)
    assert plan.smem_bytes <= 232448
    if lanes:
        assert plan.cols == Cs and plan.chunks == -(-Rs // plan.rows)
    else:
        assert plan.rows == Rs and plan.chunks == -(-Cs // plan.cols)
        assert plan.cols == Cs or plan.cols % kp.TAKE_MIN_STRIP == 0
    assert plan.blocks == 1 or plan.chunks == 1
    if plan.smem_bytes:
        assert plan.smem_bytes == plan.blocks * plan.rows * plan.cols * 4
        assert plan.smem_bytes <= max(kp.TAKE_CHUNK_BYTES,
                                      kp.TAKE_STAGE_MAX_BYTES)
    rng = np.random.default_rng(seed)
    n = Cs if lanes else Rs
    src = rng.normal(size=(batch, Rs, Cs)).astype(np.float32)
    idx = rng.integers(-n - 3, n + 3, (batch, Ri, Ci)).astype(np.int32)
    got, hits = _take_emulated(src, idx, lanes, plan)
    assert (hits == 1).all()
    _bits(_t(got), kp.take_plain(_t(src), _t(idx), 1 + lanes).numpy())
    return plan


@pytest.mark.parametrize("shape", list(TAKE_SHAPES))
def test_take_layout_covers_every_output_once(shape):
    batch, rc_s, rc_i, lanes = TAKE_SHAPES[shape]
    plan = _check_take_plan(batch, rc_s, rc_i, lanes, len(shape))
    assert ("direct" in shape) == (plan.smem_bytes == 0)


@settings(max_examples=60, deadline=None, database=None)
@given(batch=st.integers(1, 5), Rs=st.integers(1, 300),
       Cs=st.integers(1, 700), other=st.integers(1, 300),
       lanes=st.integers(0, 1))
def test_take_layout_covers_drawn_shapes(batch, Rs, Cs, other, lanes):
    """Any shape: Cs not a multiple of 4, Ri != Rs along the rows (Ci !=
    Cs along the lanes), batch 1."""
    rc_i = (Rs, other) if lanes else (other, Cs)
    _check_take_plan(batch, (Rs, Cs), rc_i, lanes, batch * Rs + Cs)


@pytest.mark.parametrize("axis", [1, 2])
def test_take_above_the_old_block_limit(no_launch, axis):
    """A block of 65,536 words, more than a CTA's 227 KB of shared memory
    (the old limit of a staged block): take equals take_plain."""
    rng = np.random.default_rng(axis)
    src = rng.normal(size=(2, 64, 1024)).astype(np.float32)
    n = src.shape[axis]
    shape = (2, 64, 300) if axis == 2 else (2, 50, 1024)
    idx = rng.integers(-n - 3, n + 3, shape).astype(np.int32)
    _bits(kp.take(_t(src), _t(idx), axis),
          kp.take_plain(_t(src), _t(idx), axis).numpy())


# ---------------------------------------------------------------------------
# FUNCTIONS, semantics, the sweep, the wrappers' checks
# ---------------------------------------------------------------------------

#: the call sites that a test above holds against its reference
TESTED = {"r4_gather_probe.build_taa_extract",
          "r4_gather_probe.build_taa_merge",
          "r4_gather_probe.build_taa_square",
          "r4_gather_probe.build_taa_sublane", "r4_gather_probe.gat",
          "r4_gather_probe2.probe", "r4_gather_probe3.int_gather",
          "r4_gather_probe3.dyn_roll", "r4_roll_probe.run",
          "r5_progoverhead.mk", "kbench7.pallas_scan"}


def _pallas_sites(rel: str):
    """{name: line} of the top-level functions of rel whose body reaches
    pl.pallas_call, and of the names assigned a pl.pallas_call outside any
    function (in module-level blocks too)."""
    def reaches(node):
        return any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                   for n in ast.walk(node))

    out = {}

    def visit(stmts):
        for node in stmts:
            if isinstance(node, ast.FunctionDef):
                if reaches(node):
                    out[node.name] = node.lineno
            elif isinstance(node, ast.Assign):
                if reaches(node.value):
                    out[node.targets[0].id] = node.lineno
            elif isinstance(node, (ast.If, ast.For, ast.While, ast.With,
                                   ast.Try)):
                visit(node.body + getattr(node, "orelse", []))

    visit(ast.parse((ROOT / rel).read_text()).body)
    return out


def test_functions_point_at_pallas_calls():
    """FUNCTIONS names exactly the 12 call sites of the six files, each at
    its def (gat at its assignment); run_extract is the only one without
    a port; every port is a kernel with a launch counter, and each is
    held against its reference above."""
    found = {f"{stem}.{name}": f"{rel}:{line}" for stem, rel in FILES.items()
             for name, line in _pallas_sites(rel).items()}
    assert len(found) == 12
    assert {k: w for k, (w, _) in kp.FUNCTIONS.items()} == found
    unported = {k for k, (_, (kern, _)) in kp.FUNCTIONS.items()
                if kern is None}
    assert unported == {"r4_gather_probe3.run_extract"}
    ported = {kern for _, (kern, _) in kp.FUNCTIONS.values()} - {None}
    assert ported == set(kp.LAUNCHES)
    for key, where in kp.REPLACES.items():
        assert any(w == where and k == key
                   for w, (k, _) in kp.FUNCTIONS.values())
    assert TESTED == set(kp.FUNCTIONS) - unported


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_index_semantics_are_jax(no_launch, dtype, axis):
    """Indices in [-n, 0) wrap; any other index outside [0, n) gives NaN
    (float32) or INT32_MIN (int32), as jnp.take_along_axis."""
    rng = np.random.default_rng(11)
    src = (rng.normal(size=(8, 8)) * 100).astype(dtype)
    row = np.array([-1, 8, 9, 0, -8, -9, np.iinfo(np.int32).min, 7],
                   np.int32)
    idx = np.stack([np.roll(row, k) for k in range(8)], axis=axis ^ 1)
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(src), jnp.asarray(idx),
                                         axis=axis))
    got = kp.take(_t(src), _t(idx), axis)
    _bits(got, ref)
    fill = np.isnan(ref) if dtype == "float32" else \
        ref == np.iinfo(np.int32).min
    assert fill.sum() == 4 * 8


@pytest.mark.parametrize("device_shift", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("axis", [1, 2])
def test_roll_shifts_are_numpy(no_launch, device_shift, axis):
    """Negative shifts, 0, n and shifts past n, as np.roll."""
    x = np.random.default_rng(2).normal(size=(3, 8, 12)).astype(np.float32)
    n = x.shape[axis]
    for s in (-3, 0, 1, n, n + 3, -n - 1, 261, -1000):
        shift = torch.tensor([s], dtype=torch.int32) if device_shift else s
        _bits(kp.roll(_t(x), shift, axis), np.roll(x, s, axis=axis))


def test_kbench_runs_the_prims_sweep_on_the_cpu():
    """python -m pinc_tpu_torch.kbench's prims rows at a small size (the
    other sweeps at tests/test_torch_kbench.py's), untimed, and
    check_prims at the probes' shapes."""
    rows = kbench.run(device="cpu", time=False,
                      k12=dict(grid=(16, 16, 16), B=256, fill=170),
                      k13=dict(grid=(16, 16, 16), B=256),
                      prims=dict(NT=4, L=136, W=40, B=1000))
    rows = [r for r in rows if r["sweep"] == "prims"]
    assert [r["name"] for r in rows] == (
        [f"prims take {m}" for m in ("extract", "merge", "square")]
        + [f"prims take {m[0]}" for m in kbench.PROBE_BLOCKS]
        + [f"prims roll rows p={p}" for p in range(1, 8)]
        + ["prims roll lanes (device shift)"]
        + [f"prims plane_add G={G}" for G in (1, 4, 8)]
        + ["prims lane_prefix mask", "prims lane_prefix normal"])
    assert all(r["ok"] and r["bit_equal"] and r["refs"] and r["library"]
               and r["bound_ms"] > 0 and r["bound_by"] == "bytes"
               for r in rows)
    assert {r["kernel"] for r in rows} == set(kp.LAUNCHES)
    by = {r["name"]: r for r in rows}
    assert by["prims lane_prefix mask"]["library_err"] == 0.0
    assert 0 < by["prims lane_prefix normal"]["library_tol"]
    assert by["prims take extract"]["refs"] == [
        "experiments/r4_gather_probe.py:136",
        "experiments/r4_gather_probe.py:49"]
    assert by["prims take int_gather (8, 128) int32"]["refs"] == [
        "experiments/r4_gather_probe3.py:35"]
    checks = kbench.check_prims("cpu")
    assert all(r["ok"] for r in checks)
    assert {r["kernel"] for r in checks} == set(kp.LAUNCHES)


def _reject(kind: str):
    f32 = torch.zeros((2, 8, 16))
    i32 = torch.zeros((2, 8, 4), dtype=torch.int32)
    return {
        "take_f64": (TypeError, lambda: kp.take(f32.double(), i32, 2)),
        "take_i64_idx": (TypeError, lambda: kp.take(f32, i32.long(), 2)),
        "take_rank4": (ValueError, lambda: kp.take(f32[None], i32[None], 3)),
        "take_batch_axis": (ValueError, lambda: kp.take(f32, i32, 0)),
        "take_extent": (ValueError, lambda: kp.take(f32, i32[:, :4], 2)),
        "take_device": (ValueError, lambda: kp.take(f32.to("meta"),
                                                    i32.to("meta"), 2)),
        "take_empty": (ValueError, lambda: kp.take(f32, i32[:, :, :0], 2)),
        "roll_f64": (TypeError, lambda: kp.roll(f32.double(), 1, 1)),
        "roll_shift_i64": (TypeError, lambda: kp.roll(
            f32, torch.tensor([1]), 1)),
        "roll_shift_two": (ValueError, lambda: kp.roll(
            f32, torch.tensor([1, 2], dtype=torch.int32), 1)),
        "roll_device": (ValueError, lambda: kp.roll(f32.to("meta"), 1, 1)),
        "plane_add_none": (ValueError, lambda: kp.plane_add([])),
        "plane_add_nine": (ValueError, lambda: kp.plane_add([f32] * 9)),
        "plane_add_shapes": (ValueError, lambda: kp.plane_add(
            [f32, f32[:1].contiguous()])),
        "plane_add_int32": (TypeError, lambda: kp.plane_add([i32])),
        "plane_add_g0": (ValueError, lambda: kp.plane_add([f32], 0)),
        "lane_prefix_rank3": (ValueError, lambda: kp.lane_prefix(f32)),
        "lane_prefix_wide": (ValueError, lambda: kp.lane_prefix(
            torch.zeros((1, kp.MAX_PREFIX_B + 1)))),
        "lane_prefix_f64": (TypeError, lambda: kp.lane_prefix(
            f32[0].double())),
    }[kind]


@pytest.mark.parametrize("kind", [
    "take_f64", "take_i64_idx", "take_rank4", "take_batch_axis",
    "take_extent", "take_device", "take_empty", "roll_f64",
    "roll_shift_i64", "roll_shift_two", "roll_device", "plane_add_none",
    "plane_add_nine", "plane_add_shapes", "plane_add_int32", "plane_add_g0",
    "lane_prefix_rank3", "lane_prefix_wide", "lane_prefix_f64"])
def test_wrappers_reject_what_the_kernels_do_not_take(kind):
    error, call = _reject(kind)
    with pytest.raises(error):
        call()
