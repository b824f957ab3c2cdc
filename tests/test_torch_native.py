"""pinc_tpu_torch's native host library (native/: the snapshot spooler,
built with g++ into pinc_tpu_torch/_build/) and its ini parser against
pinc_tpu's.

* pinc_tpu's native C++ parser (and its read_file) gives the port's
  Python parser's entries on every deck in input/ and on a deck of
  comments, case and blanks; a missing file raises in both packages.
* A spool round trip returns each record's name, step, dtype, shape and
  bits.
* The port's spool file is byte for byte pinc_tpu's for the same records.
"""

from pathlib import Path

import numpy as np
import pytest

from pinc_tpu import native as jnative
from pinc_tpu.config import PincConfig as JConfig
from pinc_tpu_torch import native
from pinc_tpu_torch.config import PincConfig

ROOT = Path(__file__).resolve().parents[1]
DECKS = sorted(p.name for p in (ROOT / "input").glob("*.ini"))

DECK = """
; top comment
[Time]
nTimeSteps = 45    ; inline
timeStep = 0.2
[grid]
nDims=3
TrueSize = 32, 16 ,16
stepSize=6.28 tot   # hash comment
empty =
"""


@pytest.fixture(scope="module")
def lib():
    L = native.lib()
    if L is None:
        pytest.skip("no C++ compiler (g++) to build the native library")
    return L


def test_library_builds_into_the_port(lib):
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "pinc_tpu_torch" / "_build"
    assert path.name.startswith("libpinc_native-")


@pytest.fixture(scope="module")
def jlib():
    if jnative.lib() is None:
        pytest.skip("pinc_tpu's native library does not build here")


def _entries(path) -> dict:
    """The port's read_file (its Python parser), checked against
    pinc_tpu's read_file (its native parser where it builds)."""
    port = dict(PincConfig.from_file(path)._d)
    assert port == dict(JConfig.from_file(path)._d)
    return port


@pytest.mark.parametrize("deck", DECKS)
def test_native_parser_matches_python_on_the_decks(jlib, deck):
    path = ROOT / "input" / deck
    assert jnative.parse_ini_native(str(path)) == _entries(path)


def test_native_parser_comments_and_case(jlib, tmp_path):
    p = tmp_path / "deck.ini"
    p.write_text(DECK)
    port = _entries(p)
    assert jnative.parse_ini_native(str(p)) == port
    assert port["time:ntimesteps"] == "45"
    assert port["grid:truesize"] == "32, 16 ,16"
    assert port["grid:stepsize"] == "6.28 tot"
    assert port["grid:empty"] == ""
    with pytest.raises(FileNotFoundError):
        jnative.parse_ini_native(str(tmp_path / "missing.ini"))
    with pytest.raises(FileNotFoundError):
        PincConfig.from_file(tmp_path / "missing.ini")


def _records():
    rng = np.random.default_rng(0)
    return [("rho", 3.0, rng.normal(size=(8, 6)).astype(np.float32)),
            ("E", 3.0, rng.normal(size=(4, 5, 6, 3))),
            ("pop/pos/0", 3.0, np.arange(24, dtype=np.int32).reshape(2, 3, 4)),
            ("pop/vel/1", 2.5, rng.normal(size=(0, 3)).astype(np.float32)),
            ("mask", 7.0, rng.uniform(size=(5,)) < 0.5)]


def test_spool_roundtrip(lib, tmp_path):
    from pinc_tpu_torch.spool import SpoolWriter, read_spool
    w = SpoolWriter(tmp_path / "sub" / "t.spool")
    recs = _records()
    for name, step, arr in recs:
        w.write(name, step, arr)
    assert w.close() == len(recs)
    assert w.close() == 0
    got = list(read_spool(tmp_path / "sub" / "t.spool"))
    assert len(got) == len(recs)
    for (name, step, arr), (gname, gstep, garr) in zip(recs, got):
        assert (gname, gstep) == (name, step)
        want = arr.astype(np.uint8) if arr.dtype == np.bool_ else arr
        assert garr.dtype == want.dtype and garr.shape == want.shape
        np.testing.assert_array_equal(garr, want)


def test_spool_file_is_pinc_tpus(lib, jlib, tmp_path):
    from pinc_tpu.spool import SpoolWriter as JSpoolWriter
    from pinc_tpu_torch.spool import SpoolWriter
    for cls, name in ((SpoolWriter, "torch.spool"),
                      (JSpoolWriter, "jax.spool")):
        w = cls(tmp_path / name)
        for rec in _records():
            w.write(*rec)
        w.close()
    assert ((tmp_path / "torch.spool").read_bytes()
            == (tmp_path / "jax.spool").read_bytes())
