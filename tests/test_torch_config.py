"""pinc_tpu_torch's copies of the host modules (config, units) against
pinc_tpu's on every deck in input/."""

from pathlib import Path

import pytest

from pinc_tpu.config import PincConfig as JConfig, required_np as j_required_np
from pinc_tpu.units import alloc_and_normalize as j_normalize
from pinc_tpu_torch.config import PincConfig, required_np
from pinc_tpu_torch.units import alloc_and_normalize

DECKS = sorted((Path(__file__).resolve().parents[1] / "input").glob("*.ini"))


def test_decks_found():
    assert len(DECKS) >= 7


@pytest.mark.parametrize("deck", DECKS, ids=lambda p: p.name)
def test_parse_and_normalize_identically(deck):
    overrides = ["time:nTimeSteps=3"]
    j = JConfig.from_file(deck, overrides)
    t = PincConfig.from_file(deck, overrides)
    assert dict(t._d) == dict(j._d)
    assert required_np(t) == j_required_np(j)
    try:
        ju = j_normalize(j)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            alloc_and_normalize(t)
        return
    tu = alloc_and_normalize(t)
    assert vars(tu) == vars(ju)
    # pc / tot suffixes expanded and normalized in place, key for key
    assert dict(t._d) == dict(j._d)


def test_timers():
    from pinc_tpu_torch.utils.timer import DeviceTimer, Timer
    for t in (Timer(), DeviceTimer("cpu")):
        t.start()
        sum(range(10000))
        t.stop()
        first = t.total
        assert first > 0
        t.start()
        t.stop()
        assert t.total >= first
        t.reset()
        assert t.total == 0


def test_getnp_cli(capsys):
    from pinc_tpu_torch.__main__ import main
    deck = str(DECKS[0])
    assert main([deck, "getnp", "grid:nSubdomains=2,2,1"]) == 0
    assert capsys.readouterr().out.strip() == str(
        j_required_np(JConfig.from_file(deck, ["grid:nSubdomains=2,2,1"])))
