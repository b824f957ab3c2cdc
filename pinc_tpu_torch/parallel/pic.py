"""Simulation factory (the single-device branch of
``pinc_tpu/parallel/pic.py``'s ``make_simulation``).  Decomposed decks
(``grid:nSubdomains`` > 1) are not ported yet and raise."""

from __future__ import annotations

from ..config import PincConfig, required_np
from ..population import capacity_of
from ..simulation import _TODO, Simulation
from ..utils.logging import STATUS, msg

# Above this many particle slots (capacity x species) the flat layout's
# working set is too large and the tiled layout is selected automatically
# when the deck does not pin methods:layout (the threshold of pinc_tpu).
AUTO_TILED_SLOTS = 24_000_000


def make_simulation(cfg: PincConfig, seed: int = 1,
                    device=None) -> Simulation:
    """Tiled layout when methods:layout = tiled, or automatically for decks
    too big for the flat working set; plain single-block otherwise.
    device: the CUDA card by default, or e.g. "cpu"."""
    if required_np(cfg) > 1:
        raise NotImplementedError(
            f"grid:nSubdomains > 1 (the multi-device layer, parallel/) is "
            f"{_TODO}")
    layout = cfg.get_str("methods:layout", "").lower()
    tiled = layout == "tiled"
    slots = capacity_of(cfg) * cfg.get_int("population:nspecies")
    if not layout and slots > AUTO_TILED_SLOTS:
        msg(STATUS, "auto-selected methods:layout=tiled (%d particle "
            "slots exceed the flat layout's working set); pin "
            "methods:layout=flat to override", slots)
        tiled = True
    if tiled:
        from ..tiled_sim import TiledSimulation
        return TiledSimulation(cfg, seed=seed, device=device)
    return Simulation(cfg, seed=seed, device=device)
