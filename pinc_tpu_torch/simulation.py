"""The simulation: deck -> time step -> run modes (the counterpart of
``pinc_tpu/simulation.py``).

Equivalent of the reference's ``main.c``: method selection
(src/main.c:55-79), allocation (src/main.c:84-107), the leapfrog half-kick
initialization (src/main.c:141-186) and the production time loop
(src/main.c:197-274).  PyTorch runs eagerly, so the step is a plain method
on tensors that live on ``Simulation.device``.

Deck features that are not ported yet raise ``NotImplementedError`` (see
``unported_features``) rather than run something else.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import PincConfig
from .grid import GridSpec, gradient, potential_energy
from .population import Particles, initialize_auto
from .registry import ACCELERATORS, DISTRIBUTORS, MIGRATORS, RUN_MODES, SOLVERS
from .units import Units, alloc_and_normalize
from .utils.logging import STATUS, TIMER, msg
from .ops import pusher as _pusher_ops
from .solvers import spectral as _spectral      # noqa: F401 (registry)

_TODO = "not ported to pinc_tpu_torch yet (ROADMAP.md, 'Still to port')"


def _unported(what: str):
    def factory(cfg: PincConfig):
        raise NotImplementedError(f"{what} is {_TODO}")
    return factory


for _name in ("mgSolve", "mgSolver", "multigrid"):
    SOLVERS.register(_name)(_unported(f"methods:poisson={_name} (multigrid)"))
for _name in ("mgMode", "mgModeErrorScaling", "puModeParticle",
              "puModeInterp"):
    RUN_MODES.register(_name)(_unported(f"methods:mode={_name}"))


def unported_features(cfg: PincConfig) -> List[str]:
    """The deck's features the port cannot run yet (empty when none)."""
    found = []
    for key in ("objects:objects", "files:objects"):
        if key in cfg and any(n.endswith(".h5")
                              for n in cfg.get_str_arr(key)):
            found.append(f"embedded objects ({key})")
    nd = cfg.get_int("grid:ndims")
    bnd = [b.strip().upper()
           for b in cfg.get_str_arr("grid:boundaries", 2 * nd)]
    if any(b != "PERIODIC" for b in bnd):
        found.append("non-periodic grid:boundaries (bc.py, multigrid)")
    if (cfg.get_int("files:checkpointevery", 0)
            or cfg.get_bool("time:resume")
            or cfg.get_double("time:starttime", 0.0) > 0.0):
        found.append("checkpoint/resume (files:checkpointEvery, "
                     "time:resume, time:startTime)")
    if cfg.get_bool("methods:debug"):
        found.append("the methods:debug invariant checks")
    return found


def check_supported(cfg: PincConfig) -> None:
    found = unported_features(cfg)
    if found:
        raise NotImplementedError("; ".join(found) + f": {_TODO}")


@dataclass
class Diagnostics:
    kin_energy: torch.Tensor   # (S,) time-centered KE per species
    pot_energy: torch.Tensor   # () total field energy 0.5*sum(rho*phi)
    n_lost: torch.Tensor       # particles lost this step


@dataclass
class StepOutput:
    particles: Particles
    rho: torch.Tensor
    phi: torch.Tensor
    E: torch.Tensor
    diag: Diagnostics


class Simulation:
    """Owns the configuration, the static problem setup and the step on
    the flat layout.  Mirrors the lifetime of regular() in the reference.
    ``device`` is where every tensor of the run lives."""

    _DEFER_PARTICLES = False

    def __init__(self, cfg: PincConfig, seed: int = 1, device="cpu"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.units: Units = alloc_and_normalize(cfg)
        self.spec = GridSpec.from_config(cfg)

        # method selection — same ini names as the reference's select()s
        self.acc = ACCELERATORS.select(cfg, "methods:acc")
        self.distr = DISTRIBUTORS.select(cfg, "methods:distr")
        self.migrate = MIGRATORS.select(cfg, "methods:migrate",
                                        default="puExtractEmigrantsND")
        self.solver = SOLVERS.select(cfg, "methods:poisson")

        # subclasses that rebuild their own state may skip the flat
        # (S, cap, D) arrays at giant populations and regenerate each
        # species on the device instead
        from .population import capacity_of, species_params_of, \
            wants_device_init
        defer = (self._DEFER_PARTICLES and wants_device_init(cfg)
                 and capacity_of(cfg)
                 * cfg.get_int("population:nspecies") > 32_000_000)
        if defer:
            self.particles = None
            self.params = species_params_of(cfg, self.spec, self.device)
        else:
            self.particles, self.params = initialize_auto(
                cfg, self.spec, seed=seed, device=self.device)
        self.n_time_steps = cfg.get_int("time:ntimesteps")

    # ----------------------------------------------------------------- step
    def _fields_from_particles(self, particles: Particles):
        rho = self.distr(particles, self.params, self.spec.global_size,
                         dtype=self.spec.dtype)
        phi = self.solver(rho)
        return rho, phi, -gradient(phi)

    def _half_kick(self, particles: Particles) -> StepOutput:
        """Initialization: solve the initial field and advance velocities a
        half step back (src/main.c:161-186: gMul(E,0.5); acc; gMul(E,2))."""
        rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, 0.5 * E,
                                 e_scale=0.5)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)))

    def _step(self, particles: Particles) -> StepOutput:
        """One full leapfrog step (src/main.c:197-274): move, migrate,
        deposit, solve, E = -grad(phi), kick."""
        particles = _pusher_ops.move(particles, self.spec.global_size,
                                     periodic=True)
        particles = self.migrate(particles)
        rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, E)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------------- run
    def run(self, progress_every: int = 10) -> Dict[str, np.ndarray]:
        """The regular() run mode: half-kick init, nTimeSteps steps,
        per-step energy history."""
        t_start = time.monotonic()
        out = self._half_kick(self.particles)
        ke_hist = [out.diag.kin_energy.cpu().numpy()]
        pe_hist = [float(out.diag.pot_energy)]
        particles = out.particles
        for n in range(1, self.n_time_steps + 1):
            out = self._step(particles)
            particles = out.particles
            ke = out.diag.kin_energy.cpu().numpy()
            pe = float(out.diag.pot_energy)
            ke_hist.append(ke)
            pe_hist.append(pe)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
        self._sync()
        wall = time.monotonic() - t_start
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.particles = particles
        return {"kinetic": np.stack(ke_hist), "potential": np.asarray(pe_hist),
                "wall_time": wall}


# ---------------------------------------------------------------------------
# Run modes (reference: select of methods:mode, src/main.c:32-36)
# ---------------------------------------------------------------------------

def default_device() -> torch.device:
    """The card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@RUN_MODES.register("regular")
def _regular_factory(cfg: PincConfig):
    def run(device=None):
        if "files:output" in cfg:
            raise NotImplementedError(
                f"files:output (HDF5 output, io_h5/spool) is {_TODO}; "
                f"drop the key to run without output")
        from .parallel.pic import make_simulation
        sim = make_simulation(cfg, device=device or default_device())
        hist = sim.run()
        hist["sim"] = sim
        return hist
    return run


@RUN_MODES.register("sMode")
def _s_mode_factory(cfg: PincConfig):
    """Demo spectral-solve mode (sMode, src/spectral.c:127-152): fill a
    sinusoidal rho, solve once, report the error against the analytic
    solution."""
    def run(device=None):
        from .grid import fill_sin
        alloc_and_normalize(cfg)
        spec = GridSpec.from_config(cfg)
        solver = SOLVERS.select(cfg, "methods:poisson", default="sSolve")
        rho_np, phi_exact = fill_sin(spec)
        rho = torch.as_tensor(rho_np, dtype=spec.dtype,
                              device=device or default_device())
        phi = solver(rho).cpu().numpy()
        err = np.sqrt(np.mean((phi - phi_exact) ** 2))
        msg(STATUS, "sMode RMS error vs analytic: %g", err)
        return {"rms_error": err, "phi": phi, "phi_exact": phi_exact}
    return run
