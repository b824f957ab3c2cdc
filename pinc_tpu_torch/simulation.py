"""The simulation: deck -> time step -> run modes (the counterpart of
``pinc_tpu/simulation.py``).

Equivalent of the reference's ``main.c``: method selection
(src/main.c:55-79), allocation (src/main.c:84-107), the leapfrog half-kick
initialization (src/main.c:141-186) and the production time loop
(src/main.c:197-274).  PyTorch runs eagerly, so the step is a plain method
on tensors that live on ``Simulation.device``.

Deck features that are not ported yet (objects; ``grid:nSubdomains`` > 1
through the factory, ``parallel/pic.py``) raise ``NotImplementedError``
(see ``unported_features``) rather than run something else.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .bc import BCSpec, gradient_bc
from .config import PincConfig
from .grid import BndType, GridSpec, gradient, potential_energy
from .population import Particles, initialize_auto
from .registry import ACCELERATORS, DISTRIBUTORS, MIGRATORS, RUN_MODES, SOLVERS
from .units import Units, alloc_and_normalize
from .utils.logging import ERROR, STATUS, TIMER, WARNING, msg
from .ops import pusher as _pusher_ops
from .solvers import spectral as _spectral      # noqa: F401 (registry)
from .solvers import multigrid as _multigrid    # noqa: F401 (registry)
from . import pumodes as _pumodes               # noqa: F401 (registry)

_TODO = "not ported to pinc_tpu_torch yet (ROADMAP.md, 'Still to port')"


def unported_features(cfg: PincConfig) -> List[str]:
    """The deck's features the port cannot run yet (empty when none)."""
    found = []
    for key in ("objects:objects", "files:objects"):
        if key in cfg and any(n.endswith(".h5")
                              for n in cfg.get_str_arr(key)):
            found.append(f"embedded objects ({key})")
    return found


def check_single_device(cfg: PincConfig, what: str) -> None:
    """Decomposed decks (grid:nSubdomains > 1) need the multi-device layer
    (parallel/), which is not ported: raise."""
    from .config import required_np
    if required_np(cfg) > 1:
        raise NotImplementedError(
            f"{what} with grid:nSubdomains > 1 (the multi-device layer, "
            f"parallel/) is {_TODO}")


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
    particles: Optional[Particles]   # None where no writer reads them
    rho: torch.Tensor
    phi: torch.Tensor
    E: torch.Tensor
    diag: Diagnostics


class Simulation:
    """Owns the configuration, the static problem setup and the step on
    the flat layout.  Mirrors the lifetime of regular() in the reference.
    ``device`` is where every tensor of the run lives: the CUDA card by
    default, the CPU only when the caller passes ``device="cpu"``."""

    _DEFER_PARTICLES = False
    _TILED_CKPT = False        # TiledSimulation restores tiled checkpoints

    def __init__(self, cfg: PincConfig, seed: int = 1, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.units: Units = alloc_and_normalize(cfg)
        self.spec = GridSpec.from_config(cfg)

        # method selection — same ini names as the reference's select()s
        self.acc = ACCELERATORS.select(cfg, "methods:acc")
        self.distr = DISTRIBUTORS.select(cfg, "methods:distr")
        self.migrate = MIGRATORS.select(cfg, "methods:migrate",
                                        default="puExtractEmigrantsND")
        self.solver = SOLVERS.select(cfg, "methods:poisson")

        self.bc = BCSpec.from_config(cfg)
        # the dims with walls (reflection), and per-dim periodicity for the
        # CIC/NGP wrap-or-clamp (mixed decks wrap their periodic dims;
        # uniform decks pass one bool)
        self._bounded_dims = tuple(b is not BndType.PERIODIC
                                   for b in self.bc.upper)
        self._periodic_dims = (self.spec.periodic
                               if len(set(self._bounded_dims)) == 1
                               else tuple(not b for b in self._bounded_dims))

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

        # checkpoint/resume (checkpoint.py): files:checkpointEvery writes,
        # time:resume or time:startTime > 0 restores and continues the
        # step numbering
        self.checkpoint_every = cfg.get_int("files:checkpointevery", 0)
        self.start_step = 0
        self._resumed = False
        self._pending_tiled_resume = False
        if (cfg.get_bool("time:resume")
                or cfg.get_double("time:starttime", 0.0) > 0.0):
            from . import checkpoint as _ckpt
            layout = _ckpt.peek_layout(cfg)
            if layout is None:
                msg(WARNING, "time:startTime/resume set but no checkpoint "
                    "found; starting fresh")
            elif layout == "tiled":
                # restored verbatim into the tiled state, once the tiled
                # subclass has its TileSpec
                if not self._TILED_CKPT:
                    raise ValueError(
                        "checkpoint was written by methods:layout=tiled; "
                        "resume with the same layout")
                self._pending_tiled_resume = True
            else:
                self.start_step, self.particles = _ckpt.load(
                    cfg, device=self.device)
                self._resumed = True

    # ----------------------------------------------------------------- step
    def _efield(self, phi: torch.Tensor) -> torch.Tensor:
        """E = -grad(phi), through the BC-aware gradient on bounded decks."""
        if self.spec.periodic:
            return -gradient(phi)
        return -gradient_bc(phi, self.bc)

    def _fields_from_particles(self, particles: Particles):
        rho = self.distr(particles, self.params, self.spec.global_size,
                         periodic=self._periodic_dims, dtype=self.spec.dtype)
        phi = self.solver(rho)
        return rho, phi, self._efield(phi)

    def _half_kick(self, particles: Particles) -> StepOutput:
        """Initialization: solve the initial field and advance velocities a
        half step back (src/main.c:161-186: gMul(E,0.5); acc; gMul(E,2))."""
        rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, 0.5 * E,
                                 periodic=self._periodic_dims, e_scale=0.5)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)))

    def _step(self, particles: Particles) -> StepOutput:
        """One full leapfrog step (src/main.c:197-274): move (and reflect
        at bounded walls), migrate, deposit, solve, E = -grad(phi), kick."""
        particles = _pusher_ops.move(particles, self.spec.global_size,
                                     periodic=self.spec.periodic)
        if not self.spec.periodic:
            # bounded walls reflect; the periodic dims of a mixed deck
            # wrap (move ran unwrapped)
            particles = _pusher_ops.reflect(particles, self.spec.global_size,
                                            bounded=self._bounded_dims)
        particles = self.migrate(particles)
        rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, E,
                                 periodic=self._periodic_dims)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)))

    def _gross_density(self, counts: torch.Tensor) -> float:
        """sum_s |q_s| * alive_s / volume: the yardstick of the
        neutrality guard (the species charges nearly cancel, so the f32
        noise floor of the mean is O(eps * gross density), not O(|rho|))."""
        return float(torch.sum(self.params.charge.abs().cpu()
                               * counts.cpu())) \
            / self.spec.global_volume + 1e-30

    def _assert_invariants(self, out: StepOutput, n: int,
                           max_vel: float) -> None:
        """methods:debug guards: pVelAssertMax (a CFL-like bound),
        pPosAssertInLocalFrame and gAssertNeutralGrid
        (src/population.c:316-365, src/grid.c:862-869); ERROR-exits in
        the reference, raises PincError here."""
        p = out.particles
        alive = p.alive
        if max_vel > 0.0 and bool(alive.any()):
            speed = float(p.vel.abs()[alive].max())
            if speed > max_vel:
                msg(ERROR, "step %d: particle speed %g exceeds "
                    "population:maxVel=%g", n, speed, max_vel)
        pos = p.pos()[alive]
        L = torch.tensor(self.spec.global_size, dtype=pos.dtype,
                         device=pos.device)
        if pos.numel() and (bool((pos < 0).any()) or bool((pos >= L).any())):
            msg(ERROR, "step %d: particle outside the domain "
                "(min %g, max %g)", n, float(pos.min()), float(pos.max()))
        if self.spec.periodic:
            mean = float(out.rho.double().mean())
            gross = self._gross_density(p.counts())
            if abs(mean) > 1e-4 * gross:
                msg(ERROR, "step %d: grid not charge-neutral (mean %g vs "
                    "gross charge density %g)", n, mean, gross)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------------- run
    def run(self, writer=None,
            progress_every: int = 10) -> Dict[str, np.ndarray]:
        """The regular() run mode: half-kick init (skipped on a resumed
        run, whose velocities are already staggered), the steps up to
        nTimeSteps, per-step energy history, the writer's (io_h5
        OutputWriter) callbacks, the methods:debug guards (with
        population:maxVel) and the checkpoints."""
        t_start = time.monotonic()
        ke_hist: List[np.ndarray] = []
        pe_hist: List[float] = []
        if self._resumed:
            particles = self.particles
        else:
            out = self._half_kick(self.particles)
            ke_hist.append(out.diag.kin_energy.cpu().numpy())
            pe_hist.append(float(out.diag.pot_energy))
            if writer is not None:
                writer.write_step(0, out)
                writer.write_energy(0, ke_hist[0], pe_hist[0])
            particles = out.particles
        debug = self.cfg.get_bool("methods:debug", False)
        max_vel = self.cfg.get_double("population:maxvel", 0.0)
        for n in range(self.start_step + 1, self.n_time_steps + 1):
            out = self._step(particles)
            particles = out.particles
            ke = out.diag.kin_energy.cpu().numpy()
            pe = float(out.diag.pot_energy)
            ke_hist.append(ke)
            pe_hist.append(pe)
            if writer is not None:
                writer.write_step(n, out)
                writer.write_energy(n, ke, pe)
            if debug:
                self._assert_invariants(out, n, max_vel)
            if self.checkpoint_every and n % self.checkpoint_every == 0:
                from . import checkpoint as _ckpt
                _ckpt.save(self.cfg, n, particles)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
        self._sync()
        wall = time.monotonic() - t_start
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.particles = particles
        if self.checkpoint_every:
            from . import checkpoint as _ckpt
            _ckpt.save(self.cfg, self.n_time_steps, particles)
        return {"kinetic": _stack(ke_hist, self.params.charge.shape[0]),
                "potential": np.asarray(pe_hist), "wall_time": wall}


# ---------------------------------------------------------------------------
# Run modes (reference: select of methods:mode, src/main.c:32-36)
# ---------------------------------------------------------------------------

def default_device() -> torch.device:
    """The CUDA card, where the port's entry points run unless the caller
    passes ``device="cpu"``.  Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is false): "
            "pinc_tpu_torch runs on the card; pass device=\"cpu\" to run "
            "the kernels' plain PyTorch versions on the CPU")
    return torch.device("cuda")


def _stack(ke_hist: List[np.ndarray], n_species: int) -> np.ndarray:
    """(steps, S) kinetic energies; (0, S) for a run with no step."""
    return (np.stack(ke_hist) if ke_hist
            else np.zeros((0, n_species), np.float32))


@RUN_MODES.register("regular")
def _regular_factory(cfg: PincConfig):
    def run(device=None):
        from .parallel.pic import make_simulation
        sim = make_simulation(cfg, device=device or default_device())
        writer = None
        if "files:output" in cfg:
            from .io_h5 import OutputWriter
            writer = OutputWriter(cfg, sim)
        try:
            hist = sim.run(writer=writer)
        finally:
            if writer is not None:
                writer.close()
        hist["sim"] = sim
        return hist
    return run


@RUN_MODES.register("mgMode")
def _mg_mode_factory(cfg: PincConfig):
    """Multigrid benchmark mode (mgMode, src/multigrid.c:1856-2014): fill a
    sinusoidal rho, time the solve to tolerance with CUDA events
    (``multigrid:nRepetitions`` solves, default 5, after one untimed), and
    write (runNumber, seconds) and (runNumber, cycles) to ``timer.xy.h5``
    when files:output is set."""
    def run(device=None):
        from .grid import fill_sin
        from .solvers.multigrid import make_from_config
        from .utils.timer import DeviceTimer
        check_single_device(cfg, "methods:mode=mgMode")
        device = device or default_device()
        alloc_and_normalize(cfg)
        spec = GridSpec.from_config(cfg)
        solver = make_from_config(cfg)
        rho_np, phi_exact = fill_sin(spec)
        rho = torch.as_tensor(rho_np, dtype=spec.dtype, device=device)
        solver.solve_with_stats(rho)                 # warm-up, untimed
        run_number = int(cfg.get_double("multigrid:runnumber", 0.0))
        reps = max(1, cfg.get_int("multigrid:nrepetitions", 5))
        t = DeviceTimer(device)
        t.start()
        for _ in range(reps):
            phi, n_cycles, resid = solver.solve_with_stats(rho)
        t.stop()
        seconds = t.total / 1e9 / reps
        phi_np = phi.cpu().numpy()
        err = np.sqrt(np.mean((phi_np - (phi_exact - phi_exact.mean())) ** 2))
        msg(STATUS, "mgMode: %.6f s/solve, %d cycles to tol (residual %g), "
            "rms error vs analytic %g", seconds, n_cycles, float(resid), err)
        t.msg()
        if "files:output" in cfg:
            from .io_h5 import XYFile
            timer_xy = XYFile(cfg, "timer")
            timer_xy.create("time")
            timer_xy.create("cycles")
            timer_xy.append("time", run_number, seconds)
            timer_xy.append("cycles", run_number, n_cycles)
            timer_xy.close()
        return {"seconds": seconds, "rms_error": float(err),
                "cycles": n_cycles}
    return run


@RUN_MODES.register("mgModeErrorScaling")
def _mg_error_scaling_factory(cfg: PincConfig):
    """Convergence-order study (mgModeErrorScaling,
    src/multigrid.c:1734-1851): solve the fixture (``multigrid:fixture``,
    default the sinusoid that suits the deck's BCs) at half and at the
    deck's resolution and report the measured order (expected ~2,
    script/framework/mgErrorScaling.py:64-66)."""
    def run(device=None):
        from .grid import FILL_FIXTURES
        from .solvers.multigrid import MultigridSolver
        check_single_device(cfg, "methods:mode=mgModeErrorScaling")
        device = device or default_device()
        alloc_and_normalize(cfg)
        spec = GridSpec.from_config(cfg)
        bc = BCSpec.from_config(cfg)
        periodic = bc.periodic
        fixture = cfg.get_str(
            "multigrid:fixture", "sin" if periodic else "sinDirichlet")
        fill = FILL_FIXTURES[fixture.lower()]
        errs, sizes = [], []
        for scale in (2, 1):
            shape = tuple(s // scale for s in spec.global_size)
            sub = GridSpec(n_dims=spec.n_dims, true_size=shape,
                           n_subdomains=(1,) * spec.n_dims,
                           boundaries=spec.boundaries, dtype=spec.dtype)
            rho_np, phi_exact = fill(sub)
            levels = min(cfg.get_int("multigrid:mglevels", 4),
                         max(1, min(shape).bit_length() - 2))
            mg = MultigridSolver(
                shape, n_levels=levels,
                n_pre=cfg.get_int("multigrid:npresmooth", 10),
                n_post=cfg.get_int("multigrid:npostsmooth", 10),
                n_coarse=cfg.get_int("multigrid:ncoarsesolve", 10),
                max_cycles=cfg.get_int("multigrid:mgcycles", 15),
                tol=1e-7, bc=None if periodic else bc, dtype=spec.dtype)
            phi = mg(torch.as_tensor(rho_np, dtype=spec.dtype,
                                     device=device)).cpu().numpy()
            if mg._has_nullspace:
                pe = phi_exact - phi_exact.mean()
                phi = phi - phi.mean()
            else:
                pe = phi_exact
            err = np.sqrt(np.mean((phi - pe) ** 2))
            err /= max(np.sqrt(np.mean(pe ** 2)), 1e-300)
            errs.append(err)
            sizes.append(shape)
            msg(STATUS, "errorScaling[%s]: %s -> rms rel error %g",
                fixture, shape, err)
        order = float(np.log2(errs[0] / errs[1]))
        msg(STATUS, "measured convergence order: %.2f (expect ~2)", order)
        return {"errors": errs, "sizes": sizes, "order": order,
                "fixture": fixture}
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
