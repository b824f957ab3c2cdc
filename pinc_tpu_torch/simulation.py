"""The simulation: deck -> time step -> run modes (the counterpart of
``pinc_tpu/simulation.py``).

Equivalent of the reference's ``main.c``: method selection
(src/main.c:55-79), allocation (src/main.c:84-107), the leapfrog half-kick
initialization (src/main.c:141-186) and the production time loop
(src/main.c:197-274).  PyTorch runs eagerly, so the step is a plain method
on tensors that live on ``Simulation.device``.

Embedded objects (``objects.py``) run the reference's object sequence in
the step.  Decks with ``grid:nSubdomains`` > 1, object decks included, run
on the device mesh of ``parallel/`` (``parallel/pic.make_simulation``).
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
from .utils.timer import span
from .ops import pusher as _pusher_ops
from .solvers import spectral as _spectral      # noqa: F401 (registry)
from .solvers import multigrid as _multigrid    # noqa: F401 (registry)
from . import pumodes as _pumodes               # noqa: F401 (registry)


def check_supported(cfg: PincConfig) -> None:
    """The one place that raises for a deck feature of pinc_tpu the port
    cannot run yet.  Every feature is ported: it raises for none."""


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
    # the persistent object surface charge (None on decks without
    # objects): absorbed charge accumulated across steps, the reference's
    # rhoObj grid (src/main.c:222, object.c:460-515)
    rho_obj: Optional[torch.Tensor] = None
    # the equipotential value per object from the capacitance step (the
    # "Potential-check" STATUS, src/object.c:338)
    obj_potential: Optional[torch.Tensor] = None


class Simulation:
    """Owns the configuration, the static problem setup and the step on
    the flat layout.  Mirrors the lifetime of regular() in the reference.
    ``device`` is where every tensor of the run lives: the CUDA card by
    default, the CPU only when the caller passes ``device="cpu"``.
    ``domain``: an object-id grid (numpy) used in place of reading the
    ``.grid.h5`` file the deck names under ``objects:objects`` (which it
    must still name; ``objects.from_config``), for hosts without h5py.  A
    deviation from pinc_tpu that changes no result."""

    _DEFER_PARTICLES = False
    _TILED_CKPT = False        # TiledSimulation restores tiled checkpoints

    def __init__(self, cfg: PincConfig, seed: int = 1, device=None,
                 domain: Optional[np.ndarray] = None):
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

        from . import objects as _objects
        self.objects = _objects.from_config(cfg, self.spec, self.solver,
                                            device=self.device, domain=domain)
        self.rho_obj = self._zeros() if self.objects is not None else None
        self.last_rho_obj = self.last_obj_potential = None

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
                self.start_step, self.particles, rho_obj = _ckpt.load(
                    cfg, device=self.device)
                if rho_obj is not None:
                    self.rho_obj = rho_obj
                self._resumed = True

    # ----------------------------------------------------------------- step
    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.spec.global_size, dtype=self.spec.dtype,
                           device=self.device)

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
        """Initialization: cull the particles inside objects, solve the
        initial field and advance velocities a half step back
        (src/main.c:161-186: oCollectObjectCharge with a zeroed rhoObj,
        then gMul(E,0.5); acc; gMul(E,2))."""
        rho_obj = None
        if self.objects is not None:
            particles, _ = self.objects.collect_charge(
                particles, self.params, self._zeros())
            rho_obj = self._zeros()
        rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, 0.5 * E,
                                 periodic=self._periodic_dims, e_scale=0.5)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)), rho_obj=rho_obj)

    def _object_fields(self, rho: torch.Tensor, rho_obj: torch.Tensor):
        """rho += rho_obj, solve, the capacitance correction, solve again
        (src/main.c:222-240).  Returns (rho, phi, E, phi_c per object)."""
        rho = rho + rho_obj
        with span("pinc.solve"):
            phi = self.solver(rho)
        rho, obj_phi = self.objects.apply_capacitance(rho, phi)
        with span("pinc.solve"):
            phi = self.solver(rho)      # 2nd solve (src/main.c:240)
        return rho, phi, self._efield(phi), obj_phi

    def _step(self, particles: Particles,
              rho_obj: Optional[torch.Tensor] = None) -> StepOutput:
        """One full leapfrog step (src/main.c:197-274): move (and reflect
        at bounded walls), migrate, deposit, solve, E = -grad(phi), kick;
        on an object deck the object sequence between the migration and
        the kick: the collision responses, collect, deposit, rho +=
        rho_obj, solve, capacitance, solve (src/main.c:222-240)."""
        particles = _pusher_ops.move(particles, self.spec.global_size,
                                     periodic=self.spec.periodic)
        if not self.spec.periodic:
            # bounded walls reflect; the periodic dims of a mixed deck
            # wrap (move ran unwrapped)
            particles = _pusher_ops.reflect(particles, self.spec.global_size,
                                            bounded=self._bounded_dims)
        particles = self.migrate(particles)
        obj_phi = None
        if self.objects is not None:
            if rho_obj is None:
                rho_obj = self._zeros()
            if self.objects.has_collisions:
                # reflect/backscatter/adhere/secondary first; failures stay
                # interior and collect_charge absorbs them
                particles, rho_obj, _ = self.objects.collide(
                    particles, self.params, rho_obj)
            particles, rho_obj = self.objects.collect_charge(
                particles, self.params, rho_obj)
            rho = self.distr(particles, self.params, self.spec.global_size,
                             periodic=self._periodic_dims,
                             dtype=self.spec.dtype)
            rho, phi, E, obj_phi = self._object_fields(rho, rho_obj)
        else:
            rho, phi, E = self._fields_from_particles(particles)
        particles, ke = self.acc(particles, self.params, E,
                                 periodic=self._periodic_dims)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32)),
            rho_obj=rho_obj, obj_potential=obj_phi)

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
        if self.spec.periodic and self.objects is None:
            mean = float(out.rho.double().mean())
            gross = self._gross_density(p.counts())
            if abs(mean) > 1e-4 * gross:
                msg(ERROR, "step %d: grid not charge-neutral (mean %g vs "
                    "gross charge density %g)", n, mean, gross)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _output(self, out: StepOutput) -> StepOutput:
        """The step's output as the writer and the debug guards read it
        (the sharded class gathers its shards)."""
        return out

    def _global_particles(self, particles: Particles) -> Particles:
        """The particles as a checkpoint holds them."""
        return particles

    # ---------------------------------------------------------------- scan
    def make_scan_steps(self, n: int):
        """An n-step window without output: returns run_n((particles,
        rho_obj=None)) -> ((particles, rho_obj), (ke (n, S), pe (n,))),
        every number left on the device (pinc_tpu's lax.scan of _step,
        for benchmarking and IO-free runs).  The input particles are not
        modified."""
        def run_n(particles, rho_obj=None):
            kes, pes = [], []
            for _ in range(n):
                out = self._step(particles, rho_obj)
                particles, rho_obj = out.particles, out.rho_obj
                kes.append(out.diag.kin_energy)
                pes.append(out.diag.pot_energy)
            return (particles, rho_obj), (torch.stack(kes),
                                          torch.stack(pes))
        return run_n

    # ----------------------------------------------------------------- run
    def run(self, writer=None,
            progress_every: int = 10) -> Dict[str, np.ndarray]:
        """The regular() run mode: half-kick init (skipped on a resumed
        run, whose velocities are already staggered), the steps up to
        nTimeSteps, per-step energy history, the writer's (io_h5
        OutputWriter) callbacks, the methods:debug guards (with
        population:maxVel) and the checkpoints.  On an object deck the
        persistent rho_obj rides from step to step, every progress line is
        followed by each object's "Potential-check", and the run leaves
        last_rho_obj and last_obj_potential (numpy) behind."""
        t_start = time.monotonic()
        ke_hist: List[np.ndarray] = []
        pe_hist: List[float] = []
        out = None
        if self._resumed:
            particles = self.particles
            rho_obj = self.rho_obj
        else:
            out = self._half_kick(self.particles)
            ke_hist.append(out.diag.kin_energy.cpu().numpy())
            pe_hist.append(float(out.diag.pot_energy))
            if writer is not None:
                writer.write_step(0, self._output(out))
                writer.write_energy(0, ke_hist[0], pe_hist[0])
            particles = out.particles
            rho_obj = out.rho_obj
        debug = self.cfg.get_bool("methods:debug", False)
        max_vel = self.cfg.get_double("population:maxvel", 0.0)
        for n in range(self.start_step + 1, self.n_time_steps + 1):
            out = self._step(particles, rho_obj)
            particles, rho_obj = out.particles, out.rho_obj
            ke = out.diag.kin_energy.cpu().numpy()
            pe = float(out.diag.pot_energy)
            ke_hist.append(ke)
            pe_hist.append(pe)
            if writer is not None:
                writer.write_step(n, self._output(out))
                writer.write_energy(n, ke, pe)
            if debug:
                self._assert_invariants(self._output(out), n, max_vel)
            if self.checkpoint_every and n % self.checkpoint_every == 0:
                from . import checkpoint as _ckpt
                _ckpt.save(self.cfg, n, self._global_particles(particles),
                           rho_obj)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
                if out.obj_potential is not None:
                    # the reference's "Potential-check" (src/object.c:338)
                    for a, pc in enumerate(out.obj_potential.cpu().numpy()):
                        msg(STATUS, "Potential-check for object %d : %f",
                            a, pc)
        self._sync()
        wall = time.monotonic() - t_start
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.particles, self.rho_obj = particles, rho_obj
        self.last_rho_obj = (None if rho_obj is None
                             else rho_obj.cpu().numpy())
        self.last_obj_potential = (
            None if out is None or out.obj_potential is None
            else out.obj_potential.cpu().numpy())
        if self.checkpoint_every:
            from . import checkpoint as _ckpt
            _ckpt.save(self.cfg, self.n_time_steps,
                       self._global_particles(particles), rho_obj)
        return {"kinetic": _stack(ke_hist, self.params.charge.shape[0]),
                "potential": np.asarray(pe_hist), "wall_time": wall}


# ---------------------------------------------------------------------------
# Run modes (reference: select of methods:mode, src/main.c:32-36)
# ---------------------------------------------------------------------------

def default_device() -> torch.device:
    """The CUDA card, where the port's entry points run unless the caller
    passes ``device="cpu"`` (under a launcher the card of ``LOCAL_RANK``,
    ``multihost.local_device``).  Raises when there is no card."""
    from .utils.multihost import local_device
    return local_device()


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
        device = device or default_device()
        alloc_and_normalize(cfg)
        spec = GridSpec.from_config(cfg)
        solver = make_from_config(cfg)
        ctx = None
        if any(n > 1 for n in spec.n_subdomains):
            # decomposed deck: the sharded solver on the device mesh, as
            # the reference's mgMode runs on the decomposed grid
            # (src/multigrid.c:1856-2014)
            ctx, solver = _sharded_mg(cfg, spec, solver, spec.true_size,
                                      device)
            msg(STATUS, "mgMode: sharded solver on %s mesh, %d levels",
                ctx.n_subdomains, solver.n_levels)
        rho_np, phi_exact = fill_sin(spec)
        rho = torch.as_tensor(rho_np, dtype=spec.dtype, device=device)
        if ctx is not None:
            rho = ctx.split(rho)
        solver.solve_with_stats(rho)                 # warm-up, untimed
        run_number = int(cfg.get_double("multigrid:runnumber", 0.0))
        reps = max(1, cfg.get_int("multigrid:nrepetitions", 5))
        t = DeviceTimer(device)
        t.start()
        for _ in range(reps):
            phi, n_cycles, resid = solver.solve_with_stats(rho)
        t.stop()
        seconds = t.total / 1e9 / reps
        phi_np = (phi if ctx is None else ctx.gather(phi)).cpu().numpy()
        err = np.sqrt(np.mean((phi_np - (phi_exact - phi_exact.mean())) ** 2))
        msg(STATUS, "mgMode: %.6f s/solve, %d cycles to tol (residual %g), "
            "rms error vs analytic %g", seconds, n_cycles, float(resid), err)
        t.msg()
        from .utils.multihost import is_primary
        if "files:output" in cfg and is_primary():
            # the timer file is the primary's (pinc_tpu/simulation.py:436)
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
            if any(n > 1 for n in spec.n_subdomains):
                # both resolutions on the decomposed grid, like the
                # reference's study (src/multigrid.c:1734-1851): every
                # study resolution must decompose evenly (the
                # mgAllocSubGrids constraint, src/multigrid.c:317-329)
                bad = [d for d, (s, n) in enumerate(
                    zip(shape, spec.n_subdomains)) if s % n]
                if bad:
                    raise ValueError(
                        f"mgModeErrorScaling: scaled grid {shape} is not "
                        f"divisible by grid:nSubdomains="
                        f"{spec.n_subdomains} along dims {bad} — every "
                        f"study resolution must decompose evenly (the "
                        f"mgAllocSubGrids constraint, src/multigrid.c:"
                        f"317-329); pick trueSize divisible by "
                        f"2*nSubdomains")
                local = tuple(s // n for s, n
                              in zip(shape, spec.n_subdomains))
                ctx, mg_sh = _sharded_mg(cfg, spec, mg, local, device)
                rho = torch.as_tensor(rho_np, dtype=spec.dtype, device=device)
                phi = ctx.gather(mg_sh(ctx.split(rho))).cpu().numpy()
            else:
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


def _sharded_mg(cfg: PincConfig, spec: GridSpec, solver, local, device):
    """(mesh, the sharded multigrid of ``solver``) for a decomposed deck's
    run mode on ``device`` (a CPU run meshes n CPU devices, a card run the
    visible cards)."""
    from .parallel.mesh import make_mesh, mesh_devices
    from .parallel.mg import from_single
    ctx = make_mesh(spec.n_subdomains, local, devices=mesh_devices(
        device, int(np.prod(spec.n_subdomains))))
    return ctx, from_single(solver, ctx, cfg, spec.dtype)


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
