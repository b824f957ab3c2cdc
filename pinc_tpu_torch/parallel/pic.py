"""The sharded PIC step and the simulation factory (the counterpart of
``pinc_tpu/parallel/pic.py``).

Everything MPI in the reference (SURVEY.md §2) becomes the device mesh of
``parallel/mesh.py``: the deck's ``grid:nSubdomains`` decomposition is a
list of devices, grid halo exchanges are plane copies between shards
(``parallel/halo.py``), particle migration is a fixed-capacity neighbour
exchange (``parallel/migrate.py``), and the ``MPI_Allreduce`` energy sums
add the shards' values in mesh order.

The step (mirrors src/main.c:197-274):

    shard_map: move (unwrapped) -> reflect at walls -> migrate -> absorb
               into objects -> CIC deposit into a (+1)-padded local block
               -> fold_plus
    solve:     phi = solve(rho) on the shards (parallel/pencil_fft.py's
               dispatch), E = -grad(phi) on the gathered field, cut back;
               on an object deck first the absorbed charge spread into
               rho_obj, rho += rho_obj, solve, the capacitance correction
               on the gathered rho and phi, and the second solve
    shard_map: pad_plus ghost fetch -> CIC gather -> kick -> summed KE

Particles live in per-shard slabs: ``ShardedSimulation.particles`` is a
list of per-shard ``Particles`` (S, cap_local, D) holding global
(unwrapped during the exchange) cell coordinates.  The writer, the
``methods:debug`` guards and the checkpoints get the global fields and
particles, gathered from the shards (``gather_particles``), as
``pinc_tpu/utils/multihost.py:40-56`` fetches them.  Over several
processes (``utils/multihost.py``) a process holds its own shards' slabs
(None for the others): every process initializes the global population
(the same seeded numbers), keeps its shards' particles and drops the
rest; the fields and checkpoints are gathered on every process, and the
writer gets this process's slabs, which it writes to its own
``pop.p<idx>`` file.

Embedded objects (``pinc_tpu/parallel/pic.py:142-175``, ``:225-313``):
each shard kills the particles whose floor node is object interior after
its migration, and the absorbed charge per object is summed over the mesh
(``MeshCtx.psum``).  ``rho_obj``, the persistent surface charge, is one
global tensor on this process's first device, replicated on every
process as a replicated array is in JAX, as the writer and the
checkpoints take it.  As in ``pinc_tpu``, this path only absorbs: the
responses of ``objects:collisionType`` (reflect, backscatter, adhere,
secondary) act as absorb here (a WARNING says so), where the single-device
flat path and both tiled paths run them.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from ..config import PincConfig, required_np
from ..grid import GridSpec, potential_energy
from ..objects import _at
from ..ops import cic
from ..ops import pusher as pu
from ..population import Particles, SpeciesParams, capacity_of
from ..simulation import Diagnostics, Simulation, StepOutput
from ..utils import multihost as mh
from ..utils.logging import STATUS, WARNING, msg
from .halo import fold_plus, pad_plus
from .mesh import make_mesh, mesh_devices, subdomain_offset
from .migrate import migrate

# Above this many particle slots (capacity x species) the flat layout's
# working set is too large and the tiled layout is selected automatically
# when the deck does not pin methods:layout (the threshold of pinc_tpu).
AUTO_TILED_SLOTS = 24_000_000


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedSimulation(Simulation):
    """Simulation over a device mesh.  Same deck, same physics; the
    single-block Simulation is the nSubdomains = 1 case.  devices: the
    mesh's devices (make_mesh: None means the visible cards); domain:
    Simulation's in-memory object-id grid."""

    def __init__(self, cfg: PincConfig, seed: int = 1, devices=None,
                 domain: Optional[np.ndarray] = None):
        spec = GridSpec.from_config(cfg)
        ctx = make_mesh(spec.n_subdomains, spec.true_size, devices=devices)
        # the single-device set-up first (methods, units, the global
        # initial conditions, the object system) on this process's first
        # shard's device, then distributed
        super().__init__(cfg, seed=seed, device=ctx.devices[ctx.local[0]],
                         domain=domain)
        self.ctx = ctx
        cap_global = self.particles.capacity
        self.cap_local = _round_up(math.ceil(cap_global / ctx.n_devices), 8)
        k_default = max(64, self.cap_local // 8)
        self.migration_cap = min(
            cfg.get_int("parallel:migrationcap", k_default), self.cap_local)
        self._params = {dev: SpeciesParams(charge=self.params.charge.to(dev),
                                           mass=self.params.mass.to(dev))
                        for dev in ctx.distinct_devices()}
        self.particles = self._distribute(self.particles)
        from .pencil_fft import make_sharded_solver
        self._solve = make_sharded_solver(self.solver, ctx, cfg,
                                          self.spec.dtype)
        self._objs = object_copies(self)
        if self.objects is not None and self.objects.has_collisions:
            msg(WARNING, "grid:nSubdomains > 1 on the flat layout: the "
                "objects:collisionType responses %s act as absorb (as in "
                "pinc_tpu's sharded flat path; the tiled layout runs them)",
                sorted(set(self.objects.collision_types) - {"absorb"}))

    # ------------------------------------------------------------ placement
    def _distribute(self, p: Particles) -> List[Particles]:
        """Host side: partition the globally initialized population into
        per-shard slabs in mesh order (the reference's subdomain filtering
        in pPosUniform/pPosLattice, src/population.c:139-160); this
        process's shards only, None for the others."""
        ctx = self.ctx
        S, cap, D = p.cell.shape
        capL = self.cap_local
        cell = p.cell.cpu().numpy()
        frac = p.frac.cpu().numpy()
        vel = p.vel.cpu().numpy()
        alive = p.alive.cpu().numpy()
        t = np.asarray(ctx.true_size)
        nsub = np.asarray(ctx.n_subdomains)
        # linear shard index of each particle (mixed radix, last fastest)
        coords = cell // t
        lin = np.zeros((S, cap), dtype=np.int64)
        for d in range(D):
            lin = lin * nsub[d] + coords[..., d]
        out: List[Optional[Particles]] = [None] * ctx.n_devices
        for dev_i in ctx.local:
            dev = ctx.devices[dev_i]
            o_cell = np.zeros((S, capL, D), cell.dtype)
            o_frac = np.zeros((S, capL, D), frac.dtype)
            o_vel = np.zeros((S, capL, D), vel.dtype)
            o_alive = np.zeros((S, capL), bool)
            for s in range(S):
                sel = alive[s] & (lin[s] == dev_i)
                n = int(sel.sum())
                if n > capL:
                    raise ValueError(
                        f"species {s}: {n} particles for device {dev_i} "
                        f"exceed local capacity {capL}; raise "
                        "population:nAlloc")
                o_cell[s, :n] = cell[s][sel]
                o_frac[s, :n] = frac[s][sel]
                o_vel[s, :n] = vel[s][sel]
                o_alive[s, :n] = True
            out[dev_i] = Particles(*(torch.from_numpy(a).to(dev) for a in
                                     (o_cell, o_frac, o_vel, o_alive)))
        return out

    def gather_particles(self, parts: Optional[List[Particles]] = None
                         ) -> Particles:
        """The global (S, n_shards * cap_local, D) population, the shards'
        slabs in mesh order, on this process's first device (on every
        process)."""
        ctx = self.ctx
        parts = ctx.complete(self.particles if parts is None else parts)
        dev = ctx.devices[ctx.local[0]]
        return Particles(*(torch.cat([getattr(p, k).to(dev) for p in parts],
                                     dim=1)
                           for k in ("cell", "frac", "vel", "alive")))

    # ---------------------------------------------------------- local parts
    @staticmethod
    def _local_cells(p: Particles, offset) -> torch.Tensor:
        """Cells in the shard's frame; a dead slot's (it may hold an
        emigrant's old cell) reads node 0, which its zero charge or its
        unapplied kick leaves untouched (XLA drops or clamps such
        indices in pinc_tpu)."""
        off = torch.tensor(offset, dtype=p.cell.dtype, device=p.cell.device)
        return torch.where(p.alive[..., None], p.cell - off,
                           torch.zeros_like(p.cell))

    def _deposit_local(self, p: Particles, offset) -> torch.Tensor:
        """CIC deposit of the shard's slab into its (+1)-padded block, folded
        into the neighbours (fold_plus)."""
        ctx = self.ctx
        S, capL, D = p.cell.shape
        lcell = self._local_cells(p, offset).reshape(S * capL, D)
        frac = p.frac.reshape(S * capL, D)
        q = self._params[p.cell.device].charge[:, None].expand(S, capL)
        value = torch.where(p.alive, q, torch.zeros_like(q)).reshape(-1)
        padded = tuple(t + 1 for t in ctx.true_size)
        rho_pad = cic.scatter_cic(padded, lcell, frac, value, periodic=False,
                                  dtype=self.spec.dtype)
        return fold_plus(rho_pad, ctx, bounded=self._bounded_dims)

    def _local_absorb(self, p: Particles):
        """Per shard: kill the particles whose floor node is object interior
        (the particle half of oCollectObjectCharge, src/object.c:460-515);
        returns (particles, the absorbed charge per object summed over the
        mesh).  p.cell is in the global frame."""
        dev = p.cell.device
        obj = self._objs[dev]
        cell = torch.where(p.alive[..., None], p.cell,
                           torch.zeros_like(p.cell))
        oid = _at(obj.interior_id, cell.long())               # (S, capL)
        absorbed = p.alive & (oid > 0)
        q = self._params[dev].charge[:, None].expand(p.alive.shape)
        counter = obj.object_counter(torch.where(absorbed, oid, 0), q)
        return (Particles(cell=p.cell, frac=p.frac, vel=p.vel,
                          alive=p.alive & ~absorbed),
                self.ctx.psum(counter))

    def _local_deposit(self, p: Particles):
        """Per shard: move (unwrapped), reflect at walls, migrate, absorb
        into the objects, deposit with the halo fold."""
        ctx = self.ctx
        offset = subdomain_offset(ctx)
        p = pu.move(p, ctx.global_size, periodic=False)
        if not self.spec.periodic:
            # walls reflect before the migration, so no charge or particle
            # reaches the wrap planes of the periodic halo and migration
            # rings at those edges; the periodic dims of a mixed deck wrap
            p = pu.reflect(p, ctx.global_size, bounded=self._bounded_dims)
        p, lost = migrate(p, ctx, offset, self.migration_cap)
        counter = None
        if self.objects is not None:
            p, counter = self._local_absorb(p)
        return p, self._deposit_local(p, offset), lost, counter

    def _local_no_move(self, p: Particles):
        if self.objects is not None:
            # the initial cull: particles inside objects are removed with
            # their charge discarded (oCollectObjectCharge on a zeroed
            # rhoObj, src/main.c:161-166)
            p, _ = self._local_absorb(p)
        rho = self._deposit_local(p, subdomain_offset(self.ctx))
        return p, rho, torch.zeros((), dtype=torch.int32,
                                   device=p.cell.device), None

    def _local_kick(self, p: Particles, E_local: torch.Tensor,
                    half: bool):
        ctx = self.ctx
        E_pad = pad_plus(E_local, ctx, bounded=self._bounded_dims)
        if half:
            E_pad = 0.5 * E_pad
        lp = Particles(cell=self._local_cells(p, subdomain_offset(ctx)),
                       frac=p.frac, vel=p.vel, alive=p.alive)
        lp2, ke = self.acc(lp, self._params[p.cell.device], E_pad,
                           periodic=False, e_scale=0.5 if half else 1.0)
        out = Particles(cell=p.cell, frac=p.frac, vel=lp2.vel, alive=p.alive)
        return out, ctx.psum(ke)

    # ------------------------------------------------------------ the step
    def _sharded_pipeline(self, particles: List[Particles], do_move: bool,
                          half: bool, rho_obj=None) -> StepOutput:
        ctx = self.ctx
        dep = self._local_deposit if do_move else self._local_no_move
        res = ctx.shard_map(dep, particles)
        particles, rho = _column(res, 0), _column(res, 1)
        lost, counter = ctx.first(res)[2], ctx.first(res)[3]
        obj_phi = None
        if self.objects is not None and rho_obj is None:
            rho_obj = self._zeros()
        if self.objects is not None and do_move:
            rho_obj = self.objects._spread(rho_obj.reshape(-1).clone(),
                                           counter).reshape(rho_obj.shape)
            rho, phi, E, pe, obj_phi = solve_object_fields(self, rho,
                                                           rho_obj)
        else:
            phi, E, pe = solve_fields(self, rho)
        res = ctx.shard_map(partial(self._local_kick, half=half),
                            particles, E)
        particles = _column(res, 0)
        return StepOutput(particles, rho, phi, E, Diagnostics(
            kin_energy=ctx.first(res)[1], pot_energy=pe, n_lost=lost),
            rho_obj=rho_obj, obj_potential=obj_phi)

    def _half_kick(self, particles: List[Particles]) -> StepOutput:
        # no absorbed charge is kept and no capacitance applied before the
        # first solve (Simulation._half_kick's); rho_obj comes out zero
        return self._sharded_pipeline(particles, do_move=False, half=True)

    def _step(self, particles: List[Particles],
              rho_obj=None) -> StepOutput:
        return self._sharded_pipeline(particles, do_move=True, half=False,
                                      rho_obj=rho_obj)

    # the gathered global state for the writer, the guards and checkpoints
    def _output(self, out: StepOutput) -> StepOutput:
        """The global fields, and the global population; over several
        processes the shards' slab list instead, of which the writer
        writes this process's slabs (io_h5.OutputWriter._owned_rows)."""
        g = self.ctx.gather
        parts = (out.particles if self.ctx.world > 1
                 else self.gather_particles(out.particles))
        return StepOutput(parts, g(out.rho), g(out.phi), g(out.E),
                          out.diag, rho_obj=out.rho_obj,
                          obj_potential=out.obj_potential)

    def _assert_invariants(self, out: StepOutput, n: int,
                           max_vel: float) -> None:
        # the guards decide on the global population, the same on every
        # process
        if isinstance(out.particles, list):
            out = StepOutput(self.gather_particles(out.particles), out.rho,
                             out.phi, out.E, out.diag, rho_obj=out.rho_obj,
                             obj_potential=out.obj_potential)
        super()._assert_invariants(out, n, max_vel)

    def _global_particles(self, particles: List[Particles]) -> Particles:
        return self.gather_particles(particles)

    def _sync(self) -> None:
        self.ctx.synchronize()


def solve_fields(sim, rho: List[torch.Tensor]):
    """The sharded field solve of both sharded classes: phi on the shards
    (sim._solve), E = -grad(phi) (BC-aware on walled decks) on the
    gathered phi, once for each distinct device, cut into the shards, and
    the potential energy summed over the shards.  Returns (phi, E, pe)."""
    ctx = sim.ctx
    phi = sim._solve(rho)
    E = ctx.replicated(sim._efield, phi)
    pe = ctx.sum(ctx.map(potential_energy, rho, phi))
    return phi, E, pe


def solve_object_fields(sim, rho: List[torch.Tensor],
                        rho_obj: torch.Tensor):
    """The object deck's field solve of both sharded classes
    (src/main.c:222-240): rho += rho_obj (global, replicated on every
    process), solve on the shards, the capacitance correction on the
    gathered rho and phi (it reads phi at global surface nodes), cut back
    into the shards, then solve_fields.  Returns (rho, phi, E, pe, phi_c
    per object)."""
    ctx = sim.ctx
    rho_g = ctx.gather(rho) + rho_obj
    phi = sim._solve(ctx.split(rho_g))
    rho_g, obj_phi = sim.objects.apply_capacitance(rho_g, ctx.gather(phi))
    rho = ctx.split(rho_g)
    phi, E, pe = solve_fields(sim, rho)          # 2nd solve (main.c:240)
    return rho, phi, E, pe, obj_phi


def _column(res: list, k: int) -> list:
    """Item k of each shard's result tuple (None for another process's
    shards)."""
    return [None if r is None else r[k] for r in res]


def object_copies(sim) -> Optional[dict]:
    """{device: the object system with what a shard reads on that device},
    one for each distinct device of this process's shards; None without
    objects."""
    if sim.objects is None:
        return None
    return {dev: sim.objects.on(dev) for dev in sim.ctx.distinct_devices()}


def make_simulation(cfg: PincConfig, seed: int = 1, device=None,
                    domain=None, devices=None) -> Simulation:
    """Sharded when the deck asks for more than one subdomain (the mpinc.sh
    np decision, mpinc.sh:20-29), over ``devices`` (default: n times the
    CPU when ``device`` is the CPU, else the visible cards; too few raise
    ValueError); the tiled layout when methods:layout = tiled, or
    automatically for decks too big for the flat working set; plain
    single-block otherwise.  device: the CUDA card by default, or e.g.
    "cpu".  domain: an object-id grid in place of the file the deck names
    (Simulation's)."""
    np_needed = required_np(cfg)
    layout = cfg.get_str("methods:layout", "").lower()
    tiled = layout == "tiled"
    world = mh.process_count()
    if np_needed % world:
        raise ValueError(f"{world} processes do not divide the deck's "
                         f"{np_needed} shards (grid:nSubdomains)")
    if np_needed > 1:
        if devices is None and device is not None:
            devices = mesh_devices(device, np_needed)
        if tiled:
            from .tiled_pic import ShardedTiledSimulation
            return ShardedTiledSimulation(cfg, seed=seed, devices=devices,
                                          domain=domain)
        return ShardedSimulation(cfg, seed=seed, devices=devices,
                                 domain=domain)
    slots = capacity_of(cfg) * cfg.get_int("population:nspecies")
    if not layout and slots > AUTO_TILED_SLOTS:
        msg(STATUS, "auto-selected methods:layout=tiled (%d particle "
            "slots exceed the flat layout's working set); pin "
            "methods:layout=flat to override", slots)
        tiled = True
    if tiled:
        from ..tiled_sim import TiledSimulation
        return TiledSimulation(cfg, seed=seed, device=device, domain=domain)
    return Simulation(cfg, seed=seed, device=device, domain=domain)
