"""Particle movers and accelerators (leapfrog / Boris) on the flat layout,
plus their registry bindings — the counterpart of ``pinc_tpu/ops/pusher.py``.

Reference: ``puMove`` (src/pusher.c:86-119), ``puAcc3D1[KE]`` /
``puAccND1[KE]`` (src/pusher.c:147-308), ``puAccND0[KE]``
(src/pusher.c:314-391), ``puBoris3D1[KE]`` (src/pusher.c:394-505).
Simulation units have dt = dx = 1, so the kick is ``v += (q/m) E`` and the
drift ``x += v``.  The KE variants accumulate the time-centered kinetic
energy ``0.5 m sum(v_old . v_new)`` like puAcc3D1KE (src/pusher.c:197-210).

The registry closures carry ``.order``, ``.boris`` and ``.E_ext``: the tiled
simulation routes its kernels on them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import PincConfig
from ..population import Particles, SpeciesParams
from ..registry import ACCELERATORS, DISTRIBUTORS, MIGRATORS
from . import cic


def move(p: Particles, L: Sequence[int], periodic: bool = True) -> Particles:
    """Leapfrog drift x += v with periodic wrap, in split (cell, frac)
    arithmetic (puMove + puPeriodic, src/pusher.c:86-141)."""
    frac = p.frac + p.vel
    carry = torch.floor(frac)
    frac = frac - carry
    cell = p.cell + carry.to(p.cell.dtype)
    if periodic:
        cell = torch.remainder(
            cell, torch.tensor(L, dtype=cell.dtype, device=cell.device))
    return Particles(cell=cell, frac=frac, vel=p.vel, alive=p.alive)


def reflect(p: Particles, L: Sequence[int],
            bounded: Optional[Sequence[bool]] = None) -> Particles:
    """Elastic specular reflection at non-periodic walls: the physical
    domain is [0, L-1] (node extent); positions fold back and the normal
    velocity flips on an odd number of bounces, however many one step
    makes.  (The reference declares pReflect but leaves it unimplemented,
    src/population.c:468-495.)  bounded: per-dim mask (default: all);
    mixed decks wrap their periodic dims."""
    dt, dev = p.frac.dtype, p.frac.device
    hi = torch.tensor([n - 1 for n in L], dtype=dt, device=dev)
    pos = p.cell.to(dt) + p.frac
    # fold into [0, 2*hi), then reflect the upper half
    period = 2.0 * hi
    pos_m = torch.remainder(pos, period)
    pos_r = torch.where(pos_m > hi, period - pos_m, pos_m)
    flip = torch.remainder(torch.floor(pos / hi).to(torch.int32), 2) != 0
    vel = torch.where(flip, -p.vel, p.vel)
    every = bounded is None or all(bounded)
    if not every:
        bmask = torch.tensor(list(bounded), device=dev)
        Lf = torch.tensor(list(L), dtype=dt, device=dev)
        pos_r = torch.where(bmask, pos_r, torch.remainder(pos, Lf))
        vel = torch.where(bmask, vel, p.vel)
    cell = torch.floor(pos_r).to(p.cell.dtype)
    frac = pos_r - cell.to(dt)
    cmax = [n - 2 for n in L] if every else [
        n - 2 if b else n - 1 for n, b in zip(L, bounded)]
    cell = torch.minimum(torch.clamp(cell, min=0), torch.tensor(
        cmax, dtype=cell.dtype, device=dev))
    at_wall = cell.to(dt) + frac > hi
    if not every:
        at_wall = at_wall & bmask
    frac = torch.where(at_wall, torch.ones_like(frac), frac)
    return Particles(cell=cell, frac=frac, vel=vel, alive=p.alive)


def _chunks(n: int, chunk: int):
    """Slices covering range(n) in pieces of ``chunk`` (one piece when
    chunk is 0 or >= n)."""
    if not chunk or n <= chunk:
        return [slice(0, n)]
    return [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _gathered_field(E: torch.Tensor, p: Particles, order: int,
                    periodic, chunk: int = 0) -> torch.Tensor:
    """Field at every slot, (S, cap[, C]); ``chunk`` bounds the corner
    intermediates to that many slots at a time."""
    gather = cic.gather_cic if order == 1 else cic.gather_ngp
    S, cap, D = p.cell.shape
    cell = p.cell.reshape(S * cap, D)
    frac = p.frac.reshape(S * cap, D)
    out = torch.cat([gather(E, cell[sl], frac[sl], periodic=periodic)
                     for sl in _chunks(S * cap, chunk)])
    return out.reshape((S, cap) + out.shape[1:])


def _kick(p: Particles, params: SpeciesParams, Ep: torch.Tensor,
          compute_ke: bool) -> Tuple[Particles, torch.Tensor]:
    """v += (q/m) Ep; optionally the time-centered KE per species."""
    qm = (params.charge / params.mass)[:, None, None]     # (S,1,1)
    dv = qm * Ep
    if compute_ke:
        v_dot = torch.sum(p.vel * (p.vel + dv), dim=-1)   # (S, cap)
        v_dot = torch.where(p.alive, v_dot, torch.zeros_like(v_dot))
        ke = 0.5 * params.mass * torch.sum(v_dot, dim=1)
    else:
        ke = torch.zeros((p.n_species,), dtype=p.vel.dtype,
                         device=p.vel.device)
    vel = p.vel + torch.where(p.alive[..., None], dv, torch.zeros_like(dv))
    return Particles(cell=p.cell, frac=p.frac, vel=vel, alive=p.alive), ke


def acc_leapfrog(p: Particles, params: SpeciesParams, E: torch.Tensor,
                 order: int = 1, compute_ke: bool = True, periodic=True,
                 E_ext: Optional[torch.Tensor] = None, e_scale: float = 1.0,
                 chunk: int = 0) -> Tuple[Particles, torch.Tensor]:
    """CIC/NGP gather + electrostatic kick (puAccND1KE / puAccND0KE).
    e_scale scales the external field with the initialization half kick
    (src/main.c:184-186)."""
    Ep = _gathered_field(E, p, order, periodic, chunk=chunk)
    if E_ext is not None:
        Ep = Ep + e_scale * E_ext.to(Ep.device, Ep.dtype)
    return _kick(p, params, Ep, compute_ke)


def acc_boris(p: Particles, params: SpeciesParams, E: torch.Tensor,
              B_ext: torch.Tensor, order: int = 1, compute_ke: bool = True,
              periodic=True, E_ext: Optional[torch.Tensor] = None,
              e_scale: float = 1.0,
              chunk: int = 0) -> Tuple[Particles, torch.Tensor]:
    """Boris rotation with a uniform external B (puBoris3D1[KE],
    src/pusher.c:394-505): half electric kick, rotation through
    T = (q/m) B/2 and S = 2T/(1+T^2), half electric kick."""
    Ep = _gathered_field(E, p, order, periodic, chunk=chunk)
    if E_ext is not None:
        Ep = Ep + e_scale * E_ext.to(Ep.device, Ep.dtype)
    qm = (params.charge / params.mass)[:, None, None]
    half = 0.5 * qm * Ep
    v_minus = p.vel + half
    T = qm * 0.5 * B_ext.to(Ep.device, Ep.dtype)         # (S,1,3)
    t2 = torch.sum(T * T, dim=-1, keepdim=True)
    S = 2.0 * T / (1.0 + t2)
    v_prime = v_minus + torch.linalg.cross(v_minus, T.expand_as(v_minus))
    v_plus = v_minus + torch.linalg.cross(v_prime, S.expand_as(v_prime))
    vel_new = v_plus + half
    if compute_ke:
        # the reference's convention (src/pusher.c:465-471): 0.5 m |v_plus|^2
        v2 = torch.sum(v_plus * v_plus, dim=-1)
        v2 = torch.where(p.alive, v2, torch.zeros_like(v2))
        ke = 0.5 * params.mass * torch.sum(v2, dim=1)
    else:
        ke = torch.zeros((p.n_species,), dtype=p.vel.dtype,
                         device=p.vel.device)
    vel = torch.where(p.alive[..., None], vel_new, p.vel)
    return Particles(cell=p.cell, frac=p.frac, vel=vel, alive=p.alive), ke


def deposit(p: Particles, params: SpeciesParams, shape: Sequence[int],
            order: int = 1, periodic=True, dtype=torch.float32,
            chunk: int = 0) -> torch.Tensor:
    """Charge density from all species (puDistr3D1/ND1/ND0): every alive
    superparticle deposits onto 2^D (CIC) or 1 (NGP) nodes.  chunk > 0
    scatters that many slots at a time into one rho."""
    S, cap, D = p.cell.shape
    q = params.charge[:, None].expand(S, cap)
    value = torch.where(p.alive, q, torch.zeros_like(q)).reshape(S * cap)
    cell = p.cell.reshape(S * cap, D)
    frac = p.frac.reshape(S * cap, D)
    scatter = cic.scatter_cic if order == 1 else cic.scatter_ngp
    rho = None
    for sl in _chunks(S * cap, chunk):
        r = scatter(shape, cell[sl], frac[sl], value[sl], periodic, dtype)
        rho = r if rho is None else rho + r
    return rho


# ---------------------------------------------------------------------------
# Registry bindings: the reference deck names (methods:acc / distr / migrate)
# ---------------------------------------------------------------------------

def _sanity(name: str, dims: int, order: int):
    """puSanity (src/pusher.c:1047-1087): tie method choice to nDims."""
    def check(cfg: PincConfig):
        nd = cfg.get_int("grid:ndims")
        if dims != 0 and nd != dims:
            raise ValueError(f"{name} only works with grid:nDims={dims}")
    return check


def _sweep_chunk(cfg: PincConfig) -> int:
    """population:sweepChunk — flat-layout particle-sweep chunk size in
    slots (0 = single shot).  Default: 8M-slot chunks once the population
    exceeds 16M slots, as in pinc_tpu."""
    if "population:sweepchunk" in cfg:
        return cfg.get_int("population:sweepchunk")
    from ..population import capacity_of
    slots = capacity_of(cfg) * cfg.get_int("population:nspecies")
    return 8_388_608 if slots > 16_777_216 else 0


def _make_acc(order: int, compute_ke: bool, boris: bool):
    def factory(cfg: PincConfig):
        nd = cfg.get_int("grid:ndims")
        chunk = _sweep_chunk(cfg)
        B = torch.tensor(cfg.get_double_arr("fields:bext", nd)
                         if "fields:bext" in cfg else [0.0] * nd)
        E_ext_arr = (torch.tensor(cfg.get_double_arr("fields:eext", nd))
                     if "fields:eext" in cfg else None)
        if E_ext_arr is not None and not bool(torch.any(E_ext_arr != 0.0)):
            E_ext_arr = None
        if boris:
            B3 = B.reshape(1, 1, -1)

            def acc(p, params, E, periodic=True, e_scale=1.0):
                return acc_boris(p, params, E, B3, order=order,
                                 compute_ke=compute_ke, periodic=periodic,
                                 E_ext=E_ext_arr, e_scale=e_scale,
                                 chunk=chunk)
        else:
            def acc(p, params, E, periodic=True, e_scale=1.0):
                return acc_leapfrog(p, params, E, order=order,
                                    compute_ke=compute_ke, periodic=periodic,
                                    E_ext=E_ext_arr, e_scale=e_scale,
                                    chunk=chunk)
        acc.order = order
        acc.boris = boris
        acc.E_ext = E_ext_arr
        return acc
    return factory


for _name, _dims, _order, _ke, _boris in [
    ("puAcc3D1", 3, 1, False, False), ("puAcc3D1KE", 3, 1, True, False),
    ("puAccND1", 0, 1, False, False), ("puAccND1KE", 0, 1, True, False),
    ("puAccND0", 0, 0, False, False), ("puAccND0KE", 0, 0, True, False),
    ("puBoris3D1", 3, 1, False, True), ("puBoris3D1KE", 3, 1, True, True),
]:
    ACCELERATORS.register(_name, _sanity(_name, _dims, _order))(
        _make_acc(_order, _ke, _boris))


def _make_distr(order: int):
    def factory(cfg: PincConfig):
        chunk = _sweep_chunk(cfg)

        def distr(p, params, shape, periodic=True, dtype=torch.float32):
            return deposit(p, params, shape, order=order,
                           periodic=periodic, dtype=dtype, chunk=chunk)
        distr.order = order
        return distr
    return factory


DISTRIBUTORS.register("puDistr3D1", _sanity("puDistr3D1", 3, 1))(_make_distr(1))
DISTRIBUTORS.register("puDistrND1")(_make_distr(1))
DISTRIBUTORS.register("puDistrND0")(_make_distr(0))
DISTRIBUTORS.register("puDistr3D1split", _sanity("puDistr3D1split", 3, 1))(_make_distr(1))


def _make_migrate():
    """On a single block, migration is subsumed by the periodic wrap inside
    move(); the registry keeps the reference names valid."""
    def factory(cfg: PincConfig):
        def migrate(p, mesh_ctx=None):
            return p
        return migrate
    return factory


MIGRATORS.register("puExtractEmigrants3D", _sanity("puExtractEmigrants3D", 3, 1))(_make_migrate())
MIGRATORS.register("puExtractEmigrantsND")(_make_migrate())
