"""Particle population: storage and initial conditions (the counterpart of
``pinc_tpu/population.py``).

Each species owns a fixed-capacity slab of a stacked tensor:

    cell : int32  (nSpecies, cap, nDims)   integer cell index
    frac : float  (nSpecies, cap, nDims)   offset within the cell, in [0,1)
    vel  : float  (nSpecies, cap, nDims)   velocity, cells/step
    alive: bool   (nSpecies, cap)          slot occupancy mask

Host initial conditions are the numpy code of ``pinc_tpu`` line for line,
so both packages start from bit-identical particles.  Device initial
conditions draw velocities from a seeded ``torch.Generator`` on the
simulation's device: their statistics match ``pinc_tpu``'s device init,
their bits do not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .config import PincConfig
from .grid import GridSpec


@dataclass
class SpeciesParams:
    """Per-superparticle charge/mass in simulation units, post-normalization
    (what pAlloc reads after uNormalize, src/population.c:42-92)."""
    charge: torch.Tensor  # (S,)
    mass: torch.Tensor    # (S,)


@dataclass
class Particles:
    cell: torch.Tensor   # (S, cap, D) int32
    frac: torch.Tensor   # (S, cap, D) float
    vel: torch.Tensor    # (S, cap, D) float
    alive: torch.Tensor  # (S, cap) bool

    @property
    def n_species(self) -> int:
        return self.cell.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell.shape[1]

    @property
    def n_dims(self) -> int:
        return self.cell.shape[2]

    def counts(self) -> torch.Tensor:
        return self.alive.sum(dim=1)


# ---------------------------------------------------------------------------
# Host-side initial conditions (numpy, identical to pinc_tpu)
# ---------------------------------------------------------------------------

def _split_pos(pos: np.ndarray, L: np.ndarray, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Wrap periodically and split float64 positions into (cell, frac)."""
    pos = np.mod(pos, L)
    cell = np.floor(pos).astype(np.int64)
    frac = pos - cell
    # guard against frac == 1.0 from rounding
    bump = frac >= 1.0
    cell = cell + bump
    frac = np.where(bump, 0.0, frac)
    cell = np.mod(cell, L.astype(np.int64))
    return cell.astype(np.int32), frac.astype(dtype)


def _lattice_positions(n: int, L: np.ndarray) -> np.ndarray:
    """Evenly spaced lattice: particle i at mixed-radix unfolding of i*l
    where l = (V/N)^(1/D) (pPosLattice, src/population.c:172-240)."""
    nd = len(L)
    V = float(np.prod(L))
    step = (V / n) ** (1.0 / nd)
    linear = step * np.arange(n, dtype=np.float64)
    pos = np.empty((n, nd), dtype=np.float64)
    for d in range(nd):
        pos[:, d] = np.mod(linear, L[d])
        linear = linear / L[d]
    return pos


def _uniform_positions(n: int, L: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Uniform over the global domain (pPosUniform, src/population.c:110-170)."""
    return rng.uniform(0.0, 1.0, size=(n, len(L))) * L


def _perturb(pos: np.ndarray, amplitude: np.ndarray, mode: np.ndarray,
             L: np.ndarray) -> np.ndarray:
    """x_d += A_d * cos(2 pi m_d x_d / L_d)  (pPosPerturb,
    src/population.c:242-276)."""
    theta = 2.0 * np.pi * mode * pos / L
    return pos + amplitude * np.cos(theta)


def _species_table(cfg: PincConfig, nd: int):
    """The per-species deck values every initializer reads."""
    ns = cfg.get_int("population:nspecies")
    n_particles = [int(v) for v in cfg.get_double_arr("population:nparticles", ns)]
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")
    n_alloc = [int(v) for v in cfg.get_double_arr(n_alloc_key, ns)]
    cap = max(max(n_alloc), max(n_particles))
    vth = (cfg.get_double_arr("population:thermalvelocity", ns)
           if "population:thermalvelocity" in cfg else [0.0] * ns)
    drift = (cfg.get_double_arr("population:drift", ns)
             if "population:drift" in cfg else [0.0] * ns)
    pert_amp = np.zeros((ns, nd))
    pert_mode = np.zeros((ns, nd))
    if "population:perturbamplitude" in cfg:
        pert_amp = np.asarray(cfg.get_double_arr(
            "population:perturbamplitude", ns * nd)).reshape(ns, nd)
    if "population:perturbmode" in cfg:
        pert_mode = np.asarray(cfg.get_double_arr(
            "population:perturbmode", ns * nd)).reshape(ns, nd)
    return ns, n_particles, cap, vth, drift, pert_amp, pert_mode


def species_params_of(cfg: PincConfig, spec: GridSpec,
                      device="cpu") -> SpeciesParams:
    """Just the per-species charge/mass table (no particle arrays)."""
    ns = cfg.get_int("population:nspecies")
    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    return SpeciesParams(
        charge=torch.tensor(charge, dtype=spec.dtype, device=device),
        mass=torch.tensor(mass, dtype=spec.dtype, device=device))


def initialize(cfg: PincConfig, spec: GridSpec, seed: int = 1,
               device="cpu") -> Tuple[Particles, SpeciesParams]:
    """Build the initial population per the deck on the host (numpy, the
    reference's regular() IC sequence, src/main.c:141-160) and move it to
    ``device``.  Identical to ``pinc_tpu.population.initialize``."""
    nd = spec.n_dims
    ns, n_particles, cap, vth, drift, pert_amp, pert_mode = \
        _species_table(cfg, nd)
    vth = np.asarray(vth)
    drift = np.asarray(drift)

    L = np.asarray(spec.global_size, dtype=np.float64)
    rng = np.random.default_rng(seed)
    ic_pos = cfg.get_str("population:icpositions", "lattice").lower()
    dtype = spec.np_dtype

    cells = np.zeros((ns, cap, nd), dtype=np.int32)
    fracs = np.zeros((ns, cap, nd), dtype=dtype)
    vels = np.zeros((ns, cap, nd), dtype=dtype)
    alive = np.zeros((ns, cap), dtype=bool)

    for s in range(ns):
        n = n_particles[s]
        if n > cap:
            raise ValueError(f"species {s}: nParticles {n} exceeds capacity {cap}")
        if ic_pos == "lattice":
            pos = _lattice_positions(n, L)
        elif ic_pos == "uniform":
            pos = _uniform_positions(n, L, rng)
        else:
            raise ValueError(f"unknown icPositions '{ic_pos}'")
        if np.any(pert_amp[s] != 0.0):
            pos = _perturb(pos, pert_amp[s], pert_mode[s], L)
        cell, frac = _split_pos(pos, L, dtype)
        cells[s, :n] = cell
        fracs[s, :n] = frac
        if vth[s] != 0.0:
            vels[s, :n] = rng.normal(drift[s], vth[s], size=(n, nd))
        elif drift[s] != 0.0:
            vels[s, :n] = drift[s]
        alive[s, :n] = True

    particles = Particles(cell=torch.from_numpy(cells).to(device),
                          frac=torch.from_numpy(fracs).to(device),
                          vel=torch.from_numpy(vels).to(device),
                          alive=torch.from_numpy(alive).to(device))
    return particles, species_params_of(cfg, spec, device)


# ---------------------------------------------------------------------------
# Device-side initial conditions: production-scale populations are built on
# the simulation's device instead of in host numpy.
# ---------------------------------------------------------------------------

def device_species(cfg: PincConfig, spec: GridSpec, seed: int, s: int,
                   parts: str = "all", device="cpu"):
    """Device ICs for ONE species: (cell, frac, vel, alive), each (cap, D)
    / (cap,).  Exactly nParticles/V particles per cell on a golden-ratio
    sub-lattice (as ``pinc_tpu``), Maxwellian velocities from a
    ``torch.Generator`` seeded by (seed, species), so the per-species and
    the stacked initializers agree.  parts='pos' skips the velocities,
    'vel' the positions (skipped outputs are None)."""
    nd = spec.n_dims
    ns, n_particles, cap, vth, drift, pert_amp, pert_mode = \
        _species_table(cfg, nd)
    L = spec.global_size
    V = spec.global_volume
    dtype = spec.dtype
    n = n_particles[s]
    if n % V != 0:
        raise ValueError(
            f"device init needs nParticles per species divisible by the "
            f"cell count (got {n} over {V} cells); use 'pc' units")
    ppc = n // V
    alive = torch.arange(cap, device=device) < n
    if parts != "pos":
        if vth[s] != 0.0:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed) * 1_000_003 + s)
            vel = torch.randn((cap, nd), generator=gen, dtype=dtype,
                              device=device)
            vel = drift[s] + vth[s] * vel
        else:
            vel = torch.full((cap, nd), float(drift[s]), dtype=dtype,
                             device=device)
        vel = torch.where(alive[:, None], vel, torch.zeros((), dtype=dtype,
                                                            device=device))
        if parts == "vel":
            return None, None, vel, alive
    else:
        vel = None
    idx = torch.arange(cap, dtype=torch.int64, device=device)
    cell_lin = idx // ppc                 # exact integer cell index
    slot = idx % ppc
    del idx
    # unravel cell_lin -> (cap, D), last dim fastest (C order)
    cols = []
    rem = cell_lin
    for d in range(nd - 1, -1, -1):
        cols.append((rem % L[d]).to(torch.int32))
        rem = rem // L[d]
    del rem, cell_lin
    cell = torch.stack(cols[::-1], dim=-1)
    del cols
    # sub-lattice offsets within the cell: golden-ratio sequence per dim
    slotf = slot.to(dtype) + 0.5 + 0.1 * s
    del slot
    golden = [0.6180339887, 0.7548776662, 0.8191725134][:nd]
    frac = torch.stack([torch.remainder(slotf * g, 1.0) for g in golden],
                       dim=-1)
    del slotf
    if np.any(pert_amp[s] != 0.0):
        Lt = torch.tensor(L, dtype=dtype, device=device)
        pos = cell.to(dtype) + frac
        theta = (2.0 * np.pi) * torch.tensor(pert_mode[s], dtype=dtype,
                                             device=device) * pos / Lt
        pos = pos + torch.tensor(pert_amp[s], dtype=dtype,
                                 device=device) * torch.cos(theta)
        pos = torch.remainder(pos, Lt)
        cellf = torch.floor(pos)
        frac = pos - cellf
        cell = cellf.to(torch.int32)
    return cell, frac, vel, alive


def initialize_device(cfg: PincConfig, spec: GridSpec, seed: int = 1,
                      device="cpu") -> Tuple[Particles, SpeciesParams]:
    """Device initialization of every species (see device_species)."""
    ns = cfg.get_int("population:nspecies")
    parts = [device_species(cfg, spec, seed, s, device=device)
             for s in range(ns)]
    particles = Particles(cell=torch.stack([p[0] for p in parts]),
                          frac=torch.stack([p[1] for p in parts]),
                          vel=torch.stack([p[2] for p in parts]),
                          alive=torch.stack([p[3] for p in parts]))
    return particles, species_params_of(cfg, spec, device)


DEVICE_INIT_THRESHOLD = 4_000_000


def wants_device_init(cfg: PincConfig) -> bool:
    """True when initialize_auto would take the device path."""
    ns = cfg.get_int("population:nspecies")
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")
    cap = max(int(v) for v in cfg.get_double_arr(n_alloc_key, ns))
    if cfg.get_bool("population:icdevice", False):
        return True
    return ("population:icdevice" not in cfg
            and cap > DEVICE_INIT_THRESHOLD
            and cfg.get_str("population:icpositions", "lattice") == "lattice")


def capacity_of(cfg: PincConfig) -> int:
    """Largest per-species slot capacity the deck asks for.  Suffix-aware:
    callable both before normalization (raw '128 pc' strings) and after
    (parse_indirect_input has already multiplied the values in place)."""
    from .config import global_volume
    ns = cfg.get_int("population:nspecies")
    n_alloc_key = ("population:nalloc" if "population:nalloc" in cfg
                   else "population:nparticles")

    def expanded(key):
        vals = cfg.get_double_arr(key, ns)
        if "pc" in cfg.get_str(key):
            V = global_volume(cfg)
            return [v * V for v in vals]
        return vals

    n_alloc = [int(v) for v in expanded(n_alloc_key)]
    n_part = [int(v) for v in expanded("population:nparticles")]
    return max(max(n_alloc), max(n_part))


def initialize_auto(cfg: PincConfig, spec: GridSpec, seed: int = 1,
                    device="cpu") -> Tuple[Particles, SpeciesParams]:
    """Host init (exact reference lattice semantics) for small populations;
    device init beyond DEVICE_INIT_THRESHOLD particles or when
    ``population:icDevice`` is set (falling back to host init when the
    population does not divide over the cells, as ``pinc_tpu`` does)."""
    if wants_device_init(cfg):
        try:
            return initialize_device(cfg, spec, seed, device=device)
        except ValueError:
            pass
    return initialize(cfg, spec, seed, device=device)
