"""Unit normalization schemes.

Re-implements the behavior of the reference's ``src/units.c``: all physical
quantities in the config are normalized *in place* before any compute, such
that afterwards the simulation works in units where

    dx = dt = eps0 = 1

(the scheme documented at ``src/core.h:279-391``).  Three schemes:

* ``SI``      — config values are in SI (``uSI``, src/units.c:191-231).
* ``semiSI``  — charge in elementary charges, mass in electron masses,
                timeStep in 1/omega_pe of species 0
                (``uSemiSI``, src/units.c:159-189).
* ``direct``  — the legacy dimensionless deck format used by the
                ``input/*.ini`` decks (``multiplicity = auto``, no density):
                charge/mass/velocities are already in simulation units;
                the superparticle weight is chosen so that
                omega_p(species 0) * dt equals ``time:timeStep``.

After ``normalize(cfg)``:

* ``population:charge``/``mass`` hold per-superparticle simulation values,
* ``population:density`` (if present) holds particles-per-cell,
* ``population:thermalVelocity``/``drift`` are in cells/step,
* ``population:perturbAmplitude`` is in cells,
* ``fields:BExt``/``EExt`` are in simulation units.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

from .config import PincConfig, global_volume, parse_indirect_input

ELEMENTARY_CHARGE = 1.60217733e-19   # [C]   (src/units.c:12)
ELECTRON_MASS = 9.10938188e-31       # [kg]  (src/units.c:13)
VACUUM_PERMITTIVITY = 8.854187817e-12  # [F/m] (src/units.c:14)
BOLTZMANN = 1.380658e-23             # [J/K]


@dataclass
class Units:
    """Characteristic scales in physical units (``Units``, src/core.h:392-417).

    Multiplying a simulation-unit quantity by the matching scale yields the
    physical (SI) value; derived scales follow ``uAddDerivedUnits``
    (src/units.c:233-252).
    """

    n_dims: int
    n_species: int
    weights: List[float]
    length: float = 1.0      # X = dx [m]
    time: float = 1.0        # T = dt [s]
    charge: float = 1.0      # Q = w0*|q0| [C]
    mass: float = 1.0        # M = T^2 Q^2 / (eps0 X^D) [kg]
    # derived
    hyper_area: float = field(init=False, default=1.0)
    hyper_volume: float = field(init=False, default=1.0)
    frequency: float = field(init=False, default=1.0)
    velocity: float = field(init=False, default=1.0)
    acceleration: float = field(init=False, default=1.0)
    density: float = field(init=False, default=1.0)
    charge_density: float = field(init=False, default=1.0)
    potential: float = field(init=False, default=1.0)
    e_field: float = field(init=False, default=1.0)
    b_field: float = field(init=False, default=1.0)
    energy: float = field(init=False, default=1.0)

    def __post_init__(self):
        D, X, T, Q, M = self.n_dims, self.length, self.time, self.charge, self.mass
        self.hyper_area = X ** (D - 1)
        self.hyper_volume = X ** D
        self.frequency = 1.0 / T
        self.velocity = X / T
        self.acceleration = X / T ** 2
        self.density = 1.0 / X ** D
        self.charge_density = Q / X ** D
        self.potential = (X / T) ** 2 * M / Q
        self.e_field = X * M / (T ** 2 * Q)
        self.b_field = M / (T * Q)
        self.energy = M * (X / T) ** 2


def _scheme(cfg: PincConfig) -> str:
    if "methods:normalization" in cfg:
        s = cfg.get_str("methods:normalization")
        if s not in ("SI", "semiSI"):
            raise ValueError("methods:normalization must be SI or semiSI")
        return s
    # Legacy decks (input/*.ini) have no normalization key and no density;
    # they are written directly in simulation units with multiplicity=auto.
    if "population:density" not in cfg:
        return "direct"
    return "semiSI"


def alloc_and_normalize(cfg: PincConfig) -> Units:
    """``uAlloc`` + ``uNormalize`` in one pass (the reference always calls
    them back to back, src/main.c:84-85).  Mutates ``cfg`` in place."""
    parse_indirect_input(cfg)
    scheme = _scheme(cfg)
    if scheme == "direct":
        units = _direct(cfg)
    else:
        if scheme == "semiSI":
            _semi_si_to_si(cfg)
        units = _si_units(cfg)
        _normalize_si(cfg, units)
    _common_normalize(cfg, units)
    return units


# ---------------------------------------------------------------- semiSI/SI

def _semi_si_to_si(cfg: PincConfig) -> None:
    """Convert a semiSI deck to SI in place (``uSemiSI``, src/units.c:159-189)."""
    ns = cfg.get_int("population:nspecies")
    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    density = cfg.get_double_arr("population:density", ns)
    dt = cfg.get_double("time:timestep")

    tol = 1e-10
    if abs(charge[0] + 1) > tol:
        raise ValueError("Species 0 must have charge -1 with semiSI normalization")
    if abs(mass[0] - 1) > tol:
        raise ValueError("Species 0 must have mass 1 with semiSI normalization")

    charge = [c * ELEMENTARY_CHARGE for c in charge]
    mass = [m * ELECTRON_MASS for m in mass]
    wpe = math.sqrt(ELEMENTARY_CHARGE ** 2 * density[0]
                    / (VACUUM_PERMITTIVITY * ELECTRON_MASS))
    dt /= wpe

    cfg.set_double_arr("population:charge", charge)
    cfg.set_double_arr("population:mass", mass)
    cfg.set_double("time:timestep", dt)


def _si_units(cfg: PincConfig) -> Units:
    """Characteristic scales from an SI deck (``uSI``, src/units.c:191-231)."""
    nd = cfg.get_int("grid:ndims")
    ns = cfg.get_int("population:nspecies")
    dt = cfg.get_double("time:timestep")
    step = cfg.get_double_arr("grid:stepsize", nd)
    n_particles = cfg.get_double_arr("population:nparticles", ns)
    density = cfg.get_double_arr("population:density", ns)
    charge = cfg.get_double_arr("population:charge", ns)

    V = global_volume(cfg) * step[0] ** nd
    weights = [density[s] * V / n_particles[s] for s in range(ns)]

    X = step[0]
    T = dt
    Q = weights[0] * abs(charge[0])
    M = (T * Q) ** 2 / (VACUUM_PERMITTIVITY * X ** nd)
    return Units(n_dims=nd, n_species=ns, weights=weights,
                 length=X, time=T, charge=Q, mass=M)


def _normalize_si(cfg: PincConfig, units: Units) -> None:
    """Superparticle scaling + normalization (``uNormalize``, src/units.c:78-120)."""
    ns = units.n_species
    w = units.weights
    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    density = cfg.get_double_arr("population:density", ns)
    charge = [charge[s] * w[s] / units.charge for s in range(ns)]
    mass = [mass[s] * w[s] / units.mass for s in range(ns)]
    density = [density[s] / w[s] / units.density for s in range(ns)]
    cfg.set_double_arr("population:charge", charge)
    cfg.set_double_arr("population:mass", mass)
    cfg.set_double_arr("population:density", density)


# ------------------------------------------------------------------ direct

def _direct(cfg: PincConfig) -> Units:
    """Legacy dimensionless decks: charge in units of a reference charge
    with species 0 = (-1, 1), timeStep = omega_p0*dt.  Choose the
    superparticle weight so the species-0 plasma frequency in simulation
    units equals timeStep:

        omega0^2 = (N0/V) * w * (q0^2/m0)   =>   w = tau^2 * V / N0
        (with |q0| = m0 = 1)
    """
    nd = cfg.get_int("grid:ndims")
    ns = cfg.get_int("population:nspecies")
    tau = cfg.get_double("time:timestep")
    charge = cfg.get_double_arr("population:charge", ns)
    mass = cfg.get_double_arr("population:mass", ns)
    n_particles = cfg.get_double_arr("population:nparticles", ns)
    V = float(global_volume(cfg))

    if abs(abs(charge[0]) - 1) > 1e-10 or abs(mass[0] - 1) > 1e-10:
        raise ValueError("Species 0 must have |charge|=1, mass=1 for the "
                         "legacy (direct) normalization")

    w = tau ** 2 * V * mass[0] / (n_particles[0] * charge[0] ** 2)
    cfg.set_double_arr("population:charge", [c * w for c in charge])
    cfg.set_double_arr("population:mass", [m * w for m in mass])
    # If temperature [K] is given instead of thermalVelocity, it cannot be
    # converted without an absolute scale; legacy decks use temperature=0 or
    # give thermalVelocity directly in cells/step.
    if "population:thermalvelocity" not in cfg and "population:temperature" in cfg:
        temp = cfg.get_double_arr("population:temperature", ns)
        if any(t != 0.0 for t in temp):
            raise ValueError("Nonzero population:temperature requires an SI "
                             "deck (use thermalVelocity for legacy decks)")
        cfg.set_double_arr("population:thermalvelocity", [0.0] * ns)
    return Units(n_dims=nd, n_species=ns, weights=[w] * ns)


# ------------------------------------------------------------------ common

def _common_normalize(cfg: PincConfig, units: Units) -> None:
    """The velocity/length/field entries normalized by every scheme
    (src/units.c:115-120).  In the direct scheme all scales are 1 so this
    is a no-op numerically."""
    for key, scale in (
        ("population:thermalvelocity", units.velocity),
        ("population:drift", units.velocity),
        ("population:perturbamplitude", units.length),
        ("fields:bext", units.b_field),
        ("fields:eext", units.e_field),
    ):
        if key in cfg and scale != 1.0:
            cfg.scale_double(key, 1.0 / scale)
