"""Embedded conducting objects by the capacitance-matrix method (Miyake &
Usui 2009), the counterpart of ``pinc_tpu/objects.py``.

Reference behavior (``src/object.c``):

* The object *domain* is a grid of float object ids (0 = vacuum, a+1 =
  object a) read from a ``.grid.h5`` file (``oOpenH5``/``oReadH5``,
  src/object.c:721-756).
* Interior nodes: id > 0.5 (``oFillLookupTables``, src/object.c:111-160).
* Surface nodes: nodes whose 2^D octant stencil {x-d, d in {0,1}^D}
  holds some but not all nodes of the object (``oFindObjectSurfaceNodes``,
  src/object.c:368-456).
* Capacitance matrix: for every surface node a unit charge, a Poisson
  solve, phi read at every surface node; the dense matrix inverted
  (``oComputeCapacitanceMatrix``, src/object.c:163-298).
* Per step (``oApplyCapacitanceMatrix``, src/object.c:301-364, eqs. 5/7):
      phi_c   = sum_ij C_ji phi_j / sum_ij C_ij
      rho_s  += C^T (phi_c - phi_s)
  then the field is solved again with the corrected rho.
* Absorbed charge: particles whose floor node is interior are removed and
  their charge spread uniformly over the object's surface nodes of the
  persistent ``rho_obj`` (``oCollectObjectCharge``, src/object.c:460-515).

The geometry (interior, surface, normals, the generators and the grid
file) is numpy, copied from ``pinc_tpu``.  The rest is plain PyTorch on the
tensors of ``ObjectSystem.device``, as it is plain ``jnp`` in ``pinc_tpu``
(no Pallas kernel there, no CUDA kernel here):

* On all-periodic grids A[k, i] = G((r_k - r_i) mod L): one solve of a
  unit charge gives the whole matrix.  Other grids solve unit charges in
  batches of 16; the multigrid solves a batch together, each charge
  stopping at its own cycle (``MultigridSolver.solve_batch_with_stats``),
  as ``jax.vmap`` over ``pinc_tpu``'s ``lax.while_loop`` does.  A is
  inverted in float64 on the host with numpy.
* ``apply_capacitance``: a gather of phi at the surface, a dot product and
  ``torch.mv`` (a matrix-vector product, which runs in float32: TF32 only
  applies to matrix-matrix products), an ``index_add_`` into rho.
* Collisions: bisection of the segment [pos - vel, pos] for the surface
  crossing, then the per-species response (``COLLISION_TYPES``).
* Per-object charge counters are masked sums (one reduction an object),
  where ``pinc_tpu`` takes a ``segment_sum``: the same sums in another
  order.
"""

from __future__ import annotations

import copy
import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import PincConfig
from .population import Particles, SpeciesParams
from .utils.logging import STATUS, msg
from .utils.timer import span


def find_interior(domain: np.ndarray, n_objects: int) -> np.ndarray:
    """Interior node mask per object: id == a+1 (val > 0.5 rounding,
    src/object.c:132-137).  domain: (*L,) float or int ids."""
    ids = np.rint(domain).astype(np.int32)
    return np.stack([(ids == a + 1) for a in range(n_objects)])


def find_surface(domain: np.ndarray, n_objects: int) -> np.ndarray:
    """Surface mask per object: the 2^D octant stencil {x - d, d in {0,1}^D}
    holds some but not all object-a nodes (src/object.c:380-407).
    Shifted reads beyond the edge count as vacuum (the reference reads
    zero-valued ghost nodes there)."""
    ids = np.rint(domain).astype(np.int32)
    D = domain.ndim
    out = []
    for a in range(n_objects):
        m = (ids == a + 1)
        d = np.zeros(domain.shape, dtype=np.int32)
        for offs in itertools.product((0, 1), repeat=D):
            shifted = m
            for ax, o in enumerate(offs):
                if o:
                    # read m at index - 1 along ax, zero beyond the edge
                    pad = np.zeros_like(shifted[(slice(None),) * ax
                                                + (slice(0, 1),)])
                    shifted = np.concatenate(
                        [pad, np.take(shifted, range(0, domain.shape[ax] - 1),
                                      axis=ax)], axis=ax)
            d = d + shifted
        out.append((d > 0) & (d < 2 ** D))
    return np.stack(out)


def surface_normals(interior_any: np.ndarray) -> np.ndarray:
    """Outward unit normal field on the grid: -grad of the box-smoothed
    interior indicator, normalized (zero where degenerate): one dense
    (*L, D) field, sampled at the crossing cell of each colliding particle
    (the reference's per-particle normal, src/object.c:623-633, was never
    finished)."""
    D = interior_any.ndim
    f = interior_any.astype(np.float64)
    sm = np.zeros_like(f)
    for offs in itertools.product((-1, 0, 1), repeat=D):
        sm += np.roll(f, offs, axis=tuple(range(D)))
    sm /= 3.0 ** D
    grad = np.stack(np.gradient(sm), axis=-1)
    n = -grad
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(norm > 1e-9, n / np.maximum(norm, 1e-9),
                    0.0).astype(np.float32)


#: collision responses, per species (``objects:collisionType``); 'absorb'
#: is the charge-collecting kill (the reference's only working behavior);
#: the others are the machinery the reference stubbed (pReflect,
#: pBackscatter, pAdhere, pSecondaryElectron, src/population.c:468-495):
#: * reflect   — specular, v' = v - 2 (v.n) n at the surface crossing.
#: * backscatter — v' = -v, back along the incoming path.
#: * adhere    — kill at the trajectory-surface crossing, the particle's
#:               charge on the nearest *surface* node (localized, unlike
#:               absorb's uniform spread).
#: * secondary — absorb the impactor (charge collected as usual) and emit
#:               ``objects:seeYield`` secondaries of species
#:               ``objects:seeSpecies`` from the crossing, in
#:               cosine-distributed directions about the outward normal at
#:               speed ``objects:seeVth``; the emitted charge is debited
#:               from the object's surface, so total charge is conserved.
COLLISION_TYPES = ("absorb", "reflect", "backscatter", "adhere", "secondary")

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64 and a constant
    c < 2^32: the product is split at 16 bits of c, so no partial product
    leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def u32_bits(v: torch.Tensor) -> torch.Tensor:
    """The bits of float32 ``v`` as uint32 values held in int64
    (``lax.bitcast_convert_type(v, uint32)``)."""
    return (v.float().contiguous().view(torch.int32).to(torch.int64)
            & _MASK32)


def _hash_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Stateless uint32 -> float32 in [0, 1) (xorshift-multiply mix),
    ``pinc_tpu``'s bit for bit.  bits: uint32 values held in an integer
    tensor (int64; taken mod 2^32).  Used for emission angles: decorrelated
    across steps by mixing the impactor's velocity bits, with no generator
    state threaded through the step."""
    x = bits.to(torch.int64) & _MASK32
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def cosine_directions(n: torch.Tensor, u1: torch.Tensor,
                      u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere directions about unit normals ``n``
    (..., D).  For D != 3 the normal itself."""
    D = n.shape[-1]
    if D != 3:
        return n
    st = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    ct = torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
    ph = (2.0 * np.pi) * u2
    # tangent frame: the axis least aligned with n
    z = n.new_tensor([0.0, 0.0, 1.0])
    x = n.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(torch.abs(n[..., 2:3]) < 0.9, z, x)
    t1 = _cross(a, n)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=1e-9)
    t2 = _cross(n, t1)
    return (ct[..., None] * n
            + (st * torch.cos(ph))[..., None] * t1
            + (st * torch.sin(ph))[..., None] * t2)


def _cell_of(x: torch.Tensor, L) -> torch.Tensor:
    """The wrapped, clipped cell (..., D) int64 of positions x."""
    with span("pinc.sync.cell_of"):
        Lf = torch.tensor(L, dtype=x.dtype, device=x.device)
        Li = torch.tensor(L, dtype=torch.int64, device=x.device)
    c = torch.floor(torch.remainder(x, Lf)).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), Li - 1)


def _at(grid: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """grid[cell] for cells (..., D): the grid's values (and trailing
    axes) at each cell."""
    return grid[tuple(cell.unbind(-1))]


def intersect_segments(pos: torch.Tensor, vel: torch.Tensor,
                       interior_id: torch.Tensor, normals: torch.Tensor, L,
                       n_bisect: int = 10):
    """Bisection for the surface crossing of [pos - vel, pos] (the
    reference's intended oFindIntersectPoint, src/object.c:638-660).
    Returns (t, x_int, n): the crossing parameter (just outside the
    surface), the crossing point, and the outward unit normal sampled at
    its cell."""
    prev = pos - vel
    # bisection on t in [0, 1]: prev (t = 0) outside, pos (t = 1) inside
    lo = torch.zeros(pos.shape[:-1], dtype=pos.dtype, device=pos.device)
    hi = torch.ones_like(lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        inside = _at(interior_id, _cell_of(prev + mid[..., None] * vel,
                                           L)) > 0
        lo = torch.where(inside, lo, mid)
        hi = torch.where(inside, mid, hi)
    t = lo                                      # just outside the surface
    x_int = prev + t[..., None] * vel
    n = _at(normals, _cell_of(x_int, L))        # (..., D)
    return t, x_int, n


def collide_segments(pos: torch.Tensor, vel: torch.Tensor, hit: torch.Tensor,
                     interior_id: torch.Tensor, normals: torch.Tensor,
                     L, method: str, n_bisect: int = 10):
    """Trajectory-surface collision for particles whose move landed inside
    an object (``hit``): the crossing of [pos - vel, pos] by bisection,
    then the response:

    * ``reflect``: v' = v - 2 (v.n) n at the crossing; the rest of the
      travel (1 - t) continues along v' (energy conserving).
    * ``backscatter``: v' = -v, retracing the incoming path.

    pos/vel: (..., D) global coordinates (pos after the move).  Returns
    (pos', vel', failed): ``failed`` marks hits the response could not push
    back outside (corner starts, tangential normals); the caller absorbs
    them, the reference's default."""
    Lf = torch.tensor(L, dtype=pos.dtype, device=pos.device)
    t, x_int, n = intersect_segments(pos, vel, interior_id, normals, L,
                                     n_bisect=n_bisect)
    if method == "reflect":
        vn = torch.sum(vel * n, dim=-1, keepdim=True)
        v_new = vel - 2.0 * vn * n
    elif method == "backscatter":
        v_new = -vel
    else:
        raise ValueError(f"unknown collision response {method!r}")
    pos_new = x_int + (1.0 - t)[..., None] * v_new
    failed = hit & (_at(interior_id, _cell_of(pos_new, L)) > 0)
    ok = hit & ~failed
    pos_out = torch.where(ok[..., None], torch.remainder(pos_new, Lf), pos)
    vel_out = torch.where(ok[..., None], v_new, vel)
    return pos_out, vel_out, failed


@dataclass
class ObjectSystem:
    """The static object data on ``device`` and the operators of a step."""

    domain: np.ndarray                  # (*L,) object ids
    n_objects: int
    interior_id: torch.Tensor           # (*L,) int32: 0 vacuum, a+1 object a
    surface_idx: List[np.ndarray]       # per object: flat indices (Ns_a,)
    inv_cap: List[torch.Tensor]         # per object: (Ns_a, Ns_a) C = A^-1
    cap_sum: List[float]                # per object: 1 / sum(C)
    shape: Tuple[int, ...]
    normals: Optional[torch.Tensor] = None       # (*L, D) outward normals
    collision_types: Tuple[str, ...] = ()        # per species response
    surface_id: Optional[torch.Tensor] = None    # (*L,) int32 (adhere)
    see_yield: int = 1                  # secondaries per impact
    see_vth: float = 0.05               # secondary emission speed
    see_species: int = 0                # species index of secondaries
    periodic: bool = True               # deck boundary wrap (all dims)
    device: torch.device = torch.device("cpu")
    # host seconds of the set-up's parts (solves, building A, inversion)
    # and each batch's multigrid cycle counts on bounded decks
    setup: dict = field(default_factory=dict)

    def __post_init__(self):
        # device copies of the surface lists, and sum_j C[i, j] (the
        # row sums of eq. 7's numerator, from the float64 inverse)
        self._surf = [torch.as_tensor(i, dtype=torch.int64,
                                      device=self.device)
                      for i in self.surface_idx]
        self._cap_rowsum = [c.double().sum(dim=1).float()
                            for c in self.inv_cap]

    @property
    def has_collisions(self) -> bool:
        return any(m != "absorb" for m in self.collision_types)

    def on(self, device) -> "ObjectSystem":
        """This system with the grids a shard reads per particle
        (interior_id, normals, surface_id) on ``device``: itself where they
        are there already, else a shallow copy (the surface lists and the
        capacitance matrices, which only the global fields read, stay on
        this system's device)."""
        device = torch.device(device)
        if device == self.device:
            return self
        other = copy.copy(self)
        other.device = device
        for name in ("interior_id", "normals", "surface_id"):
            t = getattr(self, name)
            setattr(other, name, None if t is None else t.to(device))
        return other

    # ------------------------------------------------------------- factory
    @classmethod
    def build(cls, domain: np.ndarray, solver, dtype=torch.float32,
              periodic: bool = True, batch: int = 16,
              collision_types: Sequence[str] = (),
              see_yield: int = 1, see_vth: float = 0.05,
              see_species: int = 0, device="cpu") -> "ObjectSystem":
        device = torch.device(device)
        shape = domain.shape
        ids = np.rint(domain).astype(np.int32)
        n_objects = int(ids.max())
        if n_objects < 1:
            raise ValueError("object domain grid contains no object ids")
        collision_types = tuple(collision_types)
        for m in collision_types:
            if m not in COLLISION_TYPES:
                raise ValueError(
                    f"objects:collisionType {m!r} not in {COLLISION_TYPES}")
        interior = find_interior(domain, n_objects)
        surface = find_surface(domain, n_objects)

        interior_id = np.zeros(shape, np.int32)
        for a in range(n_objects):
            interior_id[interior[a]] = a + 1

        with span("pinc.setup.objects"):
            setup = {"solve_s": 0.0, "matrix_s": 0.0, "invert_s": 0.0,
                     "cycles": []}
            surface_idx, inv_cap, cap_sum = [], [], []
            for a in range(n_objects):
                idx = np.flatnonzero(surface[a].ravel())
                ns = len(idx)
                msg(STATUS, "object %d: %d interior nodes, %d surface nodes",
                    a, int(interior[a].sum()), ns)
                if ns == 0:
                    raise ValueError(f"object {a} has no surface nodes")
                A = cls._potential_matrix(idx, shape, solver, dtype, periodic,
                                          batch, device=device, setup=setup)
                t0 = time.monotonic()
                C = np.linalg.inv(A.astype(np.float64))
                setup["invert_s"] += time.monotonic() - t0
                surface_idx.append(idx)
                inv_cap.append(torch.as_tensor(C.astype(np.float32),
                                               device=device))
                cap_sum.append(1.0 / float(C.sum()))
        norm = (torch.as_tensor(surface_normals(interior_id > 0),
                                device=device)
                if any(m != "absorb" for m in collision_types) else None)
        sid = None
        if "adhere" in collision_types:
            sid_np = np.zeros(shape, np.int32)
            for a in range(n_objects):
                sid_np[surface[a]] = a + 1
            sid = torch.as_tensor(sid_np, device=device)
        return cls(domain=domain, n_objects=n_objects,
                   interior_id=torch.as_tensor(interior_id, device=device),
                   surface_idx=surface_idx, inv_cap=inv_cap,
                   cap_sum=cap_sum, shape=tuple(shape),
                   normals=norm, collision_types=collision_types,
                   surface_id=sid, see_yield=int(see_yield),
                   see_vth=float(see_vth), see_species=int(see_species),
                   periodic=bool(periodic), device=device, setup=setup)

    @staticmethod
    def _potential_matrix(idx: np.ndarray, shape, solver, dtype,
                          periodic: bool, batch: int, device="cpu",
                          setup: Optional[dict] = None) -> np.ndarray:
        """A[k, i] = phi(surface_k) from a unit charge at surface_i (the
        N_surface solves of oComputeCapacitanceMatrix,
        src/object.c:227-260), float64 on the host.  setup, when given,
        gathers the solves' and the matrix's host seconds (after a device
        synchronize) and each batch's cycle counts (bounded decks, where
        the solver reports them)."""
        setup = {} if setup is None else setup
        setup.setdefault("solve_s", 0.0)
        setup.setdefault("matrix_s", 0.0)
        setup.setdefault("cycles", [])
        device = torch.device(device)
        ns = len(idx)
        V = int(np.prod(shape))

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        if periodic:
            # translation invariance: one Green's-function solve
            t0 = time.monotonic()
            delta = torch.zeros(V, dtype=dtype, device=device)
            delta[0] = 1.0
            G = solver(delta.reshape(shape)).double().cpu().numpy().ravel()
            t1 = time.monotonic()
            L = np.asarray(shape)
            coords = np.stack(np.unravel_index(idx, shape), axis=-1)  # (ns, D)
            rel = (coords[:, None, :] - coords[None, :, :]) % L       # (k,i,D)
            flat = np.ravel_multi_index(
                tuple(rel[..., d] for d in range(len(shape))), shape)
            A = G[flat]
            setup["solve_s"] += t1 - t0
            setup["matrix_s"] += time.monotonic() - t1
            return A
        # general BCs: unit-charge solves in batches
        A = np.zeros((ns, ns), np.float64)
        solve_b = getattr(solver, "solve_batch_with_stats", None)
        idx_t = torch.as_tensor(idx, dtype=torch.int64, device=device)
        for start in range(0, ns, batch):
            chunk = idx_t[start:start + batch]
            n = len(chunk)
            t0 = time.monotonic()
            rhs = torch.zeros((n, V), dtype=dtype, device=device)
            rhs[torch.arange(n, device=device), chunk] = 1.0
            rhs = rhs.reshape((n,) + tuple(shape))
            if solve_b is not None:
                phi, cycles, _ = solve_b(rhs)
                setup["cycles"].append(cycles)
            else:
                phi = torch.stack([solver(r) for r in rhs])
            sync()
            t1 = time.monotonic()
            A[:, start:start + n] = (phi.reshape(n, -1)[:, idx_t].T
                                     .double().cpu().numpy())
            setup["solve_s"] += t1 - t0
            setup["matrix_s"] += time.monotonic() - t1
        return A

    # -------------------------------------------------------------- runtime
    def collide(self, p: Particles, params: SpeciesParams,
                rho_obj: Optional[torch.Tensor] = None):
        """The per-species collision response to particles whose move
        ended inside an object (the working version of
        oParticleCollision, src/object.c:611-665).  'absorb' species are
        untouched (collect_charge kills them next), as are response
        failures (counted).  Call after the move, before collect_charge.
        Returns (particles, rho_obj, n_failed); rho_obj changes under
        'adhere' (localized charge) and 'secondary' (the emitted charge's
        debit)."""
        S, cap, D = p.cell.shape
        L = self.shape
        cell, frac, vel, alive = p.cell, p.frac, p.vel, p.alive
        n_failed = torch.zeros((), dtype=torch.int32, device=cell.device)
        for s in range(S):
            m = (self.collision_types[s]
                 if s < len(self.collision_types) else "absorb")
            if m == "absorb":
                continue
            pos = cell[s].to(torch.float32) + frac[s]
            oid = _at(self.interior_id, cell[s].long())
            hit = alive[s] & (oid > 0)
            if m == "adhere":
                rho_obj, alive, failed = self._adhere(
                    s, pos, vel[s], hit, alive, params, rho_obj)
                n_failed = n_failed + failed.sum().to(torch.int32)
                continue
            if m == "secondary":
                # the impactor stays interior: collect_charge absorbs it
                # and books its charge; here only the secondaries
                (cell, frac, vel, alive, rho_obj,
                 failed) = self._emit_secondaries(
                    s, pos, vel, hit, cell, frac, alive, params, rho_obj,
                    oid=oid)
                n_failed = n_failed + failed.sum().to(torch.int32)
                continue
            pos2, vel2, failed = collide_segments(
                pos, vel[s], hit, self.interior_id, self.normals, L, m)
            c2 = torch.floor(pos2).to(cell.dtype)
            cell, frac, vel = cell.clone(), frac.clone(), vel.clone()
            cell[s] = torch.where(hit[..., None], c2, cell[s])
            frac[s] = torch.where(hit[..., None],
                                  (pos2 - c2).to(frac.dtype), frac[s])
            vel[s] = vel2
            n_failed = n_failed + failed.sum().to(torch.int32)
        return (Particles(cell=cell, frac=frac, vel=vel, alive=alive),
                rho_obj, n_failed)

    def _nearest_surface_flat(self, x_int: torch.Tensor) -> torch.Tensor:
        """Flat index of the surface node nearest the crossing point: the
        2^D corners of the crossing cell searched for surface nodes (one
        gather a corner), else the nearest corner."""
        Lf = torch.tensor(self.shape, dtype=x_int.dtype, device=x_int.device)
        Li = torch.tensor(self.shape, dtype=torch.int64, device=x_int.device)
        D = len(self.shape)
        strides = torch.tensor([int(np.prod(self.shape[d + 1:]))
                                for d in range(D)], dtype=torch.int64,
                               device=x_int.device)
        sid = self.surface_id.reshape(-1)
        # distances from the wrapped position (the crossing of a segment
        # over a periodic edge is unwrapped)
        xw = torch.remainder(x_int, Lf)
        base = torch.floor(xw).to(torch.int64)
        best_flat = best_d = None
        for offs in itertools.product((0, 1), repeat=D):
            o = torch.tensor(offs, dtype=torch.int64, device=x_int.device)
            c = torch.remainder(base + o, Li)
            flat = torch.sum(c * strides, dim=-1)
            on_surf = sid[flat] > 0
            d = torch.sum((xw - (base + o).to(x_int.dtype)) ** 2, dim=-1)
            d = torch.where(on_surf, d, d + 1e6)   # prefer surface corners
            if best_flat is None:
                best_flat, best_d = flat, d
            else:
                take = d < best_d
                best_flat = torch.where(take, flat, best_flat)
                best_d = torch.minimum(d, best_d)
        return best_flat

    def _interior_at(self, x: torch.Tensor) -> torch.Tensor:
        """interior_id > 0 at the (wrapped, clipped) cell of x."""
        return _at(self.interior_id, _cell_of(x, self.shape)) > 0

    def _adhere(self, s, pos, vel_s, hit, alive, params, rho_obj):
        """pAdhere (src/population.c:490-495, stubbed there): kill the
        impactor at its trajectory-surface crossing and add its charge to
        the nearest surface node of rho_obj.  Hits whose segment start was
        interior too (tunneling through thin geometry) have no crossing:
        counted failed and left to collect_charge's absorb."""
        if rho_obj is None:
            raise ValueError("adhere response requires rho_obj threading")
        failed = hit & self._interior_at(pos - vel_s)
        ok = hit & ~failed
        _, x_int, _ = intersect_segments(pos, vel_s, self.interior_id,
                                         self.normals, self.shape)
        flat_idx = self._nearest_surface_flat(x_int)
        q = torch.where(ok, params.charge[s],
                        torch.zeros((), dtype=params.charge.dtype,
                                    device=ok.device)).to(rho_obj.dtype)
        rho_obj = rho_obj.reshape(-1).clone().index_add_(
            0, flat_idx, q).reshape(self.shape)
        alive = alive.clone()
        alive[s] = alive[s] & ~ok
        return rho_obj, alive, failed

    def _spread(self, rho_flat: torch.Tensor,
                counter: torch.Tensor) -> torch.Tensor:
        """rho_flat (a flat copy) += counter[a] / Ns_a on object a's
        surface nodes, for every object."""
        for a in range(self.n_objects):
            share = (counter[a] / float(len(self.surface_idx[a]))).to(
                rho_flat.dtype)
            rho_flat.index_add_(0, self._surf[a],
                                share.expand(len(self.surface_idx[a])))
        return rho_flat

    def object_counter(self, oid: torch.Tensor,
                       value: torch.Tensor) -> torch.Tensor:
        """(n_objects,) sums of value where oid == a+1 (the per-object
        segment sums of pinc_tpu, one masked reduction an object)."""
        zero = torch.zeros((), dtype=value.dtype, device=value.device)
        return torch.stack([torch.where(oid == a + 1, value, zero).sum()
                            for a in range(self.n_objects)])

    def _emit_secondaries(self, s, pos, vel, hit, cell, frac, alive,
                          params, rho_obj, oid):
        """pSecondaryElectron (src/population.c:468-482, stubbed there):
        emit see_yield particles of species see_species from each
        impact's surface crossing, cosine-distributed about the outward
        normal at speed see_vth, into free (dead) slots of the target
        species, dead slots in slot order (a stable sort).  A secondary
        with no free slot is dropped, as a migration overflow is.  The
        emitted charge is debited from the object's surface (uniform
        spread through rho_obj): total charge is conserved."""
        tgt, Y = self.see_species, self.see_yield
        S, cap, D = cell.shape
        # no crossing when the segment start was interior too: counted
        # failed, nothing emitted; collect_charge absorbs the impactor
        failed = hit & self._interior_at(pos - vel[s])
        hit = hit & ~failed
        _, x_int, n = intersect_segments(pos, vel[s], self.interior_id,
                                         self.normals, self.shape)
        # emission point: just outside along the normal; wrapped on
        # periodic decks, clipped on bounded ones
        Lf = torch.tensor(self.shape, dtype=x_int.dtype, device=x_int.device)
        x_emit = x_int + 0.01 * n
        x_emit = (torch.remainder(x_emit, Lf) if self.periodic
                  else torch.minimum(torch.clamp(x_emit, min=0.0),
                                     Lf - 1e-3))
        bits = (torch.arange(cap, dtype=torch.int64, device=cell.device)
                ^ u32_bits(vel[s][..., 0]))
        # free slots of the target species, dead first (stable)
        order = torch.argsort(alive[tgt].to(torch.int8), stable=True)
        n_dead = cap - alive[tgt].sum()
        rank = torch.cumsum(hit.to(torch.int64), dim=0) - 1
        c_e = torch.floor(x_emit).to(cell.dtype)
        f_e = (x_emit - c_e).to(frac.dtype)
        # slot cap is the drop column: writes there are cut off
        pad = lambda a: torch.cat([a[tgt], a[tgt][:1]], dim=0)  # noqa: E731
        cell_t, frac_t, vel_t = pad(cell), pad(frac), pad(vel)
        alive_t = pad(alive)
        for k in range(Y):
            u1 = _hash_uniform(bits + (2 * k + 1))
            u2 = _hash_uniform(_mul32(bits, 0x9E3779B1) + k)
            v_e = (self.see_vth
                   * cosine_directions(n, u1, u2)).to(vel.dtype)
            grank = rank * Y + k
            ok = hit & (grank >= 0) & (grank < n_dead)
            slot = torch.where(ok, order[torch.clamp(grank, 0, cap - 1)],
                               torch.full_like(grank, cap))
            cell_t[slot] = torch.where(ok[:, None], c_e, cell_t[slot])
            frac_t[slot] = torch.where(ok[:, None], f_e, frac_t[slot])
            vel_t[slot] = torch.where(ok[:, None], v_e, vel_t[slot])
            alive_t[slot] = ok | alive_t[slot]
            if rho_obj is not None:
                # the emitted charge debited from the impacted object's
                # surface (uniform spread, as collect_charge books)
                dq = torch.where(ok, -params.charge[tgt],
                                 torch.zeros((), dtype=params.charge.dtype,
                                             device=ok.device))
                counter = self.object_counter(torch.where(ok, oid, 0), dq)
                rho_obj = self._spread(rho_obj.reshape(-1).clone(),
                                       counter).reshape(self.shape)
        cell, frac, vel, alive = (cell.clone(), frac.clone(), vel.clone(),
                                  alive.clone())
        cell[tgt], frac[tgt] = cell_t[:cap], frac_t[:cap]
        vel[tgt], alive[tgt] = vel_t[:cap], alive_t[:cap]
        return cell, frac, vel, alive, rho_obj, failed

    def collect_charge(self, p: Particles, params: SpeciesParams,
                       rho_obj: torch.Tensor
                       ) -> Tuple[Particles, torch.Tensor]:
        """oCollectObjectCharge (src/object.c:460-515): absorb particles
        whose floor node is interior; spread their charge uniformly over
        the object's surface nodes of the persistent rho_obj."""
        S, cap, D = p.cell.shape
        oid = _at(self.interior_id, p.cell.long())            # (S, cap)
        absorbed = p.alive & (oid > 0)
        q = params.charge[:, None].expand(S, cap)
        counter = self.object_counter(torch.where(absorbed, oid, 0), q)
        rho_flat = self._spread(rho_obj.reshape(-1).clone(), counter)
        alive = p.alive & ~absorbed
        return (Particles(cell=p.cell, frac=p.frac, vel=p.vel, alive=alive),
                rho_flat.reshape(self.shape))

    def apply_capacitance(self, rho: torch.Tensor, phi: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """oApplyCapacitanceMatrix (src/object.c:301-364): an
        equipotential surface by correcting rho on the surface nodes.
        Returns (rho corrected, phi_c per object)."""
        rho_flat = rho.reshape(-1).clone()
        phi_flat = phi.reshape(-1)
        phi_cs = []
        for a in range(self.n_objects):
            idx = self._surf[a]
            phi_s = phi_flat[idx].float()
            # eq. 7: the object's potential, sum_ij C_ij phi_i / sum(C)
            phi_c = torch.dot(self._cap_rowsum[a], phi_s) * self.cap_sum[a]
            # eq. 5: rho_i += sum_j C[j, i] dphi_j
            corr = torch.mv(self.inv_cap[a].T, phi_c - phi_s)
            rho_flat.index_add_(0, idx, corr.to(rho.dtype))
            phi_cs.append(phi_c)
        return rho_flat.reshape(self.shape), torch.stack(phi_cs)

    def object_charge(self, rho_obj: torch.Tensor) -> torch.Tensor:
        """Diagnostic: total collected charge per object."""
        flat = torch.as_tensor(rho_obj).reshape(-1).to(self.device)
        return torch.stack([flat[s].sum() for s in self._surf])


# ---------------------------------------------------------------------------
# Geometry IO + generators (the reference reads voxelized VTK meshes from
# script/ConstructGrid; spheres and boxes are generated analytically here
# and any grid loads from the same .grid.h5 layout).
# ---------------------------------------------------------------------------

def _h5py():
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py is required for HDF5 output") from None
    return h5py


def load_domain(path: str, n_dims: int) -> np.ndarray:
    """Read an object-id grid from a PINC-layout .grid.h5 (oReadH5)."""
    with _h5py().File(path, "r") as f:
        key = "n=0.0" if "n=0.0" in f else sorted(f.keys())[0]
        data = np.asarray(f[key])
    if data.ndim == n_dims + 1:          # trailing values axis
        data = data[..., 0]
    perm = tuple(range(n_dims - 1, -1, -1))
    return np.transpose(data, perm)      # file layout is dim-reversed


def save_domain(path: str, domain: np.ndarray) -> None:
    from pathlib import Path
    h5py = _h5py()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    perm = tuple(range(domain.ndim - 1, -1, -1))
    data = np.transpose(domain, perm)[..., None].astype(np.float64)
    with h5py.File(path, "w") as f:
        f.create_dataset("n=0.0", data=data)


def make_sphere(shape: Sequence[int], center: Sequence[float], radius: float,
                object_id: int = 1,
                domain: Optional[np.ndarray] = None) -> np.ndarray:
    """Voxelized sphere (ConstructGrid.py's, no VTK needed)."""
    domain = np.zeros(tuple(shape)) if domain is None else domain
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                        indexing="ij")
    r2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    domain[r2 <= radius ** 2] = object_id
    return domain


def make_box(shape: Sequence[int], lo: Sequence[int], hi: Sequence[int],
             object_id: int = 1,
             domain: Optional[np.ndarray] = None) -> np.ndarray:
    domain = np.zeros(tuple(shape)) if domain is None else domain
    sl = tuple(slice(int(a), int(b) + 1) for a, b in zip(lo, hi))
    domain[sl] = object_id
    return domain


def from_config(cfg: PincConfig, spec, solver, device="cpu",
                domain: Optional[np.ndarray] = None
                ) -> Optional[ObjectSystem]:
    """The object system of a deck that names an object grid, else None.
    The deck key is ``objects:objects`` (or the legacy ``files:objects``,
    reference bepiColombo.ini:46); entries that are not .h5 files are
    ignored like the reference's placeholder sphere.txt entries.
    domain: an object-id grid in memory, used in place of reading the file
    the deck names (the deck must still name one); a deviation from
    pinc_tpu, which always reads the file, for hosts without h5py.  It
    changes no result."""
    ns = cfg.get_int("population:nspecies", 0)
    if "objects:collisiontype" in cfg:
        ctypes = tuple(c.strip().lower()
                       for c in cfg.get_str_arr("objects:collisiontype", ns))
    else:
        ctypes = ("absorb",) * ns
    names = [n for key in ("objects:objects", "files:objects") if key in cfg
             for n in cfg.get_str_arr(key) if n.endswith(".h5")]
    if not names:
        if domain is not None:
            raise ValueError("domain= given, but the deck names no object "
                             "grid (objects:objects = <file>.h5)")
        return None
    name = names[0]
    if domain is None:
        domain = load_domain(name, spec.n_dims)
    else:
        domain = np.asarray(domain)
    if domain.shape != spec.global_size:
        raise ValueError(
            f"object grid {name} shape {domain.shape} != "
            f"deck global size {spec.global_size}")
    return ObjectSystem.build(
        domain, solver, dtype=spec.dtype, periodic=spec.periodic,
        collision_types=ctypes,
        see_yield=cfg.get_int("objects:seeyield", 1),
        see_vth=cfg.get_double("objects:seevth", 0.05),
        see_species=cfg.get_int("objects:seespecies", 0), device=device)
