"""The plain reference that decides ``correct``: one electrostatic PIC step
of a periodic 3-D deck in plain PyTorch, written from the deck and PINC's
equations, and the checks of a re-bucket and of an object's absorption.

It imports neither JAX, ``pinc_tpu`` nor ``pinc_tpu_torch``, and takes
nothing the program derived: the species' charges and masses come from the
deck (PINC's legacy "direct" normalization), the tile origins from the tile
edge and the grid, the object's interior and surface nodes from the object
grid the benchmark made.  It reads the program's state only to judge what
the program did with it.

Precision.  The stages take the number formats they round to:
``weight_dtype(deck)`` and ``state_dtype()`` are the deck's (float32
positions, velocities and fields; the deposit and gather weights and the
gathered field in ``tiles:mxuDtype``), with sums in float64; with
``"control"`` they are one step lower (fp8 e4m3 in place of bfloat16,
bfloat16 in place of float32), the control the comparison has to reject.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the number format one step below each that a deck states
LOWER = {torch.bfloat16: torch.float8_e4m3fn, torch.float32: torch.bfloat16}

_CHUNK_SLOTS = 1 << 22


# --------------------------------------------------------------- the deck
def species(deck: Dict[str, Dict[str, str]]) -> List[Dict[str, float]]:
    """Per species charge q, mass m and q/m in simulation units: PINC's
    direct normalization of a legacy deck (multiplicity auto, no density):
    the superparticle weight w = tau^2 V m_0 / (N_0 q_0^2) makes the
    species-0 plasma frequency times dt equal time:timeStep."""
    pop = deck["population"]
    ns = int(pop["nSpecies"])
    L = [int(v) for v in deck["grid"]["trueSize"].split(",")]
    V = float(math.prod(L))
    tau = float(deck["time"]["timeStep"])
    charge = _floats(pop["charge"], ns)
    mass = _floats(pop["mass"], ns)
    n0 = per_cell(pop["nParticles"]) * V
    w = tau ** 2 * V * mass[0] / (n0 * charge[0] ** 2)
    return [{"q": c * w, "m": m * w, "qm": c / m}
            for c, m in zip(charge, mass)]


def per_cell(text: str) -> float:
    """Particles per cell of a "<n> pc" entry."""
    n, unit = text.split()
    if unit != "pc":
        raise ValueError(f"expected '<n> pc', got {text!r}")
    return float(n)


def _floats(text: str, n: int) -> List[float]:
    vals = [float(v) for v in text.split(",")]
    return vals * n if len(vals) == 1 else vals


def weight_dtype(deck, prec: str = "ref") -> torch.dtype:
    dt = (torch.bfloat16 if deck["tiles"].get("mxuDtype", "f32").lower()
          in ("bf16", "bfloat16") else torch.float32)
    return LOWER[dt] if prec == "control" else dt


def state_dtype(prec: str = "ref") -> torch.dtype:
    return LOWER[torch.float32] if prec == "control" else torch.float32


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


# ------------------------------------------------------------------ tiles
def tile_grid(grid: Sequence[int], T: int) -> Tuple[int, int, int]:
    return tuple(g // T for g in grid)


def tile_origins(grid: Sequence[int], T: int, device) -> torch.Tensor:
    """(NT, 3) int64 origin node of each tile, x-major (tile id =
    (ix * nty + iy) * ntz + iz)."""
    nt = tile_grid(grid, T)
    ax = [torch.arange(n, device=device) * T for n in nt]
    mesh = torch.meshgrid(*ax, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def _chunks(NT: int, B: int):
    step = max(1, _CHUNK_SLOTS // max(B, 1))
    return [(t0, min(t0 + step, NT)) for t0 in range(0, NT, step)]


def _corners(x: torch.Tensor, T: int, m: Optional[int] = None):
    """The two CIC nodes of one float32 tile-local coordinate plane:
    [(floor + k, weight)], the weight 1 - |x - node| clamped at 0, in
    float32.  With a working margin m, a node outside [-m, T + m] of the
    slot's own tile weighs 0: the tiled layout's rule for a slot that has
    wandered past the margin since its last re-bucket (its deposit and its
    gather keep only the nodes inside; pinc_tpu's tiled_sim.py docstring,
    "out-of-margin particles deposit nothing until the next re-bucket")."""
    f = torch.floor(x)
    out = []
    for k in (0, 1):
        n = f + k
        w = torch.clamp(1.0 - (x - n).abs(), min=0.0)
        if m is not None:
            w = torch.where((n >= -m) & (n <= T + m), w, torch.zeros_like(w))
        out.append((n.long(), w))
    return out


def out_of_margin(lpos: torch.Tensor, alive: torch.Tensor, T: int,
                  m: int) -> int:
    """Alive slots of one species' planes (3, NT, B) outside [-m, T + m)
    on some axis: the count the tiled step reports for a margin m."""
    bad = ((lpos < -float(m)) | (lpos >= float(T + m))).any(dim=0)
    return int((bad & (alive > 0.5)).sum())


def scan_margins(M: int, cadences: Sequence[int], n: int, j: int,
                 schedule: bool = True) -> List[Tuple[int, int]]:
    """The working margins (mg, md) of each species at step j (1..n) of an
    n-step window whose species are all freshly re-bucketed at its start:
    mg for the gather at the positions the step takes in, md for the
    deposit at those it gives out.  Without the schedule, the layout
    margin M.  The schedule (pinc_tpu's _scan_sched, which the tiled
    layout runs on decks with M >= 2 and n a multiple of the fastest
    cadence Re): a fast species, k steps into its cadence R, has wandered
    at most k M / R cells, so md = ceil(k M / R) (at least 1) and mg =
    ceil((k - 1) M / R); a slow species takes, in the q-th fast window of
    its cycle, the bound at that window's end, ceil((q + 1) Re M / R).
    Steps past the last whole window take M."""
    Rs = [int(R) for R in cadences]
    Re, Ri = min(Rs), max(Rs)
    slow = any(R != Re for R in Rs)
    full = [(M, M)] * len(Rs)
    if not schedule or M < 2 or n % Re:
        return full
    if slow and Ri % Re == 0:
        done = n // Ri * Ri
        done += (n - done) // Re * Re
        jj = (j - 1) % Ri
    elif not slow:
        done = n // Re * Re
        jj = (j - 1) % Re
    else:
        return full
    if j > done:
        return full
    q, k = jj // Re, jj % Re + 1
    out = []
    for R in Rs:
        if R == Re:
            out.append((min(M, math.ceil((k - 1) * M / R)),
                        min(M, max(1, math.ceil(k * M / R)))))
        else:
            m = min(M, max(1, math.ceil((q + 1) * Re * M / R)))
            out.append((m, m))
    return out


# ------------------------------------------------------------- the stages
def deposit(lpos: torch.Tensor, alive: torch.Tensor, charges: Sequence[float],
            grid: Sequence[int], T: int, wdt: torch.dtype,
            margins: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Charge density on the global periodic grid, float64, from tile-local
    positions lpos (S, 3, NT, B) and alive (S, NT, B): CIC with the x weight
    times the charge and the (y, z) weight product each rounded to wdt (the
    deposit kernels' weights), summed in float64; margins[s], where given,
    species s's working margin (_corners)."""
    S, _, NT, B = lpos.shape
    dev = lpos.device
    L = torch.tensor(grid, device=dev)
    org = tile_origins(grid, T, dev)
    rho = torch.zeros(math.prod(grid), dtype=torch.float64, device=dev)
    for s in range(S):
        for t0, t1 in _chunks(NT, B):
            val = torch.where(alive[s, t0:t1] > 0.5,
                              torch.tensor(float(charges[s]), device=dev),
                              torch.zeros((), device=dev))
            o = org[t0:t1]
            m = None if margins is None else margins[s]
            nx, ny, nz = (_corners(lpos[s, d, t0:t1], T, m)
                          for d in range(3))
            for ia, wa in nx:
                wa = rounded(wa * val, wdt)
                ga = torch.remainder(ia + o[:, 0:1], L[0])
                for ib, wb in ny:
                    gb = torch.remainder(ib + o[:, 1:2], L[1])
                    for ic, wc in nz:
                        gc = torch.remainder(ic + o[:, 2:3], L[2])
                        w = wa * rounded(wb * wc, wdt)
                        idx = (ga * L[1] + gb) * L[2] + gc
                        rho.index_add_(0, idx.reshape(-1),
                                       w.reshape(-1).double())
    return rho.reshape(tuple(grid))


def _periodic_solve(rho: torch.Tensor, symbol) -> torch.Tensor:
    """grad^2 phi = -rho on the periodic grid by the FFT, -grad^2's symbol
    the sum over the axes of symbol(m, n) (m the wave numbers of an axis
    of n nodes), the mean mode zero; float64."""
    shape = rho.shape
    k2 = torch.zeros((), dtype=torch.float64, device=rho.device)
    for d, n in enumerate(shape):
        m = torch.fft.fftfreq(n, d=1.0 / n, device=rho.device,
                              dtype=torch.float64)
        if d == len(shape) - 1:
            m = m[: n // 2 + 1].abs()
        sh = [1] * len(shape)
        sh[d] = m.numel()
        k2 = k2 + symbol(m.reshape(sh), n)
    inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                      torch.zeros_like(k2))
    spec = torch.fft.rfftn(rho.double()) * inv
    return torch.fft.irfftn(spec, s=shape)


def solve(rho: torch.Tensor) -> torch.Tensor:
    """grad^2 phi = -rho on the periodic grid, continuum k^2 (PINC's
    sSolve), the mean mode zero; float64."""
    return _periodic_solve(rho, lambda m, n: ((2.0 * math.pi / n) * m) ** 2)


def solve_fd(rho: torch.Tensor) -> torch.Tensor:
    """grad^2 phi = -rho on the periodic grid for the 7-point stencil,
    exactly: its own symbol sum_d 4 sin^2(pi m_d / n_d), the mean mode
    zero; float64.  The equation PINC's mgSolver iterates toward (its
    smoother's update phi = (sum of the neighbours + rho) / 2D, its
    residual rho + the stencil's Laplacian)."""
    return _periodic_solve(
        rho, lambda m, n: 4.0 * torch.sin((math.pi / n) * m) ** 2)


def fd_residual(phi: torch.Tensor, rho: torch.Tensor) -> float:
    """rms(rho + grad^2 phi) / rms(rho) for the periodic 7-point stencil,
    rho's mean taken out, in float64: the residual whose rms mgSolver's
    tolerance bounds (mgSolveRaw's measure), relative to rho's."""
    phi, rho = phi.double(), rho.double()
    rho = rho - rho.mean()
    lap = sum(torch.roll(phi, 1, d) + torch.roll(phi, -1, d)
              for d in range(phi.ndim)) - 2.0 * phi.ndim * phi
    den = float(rho.square().mean().sqrt())
    return float((rho + lap).square().mean().sqrt()) / (den if den else 1.0)


def mean_share(phi: torch.Tensor) -> float:
    """|mean phi| / max |phi|, in float64: how far phi is from the neutral
    one (mean zero) that the periodic solves return."""
    phi = phi.double()
    den = float(phi.abs().max())
    return abs(float(phi.mean())) / (den if den else 1.0)


def efield(phi: torch.Tensor) -> torch.Tensor:
    """E = -grad(phi), centred differences, (X, Y, Z, 3), in phi's type."""
    return torch.stack([-(0.5 * (torch.roll(phi, -1, d)
                                 - torch.roll(phi, 1, d)))
                        for d in range(3)], dim=-1)


def gather(E: torch.Tensor, lpos: torch.Tensor, grid: Sequence[int], T: int,
           wdt: torch.dtype, margin: Optional[int] = None) -> torch.Tensor:
    """E (X, Y, Z, 3) at the slots of one species' planes lpos (3, NT, B):
    the field and the (y, z) weight products rounded to wdt (the gather
    kernels'), summed in float64, on the nodes within the working margin
    where one is given (_corners).  Returns (3, NT, B) float64."""
    _, NT, B = lpos.shape
    dev = lpos.device
    L = torch.tensor(grid, device=dev)
    org = tile_origins(grid, T, dev)
    F = rounded(E.float(), wdt).double().reshape(-1, 3)
    out = torch.empty((3, NT, B), dtype=torch.float64, device=dev)
    for t0, t1 in _chunks(NT, B):
        o = org[t0:t1]
        nx, ny, nz = (_corners(lpos[d, t0:t1], T, margin) for d in range(3))
        acc = torch.zeros((t1 - t0, B, 3), dtype=torch.float64, device=dev)
        for ia, wa in nx:
            ga = torch.remainder(ia + o[:, 0:1], L[0])
            for ib, wb in ny:
                gb = torch.remainder(ib + o[:, 1:2], L[1])
                for ic, wc in nz:
                    gc = torch.remainder(ic + o[:, 2:3], L[2])
                    w = rounded(wb * wc, wdt).double() * wa.double()
                    idx = (ga * L[1] + gb) * L[2] + gc
                    acc += F[idx] * w[..., None]
        out[:, t0:t1] = acc.permute(2, 0, 1)
    return out


# ------------------------------------------------------------ the objects
def sphere_domain(shape: Sequence[int], center: Sequence[float],
                  radius: float) -> np.ndarray:
    """The voxelized sphere: node value 1 where |node - center| <= radius
    (PINC's ConstructGrid), else 0."""
    g = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                    indexing="ij")
    r2 = sum((a - c) ** 2 for a, c in zip(g, center))
    return (r2 <= radius ** 2).astype(np.float64)


def surface_nodes(domain: np.ndarray) -> np.ndarray:
    """Flat indices of the object's surface nodes: those whose octant
    stencil {x - d, d in {0, 1}^3} holds some but not all object nodes,
    reads past the low edge counting as vacuum (PINC's
    oFindObjectSurfaceNodes)."""
    m = np.rint(domain) > 0.5
    count = np.zeros(m.shape, np.int32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sh = np.zeros_like(m)
                sh[dx:, dy:, dz:] = m[: m.shape[0] - dx, : m.shape[1] - dy,
                                      : m.shape[2] - dz]
                count += sh
    return np.flatnonzero(((count > 0) & (count < 8)).ravel())


def absorbed(lpos: torch.Tensor, alive: torch.Tensor, interior: torch.Tensor,
             grid: Sequence[int], T: int) -> torch.Tensor:
    """(NT, B) bool: alive slots of one species' planes (3, NT, B) whose
    floor node is interior (PINC's oCollectObjectCharge), the position
    wrapped into the box in float32."""
    dev = lpos.device
    org = tile_origins(grid, T, dev).T.float()           # (3, NT)
    Lf = torch.tensor(grid, dtype=torch.float32, device=dev)
    cell = []
    for d in range(3):
        g = torch.remainder(lpos[d] + org[d][:, None], Lf[d])
        cell.append(torch.clamp(torch.floor(g).long(), 0, grid[d] - 1))
    inside = interior[cell[0], cell[1], cell[2]]
    return (alive > 0.5) & inside


def capacitance(surface: torch.Tensor, grid: Sequence[int],
                solver=solve) -> torch.Tensor:
    """The capacitance matrix C = A^-1 of an object's surface nodes (flat
    indices), float64: A[k, i] is the potential at surface node k of a unit
    charge at surface node i (PINC's oComputeCapacitanceMatrix), on the
    periodic grid G((r_k - r_i) mod L) of one solve (``solver``, the
    deck's method's) of a unit charge."""
    dev = surface.device
    V = math.prod(grid)
    delta = torch.zeros(V, dtype=torch.float64, device=dev)
    delta[0] = 1.0
    G = solver(delta.reshape(tuple(grid))).reshape(-1)
    rest, flat = surface.long(), torch.zeros((), dtype=torch.int64,
                                             device=dev)
    coords = []
    for n in reversed(grid):
        coords.append(rest % n)
        rest = rest // n
    coords.reverse()
    for d, n in enumerate(grid):
        flat = flat * n + torch.remainder(coords[d][:, None]
                                          - coords[d][None, :], n)
    return torch.linalg.inv(G[flat])


def corrected(rho: torch.Tensor, surface: torch.Tensor, C: torch.Tensor,
              cdt: torch.dtype = torch.float64, solver=solve):
    """PINC's oApplyCapacitanceMatrix on rho (float64): phi = solver(rho),
    the object's potential phi_c = sum_ij C_ji phi_j / sum_ij C_ij and
    rho += C^T (phi_c - phi) on the surface nodes, which leaves the surface
    an equipotential and adds no net charge.  cdt: the type C and the
    surface potentials are rounded to (the control's).  Returns (rho
    corrected, phi_c)."""
    r = (lambda t: t) if cdt == torch.float64 else \
        (lambda t: t.to(cdt).double())
    Cr = r(C)
    phi_s = r(solver(rho).reshape(-1)[surface])
    phi_c = float(Cr.sum(dim=1) @ phi_s) / float(Cr.sum())
    out = rho.reshape(-1).clone()
    out.index_add_(0, surface.long(), r(Cr.T @ (phi_c - phi_s)))
    return out.reshape(rho.shape), phi_c


# --------------------------------------------------- multiset fingerprints
_MUL = (0x9E3779B97F4A7C15 - (1 << 64), 0xC2B2AE3D27D4EB4F - (1 << 64),
        0x165667B19E3779F9, 0x27D4EB2F165667C5, 0x85EBCA77C2B2AE63 - (1 << 64),
        0x94D049BB133111EB - (1 << 64), 0x2545F4914F6CDD1D)


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ ((h >> 31) & ((1 << 33) - 1))
    h = h * _MUL[0]
    h = h ^ ((h >> 29) & ((1 << 35) - 1))
    return h


def slot_hash(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """A 64-bit hash (int64, wrapping) of equal-shaped int32 words."""
    h = torch.zeros(words[0].shape, dtype=torch.int64,
                    device=words[0].device)
    for i, w in enumerate(words):
        h = _mix(h + (w.long() & 0xFFFFFFFF) * _MUL[(i + 1) % len(_MUL)])
    return _mix(h)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tile_fingerprints(tile: torch.Tensor, lpos: torch.Tensor,
                      vel: torch.Tensor, keep: torch.Tensor,
                      NT: int) -> torch.Tensor:
    """(NT,) int64: per tile, the wrapping sum of the hashes of the kept
    slots' (tile, local position bits, velocity bits).  Two layouts hold
    the same multiset of particles in every tile exactly where their
    fingerprints agree (but for a 2^-64 chance).  tile (N,), lpos and vel
    (3, N) float32, keep (N,) bool."""
    h = slot_hash([tile.to(torch.int32)] + [_bits(lpos[d]) for d in range(3)]
                  + [_bits(vel[d]) for d in range(3)])
    h = torch.where(keep, h, torch.zeros_like(h))
    fp = torch.zeros(NT, dtype=torch.int64, device=h.device)
    return fp.index_add_(0, tile.long(), h)


def layout_fingerprints(lpos: torch.Tensor, vel: torch.Tensor,
                        alive: torch.Tensor) -> torch.Tensor:
    """tile_fingerprints of one species' tiled planes (3, NT, B)."""
    _, NT, B = lpos.shape
    tile = torch.arange(NT, device=lpos.device)[:, None].expand(NT, B)
    return tile_fingerprints(tile.reshape(-1), lpos.reshape(3, -1),
                             vel.reshape(3, -1), alive.reshape(-1) > 0.5, NT)


def bucketed_fingerprints(pos: torch.Tensor, vel: torch.Tensor,
                          grid: Sequence[int], T: int) -> torch.Tensor:
    """tile_fingerprints of global float32 positions pos (N, 3) and vel
    (N, 3), each put in the tile of its floor node with position - origin
    as its local position: the bucketing worked out again."""
    nt = tile_grid(grid, T)
    cell = torch.floor(pos).long()
    ti = [torch.div(cell[:, d], T, rounding_mode="floor") for d in range(3)]
    tile = (ti[0] * nt[1] + ti[1]) * nt[2] + ti[2]
    lp = torch.stack([pos[:, d] - (ti[d] * T).float() for d in range(3)])
    return tile_fingerprints(tile, lp, vel.T.contiguous(),
                             torch.ones(pos.shape[0], dtype=torch.bool,
                                        device=pos.device), math.prod(nt))


def rebucketed_fingerprints(lpos: torch.Tensor, vel: torch.Tensor,
                            alive: torch.Tensor, grid: Sequence[int], T: int,
                            sdt: torch.dtype = torch.float32) -> torch.Tensor:
    """tile_fingerprints of one species' planes (3, NT, B) re-bucketed: each
    alive slot moves to the neighbouring tile its position lies in (one
    tile at most along each axis) with position - shift * T per axis in
    float32 (rounded to sdt: the control's)."""
    _, NT, B = lpos.shape
    nt = tile_grid(grid, T)
    t = torch.arange(NT, device=lpos.device)
    ijk = [t // (nt[1] * nt[2]), (t // nt[2]) % nt[1], t % nt[2]]
    new_lp, new_t = [], []
    for d in range(3):
        x = lpos[d]
        shift = (x >= float(T)).long() - (x < 0.0).long()
        new_lp.append(rounded(x - (shift * T).float(), sdt))
        new_t.append(torch.remainder(ijk[d][:, None] + shift, nt[d]))
    tile = (new_t[0] * nt[1] + new_t[1]) * nt[2] + new_t[2]
    return tile_fingerprints(tile.reshape(-1),
                             torch.stack(new_lp).reshape(3, -1),
                             vel.reshape(3, -1), alive.reshape(-1) > 0.5, NT)
