"""The comparison that decides ``correct``: the numbers a run compares,
each worked out by the plain reference (``reference.py``) from what the
program's timed entry took in and gave out at one step, one re-bucket and
the start, and each held to its limit from ``limits/<workload>.json``.

A capture is a dict of tensors of one step as the timed entry left them:
``lpos``, ``vel`` (S, 3, NT, B) and ``alive`` (S, NT, B) float32, ``rho``,
``phi`` (X, Y, Z), ``n_out`` (the program's count of slots past the margin
at that step), on the ``run`` entry also ``E`` (X, Y, Z, 3), and on an
object deck ``rho_obj`` and ``obj_phi``.  ``control_step`` stands the
reference, one precision step lower, in the program's place.  The solve
is judged by the equation of the deck's own method (``SOLVES``): against
the continuum spectral solve for sSolve, by the 7-point stencil's residual
and the mean for the multigrid; a deck whose method or boundaries the
reference cannot judge is refused before anything runs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import reference as ref


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64."""
    b = b.double()
    den = float(b.abs().max())
    return float((a.double() - b).abs().max()) / (den if den else 1.0)


#: the reference's solve for each Poisson method of the program it can
#: judge (``methods:poisson``, registry.SOLVERS' names, matched as the
#: registry matches them): the continuum spectral solve of sSolve, and the
#: exact solve of the 7-point stencil that mgSolver iterates toward
SOLVES = {"ssolve": ref.solve, "ssolver": ref.solve,
          "mgsolve": ref.solve_fd, "mgsolver": ref.solve_fd}


def judged_solve(deck):
    """The reference's solve of the deck's method; raises ValueError, naming
    the key, for a deck the reference cannot judge: a method not in SOLVES,
    or a boundary that is not PERIODIC (the deposit, E and both solves of
    the reference are periodic)."""
    method = deck.get("methods", {}).get("poisson")
    if method is None or method.strip().lower() not in SOLVES:
        raise ValueError(f"methods:poisson = {method!r}: the reference "
                         f"judges only {sorted(SOLVES)}")
    bounds = deck["grid"].get("boundaries", "PERIODIC")
    if any(b.strip().upper() != "PERIODIC" for b in bounds.split(",")):
        raise ValueError(f"grid:boundaries = {bounds!r}: the reference "
                         f"judges only PERIODIC")
    return SOLVES[method.strip().lower()]


class Geometry:
    """What the reference works out of the deck, the mix's stated layout
    and the object grid: the species, the field solve of the deck's method
    (``judged_solve``), the tile edge, the grid, the layout margin M and the
    re-bucket cadences the mix states (``expect``), the interior lookup,
    the surface nodes and the capacitance matrix."""

    def __init__(self, deck, domain=None, device="cpu", layout=None):
        self.deck = deck
        self.solve = judged_solve(deck)
        self.species = ref.species(deck)
        self.grid = tuple(int(v) for v in deck["grid"]["trueSize"].split(","))
        self.T = int(deck["tiles"].get("tileSize", 8))
        layout = layout or {}
        self.M = int(layout["margin"]) if "margin" in layout else None
        self.cadences = [int(R) for R in layout.get("cadences", [])]
        self.schedule = deck["tiles"].get("marginSchedule",
                                          "true").lower() != "false"
        self.interior = self.surface = self._C = None
        if domain is not None:
            self.interior = torch.as_tensor(domain > 0.5, device=device)
            self.surface = torch.as_tensor(ref.surface_nodes(domain),
                                           device=device)

    @property
    def charges(self):
        return [s["q"] for s in self.species]

    @property
    def C(self) -> torch.Tensor:
        """The object's capacitance matrix, worked out on first use (after
        the measured window)."""
        if self._C is None:
            self._C = ref.capacitance(self.surface, self.grid, self.solve)
        return self._C

    def step_margins(self, entry: str, n: int, j: int):
        """The working margins (mg, md) of each species at the judged step:
        on the scan entry step j of an n-step window (ref.scan_margins),
        on run() the layout margin."""
        if entry == "scan":
            return ref.scan_margins(self.M, self.cadences, n, j,
                                    self.schedule)
        return [(self.M, self.M)] * len(self.species)


def _kick(vel, E, lpos, g: Geometry, wdt, margins) -> torch.Tensor:
    """The reference's kicked velocities (S, 3, NT, B) float64, each
    species' gather on the nodes within its margin mg."""
    return torch.stack([vel[s].double() + g.species[s]["qm"]
                        * ref.gather(E, lpos[s], g.grid, g.T, wdt,
                                     margins[s][0])
                        for s in range(vel.shape[0])])


def _vel_err(vel0, vel1, v_ref, alive) -> float:
    """max over species of max |vel1 - v_ref| / max |v_ref - vel0| on the
    alive slots: the velocity error against the size of the kick."""
    worst = 0.0
    for s in range(vel0.shape[0]):
        a = alive[s][None] > 0.5
        kick = float(torch.where(a, v_ref[s] - vel0[s].double(),
                                 torch.zeros((), dtype=torch.float64,
                                             device=a.device)).abs().max())
        err = float(torch.where(a, vel1[s].double() - v_ref[s],
                                torch.zeros((), dtype=torch.float64,
                                            device=a.device)).abs().max())
        worst = max(worst, err / (kick if kick else 1.0))
    return worst


def _pos_err(x1, x_ref, alive) -> float:
    a = alive[:, None] > 0.5
    return float(torch.where(a, (x1 - x_ref).abs(),
                             torch.zeros((), device=a.device)).max())


def _absorb_ref(lpos, alive, g: Geometry) -> torch.Tensor:
    return torch.stack([ref.absorbed(lpos[s], alive[s], g.interior, g.grid,
                                     g.T) for s in range(lpos.shape[0])])


def _out_of_margin(lpos, alive, g: Geometry, margins) -> int:
    """The reference's count of alive slots past each species' deposit
    margin md."""
    return sum(ref.out_of_margin(lpos[s], alive[s], g.T, margins[s][1])
               for s in range(lpos.shape[0]))


def _surface_mask(g: Geometry, shape) -> torch.Tensor:
    keep = torch.zeros(math.prod(shape), dtype=torch.bool,
                       device=g.surface.device)
    keep[g.surface] = True
    return keep.reshape(shape)


def step_numbers(entry: str, g: Geometry, c0: dict, c1: dict,
                 margins) -> Dict[str, float]:
    """The numbers of one step from c0 (the state the step took in) to c1
    (what it gave out), each stage judged from the program's own input to
    it, every slot past its working margin (margins: (mg, md) a species)
    on the layout's rule.  ``scan`` (the mega body): kick with the field of
    c0's solve at c0's positions, drift, the count past the margin,
    deposit, solve.  ``run``: drift, the count past the margin, the
    object's absorption, deposit (with the collected charge and the
    capacitance correction on an object deck), solve, E, kick at the new
    positions."""
    wdt = ref.weight_dtype(g.deck)
    md = [m[1] for m in margins]
    out: Dict[str, float] = {}
    if entry == "scan":
        E0 = ref.efield(c0["phi"].float())
        v_ref = _kick(c0["vel"], E0, c0["lpos"], g, wdt, margins)
        out["vel_err"] = _vel_err(c0["vel"], c1["vel"], v_ref, c0["alive"])
        out["pos_err"] = _pos_err(c1["lpos"], c0["lpos"] + c1["vel"],
                                  c1["alive"])
        out["alive_off"] = float((c1["alive"] != c0["alive"]).sum())
        n_ref = _out_of_margin(c1["lpos"], c1["alive"], g, margins)
    else:
        x_ref = c0["lpos"] + c0["vel"]
        n_ref = _out_of_margin(x_ref, c0["alive"], g, margins)
        alive_ref = c0["alive"] > 0.5
        if g.interior is not None:
            hit = _absorb_ref(x_ref, c0["alive"], g)
            alive_ref = alive_ref & ~hit
            dq = sum(g.charges[s] * float(hit[s].sum())
                     for s in range(hit.shape[0]))
            got = float(c1["rho_obj"].double().sum()
                        - c0["rho_obj"].double().sum())
            out["charge_err"] = abs(got - dq) / abs(g.charges[0])
        out["alive_off"] = float(((c1["alive"] > 0.5) != alive_ref).sum())
        out["pos_err"] = _pos_err(c1["lpos"], x_ref, c1["alive"])
        v_ref = _kick(c0["vel"], c1["E"], c1["lpos"], g, wdt, margins)
        out["vel_err"] = _vel_err(c0["vel"], c1["vel"], v_ref, c1["alive"])
        out["efield_err"] = _rel(c1["E"], ref.efield(c1["phi"].double()))
    out["margin_count_off"] = abs(float(c1["n_out"].double().sum()) - n_ref)
    dep = ref.deposit(c1["lpos"], c1["alive"], g.charges, g.grid, g.T, wdt,
                      md)
    rho = c1["rho"].double()
    if g.surface is not None:
        # the deposit, the collected charge and the capacitance correction,
        # all worked out again; on the surface nodes rho holds all three
        pre = dep + c1["rho_obj"].double()
        dep, _ = ref.corrected(pre, g.surface, g.C, solver=g.solve)
        on = _surface_mask(g, rho.shape)
        zero = torch.zeros((), dtype=torch.float64, device=rho.device)
        out["surface_rho_err"] = _rel(torch.where(on, rho, zero),
                                      torch.where(on, dep, zero))
        out["total_charge_err"] = (abs(float(rho.sum()) - float(pre.sum()))
                                   / abs(g.charges[0]))
        rho, dep = torch.where(on, zero, rho), torch.where(on, zero, dep)
        phi = c1["phi"].double().reshape(-1)
        out["equipotential_err"] = (
            float((phi[g.surface] - float(c1["obj_phi"][0])).abs().max())
            / float(phi.abs().max()))
    out["rho_err"] = _rel(rho, dep)
    if g.solve is ref.solve_fd:
        # the multigrid stops at its tolerance on the stencil's residual, or
        # at its cycle cap, and the residual's lowest modes weigh 1/k^2 in
        # phi: on large grids a sound solve lies percents of max |phi| from
        # the exact one, farther than bfloat16's rounding.  So its phi is
        # judged by what fixes it: the residual, and the mean it holds at 0
        out["phi_resid"] = ref.fd_residual(c1["phi"], c1["rho"])
        out["phi_mean"] = ref.mean_share(c1["phi"])
    else:
        out["phi_err"] = _rel(c1["phi"], g.solve(c1["rho"].double()))
    return out


def control_step(entry: str, g: Geometry, c0: dict, margins) -> dict:
    """The step of c0 computed by the reference one precision step below
    the deck's (fp8 e4m3 weights and gathered field, bfloat16 states,
    fields and capacitance matrix), in the shape of a capture."""
    wdt = ref.weight_dtype(g.deck, "control")
    sdt = ref.state_dtype("control")
    r = lambda t: ref.rounded(t.float(), sdt)           # noqa: E731
    md = [m[1] for m in margins]
    out = {}
    if entry == "scan":
        E0 = ref.efield(c0["phi"].float())
        vel = r(_kick(c0["vel"], E0, c0["lpos"], g, wdt, margins))
        vel = torch.where(c0["alive"][:, None] > 0.5, vel, c0["vel"])
        lpos = r(c0["lpos"] + vel)
        alive = c0["alive"]
        rho = r(ref.deposit(lpos, alive, g.charges, g.grid, g.T, wdt, md))
        n_out = _out_of_margin(lpos, alive, g, margins)
        out.update(lpos=lpos, vel=vel, alive=alive, rho=rho,
                   phi=r(g.solve(rho.double())),
                   n_out=torch.tensor(float(n_out)))
        return out
    lpos = r(c0["lpos"] + c0["vel"])
    alive = c0["alive"]
    n_out = _out_of_margin(lpos, alive, g, margins)
    rho_obj = None
    if g.interior is not None:
        hit = _absorb_ref(lpos, alive, g)
        alive = torch.where(hit, torch.zeros_like(alive), alive)
        dq = sum(g.charges[s] * float(hit[s].sum())
                 for s in range(hit.shape[0]))
        flat = c0["rho_obj"].double().reshape(-1).clone()
        flat[g.surface] += dq / g.surface.numel()
        rho_obj = r(flat.reshape(c0["rho_obj"].shape))
    rho = r(ref.deposit(lpos, alive, g.charges, g.grid, g.T, wdt, md))
    if rho_obj is not None:
        rho, phi_c = ref.corrected(rho.double() + rho_obj.double(),
                                   g.surface, g.C, cdt=sdt,
                                   solver=g.solve)
        rho = r(rho)
        out.update(rho_obj=rho_obj,
                   obj_phi=torch.tensor([phi_c], device=rho.device))
    phi = r(g.solve(rho.double()))
    E = r(ref.efield(phi.double()))
    vel = r(_kick(c0["vel"], E, lpos, g, wdt, margins))
    vel = torch.where(alive[:, None] > 0.5, vel, c0["vel"])
    out.update(lpos=lpos, vel=vel, alive=alive, rho=rho, phi=phi, E=E,
               n_out=torch.tensor(float(n_out)))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every number, and whether all hold.
    A number without a limit, a missing number, or one that is not finite
    fails."""
    table, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v = numbers.get(name, float("nan"))
        lim = limits.get(name, float("nan"))
        table[name] = {"value": v, "limit": lim}
        if not (math.isfinite(v) and math.isfinite(lim) and v <= lim):
            ok = False
    return {"ok": ok, "table": table}
