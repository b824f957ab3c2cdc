"""Tiled-layout simulation on one device: the production PIC step (the
counterpart of ``pinc_tpu/tiled_sim.py``).

Same physics as :class:`Simulation`, but particles live in per-tile buckets
(``ops/tiled.py``) as component planes.  On a periodic 3-D deck every step
runs the fused kernels of ``ops/tiled_kernels.py``: per species
``deposit_move`` (drift, margin count, deposit), then the fold, the solve
and E = -grad(phi), then per species ``gather_kick`` (gather, kick, KE
sum).  A deck with bounded walls (``grid:boundaries`` DIRICHLET or
NEUMANN) takes pinc_tpu's unfused step: the drift, the walls' reflection
on the tile-local planes, the margin count, ``deposit`` per species, the
fold, the solve, the BC-aware E = -grad(phi), then ``gather`` and the
kick.  The half kick runs ``deposit`` and ``gather``.  On CUDA tensors
these are the hand-written kernels, on CPU tensors their plain versions.
The kernels are 3-D: 1-D and 2-D decks take pinc_tpu's route for them, the
unfused step on the plain tiled deposit, fold and gather of
``ops/tiled.py`` and the sort re-bucket, where no kernel runs (nor does a
Pallas kernel in pinc_tpu).

Deck knobs, section ``[tiles]``: ``tileSize`` (default 8), ``margin``
(default 1 when the velocity scale allows a re-bucket cadence >= 4, else
2), ``slack`` (bucket head room, default 1.25), ``rebucketEvery``
(default: per species, from the velocity scale), ``mxuDtype`` (f32 or
bf16 weights) and ``rebucket``.  Re-bucketing is, by default, the
exchange of ``ops/exchange.py``: live slots that left their tile move to
the neighbouring tile through buffers, tuned by ``exchangeCap`` (face
cap), ``exchangeRows``, ``exchangeFused``, ``exchangeImpl`` and
``exchangeTotalCap``.  As in pinc_tpu, it takes the gather kernels
(K8-K10) when B % 1024 == 0 and the per-row gate holds, else the one-hot
kernels (K11, ``ops/onehot_exchange.py``).  ``tiles:rebucket = sort``
selects the stable sort of ``ops/tiled.bucket`` instead.

``make_scan_steps(n)`` is the production long-run path (the counterpart of
pinc_tpu's ``make_scan_steps``): n steps with the per-species re-bucket
schedule applied between them, no host sync inside the window with the
FFT solve (an ``mgSolve`` deck makes one a V-cycle, to test the
tolerance).  On a periodic 3-D deck by default (``tiles:mega``, true)
each step is one K5 ``pic_step`` for every species (gather with the
previous step's field, kick, drift, deposit), then the K7 fold, the solve
and the K6 E tiles (``ops/field_kernels.py``); on decks with margin >= 2
and ``fresh=True`` the steps run at the per-step margin schedule
(``tiles:marginSchedule``, true).  ``tiles:mega = false``, and every deck
the fused kernels do not serve, scans the step of ``run()``.

``tiles:backend`` is read as pinc_tpu reads it.  ``pallas`` (the port's
default on every device for 3-D decks; 1-D and 2-D decks default to
``xla``, as in pinc_tpu) is the route above.  Any other value is
pinc_tpu's XLA route: the unfused step (on a 3-D deck with ``deposit`` and
``gather`` at f32 weights whatever ``tiles:mxuDtype`` says, as pinc_tpu's
XLA deposit and gather are), and the window scans it (no mega body, no
margin schedule).  ``tiles:gather`` (pinc_tpu's choice between two XLA
gathers of the same field) is accepted and ignored.

``methods:debug`` checks the invariants after every step of ``run()``
(speed under ``population:maxVel``, every particle inside its tile's
margin, a neutral grid on periodic decks) and raises ``PincError``.

``run(writer)`` writes the deck's output (``io_h5.OutputWriter``) and
checkpoints as pinc_tpu's does; a tiled checkpoint holds the tile planes
verbatim and what ``retune`` set, so a resumed run is the uninterrupted
one bit for bit.  Decks with objects are refused.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .config import PincConfig
from .grid import potential_energy
from .ops import exchange as ex
from .ops import field_kernels as fk
from .ops import gather_exchange as gx
from .ops import onehot_exchange as ox
from .ops import tiled as tl
from .ops import tiled_kernels as tk
from .population import Particles
from .simulation import Diagnostics, Simulation, StepOutput, _stack
from .utils.logging import ERROR, STATUS, TIMER, WARNING, msg


@dataclass
class TiledState:
    """Component-plane layout: coordinates are D contiguous (NT, B)
    planes, the layout every kernel reads."""
    lpos: torch.Tensor    # (S, D, NT, B) tile-local positions, f32
    vel: torch.Tensor     # (S, D, NT, B) f32
    alive: torch.Tensor   # (S, NT, B) f32 0/1


class TiledSimulation(Simulation):
    _DEFER_PARTICLES = True    # bucket from per-species generation at
                               # giant populations (see Simulation)
    _TILED_CKPT = True         # a tiled checkpoint restores verbatim

    def __init__(self, cfg: PincConfig, seed: int = 1, device=None):
        nd = cfg.get_int("grid:ndims")
        super().__init__(cfg, seed=seed, device=device)
        # physics-method routing: the kernels honor the same deck
        # selections as the flat path through the registry closures'
        # attributes; anything they cannot express raises
        self._acc_order = getattr(self.acc, "order", None)
        self._acc_boris = getattr(self.acc, "boris", None)
        self._distr_order = getattr(self.distr, "order", None)
        if None in (self._acc_order, self._acc_boris, self._distr_order):
            raise ValueError(
                "methods:layout=tiled requires a registry accelerator/"
                "distributor (puAcc*/puBoris*/puDistr*) — got "
                f"{cfg.get_str('methods:acc')}/{cfg.get_str('methods:distr')}")
        eext = getattr(self.acc, "E_ext", None)
        self._e_ext = (None if eext is None else
                       tuple(float(v) for v in eext.reshape(-1).tolist()))
        charge = self.params.charge.cpu().numpy()
        mass = self.params.mass.cpu().numpy()
        if self._acc_boris:
            # puGet3DRotationParameters (src/pusher.c:483-505):
            # T = 0.5 (q/m) B_ext, S = 2T / (1 + |T|^2), per species
            bext = np.asarray(cfg.get_double_arr("fields:bext", nd)
                              if "fields:bext" in cfg else [0.0] * nd)
            T_s = 0.5 * (charge / mass)[:, None] * bext[None, :]
            self._boris_T = T_s
            self._boris_S = 2.0 * T_s / (1.0 + np.sum(T_s * T_s, axis=1,
                                                      keepdims=True))
        else:
            self._boris_T = self._boris_S = None

        T = cfg.get_int("tiles:tilesize", 8)
        ns = cfg.get_int("population:nspecies")
        # per-species velocity scale: the 99.9th percentile of a strided
        # sample of the initial speeds * 1.5, floored by the deck's thermal
        # and drift velocities (cold starts develop thermal speeds within
        # an oscillation period)
        vth_cfg = (cfg.get_double_arr("population:thermalvelocity", ns)
                   if "population:thermalvelocity" in cfg else [0.0] * ns)
        dr_cfg = (cfg.get_double_arr("population:drift", ns)
                  if "population:drift" in cfg else [0.0] * ns)
        floor_s = [(3.29 * abs(vth_cfg[s]) + abs(dr_cfg[s])) * 1.5
                   for s in range(ns)]
        if self.particles is not None:
            stride = max(1, self.particles.vel.shape[1] // 500_000)
            vel_np = self.particles.vel[:, ::stride].abs().cpu().numpy()
            alive_np = self.particles.alive[:, ::stride].cpu().numpy()
            vmax_s = []
            for s in range(ns):
                vs = vel_np[s][alive_np[s]]
                measured = (float(np.percentile(vs, 99.9)) * 1.5
                            if vs.size else 0.0)
                vmax_s.append(max(measured, floor_s[s], 1e-3))
        else:
            # deferred init: the same statistic analytically (3.29 sigma
            # for a Maxwellian)
            vmax_s = [max(f, 1e-3) for f in floor_s]
        vmax_est = max(vmax_s)
        M = cfg.get_int("tiles:margin", 1 if 1.0 / vmax_est >= 4 else 2)
        if vmax_est > max(M, 2):
            raise ValueError(
                f"tiled layout: estimated per-step particle displacement "
                f"({vmax_est:.2f} cells) exceeds the wander margin "
                f"(tiles:margin={M}); this deck is outside the tiled "
                f"layout's envelope — use methods:layout=flat or a "
                f"coarser grid:stepSize")
        slack = cfg.get_double("tiles:slack", 1.25)
        from .population import capacity_of
        cap_all = (self.particles.capacity if self.particles is not None
                   else capacity_of(cfg))
        ppt = cap_all * (T ** nd) / self.spec.global_volume
        # B rounds up to the quantum of pinc_tpu (128, or 1024 at
        # production sizes), so both packages size the buckets alike
        quantum = 1024 if ppt * slack >= 8192 else 128
        B = int(math.ceil(ppt * slack / quantum)) * quantum
        self.ts = tl.TileSpec(grid=self.spec.global_size, T=T, M=M, B=B)
        self.ts.validate()

        # re-bucket: the exchange (pinc_tpu's 3-D default) or the sort
        self._rebucket_mode = cfg.get_str(
            "tiles:rebucket", "exchange" if nd == 3 else "sort").lower()
        # per-face transfer capacity: the mean leavers per face over one
        # cadence is ~1% of ppt at M=1; ppt*M/(8T) is ~1.5x that mean with
        # +5 Poisson sigmas of head room (overflow is counted as drops)
        ppt_est = ppt if ppt > 0 else 128
        cap = int(math.ceil(ppt_est * max(M, 1) / (8.0 * T) / 128.0)) * 128
        cap = max(128, min(cap, (B // 8) * 8))
        self._exchange_cap = cfg.get_int("tiles:exchangecap", cap)
        self._cap_escalation = 1.0        # retune()'s factor after drops
        self._exchange_rows = self._rows_default(B, ppt)

        # per-species re-bucket cadences; slow cadences snap down to a
        # multiple of the fastest
        if "tiles:rebucketevery" in cfg:
            self.rebucket_every = cfg.get_int("tiles:rebucketevery")
            self.rebucket_every_s = [self.rebucket_every] * len(vmax_s)
        else:
            R_s = [max(1, min(int(M / v), 200)) for v in vmax_s]
            Re = min(R_s)
            self.rebucket_every_s = [
                R if R == Re else max(Re, R // Re * Re) for R in R_s]
            self.rebucket_every = min(self.rebucket_every_s)
        # tiles:backend as pinc_tpu reads it: "pallas" is its fused-kernel
        # route (bf16 weights where tiles:mxuDtype asks, the mega scan
        # body, the margin schedule); any other value its XLA route, the
        # unfused step with f32 weights.  The default on 3-D decks is
        # "pallas" on every device (pinc_tpu's is "xla" on its CPU): the
        # CPU runs the pallas route's plain versions.  1-D and 2-D decks
        # default to "xla", as in pinc_tpu; the kernels and the exchange
        # are 3-D.  tiles:gather only picks one of two XLA gathers of the
        # same field in pinc_tpu; it is read and ignored.
        self._backend = cfg.get_str("tiles:backend",
                                    "pallas" if nd == 3 else "xla").lower()
        if nd != 3 and (self._backend == "pallas"
                        or self._rebucket_mode == "exchange"):
            raise ValueError(
                f"tiles:backend=pallas and tiles:rebucket=exchange need a "
                f"3-D deck (grid:nDims = {nd}); leave both keys unset")
        self._gather_mode = cfg.get_str("tiles:gather", "mxu").lower()
        self._mxu_dtype = (torch.bfloat16 if self._backend == "pallas"
                           and cfg.get_str("tiles:mxudtype", "f32").lower()
                           in ("bf16", "bfloat16") else torch.float32)
        self._capacity = cap_all
        self._charge = [float(c) for c in charge]
        self._mass = [float(m) for m in mass]
        self._qm = [float(q) for q in charge / mass]

        if self._pending_tiled_resume:
            from . import checkpoint as _ckpt
            self.resume(*_ckpt.load_tiled(
                cfg, expect_shape=(ns, nd, self.ts.NT, B),
                device=self.device))
        elif self.particles is None:
            self.state = self._bucket_all_generate(seed)
        else:
            self.state = self._bucket_all(self.particles)
            if cap_all * ns > 32_000_000:
                self.particles = None
        msg(STATUS, "tiled layout: %s tiles of %d^%d cells, bucket=%d, "
            "margin=%d, %s re-bucket every %s steps, device %s",
            self.ts.ntiles, T, nd, B, M, self._rebucket_mode,
            self.rebucket_every_s, self.device)

    def resume(self, step: int, state: TiledState,
               tuning: Optional[dict] = None) -> None:
        """Continue from ``state`` (the tile planes verbatim, slot
        assignment included) at step ``step`` with the interrupted run's
        ``tuning()``: run() skips the half kick and runs steps step + 1 ..
        nTimeSteps, the uninterrupted trajectory bit for bit.  What a
        tiled checkpoint restores.  Without ``tuning`` the deck's
        cadences and face cap stand, which is the uninterrupted run only
        where no retune fired before ``step``."""
        self.state, self.start_step, self._resumed = state, step, True
        self.particles = None
        if tuning:
            self.rebucket_every_s = [int(R)
                                     for R in tuning["rebucket_every_s"]]
            self.rebucket_every = min(self.rebucket_every_s)
            self._exchange_cap = int(tuning["exchange_cap"])
            self._cap_escalation = float(tuning["cap_escalation"])
            self._exchange_rows = bool(tuning["exchange_rows"])

    def tuning(self) -> dict:
        """What retune() changes during a run and resume() restores: the
        per-species re-bucket cadences, the exchange face cap, its
        escalation after drops and the per-row gate."""
        return {"rebucket_every_s": list(self.rebucket_every_s),
                "exchange_cap": self._exchange_cap,
                "cap_escalation": self._cap_escalation,
                "exchange_rows": self._exchange_rows}

    # ------------------------------------------------------------- layout
    def retune(self, st: Optional[TiledState] = None, drops: int = 0) -> bool:
        """Re-estimate the per-species velocity scales from the current
        state and refresh the re-bucket cadences and the exchange face cap
        (called by run() after a drop or a margin hit).  drops: the
        re-bucket drops seen since the last retune; any drop escalates the
        face cap 1.5x, and the per-row gate is evaluated again under the
        new cap.  Returns True if anything changed."""
        st = self.state if st is None else st
        S, D, NT, B = st.vel.shape
        stride = max(1, NT // 64)
        vel_np = st.vel[:, :, ::stride].abs().cpu().numpy()
        alive_np = st.alive[:, ::stride].cpu().numpy() > 0.5
        M = self.ts.M
        v_s = [0.0] * S
        R_s = list(self.rebucket_every_s)
        for s in range(S):
            vs = vel_np[s].reshape(D, -1)[:, alive_np[s].reshape(-1)]
            if vs.size:
                v_s[s] = max(float(np.percentile(vs, 99.9)) * 1.5, 1e-3)
                R_s[s] = max(1, min(int(M / v_s[s]), 200))
        Re = min(R_s)
        R_s = [R if R == Re else max(Re, R // Re * Re) for R in R_s]
        changed = False
        for s in range(S):
            if R_s[s] != self.rebucket_every_s[s]:
                msg(STATUS, "retune: species %d re-bucket cadence %d -> %d",
                    s, self.rebucket_every_s[s], R_s[s])
                self.rebucket_every_s[s] = R_s[s]
                changed = True
        self.rebucket_every = min(self.rebucket_every_s)
        if self.rebucket_every < 2:
            msg(WARNING, "retune: cadence hit %d — the velocity scale has "
                "outgrown margin M=%d (raise tiles:margin)",
                self.rebucket_every, M)
        # face cap: the hottest species' drift per cadence (cadence * v ~= M
        # by construction, more once the cadence clamps at 1), times 1.5 for
        # every retune that follows drops
        ppt = self._capacity * (self.ts.T ** self.ts.n_dims) \
            / self.spec.global_volume
        drift = max(max(R * v for R, v in zip(self.rebucket_every_s, v_s)),
                    float(max(M, 1)))
        self._cap_escalation *= 1.5 if drops else 1.0
        cap = int(math.ceil(max(ppt, 128) * drift * self._cap_escalation
                            / (8.0 * self.ts.T) / 128.0)) * 128
        cap = max(128, min(cap, (self.ts.B // 8) * 8))
        if "tiles:exchangecap" not in self.cfg and cap != self._exchange_cap:
            msg(STATUS, "retune: exchange face cap %d -> %d%s",
                self._exchange_cap, cap, " (after drops)" if drops else "")
            self._exchange_cap = cap
            changed = True
        if changed and "tiles:exchangerows" not in self.cfg:
            rows = self._rows_default(self.ts.B, ppt)
            if rows != self._exchange_rows:
                msg(STATUS, "retune: per-row exchange %s",
                    "enabled" if rows else "disabled (cap outgrew rows)")
                self._exchange_rows = rows
        return changed

    def _rows_default(self, B: int, ppt: float) -> bool:
        """Default of tiles:exchangeRows.  The gather exchange spills a
        row's arrivals into the tile's other rows, so only the tile needs
        head room: free slots >= 2x the rounded row face cap (and
        B % 1024 == 0).  The one-hot row kernels bind arrivals to their
        row, so every row needs it: free slots per row >= 2x the row face
        cap; else the per-tile one-hot kernels run."""
        if "tiles:exchangerows" in self.cfg:
            return self.cfg.get_bool("tiles:exchangerows")
        if B % 8:
            return False
        ks = ox.default_row_cap(self._exchange_cap, B)
        free_per_row = (B - ppt) / 8.0
        if gx.supported(B) and self.ts.n_dims == 3:
            return 8 * free_per_row >= 2 * gx.round_cap(ks)
        return free_per_row >= 2 * ks

    def _empty_state(self, S: int) -> TiledState:
        D, NT, B = self.ts.n_dims, self.ts.NT, self.ts.B
        z = dict(dtype=torch.float32, device=self.device)
        return TiledState(lpos=torch.zeros((S, D, NT, B), **z),
                          vel=torch.zeros((S, D, NT, B), **z),
                          alive=torch.zeros((S, NT, B), **z))

    def _bucket_all(self, p: Particles) -> TiledState:
        """Initial bucketing of the flat particles, one species at a time
        into the preallocated state (in place, to bound the peak)."""
        st = self._empty_state(p.n_species)
        for s in range(p.n_species):
            pos = p.cell[s].to(p.frac.dtype) + p.frac[s]
            lp, lv, la, _ = tl.bucket(pos, p.vel[s], p.alive[s], self.ts)
            del pos
            st.lpos[s] = lp.permute(2, 0, 1)
            st.vel[s] = lv.permute(2, 0, 1)
            st.alive[s] = la.float()
        return st

    def _bucket_all_generate(self, seed: int) -> TiledState:
        """Per-species generate -> bucket -> free on the device: the flat
        (S, cap, D) arrays never coexist with the tiled state, and only
        one of a species' position and velocity payloads is live."""
        from .population import device_species
        S = self.params.charge.shape[0]
        st = self._empty_state(S)
        for s in range(S):
            cell, frac, _, al = device_species(self.cfg, self.spec, seed, s,
                                               parts="pos",
                                               device=self.device)
            pos = cell.to(frac.dtype) + frac
            del cell, frac
            lp, la, tid, _ = tl.bucket_positions(pos, al, self.ts)
            del pos, al
            st.lpos[s] = lp.permute(2, 0, 1)
            st.alive[s] = la.float()
            del lp, la
            _, _, v, _ = device_species(self.cfg, self.spec, seed, s,
                                        parts="vel", device=self.device)
            st.vel[s] = tl.bucket_payload(tid, v, self.ts).permute(2, 0, 1)
            del v, tid
        return st

    def _rebucket_one(self, lpos_s, vel_s, alive_s) -> torch.Tensor:
        """Re-bucket one species in place: lpos_s, vel_s (D, NT, B) and
        alive_s (NT, B) are views of the state.  Returns the drop count,
        a 0-d integer tensor on the state's device (no host sync)."""
        if self._rebucket_mode == "exchange":
            cfg = self.cfg
            _, al, d_n = ex.rebucket_exchange_planes(
                tuple(lpos_s) + tuple(vel_s), alive_s, self.ts.ntiles,
                self.ts.T, K=self._exchange_cap, rows=self._exchange_rows,
                fused=cfg.get_bool("tiles:exchangefused", True),
                impl=cfg.get_str("tiles:exchangeimpl", "auto"),
                ku=(cfg.get_int("tiles:exchangetotalcap")
                    if "tiles:exchangetotalcap" in cfg else None))
            alive_s.copy_(al > 0.5)
            return d_n
        D = self.ts.n_dims
        gpos = tl.global_positions(lpos_s.permute(1, 2, 0),
                                   self.ts).reshape(-1, D)
        vel = vel_s.reshape(D, -1).T
        lp, lv, la, d_n = tl.bucket(gpos, vel, alive_s.reshape(-1) > 0.5,
                                    self.ts)
        lpos_s.copy_(lp.permute(2, 0, 1))
        vel_s.copy_(lv.permute(2, 0, 1))
        alive_s.copy_(la)
        return d_n

    def _rebucket(self, st: TiledState,
                  species=None) -> Tuple[TiledState, int]:
        """Re-bucket the given species (default: all), in place."""
        species = range(st.lpos.shape[0]) if species is None else species
        dropped = 0
        for s in species:
            dropped += int(self._rebucket_one(st.lpos[s], st.vel[s],
                                              st.alive[s]))
        return st, dropped

    def to_particles(self, st: TiledState) -> Particles:
        """Convert back to the (cell, frac) layout for IO/diagnostics."""
        S, D, NT, B = st.lpos.shape
        gp = torch.stack([tl.global_positions(st.lpos[s].permute(1, 2, 0),
                                              self.ts) for s in range(S)])
        gp = gp.reshape(S, NT * B, D)
        cell = torch.floor(gp)
        frac = gp - cell
        L = torch.tensor(self.ts.grid, dtype=torch.int32, device=gp.device)
        cell = torch.remainder(cell.to(torch.int32), L)
        vel = st.vel.permute(0, 2, 3, 1).reshape(S, NT * B, D)
        return Particles(cell=cell, frac=frac, vel=vel,
                         alive=st.alive.reshape(S, NT * B) > 0.5)

    # --------------------------------------------------------------- step
    def _deposit_rho(self, st: TiledState) -> torch.Tensor:
        """Deposit every species with K1, sum the padded blocks, fold once
        (K7).  A species' values are q_s or 0, so |q_s| bounds them (no
        host sync for the kernel's fixed-point grid).  1-D and 2-D decks:
        the plain tiled deposit and fold of ops/tiled.py per species."""
        if self.ts.n_dims != 3:
            rho = None
            for s in range(st.lpos.shape[0]):
                r = tl.deposit_tiled(st.lpos[s].permute(1, 2, 0),
                                     st.alive[s] > 0.5, self._charge[s],
                                     self.ts, order=self._distr_order)
                rho = r if rho is None else rho + r
            return rho.to(self.spec.dtype)
        tiles = None
        for s in range(st.lpos.shape[0]):
            value = torch.where(st.alive[s] != 0,
                                torch.tensor(self._charge[s],
                                             device=self.device),
                                torch.zeros((), device=self.device))
            t = tk.deposit(st.lpos[s], value, self.ts,
                           mxu_dtype=self._mxu_dtype, order=self._distr_order,
                           vmax=abs(self._charge[s]))
            tiles = t if tiles is None else tiles + t
        return fk.fold_global(tiles, self.ts).to(self.spec.dtype)

    def _fields(self, st: TiledState):
        rho = self._deposit_rho(st)
        phi = self.solver(rho)
        return rho, phi, self._efield(phi)

    def _field_tiles(self, E: torch.Tensor) -> torch.Tensor:
        """E (X, Y, Z, 3) -> contiguous padded tiles (NT, P, P, P, 3) f32."""
        return tl.pad_tiles(E, self.ts).float().contiguous()

    def _gather(self, E_pad: torch.Tensor, lpos: torch.Tensor):
        """E at one species' slots, (D, NT, B): K3, or on 1-D and 2-D decks
        the plain tiled gather of ops/tiled.py."""
        if self.ts.n_dims != 3:
            return tl.gather_tiled(E_pad, lpos.permute(1, 2, 0), self.ts,
                                   order=self._acc_order).permute(2, 0, 1)
        return tk.gather(E_pad, lpos, self.ts, mxu_dtype=self._mxu_dtype,
                         order=self._acc_order)

    def _kick(self, st: TiledState, E: torch.Tensor, half: bool):
        """Velocity kick on the tile planes: gather E(x) (K3), add any
        external E, then the electrostatic kick or the Boris rotation of
        tk.kick_planes, which K4's plain version shares
        (puAcc*/puBoris3D1[KE], src/pusher.c:147-505).  half=True is the
        initialization half kick (src/main.c:184-186): the E kick halves
        (external E included), the magnetic rotation angle does not."""
        E_pad = self._field_tiles(E)
        e_scale = 0.5 if half else 1.0
        if half:
            E_pad = 0.5 * E_pad
        D = self.ts.n_dims
        vels, kes = [], []
        for s in range(st.lpos.shape[0]):
            Ep = self._gather(E_pad, st.lpos[s])
            Ecs = [Ep[c] if self._e_ext is None
                   else Ep[c] + e_scale * self._e_ext[c] for c in range(D)]
            v = st.vel[s]
            outs, v_dot = tk.kick_planes([v[c] for c in range(D)], Ecs,
                                         self._qm[s], self._boris(s))
            alive = st.alive[s] != 0
            v_dot = torch.where(alive, v_dot, torch.zeros_like(v_dot))
            kes.append(0.5 * self._mass[s] * torch.sum(v_dot))
            vels.append(torch.where(alive[None], torch.stack(outs), v))
        return (TiledState(lpos=st.lpos, vel=torch.stack(vels),
                           alive=st.alive), torch.stack(kes))

    def _boris(self, s: int):
        """Species s's Boris rotation vectors (T, S), or None (leapfrog)."""
        if not self._acc_boris:
            return None
        return tuple(self._boris_T[s]), tuple(self._boris_S[s])

    def _out_of_margin(self, st: TiledState) -> torch.Tensor:
        lo, hi = -float(self.ts.M), float(self.ts.T + self.ts.M)
        bad = (((st.lpos < lo) | (st.lpos >= hi)).any(dim=1)
               & (st.alive > 0.5))
        return bad.sum().to(torch.int32)

    def _reflect_walls(self, st: TiledState) -> TiledState:
        """Specular reflection at the bounded global walls, on the
        tile-local planes (ops/pusher.reflect's fold per bounded dim).
        Deposits and gathers never cross a bounded wall (the hat weights
        vanish one cell out, and the fold keeps every position in
        [0, L-1]), so the periodic tile machinery needs no other change:
        the wrap planes at a bounded edge only ever carry zeros."""
        origins = tl.tile_origins(self.ts, self.device)        # (NT, D)
        lpos, vel = st.lpos.clone(), st.vel.clone()
        for d, bounded in enumerate(self._bounded_dims):
            if not bounded:
                continue
            hi = float(self.ts.grid[d] - 1)
            org = origins[:, d][None, :, None]                 # (1, NT, 1)
            g = lpos[:, d] + org                               # (S, NT, B)
            period = 2.0 * hi
            g_m = torch.remainder(g, period)
            g_r = torch.where(g_m > hi, period - g_m, g_m)
            flip = torch.remainder(torch.floor(g / hi).to(torch.int32),
                                   2) != 0
            lpos[:, d] = g_r - org
            vel[:, d] = torch.where(flip, -vel[:, d], vel[:, d])
        return TiledState(lpos=lpos, vel=vel, alive=st.alive)

    def _tiled_step(self, st: TiledState):
        """One step of run(): the fused kernel pairs where they serve the
        deck (_use_fused), else pinc_tpu's unfused sequence: drift, the
        walls' reflection, the margin count, the fields (K1 per species,
        K7, solve, E) and the kick (K3)."""
        if self._use_fused:
            return self._tiled_step_fused(st)
        st = TiledState(lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive)
        if not self.spec.periodic:
            st = self._reflect_walls(st)
        n_out = self._out_of_margin(st)
        rho, phi, E = self._fields(st)
        st, ke = self._kick(st, E, half=False)
        return st, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=n_out)

    @property
    def _use_fused(self) -> bool:
        """The fused kernel pairs (K2 deposit_move, K4 gather_kick): the
        periodic pallas route, as in pinc_tpu (bounded walls hook in
        between the drift and the deposit, so those decks take the
        unfused step)."""
        return self._backend == "pallas" and self.spec.periodic

    def _tiled_half_kick(self, st: TiledState):
        rho, phi, E = self._fields(st)
        st, ke = self._kick(st, E, half=True)
        return st, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=torch.zeros((), dtype=torch.int32))

    def _tiled_step_fused(self, st: TiledState):
        """One step: per species drift + margin count + deposit (K2); fold
        (K7), solve, E = -grad(phi), padded E tiles; per species gather +
        kick + KE sum (K4)."""
        S = st.lpos.shape[0]
        tiles = None
        new_lpos = []
        n_out = None
        for s in range(S):
            t, nxyz, n_o = tk.deposit_move(
                st.lpos[s], st.vel[s], st.alive[s], self._charge[s], self.ts,
                mxu_dtype=self._mxu_dtype, order=self._distr_order)
            tiles = t if tiles is None else tiles + t
            new_lpos.append(nxyz)
            n_out = n_o if n_out is None else n_out + n_o
        rho = fk.fold_global(tiles, self.ts).to(self.spec.dtype)
        del tiles
        phi = self.solver(rho)
        E = self._efield(phi)
        ep5 = self._field_tiles(E)
        vels, kes = [], []
        for s in range(S):
            nv, vdot = tk.gather_kick(
                ep5, new_lpos[s], st.vel[s], st.alive[s], self._qm[s],
                self.ts, mxu_dtype=self._mxu_dtype, order=self._acc_order,
                e_ext=self._e_ext, boris=self._boris(s))
            vels.append(nv)
            kes.append(0.5 * self._mass[s] * vdot)
        st = TiledState(lpos=torch.stack(new_lpos), vel=torch.stack(vels),
                        alive=st.alive)
        return st, rho, phi, E, Diagnostics(
            kin_energy=torch.stack(kes),
            pot_energy=potential_energy(rho, phi),
            n_lost=n_out.to(torch.int32))

    # ---------------------------------------------------------------- run
    def _write(self, writer, n: int, st: TiledState, fields, diag, ke, pe):
        """Step n's output and energies to the writer; fields: (rho, phi,
        E).  The StepOutput (and the flat particles, only where the
        population is written) is built only on the steps the writer
        writes."""
        if writer.writes(n):
            writer.write_step(n, StepOutput(
                self.to_particles(st) if writer.write_pop else None,
                *fields, diag))
        writer.write_energy(n, ke, pe)

    def run(self, writer=None, progress_every: int = 10):
        """Half kick (skipped on a resumed run), then the steps up to
        nTimeSteps with the per-species re-bucket schedule (and an early
        re-bucket of every species when particles reach the margin), the
        writer's (io_h5 OutputWriter) callbacks, the methods:debug guards
        and the checkpoints.  Returns the energy histories, the wall time,
        the host time of each step, and the drop and margin counts."""
        t_start = time.monotonic()
        ke_hist, pe_hist = [], []
        if self._resumed:
            st = self.state
        else:
            st, rho, phi, E, diag = self._tiled_half_kick(self.state)
            ke_hist.append(diag.kin_energy.cpu().numpy())
            pe_hist.append(float(diag.pot_energy))
            if writer is not None:
                self._write(writer, 0, st, (rho, phi, E), diag, ke_hist[0],
                            pe_hist[0])
        step_seconds = []
        total_dropped = total_lost = 0
        debug = self.cfg.get_bool("methods:debug", False)
        max_vel = self.cfg.get_double("population:maxvel", 0.0)
        for n in range(self.start_step + 1, self.n_time_steps + 1):
            t0 = time.monotonic()
            st, rho, phi, E, diag = self._tiled_step(st)
            due = [s for s, R in enumerate(self.rebucket_every_s)
                   if n % R == 0]
            lost = int(diag.n_lost)
            if lost:
                msg(WARNING, "step %d: %d particle(s) reached the tile "
                    "margin; re-bucketing early", n, lost)
                due = list(range(st.lpos.shape[0]))
                total_lost += lost
            dropped = 0
            if due:
                st, dropped = self._rebucket(st, species=due)
                if dropped:
                    msg(WARNING, "step %d: %d particle(s) dropped by bucket "
                        "overflow (raise tiles:slack)", n, dropped)
                    total_dropped += dropped
                if dropped or lost:
                    self.retune(st, drops=dropped)
            ke = diag.kin_energy.cpu().numpy()
            pe = float(diag.pot_energy)
            ke_hist.append(ke)
            pe_hist.append(pe)
            if writer is not None:
                self._write(writer, n, st, (rho, phi, E), diag, ke, pe)
            if debug:
                self._assert_invariants_tiled(st, rho, n, max_vel)
            if self.checkpoint_every and n % self.checkpoint_every == 0:
                from . import checkpoint as _ckpt
                _ckpt.save_tiled(self.cfg, n, st, self.tuning())
            step_seconds.append(time.monotonic() - t0)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
        self._sync()
        wall = time.monotonic() - t_start
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.state = st
        if self._capacity * st.lpos.shape[0] <= 32_000_000:
            self.particles = self.to_particles(st)
        if self.checkpoint_every:
            from . import checkpoint as _ckpt
            _ckpt.save_tiled(self.cfg, self.n_time_steps, st, self.tuning())
        return {"kinetic": _stack(ke_hist, st.lpos.shape[0]),
                "potential": np.asarray(pe_hist),
                "wall_time": wall, "step_seconds": np.asarray(step_seconds),
                "dropped": total_dropped, "n_lost": total_lost}

    def _assert_invariants_tiled(self, st: TiledState, rho: torch.Tensor,
                                 n: int, max_vel: float) -> None:
        """methods:debug guards on the tiled state, the invariants of
        Simulation._assert_invariants (pVelAssertMax /
        pPosAssertInLocalFrame / gAssertNeutralGrid,
        src/population.c:316-365, src/grid.c:862-869) without converting
        to the flat layout; raise PincError."""
        alive = st.alive > 0.5                               # (S, NT, B)
        if max_vel > 0.0 and bool(alive.any()):
            vmax = float(st.vel.abs().amax(dim=1)[alive].max())
            if vmax > max_vel:
                msg(ERROR, "step %d: particle speed %g exceeds "
                    "population:maxVel=%g", n, vmax, max_vel)
        lo, hi = -float(self.ts.M), float(self.ts.T + self.ts.M)
        bad = int((((st.lpos < lo) | (st.lpos >= hi)).any(dim=1)
                   & alive).sum())
        if bad:
            msg(ERROR, "step %d: %d particle(s) outside the tile margin "
                "[%g, %g)", n, bad, lo, hi)
        if self.spec.periodic:
            mean = float(rho.double().mean())
            gross = self._gross_density(alive.sum(dim=(1, 2)))
            if abs(mean) > 1e-4 * gross:
                msg(ERROR, "step %d: grid not charge-neutral (mean %g vs "
                    "gross charge density %g)", n, mean, gross)

    # --------------------------------------------------------------- scan
    @property
    def _use_mega(self) -> bool:
        """The mega-fused scan body (K5 pic_step: every species' kick,
        drift and deposit in one kernel a step), where the fused kernels
        serve the deck and tiles:mega is not false.  Scan path only: the
        kick uses the previous step's field, so run() keeps the
        reference's in-step kick ordering."""
        return self._use_fused and self.cfg.get_bool("tiles:mega", True)

    def _rebucket_schedule(self, n: int):
        """step -> species due, from the per-species cadences."""
        events = {}
        for s, R in enumerate(self.rebucket_every_s):
            for k in range(R, n + 1, R):
                events.setdefault(k, []).append(s)
        return events

    def _plan_generic(self, n: int) -> list:
        """The steps and re-bucket events of pinc_tpu's
        _scan_with_rebuckets over n steps, in its order, as a list of
        ("step", None) and ("rebucket", species tuple) items.  Nested
        cadences (at most two, the slow a multiple of the fast, n >= 2
        fast cadences) run fast windows with the fast species re-bucketed
        after each and the slow ones after each slow cycle; the rest
        follows the per-species schedule, which pinc_tpu collapses to
        "every species every fast cadence" when a non-nested schedule has
        more than 64 events (a bound on its program size that changes the
        result; kept for parity)."""
        Rs = list(self.rebucket_every_s)
        distinct = sorted(set(Rs))
        Re, Ri = distinct[0], distinct[-1]
        fast = tuple(s for s, R in enumerate(Rs) if R == Re)
        slow = tuple(s for s, R in enumerate(Rs) if R != Re)
        plan = []
        done = 0
        nested = len(distinct) <= 2 and Ri % Re == 0 and n >= 2 * Re
        if nested:
            window = [("step", None)] * Re + [("rebucket", fast)]
            if slow:
                n_outer = n // Ri
                plan += (window * (Ri // Re) + [("rebucket", slow)]) * n_outer
                done = n_outer * Ri
            n_mid = (n - done) // Re
            plan += window * n_mid
            done += n_mid * Re
        events = {k: v for k, v in self._rebucket_schedule(n).items()
                  if k > done}
        if not nested and len(events) > 64:
            events = {k: list(range(len(Rs)))
                      for k in range(self.rebucket_every, n + 1,
                                     self.rebucket_every) if k > done}
        prev = done
        for k in sorted(set(events) | {n}):
            if k > n:
                break
            if k > prev:
                plan += [("step", None)] * (k - prev)
                prev = k
            plan += [("rebucket", (s,)) for s in events.get(k, [])]
        return plan

    def _mid_margins(self, q: int, slow_full: bool):
        """Per-step margin tuples for fast-window index q since the slow
        species' last re-bucket (fresh entry).  Fast species get the
        per-step schedule (their wander k steps after a re-bucket is
        bounded by k*M/cadence); slow species a per-window constant
        bound; slow_full forces them to the layout margin."""
        M = self.ts.M
        Rs = self.rebucket_every_s
        Re = min(Rs)
        plans = []
        for k in range(Re):
            out = []
            for s, R in enumerate(Rs):
                if R == Re:
                    j = k + 1
                    md = min(M, max(1, math.ceil(j * M / R)))
                    mg = min(M, math.ceil((j - 1) * M / R))
                elif slow_full:
                    mg = md = M
                else:
                    j_end = (q + 1) * Re
                    mg = md = min(M, max(1, math.ceil(j_end * M / R)))
                out.append((mg, md))
            plans.append(tuple(out))
        return tuple(plans)

    def _plan_sched(self, n: int) -> list:
        """pinc_tpu's _scan_sched as a plan: the margin-scheduled windows
        of the mega path ("step" items carry the per-species (mg, md)
        margins), for a state whose species are all freshly re-bucketed.
        Each fast window takes the margins of _mid_margins for its index
        in the slow cycle; what the windows cannot cover (less than one
        fast window, or non-nested cadences) runs _plan_generic at the
        full margin."""
        Rs = list(self.rebucket_every_s)
        Re, Ri = min(Rs), max(Rs)
        fast = tuple(s for s, R in enumerate(Rs) if R == Re)
        slow = tuple(s for s, R in enumerate(Rs) if R != Re)

        def window(plans):
            return [("step", m) for m in plans] + [("rebucket", fast)]
        plan = []
        done = 0
        if slow and Ri % Re == 0:
            cycle = [self._mid_margins(q, slow_full=False)
                     for q in range(Ri // Re)]
            n_cyc = n // Ri
            for _ in range(n_cyc):
                for plans in cycle:
                    plan += window(plans)
                plan.append(("rebucket", slow))
            done = n_cyc * Ri
            mids_left = (n - done) // Re
            for plans in cycle[:mids_left]:
                plan += window(plans)
            done += mids_left * Re
        elif not slow:
            plans = self._mid_margins(0, slow_full=False)
            for _ in range(n // Re):
                plan += window(plans)
            done = n // Re * Re
        if done < n:
            plan += self._plan_generic(n - done)
        return plan

    def _run_plan(self, plan, body, carry):
        """body(carry, margins) -> (carry, out) at each step; the listed
        species of carry[0] re-bucketed in place at each event.  Returns
        (carry, outs, dropped), dropped a 0-d tensor on the device."""
        outs = []
        dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        for kind, arg in plan:
            if kind == "step":
                carry, out = body(carry, arg)
                outs.append(out)
                continue
            st = carry[0]
            for s in arg:
                dropped = dropped + self._rebucket_one(st.lpos[s], st.vel[s],
                                                       st.alive[s])
        return carry, outs, dropped

    @staticmethod
    def _owned(st: TiledState, donate: bool) -> TiledState:
        if donate:
            return st
        return TiledState(lpos=st.lpos.clone(), vel=st.vel.clone(),
                          alive=st.alive.clone())

    def make_scan_steps(self, n: int, donate: bool = False,
                        fresh: bool = False):
        """A window of n steps with the per-species re-bucket schedule
        applied between them.  Returns run_n(st) -> (state, (ke (n, S),
        pe (n,), dropped)), every number left on the device.  With the FFT
        solve the window makes no host sync; an mgSolve deck makes one a
        V-cycle (the multigrid reads its residual on the host to test the
        tolerance).  donate=True lets the window update st's tensors in
        place (st is consumed); with donate=False st is left as it was.
        fresh=True asserts that every species of st is freshly re-bucketed
        (true after the initial bucketing, and after a window whose n is a
        multiple of every cadence): on margin >= 2 decks with n a multiple
        of the fast cadence, the mega path then runs the per-step margin
        schedule.  run_n.plan is the window's sequence of
        steps and re-bucket events."""
        if self._use_mega:
            return self._make_scan_steps_mega(n, donate, fresh)
        plan = self._plan_generic(n)

        def body(carry, margins):
            st, rho, phi, E, diag = self._tiled_step(carry[0])
            return (st,), (diag.kin_energy, diag.pot_energy)

        def run_n(st: TiledState):
            carry, outs, dropped = self._run_plan(
                plan, body, (self._owned(st, donate),))
            return carry[0], _stack_outs(outs, dropped)
        run_n.plan = plan
        return run_n

    def _make_scan_steps_mega(self, n: int, donate: bool = False,
                              fresh: bool = False):
        """The mega-fused window: per step one K5 pic_step (kick with the
        previous step's field, drift, deposit; the state updated in place),
        the K7 fold, the FFT solve and the K6 E tiles, which ride the carry
        to the next step.  The (ke, pe) pair of slot k is centered on step
        k-1: ke of slot k's kick and pe of the previous solve, the
        window-start solve giving the first pe."""
        ts = self.ts
        mass = torch.tensor(self._mass, dtype=torch.float32,
                            device=self.device)
        use_sched = (fresh and self._backend == "pallas" and ts.M >= 2
                     and n % min(self.rebucket_every_s) == 0
                     and self.cfg.get_bool("tiles:marginschedule", True))
        plan = self._plan_sched(n) if use_sched else self._plan_generic(n)

        def solve(rho):
            phi = self.solver(rho)
            return (fk.efield_tiles(phi, ts, out_dtype=self._mxu_dtype),
                    potential_energy(rho, phi))

        def body(carry, margins):
            st, e_tiles, pe_prev = carry
            tiles, _, _, vdot, _ = tk.pic_step(
                e_tiles, st.lpos, st.vel, st.alive, self._charge, self._qm,
                ts, mxu_dtype=self._mxu_dtype, order_acc=self._acc_order,
                order_distr=self._distr_order, e_ext=self._e_ext,
                boris_T=self._boris_T, boris_S=self._boris_S,
                margins=margins, inplace=True)
            rho = fk.fold_global(tiles, ts).to(self.spec.dtype)
            return (st,) + solve(rho), (0.5 * mass * vdot, pe_prev)

        def run_n(st: TiledState):
            st = self._owned(st, donate)
            carry = (st,) + solve(self._deposit_rho(st))
            carry, outs, dropped = self._run_plan(plan, body, carry)
            return carry[0], _stack_outs(outs, dropped)
        run_n.plan = plan
        return run_n


def _stack_outs(outs, dropped):
    """[(ke (S,), pe ())] per step -> (ke (n, S), pe (n,), dropped)."""
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), dropped)
