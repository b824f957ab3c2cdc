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
one bit for bit.

Decks with embedded objects (``objects.py``) take the unfused step with
the object sequence between the drift and the deposit (``_tiled_step_obj``:
drift, walls, margin count, the collision responses and the absorption on
the static subset of tiles near an object, the absorbed charge spread into
``rho_obj``, K1 per species and K7, rho += rho_obj, solve, capacitance,
solve, E, K3 and the kick), in ``run()`` and in the window
(``make_scan_steps`` scans that step with ``rho_obj`` in the carry); they
never run K2, K4 or K5.  The object work is plain PyTorch, as it is plain
``jnp`` in pinc_tpu.
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
from .utils.timer import count, count_device, span, spanned


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

    def __init__(self, cfg: PincConfig, seed: int = 1, device=None,
                 domain: Optional[np.ndarray] = None):
        nd = cfg.get_int("grid:ndims")
        super().__init__(cfg, seed=seed, device=device, domain=domain)
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
        if self.objects is not None:
            self._obj_tiles = self._near_object_tiles()
            self._obj_origins = tl.tile_origins(
                self.ts, self.device)[self._obj_tiles]          # (NTo, D)
            # secondaries emitted, and those that found no free slot, over
            # the object steps (0-d tensors on the device)
            self.see_emitted = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
            self.see_overflow = torch.zeros_like(self.see_emitted)
            msg(STATUS, "tiled objects: %d/%d tiles near object surfaces",
                int(self._obj_tiles.shape[0]), self.ts.NT)

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
               tuning: Optional[dict] = None, rho_obj=None) -> None:
        """Continue from ``state`` (the tile planes verbatim, slot
        assignment included) at step ``step`` with the interrupted run's
        ``tuning()``: run() skips the half kick and runs steps step + 1 ..
        nTimeSteps, the uninterrupted trajectory bit for bit.  What a
        tiled checkpoint restores.  Without ``tuning`` the deck's
        cadences and face cap stand, which is the uninterrupted run only
        where no retune fired before ``step``.  rho_obj: the object deck's
        persistent surface charge at ``step``."""
        self.state, self.start_step, self._resumed = state, step, True
        self.particles = None
        if rho_obj is not None:
            self.rho_obj = torch.as_tensor(rho_obj, device=self.device)
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
    @spanned("pinc.retune")
    def retune(self, st: Optional[TiledState] = None, drops: int = 0) -> bool:
        """Re-estimate the per-species velocity scales from the current
        state and refresh the re-bucket cadences and the exchange face cap
        (called by run() after a drop or a margin hit).  drops: the
        re-bucket drops seen since the last retune; any drop escalates the
        face cap 1.5x, and the per-row gate is evaluated again under the
        new cap.  Returns True if anything changed."""
        st = self.state if st is None else st
        speeds, alive = self._retune_sample(st)
        S = speeds.shape[0]
        M = self.ts.M
        v_s = [0.0] * S
        R_s = list(self.rebucket_every_s)
        for s, p in enumerate(speed_percentiles(speeds, alive)):
            if p is not None:
                v_s[s] = max(p * 1.5, 1e-3)
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
        if changed:
            count("pinc.retunes_changed")
        return changed

    def _retune_sample(self, st: TiledState):
        """retune()'s sample of the state: |vel| (S, D, n, B) and alive
        (S, n, B, bool) of every (NT // 64)-th tile, on the state's
        device."""
        stride = max(1, st.vel.shape[2] // 64)
        return st.vel[:, :, ::stride].abs(), st.alive[:, ::stride] > 0.5

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

    @spanned("pinc.setup.bucket")
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

    @spanned("pinc.setup.bucket")
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

    @spanned("pinc.rebucket")
    def _rebucket_one(self, lpos_s, vel_s, alive_s, ntiles=None,
                      roll_fns=None) -> torch.Tensor:
        """Re-bucket one species in place: lpos_s, vel_s (D, NT, B) and
        alive_s (NT, B) are views of the state.  Returns the drop count,
        a 0-d integer tensor on the state's device (no host sync).
        ntiles, roll_fns: a shard's tile grid and its tile-axis rolls (the
        sharded exchange; default this layout's grid, periodic)."""
        if self._rebucket_mode == "exchange":
            cfg = self.cfg
            _, al, d_n = ex.rebucket_exchange_planes(
                tuple(lpos_s) + tuple(vel_s), alive_s,
                ntiles or self.ts.ntiles, self.ts.T, K=self._exchange_cap,
                roll_fns=roll_fns, rows=self._exchange_rows,
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
        count("pinc.rebuckets", len(species))
        dropped = 0
        for s in species:
            d = self._rebucket_one(st.lpos[s], st.vel[s], st.alive[s])
            with span("pinc.sync.drops"):
                dropped += int(d)
        return st, dropped

    def _rebucket_event(self, st: TiledState, species) -> torch.Tensor:
        """A window's re-bucket event: the listed species in place; the
        drops as a 0-d tensor on the device."""
        count("pinc.rebuckets", len(species))
        dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in species:
            dropped = dropped + self._rebucket_one(st.lpos[s], st.vel[s],
                                                   st.alive[s])
        return dropped

    def _flat_state(self, st: TiledState) -> TiledState:
        """The state as one (S, D, NT, B) layout over the global tile grid
        (the sharded class gathers its shards)."""
        return st

    def _writer_particles(self, st: TiledState) -> Particles:
        """The population as the writer takes it."""
        return self.to_particles(st)

    def to_particles(self, st: TiledState, origins=None) -> Particles:
        """Convert back to the (cell, frac) layout for IO/diagnostics.
        origins: (NT, D) global node of each of st's tiles (default this
        layout's tile grid)."""
        S, D, NT, B = st.lpos.shape
        gp = torch.stack([tl.global_positions(st.lpos[s].permute(1, 2, 0),
                                              self.ts, origins)
                          for s in range(S)])
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
            with span("pinc.sync.charge"):
                q = torch.tensor(self._charge[s], device=self.device)
            value = torch.where(st.alive[s] != 0, q,
                                torch.zeros((), device=self.device))
            t = tk.deposit(st.lpos[s], value, self.ts,
                           mxu_dtype=self._mxu_dtype, order=self._distr_order,
                           vmax=abs(self._charge[s]))
            tiles = t if tiles is None else tiles + t
        return fk.fold_global(tiles, self.ts).to(self.spec.dtype)

    def _fields(self, st: TiledState):
        rho = self._deposit_rho(st)
        with span("pinc.solve"):
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
        periodic pallas route without objects, as in pinc_tpu (bounded
        walls and the object absorption hook in between the drift and the
        deposit, so those decks take the unfused step)."""
        return (self._backend == "pallas" and self.spec.periodic
                and self.objects is None)

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
        with span("pinc.solve"):
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

    # ------------------------------------------------------------ objects
    def _near_object_mask(self) -> np.ndarray:
        """The static subset of tiles that can hold an absorbable
        particle, as a boolean mask over the global tile grid: tiles with
        interior nodes, dilated by one tile (a particle's floor cell stays
        within one tile of its bucket, margin M < T).  The interior lookup
        then runs on those tiles' slots only."""
        interior = self.objects.interior_id.cpu().numpy() > 0
        T, nt = self.ts.T, self.ts.ntiles
        D = len(nt)
        tmask = interior.reshape(sum(((n, T) for n in nt), ())).any(
            axis=tuple(range(1, 2 * D, 2)))
        for ax in range(D):
            tmask = (tmask | np.roll(tmask, 1, axis=ax)
                     | np.roll(tmask, -1, axis=ax))
        return tmask

    def _near_object_tiles(self) -> torch.Tensor:
        """_near_object_mask's tiles: (NTo,) int64 indices on the device."""
        return torch.as_tensor(np.flatnonzero(self._near_object_mask()),
                               dtype=torch.int64, device=self.device)

    def _objects_on(self, device):
        """The object system whose tensors lie on ``device`` (the sharded
        class keeps a copy for each device of its mesh)."""
        return self.objects

    def _collision_type(self, s: int) -> str:
        ct = self.objects.collision_types
        return ct[s] if s < len(ct) else "absorb"

    def _has_adhere(self) -> bool:
        return (self.objects is not None
                and "adhere" in self.objects.collision_types)

    def _has_secondary(self) -> bool:
        return (self.objects is not None
                and "secondary" in self.objects.collision_types)

    def _global_planes(self, lp: torch.Tensor, origins: torch.Tensor):
        """Tile-local planes (D, NTo, B) -> wrapped global positions
        (NTo, B, D)."""
        with span("pinc.sync.global_planes"):
            Lf = torch.tensor(self.ts.grid, dtype=torch.float32,
                              device=lp.device)
        g = torch.remainder(lp + origins.T[:, :, None], Lf[:, None, None])
        return g.movedim(0, -1)

    def _collide_tile_planes(self, lp, vl, al, origins, method, valid=None):
        """reflect/backscatter on the near-object tile planes: lp/vl (D,
        NTo, B) tile-local, origins (NTo, D) the tiles' global origins.
        Positions move by the wrapped displacement, so tile-local
        coordinates stay near their bucket where the global position
        wrapped.  Returns (lp', vl')."""
        from .objects import collide_segments
        obj = self._objects_on(lp.device)
        pos, vel, _, hit, _ = self._hits_tile_planes(lp, vl, al, origins,
                                                     valid, tunnel=False)
        pos2, vel2, _ = collide_segments(pos, vel, hit, obj.interior_id,
                                         obj.normals, self.ts.grid, method)
        Lf = torch.tensor(self.ts.grid, dtype=torch.float32,
                          device=lp.device)
        delta = torch.remainder(pos2 - pos + 0.5 * Lf, Lf) - 0.5 * Lf
        return lp + delta.movedim(-1, 0), vel2.movedim(-1, 0)

    def _hits_tile_planes(self, lp, vl, al, origins, valid=None,
                          tunnel: bool = True):
        """The hit classification on near-object tile planes: (pos (NTo,
        B, D) global wrapped, vel, oid, hit, tunneled); ``tunneled`` marks
        hits whose segment start was interior too (no crossing to bisect,
        the flat path's failure class; None when tunnel=False)."""
        from .objects import _at, _cell_of
        obj = self._objects_on(lp.device)
        pos = self._global_planes(lp, origins)
        vel = vl.movedim(0, -1)
        oid = _at(obj.interior_id, _cell_of(pos, self.ts.grid))
        hit = (al > 0.5) & (oid > 0)
        if valid is not None:
            hit = hit & valid
        tunneled = hit & obj._interior_at(pos - vel) if tunnel else None
        return pos, vel, oid, hit, tunneled

    def _adhere_tiles(self, s, lp, vl, al, origins, rho_add, valid=None):
        """Tiled pAdhere: impactors die at their trajectory-surface
        crossing and their charge goes to the nearest surface node (the
        flat _adhere on the near-object tile planes); tunneled hits stay
        alive for the absorb.  Returns (alive', rho_add', a flat (V,)
        localized charge)."""
        from .objects import intersect_segments
        obj = self._objects_on(lp.device)
        pos, vel, _, hit, tunneled = self._hits_tile_planes(
            lp, vl, al, origins, valid)
        ok = hit & ~tunneled
        _, x_int, _ = intersect_segments(pos, vel, obj.interior_id,
                                         obj.normals, self.ts.grid)
        flat_idx = obj._nearest_surface_flat(x_int)
        zero = torch.zeros((), device=al.device)
        rho_add.index_add_(0, flat_idx.reshape(-1),
                           torch.where(ok, self._charge[s], zero).reshape(-1))
        return torch.where(ok, zero, al), rho_add

    def _emit_secondaries_tiles(self, s, lp, vl, al, lp_t, vl_t, al_t,
                                origins, valid=None):
        """Tiled pSecondaryElectron: see_yield cosine-distributed
        secondaries an impact into free (dead) slots of the target
        species' bucket of the same tile, dead slots in slot order (a
        stable sort); a secondary with no free slot is dropped.  The
        impactor is left interior for the absorb.  Emission points lie
        within a cell of the impactor, inside the wander margin (the
        margin count catches a rare overshoot).  Returns (lp_t', vl_t',
        al_t', emission counts per object (n_objects,), the count of
        secondaries that found no free slot)."""
        from .objects import (_hash_uniform, _mul32, cosine_directions,
                              intersect_segments, u32_bits)
        obj = self._objects_on(lp.device)
        D = self.ts.n_dims
        dev = lp.device
        Lf = torch.tensor(self.ts.grid, dtype=torch.float32, device=dev)
        pos, vel, oid, hit, tunneled = self._hits_tile_planes(
            lp, vl, al, origins, valid)
        hit = hit & ~tunneled
        _, x_int, nrm = intersect_segments(pos, vel, obj.interior_id,
                                           obj.normals, self.ts.grid)
        x_emit = x_int + 0.01 * nrm
        x_emit = (torch.remainder(x_emit, Lf) if obj.periodic
                  else torch.minimum(torch.clamp(x_emit, min=0.0),
                                     Lf - 1e-3))
        # tile-local emission coordinates: the impactor's plus the wrapped
        # displacement
        delta = torch.remainder(x_emit - pos + 0.5 * Lf, Lf) - 0.5 * Lf
        lpe = lp + delta.movedim(-1, 0)                   # (D, NTo, B)
        NTo, B = al.shape
        rows = torch.arange(NTo, device=dev)[:, None]
        order = torch.argsort(al_t, dim=-1, stable=True)  # dead first
        n_dead = torch.sum(al_t < 0.5, dim=-1, keepdim=True)
        rank = torch.cumsum(hit.to(torch.int64), dim=-1) - 1
        bits = (torch.arange(NTo * B, dtype=torch.int64,
                             device=dev).reshape(NTo, B) ^ u32_bits(vl[0]))
        # column B of each plane is the drop column, cut off at the end
        lp_t = torch.cat([lp_t, lp_t[..., :1]], dim=-1)
        vl_t = torch.cat([vl_t, vl_t[..., :1]], dim=-1)
        al_t = torch.cat([al_t, al_t[..., :1]], dim=-1)
        n_emit = torch.zeros(obj.n_objects, device=dev)
        n_over = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(obj.see_yield):
            u1 = _hash_uniform(bits + (2 * k + 1))
            u2 = _hash_uniform(_mul32(bits, 0x9E3779B1) + k)
            v_e = obj.see_vth * cosine_directions(nrm, u1, u2)
            grank = rank * obj.see_yield + k
            ok = hit & (grank >= 0) & (grank < n_dead)
            n_over = n_over + (hit & (grank >= n_dead)).sum()
            slot = torch.where(
                ok, torch.gather(order, -1, torch.clamp(grank, 0, B - 1)),
                torch.full_like(grank, B))
            al_t[rows, slot] = 1.0
            for d in range(D):
                lp_t[d][rows, slot] = lpe[d]
                vl_t[d][rows, slot] = v_e[..., d].to(vl_t.dtype)
            n_emit = n_emit + obj.object_counter(
                torch.where(ok, oid, 0), ok.float())
        return lp_t[..., :B], vl_t[..., :B], al_t[..., :B], n_emit, n_over

    @spanned("pinc.objects")
    def _absorb(self, st: TiledState, collide: bool = True):
        """_absorb_tiles on this layout's near-object tiles, the emitted
        and unplaced secondaries added to see_emitted and see_overflow.
        Returns (st, the absorbed charge per object (n_objects,), the
        adhered charge: flat (V,) or None)."""
        st, counter, rho_add, emitted, overflow = self._absorb_tiles(
            st, self._obj_tiles, self._obj_origins, self.device, collide)
        if emitted is not None:
            self.see_emitted = self.see_emitted + emitted
            self.see_overflow = self.see_overflow + overflow
        return st, counter, rho_add

    def _absorb_tiles(self, st: TiledState, idx: torch.Tensor,
                      origins: torch.Tensor, device: torch.device,
                      collide: bool = True):
        """Object absorption on the tiles idx (NTo,) of st, whose global
        origins are origins (NTo, D), everything on ``device`` (the
        particle half of oCollectObjectCharge, src/object.c:460-515), after
        the per-species collision responses the deck selects
        (objects:collisionType).  collide=False is the initial cull
        (src/main.c:161-166): interior particles are removed, no response.
        Updates st's planes in place and nothing of self.  Returns (st, the
        absorbed charge per object (n_objects,), the adhered charge: flat
        (V,) or None, the secondaries emitted and those that found no free
        slot: 0-d int64 tensors, or None on a deck without secondaries)."""
        obj = self._objects_on(device)
        counter = torch.zeros(obj.n_objects, device=device)
        rho_add = (torch.zeros(self.spec.global_volume, device=device)
                   if collide and self._has_adhere() else None)
        emitted = overflow = None
        if collide and self._has_secondary():
            emitted = torch.zeros((), dtype=torch.int64, device=device)
            overflow = torch.zeros_like(emitted)
        lpos, vel, alive = st.lpos, st.vel, st.alive
        for s in range(lpos.shape[0]):
            lp = lpos[s][:, idx]                          # (D, NTo, B)
            al = alive[s][idx]                            # (NTo, B) f32
            m = self._collision_type(s) if collide else "absorb"
            if m in ("reflect", "backscatter"):
                lp, vl = self._collide_tile_planes(lp, vel[s][:, idx], al,
                                                   origins, m)
                lpos[s][:, idx] = lp
                vel[s][:, idx] = vl
            elif m == "adhere":
                al, rho_add = self._adhere_tiles(s, lp, vel[s][:, idx], al,
                                                 origins, rho_add)
            elif m == "secondary":
                tgt = obj.see_species
                (lp_t, vl_t, al_t, n_emit,
                 n_over) = self._emit_secondaries_tiles(
                    s, lp, vel[s][:, idx], al, lpos[tgt][:, idx],
                    vel[tgt][:, idx], alive[tgt][idx], origins)
                emitted = emitted + n_emit.sum().to(torch.int64)
                overflow = overflow + n_over
                lpos[tgt][:, idx] = lp_t
                vel[tgt][:, idx] = vl_t
                alive[tgt][idx] = al_t
                # the emitted charge debited from the impacted surface
                # (uniform spread, as the flat path books it)
                counter = counter - self._charge[tgt] * n_emit
                if tgt == s:        # emission changed this species' planes
                    lp, al = lpos[s][:, idx], alive[s][idx]
            from .objects import _at, _cell_of
            oid = _at(obj.interior_id,
                      _cell_of(self._global_planes(lp, origins),
                               self.ts.grid))
            absorbed = (al > 0.5) & (oid > 0)
            counter = counter + obj.object_counter(
                torch.where(absorbed, oid, 0),
                torch.full_like(al, self._charge[s]))
            alive[s][idx] = torch.where(absorbed, torch.zeros_like(al), al)
        return st, counter, rho_add, emitted, overflow

    def _spread_obj_charge(self, rho_obj: torch.Tensor,
                           counter: torch.Tensor) -> torch.Tensor:
        """The absorbed charge per object spread over its surface nodes
        (the grid half of oCollectObjectCharge)."""
        obj = self.objects
        return obj._spread(rho_obj.reshape(-1).clone(),
                           counter).reshape(obj.shape)

    def _tiled_step_obj(self, st: TiledState, rho_obj: torch.Tensor):
        """One step with the object sequence (collect, deposit, rho +=
        rho_obj, solve, capacitance, solve: src/main.c:222-240) on the
        tiled layout: the drift, the walls, the margin count, the
        responses and absorption (_absorb), K1 per species and K7, the
        fields (Simulation._object_fields) and the kick (K3).  Returns
        (st, rho, phi, E, diag, rho_obj, phi_c per object)."""
        st = TiledState(lpos=st.lpos + st.vel, vel=st.vel, alive=st.alive)
        if not self.spec.periodic:
            st = self._reflect_walls(st)
        n_out = self._out_of_margin(st)
        st, counter, rho_add = self._absorb(st)
        rho_obj = self._spread_obj_charge(rho_obj, counter)
        if rho_add is not None:
            rho_obj = rho_obj + rho_add.reshape(self.objects.shape)
        rho, phi, E, obj_phi = self._object_fields(self._deposit_rho(st),
                                                   rho_obj)
        st, ke = self._kick(st, E, half=False)
        return (st, rho, phi, E, Diagnostics(
            kin_energy=ke, pot_energy=potential_energy(rho, phi),
            n_lost=n_out), rho_obj, obj_phi)

    def _tiled_half_kick_obj(self, st: TiledState):
        """Initialization with objects: cull the interior particles (their
        charge discarded, src/main.c:161-166), then the half kick."""
        st, _, _ = self._absorb(st, collide=False)
        return self._tiled_half_kick(st)

    # ---------------------------------------------------------------- run
    def _write(self, writer, n: int, st: TiledState, fields, diag, ke, pe,
               rho_obj=None, obj_phi=None):
        """Step n's output and energies to the writer; fields: (rho, phi,
        E).  The StepOutput (and the flat particles, only where the
        population is written) is built only on the steps the writer
        writes."""
        if writer.writes(n):
            writer.write_step(n, StepOutput(
                self._writer_particles(st) if writer.write_pop else None,
                *fields, diag, rho_obj=rho_obj, obj_potential=obj_phi))
        writer.write_energy(n, ke, pe)

    def run(self, writer=None, progress_every: int = 10):
        """Half kick (skipped on a resumed run), then the steps up to
        nTimeSteps with the per-species re-bucket schedule (and an early
        re-bucket of every species when particles reach the margin), the
        writer's (io_h5 OutputWriter) callbacks, the methods:debug guards
        and the checkpoints.  Returns the energy histories, the wall time,
        the host time of each step, and the drop and margin counts.  On an
        object deck each step is _tiled_step_obj, rho_obj rides from step
        to step, and the run leaves last_rho_obj and last_obj_potential
        (numpy) behind."""
        t_start = time.monotonic()
        ke_hist, pe_hist = [], []
        objects = self.objects is not None
        obj_phi = None
        if self._resumed:
            st = self.state
            rho_obj = self.rho_obj
        else:
            rho_obj = self._zeros() if objects else None
            st, rho, phi, E, diag = (
                self._tiled_half_kick_obj(self.state) if objects
                else self._tiled_half_kick(self.state))
            ke_hist.append(diag.kin_energy.cpu().numpy())
            pe_hist.append(float(diag.pot_energy))
            if writer is not None:
                self._write(writer, 0, st, (rho, phi, E), diag, ke_hist[0],
                            pe_hist[0], rho_obj)
        step_seconds = []
        total_dropped = total_lost = 0
        debug = self.cfg.get_bool("methods:debug", False)
        max_vel = self.cfg.get_double("population:maxvel", 0.0)
        for n in range(self.start_step + 1, self.n_time_steps + 1):
            with span("pinc.step"):
                t0 = time.monotonic()
                if objects:
                    (st, rho, phi, E, diag, rho_obj,
                     obj_phi) = self._tiled_step_obj(st, rho_obj)
                else:
                    st, rho, phi, E, diag = self._tiled_step(st)
                due = [s for s, R in enumerate(self.rebucket_every_s)
                       if n % R == 0]
                with span("pinc.sync.margin"):
                    lost = int(diag.n_lost)
                if lost:
                    count("pinc.margin_hits")
                    msg(WARNING, "step %d: %d particle(s) reached the tile "
                        "margin; re-bucketing early", n, lost)
                    due = list(range(len(self._charge)))
                    total_lost += lost
                dropped = 0
                if due:
                    st, dropped = self._rebucket(st, species=due)
                    if dropped:
                        msg(WARNING, "step %d: %d particle(s) dropped by "
                            "bucket overflow (raise tiles:slack)", n,
                            dropped)
                        total_dropped += dropped
                    if dropped or lost:
                        self.retune(st, drops=dropped)
                with span("pinc.sync.energy"):
                    ke = diag.kin_energy.cpu().numpy()
                    pe = float(diag.pot_energy)
                ke_hist.append(ke)
                pe_hist.append(pe)
                if writer is not None:
                    self._write(writer, n, st, (rho, phi, E), diag, ke, pe,
                                rho_obj, obj_phi)
                if debug:
                    self._assert_invariants_tiled(st, rho, n, max_vel)
                if self.checkpoint_every and n % self.checkpoint_every == 0:
                    from . import checkpoint as _ckpt
                    _ckpt.save_tiled(self.cfg, n, self._flat_state(st),
                                     self.tuning(), rho_obj)
                step_seconds.append(time.monotonic() - t0)
            if progress_every and n % progress_every == 0:
                msg(STATUS, "Computing time-step %i (KE=%g PE=%g)",
                    n, ke.sum(), pe)
        self._sync()
        wall = time.monotonic() - t_start
        msg(TIMER, "Time spent: %f s (%d steps)", wall, self.n_time_steps)
        self.state = st
        S = len(self._charge)
        if self._capacity * S <= 32_000_000:
            self.particles = self.to_particles(st)
        if objects:
            self.rho_obj = rho_obj
            self.last_rho_obj = rho_obj.cpu().numpy()
            self.last_obj_potential = (None if obj_phi is None
                                       else obj_phi.cpu().numpy())
        if self.checkpoint_every:
            from . import checkpoint as _ckpt
            _ckpt.save_tiled(self.cfg, self.n_time_steps,
                             self._flat_state(st), self.tuning(), rho_obj)
        return {"kinetic": _stack(ke_hist, S),
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
        if self.spec.periodic and self.objects is None:
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
            dropped = dropped + self._rebucket_event(carry[0], arg)
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
        steps and re-bucket events.  On an object deck, see
        _make_scan_steps_obj."""
        if self.objects is not None:
            return self._make_scan_steps_obj(n, donate)
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

    def _make_scan_steps_obj(self, n: int, donate: bool = False):
        """The window of an object deck: _tiled_step_obj a step (the whole
        object sequence), rho_obj in the carry, the per-species re-bucket
        schedule of _plan_generic.  Returns run_n(st, rho_obj=None) ->
        ((state, rho_obj), (ke (n, S), pe (n,), dropped, phi_c (n,
        n_objects))), every number on the device; rho_obj None starts
        from zero charge."""
        plan = self._plan_generic(n)

        def body(carry, margins):
            (st, rho, phi, E, diag, rho_obj,
             obj_phi) = self._tiled_step_obj(*carry)
            return (st, rho_obj), (diag.kin_energy, diag.pot_energy, obj_phi)

        def run_n(st: TiledState, rho_obj=None):
            if rho_obj is None:
                rho_obj = self._zeros()
            carry, outs, dropped = self._run_plan(
                plan, body, (self._owned(st, donate), rho_obj))
            ke, pe, dropped = _stack_outs(outs, dropped)
            return carry, (ke, pe, dropped,
                           torch.stack([o[2] for o in outs]))
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
            with span("pinc.solve"):
                phi = self.solver(rho)
            return (fk.efield_tiles(phi, ts, out_dtype=self._mxu_dtype),
                    potential_energy(rho, phi))

        def body(carry, margins):
            st, e_tiles, pe_prev = carry
            tiles, _, _, vdot, n_out = tk.pic_step(
                e_tiles, st.lpos, st.vel, st.alive, self._charge, self._qm,
                ts, mxu_dtype=self._mxu_dtype, order_acc=self._acc_order,
                order_distr=self._distr_order, e_ext=self._e_ext,
                boris_T=self._boris_T, boris_S=self._boris_S,
                margins=margins, inplace=True)
            count_device("pinc.past_margin", n_out)
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


# np.percentile(x, 99.9)'s quantile as numpy forms it for float32 data
_Q999 = np.asanyarray(np.true_divide(99.9, np.float32(100)))


def _q999_index(n: int) -> Tuple[int, np.ndarray]:
    """np.percentile's previous index (-1: the maximum) and its gamma for
    the 99.9th percentile of n > 0 values, in numpy's own arithmetic."""
    vi = (n - 1) * _Q999
    i = -1 if vi >= n - 1 else int(np.floor(vi))
    return i, np.asanyarray(vi - np.asanyarray(i, dtype=np.intp),
                            dtype=vi.dtype)


def speed_percentiles(speeds: torch.Tensor, alive: torch.Tensor) -> list:
    """Per species s the 99.9th percentile of the alive speeds,
    ``np.percentile(speeds[s][:, alive[s]], 99.9)`` bit for bit, or None
    where no slot is alive.  speeds: (S, D, ...) float, alive: (S, ...)
    bool.  The upper tail is selected on the speeds' device (dead slots
    below every speed); the host gets the alive counts, then the two
    order statistics about numpy's virtual index and the maximum, and
    finishes with numpy's linear rule."""
    S, D = speeds.shape[:2]
    x = torch.where(alive[:, None], speeds, -1.0).reshape(S, -1)
    # holds rank n - 1 - floor((n - 1) * 0.999) from the top for all n <= N
    k = min(x.shape[1], x.shape[1] // 500 + 8)
    top = torch.topk(x, k, dim=1).values
    with span("pinc.sync.retune_sample"):
        n = (alive.reshape(S, -1).sum(1) * D).cpu().tolist()
        idx = [_q999_index(m) if m else (-1, None) for m in n]
        pos = [[0 if i < 0 else m - 1 - i, 0 if i < 0 else m - 2 - i, 0]
               for m, (i, _) in zip(n, idx)]
        ab = top.gather(1, torch.tensor(pos, device=top.device)).cpu()
    count("pinc.retune_host_bytes", 8 * S + ab.numel() * ab.element_size())
    out = []
    for m, (_, g), (a, b, top1) in zip(n, idx, ab.numpy()):
        if not m:
            out.append(None)
        elif np.isnan(top1):
            out.append(float(top1))
        else:
            d = b - a
            out.append(float(b - d * (1 - g) if g >= 0.5 else a + d * g))
    return out
