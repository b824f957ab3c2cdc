"""Sharded x tiled: the tiled layout over a device mesh (the counterpart of
``pinc_tpu/parallel/tiled_pic.py``).

Tiles are already a spatial decomposition, so the mesh partitions the tile
grid: each shard holds the tiles of its block as its own (S, D, NT_local,
B) TiledState, and every inter-tile wrap that the single-device path
makes with a periodic roll along a tile axis fetches, at a shard boundary,
one plane from the neighbouring shard (``parallel.halo.shifted_tiles``):

* the deposition overlap-add fold -> ``ops.tiled.fold_to_global(roll_fns=)``
* the field tile padding            -> ``ops.tiled.pad_tiles(roll_fns=)``
  (``pad_tiles_cmajor`` for the mega body's E tiles)
* the re-bucket's neighbour moves   -> ``ops.exchange.rebucket_exchange_planes
  (roll_fns=)``, the gather (K8-K10) or the one-hot (K11) exchange

This mirrors the reference's communication: gHaloOp's per-dimension
Sendrecv sweeps (src/grid.c:340-406) and puMigrate's neighbour payload
exchange (src/pusher.c:914-1035).  Each shard's part runs in its thread
of ``MeshCtx.shard_map`` and launches the tiled kernels at the local
shapes (``ts_local``): K2 and K4 in ``run()``'s step, K1 and K3 in the
half kick and on walled decks, K5 in the window's mega body, K8-K11 in the
re-bucket.  The fold and the padding are plain tensor ops plus halo
planes, as ``pinc_tpu``'s are XLA there: K6 and K7 stay the
single-device path's kernels.  The solve and E = -grad(phi) are those of
``parallel/pic.py``.

Embedded objects (``pinc_tpu/parallel/tiled_pic.py:96-128``, ``:365-530``):
the single-device near-object tile mask is cut per mesh block, and each
local shard keeps its own tiles' local indices and global origins on its
device (no padding to a common count).  A shard's part of the object step
(``_pipeline_obj``) is the drift, the walls, the margin count, the
responses and the absorption on its near-object tiles
(``TiledSimulation._absorb_tiles``, the single-device body) and K1 per
species with the halo fold; the absorbed charge, the adhered charge and
the secondary counts are summed over the mesh.  Then ``rho_obj`` (one
global tensor, replicated on every process), the two solves and the
capacitance run on the sharded fields (``pic.solve_object_fields``), and
``_local_kick`` kicks.  ``run()`` and the window are the base class's.

Over several processes (``utils/multihost.py``) ``state`` holds this
process's shards (None for the others).  Every host decision of the base
class's run reads a value summed or gathered over the mesh, the same on
every process: the margin count and the drops (``psum``), ``retune()``'s
sample (``_retune_sample``, from every process), the guards
(``_flat_state``, gathered).  The writer gets this process's shards'
particles (``_writer_particles``) and the gathered fields; a checkpoint
the gathered state.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import numpy as np
import torch

from ..config import PincConfig
from ..grid import GridSpec
from ..ops import tiled as tl
from ..ops import tiled_kernels as tk
from ..simulation import Diagnostics
from ..tiled_sim import TiledSimulation, TiledState, _stack_outs
from ..utils import multihost as mh
from ..utils.logging import STATUS, msg
from ..utils.timer import count, span
from .halo import shifted_tiles
from .mesh import current_shard, make_mesh, subdomain_offset
from .pic import _column, object_copies, solve_fields, solve_object_fields


class ShardedTiledSimulation(TiledSimulation):
    """Tiled layout over a grid:nSubdomains device mesh; ``state`` is the
    list of per-shard TiledStates in mesh order.  domain: Simulation's
    in-memory object-id grid."""

    def __init__(self, cfg: PincConfig, seed: int = 1, devices=None,
                 domain: Optional[np.ndarray] = None):
        spec = GridSpec.from_config(cfg)
        ctx = make_mesh(spec.n_subdomains, spec.true_size, devices=devices)
        super().__init__(cfg, seed=seed, device=ctx.devices[ctx.local[0]],
                         domain=domain)
        if self._rebucket_mode != "exchange":
            raise ValueError(
                "the sharded tiled path supports tiles:rebucket=exchange "
                "only (a per-device sort cannot re-home cross-device "
                "migrants); drop the tiles:rebucket override or use a "
                "single device")
        self.ctx = ctx
        for t, n in zip(ctx.true_size, ctx.n_subdomains):
            if n > 1 and t % self.ts.T != 0:
                raise ValueError(
                    f"local grid extent {t} not divisible by tile "
                    f"{self.ts.T}")
        self.ts_local = tl.TileSpec(grid=ctx.true_size, T=self.ts.T,
                                    M=self.ts.M, B=self.ts.B)
        self.state = self._shard_state(self.state)
        from .pencil_fft import make_sharded_solver
        self._solve = make_sharded_solver(self.solver, ctx, cfg,
                                          self.spec.dtype)
        self._objs = object_copies(self)
        if self.objects is not None:
            # each shard's near-object tiles: the single-device mask cut per
            # mesh block, local tile indices and global origins on its device
            mask = self._near_object_mask()
            org = tl.tile_origins(self.ts_local)
            self._shard_obj_tiles = [None] * ctx.n_devices
            for i in ctx.local:
                dev = ctx.devices[i]
                idx = torch.as_tensor(
                    np.flatnonzero(mask[self._tile_block(i)]),
                    dtype=torch.int64)
                off = torch.tensor(subdomain_offset(ctx, i),
                                   dtype=torch.float32)
                self._shard_obj_tiles[i] = (idx.to(dev),
                                            (org[idx] + off).to(dev))
            msg(STATUS, "sharded tiled objects: near-object tiles per shard "
                "%s", [int(mask[self._tile_block(i)].sum())
                       for i in range(ctx.n_devices)])
        msg(STATUS, "sharded tiled layout: %s device mesh over %s tiles",
            ctx.n_subdomains, self.ts.ntiles)

    # ---------------------------------------------------------- placement
    def _tile_block(self, i: int):
        """Shard i's block of the global tile grid, as slices."""
        lnt = self.ts_local.ntiles
        return tuple(slice(c * n, (c + 1) * n)
                     for c, n in zip(self.ctx.coords(i), lnt))

    def _shard_state(self, st: TiledState) -> List[TiledState]:
        """(S, D, NT, B) global state -> the shards' states: each of this
        process's shards' cuboid of the (x-major) tile grid, copied onto
        its device (None for another process's shards)."""
        S, D, _, B = st.lpos.shape
        gnt, NTl = self.ts.ntiles, self.ts_local.NT
        out: List[Optional[TiledState]] = [None] * self.ctx.n_devices
        for i in self.ctx.local:
            dev = self.ctx.devices[i]
            blk = self._tile_block(i)

            def cut(a, lead):
                g = a.reshape(lead + gnt + (B,))
                sl = (slice(None),) * len(lead) + blk
                return g[sl].reshape(lead + (NTl, B)).to(
                    dev, copy=True).contiguous()
            out[i] = TiledState(lpos=cut(st.lpos, (S, D)),
                                vel=cut(st.vel, (S, D)),
                                alive=cut(st.alive, (S,)))
        return out

    def _flat_state(self, st: List[TiledState]) -> TiledState:
        """The shards' states as one global (S, D, NT, B) state on this
        process's first device, on every process (the inverse of
        _shard_state)."""
        st = self.ctx.complete(st)
        S, D, _, B = st[0].lpos.shape
        gnt, lnt = self.ts.ntiles, self.ts_local.ntiles
        dev = self.ctx.devices[self.ctx.local[0]]

        def put(name, lead):
            g = torch.empty(lead + gnt + (B,), dtype=torch.float32,
                            device=dev)
            for i, s in enumerate(st):
                g[(slice(None),) * len(lead) + self._tile_block(i)].copy_(
                    getattr(s, name).reshape(lead + lnt + (B,)))
            return g.reshape(lead + (self.ts.NT, B))
        return TiledState(lpos=put("lpos", (S, D)), vel=put("vel", (S, D)),
                          alive=put("alive", (S,)))

    def _roll_fns(self):
        """Per-dim tile-axis wrap: a plane from the neighbouring shard."""
        ctx = self.ctx
        return [(lambda a, s, ax, d=d: shifted_tiles(a, ax, s, ctx, d))
                for d in range(len(ctx.axes))]

    # -------------------------------------------------------- local parts
    def _local_fields(self, stl: TiledState) -> torch.Tensor:
        """Per shard: K1 a species on the local tiles, the padded blocks
        summed and folded once with the neighbours' halo planes."""
        ln = self.ts_local
        dev = stl.lpos.device
        tiles = None
        for s in range(stl.lpos.shape[0]):
            value = torch.where(stl.alive[s] != 0,
                                torch.tensor(self._charge[s], device=dev),
                                torch.zeros((), device=dev))
            t = tk.deposit(stl.lpos[s], value, ln, mxu_dtype=self._mxu_dtype,
                           order=self._distr_order,
                           vmax=abs(self._charge[s]))
            tiles = t if tiles is None else tiles + t
        rho = tl.fold_to_global(tiles, ln, roll_fns=self._roll_fns())
        return rho.to(self.spec.dtype)

    def _local_move_fields(self, stl: TiledState):
        """Per shard: K2 a species (drift, margin count, deposit), the fold
        with the neighbours' halo planes."""
        ln = self.ts_local
        tiles, lposs, n_out = None, [], None
        for s in range(stl.lpos.shape[0]):
            t, nxyz, n_o = tk.deposit_move(
                stl.lpos[s], stl.vel[s], stl.alive[s], self._charge[s], ln,
                mxu_dtype=self._mxu_dtype, order=self._distr_order)
            tiles = t if tiles is None else tiles + t
            lposs.append(nxyz)
            n_out = n_o if n_out is None else n_out + n_o
        st2 = TiledState(lpos=torch.stack(lposs), vel=stl.vel,
                         alive=stl.alive)
        rho = tl.fold_to_global(tiles, ln, roll_fns=self._roll_fns())
        return st2, rho.to(self.spec.dtype), n_out

    def _local_kick(self, stl: TiledState, E_local: torch.Tensor,
                    half: bool):
        """Per shard: the padded E tiles (the neighbours' halo planes), then
        K4 a species for a full kick on the pallas route, else K3 and the
        kick of tk.kick_planes (Boris, external E); the KE summed over the
        mesh."""
        ln = self.ts_local
        E_pad = tl.pad_tiles(E_local, ln,
                             roll_fns=self._roll_fns()).float().contiguous()
        e_scale = 0.5 if half else 1.0
        if half:
            E_pad = 0.5 * E_pad
        S, D = stl.lpos.shape[:2]
        vels, kes = [], []
        for s in range(S):
            if self._backend == "pallas" and not half:
                nv, vdot = tk.gather_kick(
                    E_pad, stl.lpos[s], stl.vel[s], stl.alive[s],
                    self._qm[s], ln, mxu_dtype=self._mxu_dtype,
                    order=self._acc_order, e_ext=self._e_ext,
                    boris=self._boris(s))
                vels.append(nv)
                kes.append(0.5 * self._mass[s] * vdot)
                continue
            Ep = tk.gather(E_pad, stl.lpos[s], ln, mxu_dtype=self._mxu_dtype,
                           order=self._acc_order)
            Ecs = [Ep[c] if self._e_ext is None
                   else Ep[c] + e_scale * self._e_ext[c] for c in range(D)]
            v = stl.vel[s]
            outs, v_dot = tk.kick_planes([v[c] for c in range(D)], Ecs,
                                         self._qm[s], self._boris(s))
            alive = stl.alive[s] != 0
            v_dot = torch.where(alive, v_dot, torch.zeros_like(v_dot))
            kes.append(0.5 * self._mass[s] * torch.sum(v_dot))
            vels.append(torch.where(alive[None], torch.stack(outs), v))
        st2 = TiledState(lpos=stl.lpos, vel=torch.stack(vels),
                         alive=stl.alive)
        return st2, self.ctx.psum(torch.stack(kes))

    def _local_reflect(self, stl: TiledState) -> TiledState:
        """Specular reflection at the bounded global walls on a shard's
        tile-local planes: TiledSimulation._reflect_walls with the shard's
        global origin added.  The fold keeps every position in [0, L-1] and
        CIC hat weights vanish one cell out, so the periodic tile wraps
        carry only zeros at bounded walls."""
        ln = self.ts_local
        dev = stl.lpos.device
        origins = tl.tile_origins(ln, dev)                   # (NTl, D) local
        off = [c * t for c, t in zip(self.ctx.coords(), self.ctx.true_size)]
        lpos, vel = stl.lpos.clone(), stl.vel.clone()
        for d, bounded in enumerate(self._bounded_dims):
            if not bounded:
                continue
            hi = float(self.ts.grid[d] - 1)
            org = origins[:, d][None, :, None] + float(off[d])
            g = lpos[:, d] + org
            period = 2.0 * hi
            g_m = torch.remainder(g, period)
            g_r = torch.where(g_m > hi, period - g_m, g_m)
            flip = torch.remainder(torch.floor(g / hi).to(torch.int32),
                                   2) != 0
            lpos[:, d] = g_r - org
            vel[:, d] = torch.where(flip, -vel[:, d], vel[:, d])
        return TiledState(lpos=lpos, vel=vel, alive=stl.alive)

    def _objects_on(self, device):
        return self._objs[device]

    def _local_absorb_tiled(self, stl: TiledState, collide: bool = True):
        """Per shard: _absorb_tiles on the shard's near-object tiles;
        the absorbed charge per object, the adhered charge (flat (V,), or
        None) and the secondaries' (emitted, unplaced) counts (or None)
        summed over the mesh.  Changes nothing of self."""
        idx, origins = self._shard_obj_tiles[current_shard()]
        stl, counter, rho_add, emitted, overflow = self._absorb_tiles(
            stl, idx, origins, stl.lpos.device, collide)
        psum = self.ctx.psum
        return (stl, psum(counter),
                None if rho_add is None else psum(rho_add),
                None if emitted is None
                else psum(torch.stack([emitted, overflow])))

    def _local_rebucket(self, stl: TiledState, species):
        """Per shard: the exchange re-bucket of the listed species on the
        local tile grid, in place; only the buffer wraps cross shards.
        Returns (state, the drops summed over the mesh)."""
        rolls = self._roll_fns()
        dropped = torch.zeros((), dtype=torch.int64, device=stl.lpos.device)
        for s in species:
            dropped = dropped + self._rebucket_one(
                stl.lpos[s], stl.vel[s], stl.alive[s],
                ntiles=self.ts_local.ntiles, roll_fns=rolls)
        return stl, self.ctx.psum(dropped)

    # ------------------------------------------------------------ the step
    def _pipeline(self, st: List[TiledState], do_move: bool, half: bool):
        ctx = self.ctx

        def dep(stl):
            if do_move and self._backend == "pallas" and self.spec.periodic:
                stl, rho, n_out = self._local_move_fields(stl)
            else:
                if do_move:
                    stl = TiledState(lpos=stl.lpos + stl.vel, vel=stl.vel,
                                     alive=stl.alive)
                    if not self.spec.periodic:
                        stl = self._local_reflect(stl)
                rho = self._local_fields(stl)
                n_out = self._out_of_margin(stl)
            return stl, rho, ctx.psum(n_out)

        res = ctx.shard_map(dep, st)
        st, rho = _column(res, 0), _column(res, 1)
        n_out = ctx.first(res)[2].to(torch.int32)
        phi, E, pe = solve_fields(self, rho)
        res = ctx.shard_map(partial(self._local_kick, half=half), st, E)
        return _column(res, 0), rho, phi, E, Diagnostics(
            kin_energy=ctx.first(res)[1], pot_energy=pe, n_lost=n_out)

    def _tiled_half_kick(self, st):
        return self._pipeline(st, do_move=False, half=True)

    def _pipeline_obj(self, st: List[TiledState], rho_obj, half: bool,
                      cull_only: bool):
        """The object step on the mesh (src/main.c:222-240): per shard the
        drift, the walls, the margin count, the responses and absorption,
        K1 per species and the halo fold; then rho_obj, the solves and the
        capacitance on the sharded fields; per shard the kick.  cull_only:
        the initialization's cull (no move, no response, the absorbed
        charge discarded, one solve).  Returns (st, rho, phi, E, diag,
        rho_obj, phi_c per object or None)."""
        ctx = self.ctx

        def dep(stl):
            if not cull_only:
                stl = TiledState(lpos=stl.lpos + stl.vel, vel=stl.vel,
                                 alive=stl.alive)
                if not self.spec.periodic:
                    stl = self._local_reflect(stl)
            n_out = self._out_of_margin(stl)
            stl, *sums = self._local_absorb_tiled(stl,
                                                  collide=not cull_only)
            return (stl, self._local_fields(stl), ctx.psum(n_out), *sums)

        res = ctx.shard_map(dep, st)
        st, rho = _column(res, 0), _column(res, 1)
        n_out, counter, rho_add, see = ctx.first(res)[2:]
        obj_phi = None
        if cull_only:
            phi, E, pe = solve_fields(self, rho)
        else:
            rho_obj = self._spread_obj_charge(rho_obj, counter)
            if rho_add is not None:
                rho_obj = rho_obj + rho_add.reshape(self.objects.shape)
            rho, phi, E, pe, obj_phi = solve_object_fields(self, rho,
                                                           rho_obj)
            if see is not None:
                self.see_emitted = self.see_emitted + see[0]
                self.see_overflow = self.see_overflow + see[1]
        res = ctx.shard_map(partial(self._local_kick, half=half), st, E)
        return (_column(res, 0), rho, phi, E, Diagnostics(
            kin_energy=ctx.first(res)[1], pot_energy=pe,
            n_lost=n_out.to(torch.int32)), rho_obj, obj_phi)

    def _tiled_step_obj(self, st, rho_obj):
        return self._pipeline_obj(st, rho_obj, half=False, cull_only=False)

    def _tiled_half_kick_obj(self, st):
        return self._pipeline_obj(st, None, half=True, cull_only=True)[:5]

    def _tiled_step(self, st):
        return self._pipeline(st, do_move=True, half=False)

    def _rebucket(self, st, species=None):
        species = range(len(self._charge)) if species is None else species
        d = self._rebucket_event(st, species)
        with span("pinc.sync.drops"):
            return st, int(d)

    def _rebucket_event(self, st, species) -> torch.Tensor:
        count("pinc.rebuckets", len(species))
        res = self.ctx.shard_map(
            partial(self._local_rebucket, species=tuple(species)), st)
        return self.ctx.first(res)[1]

    @staticmethod
    def _owned(st, donate: bool):
        return [None if s is None else TiledSimulation._owned(s, donate)
                for s in st]

    # ---------------------------- the global views of the base class's run
    def _retune_sample(self, st):
        """retune()'s sample, every (NT // 64)-th tile of the global tile
        grid, taken from the shards that hold those tiles into tensors on
        the first local device (its percentiles see every shard; over
        several processes each fills its shards' tiles and the samples
        are gathered, so every process derives the same cadences)."""
        gnt, lnt = self.ts.ntiles, self.ts_local.ntiles
        gc = np.unravel_index(np.arange(0, self.ts.NT,
                                        max(1, self.ts.NT // 64)), gnt)
        shard = np.ravel_multi_index(tuple(c // n for c, n in zip(gc, lnt)),
                                     self.ctx.n_subdomains)
        local = np.ravel_multi_index(tuple(c % n for c, n in zip(gc, lnt)),
                                     lnt)
        first = self.ctx.first(st)
        S, D, _, B = first.vel.shape
        dev = first.vel.device
        vel = torch.zeros((S, D, len(local), B), dtype=first.vel.dtype,
                          device=dev)
        alive = torch.zeros((S, len(local), B), dtype=first.alive.dtype,
                            device=dev)
        for i in self.ctx.local:
            s = st[i]
            sel = np.flatnonzero(shard == i)
            if sel.size:
                idx = torch.as_tensor(local[sel], device=s.vel.device)
                at = torch.as_tensor(sel, device=dev)
                vel[:, :, at] = s.vel.index_select(2, idx).abs().to(dev)
                alive[:, at] = s.alive.index_select(1, idx).to(dev)
        if self.ctx.world > 1:
            owner = np.asarray([self.ctx.owner(int(i)) for i in shard])
            got = mh.all_gather([vel, alive])
            for q, (v, a) in enumerate(got):
                at = torch.as_tensor(np.flatnonzero(owner == q), device=dev)
                vel[:, :, at] = v[:, :, at]
                alive[:, at] = a[:, at]
        return vel, alive > 0.5

    def to_particles(self, st):
        return super().to_particles(self._flat_state(st))

    def _writer_particles(self, st):
        """The population the writer gets: the global one; over several
        processes the shards' particles (None for another process's),
        each shard's converted with its tiles' global origins, of which
        the writer writes this process's."""
        if self.ctx.world == 1:
            return self.to_particles(st)
        org = tl.tile_origins(self.ts_local)

        def convert(stl):
            off = torch.tensor(subdomain_offset(self.ctx),
                               dtype=torch.float32)
            return TiledSimulation.to_particles(
                self, stl, (org + off).to(stl.lpos.device))   # exact sums
        return self.ctx.map(convert, st)

    def _assert_invariants_tiled(self, st, rho, n: int,
                                 max_vel: float) -> None:
        super()._assert_invariants_tiled(self._flat_state(st),
                                         self.ctx.gather(rho), n, max_vel)

    def _write(self, writer, n: int, st, fields, diag, ke, pe,
               rho_obj=None, obj_phi=None):
        # rho_obj is one global tensor already
        if writer.writes(n):
            fields = tuple(self.ctx.gather(f) for f in fields)
        super()._write(writer, n, st, fields, diag, ke, pe, rho_obj, obj_phi)

    def _sync(self) -> None:
        self.ctx.synchronize()

    # --------------------------------------------------------------- scan
    def _make_scan_steps_mega(self, n: int, donate: bool = False,
                              fresh: bool = False):
        """The sharded mega window: per shard one K5 pic_step a step (kick
        with the previous field, drift, deposit of every species), the fold
        with halo planes, the solve, and the E tiles padded with halo
        planes (pad_tiles_cmajor), which ride the carry.  fresh is accepted
        for the API: as in pinc_tpu, the sharded body runs no margin
        schedule."""
        del fresh
        ctx = self.ctx
        ln = self.ts_local
        NTl, P3 = ln.NT, ln.P
        plan = self._plan_generic(n)

        def particles_part(stl, ep5l):
            tiles, _, _, vdot, _ = tk.pic_step(
                ep5l, stl.lpos, stl.vel, stl.alive, self._charge, self._qm,
                ln, mxu_dtype=self._mxu_dtype, order_acc=self._acc_order,
                order_distr=self._distr_order, e_ext=self._e_ext,
                boris_T=self._boris_T, boris_S=self._boris_S, inplace=True)
            rho = tl.fold_to_global(tiles, ln, roll_fns=self._roll_fns())
            mass = torch.tensor(self._mass, dtype=torch.float32,
                                device=vdot.device)
            return rho.to(self.spec.dtype), ctx.psum(0.5 * mass * vdot)

        def pad_part(El):
            return tl.pad_tiles_cmajor(
                El, ln, roll_fns=self._roll_fns()).reshape(
                    NTl, 3 * P3, P3 * P3).contiguous()

        def fields(rho):
            _, E, pe = solve_fields(self, rho)
            return ctx.shard_map(pad_part, E), pe

        def body(carry, margins):
            st, ep5, pe_prev = carry
            res = ctx.shard_map(particles_part, st, ep5)
            return (st,) + fields(_column(res, 0)), (ctx.first(res)[1],
                                                      pe_prev)

        def run_n(st):
            st = self._owned(st, donate)
            carry = (st,) + fields(ctx.shard_map(self._local_fields, st))
            carry, outs, dropped = self._run_plan(plan, body, carry)
            return carry[0], _stack_outs(outs, dropped)
        run_n.plan = plan
        return run_n
