"""Domain-decomposed multi-chip MPM: blocks sharded by space-filling-curve
ranges, ``ppermute`` halo exchange, particle migration.

This is the scaling tier the replicated-grid path (:mod:`.distributed`)
cannot reach: each device owns a contiguous **morton-key range of blocks**
and holds only its own grid rows, so the grid footprint scales 1/D with
the mesh (reference analog: per-device partition groups,
``simulation/mpm/Simulator.cpp:44-118`` — which never exchanges between
groups; SURVEY §5.8 names the halo exchange as the deliverable).

Per step (SPMD inside ``shard_map``):

1. **Key census** (``all_gather`` of the small sorted key arrays): every
   device learns which of ITS blocks are touched by remote particles and
   builds a local table = blocks-it-touches ∪ owned-blocks-touched-remotely.
2. **Local P2G** into that table (sort-free scatter as in ``explicit_step``).
3. **Forward halo ring** (``ppermute``): partial sums for non-owned blocks
   travel around the ring; owners absorb (D-1 hops; with SFC locality most
   rows land on hop 1).
4. Grid update on owned rows only (momentum -> velocity, gravity, colliders).
5. **Return halo ring**: owners circulate updated velocities; devices fill
   their apron rows.
6. G2P + advect locally.
7. **Particle migration ring**: particles whose new block left the device's
   range are compacted into a fixed-capacity bundle and routed to their new
   owner; arrivals land in free particle slots.

Static capacities everywhere (local block table, migration bundle, particle
slots) with an OR'd overflow flag for host-side re-trace — the framework's
``_buildSuccess`` idiom.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      build_block_table, pack_coords,
                                      unpack_key)
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import neighbor_offsets
from ..math.bits import morton3d
from ..math.interpolation import bspline_weights, stencil_size
from ..math.vecmat import mm
from .distributed import _shard_map_norep
from .mpm import MPMSim, MPMState

__all__ = ["DDState", "make_dd_state", "explicit_step_dd",
           "gather_dd_particles", "morton_splits"]

_MORTON_OFF = 512          # block coords in [-512, 512) -> [0, 1024)


def _block_morton(coords: jax.Array) -> jax.Array:
    return morton3d(coords + _MORTON_OFF)


def _owner(mkey: jax.Array, splits: jax.Array) -> jax.Array:
    """Device rank owning a morton key: splits [D+1], ranges half-open."""
    return jnp.clip(jnp.searchsorted(splits[1:-1], mkey, side="right"),
                    0, splits.shape[0] - 2).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DDState:
    """Sharded particle state: channels [D*capP, ...], alive mask, pid."""

    channels: Dict[str, jax.Array]
    alive: jax.Array               # [D*capP] bool
    pid: jax.Array                 # [D*capP] int32 original particle id
    splits: jax.Array              # [D+1] morton boundaries (replicated)
    max_vel: jax.Array


def morton_splits(x: np.ndarray, dx: float, bs: int, n_devices: int,
                  origin=None) -> np.ndarray:
    """Quantile SFC splits from initial particle positions (host-side)."""
    o = np.zeros(3) if origin is None else np.asarray(origin)
    blocks = np.floor((x - o) / dx - 0.5).astype(np.int64) // bs
    mk = np.asarray(_block_morton(jnp.asarray(blocks, jnp.int32)))
    qs = np.quantile(mk, np.linspace(0, 1, n_devices + 1)[1:-1])
    return np.concatenate([[np.iinfo(np.int32).min], qs.astype(np.int64),
                           [np.iinfo(np.int32).max]]).astype(np.int32)


def _put_global(mesh: Mesh, full: np.ndarray, spec: P):
    """Place a host-side FULL array onto a (possibly multi-process) mesh.

    Single-process: plain ``device_put``.  Multi-process: every process
    builds the same full array deterministically (the host-side shuffle
    is seeded by the data, not the process), so each process serves its
    addressable shards by slicing — ``make_array_from_callback`` handles
    arbitrary device order and replicated specs alike.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(full, sharding)
    full = np.asarray(full)
    return jax.make_array_from_callback(full.shape, sharding,
                                        lambda idx: full[idx])


def make_dd_state(state: MPMState, mesh: Mesh, *, axis: str = "d",
                  cap_per_device: Optional[int] = None,
                  splits: Optional[np.ndarray] = None) -> DDState:
    """Distribute an MPMState: each particle to the device owning its block
    (host-side shuffle), channels padded to ``cap_per_device`` per shard.

    Works on multi-process meshes too (every process passes the same
    host-side ``state``; see :func:`_put_global`)."""
    D = mesh.shape[axis]
    p = state.particles
    grid = state.grid
    dx = float(grid.dx)
    tr = np.asarray(grid.transform.matrix)
    origin = tr[:grid.dim, 3]
    n = int(p.size)
    x = np.asarray(p["x"])[:n]
    if splits is None:
        splits = morton_splits(x, dx, grid.block_size, D, origin)
    blocks = np.floor((x - origin) / dx - 0.5).astype(np.int64) \
        // grid.block_size
    mk = np.asarray(_block_morton(jnp.asarray(blocks, jnp.int32)))
    owner = np.clip(np.searchsorted(splits[1:-1], mk, side="right"),
                    0, D - 1)
    counts = np.bincount(owner, minlength=D)
    capP = cap_per_device or int(1 << int(np.ceil(np.log2(
        max(counts.max() * 2, 64)))))
    assert counts.max() <= capP, "cap_per_device too small"
    order = np.argsort(owner, kind="stable")
    # slot layout: device d owns rows [d*capP, (d+1)*capP)
    dst = np.full(n, -1, np.int64)
    so = owner[order]
    for d in range(D):
        idx = order[so == d]
        dst[idx] = d * capP + np.arange(len(idx))
    alive = np.zeros(D * capP, bool)
    alive[dst] = True
    pid = np.full(D * capP, -1, np.int32)
    pid[dst] = np.arange(n, dtype=np.int32)
    channels = {}
    for k, v in p.channels.items():
        a = np.zeros((D * capP,) + v.shape[1:], np.float32)
        a[dst] = np.asarray(v)[:n]
        channels[k] = a
    pspec, rspec = P(axis), P()
    channels = {k: _put_global(mesh, np.asarray(v), pspec)
                for k, v in channels.items()}
    return DDState(channels,
                   _put_global(mesh, alive, pspec),
                   _put_global(mesh, pid, pspec),
                   _put_global(mesh, np.asarray(splits, np.int32), rspec),
                   _put_global(mesh, np.asarray(state.max_vel), rspec))


def gather_dd_particles(dds: DDState, n: int) -> Dict[str, np.ndarray]:
    """Host-side: reassemble channels in original particle-id order."""
    pid = np.asarray(dds.pid)
    alive = np.asarray(dds.alive)
    out = {}
    for k, v in dds.channels.items():
        a = np.zeros((n,) + v.shape[1:], np.float32)
        a[pid[alive]] = np.asarray(v)[alive]
        out[k] = a
    return out


def explicit_step_dd(sim: MPMSim, dds: DDState, dt, mesh: Mesh, *,
                     grid_template, nb_local: int, mig_cap: int = 1024,
                     axis: str = "d", with_stats: bool = False):
    """One domain-decomposed explicit APIC step.  Call under ``jax.jit``.

    ``grid_template``: a SparseGrid giving dx/transform/block_size (its
    table/data are ignored — each device holds its own ``nb_local`` rows).
    Returns (new state, overflow flag); with ``with_stats=True`` also a
    comm-volume diagnostics dict: per-hop LIVE row
    counts on each ring (``fwd_rows``/``ret_rows``/``mig_rows``, [D-1]
    int32 summed over devices — with SFC locality most forward-halo rows
    absorb on hop 1) plus the static per-row payload sizes
    (``*_row_bytes``) and the physical per-hop wire volume
    (``hop_wire_bytes``: every device ships its full fixed-capacity
    buffer each hop regardless of liveness — useful bytes / wire bytes
    is the locality figure of merit).
    """
    dim = grid_template.dim
    bs = grid_template.block_size
    assert dim == 3, "domain decomposition is 3-D (morton ownership)"
    ncell = bs ** dim
    S = stencil_size(sim.order)
    D = mesh.shape[axis]
    capP_total = dds.alive.shape[0]
    assert capP_total % D == 0
    capP = capP_total // D
    cap_cells = nb_local * ncell
    transform_m = grid_template.transform.matrix
    perm_fwd = [(i, (i + 1) % D) for i in range(D)]

    def pack_ch(channels, pid):
        cols = [channels["x"], channels["v"],
                channels["F"].reshape(capP, 9),
                channels["C"].reshape(capP, 9),
                channels["m"][:, None], channels["vol"][:, None]]
        if "Jp" in channels:
            cols.append(channels["Jp"][:, None])
        cols.append(pid.astype(jnp.float32)[:, None])
        return jnp.concatenate(cols, axis=1)

    def unpack_ch(mat, channels):
        out = dict(x=mat[:, 0:3], v=mat[:, 3:6],
                   F=mat[:, 6:15].reshape(-1, 3, 3),
                   C=mat[:, 15:24].reshape(-1, 3, 3),
                   m=mat[:, 24], vol=mat[:, 25])
        i = 26
        if "Jp" in channels:
            out["Jp"] = mat[:, 26]
            i = 27
        pid = mat[:, i].astype(jnp.int32)
        return out, pid

    def step_local(channels, alive, pid, splits, max_vel, dt):
        me = jax.lax.axis_index(axis)
        x, v, F, C = (channels["x"], channels["v"], channels["F"],
                      channels["C"])
        m = jnp.where(alive, channels["m"], 0.0)
        vol = jnp.where(alive, channels["vol"], 0.0)

        dx = jnp.linalg.norm(transform_m[:dim, 0])
        origin = transform_m[:dim, 3]
        xi = (x - origin) / dx
        base, w, _ = bspline_weights(xi, sim.order)
        offs = jnp.asarray(neighbor_offsets(dim, 0, S - 1))
        cells = base[:, None, :] + offs[None, :, :]
        w3 = (w[:, 0, :, None, None] * w[:, 1, None, :, None] *
              w[:, 2, None, None, :]).reshape(capP, S ** dim)
        pblock = jnp.floor_divide(base, bs)

        # ---- 1. key census -------------------------------------------------
        # my touched blocks (particle blocks + stencil apron)
        ltab, _ = build_block_table(pblock, nb_local, valid=alive, dim=dim)
        doffs = jnp.asarray(neighbor_offsets(dim, 0, 1))
        lcoords = unpack_key(ltab.keys, dim)
        cand = (lcoords[:, None, :] + doffs[None, :, :]).reshape(-1, dim)
        vmask = jnp.repeat(jnp.arange(nb_local) < ltab.count,
                           doffs.shape[0])
        touched, _ = build_block_table(cand, nb_local, valid=vmask, dim=dim)
        # owned blocks touched by anyone (gather the small key arrays)
        all_keys = jax.lax.all_gather(touched.keys, axis).reshape(-1)
        all_coords = unpack_key(all_keys, dim)
        all_mk = _block_morton(all_coords)
        owned_remote = (_owner(all_mk, splits) == me) & \
            (all_keys != KEY_SENTINEL)
        # local table = touched ∪ owned_remote (capacity nb_local)
        cat = jnp.concatenate([touched.keys, all_keys])
        catmask = jnp.concatenate(
            [jnp.arange(nb_local) < touched.count, owned_remote])
        table, _ = build_block_table(unpack_key(cat, dim), nb_local,
                                     valid=catmask, dim=dim)
        overflow = table.count > table.capacity
        # morton3d keys only span block coords in [-_MORTON_OFF,
        # _MORTON_OFF); a particle outside wraps its key and would be
        # owned by / migrated to the wrong device — flag, don't wrap
        overflow = overflow | jnp.any(
            alive & ((pblock < -_MORTON_OFF) |
                     (pblock >= _MORTON_OFF)).any(-1))
        tcoords = table.active_coords
        tmk = _block_morton(tcoords)
        owned_slot = (_owner(tmk, splits) == me) & table.mask

        # ---- 2. local P2G ----------------------------------------------------
        Dinv = 4.0 / (dx * dx)
        tau = sim.model.kirchhoff(F)
        A = m[:, None, None] * C - \
            (dt * Dinv * vol)[:, None, None] * tau
        xdiff = (cells.astype(xi.dtype) - xi[:, None, :]) * dx
        mom = w3[..., None] * (m[:, None, None] * v[:, None, :] +
                               jnp.einsum("nij,nkj->nki", A, xdiff))
        mass_c = w3 * m[:, None]
        blk, loc = jnp.floor_divide(cells, bs), cells % bs
        lin = (loc[..., 0] * bs + loc[..., 1]) * bs + loc[..., 2]
        slot = table.query(blk)
        overflow = overflow | jnp.any(alive[:, None] & (slot < 0))
        flat = jnp.where(slot >= 0, slot * ncell + lin, cap_cells)
        payload = jnp.concatenate([mass_c[..., None], mom], -1)
        acc = jnp.zeros((cap_cells + 1, 1 + dim), payload.dtype)
        acc = acc.at[flat.reshape(-1)].add(
            payload.reshape(-1, 1 + dim))[:cap_cells]
        acc = acc.reshape(nb_local, ncell, 1 + dim)

        # ---- 3. forward halo ring (ppermute) --------------------------------
        send_mask = table.mask & ~owned_slot
        bkeys = jnp.where(send_mask, table.keys, KEY_SENTINEL)
        bpay = jnp.where(send_mask[:, None, None], acc, 0.0)
        acc = jnp.where(owned_slot[:, None, None], acc, 0.0)

        def fwd_hop(h, carry):
            acc, bkeys, bpay, rows = carry
            bkeys = jax.lax.ppermute(bkeys, axis, perm_fwd)
            bpay = jax.lax.ppermute(bpay, axis, perm_fwd)
            rows = rows.at[h].set(
                jnp.sum((bkeys != KEY_SENTINEL).astype(jnp.int32)))
            rc = unpack_key(bkeys, dim)
            mine = (bkeys != KEY_SENTINEL) & \
                (_owner(_block_morton(rc), splits) == me)
            rslot = table.query(rc)
            dstrow = jnp.where(mine & (rslot >= 0), rslot, nb_local)
            acc = jnp.concatenate(
                [acc, jnp.zeros((1, ncell, 1 + dim), acc.dtype)]
            ).at[dstrow].add(jnp.where(mine[:, None, None], bpay, 0.0)
                             )[:nb_local]
            bkeys = jnp.where(mine, KEY_SENTINEL, bkeys)
            bpay = jnp.where(mine[:, None, None], 0.0, bpay)
            return acc, bkeys, bpay, rows

        acc, _, _, fwd_rows = jax.lax.fori_loop(
            0, D - 1, fwd_hop,
            (acc, bkeys, bpay, jnp.zeros((D - 1,), jnp.int32)))

        # ---- 4. grid update (owned rows) -------------------------------------
        gm = acc[..., 0]
        gmv = acc[..., 1:]
        has_mass = (gm > 0.0) & owned_slot[:, None]
        gv = jnp.where(has_mass[..., None],
                       gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
        gv = gv + dt * sim.gravity[None, None, :]
        corners = jnp.asarray(neighbor_offsets(dim, 0, bs - 1))
        node_cells = tcoords[:, None, :] * bs + corners[None, :, :]
        node_x = node_cells.astype(gv.dtype) * dx + origin
        gv = resolve_boundaries(sim.colliders, node_x, gv)
        gv = jnp.where(has_mass[..., None], gv, 0.0)
        max_vel_new = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))
        max_vel_new = jax.lax.pmax(max_vel_new, axis)

        # ---- 5. return halo ring ---------------------------------------------
        rkeys = jnp.where(owned_slot, table.keys, KEY_SENTINEL)
        rpay = jnp.where(owned_slot[:, None, None], gv, 0.0)

        def ret_hop(h, carry):
            gv, rkeys, rpay, rows = carry
            rkeys = jax.lax.ppermute(rkeys, axis, perm_fwd)
            rpay = jax.lax.ppermute(rpay, axis, perm_fwd)
            rows = rows.at[h].set(
                jnp.sum((rkeys != KEY_SENTINEL).astype(jnp.int32)))
            rc = unpack_key(rkeys, dim)
            rslot = table.query(rc)
            fill = (rkeys != KEY_SENTINEL) & (rslot >= 0)
            dstrow = jnp.where(fill, rslot, nb_local)
            pad = jnp.zeros((1, ncell, dim), gv.dtype)
            gv = jnp.concatenate([gv, pad]).at[dstrow].add(
                jnp.where(fill[:, None, None], rpay, 0.0))[:nb_local]
            return gv, rkeys, rpay, rows

        # apron rows are zero before the ring, so add == fill
        gv, _, _, ret_rows = jax.lax.fori_loop(
            0, D - 1, ret_hop,
            (gv, rkeys, rpay, jnp.zeros((D - 1,), jnp.int32)))

        # ---- 6. G2P + advect --------------------------------------------------
        gvf = gv.reshape(cap_cells, dim)
        safe = jnp.minimum(flat, cap_cells - 1)
        vnode = jnp.where((flat < cap_cells)[..., None], gvf[safe], 0.0)
        v_new = jnp.einsum("nk,nki->ni", w3, vnode)
        B = jnp.einsum("nk,nki,nkj->nij", w3, vnode, xdiff)
        C_new = Dinv * B
        eye = jnp.eye(dim, dtype=F.dtype)
        F_new = mm(eye + dt * C_new, F)
        upd = {}
        if sim.plasticity is not None and "Jp" in channels:
            F_new, Jp_new = sim.plasticity.project(F_new, channels["Jp"])
            upd["Jp"] = jnp.where(alive, Jp_new, channels["Jp"])
        x_new = x + dt * v_new
        mk1 = alive[:, None]
        out_ch = dict(channels)
        out_ch.update(
            x=jnp.where(mk1, x_new, x), v=jnp.where(mk1, v_new, v),
            F=jnp.where(mk1[..., None], F_new, F),
            C=jnp.where(mk1[..., None], C_new, C), **upd)

        # ---- 7. particle migration ring ---------------------------------------
        nxi = (out_ch["x"] - origin) / dx
        nbase, _, _ = bspline_weights(nxi, sim.order)
        nblock = jnp.floor_divide(nbase, bs)
        overflow = overflow | jnp.any(
            alive & ((nblock < -_MORTON_OFF) |
                     (nblock >= _MORTON_OFF)).any(-1))
        nowner = _owner(_block_morton(nblock), splits)
        leaving = alive & (nowner != me)
        mat = pack_ch(out_ch, pid)
        # compact leaving lanes to the front
        order = jnp.argsort(~leaving, stable=True)
        src = order[:mig_cap]
        bvalid = leaving[src]
        overflow = overflow | \
            (jnp.sum(leaving.astype(jnp.int32)) > mig_cap)
        bmat = jnp.where(bvalid[:, None], mat[src], 0.0)
        bowner = jnp.where(bvalid, nowner[src], -1)
        alive2 = alive & ~leaving

        def mig_hop(h, carry):
            mat, alive2, bmat, bowner, ovf, rows = carry
            bmat = jax.lax.ppermute(bmat, axis, perm_fwd)
            bowner = jax.lax.ppermute(bowner, axis, perm_fwd)
            rows = rows.at[h].set(
                jnp.sum((bowner >= 0).astype(jnp.int32)))
            arriving = bowner == me
            n_arr = jnp.sum(arriving.astype(jnp.int32))
            free = jnp.argsort(alive2, stable=True)    # False slots first
            n_free = jnp.sum((~alive2).astype(jnp.int32))
            ovf = ovf | (n_arr > n_free)
            # k-th arriving row -> k-th free slot
            arr_rank = jnp.cumsum(arriving.astype(jnp.int32)) - 1
            dst = jnp.where(arriving,
                            free[jnp.clip(arr_rank, 0, capP - 1)], capP)
            mat = jnp.concatenate(
                [mat, jnp.zeros((1, mat.shape[1]), mat.dtype)]
            ).at[dst].set(bmat)[:capP]
            newalive = jnp.zeros((capP + 1,), bool).at[dst].set(
                arriving)[:capP]
            alive2 = alive2 | newalive
            bowner = jnp.where(arriving, -1, bowner)
            bmat = jnp.where(arriving[:, None], 0.0, bmat)
            return mat, alive2, bmat, bowner, ovf, rows

        mat, alive2, _, _, overflow, mig_rows = jax.lax.fori_loop(
            0, D - 1, mig_hop,
            (mat, alive2, bmat, bowner, overflow,
             jnp.zeros((D - 1,), jnp.int32)))
        out_ch, pid2 = unpack_ch(mat, out_ch)
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
        stats = jax.lax.psum(
            jnp.stack([fwd_rows, ret_rows, mig_rows]), axis)
        return out_ch, alive2, pid2, max_vel_new, overflow, stats

    pspec, rspec = P(axis), P()
    mapped = _shard_map_norep(
        step_local, mesh=mesh,
        in_specs=(pspec, pspec, pspec, rspec, rspec, rspec),
        out_specs=(pspec, pspec, pspec, rspec, rspec, rspec))
    out_ch, alive, pid, max_vel, overflow, ring_rows = mapped(
        dds.channels, dds.alive, dds.pid, dds.splits, dds.max_vel, dt)
    new = DDState(out_ch, alive, pid, dds.splits, max_vel)
    if not with_stats:
        return new, overflow
    ncols = 26 + (1 if "Jp" in dds.channels else 0) + 1
    stats = {
        "fwd_rows": ring_rows[0], "ret_rows": ring_rows[1],
        "mig_rows": ring_rows[2],
        "fwd_row_bytes": 4 + ncell * (1 + dim) * 4,
        "ret_row_bytes": 4 + ncell * dim * 4,
        "mig_row_bytes": 4 + ncols * 4,
        "hop_wire_bytes": {
            "fwd": D * nb_local * (4 + ncell * (1 + dim) * 4),
            "ret": D * nb_local * (4 + ncell * dim * 4),
            "mig": D * mig_cap * (4 + ncols * 4),
        },
    }
    return new, overflow, stats
