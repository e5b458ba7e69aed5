"""Multi-chip explicit MPM: particle-sharded SPMD over a device mesh.

The reference's multi-GPU MPM groups particle objects by MemoryLocation and
runs independent partitions per device (simulation/mpm/Simulator.cpp:44-118)
— it has no cross-device reduction, so grids can't span devices.  This
design goes further (SURVEY §5.8, §7-M4):

* **particles sharded** over the mesh axis (leading-dim sharding)
* **grid replicated**: each device scatters its particles into a local
  partial grid; one ``psum`` over the interconnect merges mass/momentum (the
  collective replacement for atomic peer writes)
* **block table union**: each device builds its local sorted block table;
  ``all_gather`` of the (small) key arrays + re-unique gives the identical
  global table everywhere — deterministic, no hash races by construction.
* grid update + G2P run replicated/locally — no further communication.

Cost model: the collective moves ``block_capacity * (bs^d) * 4`` floats per
step (a few MB) over the interconnect; particles never migrate between devices.
Domain
-decomposed sharding (blocks sharded, ``ppermute`` halo exchange) is the
planned next tier for grids too large to replicate.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
def _shard_map_norep(f, *, mesh, in_specs, out_specs):
    """shard_map without replication checking, across jax versions
    (check_rep was renamed check_vma in jax 0.8+)."""
    try:
        from jax import shard_map as sm
        return sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_vma=False)
    except (ImportError, TypeError):
        from jax.experimental.shard_map import shard_map as sm
        return sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_rep=False)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      build_block_table)
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import neighbor_offsets
from ..math.interpolation import bspline_weights, stencil_size
from ..math.vecmat import mm
from .mpm import MPMSim, MPMState

__all__ = ["shard_state", "explicit_step_sharded"]


def shard_state(state: MPMState, mesh: Mesh, axis: str = "d") -> MPMState:
    """Place particle channels sharded on the mesh, grid replicated.

    Particle capacity must be divisible by the mesh size.
    """
    psh = NamedSharding(mesh, P(axis))
    rsh = NamedSharding(mesh, P())
    parts = state.particles
    ch = {k: jax.device_put(v, psh) for k, v in parts.channels.items()}
    import dataclasses
    particles = dataclasses.replace(parts, channels=ch)
    grid = jax.tree.map(lambda a: jax.device_put(a, rsh), state.grid)
    return MPMState(particles, grid,
                    jax.device_put(state.max_vel, rsh))


def _union_tables(local_keys: jax.Array, capacity: int, axis: str):
    """Global block table from per-device sorted key arrays (all_gather +
    re-unique) — identical on every device."""
    all_keys = jax.lax.all_gather(local_keys, axis).reshape(-1)
    skeys = jnp.sort(all_keys)
    neq = jnp.concatenate([jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])
    neq = neq & (skeys != KEY_SENTINEL)
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1
    count = rank[-1] + 1
    dst = jnp.where(neq, jnp.minimum(rank, capacity), capacity)
    keys = jnp.full((capacity + 1,), KEY_SENTINEL, jnp.int32).at[dst].set(
        skeys)[:capacity]
    return keys, count.astype(jnp.int32)


def explicit_step_sharded(sim: MPMSim, state: MPMState, dt, mesh: Mesh,
                          axis: str = "d") -> MPMState:
    """One explicit APIC step, SPMD over ``mesh`` (call under ``jax.jit``).

    Numerically identical to :func:`zpc_tpu.sim.mpm.explicit_step` up to
    reduction order.
    """
    grid0 = state.grid
    dim, bs = grid0.dim, grid0.block_size
    ncell = grid0.cells_per_block
    bcap = grid0.block_capacity
    cap_cells = bcap * ncell
    S = stencil_size(sim.order)
    n_total = state.particles.capacity
    n_valid = state.particles.size
    nd = mesh.shape[axis]
    assert n_total % nd == 0, "particle capacity must divide mesh size"
    n_local = n_total // nd

    pspec = P(axis)
    rspec = P()

    def step_local(channels, table_keys, transform_m, max_vel, dt):
        x, v, F, C, pm, vol = (channels["x"], channels["v"], channels["F"],
                               channels["C"], channels["m"], channels["vol"])
        # validity from *global* lane index
        gidx = jax.lax.axis_index(axis) * n_local + jnp.arange(n_local)
        pmask = gidx < n_valid
        m = jnp.where(pmask, pm, 0.0)

        dx = jnp.linalg.norm(transform_m[:dim, 0])
        inv_scale = 1.0 / dx
        origin = transform_m[:dim, 3]
        xi = (x - origin) * inv_scale
        base, w, _ = bspline_weights(xi, sim.order)
        offs = jnp.asarray(neighbor_offsets(dim, 0, S - 1))
        cells = base[:, None, :] + offs[None, :, :]
        w3 = (w[:, 0, :, None, None] * w[:, 1, None, :, None] *
              w[:, 2, None, None, :]).reshape(n_local, S ** dim)

        # -- global table union ------------------------------------------
        pblock = jnp.floor_divide(base, bs)
        ltab, _ = build_block_table(pblock, bcap, valid=pmask, dim=dim)
        keys, count = _union_tables(ltab.keys, bcap, axis)
        # dilate by +1 block (stencil apron)
        doffs = jnp.asarray(neighbor_offsets(dim, 0, 1))
        from ..containers.block_table import pack_coords, unpack_key
        coords = unpack_key(keys, dim)
        cand = (coords[:, None, :] + doffs[None, :, :]).reshape(-1, dim)
        vmask = jnp.repeat(jnp.arange(bcap) < count, doffs.shape[0])
        dtab, _ = build_block_table(cand, bcap, valid=vmask, dim=dim)
        table = BlockTable(dtab.keys, dtab.count, dim)

        # -- P2G (local partial) + psum ----------------------------------
        Dinv = 4.0 / (dx * dx)
        tau = sim.model.kirchhoff(F)
        A = m[:, None, None] * C - (dt * Dinv * jnp.where(
            pmask, vol, 0.0))[:, None, None] * tau
        xdiff = (cells.astype(xi.dtype) - xi[:, None, :]) * dx
        mom = w3[..., None] * (m[:, None, None] * v[:, None, :] +
                               jnp.einsum("nij,nkj->nki", A, xdiff))
        mass_c = w3 * m[:, None]
        block, local = jnp.floor_divide(cells, bs), cells % bs
        lin = (local[..., 0] * bs + local[..., 1]) * bs + local[..., 2]
        slot = table.query(block)
        flat = jnp.where(slot >= 0, slot * ncell + lin, cap_cells)
        payload = jnp.concatenate([mass_c[..., None], mom], -1)
        acc = jnp.zeros((cap_cells + 1, 4), payload.dtype)
        acc = acc.at[flat.reshape(-1)].add(payload.reshape(-1, 4))[:cap_cells]
        acc = jax.lax.psum(acc, axis)            # cross-device merge

        # -- grid update (replicated compute) ----------------------------
        gm, gmv = acc[:, 0], acc[:, 1:]
        has_mass = gm > 0.0
        gv = jnp.where(has_mass[:, None],
                       gmv / jnp.maximum(gm, 1e-30)[:, None], 0.0)
        gv = gv + dt * sim.gravity[None, :]
        corners = jnp.asarray(neighbor_offsets(dim, 0, bs - 1))
        node_cells = (unpack_key(table.keys, dim)[:, None, :] * bs +
                      corners[None, :, :]).reshape(cap_cells, dim)
        node_x = node_cells.astype(gv.dtype) * dx + origin
        gv = resolve_boundaries(sim.colliders, node_x, gv)
        gv = jnp.where(has_mass[:, None], gv, 0.0)
        max_vel_new = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

        # -- G2P + advect -------------------------------------------------
        safe = jnp.minimum(flat, cap_cells - 1)
        vnode = gv[safe]
        vnode = jnp.where((flat < cap_cells)[..., None], vnode, 0.0)
        v_new = jnp.einsum("nk,nki->ni", w3, vnode)
        B = jnp.einsum("nk,nki,nkj->nij", w3, vnode, xdiff)
        C_new = Dinv * B
        eye = jnp.eye(dim, dtype=F.dtype)
        F_new = mm(eye + dt * C_new, F)
        upd = {}
        if sim.plasticity is not None and "Jp" in channels:
            F_new, Jp_new = sim.plasticity.project(F_new, channels["Jp"])
            upd["Jp"] = jnp.where(pmask, Jp_new, channels["Jp"])
        x_new = x + dt * v_new
        mk = pmask[:, None]
        out_ch = dict(channels)
        out_ch.update(
            x=jnp.where(mk, x_new, x), v=jnp.where(mk, v_new, v),
            F=jnp.where(mk[..., None], F_new, F),
            C=jnp.where(mk[..., None], C_new, C), **upd)
        gdata = {"m": gm.reshape(bcap, ncell),
                 "v": gv.reshape(bcap, ncell, dim)}
        return out_ch, table.keys, table.count, gdata, max_vel_new

    mapped = _shard_map_norep(
        step_local, mesh=mesh,
        in_specs=(pspec, rspec, rspec, rspec, rspec),
        out_specs=(pspec, rspec, rspec, rspec, rspec))
    out_ch, keys, count, gdata, max_vel = mapped(
        state.particles.channels, grid0.table.keys,
        grid0.transform.matrix, state.max_vel, dt)

    import dataclasses
    particles = dataclasses.replace(state.particles, channels=out_ch)
    table = BlockTable(keys, count, dim)
    grid = dataclasses.replace(grid0, table=table, data=gdata)
    return MPMState(particles, grid, max_vel)
