"""Binned-v2 fast path for the J-only fluid pipeline (3-D).

claymore's flagship fluid configuration is exactly this: scalar-J EOS
particles over block-sparse grids with fused G2P2G transfers
(reference lineage: simulation/transfer/P2G.hpp fluid specialization).
Reuses the mpm_binned2 machinery — sort-into-bins, drift-slack windows,
adaptive rebinning, reshape spill/pull — with an 18-column payload
(x3 v3 J1 C9 m1 vol1) instead of 26: rebins move ~30% less data and the
stress contribution to the APIC affine matrix is one scalar.

Oracle-shared with sim.fluid.explicit_fluid_step (same physics tests).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..containers.block_table import KEY_SENTINEL, pack_coords
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import neighbor_offsets
from ..math.interpolation import bspline_weights
from ..models.constitutive import EquationOfState
from .mpm import MPMSim, MPMState
from .mpm_binned2 import (_PREC, BinnedConfig2, BinState, K,
                          _axis_stencils, _ctx_g2p, _ctx_p2g, _make_ctx3,
                          _node_positions, _rebin, _sort_into_bins)

__all__ = ["bin_fluid_state", "explicit_fluid_step_binned2",
           "rollout_fluid_binned2", "unbin_fluid_state"]

# column layout: x3 v3 J1 C9 m1 vol1
_J, _C0, _M, _VOL = 6, 7, 16, 17
_W = 18


def _fluid_layout(dim):
    """Column offsets for the x v J C m vol fluid payload."""
    return dict(J=2 * dim, C0=2 * dim + 1, M=2 * dim + 1 + dim * dim,
                VOL=2 * dim + 2 + dim * dim, W=2 * dim + 3 + dim * dim)


def bin_fluid_state(sim: MPMSim, state: MPMState,
                    cfg: BinnedConfig2) -> BinState:
    """Enter bin order from a fluid MPMState (x, v, J, C, m, vol)."""
    p = state.particles
    grid = state.grid
    dim = grid.dim
    assert dim in (2, 3) and grid.block_size == 4
    N = p.capacity
    pmask = p.mask
    cols = jnp.concatenate([
        p["x"], p["v"], p["J"][:, None], p["C"].reshape(N, dim * dim),
        jnp.where(pmask, p["m"], 0.0)[:, None],
        jnp.where(pmask, p["vol"], 0.0)[:, None]], axis=1)
    pid = jnp.where(pmask, jnp.arange(N, dtype=jnp.int32), -1)
    origin_w = grid.transform.matrix[:dim, dim]
    xi = (p["x"] - origin_w) / grid.dx
    base, _, _ = bspline_weights(xi, sim.order)
    keys = jnp.where(pmask,
                     pack_coords(jnp.floor_divide(base - cfg.slack, 4)),
                     KEY_SENTINEL)
    nb = cfg.block_capacity or grid.block_capacity
    st = _sort_into_bins(keys, cols, pid, cfg, nb, dim)
    return dataclasses.replace(
        st, grid=dataclasses.replace(st.grid, transform=grid.transform),
        max_vel=state.max_vel)


def unbin_fluid_state(st: BinState, template: MPMState) -> MPMState:
    p = template.particles
    d = st.grid.dim
    lay = _fluid_layout(d)
    N = p.capacity
    L = st.cols.shape[0]
    alive = st.pid >= 0
    dst = jnp.where(alive, st.pid, N)
    inv = jnp.zeros((N + 1,), jnp.int32).at[dst].set(
        jnp.arange(L, dtype=jnp.int32))[:N]
    mat = st.cols[inv]
    pmask = p.mask
    mk = pmask[:, None]
    particles = p.update(
        x=jnp.where(mk, mat[:, 0:d], p["x"]),
        v=jnp.where(mk, mat[:, d:2 * d], p["v"]),
        J=jnp.where(pmask, mat[:, lay["J"]], p["J"]),
        C=jnp.where(mk[..., None],
                    mat[:, lay["C0"]:lay["C0"] + d * d].reshape(N, d, d),
                    p["C"]))
    return MPMState(particles, st.grid, st.max_vel)


def explicit_fluid_step_binned2(sim: MPMSim, state: BinState, dt,
                                cfg: BinnedConfig2, *, rebin: bool = True,
                                j_clamp: float = 0.1) -> BinState:
    """One explicit J-only EOS step on a fluid BinState.

    The 3-D transfers ride the shared mpm_binned2 context machinery
    (`_ctx_p2g` / `_ctx_g2p`), so `cfg.chunk_bins` and `cfg.recenter`
    mean the same thing here as on the elastic path — the working-set
    bound of chunking applies to the fluid pipeline unchanged.
    """
    assert isinstance(sim.model, EquationOfState)
    st = state
    if rebin:
        st = _rebin(sim, st, cfg)
    if st.grid.dim == 2:
        return _fluid_step2d(sim, st, dt, cfg, j_clamp)
    if cfg.chunk_bins and cfg.chunk_bins < cfg.bins_capacity:
        return _fluid_step3d_chunked(sim, st, dt, cfg, j_clamp)
    return _fluid_step3d(sim, st, dt, cfg, j_clamp)


def _fluid_p2g_inputs(sim: MPMSim, ctx, cols, dt, dx):
    """Per-chunk fluid P2G operands: Q0/QA planes from the J-only EOS.

    The stress term is one scalar on A's diagonal (tau = -p(J)·J·I),
    vs. the elastic path's full kirchhoff(F) — the only physics
    difference between the two pipelines' P2G.
    """
    lane_alive = ctx.lane_alive
    vb = cols[..., 3:6]
    # dead lanes carry J = 0 and pressure(0) is inf: 0 * inf = NaN would
    # contaminate the einsums even though vol masks the magnitude
    Jb = jnp.where(lane_alive, cols[..., _J], 1.0)
    Cb = cols[..., _C0:_C0 + 9].reshape(*cols.shape[:2], 3, 3)
    mban = jnp.where(lane_alive, cols[..., _M], 0.0)
    volb = jnp.where(lane_alive, cols[..., _VOL], 0.0)
    Dinv = 4.0 / (dx * dx)
    tau_s = -sim.model.pressure(Jb) * Jb
    stress_s = -dt * Dinv * volb * tau_s
    A = mban[..., None, None] * Cb
    A = A + stress_s[..., None, None] * jnp.eye(3, dtype=A.dtype)
    u0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A, ctx.rel0)
    Q0 = jnp.concatenate([mban[..., None], u0], -1)
    QA = [dx * A[..., :, d] for d in range(3)]
    return Q0, QA, Jb, mban, volb


def _fluid_advect(ctx, cols, s0, sx, sy, sz, Jb, dt, dx, j_clamp):
    """G2P tail: new v/C/J/x for one bin-chunk, plus its stencil offsets."""
    xb = cols[..., 0:3]
    Dinv = 4.0 / (dx * dx)
    v_new = s0
    Bmat = v_new[..., :, None] * ctx.rel0[..., None, :] + \
        dx * jnp.stack([sx, sy, sz], axis=-1)
    C_new = Dinv * Bmat
    J_new = Jb * (1.0 + dt * jnp.trace(C_new, axis1=-2, axis2=-1))
    J_new = jnp.maximum(J_new, j_clamp)
    x_new = xb + dt * v_new
    base_new = jnp.floor((x_new - ctx.origin_w) / dx - 0.5
                         ).astype(jnp.int32)
    off_new = base_new - ctx.borigin[:, None, :]
    return x_new, v_new, C_new, J_new, off_new


def _fluid_newcols(ctx, cols, x_new, v_new, C_new, J_new, mban, volb):
    Bc = cols.shape[0]
    ok3 = ctx.lane_alive[..., None]
    return jnp.concatenate(
        [jnp.where(ok3, x_new, cols[..., 0:3]),
         jnp.where(ok3, v_new, cols[..., 3:6]),
         jnp.where(ctx.lane_alive, J_new, cols[..., _J])[..., None],
         jnp.where(ok3[..., None], C_new,
                   cols[..., _C0:_C0 + 9].reshape(Bc, K, 3, 3)
                   ).reshape(Bc, K, 9),
         mban[..., None], volb[..., None]], axis=-1).reshape(Bc * K, _W)


def _fluid_step3d(sim: MPMSim, st: BinState, dt, cfg: BinnedConfig2,
                  j_clamp: float) -> BinState:
    grid = st.grid
    dx = grid.dx
    B = cfg.bins_capacity
    side = cfg.side

    cols = st.cols.reshape(B, K, _W)
    ctx = _make_ctx3(st, cfg)
    lane_alive = ctx.lane_alive
    overflow = ctx.overflow

    Q0, QA, Jb, mban, volb = _fluid_p2g_inputs(sim, ctx, cols, dt, dx)
    acc = _ctx_p2g(ctx, Q0, QA)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update -----------------------------------------------------
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    gv = resolve_boundaries(sim.colliders, _node_positions(ctx), gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- G2P ---------------------------------------------------------------
    s0, sx, sy, sz = _ctx_g2p(ctx, gv)
    x_new, v_new, C_new, J_new, off_new = _fluid_advect(
        ctx, cols, s0, sx, sy, sz, Jb, dt, dx, j_clamp)
    if cfg.recenter:
        # Galilean recentering — see the elastic step / BinnedConfig2
        asum = jnp.maximum(jnp.sum(lane_alive.astype(jnp.int32)), 1)
        mean_off = (jnp.sum(jnp.where(lane_alive[..., None], off_new, 0),
                            axis=(0, 1)).astype(jnp.float32) / asum)
        shift = jnp.clip(jnp.round(mean_off - 0.5 * (side - 3)),
                         -1.0, 1.0).astype(jnp.int32)
        off_new = off_new - shift[None, None, :]
        tm = grid.transform.matrix.at[:3, 3].add(
            shift.astype(jnp.float32) * dx)
        grid = dataclasses.replace(
            grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = jnp.any(lane_alive[..., None] &
                      ((off_new < 0) | (off_new > side - 3)))

    ncols = _fluid_newcols(ctx, cols, x_new, v_new, C_new, J_new,
                           mban, volb)
    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=overflow, needs_rebin=escaped)


def _fluid_step3d_chunked(sim: MPMSim, st: BinState, dt,
                          cfg: BinnedConfig2, j_clamp: float) -> BinState:
    """The fluid 3-D step with the transfer pipeline chunked over bins.

    Physics-identical to :func:`_fluid_step3d` (same helpers); two
    ``lax.scan`` passes over bin-chunks of ``cfg.chunk_bins`` pin the
    [B,K,·] working set at the chunk size at any problem scale — the
    same bound the elastic `_step3d_chunked` carries.
    fp32 sums are chunk-major reassociated: roundoff, not bitwise.
    """
    grid = st.grid
    dx = grid.dx
    B = cfg.bins_capacity
    Bc = cfg.chunk_bins
    assert B % Bc == 0, (B, Bc)
    side = cfg.side
    nb = grid.table.capacity
    L = B * K
    lo_arr = jnp.arange(B // Bc, dtype=jnp.int32) * Bc

    def chunk_particles(lo):
        ctx = _make_ctx3(st, cfg, lo=lo, nbins=Bc)
        cols = jax.lax.dynamic_slice_in_dim(
            st.cols, lo * K, Bc * K, 0).reshape(Bc, K, _W)
        return ctx, cols

    # ---- pass 1: chunked P2G --------------------------------------------
    def p2g_chunk(carry, lo):
        acc, overflow = carry
        ctx, cols = chunk_particles(lo)
        Q0, QA, _, _, _ = _fluid_p2g_inputs(sim, ctx, cols, dt, dx)
        return (acc + _ctx_p2g(ctx, Q0, QA),
                overflow | ctx.overflow), None

    acc0 = jnp.zeros((nb, 64, 4), jnp.float32)
    (acc, overflow), _ = jax.lax.scan(p2g_chunk, (acc0, st.overflow),
                                      lo_arr)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update (global, [nb]-sized) --------------------------------
    origin_w = grid.transform.matrix[:3, 3]
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    corners = jnp.asarray(neighbor_offsets(3, 0, 3))
    node_x = (grid.table.active_coords[:, None, :] * 4 +
              corners[None]).astype(jnp.float32) * dx + origin_w
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- pass 2: chunked G2P + advect ------------------------------------
    big = jnp.int32(1 << 20)

    def g2p_chunk(carry, lo):
        ncols, off_min, off_max, osum, ocnt = carry
        ctx, cols = chunk_particles(lo)
        lane_alive = ctx.lane_alive
        Jb = jnp.where(lane_alive, cols[..., _J], 1.0)
        mban = jnp.where(lane_alive, cols[..., _M], 0.0)
        volb = jnp.where(lane_alive, cols[..., _VOL], 0.0)
        s0, sx, sy, sz = _ctx_g2p(ctx, gv)
        x_new, v_new, C_new, J_new, off_new = _fluid_advect(
            ctx, cols, s0, sx, sy, sz, Jb, dt, dx, j_clamp)
        mk = lane_alive[..., None]
        off_min = jnp.minimum(off_min, jnp.min(
            jnp.where(mk, off_new, big), axis=(0, 1)))
        off_max = jnp.maximum(off_max, jnp.max(
            jnp.where(mk, off_new, -big), axis=(0, 1)))
        osum = osum + jnp.sum(jnp.where(mk, off_new, 0), axis=(0, 1))
        ocnt = ocnt + jnp.sum(lane_alive.astype(jnp.int32))
        nc = _fluid_newcols(ctx, cols, x_new, v_new, C_new, J_new,
                            mban, volb)
        ncols = jax.lax.dynamic_update_slice_in_dim(ncols, nc, lo * K, 0)
        return (ncols, off_min, off_max, osum, ocnt), None

    carry0 = (jnp.zeros((L, _W), st.cols.dtype),
              jnp.full((3,), big), jnp.full((3,), -big),
              jnp.zeros((3,), jnp.int32), jnp.int32(0))
    (ncols, off_min, off_max, osum, ocnt), _ = jax.lax.scan(
        g2p_chunk, carry0, lo_arr)

    # ---- recenter + escape (global reductions from the chunk stats) ------
    if cfg.recenter:
        mean_off = osum.astype(jnp.float32) / jnp.maximum(ocnt, 1)
        shift = jnp.clip(jnp.round(mean_off - 0.5 * (side - 3)),
                         -1.0, 1.0).astype(jnp.int32)
        off_min = off_min - shift
        off_max = off_max - shift
        tm = grid.transform.matrix.at[:3, 3].add(
            shift.astype(jnp.float32) * dx)
        grid = dataclasses.replace(
            grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = jnp.any((off_min < 0) | (off_max > side - 3))

    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=overflow, needs_rebin=escaped)


def _fluid_step2d(sim: MPMSim, st, dt, cfg: BinnedConfig2,
                  j_clamp: float):
    """2-D J-only EOS step (x2 v2 J1 C4 m1 vol1 payload)."""
    from .mpm_binned2 import _DIRS2, _SPILL2, _PULL2
    grid = st.grid
    table = grid.table
    nb = table.capacity
    dx = grid.dx
    origin_w = grid.transform.matrix[:2, 2]
    B = cfg.bins_capacity
    L = B * K
    side = cfg.side
    lay = _fluid_layout(2)

    cols = st.cols.reshape(B, K, lay["W"])
    xb = cols[..., 0:2]
    vb = cols[..., 2:4]
    Jb = cols[..., lay["J"]]
    Cb = cols[..., lay["C0"]:lay["C0"] + 4].reshape(B, K, 2, 2)
    mban = cols[..., lay["M"]]
    volb = cols[..., lay["VOL"]]
    lane_alive = (st.pid >= 0).reshape(B, K)
    mban = jnp.where(lane_alive, mban, 0.0)
    volb = jnp.where(lane_alive, volb, 0.0)
    Jb = jnp.where(lane_alive, Jb, 1.0)

    bin_live = jnp.any(lane_alive, axis=1)
    bin_block = jnp.where(bin_live, st.bin_block, -1)
    bad_bin = bin_live & (bin_block < 0)
    overflow = st.overflow | jnp.any(bad_bin)
    bin_block_safe = jnp.clip(bin_block, 0, nb - 1)
    borigin = table.active_coords[bin_block_safe] * 4

    xib = (xb - origin_w) / dx
    (wx, wy), (wx_i, wy_i), rel0i = _axis_stencils(xib, borigin, side)
    rel0 = rel0i * dx
    wx = wx * lane_alive[..., None]
    wx_i = wx_i * lane_alive[..., None]

    Dinv = 4.0 / (dx * dx)
    tau_s = -sim.model.pressure(Jb) * Jb
    stress_s = -dt * Dinv * volb * tau_s
    A = mban[..., None, None] * Cb
    A = A + stress_s[..., None, None] * jnp.eye(2, dtype=A.dtype)
    u0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A, rel0)
    Q0 = jnp.concatenate([mban[..., None], u0], -1)           # [B,K,3]
    zero = jnp.zeros_like(mban)[..., None]
    QA = [jnp.concatenate([zero, dx * A[..., :, d]], -1) for d in range(2)]

    def plane_scale(w6, q):
        return (w6[..., :, None] * q[..., None, :]).reshape(B, K, 3 * side)

    R1 = plane_scale(wx, Q0) + plane_scale(wx_i, QA[0])
    R2 = plane_scale(wx, QA[1])
    Sstack = jnp.concatenate([wy, wy_i], axis=1)
    Rstack = jnp.concatenate([R1, R2], axis=1)
    out = jnp.einsum("bkm,bkA->bmA", Sstack, Rstack, precision=_PREC,
                     preferred_element_type=jnp.float32)
    cube = jnp.moveaxis(out.reshape(B, side, side, 3), 1, 2
                        ).reshape(B, side * side, 3)

    dirs = [d for d in _DIRS2 if any(d)]
    coords = table.active_coords
    dirs_j = jnp.asarray(dirs, jnp.int32)
    nbr_pos = jax.vmap(
        lambda d: table.query(coords + d[None, :]), out_axes=1)(dirs_j)
    own_ids = jnp.arange(nb, dtype=jnp.int32)[:, None]
    nbr4 = jnp.concatenate([own_ids, nbr_pos], axis=1)
    nbr4 = jnp.where(table.mask[:, None], nbr4, -1)
    tgt = nbr4[bin_block_safe].T
    tgt = jnp.where((bin_live & ~bad_bin)[None, :], tgt, -1)
    if side == 8:
        spilled = cube.reshape(B, 2, 4, 2, 4, 3).transpose(
            1, 3, 0, 2, 4, 5).reshape(4, B, 16, 3)
    else:
        spill = jnp.asarray(_SPILL2)
        spilled = jnp.einsum("dts,nsc->dntc", spill, cube, precision=_PREC,
                             preferred_element_type=jnp.float32)
    use_seg = cfg.use_segments
    if use_seg is None:
        use_seg = nb * 4 * B > (1 << 27)
    if use_seg:
        seg = jnp.where(tgt >= 0, tgt, nb).reshape(-1)
        acc = jax.ops.segment_sum(
            spilled.reshape(4 * B, 16 * 3), seg,
            num_segments=nb + 1)[:nb].reshape(nb, 16, 3)
        sel = None
    else:
        sel = (tgt.reshape(-1)[None, :] ==
               jnp.arange(nb, dtype=jnp.int32)[:, None]).astype(
            jnp.float32)
        acc = jax.lax.dot_general(
            sel, spilled.reshape(4 * B, 16 * 3),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(nb, 16, 3)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    corners = jnp.asarray(neighbor_offsets(2, 0, 3))
    node_x = (coords[:, None, :] * 4 +
              corners[None]).astype(gv.dtype) * dx + origin_w
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    if use_seg:
        safe = jnp.clip(tgt, 0, nb - 1)
        Vd = jnp.where((tgt >= 0)[..., None, None], gv[safe], 0.0)
    else:
        Vd = jax.lax.dot_general(
            sel, gv.reshape(nb, 16 * 2),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(4, B, 16, 2)
    if side == 8:
        Vbin = Vd.reshape(2, 2, B, 4, 4, 2).transpose(
            2, 0, 3, 1, 4, 5).reshape(B, 64, 2)
    else:
        pull = jnp.asarray(_PULL2)
        Vbin = jnp.einsum("dst,dnte->nse", pull, Vd, precision=_PREC,
                          preferred_element_type=jnp.float32)
    Vac = jnp.moveaxis(Vbin.reshape(B, side, side, 2), 1, 2
                       ).reshape(B, side, 2 * side)
    P0 = jnp.einsum("bkm,bmA->bkA", wy, Vac, precision=_PREC,
                    preferred_element_type=jnp.float32)
    P1 = jnp.einsum("bkm,bmA->bkA", wy_i, Vac, precision=_PREC,
                    preferred_element_type=jnp.float32)
    P0r = P0.reshape(B, K, side, 2)
    P1r = P1.reshape(B, K, side, 2)
    s0 = jnp.einsum("bka,bkac->bkc", wx, P0r)
    sx = jnp.einsum("bka,bkac->bkc", wx_i, P0r)
    sy = jnp.einsum("bka,bkac->bkc", wx, P1r)

    v_new = s0
    Bmat = v_new[..., :, None] * rel0[..., None, :] + \
        dx * jnp.stack([sx, sy], axis=-1)
    C_new = Dinv * Bmat
    J_new = Jb * (1.0 + dt * jnp.trace(C_new, axis1=-2, axis2=-1))
    J_new = jnp.maximum(J_new, j_clamp)
    x_new = xb + dt * v_new

    base_new = jnp.floor((x_new - origin_w) / dx - 0.5).astype(jnp.int32)
    off_new = base_new - borigin[:, None, :]
    if cfg.recenter:
        # Galilean recentering — see the elastic step / BinnedConfig2
        asum = jnp.maximum(jnp.sum(lane_alive.astype(jnp.int32)), 1)
        mean_off = (jnp.sum(jnp.where(lane_alive[..., None], off_new, 0),
                            axis=(0, 1)).astype(jnp.float32) / asum)
        shift = jnp.clip(jnp.round(mean_off - 0.5 * (side - 3)),
                         -1.0, 1.0).astype(jnp.int32)
        off_new = off_new - shift[None, None, :]
        tm = grid.transform.matrix.at[:2, 2].add(
            shift.astype(jnp.float32) * dx)
        grid = dataclasses.replace(
            grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = jnp.any(lane_alive[..., None] &
                      ((off_new < 0) | (off_new > side - 3)))

    ok2 = lane_alive[..., None]
    ncols = jnp.concatenate(
        [jnp.where(ok2, x_new, xb), jnp.where(ok2, v_new, vb),
         jnp.where(lane_alive, J_new, Jb)[..., None],
         jnp.where(ok2[..., None], C_new, Cb).reshape(B, K, 4),
         mban[..., None], volb[..., None]], axis=-1).reshape(L, lay["W"])

    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=overflow, needs_rebin=escaped)


def rollout_fluid_binned2(sim: MPMSim, state: MPMState, dt,
                          cfg: BinnedConfig2,
                          n_steps: int) -> Tuple[MPMState, jax.Array]:
    """n adaptive fluid steps in bin order; unbin once at the end."""
    st = bin_fluid_state(sim, state, cfg)

    def body(_, s):
        s = jax.lax.cond(s.needs_rebin,
                         lambda t: _rebin(sim, t, cfg), lambda t: t, s)
        return explicit_fluid_step_binned2(sim, s, dt, cfg, rebin=False)

    st = jax.lax.fori_loop(0, n_steps, body, st)
    return unbin_fluid_state(st, state), st.overflow
