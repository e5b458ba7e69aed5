"""Binned MPM transfers — the fast XLA path, exposed as reusable machinery.

The baseline ``explicit_step``'s per-lane table queries (27N searchsorted
gathers) and 27N scatter-add dominated its step (chosen before the move to the
GPU; not re-measured on the H100).  This module removes both, following the
structure the reference's upstream (claymore-style MGMPM) uses on GPUs —
re-expressed as dense XLA ops:

1. particles are stable-sorted by active-block slot and packed into
   fixed-size **bins** (``BIN_SIZE`` particles, each bin belongs to one
   block) — built from one sort + searchsorted on the (tiny) block table;
2. P2G/G2P are per-bin **batched matmuls**: separable B-spline stencils
   ``[bins, K, 6]`` contract against particle payloads; the APIC node
   -position dependence is decomposed into 4 separable terms;
3. bins -> blocks **and** the inter-block halo merge happen in a single
   concatenated one-hot selection matmul (HIGHEST precision = exact fp32)
   — zero gathers in grid assembly; the transposed selection assembles the
   per-bin halo velocity cubes for G2P the same way.

The bin workspace (:func:`prepare_bins` -> :class:`BinWorkspace`) is
separated from the physics so the **implicit** solver reuses it: stencils
and selection matrices are built once per step and every CG iteration's
operator apply is two einsum passes + two selection matmuls
(:mod:`zpc_tpu.sim.implicit_binned`).

Bin overflow is detected exactly (bht ``_buildSuccess`` idiom) — callers
grow ``bins_capacity`` and re-trace.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import SparseGrid, neighbor_offsets
from ..math.interpolation import bspline_weights
from ..math.vecmat import mm, scale_trailing
from .mpm import MPMSim, MPMState

__all__ = ["explicit_step_binned", "BinnedConfig", "BinWorkspace",
           "prepare_bins", "BIN_SIZE"]

BIN_SIZE = 128  # particles per bin: matmul-friendly contraction dim


@dataclasses.dataclass(frozen=True)
class BinnedConfig:
    bins_capacity: int          # static bin count (>= N/BIN_SIZE * margin)
    halo: int = 2               # 4^3 block + 2 halo = 6^3 footprint


# full float32 products in the stencil contractions and one-hot
# selections (as in mpm_binned2): lower settings may run as TF32 on the GPU
_PREC = jax.lax.Precision.HIGHEST


def _einsum_nk(S, Q):
    """[B,K,M] x [B,K,C] -> [B,M,C] (fp32 accumulation)."""
    return jnp.einsum("bkm,bkc->bmc", S, Q, precision=_PREC,
                      preferred_element_type=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BinWorkspace:
    """Per-step bin structure + stencils, shared by explicit/implicit paths.

    Shapes: B = bins_capacity, K = BIN_SIZE, nb = block capacity.
    """

    grid: SparseGrid            # activated, zeroed
    overflow: jax.Array
    lane_ok: jax.Array          # [B, K]
    gsafe: jax.Array            # [B, K] particle ids (clamped)
    flat_of_p: jax.Array        # [N] original -> flat bin lane
    pmask0: jax.Array           # [N]
    rel0: jax.Array             # [B, K, 3] block-origin-world - x_p
    wx: jax.Array               # [6, B, K] per-plane x-axis stencils
    wx_i: jax.Array             # [6, B, K] index-weighted
    S0: jax.Array               # [B, K, 36]
    S1: jax.Array
    S2: jax.Array
    sel_cat: jax.Array          # [nb, 8B] one-hot (small problems) or [1,1]
    tgt8: jax.Array             # [8, B] target block per (dir, bin), -1 dead
    xb: jax.Array               # gathered particle channels
    vb: jax.Array
    Fb: jax.Array
    Cb: jax.Array
    mban: jax.Array
    volb: jax.Array
    use_segments: bool = dataclasses.field(metadata=dict(static=True),
                                           default=False)

    # -- derived sizes ---------------------------------------------------------
    @property
    def nbins(self) -> int:
        return self.lane_ok.shape[0]

    @property
    def nb(self) -> int:
        return self.grid.block_capacity

    def bin_leaves(self, obj):
        """Gather per-particle pytree leaves into the bin layout."""
        if obj is None:
            return None
        N = self.pmask0.shape[0]

        def g(a):
            if not (hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == N):
                return a
            out = a[self.gsafe]
            extra = (1,) * (out.ndim - 2)
            return jnp.where(self.lane_ok.reshape(
                self.lane_ok.shape + extra), out, 0)

        return jax.tree.map(g, obj)

    # -- transfer primitives ----------------------------------------------------
    def p2g(self, Q0, QA) -> jax.Array:
        """Scatter separable payloads to grid nodes: ``[nb, 64, C]``.

        node(a,b,c) += wx_a wy_b wz_c Q0 + dx-scaled index-weighted terms
        QA[d] paired with the d-axis index stencil (the APIC decomposition).
        """
        side, C = 6, Q0.shape[-1]
        nbins = self.nbins
        out = jnp.zeros((nbins, side, 36, C), jnp.float32)
        for a in range(side):
            # scale_trailing (not `wx[a][..., None] *`): a hoisted trailing-1
            # broadcast is stored 128x lane-padded by XLA inside solver loops
            wa, wai = self.wx[a], self.wx_i[a]
            qa = scale_trailing(wa, Q0) + scale_trailing(wai, QA[0])
            cube_a = _einsum_nk(self.S0, qa)
            cube_a = cube_a + _einsum_nk(self.S1, scale_trailing(wa, QA[1]))
            cube_a = cube_a + _einsum_nk(self.S2, scale_trailing(wa, QA[2]))
            out = out.at[:, a].set(cube_a)
        out = out.reshape(nbins, 216, C)
        from ..ops.spill_tables import _SPILL_ALL

        spill = jnp.asarray(_SPILL_ALL[:, :, :216])     # [8, 64, 216]
        spilled = jnp.einsum("dts,nsc->dntc", spill, out, precision=_PREC,
                             preferred_element_type=jnp.float32)
        if self.use_segments:
            # large problems: the one-hot matrix would be O(nb * 8B) —
            # segment-sum scales linearly instead
            seg = jnp.where(self.tgt8 >= 0, self.tgt8, self.nb).reshape(-1)
            acc = jax.ops.segment_sum(
                spilled.reshape(8 * nbins, 64 * C), seg,
                num_segments=self.nb + 1)[:self.nb]
            return acc.reshape(self.nb, 64, C)
        acc = jax.lax.dot_general(
            self.sel_cat, spilled.reshape(8 * nbins, 64 * C),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(self.nb, 64, C)
        return acc

    def g2p(self, node_vals: jax.Array):
        """Gather grid node values back to particles.

        ``node_vals``: [nb, 64, C].  Returns (s0, s_idx) where
        s0[B,K,C] = sum w * val and s_idx = [sx, sy, sz] index-weighted sums
        (building blocks for velocity + affine/B reconstruction).
        """
        nb, _, C = node_vals.shape
        nbins = self.nbins
        if self.use_segments:
            safe = jnp.clip(self.tgt8, 0, nb - 1)
            Vd = node_vals[safe]                        # [8, B, 64, C]
            Vd = jnp.where((self.tgt8 >= 0)[..., None, None], Vd, 0.0)
        else:
            Vd = jax.lax.dot_general(
                self.sel_cat, node_vals.reshape(nb, 64 * C),
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32, precision=_PREC,
            ).reshape(8, nbins, 64, C)
        from ..ops.spill_tables import _PULL_ALL

        pull = jnp.asarray(_PULL_ALL[:, :, :64])        # [8, 216, 64]
        Vbin = jnp.einsum("dst,dnte->nse", pull, Vd, precision=_PREC,
                          preferred_element_type=jnp.float32
                          ).reshape(nbins, 6, 36, C)
        K = BIN_SIZE
        s0 = jnp.zeros((nbins, K, C), jnp.float32)
        sx = jnp.zeros((nbins, K, C), jnp.float32)
        sy = jnp.zeros((nbins, K, C), jnp.float32)
        sz = jnp.zeros((nbins, K, C), jnp.float32)
        for a in range(6):
            Va = Vbin[:, a]
            m0 = jnp.einsum("bkm,bmc->bkc", self.S0, Va, precision=_PREC,
                            preferred_element_type=jnp.float32)
            m1 = jnp.einsum("bkm,bmc->bkc", self.S1, Va, precision=_PREC,
                            preferred_element_type=jnp.float32)
            m2 = jnp.einsum("bkm,bmc->bkc", self.S2, Va, precision=_PREC,
                            preferred_element_type=jnp.float32)
            wa, wai = self.wx[a], self.wx_i[a]
            s0 = s0 + scale_trailing(wa, m0)
            sx = sx + scale_trailing(wai, m0)
            sy = sy + scale_trailing(wa, m1)
            sz = sz + scale_trailing(wa, m2)
        return s0, [sx, sy, sz]

    def node_positions(self) -> jax.Array:
        """World positions of grid nodes ``[nb, 64, 3]``."""
        g = self.grid
        corners = jnp.asarray(neighbor_offsets(3, 0, 3))
        cells = g.table.active_coords[:, None, :] * 4 + corners[None]
        origin_w = g.transform.matrix[:3, 3]
        return cells.astype(jnp.float32) * g.dx + origin_w

    def unbin(self, binned: jax.Array, orig: jax.Array) -> jax.Array:
        """[B,K,...] -> original particle order, padding preserved."""
        K = BIN_SIZE
        flatv = binned.reshape((self.nbins * K,) + binned.shape[2:])
        out = flatv[self.flat_of_p]
        extra = (1,) * (orig.ndim - 1)
        return jnp.where(self.pmask0.reshape((-1,) + extra), out, orig)


def prepare_bins(sim: MPMSim, state: MPMState, cfg: BinnedConfig
                 ) -> BinWorkspace:
    """Partition + bin construction + stencils (once per step).

    One N-element sort total: the sorted (packed block key, particle id)
    pairs drive BOTH the block-table compaction and the bin grouping (the
    pre-dilation group order equals the dilated-table slot order because
    both are key-ascending; dilation-added blocks carry no particles).
    """
    import dataclasses as _dc

    from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                          build_block_table, pack_coords)

    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    assert dim == 3 and bs == 4, "binned path is specialized to 3-D, bs=4"
    assert sim.order == 2, "binned stencils are quadratic (3-tap) only"
    nb = grid.block_capacity
    dx = grid.dx
    N = p.capacity
    nbins = cfg.bins_capacity
    K = BIN_SIZE
    side = 6

    pmask0 = p.mask
    x0 = p["x"]
    inv_dx = 1.0 / dx
    origin_w = grid.transform.matrix[:dim, 3]
    xi0 = (x0 - origin_w) * inv_dx
    base0, _, _ = bspline_weights(xi0, sim.order)
    pblock0 = jnp.floor_divide(base0, bs)

    # ---- single sort: (packed block key, particle id) -----------------------
    keys = jnp.where(pmask0, pack_coords(pblock0), KEY_SENTINEL)
    pid = jnp.arange(N, dtype=jnp.int32)
    skey, sid = jax.lax.sort((keys, pid), num_keys=1, is_stable=True)
    neq = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    neq = neq & (skey != KEY_SENTINEL)
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1       # group id per lane
    n_groups = rank[-1] + 1
    lane_i = jnp.arange(N, dtype=jnp.int32)
    # pre-dilation table keys (sorted-unique compaction)
    dst = jnp.clip(jnp.where(neq, rank, nb), 0, nb)
    t1_keys = jnp.full((nb + 1,), KEY_SENTINEL, jnp.int32).at[dst].set(
        skey)[:nb]
    # per-group sorted ranges
    g_start = jnp.zeros((nb + 1,), jnp.int32).at[dst].set(lane_i)[:nb]
    valid_count = jnp.sum(pmask0.astype(jnp.int32))
    g_end = jnp.concatenate(
        [jnp.where(jnp.arange(1, nb) < n_groups, g_start[1:], valid_count),
         valid_count[None]])
    g_end = jnp.where(jnp.arange(nb) < n_groups, g_end, g_start)

    # ---- dilation: rebuild table over group keys + apron --------------------
    from ..containers.block_table import unpack_key

    offs = jnp.asarray(neighbor_offsets(dim, 0, 1))
    t1_coords = unpack_key(t1_keys, dim)
    cand = (t1_coords[:, None, :] + offs[None, :, :]).reshape(-1, dim)
    vmask = jnp.repeat(jnp.arange(nb) < n_groups, offs.shape[0])
    table, inv_cand = build_block_table(cand, nb, valid=vmask, dim=dim)
    remap = inv_cand[jnp.arange(nb) * offs.shape[0]]   # group -> final slot
    grid = _dc.replace(grid, table=table).zeroed()

    # ---- bins over groups ----------------------------------------------------
    counts = g_end - g_start
    bins_per_group = (counts + K - 1) // K
    bin_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(bins_per_group)]).astype(jnp.int32)
    total_bins = bin_start[-1]
    overflow = (total_bins > nbins) | (n_groups > nb)

    bin_idx = jnp.arange(nbins, dtype=jnp.int32)
    bin_group = jnp.clip(
        (jnp.searchsorted(bin_start, bin_idx, side="right") - 1
         ).astype(jnp.int32), 0, nb - 1)
    bin_block = jnp.clip(remap[bin_group], 0, nb - 1)
    bin_live = bin_idx < total_bins
    local_bin = bin_idx - bin_start[bin_group]
    lane = jnp.arange(K, dtype=jnp.int32)
    spos = (g_start[bin_group] + local_bin * K)[:, None] + lane[None, :]
    lane_ok = bin_live[:, None] & (spos < g_end[bin_group][:, None])
    spos_safe = jnp.clip(spos, 0, N - 1)
    pids = jnp.where(lane_ok, sid[spos_safe], -1)
    gsafe = jnp.maximum(pids, 0)

    # inverse mapping (original particle -> flat bin lane)
    inv_sorted = jnp.zeros((N,), jnp.int32).at[sid].set(lane_i)
    grp_of_sorted = rank
    grp_of_p = jnp.clip(grp_of_sorted[jnp.clip(inv_sorted, 0, N - 1)],
                        0, nb - 1)
    off_in_grp = inv_sorted - g_start[grp_of_p]
    bin_of_p = bin_start[grp_of_p] + off_in_grp // K
    lane_of_p = off_in_grp % K
    flat_of_p = jnp.clip(bin_of_p * K + lane_of_p, 0, nbins * K - 1)

    # packed particle gather (one indexed op)
    packed = jnp.concatenate(
        [x0, p["v"], p["F"].reshape(N, 9), p["C"].reshape(N, 9),
         p["m"][:, None], p["vol"][:, None]], axis=1)     # [N, 26]
    pb = packed[gsafe]
    pb = jnp.where(lane_ok[..., None], pb, 0.0)
    xb = pb[..., 0:3]
    vb = pb[..., 3:6]
    Fb = pb[..., 6:15].reshape(nbins, K, 3, 3)
    Cb = pb[..., 15:24].reshape(nbins, K, 3, 3)
    mban = jnp.where(lane_ok, pb[..., 24], 0.0)
    volb = jnp.where(lane_ok, pb[..., 25], 0.0)

    # stencils
    xib = (xb - origin_w) * inv_dx
    baseb, wb, _ = bspline_weights(xib, sim.order)
    borigin = table.active_coords[bin_block] * bs
    off = jnp.clip(baseb - borigin[:, None, :], 0, bs - 1)
    sidx = jnp.arange(side, dtype=jnp.int32)

    def stencil_axis(d):
        w_axis = jnp.zeros((nbins, K, side), wb.dtype)
        for j in range(3):
            hit = (sidx[None, None, :] == (off[..., d] + j)[..., None])
            w_axis = w_axis + jnp.where(hit, wb[..., d, j:j + 1], 0.0)
        return w_axis

    wx, wy, wz = stencil_axis(0), stencil_axis(1), stencil_axis(2)
    fidx = sidx.astype(wx.dtype)
    wx_i, wy_i, wz_i = wx * fidx, wy * fidx, wz * fidx
    S0 = (wy[:, :, :, None] * wz[:, :, None, :]).reshape(nbins, K, 36)
    S1 = (wy_i[:, :, :, None] * wz[:, :, None, :]).reshape(nbins, K, 36)
    S2 = (wy[:, :, :, None] * wz_i[:, :, None, :]).reshape(nbins, K, 36)
    # plane-major stencil layout (see p2g comment)
    wx = jnp.moveaxis(wx, 2, 0)
    wx_i = jnp.moveaxis(wx_i, 2, 0)
    # lever arm of the block-origin node: x_node - x_p in WORLD space.
    # Work in index space (borigin - xib) so the grid transform translation
    # is included (world = index*dx + origin_w).
    rel0 = (borigin[:, None, :].astype(xb.dtype) - xib) * dx

    # concatenated one-hot selection (bins + 7 spill dirs -> blocks)
    dirs = [d for d in neighbor_offsets(3, 0, 1).tolist() if any(d)]
    coords = table.active_coords
    dirs_j = jnp.asarray(dirs, jnp.int32)
    nbr_pos = jax.vmap(
        lambda d: table.query(coords + d[None, :]), out_axes=1)(dirs_j)
    own_ids = jnp.arange(nb, dtype=jnp.int32)[:, None]
    nbr8_blocks = jnp.concatenate([own_ids, nbr_pos], axis=1)
    nbr8_blocks = jnp.where(table.mask[:, None], nbr8_blocks, -1)
    tgt = nbr8_blocks[bin_block].T                      # [8, nbins]
    tgt = jnp.where(bin_live[None, :], tgt, -1)
    # one-hot matmul wins at small scale (exact); segment/gather wins at
    # large scale (the one-hot would be O(nb * 8B) memory)
    use_segments = nb * 8 * nbins > (1 << 27)
    if use_segments:
        sel_cat = jnp.zeros((1, 1), jnp.float32)
    else:
        sel_cat = (tgt.reshape(-1)[None, :] ==
                   jnp.arange(nb, dtype=jnp.int32)[:, None]
                   ).astype(jnp.float32)

    return BinWorkspace(grid, overflow, lane_ok, gsafe, flat_of_p, pmask0,
                        rel0, wx, wx_i, S0, S1, S2, sel_cat, tgt,
                        xb, vb, Fb, Cb, mban, volb, use_segments)


def explicit_step_binned(sim: MPMSim, state: MPMState, dt,
                         cfg: BinnedConfig) -> Tuple[MPMState, jax.Array]:
    """One explicit APIC step via the binned transfer path.

    Returns (new_state, overflow_flag).  Physics identical to
    :func:`zpc_tpu.sim.mpm.explicit_step` up to summation order.
    """
    p = state.particles
    ws = prepare_bins(sim, state, cfg)
    grid = ws.grid
    dx = grid.dx
    nb = grid.block_capacity
    Dinv = 4.0 / (dx * dx)
    model = ws.bin_leaves(sim.model)
    plasticity = ws.bin_leaves(sim.plasticity)

    # ---- P2G ----------------------------------------------------------------
    tau = model.kirchhoff(ws.Fb)
    A = ws.mban[..., None, None] * ws.Cb - \
        (dt * Dinv * ws.volb)[..., None, None] * tau
    u0 = ws.mban[..., None] * ws.vb + \
        jnp.einsum("bkij,bkj->bki", A, ws.rel0)
    Q0 = jnp.concatenate([ws.mban[..., None], u0], -1)          # [B,K,4]
    zero = jnp.zeros_like(ws.mban)[..., None]
    QA = [jnp.concatenate([zero, dx * A[..., :, d]], -1) for d in range(3)]
    acc = ws.p2g(Q0, QA)                                        # [nb,64,4]
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update ----------------------------------------------------------
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    node_x = ws.node_positions()
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- G2P ----------------------------------------------------------------
    s0, (sx, sy, sz) = ws.g2p(gv)
    v_new = s0
    Bmat = v_new[..., :, None] * ws.rel0[..., None, :] + \
        dx * jnp.stack([sx, sy, sz], axis=-1)
    C_new = Dinv * Bmat
    eye = jnp.eye(3, dtype=ws.Fb.dtype)
    F_new = mm(eye + dt * C_new, ws.Fb)
    upd = {}
    if plasticity is not None and p.has_prop("Jp"):
        Jpb = ws.bin_leaves(p["Jp"])
        F_new, Jp_new = plasticity.project(F_new, Jpb)
    x_new = ws.xb + dt * v_new

    channels = dict(
        x=ws.unbin(x_new, p["x"]), v=ws.unbin(v_new, p["v"]),
        F=ws.unbin(F_new, p["F"]), C=ws.unbin(C_new, p["C"]))
    if plasticity is not None and p.has_prop("Jp"):
        channels["Jp"] = ws.unbin(Jp_new, p["Jp"])
    particles = p.update(**channels)
    grid = grid.with_data(m=gm, v=gv)
    return MPMState(particles, grid, max_vel), ws.overflow
