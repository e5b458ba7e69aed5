"""Binned MPM v2 — gather-free rebinning + fused transfer einsums.

Evolution of :mod:`zpc_tpu.sim.mpm_binned` driven by a hardware profile
of v1 (chosen before the move to the GPU; not re-measured on the H100):

====================  =========================================
v1 stage              v2 replacement
====================  =========================================
pack gather [N,26]    **pad-in-the-sort**: one wide stable
unbin gather [N,24]   ``lax.sort`` carries the whole particle
sort (key,pid)        pack; dummy lanes keyed per block make
                      every block segment a multiple of K, so
                      the sorted array *reshapes* into bins —
                      zero gathers/scatters
p2g einsums (18 tiny) one K-stacked einsum [B,3K,36]x[B,3K,24]
g2p einsums           three [B,K,36]x[B,36,18] einsums
====================  =========================================

State persists in **bin (sorted) order** across steps of a rollout —
original order is restored once at the end via the carried pid column.

Shared physics with v1/explicit_step (same oracle tests).  Reference
lineage: claymore-style particle bins over block-sparse grids
(simulation/transfer/P2G.hpp / G2P2G.hpp), re-expressed as sort + matmul
contractions instead of shared-memory atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers.block_table import (KEY_SENTINEL, build_block_table,
                                      pack_coords, unpack_key)
from ..geometry.collider import resolve_boundaries
from ..geometry.sparse_grid import SparseGrid, neighbor_offsets
from ..math.interpolation import bspline_weights
from ..math.vecmat import mm
from .mpm import MPMSim, MPMState

__all__ = ["explicit_step_binned2", "rollout_binned2", "BinnedConfig2",
           "BinState", "bin_state", "unbin_state", "rebin_adaptive",
           "adaptive_chain"]

K = 128                      # particles per bin
SIDE = 6                     # 4-cell block + 2-cell halo window
# full float32 products in the transfer contractions: on the GPU, HIGH
# (and DEFAULT) let XLA run float32 dots as TF32, whose 10-bit mantissa
# put the 1M-particle step's F 4x outside the reference tolerance
_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class BinnedConfig2:
    bins_capacity: int           # static bin count (lanes = bins * K)
    block_capacity: Optional[int] = None  # dilated table cap (None = grid's)
    use_segments: Optional[bool] = None   # None = auto by one-hot size
    sort_chunk: int = 0          # 0 = permutation sort + one row gather
                                 # (see _chunked_stable_sort)
                                 # >0 = payload columns per stable sort
    slack: int = 1               # drift slack in cells before a rebin.
                                 # 0: exact 6-node window, rebin whenever
                                 #    any stencil base crosses a cell.
                                 # 1: bins keyed on floor((base-1)/4) so
                                 #    the nominal window sits at [1,4] of
                                 #    an 8-node span — particles drift a
                                 #    full cell each way before needing a
                                 #    rebin, and the 8-node window aligns
                                 #    to block boundaries, turning the
                                 #    spill/pull matmuls into reshapes.
    migrate_capacity: int = 0    # >0 enables the incremental rebin: up to
                                 # this many escapees migrate into free
                                 # lanes of their destination block's
                                 # existing bins (table/bins frozen),
                                 # falling back to the full sort-based
                                 # rebin when the move needs structure.
                                 # Requires slack=1.
    reserve_bins: int = 0        # extra all-dummy bins per block at full
                                 # rebin time: free-lane headroom for the
                                 # incremental path.  Costs nothing in the
                                 # step (transfers run over the static
                                 # bins_capacity either way) but consumes
                                 # bins_capacity budget.
    recenter: bool = True        # Galilean frame shift: move the grid
                                 # origin by the bulk integer cell drift
                                 # each step so pure translation never
                                 # forces a rebin.  The MPM grid is
                                 # scratch (rebuilt by P2G every step),
                                 # so shifting its origin between steps
                                 # is physically free; colliders are
                                 # evaluated at world node positions and
                                 # stay exact.
    chunk_bins: int = 0          # >0: run the transfer pipeline in
                                 # bin-chunks of this size (lax.scan).
                                 # Chunking bounds the working set of
                                 # the per-particle intermediates
                                 # ([B,K,64] stencils, [B,K,72] einsum
                                 # planes) at any scale for one extra
                                 # [nb,64,4] accumulator carry (sized
                                 # before the move to the GPU; not
                                 # re-measured on the H100).  Must
                                 # divide bins_capacity.

    @property
    def side(self) -> int:
        assert self.slack in (0, 1)
        return 6 + 2 * self.slack


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BinState:
    """Particle state living in bin (block-sorted, K-padded) order.

    ``cols``: [L, W] packed channels (x3 v3 F9 C9 m1 vol1 [Jp1]); dead /
    dummy lanes carry m=0.  ``pid``: [L] original particle index, -1 on
    dummy lanes.  The grid is rebuilt every step.
    """

    cols: jax.Array
    pid: jax.Array
    grid: SparseGrid
    max_vel: jax.Array
    overflow: jax.Array
    needs_rebin: jax.Array       # any particle left its bin's block window
    bin_block: jax.Array         # [bins] table slot per bin, frozen at
                                 # rebin time (-1 = dead bin).  With
                                 # drift slack the lane-0 position may
                                 # cross a cell boundary mid-interval, so
                                 # the mapping cannot be recomputed.
    nbr8: jax.Array              # [nb, 2^dim] spill-target slots (own +
                                 # +1-per-axis neighbors) per table slot,
                                 # frozen with the table: the 7 neighbor
                                 # queries cost ~77 sequential searchsorted
                                 # passes — latency, not bandwidth — so
                                 # they are cached at rebin time instead
                                 # of rebuilt every step.

    @property
    def has_jp(self) -> bool:
        d = self.grid.dim
        return self.cols.shape[1] == 2 * d + 2 * d * d + 3


def _pack_cols(p, pmask):
    n = p.capacity
    d = p["x"].shape[-1]
    cols = [p["x"], p["v"], p["F"].reshape(n, d * d),
            p["C"].reshape(n, d * d),
            jnp.where(pmask, p["m"], 0.0)[:, None],
            jnp.where(pmask, p["vol"], 0.0)[:, None]]
    if p.has_prop("Jp"):
        cols.append(p["Jp"][:, None])
    return jnp.concatenate(cols, axis=1)


def _col_layout(dim):
    """Column offsets of the packed layout for a given dim."""
    dd = dim * dim
    return dict(x=(0, dim), v=(dim, 2 * dim), F=(2 * dim, 2 * dim + dd),
                C=(2 * dim + dd, 2 * dim + 2 * dd), m=2 * dim + 2 * dd,
                vol=2 * dim + 2 * dd + 1, Jp=2 * dim + 2 * dd + 2)


def bin_state(sim: MPMSim, state: MPMState, cfg: BinnedConfig2) -> BinState:
    """Enter bin order: one wide sort with per-block K-padding dummies."""
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    assert dim in (2, 3) and bs == 4, "binned2 needs bs=4, dim 2 or 3"
    assert sim.order == 2
    N = p.capacity
    L = cfg.bins_capacity * K
    assert L >= N, "bins_capacity * K must cover particle capacity"

    pmask = p.mask
    cols = _pack_cols(p, pmask)
    pid = jnp.where(pmask, jnp.arange(N, dtype=jnp.int32), -1)

    origin_w = grid.transform.matrix[:dim, dim]
    xi = (p["x"] - origin_w) / grid.dx
    base, _, _ = bspline_weights(xi, sim.order)
    keys = jnp.where(pmask,
                     pack_coords(jnp.floor_divide(base - cfg.slack, bs)),
                     KEY_SENTINEL)
    nb = cfg.block_capacity or grid.block_capacity
    st = _sort_into_bins(keys, cols, pid, cfg, nb, dim)
    return dataclasses.replace(
        st, grid=dataclasses.replace(st.grid, transform=grid.transform),
        max_vel=state.max_vel)


def _sort_into_bins(keys: jax.Array, cols: jax.Array, pid: jax.Array,
                    cfg: BinnedConfig2, nb: int,
                    dim: int = 3) -> BinState:
    """Core rebinning: composite (block_key, is_dummy) sort with padding.

    Returns a BinState whose grid holds ONLY the table (data unset).
    """
    N = keys.shape[0]
    L = cfg.bins_capacity * K
    if L < N:
        raise ValueError(
            f"BinnedConfig2.bins_capacity={cfg.bins_capacity} gives only "
            f"{L} lanes (x{K}/bin) for {N} particle lanes; raise "
            f"bins_capacity to at least {-(-N // K)} (plus padding slack)")
    npad = L - N

    # per-block counts from a key-only sort (cheap: 1 col)
    skey = jax.lax.sort((keys,), num_keys=1)[0]
    neq = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    live = skey != KEY_SENTINEL
    neq = neq & live
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1          # group id
    n_groups = jnp.maximum(rank[-1] + 1, 0)
    # counts per group via boundary positions
    lane = jnp.arange(N, dtype=jnp.int32)
    nbq = cfg.bins_capacity
    gstart = jnp.zeros((nbq + 1,), jnp.int32).at[
        jnp.clip(jnp.where(neq, rank, nbq), 0, nbq)].set(lane)[:nbq]
    nlive = jnp.sum(live.astype(jnp.int32))
    gend = jnp.concatenate(
        [jnp.where(jnp.arange(1, nbq) < n_groups, gstart[1:], nlive),
         nlive[None]])
    gid = jnp.arange(nbq, dtype=jnp.int32)
    gvalid = gid < n_groups
    counts = jnp.where(gvalid, gend - gstart, 0)
    gkeys = jnp.where(
        gvalid,
        jnp.full((nbq + 1,), KEY_SENTINEL, jnp.int32).at[
            jnp.clip(jnp.where(neq, rank, nbq), 0, nbq)].set(skey)[:nbq],
        KEY_SENTINEL)
    pads = jnp.where(gvalid,
                     (-counts) % K + cfg.reserve_bins * K, 0)
    total = jnp.sum(counts + pads)

    # dummy lanes: j-th dummy belongs to the group whose cum-pad covers j
    padcum = jnp.cumsum(pads)
    # overflow must ALSO fire when the padding budget (npad = L - N dummy
    # lanes) is exhausted: with dead particle lanes (capacity > size) the
    # lane total can fit in L while the dummies needed (padcum[-1]) exceed
    # npad — truncated dummies would silently mix two blocks in one bin
    overflow = (total > L) | (n_groups > nbq) | (padcum[-1] > npad)
    dense = _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, npad)
    in_budget = jnp.arange(npad, dtype=jnp.int32) < jnp.minimum(
        padcum[-1], npad)
    dummy_keys = jnp.where(in_budget, dense, KEY_SENTINEL)

    # composite key: (block_key, is_dummy) — dummies sort after reals
    all_keys = jnp.concatenate([keys, dummy_keys])
    is_dummy = jnp.concatenate([jnp.zeros((N,), jnp.int32),
                                jnp.ones((npad,), jnp.int32)])
    ckey = all_keys * 2 + is_dummy          # keys are 30-bit, fits int32
    ckey = jnp.where(all_keys == KEY_SENTINEL, KEY_SENTINEL, ckey)

    pad_pid = jnp.full((npad,), -1, jnp.int32)
    allcols = [jnp.concatenate([cols[:, i], jnp.zeros((npad,), cols.dtype)])
               for i in range(cols.shape[1])]
    sck, spid, scols = _chunked_stable_sort(
        ckey, jnp.concatenate([pid, pad_pid]), allcols, cfg.sort_chunk)

    # block table (dilated) from the group keys
    offs = jnp.asarray(neighbor_offsets(dim, 0, 1))
    gcoords = unpack_key(gkeys, dim)
    cand = (gcoords[:, None, :] + offs[None, :, :]).reshape(-1, dim)
    vmask = jnp.repeat(gvalid, offs.shape[0])
    table, _ = build_block_table(cand, nb, valid=vmask, dim=dim)
    overflow = overflow | (table.count > table.capacity)
    # per-BIN block slot (a group can span several K-bins): from each
    # bin's first sorted lane (dummies carry their group key too)
    first_ck = sck.reshape(cfg.bins_capacity, K)[:, 0]
    first_key = jnp.where(first_ck == KEY_SENTINEL, KEY_SENTINEL,
                          first_ck >> 1)
    bin_block = jnp.where(first_key == KEY_SENTINEL, -1,
                          table.query_keys(first_key))
    ncell = 4 ** dim
    data = {"m": jnp.zeros((nb, ncell), jnp.float32),
            "v": jnp.zeros((nb, ncell, dim), jnp.float32)}
    grid = SparseGrid(table, data, None, 4, dim)  # transform set by caller
    return BinState(scols, spid, grid, jnp.float32(0.0), overflow,
                    jnp.bool_(False), bin_block, _neighbor_slots(table, dim))



def _neighbor_slots(table, dim):
    """[nb, 2^dim] spill-target table slots: own + positive neighbors
    (-1 where absent).  Depends only on the table — cached on BinState."""
    dirs = [d for d in neighbor_offsets(dim, 0, 1).tolist() if any(d)]
    coords = table.active_coords
    dirs_j = jnp.asarray(dirs, jnp.int32)
    nbr_pos = jax.vmap(
        lambda d: table.query(coords + d[None, :]), out_axes=1)(dirs_j)
    own_ids = jnp.arange(table.capacity, dtype=jnp.int32)[:, None]
    nbr = jnp.concatenate([own_ids, nbr_pos], axis=1)
    return jnp.where(table.mask[:, None], nbr, -1)


def _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, size):
    """Key for the j-th padding dummy, j in [0, size): the group whose
    cumulative pad range covers j.  Built as a scatter-max at each
    group's pad-start followed by a cummax (gkeys are ascending, so the
    running max IS the covering group's key) — replaces a searchsorted
    of ~12 dependent gather passes.
    Out-of-budget ranks (j >= padcum[-1]) are NOT masked here; callers
    must mask.  Returns [size] int32 keys.
    """
    starts = padcum - pads
    pos = jnp.where(gvalid & (pads > 0), starts, size)
    gmark = jnp.zeros((size + 1,), jnp.int32).at[pos].max(
        jnp.where(gvalid, gkeys, 0), mode="drop")[:size]
    return jax.lax.cummax(gmark)


def _chunked_stable_sort(ckey, pid, cols, chunk):
    """Move (pid + payload columns) into ckey order.

    ``chunk == 0`` (default): ONE stable 3-operand sort produces pid and
    the permutation; the payload moves with a single [L, W] row gather.
    Compile time grew superlinearly with several multi-operand sorts in
    one program (chosen before the move to the GPU; not re-measured on
    the H100), so payload-carrying sorts are opt-in only.

    ``chunk > 0``: chunked stable sorts sharing the permutation through
    key equality (kept for machines where gathers are the bottleneck).
    """
    if chunk == 0:
        lane = jnp.arange(ckey.shape[0], dtype=jnp.int32)
        skey, spid, perm = jax.lax.sort((ckey, pid, lane), num_keys=1,
                                        is_stable=True)
        return skey, spid, jnp.stack(cols, axis=1)[perm]
    first = jax.lax.sort((ckey, pid), num_keys=1, is_stable=True)
    skey, spid = first[0], first[1]
    out = []
    for i in range(0, len(cols), chunk):
        res = jax.lax.sort((ckey, *cols[i:i + chunk]), num_keys=1,
                           is_stable=True)
        out.extend(res[1:])
    return skey, spid, jnp.stack(out, axis=1)


def _rebin(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """Re-sort an existing BinState into fresh bins (bin order in, bin
    order out) — the per-step partition, no gathers."""
    grid = st.grid
    dim = grid.dim
    origin_w = grid.transform.matrix[:dim, dim]
    x = st.cols[:, 0:dim]
    alive = st.pid >= 0
    xi = (x - origin_w) / grid.dx
    base, _, _ = bspline_weights(xi, sim.order)
    keys = jnp.where(alive,
                     pack_coords(jnp.floor_divide(base - cfg.slack, 4)),
                     KEY_SENTINEL)
    # sort keeps L lanes: dead lanes re-keyed as padding dummies
    nb = cfg.block_capacity or grid.table.capacity
    nst = _sort_into_bins_from_lanes(keys, st.cols, st.pid, cfg, nb, dim)
    return dataclasses.replace(
        nst,
        grid=dataclasses.replace(nst.grid, transform=grid.transform),
        max_vel=st.max_vel, overflow=st.overflow | nst.overflow)


def _sort_into_bins_from_lanes(keys, cols, pid, cfg: BinnedConfig2,
                               nb: int, dim: int = 3) -> BinState:
    """Like :func:`_sort_into_bins` but input lanes already number L:
    dead lanes are re-used as the padding budget."""
    L = keys.shape[0]
    nbq = cfg.bins_capacity
    assert L == nbq * K

    skey = jax.lax.sort((keys,), num_keys=1)[0]
    neq = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    live = skey != KEY_SENTINEL
    neq = neq & live
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1
    n_groups = jnp.maximum(rank[-1] + 1, 0)
    lane = jnp.arange(L, dtype=jnp.int32)
    dst = jnp.clip(jnp.where(neq, rank, nbq), 0, nbq)
    gstart = jnp.zeros((nbq + 1,), jnp.int32).at[dst].set(lane)[:nbq]
    nlive = jnp.sum(live.astype(jnp.int32))
    gend = jnp.concatenate(
        [jnp.where(jnp.arange(1, nbq) < n_groups, gstart[1:], nlive),
         nlive[None]])
    gid = jnp.arange(nbq, dtype=jnp.int32)
    gvalid = gid < n_groups
    counts = jnp.where(gvalid, gend - gstart, 0)
    gkeys = jnp.full((nbq + 1,), KEY_SENTINEL, jnp.int32).at[dst].set(
        skey)[:nbq]
    gkeys = jnp.where(gvalid, gkeys, KEY_SENTINEL)
    pads = jnp.where(gvalid,
                     (-counts) % K + cfg.reserve_bins * K, 0)
    overflow = (jnp.sum(counts + pads) > L) | (n_groups > nbq)

    # re-key DEAD lanes as padding dummies.  dead lanes: keys == SENTINEL.
    # j-th dead lane (in lane order) serves group g with padcum[g-1]<=j.
    dead = keys == KEY_SENTINEL
    dead_rank = jnp.cumsum(dead.astype(jnp.int32)) - 1    # per dead lane
    padcum = jnp.cumsum(pads)
    dense = _dummy_keys_by_rank(gkeys, gvalid, pads, padcum, L)
    in_budget = dead & (dead_rank < padcum[-1])
    keys2 = jnp.where(in_budget,
                      dense[jnp.clip(dead_rank, 0, L - 1)], keys)
    ckey = jnp.where(keys2 == KEY_SENTINEL, KEY_SENTINEL,
                     keys2 * 2 + dead.astype(jnp.int32))

    sck, spid, scols = _chunked_stable_sort(
        ckey, pid, [cols[:, i] for i in range(cols.shape[1])],
        cfg.sort_chunk)

    offs = jnp.asarray(neighbor_offsets(dim, 0, 1))
    gcoords = unpack_key(gkeys, dim)
    cand = (gcoords[:, None, :] + offs[None, :, :]).reshape(-1, dim)
    vmask = jnp.repeat(gvalid, offs.shape[0])
    table, _ = build_block_table(cand, nb, valid=vmask, dim=dim)
    overflow = overflow | (table.count > table.capacity)
    # per-BIN block slot (a group can span several K-bins): from each
    # bin's first sorted lane (dummies carry their group key too)
    first_ck = sck.reshape(cfg.bins_capacity, K)[:, 0]
    first_key = jnp.where(first_ck == KEY_SENTINEL, KEY_SENTINEL,
                          first_ck >> 1)
    bin_block = jnp.where(first_key == KEY_SENTINEL, -1,
                          table.query_keys(first_key))
    ncell = 4 ** dim
    data = {"m": jnp.zeros((nb, ncell), jnp.float32),
            "v": jnp.zeros((nb, ncell, dim), jnp.float32)}
    grid = SparseGrid(table, data, None, 4, dim)
    return BinState(scols, spid, grid, jnp.float32(0.0), overflow,
                    jnp.bool_(False), bin_block, _neighbor_slots(table, dim))


def _rebin_incremental(sim: MPMSim, st: BinState, cfg: BinnedConfig2,
                       m_cap: int):
    """Escapee migration: move up to ``m_cap`` particles that left their
    bin's block window into free (dead/dummy) lanes of their destination
    block's existing bins, leaving bins, table and grid untouched.

    Returns ``(new_state, ok)``.  ``ok`` is False when the move needs a
    structural rebuild — destination block absent from the (dilated)
    table, its bins out of free lanes, or more than ``m_cap`` escapees —
    and the caller must fall back to the full sort-based :func:`_rebin`.

    Why: the full rebin is dominated by the [L, W] row gather and the
    dummy-key/table machinery and fires every handful of steps under
    bulk motion; an escape moves a particle to an *adjacent*
    block, which usually already has bins with spare lanes (per-block
    K-padding leaves (-count) % K of them).  Reference analog: the
    rebuild-on-overflow idiom of ``container/Bht.hpp:163-175`` inverted —
    reuse the structure until it genuinely no longer fits.
    """
    grid = st.grid
    dim = grid.dim
    table = grid.table
    nb = table.capacity
    nbq = cfg.bins_capacity
    L = st.cols.shape[0]
    origin_w = grid.transform.matrix[:dim, dim]
    lanes = jnp.arange(L, dtype=jnp.int32)
    BIG = jnp.int32(np.int32(2**31 - 1))

    x = st.cols[:, 0:dim]
    alive = st.pid >= 0
    xi = (x - origin_w) / grid.dx
    base, _, _ = bspline_weights(xi, sim.order)
    keys = jnp.where(alive,
                     pack_coords(jnp.floor_divide(base - cfg.slack, 4)),
                     KEY_SENTINEL)

    # guard-band criterion: migrate every particle within one cell of its
    # bin's window edge (off outside [1, side-4]), re-keyed to its proper
    # block.  Migrating only *actual* escapees would leave the trailing
    # cohort one sub-cell from the edge — the flag would re-fire almost
    # every step under bulk motion; migrating on key-change alone would
    # move ~half the particles (the key flips a full cell before the
    # window is left).  The band restores >= 1 cell of slack for every
    # particle, matching the full rebin's refresh interval to first order.
    valid_bin = st.bin_block >= 0
    slot_per_bin = jnp.where(valid_bin, st.bin_block, 0)
    borigin = table.active_coords[slot_per_bin] * 4          # [nbq, dim]
    home_origin = jnp.broadcast_to(
        borigin[:, None, :], (nbq, K, dim)).reshape(L, dim)
    off = base - home_origin
    moved = alive & jnp.any((off < 1) | (off > cfg.side - 4), axis=-1)
    n_moved = jnp.sum(moved.astype(jnp.int32))

    # free-lane inventory in lane order (== grouped by block, since bins
    # of a block are consecutive and blocks are key-sorted); dead-bin
    # lanes are excluded — they belong to no block
    lane_slot = jnp.broadcast_to(
        jnp.where(valid_bin, st.bin_block, nb)[:, None], (nbq, K)
    ).reshape(L)
    free = ~alive & (lane_slot < nb)
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    free_list = jnp.zeros((L,), jnp.int32).at[
        jnp.where(free, free_rank, L)].set(lanes, mode="drop")
    free_cnt = jnp.zeros((nb + 1,), jnp.int32).at[
        jnp.where(free, lane_slot, nb)].add(1)[:nb]
    free_start = jnp.cumsum(free_cnt) - free_cnt

    # compact escapees sorted by destination key; ranks within key runs
    skey, slane = jax.lax.sort(
        (jnp.where(moved, keys, BIG), lanes), num_keys=1, is_stable=True)
    skey_c = skey[:m_cap]
    slane_c = slane[:m_cap]
    valid_c = skey_c != BIG
    dst_slot = table.query_keys(jnp.where(valid_c, skey_c, KEY_SENTINEL))
    miss = jnp.any(valid_c & (dst_slot < 0))
    idx_c = jnp.arange(m_cap, dtype=jnp.int32)
    neq = jnp.concatenate([jnp.ones((1,), bool), skey_c[1:] != skey_c[:-1]])
    seg_start = jax.lax.cummax(jnp.where(neq, idx_c, 0))
    rank = idx_c - seg_start
    slot_safe = jnp.maximum(dst_slot, 0)
    short = jnp.any(valid_c & (rank >= free_cnt[slot_safe]))
    ok = (~miss) & (~short) & (n_moved <= m_cap)

    free_pos = jnp.clip(free_start[slot_safe] + rank, 0, L - 1)
    dst_lane = free_list[free_pos]

    # apply: dst lanes are free (pid < 0), src lanes alive -> disjoint
    src_rows = st.cols[slane_c]                              # [m_cap, W]
    src_pid = st.pid[slane_c]
    dst = jnp.where(valid_c, dst_lane, L)
    src = jnp.where(valid_c, slane_c, L)
    cols2 = st.cols.at[dst].set(src_rows, mode="drop")
    cols2 = cols2.at[src].set(jnp.zeros_like(src_rows), mode="drop")
    pid2 = st.pid.at[dst].set(src_pid, mode="drop")
    pid2 = pid2.at[src].set(-1, mode="drop")

    nst = dataclasses.replace(st, cols=cols2, pid=pid2,
                              needs_rebin=jnp.bool_(False))
    return nst, ok


def rebin_adaptive(sim: MPMSim, st: BinState, cfg: BinnedConfig2) -> BinState:
    """Incremental escapee migration when enabled and sufficient; full
    sort-based :func:`_rebin` otherwise."""
    if cfg.migrate_capacity <= 0 or cfg.slack != 1:
        return _rebin(sim, st, cfg)
    nst, ok = _rebin_incremental(sim, st, cfg, cfg.migrate_capacity)
    return jax.lax.cond(ok, lambda _: nst,
                        lambda _: _rebin(sim, st, cfg), None)


def unbin_state(st: BinState, template: MPMState) -> MPMState:
    """Back to original particle order (one gather; rollout-end only)."""
    p = template.particles
    N = p.capacity
    L = st.cols.shape[0]
    d = st.grid.dim
    lay = _col_layout(d)
    alive = st.pid >= 0
    dst = jnp.where(alive, st.pid, N)
    inv = jnp.zeros((N + 1,), jnp.int32).at[dst].set(
        jnp.arange(L, dtype=jnp.int32))[:N]
    mat = st.cols[inv]
    pmask = p.mask
    mk = pmask[:, None]
    upd = dict(
        x=jnp.where(mk, mat[:, lay["x"][0]:lay["x"][1]], p["x"]),
        v=jnp.where(mk, mat[:, lay["v"][0]:lay["v"][1]], p["v"]),
        F=jnp.where(mk[..., None],
                    mat[:, lay["F"][0]:lay["F"][1]].reshape(N, d, d),
                    p["F"]),
        C=jnp.where(mk[..., None],
                    mat[:, lay["C"][0]:lay["C"][1]].reshape(N, d, d),
                    p["C"]))
    if st.has_jp and p.has_prop("Jp"):
        upd["Jp"] = jnp.where(pmask, mat[:, lay["Jp"]], p["Jp"])
    particles = p.update(**upd)
    return MPMState(particles, st.grid, st.max_vel)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _axis_stencils(xib, borigin, side=SIDE):
    """Per-axis quadratic-B-spline window stencils, evaluated directly.

    ``w[d][b,k,s] = N2(xib_d - (borigin_d + s))`` for every window node
    ``s in [0, side)`` — the node weight IS the kernel evaluated at that node's
    distance, and the compact support ``|t| < 1.5`` yields exactly the 3
    nonzero nodes of the quadratic stencil.  This replaces the round-2 one-hot
    construction (base offsets + 3 compare/selects per axis), which was the
    dominant stage of the step (chosen before the move to the GPU; not
    re-measured on the H100).  An out-of-window particle silently loses the
    out-of-window part of its support, but it also flags ``needs_rebin`` at the
    end of the step that moved it, so those weights are never used for physics
    (same contract as the clipped one-hots).  N2 algebra matches
    InterpolationKernel.hpp's quadratic_bspline_weights branch-by-branch.

    Returns (w [dim][B,K,side], w_i [dim][B,K,side], rel0 [B,K,dim]).
    """
    B, Kk, dim = xib.shape
    sidx = jnp.arange(side, dtype=xib.dtype)
    ws, wis = [], []
    for d in range(dim):
        t = xib[..., d:d + 1] - (borigin[:, None, d:d + 1].astype(xib.dtype)
                                 + sidx)
        at = jnp.abs(t)
        c1 = jnp.maximum(1.5 - at, 0.0)
        c2 = jnp.maximum(0.5 - at, 0.0)
        w_axis = 0.5 * c1 * c1 - 1.5 * c2 * c2
        ws.append(w_axis)
        wis.append(w_axis * sidx)
    rel0 = (borigin[:, None, :].astype(xib.dtype) - xib)
    return ws, wis, rel0


# 2-D spill/pull slab tables (own + 3 positive dirs)
_DIRS2 = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _spill2(d):
    M = np.zeros((16, 36), np.float32)
    for i in range(4):
        for j in range(4):
            si, sj = i + 4 * d[0], j + 4 * d[1]
            if si < SIDE and sj < SIDE:
                M[i * 4 + j, si * SIDE + sj] = 1.0
    return M


def _pull2(d):
    P = np.zeros((36, 16), np.float32)
    for a in range(SIDE):
        for b in range(SIDE):
            da, db = a >= 4, b >= 4
            if (int(da), int(db)) != d:
                continue
            P[a * SIDE + b, (a - 4 * da) * 4 + (b - 4 * db)] = 1.0
    return P


_SPILL2 = np.stack([_spill2(d) for d in _DIRS2])
_PULL2 = np.stack([_pull2(d) for d in _DIRS2])


def _spill_sel(nbr8, bin_block, bin_live, nbq, cfg, b_hint=None):
    """Concatenated one-hot (own + 7 spill dirs) -> blocks, or segment ids.

    ``nbr8`` is the table-frozen [nb, 8] spill-target cache carried on
    the BinState (the neighbor queries are latency-bound searchsorted
    chains — rebuilding them per step cost a measurable slice of the
    step's non-transfer time).  ``b_hint`` overrides the bin count used
    by the auto seg-vs-onehot threshold (the chunked step passes the
    FULL bin count so the decision matches problem scale, not chunk
    size)."""
    tgt = nbr8[bin_block].T                       # [8, B]
    tgt = jnp.where(bin_live[None, :], tgt, -1)
    B = b_hint if b_hint is not None else bin_block.shape[0]
    use_seg = cfg.use_segments
    if use_seg is None:
        # the segment_sum reduction beats the one-hot selection matmul once the
        # sel matrix stops being tiny — the [nb, 8B] one-hot build+reads
        # dominate (chosen before the move to the GPU; not re-measured on the
        # H100).  Keep one-hot only for small problems where the matmul is
        # exact-fp32 cheap.
        use_seg = nbq * 8 * B > (1 << 22)
    if use_seg:
        return None, tgt, True
    sel = (tgt.reshape(-1)[None, :] ==
           jnp.arange(nbq, dtype=jnp.int32)[:, None]).astype(jnp.float32)
    return sel, tgt, False


def explicit_step_binned2(sim: MPMSim, state, dt, cfg: BinnedConfig2,
                          *, rebin: bool = True):
    """One explicit APIC step on a :class:`BinState` (bin order in/out)."""
    st = state
    if rebin:
        st = _rebin(sim, st, cfg)
    if st.grid.dim == 2:
        return _step2d(sim, st, dt, cfg)
    if cfg.chunk_bins and cfg.chunk_bins < cfg.bins_capacity:
        return _step3d_chunked(sim, st, dt, cfg)
    return _step3d(sim, st, dt, cfg)


@dataclasses.dataclass
class _Ctx3:
    """Per-step 3-D transfer context over a :class:`BinState`.

    Built once per step (or once per implicit solve — the stencils and
    spill selection are shared by every operator application inside the
    CG loop, the v2 analog of mpm_binned.BinWorkspace).  All members are
    traced values; this is NOT a pytree, it lives inside one trace.
    """

    cfg: BinnedConfig2
    table: object
    dx: object
    origin_w: jax.Array
    lane_alive: jax.Array            # [B, K]
    borigin: jax.Array               # [B, 3] window origin (node coords)
    rel0: jax.Array                  # [B, K, 3] world offset to origin
    wx: jax.Array                    # [B, K, side] (aliveness folded in)
    wx_i: jax.Array
    S0: jax.Array                    # [B, K, side^2] y⊗z plane product
    fy_m: jax.Array                  # [side^2] node y index
    fz_m: jax.Array                  # [side^2] node z index
    sel: Optional[jax.Array]         # one-hot spill selection (or None)
    tgt8: jax.Array                  # [8, B] target block slot per dir
    use_seg: bool
    overflow: jax.Array

    @property
    def side(self) -> int:
        return self.cfg.side


def _make_ctx3(st: BinState, cfg: BinnedConfig2, lo=None,
               nbins: Optional[int] = None) -> _Ctx3:
    """Build the transfer context; ``lo``/``nbins`` restrict it to the
    bin-chunk [lo, lo+nbins) (the chunked step's working-set control —
    ``lo`` may be traced, slices are ``dynamic_slice``)."""
    grid = st.grid
    table = grid.table
    nb = table.capacity
    dx = grid.dx
    origin_w = grid.transform.matrix[:3, 3]
    B = cfg.bins_capacity if nbins is None else nbins
    side = cfg.side
    sq = side * side

    if lo is None:
        cols = st.cols.reshape(B, K, -1)
        pid = st.pid
        bin_block_full = st.bin_block
    else:
        cols = jax.lax.dynamic_slice_in_dim(
            st.cols, lo * K, B * K, 0).reshape(B, K, -1)
        pid = jax.lax.dynamic_slice_in_dim(st.pid, lo * K, B * K, 0)
        bin_block_full = jax.lax.dynamic_slice_in_dim(st.bin_block, lo, B, 0)
    xb = cols[..., 0:3]
    lane_alive = (pid >= 0).reshape(B, K)

    # bin -> block mapping frozen at rebin time (recomputing it from a
    # lane position would break once drift slack lets particles cross a
    # cell boundary mid-interval)
    bin_live = jnp.any(lane_alive, axis=1)
    bin_block = jnp.where(bin_live, bin_block_full, -1)
    bad_bin = bin_live & (bin_block < 0)
    overflow = st.overflow | jnp.any(bad_bin)
    bin_block_safe = jnp.clip(bin_block, 0, nb - 1)
    borigin = table.active_coords[bin_block_safe] * 4

    xib = (xb - origin_w) / dx
    ws, wis, rel0i = _axis_stencils(xib, borigin, side)
    wx, wy, wz = ws
    rel0 = rel0i * dx
    # dead lanes must not contribute: fold aliveness into wx
    wx = wx * lane_alive[..., None]
    wx_i = wis[0] * lane_alive[..., None]
    S0 = (wy[:, :, :, None] * wz[:, :, None, :]).reshape(B, K, sq)
    # index-weighted stencils are diagonal rescales of S0 along the node
    # axis (S1 = S0 * f[y], S2 = S0 * f[z]) — folded into the einsum
    # output/input instead of materializing two more [B,K,side^2] arrays
    fidx = jnp.arange(side, dtype=S0.dtype)
    fy_m = jnp.repeat(fidx, side)                           # [sq], f[y]
    fz_m = jnp.tile(fidx, side)                             # [sq], f[z]
    sel, tgt8, use_seg = _spill_sel(st.nbr8, bin_block_safe,
                                    bin_live & ~bad_bin, nb, cfg,
                                    b_hint=cfg.bins_capacity)
    return _Ctx3(cfg, table, dx, origin_w, lane_alive, borigin, rel0,
                 wx, wx_i, S0, fy_m, fz_m, sel, tgt8, use_seg, overflow)


def _ctx_slice(ctx: _Ctx3, lo, m: int) -> _Ctx3:
    """Slice a full-B context down to the bin-chunk [lo, lo+m) (``lo``
    may be traced).  Requires the segment spill path (the one-hot sel
    matrix is not chunkable)."""
    assert ctx.use_seg, "chunked transfers require use_segments"
    dsl = jax.lax.dynamic_slice_in_dim
    return dataclasses.replace(
        ctx,
        lane_alive=dsl(ctx.lane_alive, lo, m, 0),
        borigin=dsl(ctx.borigin, lo, m, 0),
        rel0=dsl(ctx.rel0, lo, m, 0),
        wx=dsl(ctx.wx, lo, m, 0),
        wx_i=dsl(ctx.wx_i, lo, m, 0),
        S0=dsl(ctx.S0, lo, m, 0),
        tgt8=dsl(ctx.tgt8, lo, m, 1))


def _ctx_p2g(ctx: _Ctx3, Q0, QA=None, squared=False, chunk: int = 0):
    """Transfer [B,K,C] particle channels to [nb,64,C] block nodes.

    ``chunk`` > 0 runs the plane einsums + spill in bin-chunks of that
    size (lax.scan, accumulator carry): chunking bounds the implicit CG
    operator's [B,K,C·side] working set the same way chunk_bins does for
    the explicit step.

    node(a,y,z) += wx[a]*wy[y]*wz[z] * (Q0 + a*QA[0] + y*QA[1] + z*QA[2])
    — the APIC/force plane decomposition shared by the explicit step and
    every implicit operator application (ImplicitMPM.hpp's G2P2G lineage).

    ``QA=None`` is the plain-weight transfer (no affine planes): the
    einsum shrinks to one C·side-wide plane — the contact-force path
    rides this at 1/3 the cost.  Per-component ``QA`` entries may also
    be narrower than C (aligned to the LAST channels; the leading ones
    are implicitly zero): callers
    whose index-weighted planes have structurally-zero channels (the
    mass channel of the APIC momentum transfer) pass only the live ones
    instead of shipping zeros through the [B,K,·] contraction.

    ``squared=True`` transfers with w^2 instead of w (QA must be None):
    node_i = sum_p w_ip^2 Q0_p — the row norms a Jacobi preconditioner
    of the P2G∘H∘G2P stiffness needs (diag(M + dt^2 K) estimation).
    """
    from ..ops.spill_tables import _SPILL_ALL

    B, Kk, C = Q0.shape
    side, sq = ctx.side, ctx.side * ctx.side
    nb = ctx.table.capacity

    if chunk and chunk < B:
        assert B % chunk == 0, (B, chunk)
        dsl = jax.lax.dynamic_slice_in_dim

        def body(acc, i):
            lo = i * chunk
            ctx_c = _ctx_slice(ctx, lo, chunk)
            Q0c = dsl(Q0, lo, chunk, 0)
            QAc = (None if QA is None
                   else [dsl(q, lo, chunk, 0) for q in QA])
            return acc + _ctx_p2g(ctx_c, Q0c, QAc, squared), None

        acc0 = jnp.zeros((nb, 64, C), Q0.dtype)
        acc, _ = jax.lax.scan(body, acc0,
                              jnp.arange(B // chunk, dtype=jnp.int32))
        return acc

    def plane_scale(w6, q):
        # [B,K,side],[B,K,Cq] -> [B,K,Cq*side] (a-major)
        return (w6[..., :, None] * q[..., None, :]).reshape(
            B, Kk, q.shape[-1] * side)

    S0 = ctx.S0
    wx = ctx.wx
    if squared:
        assert QA is None
        S0 = S0 * S0
        wx = wx * wx

    # THREE einsums, one per plane group, each output used directly — faster
    # than a stacked single-Rcat einsum (chosen before the move to the GPU; not
    # re-measured on the H100): the [B,K,(C+C1+C2)·side] channel concat and the
    # outf slicing both materialize at full size in the stacked form, which
    # costs more than reading S0 three times.  (The symmetric split on the G2P
    # side was slower — kept stacked there.)
    def dot(R):
        return jnp.einsum("bkm,bkA->bmA", S0, R, precision=_PREC,
                          preferred_element_type=jnp.float32)

    R1 = plane_scale(wx, Q0)
    if QA is not None:
        qa0 = QA[0]
        if qa0.shape[-1] < C:     # leading channels implicitly zero
            qa0 = jnp.pad(qa0, [(0, 0)] * 2 + [(C - qa0.shape[-1], 0)])
        R1 = R1 + plane_scale(ctx.wx_i, qa0)
    out = dot(R1).reshape(B, sq, side, C)
    if QA is not None:
        C1, C2 = QA[1].shape[-1], QA[2].shape[-1]
        o1 = dot(plane_scale(wx, QA[1])).reshape(B, sq, side, C1)
        o2 = dot(plane_scale(wx, QA[2])).reshape(B, sq, side, C2)
        pady = [(0, 0)] * 3 + [(C - C1, 0)]
        padz = [(0, 0)] * 3 + [(C - C2, 0)]
        out = (out + ctx.fy_m[None, :, None, None] * jnp.pad(o1, pady)
               + ctx.fz_m[None, :, None, None] * jnp.pad(o2, padz))
    cube = jnp.moveaxis(out, 2, 1).reshape(B, side ** 3, C)
    return _spill_reduce(ctx, cube, C)


def _spill_reduce(ctx: _Ctx3, cube, C):
    """[B, side^3, C] window cubes -> [nb, 64, C] block accumulation.

    The spill stage shared by the XLA and Pallas P2G front-ends: route
    each window's 8 octants to their target blocks (transpose for the
    exactly-tiling side=8 window, one-hot slab matmul otherwise) and
    reduce bins -> blocks by segment_sum or exact-fp32 selection matmul.
    """
    from ..ops.spill_tables import _SPILL_ALL

    B = cube.shape[0]
    side = ctx.side
    nb = ctx.table.capacity
    if side == 8:
        # the 8-node window tiles 2x2x2 blocks exactly: "spill" is a
        # transpose, not a matmul
        spilled = cube.reshape(B, 2, 4, 2, 4, 2, 4, C).transpose(
            1, 3, 5, 0, 2, 4, 6, 7).reshape(8, B, 64, C)
    else:
        spill = jnp.asarray(_SPILL_ALL[:, :, :216])           # [8,64,216]
        spilled = jnp.einsum("dts,nsc->dntc", spill, cube, precision=_PREC,
                             preferred_element_type=jnp.float32)
    if ctx.use_seg:
        seg = jnp.where(ctx.tgt8 >= 0, ctx.tgt8, nb).reshape(-1)
        acc = jax.ops.segment_sum(
            spilled.reshape(8 * B, 64 * C), seg,
            num_segments=nb + 1)[:nb].reshape(nb, 64, C)
    else:
        acc = jax.lax.dot_general(
            ctx.sel, spilled.reshape(8 * B, 64 * C),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(nb, 64, C)
    return acc


def _ctx_g2p(ctx: _Ctx3, gv, chunk: int = 0):
    """Gather [nb,64,3] node values to particles.

    Returns (s0, sx, sy, sz) [B,K,3]: the plain weighted sum and the
    three index-weighted sums (for the APIC B-matrix / force gradient).
    ``chunk``: see :func:`_ctx_p2g` (bin-chunked scan writing output
    chunks by dynamic_update_slice).
    """
    from ..ops.spill_tables import _PULL_ALL

    B = ctx.S0.shape[0]
    side, sq = ctx.side, ctx.side * ctx.side

    if chunk and chunk < B:
        assert B % chunk == 0, (B, chunk)
        dusl = jax.lax.dynamic_update_slice_in_dim

        def body(carry, i):
            lo = i * chunk
            outs = _ctx_g2p(_ctx_slice(ctx, lo, chunk), gv)
            return tuple(dusl(c, o, lo, 0)
                         for c, o in zip(carry, outs)), None

        z = jnp.zeros((B, K, 3), gv.dtype)
        outs, _ = jax.lax.scan(body, (z, z, z, z),
                               jnp.arange(B // chunk, dtype=jnp.int32))
        return outs
    nb = ctx.table.capacity
    if ctx.use_seg:
        safe = jnp.clip(ctx.tgt8, 0, nb - 1)
        Vd = jnp.where((ctx.tgt8 >= 0)[..., None, None], gv[safe], 0.0)
    else:
        Vd = jax.lax.dot_general(
            ctx.sel, gv.reshape(nb, 64 * 3),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(8, B, 64, 3)
    if side == 8:
        # inverse of the spill transpose: window = 2x2x2 blocks
        Vbin = Vd.reshape(2, 2, 2, B, 4, 4, 4, 3).transpose(
            3, 0, 4, 1, 5, 2, 6, 7).reshape(B, 512, 3)
    else:
        pull = jnp.asarray(_PULL_ALL[:, :, :64])              # [8,216,64]
        Vbin = jnp.einsum("dst,dnte->nse", pull, Vd, precision=_PREC,
                          preferred_element_type=jnp.float32)  # [B,216,3]

    # V as [B, side^2, (a,c)]
    Vac = jnp.moveaxis(Vbin.reshape(B, side, sq, 3), 1, 2
                       ).reshape(B, sq, 3 * side)
    # S1/S2 fold into the INPUT here (einsum(S0*f[m], V) = einsum(S0,
    # f*V)); stacking the three V variants along the free channel axis
    # again reads S0 ONCE instead of three times
    A3 = 3 * side
    Vcat = jnp.concatenate([Vac, ctx.fy_m[None, :, None] * Vac,
                            ctx.fz_m[None, :, None] * Vac], axis=-1)
    Pcat = jnp.einsum("bkm,bmA->bkA", ctx.S0, Vcat, precision=_PREC,
                      preferred_element_type=jnp.float32)   # [B,K,9side]
    # a-contraction on contiguous 3·side slices: the 5-D
    # Pcat.reshape(B,K,3,side,3) + "bka,bkvac->bkvc" form costs a layout copy
    # of Pcat plus [B,K,3,8,3] broadcast-multiply traffic; four sliced einsums
    # avoid both (chosen before the move to the GPU; not re-measured on the
    # H100)

    def ac(w, P24):
        return jnp.einsum("bka,bkac->bkc", w,
                          P24.reshape(B, K, side, 3))
    s0 = ac(ctx.wx, Pcat[..., 0:A3])
    sy = ac(ctx.wx, Pcat[..., A3:2 * A3])
    sz = ac(ctx.wx, Pcat[..., 2 * A3:])
    sx = ac(ctx.wx_i, Pcat[..., 0:A3])
    return s0, sx, sy, sz


def _node_positions(ctx: _Ctx3):
    corners = jnp.asarray(neighbor_offsets(3, 0, 3))
    return (ctx.table.active_coords[:, None, :] * 4 +
            corners[None]).astype(jnp.float32) * ctx.dx + ctx.origin_w


def _step3d(sim: MPMSim, st, dt, cfg: BinnedConfig2):
    grid = st.grid
    dx = grid.dx
    origin_w = grid.transform.matrix[:3, 3]
    B = cfg.bins_capacity
    L = B * K
    side = cfg.side

    cols = st.cols.reshape(B, K, -1)
    xb = cols[..., 0:3]
    vb = cols[..., 3:6]
    Fb = cols[..., 6:15].reshape(B, K, 3, 3)
    Cb = cols[..., 15:24].reshape(B, K, 3, 3)
    lane_alive = (st.pid >= 0).reshape(B, K)
    mban = jnp.where(lane_alive, cols[..., 24], 0.0)
    volb = jnp.where(lane_alive, cols[..., 25], 0.0)

    ctx = _make_ctx3(st, cfg)
    overflow = ctx.overflow
    rel0 = ctx.rel0
    borigin = ctx.borigin

    # ---- P2G -----------------------------------------------------------------
    Dinv = 4.0 / (dx * dx)
    tau = sim.model.kirchhoff(Fb)
    A = mban[..., None, None] * Cb - \
        (dt * Dinv * volb)[..., None, None] * tau
    u0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A, rel0)
    Q0 = jnp.concatenate([mban[..., None], u0], -1)           # [B,K,4]
    # index-weighted planes carry only the momentum channels (the mass
    # plane is structurally zero — _ctx_p2g pads, saving 2/12 of Rcat)
    QA = [dx * A[..., :, d] for d in range(3)]
    acc = _ctx_p2g(ctx, Q0, QA)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update ----------------------------------------------------------
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    node_x = _node_positions(ctx)
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- G2P -------------------------------------------------------------------
    s0, sx, sy, sz = _ctx_g2p(ctx, gv)

    v_new = s0
    Bmat = v_new[..., :, None] * rel0[..., None, :] + \
        dx * jnp.stack([sx, sy, sz], axis=-1)
    C_new = Dinv * Bmat
    eye = jnp.eye(3, dtype=Fb.dtype)
    F_new = mm(eye + dt * C_new, Fb)
    if sim.plasticity is not None and st.has_jp:
        Jpb = cols[..., 26]
        F_new, Jp_new = sim.plasticity.project(F_new, Jpb)
    x_new = xb + dt * v_new

    # escape check: a particle whose new stencil base leaves its bin's
    # block [0,3] window forces a rebin before the next step (the clip in
    # _axis_stencils would otherwise silently corrupt weights)
    base_new = jnp.floor((x_new - origin_w) / dx - 0.5).astype(jnp.int32)
    off_new = base_new - borigin[:, None, :]
    if cfg.recenter:
        # Galilean recentering (see BinnedConfig2.recenter): follow the
        # bulk integer drift with the grid origin so the next step's
        # bases stay centered in the frozen windows.  int32 sums are
        # exact (parallel/primitives.py routing note).
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

    ok3 = lane_alive[..., None]
    newcols = [jnp.where(ok3, x_new, xb), jnp.where(ok3, v_new, vb),
               jnp.where(ok3[..., None], F_new, Fb).reshape(B, K, 9),
               jnp.where(ok3[..., None], C_new, Cb).reshape(B, K, 9),
               mban[..., None], volb[..., None]]
    if st.has_jp:
        jpcol = (Jp_new if sim.plasticity is not None
                 else cols[..., 26])
        newcols.append(jnp.where(ok3, jpcol[..., None],
                                 cols[..., 26:27]))
    ncols = jnp.concatenate(newcols, axis=-1).reshape(L, -1)

    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=overflow, needs_rebin=escaped)


def _step3d_chunked(sim: MPMSim, st, dt, cfg: BinnedConfig2):
    """The 3-D step with the transfer pipeline chunked over bins.

    Physics-identical to :func:`_step3d` (same helpers, same contraction
    forms); only the iteration structure changes: two ``lax.scan`` passes
    over bin-chunks of ``cfg.chunk_bins`` — P2G accumulating into one
    [nb,64,4] grid buffer, then (after the global grid update) G2P
    writing particle chunks back by ``dynamic_update_slice``.  Rationale:
    chunking pins the [B,K,·] working set at the chunk size for ANY
    problem size (chosen before the move to the GPU; not re-measured on
    the H100).  fp32 sums are reassociated (chunk-major) relative to the
    unchunked step, so results match to roundoff, not bitwise.
    """
    grid = st.grid
    dx = grid.dx
    origin_w = grid.transform.matrix[:3, 3]
    B = cfg.bins_capacity
    Bc = cfg.chunk_bins
    assert B % Bc == 0, (B, Bc)
    nchunks = B // Bc
    side = cfg.side
    nb = grid.table.capacity
    L = B * K
    W = st.cols.shape[-1]
    lo_arr = jnp.arange(nchunks, dtype=jnp.int32) * Bc
    Dinv = 4.0 / (dx * dx)

    def chunk_particles(lo):
        ctx = _make_ctx3(st, cfg, lo=lo, nbins=Bc)
        cols = jax.lax.dynamic_slice_in_dim(
            st.cols, lo * K, Bc * K, 0).reshape(Bc, K, -1)
        lane_alive = ctx.lane_alive
        mban = jnp.where(lane_alive, cols[..., 24], 0.0)
        volb = jnp.where(lane_alive, cols[..., 25], 0.0)
        return ctx, cols, mban, volb

    # ---- pass 1: chunked P2G --------------------------------------------
    def p2g_chunk(carry, lo):
        acc, overflow = carry
        ctx, cols, mban, volb = chunk_particles(lo)
        vb = cols[..., 3:6]
        Fb = cols[..., 6:15].reshape(Bc, K, 3, 3)
        Cb = cols[..., 15:24].reshape(Bc, K, 3, 3)
        tau = sim.model.kirchhoff(Fb)
        A = mban[..., None, None] * Cb - \
            (dt * Dinv * volb)[..., None, None] * tau
        u0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A,
                                               ctx.rel0)
        Q0 = jnp.concatenate([mban[..., None], u0], -1)       # [Bc,K,4]
        QA = [dx * A[..., :, d] for d in range(3)]
        acc = acc + _ctx_p2g(ctx, Q0, QA)
        return (acc, overflow | ctx.overflow), None

    acc0 = jnp.zeros((nb, 64, 4), jnp.float32)
    (acc, overflow), _ = jax.lax.scan(p2g_chunk, (acc0, st.overflow),
                                      lo_arr)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update (global, [nb]-sized) --------------------------------
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    # node positions need only the table, not a particle chunk
    corners = jnp.asarray(neighbor_offsets(3, 0, 3))
    node_x = (grid.table.active_coords[:, None, :] * 4 +
              corners[None]).astype(jnp.float32) * dx + origin_w
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- pass 2: chunked G2P + advect ------------------------------------
    eye = jnp.eye(3, dtype=st.cols.dtype)
    big = jnp.int32(1 << 20)

    def g2p_chunk(carry, lo):
        ncols, off_min, off_max, osum, ocnt = carry
        ctx, cols, mban, volb = chunk_particles(lo)
        lane_alive = ctx.lane_alive
        xb = cols[..., 0:3]
        vb = cols[..., 3:6]
        Fb = cols[..., 6:15].reshape(Bc, K, 3, 3)
        Cb = cols[..., 15:24].reshape(Bc, K, 3, 3)
        s0, sx, sy, sz = _ctx_g2p(ctx, gv)
        v_new = s0
        Bmat = v_new[..., :, None] * ctx.rel0[..., None, :] + \
            dx * jnp.stack([sx, sy, sz], axis=-1)
        C_new = Dinv * Bmat
        F_new = mm(eye + dt * C_new, Fb)
        if sim.plasticity is not None and st.has_jp:
            Jpb = cols[..., 26]
            F_new, Jp_new = sim.plasticity.project(F_new, Jpb)
        x_new = xb + dt * v_new

        base_new = jnp.floor((x_new - origin_w) / dx - 0.5
                             ).astype(jnp.int32)
        off_new = base_new - ctx.borigin[:, None, :]
        mk = lane_alive[..., None]
        off_min = jnp.minimum(off_min, jnp.min(
            jnp.where(mk, off_new, big), axis=(0, 1)))
        off_max = jnp.maximum(off_max, jnp.max(
            jnp.where(mk, off_new, -big), axis=(0, 1)))
        osum = osum + jnp.sum(jnp.where(mk, off_new, 0), axis=(0, 1))
        ocnt = ocnt + jnp.sum(lane_alive.astype(jnp.int32))

        newcols = [jnp.where(mk, x_new, xb), jnp.where(mk, v_new, vb),
                   jnp.where(mk[..., None], F_new, Fb).reshape(Bc, K, 9),
                   jnp.where(mk[..., None], C_new, Cb).reshape(Bc, K, 9),
                   mban[..., None], volb[..., None]]
        if st.has_jp:
            jpcol = (Jp_new if sim.plasticity is not None
                     else cols[..., 26])
            newcols.append(jnp.where(mk, jpcol[..., None],
                                     cols[..., 26:27]))
        nc = jnp.concatenate(newcols, axis=-1).reshape(Bc * K, -1)
        ncols = jax.lax.dynamic_update_slice_in_dim(ncols, nc, lo * K, 0)
        return (ncols, off_min, off_max, osum, ocnt), None

    carry0 = (jnp.zeros((L, W), st.cols.dtype),
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


def _step2d(sim: MPMSim, st, dt, cfg: BinnedConfig2):
    """2-D specialization: 4^2 blocks, 6^2 windows, 4 spill dirs
    (the reference's 2-D MPM use cases on the fast path)."""
    grid = st.grid
    table = grid.table
    nb = table.capacity
    dx = grid.dx
    origin_w = grid.transform.matrix[:2, 2]
    B = cfg.bins_capacity
    L = B * K
    side = cfg.side
    lay = _col_layout(2)

    cols = st.cols.reshape(B, K, -1)
    xb = cols[..., 0:2]
    vb = cols[..., 2:4]
    Fb = cols[..., 4:8].reshape(B, K, 2, 2)
    Cb = cols[..., 8:12].reshape(B, K, 2, 2)
    mban = cols[..., 12]
    volb = cols[..., 13]
    lane_alive = (st.pid >= 0).reshape(B, K)
    mban = jnp.where(lane_alive, mban, 0.0)
    volb = jnp.where(lane_alive, volb, 0.0)

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

    # ---- P2G -----------------------------------------------------------------
    Dinv = 4.0 / (dx * dx)
    tau = sim.model.kirchhoff(Fb)
    A = mban[..., None, None] * Cb - \
        (dt * Dinv * volb)[..., None, None] * tau
    u0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A, rel0)
    Q0 = jnp.concatenate([mban[..., None], u0], -1)           # [B,K,3]
    zero = jnp.zeros_like(mban)[..., None]
    QA = [jnp.concatenate([zero, dx * A[..., :, d]], -1) for d in range(2)]

    def plane_scale(w6, q):
        return (w6[..., :, None] * q[..., None, :]).reshape(B, K, 3 * side)

    R1 = plane_scale(wx, Q0) + plane_scale(wx_i, QA[0])
    R2 = plane_scale(wx, QA[1])
    Sstack = jnp.concatenate([wy, wy_i], axis=1)            # [B,2K,side]
    Rstack = jnp.concatenate([R1, R2], axis=1)              # [B,2K,3side]
    out = jnp.einsum("bkm,bkA->bmA", Sstack, Rstack, precision=_PREC,
                     preferred_element_type=jnp.float32)  # [B,side,3side]
    cube = jnp.moveaxis(out.reshape(B, side, side, 3), 1, 2
                        ).reshape(B, side * side, 3)         # [(a,y)]

    # ---- spill + block reduction -----------------------------------------------
    nbr4 = st.nbr8                         # [nb, 4] (table-frozen cache)
    tgt = nbr4[bin_block_safe].T                              # [4, B]
    tgt = jnp.where((bin_live & ~bad_bin)[None, :], tgt, -1)
    if side == 8:
        spilled = cube.reshape(B, 2, 4, 2, 4, 3).transpose(
            1, 3, 0, 2, 4, 5).reshape(4, B, 16, 3)
    else:
        spill = jnp.asarray(_SPILL2)                          # [4,16,36]
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
               jnp.arange(nb, dtype=jnp.int32)[:, None]).astype(jnp.float32)
        acc = jax.lax.dot_general(
            sel, spilled.reshape(4 * B, 16 * 3),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_PREC,
        ).reshape(nb, 16, 3)
    gm = acc[..., 0]
    gmv = acc[..., 1:]

    # ---- grid update --------------------------------------------------------------
    has_mass = gm > 0.0
    gv = jnp.where(has_mass[..., None],
                   gmv / jnp.maximum(gm, 1e-30)[..., None], 0.0)
    gv = gv + dt * sim.gravity[None, None, :]
    corners = jnp.asarray(neighbor_offsets(2, 0, 3))
    node_x = (table.active_coords[:, None, :] * 4 +
              corners[None]).astype(gv.dtype) * dx + origin_w
    gv = resolve_boundaries(sim.colliders, node_x, gv)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- G2P -------------------------------------------------------------------
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
        pull = jnp.asarray(_PULL2)                            # [4,36,16]
        Vbin = jnp.einsum("dst,dnte->nse", pull, Vd, precision=_PREC,
                          preferred_element_type=jnp.float32)  # [B,36,2]
    Vac = jnp.moveaxis(Vbin.reshape(B, side, side, 2), 1, 2
                       ).reshape(B, side, 2 * side)          # [B,y,(a,c)]
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
    eye = jnp.eye(2, dtype=Fb.dtype)
    F_new = mm(eye + dt * C_new, Fb)
    if sim.plasticity is not None and st.has_jp:
        F_new, Jp_new = sim.plasticity.project(F_new, cols[..., 14])
    x_new = xb + dt * v_new

    base_new = jnp.floor((x_new - origin_w) / dx - 0.5).astype(jnp.int32)
    off_new = base_new - borigin[:, None, :]
    if cfg.recenter:
        # Galilean recentering — see the 3-D step / BinnedConfig2.recenter
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
    newcols = [jnp.where(ok2, x_new, xb), jnp.where(ok2, v_new, vb),
               jnp.where(ok2[..., None], F_new, Fb).reshape(B, K, 4),
               jnp.where(ok2[..., None], C_new, Cb).reshape(B, K, 4),
               mban[..., None], volb[..., None]]
    if st.has_jp:
        jpcol = (Jp_new if sim.plasticity is not None else cols[..., 14])
        newcols.append(jnp.where(ok2, jpcol[..., None], cols[..., 14:15]))
    ncols = jnp.concatenate(newcols, axis=-1).reshape(L, -1)

    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    return dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                               overflow=overflow, needs_rebin=escaped)


def adaptive_chain(step_fn, rebin_fn, st, n_steps: int):
    """Run ``n_steps`` of ``step_fn`` with rebins only when flagged, as a
    two-level while loop: the inner loop advances cond-free until
    ``needs_rebin`` fires; the outer loop rebins between inner runs.

    This structure exists because a ``lax.cond(needs_rebin, rebin, id)`` INSIDE
    the per-step body cost a large share of the step even when the branch is
    never taken (the live branch poisons the loop body's schedule/aliasing;
    chosen before the move to the GPU; not re-measured on the H100), while
    rebins actually fire about once per 120 steps at CFL-limited drift.
    Hoisting the cond to the outer loop amortizes both the cond overhead and
    the rebin itself to noise without giving up exactness: the inner loop stops
    on the very step that set the flag.
    """
    def inner_cond(c):
        s, i = c
        return (i < n_steps) & ~s.needs_rebin

    def inner_body(c):
        s, i = c
        return step_fn(s), i + 1

    def outer_cond(c):
        s, i = c
        return i < n_steps

    def outer_body(c):
        s, i = c
        s, i = jax.lax.while_loop(inner_cond, inner_body, (s, i))
        s = jax.lax.cond(s.needs_rebin, rebin_fn, lambda t: t, s)
        return s, i

    st, _ = jax.lax.while_loop(outer_cond, outer_body,
                               (st, jnp.int32(0)))
    return st


def rollout_binned2(sim: MPMSim, state: MPMState, dt, cfg: BinnedConfig2,
                    n_steps: int) -> Tuple[MPMState, jax.Array]:
    """n steps in bin order; original order restored once at the end.

    Returns (state, overflow).  Jit the whole call.  Adaptive rebinning
    (cross-step G2P2G fusion, G2P2G.hpp lineage) rides the two-level
    :func:`adaptive_chain` structure.
    """
    st = bin_state(sim, state, cfg)
    st = adaptive_chain(
        lambda s: explicit_step_binned2(sim, s, dt, cfg, rebin=False),
        lambda s: rebin_adaptive(sim, s, cfg), st, n_steps)
    return unbin_state(st, state), st.overflow
