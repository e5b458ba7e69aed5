"""``AdaptiveGrid`` — multi-level VDB-like sparse tree.

Reference: ``geometry/AdaptiveGrid.hpp:9-19`` — per-level ``bht`` +
``TileVector`` node pools with OpenVDB's 5-4-3-style branching
(``TileBits``), child masks, hierarchical ``probeValue`` descending levels
(:1035-1090), and a caching accessor (:1090-1130); conversion to/from
OpenVDB (AdaptiveGrid_Conversion.cpp).

Re-design: static level count, each level a sorted-key
:class:`BlockTable` + dense node payload ``[cap_l, bs_l^d]`` + boolean child
mask.  ``probe`` descends all levels **unrolled and branch-free**: every
level's lookup runs for every query lane, ``where`` selects the value from
the finest level whose child-mask says "leaf here" — no data-dependent
control flow, so 1M probes are a handful of fused gathers.  The reference's
per-thread node-caching accessor is unnecessary: XLA already amortizes the
table lookups across the vectorized batch.

Level convention: level 0 = finest (leaf), level L-1 = coarsest.  Block size
``bs[l]`` cells per axis, each cell of level l spans ``span[l] =
prod(bs[:l])`` leaf cells.  A level-l cell is *interior* (has children) if
the child mask is set; otherwise its payload value covers the whole span
(constant tile, VDB semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers.block_table import BlockTable, build_block_table
from ..math.transform import Transform, scaling, translation

__all__ = ["AdaptiveGrid", "adaptive_grid_from_leaves",
           "AdaptiveGridLevelSet", "adaptive_from_sdf"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveLevel:
    table: BlockTable
    value: jax.Array        # [cap, bs^d] payload
    child: jax.Array        # [cap, bs^d] bool — cell refined at finer level?

    @property
    def capacity(self) -> int:
        return self.value.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AdaptiveGrid:
    levels: Tuple[AdaptiveLevel, ...]       # finest .. coarsest
    transform: Transform                    # leaf-cell index -> world
    block_sizes: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True), default=(8, 4, 4))
    dim: int = dataclasses.field(metadata=dict(static=True), default=3)
    background: float = dataclasses.field(metadata=dict(static=True),
                                          default=0.0)

    # span of one cell of level l, in leaf cells
    def cell_span(self, l: int) -> int:
        s = 1
        for b in self.block_sizes[:l]:
            s *= b
        return s

    def _level_lookup(self, l: int, leaf_cell: jax.Array):
        """(found, value, is_leaf_here) for level-l lookup of leaf cells."""
        lev = self.levels[l]
        bs = self.block_sizes[l]
        span = self.cell_span(l)
        cell_l = jnp.floor_divide(leaf_cell, span)       # level-l cell coord
        block_l = jnp.floor_divide(cell_l, bs)
        local = cell_l - block_l * bs
        lin = jnp.zeros(local.shape[:-1], jnp.int32)
        for d in range(self.dim):
            lin = lin * bs + local[..., d]
        slot = lev.table.query(block_l)
        ok = slot >= 0
        safe = jnp.maximum(slot, 0)
        flat = lev.value.reshape(-1)
        cmask = lev.child.reshape(-1)
        idx = safe * (bs ** self.dim) + lin
        val = flat[idx]
        has_child = cmask[idx] & ok
        return ok, val, has_child

    def probe(self, x_world: jax.Array) -> jax.Array:
        """Hierarchical value lookup (probeValue, AdaptiveGrid.hpp:1035-1090):
        the value of the finest node covering each query point; background
        where nothing covers it.  Branch-free over the whole batch."""
        xi = self.transform.inverse().apply(x_world)
        leaf_cell = jnp.floor(xi).astype(jnp.int32)
        out = jnp.full(x_world.shape[:-1], self.background,
                       self.levels[0].value.dtype)
        covered = jnp.zeros(x_world.shape[:-1], bool)
        # descend coarse -> fine: finer levels overwrite where they exist
        for l in reversed(range(len(self.levels))):
            ok, val, has_child = self._level_lookup(l, leaf_cell)
            # a level-l value applies where the node exists and is not
            # refined further (or it IS the finest level)
            applies = ok & (~has_child if l > 0 else jnp.ones_like(ok))
            out = jnp.where(applies, val, out)
            covered = covered | ok
        return out

    def sample(self, x_world: jax.Array) -> jax.Array:
        """Trilinear sampling of the hierarchical field via 2^d probes
        (iSample-with-accessor analog)."""
        xi = self.transform.inverse().apply(x_world) - 0.5
        base = jnp.floor(xi)
        frac = xi - base
        out = None
        from .sparse_grid import neighbor_offsets

        for c in neighbor_offsets(self.dim, 0, 1):
            corner_ix = base + jnp.asarray(c, xi.dtype) + 0.5
            p = self.transform.apply(corner_ix)
            w = jnp.ones(xi.shape[:-1], xi.dtype)
            for d in range(self.dim):
                w = w * (frac[..., d] if c[d] else 1.0 - frac[..., d])
            v = self.probe(p)
            out = w * v if out is None else out + w * v
        return out

    def sample_gradient(self, x_world: jax.Array) -> jax.Array:
        """Gradient of the trilinearly-sampled field (autodiff through the
        probe gathers, the same policy as SparseGrid.sample_gradient)."""
        def f(p):
            return jnp.sum(self.sample(p[None]))
        g = jax.vmap(jax.grad(f))(x_world.reshape(-1, self.dim))
        return g.reshape(x_world.shape)

    def sample_staggered(self, x_world: jax.Array) -> jax.Array:
        """MAC sampling (SparseGrid.hpp:418-498 staggered convention): the
        d-th output component samples the field on faces offset -dx/2
        along d — for AdaptiveGrid the payload is scalar, so this returns
        the per-face-component interpolation of that scalar field."""
        dxw = self.transform.matrix[0, 0]
        comps = []
        for d in range(self.dim):
            shift = jnp.zeros((self.dim,), x_world.dtype).at[d].set(
                0.5 * dxw)
            comps.append(self.sample(x_world + shift))
        return jnp.stack(comps, axis=-1)

    # -- writes / re-activation (AdaptiveGrid.hpp value-write accessor +
    # topology activation, :1035-1130) ------------------------------------
    def update_leaf_values(self, leaf_cells: jax.Array,
                           leaf_values: jax.Array):
        """Topology-preserving value write into existing leaf cells.

        Returns (grid, overflow); overflow fires when a written cell's
        leaf block is not active (re-activate first via
        :meth:`activate_leaves`)."""
        lev = self.levels[0]
        bs = self.block_sizes[0]
        dim = self.dim
        block = jnp.floor_divide(leaf_cells, bs)
        local = leaf_cells - block * bs
        lin = jnp.zeros(local.shape[:-1], jnp.int32)
        for d in range(dim):
            lin = lin * bs + local[..., d]
        slot = lev.table.query(block)
        overflow = jnp.any(slot < 0)
        ncell = bs ** dim
        flat_idx = jnp.where(slot >= 0, slot * ncell + lin,
                             lev.capacity * ncell)
        buf = jnp.concatenate(
            [lev.value.reshape(-1), jnp.zeros((1,), lev.value.dtype)])
        value = buf.at[flat_idx].set(leaf_values)[:-1].reshape(
            lev.capacity, ncell)
        levels = (dataclasses.replace(lev, value=value),) + self.levels[1:]
        return dataclasses.replace(self, levels=levels), overflow

    def activate_leaves(self, leaf_cells: jax.Array):
        """Re-activation: extend the leaf topology (block granularity)
        with the blocks covering ``leaf_cells``, preserving every stored
        value, and rebuild the coarser child masks.  Returns
        (grid, overflow) — overflow when a level's capacity is exceeded.
        """
        lev0 = self.levels[0]
        bs0 = self.block_sizes[0]
        dim = self.dim
        cap0 = lev0.capacity
        new_blocks = jnp.floor_divide(leaf_cells, bs0)
        old_coords = lev0.table.active_coords           # [cap0, d]
        old_valid = lev0.table.mask
        cat = jnp.concatenate([old_coords, new_blocks])
        catmask = jnp.concatenate(
            [old_valid, jnp.ones(new_blocks.shape[:-1], bool)])
        table, _ = build_block_table(cat, cap0, valid=catmask, dim=dim)
        overflow = table.count > cap0
        # move old payload rows to their new slots
        ncell = bs0 ** dim
        dst = table.query(old_coords)                   # [cap0]
        dst = jnp.where(old_valid & (dst >= 0), dst, cap0)
        value = jnp.full((cap0 + 1, ncell), self.background,
                         lev0.value.dtype).at[dst].set(lev0.value)[:cap0]
        child = jnp.zeros((cap0 + 1, ncell), bool
                          ).at[dst].set(lev0.child)[:cap0]
        levels = [AdaptiveLevel(table, value, child)]
        # rebuild coarser child masks from the (new) finer block keys
        span = bs0
        fine_cells = table.active_coords * bs0          # block origin cells
        fine_valid = table.mask
        for l in range(1, len(self.levels)):
            lev = self.levels[l]
            bs = self.block_sizes[l]
            cap = lev.capacity
            cell_l = jnp.floor_divide(fine_cells, span)
            block_l = jnp.floor_divide(cell_l, bs)
            tbl, inv = build_block_table(block_l, cap, valid=fine_valid,
                                         dim=dim)
            overflow = overflow | (tbl.count > cap)
            local = cell_l - block_l * bs
            lin = jnp.zeros(local.shape[:-1], jnp.int32)
            for d in range(dim):
                lin = lin * bs + local[..., d]
            nc = bs ** dim
            flat = jnp.where((inv >= 0) & fine_valid, inv * nc + lin,
                             cap * nc)
            child = jnp.zeros((cap * nc + 1,), bool).at[flat].set(
                True)[:-1].reshape(cap, nc)
            # carry coarse values over by key (constant-tile payloads)
            vdst = tbl.query(lev.table.active_coords)
            vdst = jnp.where(lev.table.mask & (vdst >= 0), vdst, cap)
            value = jnp.full((cap + 1, nc), self.background,
                             lev.value.dtype).at[vdst].set(
                                 lev.value)[:cap]
            levels.append(AdaptiveLevel(tbl, value, child))
            span *= bs
            # next level's "fine" keys are THIS level's blocks, expressed
            # as their leaf-cell origins (block b covers leaf cells from
            # b * bs * span_l = b * span)
            fine_cells = tbl.active_coords * span
            fine_valid = tbl.mask
        return dataclasses.replace(self, levels=tuple(levels)), overflow


def adaptive_grid_from_leaves(leaf_cells: jax.Array, leaf_values: jax.Array,
                              *, dx: float,
                              block_sizes: Sequence[int] = (8, 4, 4),
                              capacities: Optional[Sequence[int]] = None,
                              background: float = 0.0,
                              coarse_values: Optional[Sequence] = None,
                              origin=None) -> AdaptiveGrid:
    """Build from active leaf cells (coords [n, d] + values [n]).

    Coarser levels get child masks where finer blocks exist; their values
    default to ``background`` (or per-level constants via
    ``coarse_values``) — matching VDB's interior-tile semantics.
    """
    dim = leaf_cells.shape[-1]
    nlev = len(block_sizes)
    capacities = capacities or [max(64, leaf_cells.shape[0]), 512, 64]
    levels = []
    span = 1
    cur_cells = leaf_cells
    for l, bs in enumerate(block_sizes):
        cap = capacities[l]
        cell_l = jnp.floor_divide(leaf_cells, span)
        block_l = jnp.floor_divide(cell_l, bs)
        table, inv = build_block_table(block_l, cap, dim=dim)
        value = jnp.full((cap, bs ** dim), background,
                         leaf_values.dtype)
        child = jnp.zeros((cap, bs ** dim), bool)
        local = cell_l - jnp.floor_divide(cell_l, bs) * bs
        lin = jnp.zeros(local.shape[:-1], jnp.int32)
        for d in range(dim):
            lin = lin * bs + local[..., d]
        flat_idx = jnp.where(inv >= 0, inv * (bs ** dim) + lin,
                             cap * (bs ** dim))
        if l == 0:
            buf = jnp.full((cap * (bs ** dim) + 1,), background,
                           leaf_values.dtype)
            value = buf.at[flat_idx].set(leaf_values)[:-1].reshape(
                cap, bs ** dim)
        else:
            cbuf = jnp.zeros((cap * (bs ** dim) + 1,), bool)
            child = cbuf.at[flat_idx].set(True)[:-1].reshape(cap, bs ** dim)
            if coarse_values is not None and coarse_values[l] is not None:
                value = jnp.full_like(value, coarse_values[l])
        levels.append(AdaptiveLevel(table, value, child))
        span *= bs
    tr = scaling(dx)
    if origin is not None:
        tr = translation(origin).compose(tr)
    return AdaptiveGrid(tuple(levels), tr, tuple(block_sizes), dim,
                        background)


def adaptive_from_sdf(levelset, *, dx: float, lo, hi, band: float,
                      block_sizes: Sequence[int] = (8, 4, 4),
                      capacities: Optional[Sequence[int]] = None,
                      origin=None) -> "AdaptiveGrid":
    """Sample an analytic/level-set SDF into an adaptive narrow-band grid:
    leaf cells only inside ``|sdf| < band``, coarse constant tiles carry
    the (clamped) far-field sign — the coarse-fine collision-SDF pattern
    (VdbLevelSet mesh->SDF conversion analog, dependency-free)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    org = lo if origin is None else np.asarray(origin, np.float32)
    res = np.maximum(((hi - lo) / dx).astype(np.int64), 1)
    dim = lo.shape[0]
    axes = [np.arange(int(r)) for r in res]
    cells = np.stack(np.meshgrid(*axes, indexing="ij"),
                     -1).reshape(-1, dim)
    centers = (cells + 0.5) * dx + org
    vals = np.asarray(levelset.sdf(jnp.asarray(centers, jnp.float32)))
    keep = np.abs(vals) < band
    leaf_cells = jnp.asarray(cells[keep], jnp.int32)
    leaf_vals = jnp.asarray(vals[keep], jnp.float32)
    if capacities is None:
        nblk = max(64, int(np.unique(
            cells[keep] // block_sizes[0], axis=0).shape[0] * 2))
        capacities = [nblk, max(64, nblk // 8), 64]
    return adaptive_grid_from_leaves(
        leaf_cells, leaf_vals, dx=dx, block_sizes=block_sizes,
        capacities=capacities, background=float(band), origin=org)


class AdaptiveGridLevelSet:
    """LevelSet adapter over a scalar AdaptiveGrid SDF — the grid's sim
    consumer: plug into :class:`~zpc_tpu.geometry.collider.Collider` as a
    boundary for MPM steps (grid-backed collision SDF, the role
    ``SparseLevelSet`` + ``Collider`` play in the reference)."""

    def __init__(self, grid: AdaptiveGrid):
        self.grid = grid

    def sdf(self, x: jax.Array) -> jax.Array:
        return self.grid.sample(x)

    def normal(self, x: jax.Array) -> jax.Array:
        g = self.grid.sample_gradient(x)
        return g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True),
                               1e-12)

    def velocity(self, x: jax.Array) -> jax.Array:
        return jnp.zeros_like(x)

    def inside(self, x: jax.Array) -> jax.Array:
        return self.sdf(x) < 0.0
