"""Narrow-band sparse signed-distance fields.

Reference: ``geometry/SparseLevelSet.hpp:18-28`` (bht table + block payload
+ background value, collocated/staggered categories) and the parallel flood
fill ``flood_fill_levelset`` with its ReserveForNeighbor / MarkInteriorTag /
ComputeTaggedSDF functor passes (``geometry/LevelSetUtils.hpp:10-162``);
mesh/points -> SDF conversion lives in the reference's VDB tool layer.

Re-design: a SparseLevelSet *is* a SparseGrid with an ``sdf`` property
(+ optional ``vel``) and a background distance — all sampling machinery is
inherited.  The flood fill becomes **jump-flood sweeps** over the active
narrow band: each pass takes the min over face neighbors + dx (vectorized
gather over the block structure, ``lax`` loop with static trip count), which
is the parallel-friendly replacement for the reference's tag-propagation
worklists.  Construction helpers build narrow bands from analytic level
sets or point clouds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers.block_table import build_block_table
from ..core.config import prop
from .levelset import LevelSet
from .sparse_grid import SparseGrid, neighbor_offsets, sparse_grid

__all__ = ["SparseLevelSet", "levelset_from_analytic",
           "levelset_from_points", "flood_fill", "redistance"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseLevelSet(LevelSet):
    """Narrow-band SDF on a block-sparse grid; outside the band the field is
    ``background`` (sign gives inside/outside far-field)."""

    grid: SparseGrid
    background: jax.Array    # positive distance magnitude for far-field

    def sdf(self, x: jax.Array) -> jax.Array:
        # sample; inactive regions give background via default
        return self.grid.sample("sdf", x, default=self.background)

    def velocity(self, x: jax.Array) -> jax.Array:
        if "vel" in self.grid.data:
            return self.grid.sample("vel", x, default=0.0)
        return jnp.zeros_like(x)


def levelset_from_analytic(ls: LevelSet, lo, hi, dx: float,
                           block_capacity: int = 4096,
                           band: float = 3.0) -> SparseLevelSet:
    """Rasterize an analytic level set into a narrow band of +-band*dx
    (the reference's VDB-load path replaced by direct evaluation)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    # candidate blocks: every block whose AABB intersects the band
    bs = 4
    bdx = dx * bs
    axes = [np.arange(int(np.floor(lo[d] / bdx)) - 1,
                      int(np.ceil(hi[d] / bdx)) + 1) for d in range(3)]
    blocks = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    centers = (blocks + 0.5) * bdx
    d = np.asarray(ls.sdf(jnp.asarray(centers, jnp.float32)))
    r_block = bdx * np.sqrt(3) / 2
    # one-sided band: keep the exterior band AND the whole interior, so the
    # sampled field stays negative deep inside (narrow-band-only storage
    # would return the positive background there)
    keep = d <= band * dx + r_block
    blocks = blocks[keep]
    g = sparse_grid([prop("sdf")], dx=dx, block_capacity=block_capacity)
    g = g.activate(jnp.asarray(blocks, jnp.int32))
    node_x = g.node_world_positions()
    vals = ls.sdf(node_x.reshape(-1, 3)).reshape(node_x.shape[:-1])
    vals = jnp.clip(vals, -band * dx * 4, band * dx * 4)
    g = g.with_data(sdf=vals)
    return SparseLevelSet(g, jnp.float32(band * dx * 4))


def levelset_from_points(x: jax.Array, dx: float, radius: float,
                         block_capacity: int = 4096,
                         band: int = 2) -> SparseLevelSet:
    """Union-of-spheres SDF from a point cloud (particle surfacing; the
    reference builds these through OpenVDB particle rasterization)."""
    cells = jnp.floor(x / dx).astype(jnp.int32)
    offs = jnp.asarray(neighbor_offsets(3, -band, band))
    cand = (jnp.floor_divide(cells, 4)[:, None, :] +
            jnp.floor_divide(offs, 4)[None, :, :]).reshape(-1, 3)
    g = sparse_grid([prop("sdf")], dx=dx, block_capacity=block_capacity)
    g = g.activate(cand, dilation=1)
    node_x = g.node_world_positions().reshape(-1, 3)
    # distance to nearest point (chunked to bound memory)
    n_nodes = node_x.shape[0]

    def chunk_min(carry, xc):
        d = jnp.linalg.norm(node_x[:, None, :] - xc[None, :, :], axis=-1)
        return jnp.minimum(carry, jnp.min(d, axis=1)), None

    npts = x.shape[0]
    CH = 1024
    pad = (-npts) % CH
    xp = jnp.concatenate([x, jnp.full((pad, 3), 1e9, x.dtype)])
    chunks = xp.reshape(-1, CH, 3)
    dmin, _ = jax.lax.scan(chunk_min,
                           jnp.full((n_nodes,), jnp.inf, x.dtype), chunks)
    sdf = (dmin - radius).reshape(g.block_capacity, g.cells_per_block)
    g = g.with_data(sdf=sdf)
    return SparseLevelSet(g, jnp.float32(4 * band * dx))


def _face_neighbor_min(grid: SparseGrid, vals: jax.Array, big: float):
    """Min over the 6 face neighbors of every active cell (vectorized
    gather via cell_slot; inactive neighbors contribute ``big``)."""
    nb, nc = vals.shape
    bs = grid.block_size
    corners = jnp.asarray(neighbor_offsets(3, 0, bs - 1))
    cells = (grid.table.active_coords[:, None, :] * bs +
             corners[None, :, :])                      # [nb, 64, 3]
    out = jnp.full_like(vals, big)
    flat = vals.reshape(-1)
    for d in range(3):
        for s in (-1, 1):
            off = jnp.zeros((3,), jnp.int32).at[d].set(s)
            slot = grid.cell_slot(cells + off)
            safe = jnp.maximum(slot, 0)
            v = jnp.where(slot >= 0, flat[safe], big)
            out = jnp.minimum(out, v.reshape(nb, nc))
    return out


def flood_fill(ls: SparseLevelSet, iters: int = 16) -> SparseLevelSet:
    """Eikonal sweep over the active band (LevelSetUtils.hpp flood fill):
    |phi| <- min(|phi|, min_face |phi_nbr| + dx), keeping signs; fills
    unresolved active cells from their neighbors."""
    g = ls.grid
    dx = g.dx
    big = float(1e9)
    phi = g.data["sdf"]

    def body(_, phi):
        mag = jnp.abs(phi)
        nmin = _face_neighbor_min(g, mag, big)
        newmag = jnp.minimum(mag, nmin + dx)
        return jnp.sign(jnp.where(phi == 0, 1.0, phi)) * newmag

    phi = jax.lax.fori_loop(0, iters, body, phi)
    return SparseLevelSet(g.with_data(sdf=phi), ls.background)


def redistance(ls: SparseLevelSet, iters: int = 8) -> SparseLevelSet:
    """Approximate re-distancing: keep the zero-crossing cells, flood the
    rest (cheap parallel analog of the reference's ComputeTaggedSDF pass)."""
    return flood_fill(ls, iters)
