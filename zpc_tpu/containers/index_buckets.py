"""Cell-binned neighbor lists (``IndexBuckets`` / ``SpatialHash``).

Reference: ``container/IndexBuckets.hpp:12-66`` — per-cell counts + offsets
(exclusive scan) + particle indices, built with atomic counters; queried via
``bucketNo(coord)``; and ``container/SpatialHash.hpp`` (uniform-cell
variant).

Re-design: the atomic count/offset build becomes **sort + run-length
offsets** — particle ids stable-sorted by packed cell key; the sorted-unique
cell table doubles as the hash table; per-cell ranges are recovered with
``searchsorted`` over the sorted keys.  Neighborhood queries use a **fixed
fanout**: 3^d candidate cells x K slots per cell, returned as a padded
candidate matrix + mask — the static-shape replacement for the reference's
dynamic per-cell iteration (the consumer masks instead of branching).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers.block_table import (KEY_SENTINEL, BlockTable,
                                      build_block_table, pack_coords)
from ..geometry.sparse_grid import neighbor_offsets

__all__ = ["IndexBuckets", "build_index_buckets", "neighbor_candidates"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IndexBuckets:
    table: BlockTable        # active cell coords (sorted keys)
    offsets: jax.Array       # [cell_capacity+1] start offset per table slot
    indices: jax.Array       # [n] particle ids sorted by cell
    dx: jax.Array            # cell size
    count: jax.Array         # valid particle count

    @property
    def cell_capacity(self) -> int:
        return self.table.capacity

    def cell_of(self, x: jax.Array) -> jax.Array:
        return jnp.floor(x / self.dx).astype(jnp.int32)

    def cell_range(self, coords: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """(start, end) index range into ``indices`` per query cell coord;
        empty range for inactive cells."""
        slot = self.table.query(coords)
        safe = jnp.maximum(slot, 0)
        start = self.offsets[safe]
        end = self.offsets[safe + 1]
        empty = slot < 0
        return jnp.where(empty, 0, start), jnp.where(empty, 0, end)


def build_index_buckets(x: jax.Array, dx: float,
                        cell_capacity: int,
                        valid: Optional[jax.Array] = None) -> IndexBuckets:
    """Sort-based build (replaces the reference's atomic-counter build)."""
    n = x.shape[0]
    dxj = jnp.asarray(dx, x.dtype)
    cells = jnp.floor(x / dxj).astype(jnp.int32)
    if valid is None:
        valid = jnp.ones((n,), bool)
    keys = jnp.where(valid, pack_coords(cells), KEY_SENTINEL)
    ids = jnp.arange(n, dtype=jnp.int32)
    skeys, sids = jax.lax.sort((keys, ids), num_keys=1, is_stable=True)
    table, _ = build_block_table(cells, cell_capacity, valid=valid,
                                 dim=cells.shape[-1])
    # offsets: first sorted position of each table key
    offsets = jnp.searchsorted(skeys, table.keys).astype(jnp.int32)
    count = jnp.sum(valid.astype(jnp.int32))
    # cap+1 sentinel end: position after last valid
    offsets = jnp.concatenate([offsets, count[None]])
    # slots beyond table.count have key sentinel -> searchsorted returns
    # `count` (first sentinel position) making their ranges empty
    offsets = jnp.minimum(offsets, count)
    return IndexBuckets(table, offsets, sids, dxj, count)


def neighbor_candidates(ib: IndexBuckets, q: jax.Array, k_per_cell: int,
                        ring: int = 1) -> Tuple[jax.Array, jax.Array]:
    """Fixed-fanout neighbor candidates for query points ``[nq, d]``.

    Returns (ids [nq, (2*ring+1)^d * k_per_cell], mask) — particle ids in
    the (2 ring+1)^d cell neighborhood, up to ``k_per_cell`` per cell
    (overflow beyond k is dropped; size k to your density).  The consumer
    applies the true distance test on the masked candidates.
    """
    d = q.shape[-1]
    offs = jnp.asarray(neighbor_offsets(d, -ring, ring))   # [m, d]
    ccell = ib.cell_of(q)                                  # [nq, d]
    cand_cells = ccell[:, None, :] + offs[None, :, :]      # [nq, m, d]
    start, end = ib.cell_range(cand_cells)                 # [nq, m]
    lane = jnp.arange(k_per_cell, dtype=jnp.int32)
    pos = start[..., None] + lane                          # [nq, m, k]
    ok = pos < end[..., None]
    safe = jnp.clip(pos, 0, ib.indices.shape[0] - 1)
    ids = jnp.where(ok, ib.indices[safe], -1)
    nq = q.shape[0]
    return ids.reshape(nq, -1), ok.reshape(nq, -1)
