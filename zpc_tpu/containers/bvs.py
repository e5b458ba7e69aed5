"""``Bvs`` — flat bounding-volume sweep structure
(reference ``container/Bvs.hpp``: a sorted flat alternative to the BVH for
broad-phase when rebuild cost dominates).

Form: primitives sorted by their min coordinate along a chosen axis; a
query interval locates its candidate range by two binary searches, then
tests a **bounded window** of candidates (static fanout, like
IndexBuckets).  Build = one sort; no tree, no ropes — the cheapest
rebuild-every-frame broad phase for moderately uniform scenes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .bvh import aabb_overlap

__all__ = ["Bvs", "build_bvs", "bvs_query"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bvs:
    lo: jax.Array        # [n, dim] sorted by lo[:, axis]
    hi: jax.Array
    prim: jax.Array      # [n] original primitive ids
    max_extent: jax.Array  # max box width along the sweep axis
    axis: int = dataclasses.field(metadata=dict(static=True), default=0)


def build_bvs(prim_lo: jax.Array, prim_hi: jax.Array, axis: int = 0,
              valid: Optional[jax.Array] = None) -> Bvs:
    n = prim_lo.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    big = jnp.asarray(3.4e38, prim_lo.dtype)
    keys = jnp.where(valid, prim_lo[:, axis], big)
    order = jnp.argsort(keys)
    lo = jnp.where(valid[order][:, None], prim_lo[order], big)
    hi = jnp.where(valid[order][:, None], prim_hi[order], -big)
    ext = jnp.max(jnp.where(valid, prim_hi[:, axis] - prim_lo[:, axis],
                            0.0))
    return Bvs(lo, hi, jnp.where(valid[order], order, -1).astype(jnp.int32),
               ext, axis)


def bvs_query(bvs: Bvs, q_lo: jax.Array, q_hi: jax.Array,
              max_candidates: int) -> Tuple[jax.Array, jax.Array]:
    """Overlap query: returns (prim ids [nq, max_candidates], mask).

    Candidates are primitives whose sweep-axis min lies in
    [q_lo - max_extent, q_hi] — a superset of true overlaps along that
    axis; the remaining axes are tested exactly.  Overflow beyond
    ``max_candidates`` is truncated (size to density).
    """
    a = bvs.axis
    starts = jnp.searchsorted(
        bvs.lo[:, a], q_lo[:, a] - bvs.max_extent).astype(jnp.int32)
    lane = jnp.arange(max_candidates, dtype=jnp.int32)
    pos = starts[:, None] + lane[None, :]
    n = bvs.lo.shape[0]
    safe = jnp.clip(pos, 0, n - 1)
    in_range = (pos < n) & (bvs.lo[safe, a] <= q_hi[:, a:a + 1])
    ok = in_range & aabb_overlap(bvs.lo[safe], bvs.hi[safe],
                                 q_lo[:, None, :], q_hi[:, None, :])
    ids = jnp.where(ok, bvs.prim[safe], -1)
    return ids, ok & (ids >= 0)
