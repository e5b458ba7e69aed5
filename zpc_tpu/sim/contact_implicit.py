"""IPC-style mesh contact for the implicit binned MPM solve (config 5).

Couples the reference's contact stack — LBVH broad phase
(``container/Bvh.hpp:662-733``), barrier energies and derivatives
(``geometry/Distance.hpp:233-2450``), CCD step limiting — into the grid
implicit system, re-designed for the binned layout:

* **Broad phase at block granularity.**  Per-particle BVH queries at 1M
  particles are the reference's formulation (atomically-appended pair lists);
  here the bins already group 128 particles per grid block, so ONE query per
  bin (its dhat-padded window box) against the triangle LBVH finds every
  candidate in ~2.5k banded-join queries instead of 1M, and the resulting
  per-bin triangle lists are dense ``[B, max_tris]`` arrays — no pair
  compaction, no scatters.
* **Dense narrow phase.**  Every (bin-lane, candidate-slot) pair
  evaluates point-triangle closest distance (Ericson clamping,
  ``geometry/distance.py``); the barrier force uses the exact
  envelope gradient ``∇d² = 2 (p - closest)`` and a Gauss-Newton PSD
  Hessian ``b''(d²) ∇d² ∇d²ᵀ`` (the b'·∇²d² term is NSD inside the
  barrier and is dropped — in place of the reference's
  per-pair 12x12 eigendecomposition SPD projection, which would cost a
  batched eigh per pair here).
* **Capacity contract.**  Truncated candidate lists (more than
  ``max_tris`` triangles near one block) or an out-of-band banded-join
  query raise the overflow flag for host-side re-trace with larger
  capacities — the framework-wide ``_buildSuccess`` idiom
  (``container/Bht.hpp:163-175``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..containers.bvh import LBvh, build_lbvh_complete, query_overlaps_sorted
from ..geometry.contact import barrier, barrier_grad, barrier_hess
from ..geometry.distance import point_triangle_closest

__all__ = ["MeshContact", "ContactSet"]


class ContactSet(NamedTuple):
    """Broad-phase result: per-bin candidate triangles (block-granular)."""

    hits: jax.Array       # [B, max_tris] triangle ids, -1 padded
    overflow: jax.Array   # candidate list truncated or band too narrow


@dataclasses.dataclass(frozen=True)
class MeshContact:
    """Static (or per-step-updated) triangle mesh obstacle with an IPC
    barrier, consumable by :func:`implicit_step_binned2`."""

    tri: jax.Array        # [M, 3, 3] triangle vertices
    bvh: LBvh
    dhat: float           # barrier activation distance (world units)
    kappa: float          # barrier stiffness
    max_tris: int = 8     # candidate triangles per block window
    tile: int = 128       # banded-join query tile
    use_ccd: bool = False  # conservative-advancement advection clamp

    @staticmethod
    def build(tri_verts, dhat: float, kappa: float, *, max_tris: int = 8,
              tile: int = 128, use_ccd: bool = False) -> "MeshContact":
        tri_verts = jnp.asarray(tri_verts, jnp.float32)
        lo = jnp.min(tri_verts, axis=1)
        hi = jnp.max(tri_verts, axis=1)
        return MeshContact(tri_verts, build_lbvh_complete(lo, hi),
                           float(dhat), float(kappa), max_tris, tile,
                           use_ccd)

    # -- broad phase --------------------------------------------------------
    def broad_phase(self, ctx, lane_alive) -> ContactSet:
        """One dhat-padded AABB query per bin window."""
        B = lane_alive.shape[0]
        f32 = jnp.float32
        dx = ctx.dx
        bin_live = jnp.any(lane_alive, axis=1)
        # per-bin windows share one extent -> uniform_extent fast path;
        # the 1e-5 relative inflation keeps the reconstructed c -+ ext
        # conservatively OUTSIDE the exact window under f32 rounding
        # (the narrow phase re-tests d < dhat exactly anyway)
        half = 0.5 * (ctx.side - 1) * dx
        cen = ctx.borigin.astype(f32) * dx + ctx.origin_w + half
        ext = (half + self.dhat) * (1.0 + 1e-5)
        far = jnp.float32(1e9)
        T = self.tile
        nq = -(-B // T) * T
        pad = nq - B
        pts = jnp.concatenate(
            [jnp.where(bin_live[:, None], cen, far),
             jnp.full((pad, 3), far, f32)])
        qid, hits, counts, in_band = query_overlaps_sorted(
            self.bvh, pts, pts, self.max_tris, tile=T,
            uniform_extent=ext)
        hits_b = jnp.full((nq, self.max_tris), -1, jnp.int32
                          ).at[qid].set(hits)[:B]
        cnt_b = jnp.zeros((nq,), jnp.int32).at[qid].set(counts)[:B]
        band_b = jnp.zeros((nq,), bool).at[qid].set(in_band)[:B]
        overflow = jnp.any(bin_live &
                           ((cnt_b > self.max_tris) | ~band_b))
        return ContactSet(hits_b, overflow)

    # -- narrow phase ---------------------------------------------------------
    def _pairwise(self, cset: ContactSet, xb, lane_alive):
        """Yield (active, diff, d2) per candidate slot (static unroll)."""
        M = self.tri.shape[0]
        dhat2 = self.dhat * self.dhat
        for t in range(self.max_tris):
            idx = cset.hits[:, t]
            tvalid = idx >= 0
            tv = self.tri[jnp.clip(idx, 0, M - 1)]       # [B,3,3]
            _, cl = point_triangle_closest(
                xb, tv[:, None, 0], tv[:, None, 1], tv[:, None, 2])
            diff = xb - cl
            d2 = jnp.sum(diff * diff, -1)
            act = tvalid[:, None] & lane_alive & (d2 < dhat2)
            yield act, diff, d2, tv

    def forces_and_hessians(self, cset: ContactSet, xb, lane_alive):
        """Barrier force [B,K,3] and GN-PSD position Hessian [B,K,3,3]."""
        B, Kk, _ = xb.shape
        dhat2 = self.dhat * self.dhat
        fc = jnp.zeros((B, Kk, 3), xb.dtype)
        Hc = jnp.zeros((B, Kk, 3, 3), xb.dtype)
        for act, diff, d2, _ in self._pairwise(cset, xb, lane_alive):
            bg = jnp.where(act, barrier_grad(d2, dhat2, self.kappa), 0.0)
            bh = jnp.where(
                act, jnp.maximum(barrier_hess(d2, dhat2, self.kappa), 0.0),
                0.0)
            fc = fc - (2.0 * bg)[..., None] * diff
            Hc = Hc + (4.0 * bh)[..., None, None] * \
                diff[..., :, None] * diff[..., None, :]
        return fc, Hc

    def energy(self, cset: ContactSet, xb, lane_alive):
        """Total barrier energy (line-search / diagnostics)."""
        dhat2 = self.dhat * self.dhat
        e = jnp.float32(0.0)
        for act, _, d2, _ in self._pairwise(cset, xb, lane_alive):
            e = e + jnp.sum(jnp.where(
                act, barrier(d2, dhat2, self.kappa), 0.0))
        return e

    def toi(self, cset: ContactSet, xb, dxb, lane_alive,
            min_sep: float = 1e-4) -> jax.Array:
        """Per-particle conservative time of impact in (0, 1] for the
        displacement ``dxb`` against the candidate triangles
        (ccd_tight / Distance.hpp CCD lineage: additive conservative
        advancement on the same dense pair set)."""
        from ..geometry.distance import point_triangle_ccd

        M = self.tri.shape[0]
        alpha = jnp.ones(xb.shape[:-1], xb.dtype)
        zero3 = jnp.zeros_like(xb)
        for t in range(self.max_tris):
            idx = cset.hits[:, t]
            tvalid = idx >= 0
            tv = self.tri[jnp.clip(idx, 0, M - 1)]
            a = jnp.broadcast_to(tv[:, None, 0], xb.shape)
            b = jnp.broadcast_to(tv[:, None, 1], xb.shape)
            c = jnp.broadcast_to(tv[:, None, 2], xb.shape)
            ti = point_triangle_ccd(xb, a, b, c, dxb, zero3, zero3, zero3,
                                    min_sep=min_sep)
            alpha = jnp.where(tvalid[:, None] & lane_alive,
                              jnp.minimum(alpha, ti), alpha)
        return alpha
