"""Cell-cut structures + degeneracy/intersection predicates.

Parity surface for the reference's ``geometry/Geometry.hpp:69-310``
(ExactRootParityCCD building blocks, Wang & Ferguson lineage): the
``bilinear`` / ``prism`` / ``hex`` cells built from CCD vertex
differences, their bbox-cut tests, and the exact-ish point/segment/ray
predicates they rely on.

Re-design: everything is **vectorized and branch-free** — batched
``[..., 3]`` inputs, compensated double-float predicates from
:mod:`zpc_tpu.geometry.predicates` instead of fp64 Shewchuk, masks
instead of early returns.  Return conventions match the reference
(0 = no hit, 1 = hit, 2 = endpoint-on, etc.).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .predicates import orient2d, orient3d

__all__ = ["Bilinear", "Prism", "Hex", "make_bilinear", "make_prism",
           "make_hex", "is_triangle_degenerated", "same_point",
           "point_on_ray", "colinear_point_on_segment", "point_on_segment",
           "ray_segment_intersection", "segment_segment_intersection",
           "ray_triangle_intersection"]

# facet tables for the two bilinear orientations (Geometry.hpp:69-99)
_BILINEAR_FACETS_POS = np.asarray(
    [[1, 2, 0], [3, 0, 2], [0, 3, 1], [2, 1, 3]], np.int32)
_BILINEAR_FACETS_NEG = np.asarray(
    [[1, 0, 2], [3, 2, 0], [0, 1, 3], [2, 3, 1]], np.int32)

PRISM_EDGES = np.asarray(
    [[0, 1], [1, 2], [2, 0], [3, 4], [4, 5], [5, 3], [0, 3], [1, 4],
     [2, 5]], np.int32)                              # Geometry.hpp:~105
HEX_EDGES = np.asarray(
    [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], np.int32)      # Geometry.hpp:~170


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bilinear:
    """Bilinear patch spanned by two segment-pairs (Geometry.hpp bilinear).

    ``v``: [..., 4, 3] vertices; ``facets``: [..., 4, 3] tetra facet index
    triples oriented by the sign of orient3d(v0..v3); ``is_degenerated``:
    [...] bool (coplanar)."""

    v: jax.Array
    facets: jax.Array
    is_degenerated: jax.Array


def make_bilinear(v0, v1, v2, v3) -> Bilinear:
    v = jnp.stack([v0, v1, v2, v3], axis=-2)
    ori = orient3d(v0, v1, v2, v3)
    pos = jnp.asarray(_BILINEAR_FACETS_POS)
    neg = jnp.asarray(_BILINEAR_FACETS_NEG)
    facets = jnp.where((ori >= 0)[..., None, None], pos, neg)
    return Bilinear(v, facets, ori == 0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Prism:
    """CCD prism: 6 difference vertices (vs-fs*, ve-fe*), 9 edges."""

    v: jax.Array                   # [..., 6, 3]

    def bbox(self) -> Tuple[jax.Array, jax.Array]:
        return self.v.min(-2), self.v.max(-2)

    def bbox_cut_bbox(self, lo, hi) -> jax.Array:
        """isPrismBboxCutBbox (Geometry.hpp:128-133)."""
        mn, mx = self.bbox()
        return jnp.all((mn <= hi) & (lo <= mx), axis=-1)

    def triangle_degenerated(self, up_or_bottom: int) -> jax.Array:
        """isTriangleDegenerated (Geometry.hpp:136-153)."""
        pid = 0 if up_or_bottom == 0 else 3
        return is_triangle_degenerated(self.v[..., pid, :],
                                       self.v[..., pid + 1, :],
                                       self.v[..., pid + 2, :])


def make_prism(vs, fs0, fs1, fs2, ve, fe0, fe1, fe2) -> Prism:
    """Vertex order matches the reference ctor: (s-f0, s-f2, s-f1, ...)."""
    v = jnp.stack([vs - fs0, vs - fs2, vs - fs1,
                   ve - fe0, ve - fe2, ve - fe1], axis=-2)
    return Prism(v)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hex:
    """CCD hexahedron: 8 difference vertices, 12 edges."""

    v: jax.Array                   # [..., 8, 3]

    def bbox(self) -> Tuple[jax.Array, jax.Array]:
        return self.v.min(-2), self.v.max(-2)

    def bbox_cut_bbox(self, lo, hi) -> jax.Array:
        """isHexBboxCutBbox (Geometry.hpp:193-198)."""
        mn, mx = self.bbox()
        return jnp.all((mn <= hi) & (lo <= mx), axis=-1)


def make_hex(a0, a1, b0, b1, a0b, a1b, b0b, b1b) -> Hex:
    v = jnp.stack([a0 - b0, a1 - b0, a1 - b1, a0 - b1,
                   a0b - b0b, a1b - b0b, a1b - b1b, a0b - b1b], axis=-2)
    return Hex(v)


# --------------------------------------------------------------------------
# degeneracy / incidence predicates (Geometry.hpp:207-310)
# --------------------------------------------------------------------------

def _drop_axis(p, t):
    """Project to 2-D by keeping axes (t+1)%3, (t+2)%3."""
    return jnp.stack([p[..., (t + 1) % 3], p[..., (t + 2) % 3]], axis=-1)


def is_triangle_degenerated(t1, t2, t3) -> jax.Array:
    """True iff t1 t2 t3 are (numerically) colinear: cross-norm filter +
    three exact 2-D projections (Geometry.hpp is_triangle_degenerated)."""
    r = jnp.linalg.norm(jnp.cross(t1 - t2, t1 - t3), axis=-1)
    exact = jnp.ones(r.shape, bool)
    for j in range(3):
        o = orient2d(_drop_axis(t1, j), _drop_axis(t2, j), _drop_axis(t3, j))
        exact = exact & (o == 0)
    return (jnp.abs(r) <= 1e-8) & exact


def same_point(p1, p2) -> jax.Array:
    return jnp.all(p1 == p2, axis=-1)


def _axis_ray_ok(dirv, s0, pt, d) -> jax.Array:
    """Per-axis ray-direction consistency (point_on_ray's sign checks)."""
    dd, ss, pp = dirv[..., d], s0[..., d], pt[..., d]
    return jnp.where(dd > 0, pp > ss,
                     jnp.where(dd < 0, pp < ss, pp == ss))


def point_on_ray(s0, e0, dir0, pt) -> jax.Array:
    """0 = off-ray, 1 = on open ray, 2 = pt == s0 (Geometry.hpp:232-266)."""
    on_line = is_triangle_degenerated(s0, e0, pt)
    ok = _axis_ray_ok(dir0, s0, pt, 0) & _axis_ray_ok(dir0, s0, pt, 1) \
        & _axis_ray_ok(dir0, s0, pt, 2)
    hit = jnp.where(on_line & ok, 1, 0)
    return jnp.where(same_point(s0, pt), 2, hit).astype(jnp.int32)


def colinear_point_on_segment(pt, s0, s1) -> jax.Array:
    lo = jnp.minimum(s0, s1)
    hi = jnp.maximum(s0, s1)
    return jnp.all((lo <= pt) & (pt <= hi), axis=-1)


def point_on_segment(pt, s0, s1) -> jax.Array:
    return is_triangle_degenerated(pt, s0, s1) & \
        colinear_point_on_segment(pt, s0, s1)


def _sign(x):
    return jnp.where(x > 0, 1, jnp.where(x < 0, -1, 0)).astype(jnp.int32)


def segment_segment_intersection(s0, e0, s1, e1) -> jax.Array:
    """True iff coplanar segments (s0,e0) and (s1,e1) properly intersect
    or touch (inclusive).  Branch-free orientation-pair test."""
    o1 = _sign(orient3d_proxy(s0, e0, s1))
    o2 = _sign(orient3d_proxy(s0, e0, e1))
    o3 = _sign(orient3d_proxy(s1, e1, s0))
    o4 = _sign(orient3d_proxy(s1, e1, e0))
    proper = (o1 * o2 < 0) & (o3 * o4 < 0)
    touch = (point_on_segment(s1, s0, e0) | point_on_segment(e1, s0, e0) |
             point_on_segment(s0, s1, e1) | point_on_segment(e0, s1, e1))
    return proper | touch


def orient3d_proxy(a, b, c):
    """2-D orientation for coplanar 3-D inputs: take the projection with
    the largest plane normal component (deterministic, compensated)."""
    n = jnp.abs(jnp.cross(b - a, c - a))
    # evaluate all three projections, select by dominant normal axis
    outs = jnp.stack([orient2d(_drop_axis(a, j), _drop_axis(b, j),
                               _drop_axis(c, j)) for j in range(3)], -1)
    j = jnp.argmax(n, axis=-1)
    return jnp.take_along_axis(outs, j[..., None], axis=-1)[..., 0]


def ray_segment_intersection(s0, e0, dir0, s1, e1) -> jax.Array:
    """0 = miss, 1 = hit, 2 = ray origin on segment
    (Geometry.hpp ray_segment_intersection, deterministic re-design).

    The reference resolves the coplanar-ray case by sampling random
    out-of-plane points; here the parity test is replaced with explicit
    orientation consistency (branch-free, jit-safe): the ray hits the
    segment iff they are coplanar, the endpoints straddle the ray line,
    and the crossing parameter is non-negative.
    """
    degen_seg = same_point(s1, e1)
    on_ray_d = point_on_ray(s0, e0, dir0, s1)

    coplanar = orient3d(s0, e0, s1, e1) == 0
    origin_on = point_on_segment(s0, s1, e1)

    # straddle test in the dominant projection plane of the ray+segment
    r_s1 = orient3d_proxy(s0, e0, s1)
    r_e1 = orient3d_proxy(s0, e0, e1)
    straddles = _sign(r_s1) * _sign(r_e1) <= 0

    # crossing point must lie forward along dir0.  The segment crosses
    # the ray's line at parameter u = r_s1 / (r_s1 - r_e1) (ratio of the
    # signed areas; invariant under the projection's scaling), giving
    # crossing point p = s1 + u (e1 - s1).  Forward means
    # dot(p - s0, dir0) >= 0; multiplying through by (r_s1 - r_e1) and
    # correcting by its sign keeps it division-free:
    a = jnp.sum((s1 - s0) * dir0, -1)
    b = jnp.sum((e1 - s1) * dir0, -1)
    den = r_s1 - r_e1
    forward = (a * den + r_s1 * b) * jnp.sign(den) >= 0
    # colinear case: segment lies on the ray line
    col_s1 = point_on_ray(s0, e0, dir0, s1) > 0
    col_e1 = point_on_ray(s0, e0, dir0, e1) > 0
    seg_on_line = is_triangle_degenerated(s1, s0, e0) & \
        is_triangle_degenerated(e1, s0, e0)
    colinear_hit = seg_on_line & (col_s1 | col_e1)

    proper = coplanar & straddles & forward & ~seg_on_line
    hit = jnp.where(proper | colinear_hit, 1, 0)
    hit = jnp.where(origin_on, 2, hit)
    return jnp.where(degen_seg, on_ray_d, hit).astype(jnp.int32)


def ray_triangle_intersection(o, d, t0, t1, t2, eps: float = 0.0):
    """Watertight-ish ray/triangle: returns (hit bool, t).  Möller-Trumbore
    with orientation fallbacks handled by the caller at eps=0."""
    e1 = t1 - t0
    e2 = t2 - t0
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, -1)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    s = o - t0
    u = jnp.sum(s * p, -1) * inv
    q = jnp.cross(s, e1)
    v = jnp.sum(d * q, -1) * inv
    t = jnp.sum(e2 * q, -1) * inv
    hit = (jnp.abs(det) > 1e-12) & (u >= -eps) & (v >= -eps) & \
        (u + v <= 1 + eps) & (t >= 0)
    return hit, t
