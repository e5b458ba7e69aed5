"""Distance queries & CCD (reference ``geometry/Distance.hpp:233-2450``,
``SpatialQuery.hpp``, ``Friction.hpp`` precursors; IPC-style primitives).

Re-design: every query is **batched and branch-free** — the reference's
per-case distance-type dispatch (point-point/point-edge/point-triangle
regions) becomes clamped barycentric projections computed for all lanes with
``where`` selects.  Gradients come from autodiff (the reference hand-derives
gradient + hessian for each of the 9 cases, Distance.hpp).

CCD uses conservative advancement (additive CCD): a bounded ``fori_loop``
advancing by a safe fraction of distance/relative-speed, vectorized over
query pairs — instead of the reference's per-thread iterative root-finders.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

__all__ = [
    "point_point_dist2", "point_edge_closest", "point_edge_dist2",
    "point_triangle_closest", "point_triangle_dist2",
    "edge_edge_closest", "edge_edge_dist2",
    "ray_triangle", "segment_triangle_intersect",
    "point_triangle_ccd", "edge_edge_ccd",
]


def _dot(a, b):
    return jnp.sum(a * b, -1)


def point_point_dist2(p, q):
    d = p - q
    return _dot(d, d)


def point_edge_closest(p, e0, e1):
    """Closest point on segment [e0, e1]; returns (t, closest)."""
    d = e1 - e0
    t = _dot(p - e0, d) / jnp.maximum(_dot(d, d), 1e-30)
    t = jnp.clip(t, 0.0, 1.0)
    return t, e0 + t[..., None] * d


def point_edge_dist2(p, e0, e1):
    _, c = point_edge_closest(p, e0, e1)
    return point_point_dist2(p, c)


def point_triangle_closest(p, a, b, c):
    """Closest point on triangle abc (Ericson's barycentric clamping,
    branch-free).  Returns (bary [..., 3], closest [..., 3])."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = jnp.maximum(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    bary_face = jnp.stack([1.0 - v - w, v, w], -1)

    # vertex regions
    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    # edge regions
    vab = d1 * d4 - d3 * d2
    reg_ab = (~reg_a) & (~reg_b) & (vab <= 0) & (d1 >= 0) & (d3 <= 0)
    vac = d5 * d2 - d1 * d6
    reg_ac = (~reg_a) & (~reg_c) & (vac <= 0) & (d2 >= 0) & (d6 <= 0)
    vbc = d3 * d6 - d5 * d4
    reg_bc = (~reg_b) & (~reg_c) & (vbc <= 0) & ((d4 - d3) >= 0) & \
        ((d5 - d6) >= 0)

    t_ab = jnp.clip(d1 / jnp.maximum(d1 - d3, 1e-30), 0, 1)
    t_ac = jnp.clip(d2 / jnp.maximum(d2 - d6, 1e-30), 0, 1)
    t_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6), 1e-30),
                    0, 1)

    bary = bary_face
    z = jnp.zeros_like(v)
    o = jnp.ones_like(v)

    def pick(cond, bb):
        return jnp.where(cond[..., None], bb, bary)

    bary = pick(reg_bc, jnp.stack([z, 1 - t_bc, t_bc], -1))
    bary = pick(reg_ac, jnp.stack([1 - t_ac, z, t_ac], -1))
    bary = pick(reg_ab, jnp.stack([1 - t_ab, t_ab, z], -1))
    bary = pick(reg_c, jnp.stack([z, z, o], -1))
    bary = pick(reg_b, jnp.stack([z, o, z], -1))
    bary = pick(reg_a, jnp.stack([o, z, z], -1))
    closest = (bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c)
    return bary, closest


def point_triangle_dist2(p, a, b, c):
    _, cl = point_triangle_closest(p, a, b, c)
    return point_point_dist2(p, cl)


def edge_edge_closest(p0, p1, q0, q1):
    """Closest points between segments; returns (s, t, cp, cq)
    (Ericson 5.1.9, branch-free clamp iteration)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = jnp.maximum(a * e - b * b, 1e-30)
    s = jnp.clip((b * f - c * e) / denom, 0.0, 1.0)
    # recompute t for clamped s, then re-clamp s
    t = (b * s + f) / jnp.maximum(e, 1e-30)
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.clip((b * t_cl - c) / jnp.maximum(a, 1e-30), 0.0, 1.0)
    cp = p0 + s[..., None] * d1
    cq = q0 + t_cl[..., None] * d2
    return s, t_cl, cp, cq


def edge_edge_dist2(p0, p1, q0, q1):
    _, _, cp, cq = edge_edge_closest(p0, p1, q0, q1)
    return point_point_dist2(cp, cq)


def ray_triangle(o, d, a, b, c, eps: float = 1e-9):
    """Moller-Trumbore; returns (hit, t, u, v), t=inf on miss."""
    e1 = b - a
    e2 = c - a
    pv = jnp.cross(d, e2)
    det = _dot(e1, pv)
    inv = 1.0 / jnp.where(jnp.abs(det) < eps, jnp.inf, det)
    tv = o - a
    u = _dot(tv, pv) * inv
    qv = jnp.cross(tv, e1)
    v = _dot(d, qv) * inv
    t = _dot(e2, qv) * inv
    hit = (jnp.abs(det) >= eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return hit, jnp.where(hit, t, jnp.inf), u, v


def segment_triangle_intersect(p0, p1, a, b, c):
    """(Geometry.hpp segment/triangle tests)."""
    d = p1 - p0
    hit, t, _, _ = ray_triangle(p0, d, a, b, c)
    return hit & (t <= 1.0)


def _ccd(dist_fn, x0_list, v_list, min_sep, max_iters):
    """Conservative-advancement core: advance time while closest distance
    stays above min_sep; returns earliest safe time-of-impact in [0, 1]."""
    speeds = sum(jnp.linalg.norm(v, axis=-1) for v in v_list)
    speeds = jnp.maximum(speeds, 1e-30)

    def body(_, t):
        xs = [x + t[..., None] * v for x, v in zip(x0_list, v_list)]
        d = jnp.sqrt(jnp.maximum(dist_fn(*xs), 0.0))
        step = 0.9 * jnp.maximum(d - min_sep, 0.0) / speeds
        return jnp.minimum(t + step, 1.0)

    t = jnp.zeros_like(speeds)
    return jax.lax.fori_loop(0, max_iters, body, t)


def point_triangle_ccd(p, a, b, c, dp, da, db, dc,
                       min_sep: float = 1e-4, max_iters: int = 32):
    """Time of impact in [0,1] for a moving point vs moving triangle
    (Distance.hpp CCD family; additive conservative advancement)."""
    return _ccd(point_triangle_dist2, [p, a, b, c], [dp, da, db, dc],
                min_sep, max_iters)


def edge_edge_ccd(p0, p1, q0, q1, dp0, dp1, dq0, dq1,
                  min_sep: float = 1e-4, max_iters: int = 32):
    return _ccd(edge_edge_dist2, [p0, p1, q0, q1], [dp0, dp1, dq0, dq1],
                min_sep, max_iters)
