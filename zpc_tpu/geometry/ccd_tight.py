"""Tight-inclusion continuous collision detection, batched.

Reference: ``include/zensim/math/Rational.hpp:362-1265`` — the
tight-inclusion CCD of Wang et al. (NumCCD dyadic rationals, Interval3
bisection of the (t, u, v) parameter cube, 8-corner evaluation of the
multilinear gap function with a floating-point inclusion filter).

Redesign (not a translation):

* **Dyadic int32 boxes.** The reference's ``NumCCD`` (k / 2^n over u64)
  becomes per-dimension ``(k, n)`` int32 pairs with n ≤ 23, so every box
  corner ``k * 2^-n`` is *exactly* representable in fp32 — the same
  exactness argument as NumCCD, sized to the fp32 mantissa.  Splitting a
  dimension maps (k, n) → (2k, n+1), (2k+1, n+1); the simplex test
  u + v ≤ 1 is done exactly in shifted int32.
* **Lockstep DFS with fixed-capacity stacks.**  Recursion becomes a
  ``lax.while_loop`` over a ``[Q, S, 6]`` int32 stack; every query pops,
  evaluates, and pushes in the same vectorized step (divergence costs
  masked lanes, not recompilation).  Stack overflow and the iteration
  cap degrade **conservatively**: the unrefined box's t_lo is folded
  into the answer, so a hit is never missed.
* **fp32 corner evaluation + conservative filter.**  The gap function is
  multilinear in (t, u, v), so its range over a box is spanned by the 8
  corners; corners are evaluated in fp32 and widened by a γ-style bound
  (64 ulp of the largest input magnitude), replacing the reference's
  double-precision filter constants.

Returned ``toi`` is a conservative lower bound on the true time of
impact and is within ``tol`` of it when the box refinement converged
(``overflowed == False``).  Time is normalized to [0, 1]: callers scale
``dt`` into the displacement arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["CCDResult", "vertex_face_ccd", "edge_edge_ccd_tight"]

_N_MAX = 23          # deepest dyadic level: corners stay exact in fp32
_EPS32 = 2.0 ** -23


class CCDResult(NamedTuple):
    toi: jax.Array        # [Q] fp32, conservative earliest impact; inf = miss
    hit: jax.Array        # [Q] bool
    overflowed: jax.Array  # [Q] bool: stack overflow / iteration cap hit


def _ldexp_lo(k, n):
    """Exact fp32 value of the dyadic k / 2^n (k < 2^n ≤ 2^23)."""
    return k.astype(jnp.float32) * jnp.exp2(-n.astype(jnp.float32))


def _corners(box):
    """box [Q, 6] int32 → (lo, hi) pairs per dim, each [Q] fp32."""
    tk, tn, uk, un, vk, vn = (box[:, i] for i in range(6))
    tl = _ldexp_lo(tk, tn)
    ul = _ldexp_lo(uk, un)
    vl = _ldexp_lo(vk, vn)
    th = _ldexp_lo(tk + 1, tn)
    uh = _ldexp_lo(uk + 1, un)
    vh = _ldexp_lo(vk + 1, vn)
    return (tl, th), (ul, uh), (vl, vh)


def _gap_corners_vf(tb, ub, vb, p0, p1, a0, a1, b0, b1, c0, c1):
    """Vertex-face gap F = p(t) - ((1-u-v) a(t) + u b(t) + v c(t)) at the
    8 box corners.  Returns [Q, 2, 2, 2, 3]."""
    t = jnp.stack(tb, -1)[:, :, None, None, None]        # [Q,2,1,1,1]
    u = jnp.stack(ub, -1)[:, None, :, None, None]
    v = jnp.stack(vb, -1)[:, None, None, :, None]

    def lerp(x0, x1, w):
        return x0[:, None, None, None, :] + w * (
            (x1 - x0)[:, None, None, None, :])

    pt = lerp(p0, p1, t)
    at = lerp(a0, a1, t)
    bt = lerp(b0, b1, t)
    ct = lerp(c0, c1, t)
    return pt - (at + u * (bt - at) + v * (ct - at))


def _gap_corners_ee(tb, ub, vb, a00, a01, a10, a11, b00, b01, b10, b11):
    """Edge-edge gap F = ((1-u) a0(t) + u a1(t)) - ((1-v) b0(t) + v b1(t))."""
    t = jnp.stack(tb, -1)[:, :, None, None, None]
    u = jnp.stack(ub, -1)[:, None, :, None, None]
    v = jnp.stack(vb, -1)[:, None, None, :, None]

    def lerp(x0, x1, w):
        return x0[:, None, None, None, :] + w * (
            (x1 - x0)[:, None, None, None, :])

    ea0 = lerp(a00, a01, t)
    ea1 = lerp(a10, a11, t)
    eb0 = lerp(b00, b01, t)
    eb1 = lerp(b10, b11, t)
    return (ea0 + u * (ea1 - ea0)) - (eb0 + v * (eb1 - eb0))


def _t_early(g, tb, band):
    """Conservative earliest impact time inside a box, from its 8 corner
    gap values.  For multilinear F, min_uv F(t,·,·,c) ≥ lerp of the
    per-face minima, so while that lerp stays above +band (resp. the max
    lerp below -band) no root can exist: solve the crossing point per
    coordinate and take the latest.  Strictly sharper than t_lo for
    pruning and for conservative fallbacks."""
    a_min = jnp.min(g[:, 0], axis=(1, 2))     # [Q, 3] at t_lo
    b_min = jnp.min(g[:, 1], axis=(1, 2))     # at t_hi
    a_max = jnp.max(g[:, 0], axis=(1, 2))
    b_max = jnp.max(g[:, 1], axis=(1, 2))
    bnd = band[:, None]
    s_lo = jnp.where(a_min > bnd,
                     (a_min - bnd) / jnp.maximum(a_min - b_min, 1e-30), 0.0)
    s_hi = jnp.where(a_max < -bnd,
                     (-bnd - a_max) / jnp.maximum(b_max - a_max, 1e-30), 0.0)
    s = jnp.clip(jnp.max(jnp.maximum(s_lo, s_hi), axis=-1), 0.0, 1.0)
    t_lo, t_hi = tb
    return t_lo + s * (t_hi - t_lo)


def _simplex_excluded(box):
    """Exact dyadic test: the whole box lies outside u + v ≤ 1, i.e.
    u_lo + v_lo > 1, evaluated as shifted int32 (no rounding)."""
    uk, un, vk, vn = box[:, 2], box[:, 3], box[:, 4], box[:, 5]
    m = jnp.maximum(un, vn)
    lhs = (uk << (m - un)) + (vk << (m - vn))   # < 2^24: no overflow
    return lhs > (1 << m)


def _ccd_loop(init_args, gap_fn, pts, min_sep, tol, max_iter, stack_size,
              simplex):
    """Shared lockstep bisection loop.  ``pts`` is the tuple of point
    arrays handed to ``gap_fn``; ``simplex`` enables the u+v ≤ 1 domain."""
    import math
    Q = pts[0].shape[0]
    S = stack_size
    n_tol = min(_N_MAX, max(1, int(math.ceil(-math.log2(float(tol))))))

    # conservative rounding filter per query: the gap evaluation is a
    # short chain of fp32 lerps of the inputs → |err| ≤ 64 ulp(M)
    mags = jnp.stack([jnp.max(jnp.abs(p), axis=-1) for p in pts], axis=0)
    err = 64.0 * _EPS32 * jnp.maximum(jnp.max(mags, axis=0), 1.0)  # [Q]
    band = err + jnp.asarray(min_sep, jnp.float32)                 # [Q]

    stack = jnp.zeros((Q, S, 6), jnp.int32)    # root box (k=0, n=0)^3
    sp = jnp.ones((Q,), jnp.int32)
    toi = jnp.full((Q,), jnp.inf, jnp.float32)
    ovf = jnp.zeros((Q,), jnp.bool_)
    qar = jnp.arange(Q)

    def cond(c):
        it, sp = c[0], c[2]
        return (it < max_iter) & jnp.any(sp > 0)

    def body(c):
        it, stack, sp, toi, ovf = c
        active = sp > 0
        idx = jnp.maximum(sp - 1, 0)
        box = jnp.take_along_axis(stack, idx[:, None, None], axis=1)[:, 0]
        sp2 = sp - active.astype(jnp.int32)

        tb, ub, vb = _corners(box)
        g = gap_fn(tb, ub, vb, *pts)                      # [Q,2,2,2,3]
        t_lo = _t_early(g, tb, band)      # sharpest conservative bound
        live = active & (t_lo < toi)                      # prune by best
        if simplex:
            live = live & ~_simplex_excluded(box)

        gmin = jnp.min(g, axis=(1, 2, 3))
        gmax = jnp.max(g, axis=(1, 2, 3))
        inc = jnp.all((gmin <= band[:, None]) & (gmax >= -band[:, None]),
                      axis=-1)
        live = live & inc

        # existence certificate: if the gap at the box center is strictly
        # inside ±(min_sep - err), a true root exists in this box — no
        # (u, v) refinement is needed once t is resolved.  Without this,
        # fat root manifolds (min_sep > 0) force an exponential number of
        # sibling (u, v) boxes through the full refinement depth.
        ctr = tuple((0.5 * (lo + hi), 0.5 * (lo + hi))
                    for lo, hi in (tb, ub, vb))
        gc = gap_fn(*ctr, *pts)[:, 0, 0, 0, :]
        certified = jnp.all(
            jnp.abs(gc) <= jnp.asarray(min_sep, jnp.float32) - err[:, None],
            axis=-1)

        ns = box[:, 1::2]                                 # (tn, un, vn)
        nmin = jnp.min(ns, axis=-1)
        terminal = live & ((nmin >= n_tol) |
                           (certified & (ns[:, 0] >= n_tol)))
        toi = jnp.where(terminal, jnp.minimum(toi, t_lo), toi)

        split = live & ~terminal
        # Split the dimension with the largest IMAGE width (co-domain
        # extent across the 8 corners), as in tight-inclusion: splitting
        # the widest *parameter* lets uninformative dims double branches
        # exponentially while the informative one lags.  Ties break to t
        # (argmax picks the first).  Certified boxes only need t
        # resolved — force d = t.  Refusal to split past _N_MAX keeps
        # corners fp32-exact: such a dim reports width 0.
        spans = jnp.stack(
            [jnp.max(jnp.abs(g[:, 1] - g[:, 0]), axis=(1, 2, 3)),
             jnp.max(jnp.abs(g[:, :, 1] - g[:, :, 0]), axis=(1, 2, 3)),
             jnp.max(jnp.abs(g[:, :, :, 1] - g[:, :, :, 0]),
                     axis=(1, 2, 3))], axis=-1)           # [Q, 3]
        spans = jnp.where(ns >= _N_MAX, 0.0, spans)
        d = jnp.where(certified & (ns[:, 0] < _N_MAX), 0,
                      jnp.argmax(spans, axis=-1)).astype(jnp.int32)
        kd = jnp.take_along_axis(box, (2 * d)[:, None], axis=1)[:, 0]
        nd = jnp.take_along_axis(box, (2 * d + 1)[:, None], axis=1)[:, 0]
        child_lo = box.at[qar, 2 * d].set(2 * kd).at[qar, 2 * d + 1].set(
            nd + 1)
        child_hi = child_lo.at[qar, 2 * d].set(2 * kd + 1)

        room = sp2 + 2 <= S
        do_push = split & room
        # overflow degrades conservatively: count the unrefined box as a
        # potential hit at its t_lo
        blown = split & ~room
        toi = jnp.where(blown, jnp.minimum(toi, t_lo), toi)
        ovf = ovf | blown

        pos_hi = jnp.where(do_push, sp2, S)               # S → dropped
        pos_lo = jnp.where(do_push, sp2 + 1, S)
        stack = stack.at[qar, pos_hi].set(child_hi, mode="drop")
        stack = stack.at[qar, pos_lo].set(child_lo, mode="drop")
        sp2 = sp2 + 2 * do_push.astype(jnp.int32)
        return it + 1, stack, sp2, toi, ovf

    it, stack, sp, toi, ovf = jax.lax.while_loop(
        cond, body, (jnp.int32(0), stack, sp, toi, ovf))

    # iteration cap with work left: fold remaining boxes in conservatively,
    # but only those that would survive the prune/domain/inclusion tests
    # (a raw t_lo min would let long-dead bottom-of-stack boxes destroy a
    # converged answer)
    def leftover_tlo(k, acc):
        box = stack[:, k]
        tb, ub, vb = _corners(box)
        g = gap_fn(tb, ub, vb, *pts)
        te = _t_early(g, tb, band)
        ok = (k < sp) & (te < toi)
        if simplex:
            ok = ok & ~_simplex_excluded(box)
        gmn = jnp.min(g, axis=(1, 2, 3))
        gmx = jnp.max(g, axis=(1, 2, 3))
        ok = ok & jnp.all((gmn <= band[:, None]) & (gmx >= -band[:, None]),
                          axis=-1)
        live_any, tmin = acc
        return live_any | ok, jnp.where(ok, jnp.minimum(tmin, te), tmin)

    live_any, tmin = jax.lax.fori_loop(
        0, S, leftover_tlo,
        (jnp.zeros((Q,), jnp.bool_), jnp.full((Q,), jnp.inf, jnp.float32)))
    toi = jnp.where(live_any, jnp.minimum(toi, tmin), toi)
    ovf = ovf | live_any
    return CCDResult(toi=toi, hit=jnp.isfinite(toi), overflowed=ovf)


def vertex_face_ccd(p, t0, t1, t2, dp, dt0, dt1, dt2, *, min_sep=0.0,
                    tol=1e-6, max_iter=1024, stack_size=96) -> CCDResult:
    """Batched conservative vertex-triangle CCD over t ∈ [0, 1].

    All points are [Q, 3]; ``d*`` are displacements over the step.
    Reference: Rational.hpp ``vertexFaceCCD`` (:813-1008).
    """
    pts = (p, p + dp, t0, t0 + dt0, t1, t1 + dt1, t2, t2 + dt2)
    return _ccd_loop(None, _gap_corners_vf, pts, min_sep, tol, max_iter,
                     stack_size, simplex=True)


def edge_edge_ccd_tight(a0, a1, b0, b1, da0, da1, db0, db1, *, min_sep=0.0,
                        tol=1e-6, max_iter=1024, stack_size=96) -> CCDResult:
    """Batched conservative edge-edge CCD over t ∈ [0, 1].

    Reference: Rational.hpp ``edgeEdgeCCD`` (:1010-1265).
    """
    pts = (a0, a0 + da0, a1, a1 + da1, b0, b0 + db0, b1, b1 + db1)
    return _ccd_loop(None, _gap_corners_ee, pts, min_sep, tol, max_iter,
                     stack_size, simplex=False)
