"""B-spline interpolation kernels + grid arenas.

Reference: ``math/curve/InterpolationKernel.hpp:59-132`` (linear/quadratic/
cubic B-spline weights and derivative weights) and the ``GridArena`` stencil
object (``:271-289``) used by every transfer kernel
(``simulation/Utils.hpp:32-184``).

Re-design: weights are computed **per axis as small dense vectors** (``[...,
S]`` for stencil size S) and combined by outer products, so a particle's full
3-D stencil is ``wx ⊗ wy ⊗ wz`` — this is exactly the shape the matmul-friendly
P2G/G2P kernels consume (segment/einsum formulations instead of atomic
scatter).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

__all__ = [
    "linear_bspline_weights",
    "quadratic_bspline_weights",
    "cubic_bspline_weights",
    "bspline_weights",
    "stencil_size",
    "base_node",
]

# stencil widths per order (number of nodes touched along an axis)
_STENCIL = {1: 2, 2: 3, 3: 4}


def stencil_size(order: int) -> int:
    return _STENCIL[order]


def base_node(x_over_dx, order: int):
    """Leftmost grid node of the stencil for normalized position x/dx.

    linear: floor(x);  quadratic: floor(x - 0.5);  cubic: floor(x) - 1
    (reference InterpolationKernel.hpp / simulation/Utils.hpp:10-31).
    """
    if order == 1:
        return jnp.floor(x_over_dx).astype(jnp.int32)
    if order == 2:
        return jnp.floor(x_over_dx - 0.5).astype(jnp.int32)
    if order == 3:
        return jnp.floor(x_over_dx).astype(jnp.int32) - 1
    raise ValueError(order)


def linear_bspline_weights(fx):
    """fx = x/dx - base; weights over 2 nodes, plus d(weight)/d(fx)."""
    w = jnp.stack([1.0 - fx, fx], axis=-1)
    dw = jnp.stack([-jnp.ones_like(fx), jnp.ones_like(fx)], axis=-1)
    return w, dw


def quadratic_bspline_weights(fx):
    """fx = x/dx - base in [0.5, 1.5); weights over 3 nodes.

    (InterpolationKernel.hpp quadratic_bspline_weights.)
    """
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    dw0 = fx - 1.5
    dw1 = -2.0 * (fx - 1.0)
    dw2 = fx - 0.5
    return (jnp.stack([w0, w1, w2], -1), jnp.stack([dw0, dw1, dw2], -1))


def cubic_bspline_weights(fx):
    """fx = x/dx - (base+1) in [0,1); weights over 4 nodes at offsets
    -1..2 relative to base+1 (InterpolationKernel.hpp cubic)."""
    # distances of the 4 nodes from x: 1+fx, fx, 1-fx, 2-fx
    d0 = 1.0 + fx
    d1 = fx
    d2 = 1.0 - fx
    d3 = 2.0 - fx

    def far(d):   # 1 <= |d| < 2
        return (2.0 - d) ** 3 / 6.0

    def near(d):  # |d| < 1
        return 0.5 * d ** 3 - d * d + 2.0 / 3.0

    def dfar(d):
        return -0.5 * (2.0 - d) ** 2

    def dnear(d):
        return 1.5 * d * d - 2.0 * d

    w = jnp.stack([far(d0), near(d1), near(d2), far(d3)], -1)
    dw = jnp.stack([dfar(d0), dnear(d1), -dnear(d2), -dfar(d3)], -1)
    return w, dw


def bspline_weights(x_over_dx, order: int = 2) -> Tuple:
    """Per-axis weights for a normalized position.

    Returns (base [..., dim] int32, w [..., dim, S], dw [..., dim, S])
    where dw is d(weight)/dx in *grid units* (divide by dx for world).
    """
    base = base_node(x_over_dx, order)
    if order == 1:
        fx = x_over_dx - base
        w, dw = linear_bspline_weights(fx)
    elif order == 2:
        fx = x_over_dx - base
        w, dw = quadratic_bspline_weights(fx)
    elif order == 3:
        fx = x_over_dx - (base + 1)
        w, dw = cubic_bspline_weights(fx)
    else:
        raise ValueError(order)
    return base, w, dw
