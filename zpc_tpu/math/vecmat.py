"""Small-tensor helpers (reference ``math/Vec.h`` / ``VecInterface.hpp``).

The reference builds a full fixed-size tensor template library; in JAX,
``jnp`` arrays with batched last-dims *are* that library, so this module only
adds what jnp lacks:

* :func:`mm` / :func:`mv` — small-matrix products pinned to
  ``Precision.HIGHEST``.  The default matmul precision may round float32
  operands (TF32 on the GPU); for 3x3 constitutive/decomposition math that is a
  correctness bug (observed: Jacobi SVD stalling at ~1e-3), so every
  small-matrix product in the framework routes through here.  Large matmuls
  (P2G one-hot products etc.) intentionally keep the default.
* common small-matrix ops the sim layer uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["mm", "mm33", "det3", "mv", "outer", "trace", "frobenius",
           "identity_like", "cross_matrix", "scale_trailing"]


def scale_trailing(w, X):
    """``w[..., None, ...] * X`` without ever materializing a trailing-1
    broadcast of ``w``.

    Multiplies a scalar field ``w`` (shape = X.shape[:w.ndim]) into the
    trailing dims of ``X`` channel-by-channel.  A value shaped ``[..., 1]``
    that XLA hoists out of a solver loop (``lax.while_loop``) can be stored
    padded along its minor dimension, which inflated the implicit CG
    loop's memory (chosen before the move to the GPU; not re-measured on
    the H100).  Unrolling over the (static, tiny) trailing dims keeps
    every loop-crossing value at ``w``'s own cleanly-tiled shape.
    """
    tail = X.shape[w.ndim:]
    flat = X.reshape(X.shape[:w.ndim] + (-1,))
    cols = [w * flat[..., i] for i in range(flat.shape[-1])]
    return jnp.stack(cols, -1).reshape(X.shape[:w.ndim] + tail)


def mm(a, b):
    """Batched small-matrix @ matrix at full fp32 precision.

    3x3 (and 2x2) operands take the **unrolled elementwise path**: batched
    tiny ``dot_general`` ops were far slower than plain elementwise FMAs
    (chosen before the move to the GPU; not re-measured on the H100).
    """
    if a.shape[-2:] == (3, 3) and b.shape[-2:] == (3, 3):
        return mm33(a, b)
    if a.shape[-2:] == (2, 2) and b.shape[-2:] == (2, 2):
        rows = []
        for i in range(2):
            rows.append(jnp.stack(
                [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                 for j in range(2)], -1))
        return jnp.stack(rows, -2)
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def mm33(a, b):
    """Unrolled batched 3x3 multiply (pure elementwise FMAs)."""
    rows = []
    for i in range(3):
        rows.append(jnp.stack(
            [a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j] +
             a[..., i, 2] * b[..., 2, j] for j in range(3)], -1))
    return jnp.stack(rows, -2)


def det3(A):
    """Cofactor-expansion determinant (jnp.linalg.det lowers to LU — slow
    and needless for 3x3)."""
    if A.shape[-1] == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] -
                            A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] -
                              A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] -
                              A[..., 1, 1] * A[..., 2, 0]))


def mv(a, v):
    """Batched small-matrix @ vector at full fp32 precision."""
    return jnp.einsum("...ij,...j->...i", a, v,
                      precision=lax.Precision.HIGHEST)


def outer(u, v):
    return u[..., :, None] * v[..., None, :]


def trace(A):
    return jnp.trace(A, axis1=-2, axis2=-1)


def frobenius(A):
    return jnp.sqrt(jnp.sum(A * A, (-2, -1)))


def identity_like(A):
    return jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)


def cross_matrix(w):
    """Skew matrix [w]_x with [w]_x v = w x v."""
    zero = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([zero, -w[..., 2], w[..., 1]], -1),
        jnp.stack([w[..., 2], zero, -w[..., 0]], -1),
        jnp.stack([-w[..., 1], w[..., 0], zero], -1),
    ], -2)
