"""Small-matrix decompositions, batched.

Reference: 3x3/2x2 SVD (``math/matrix/SVD.hpp``), polar & QR-SVD
(``QRSVD.hpp``), Givens rotations (``Givens.hpp``), eigen (``Eigen.hpp``).

Re-design: the reference runs one decomposition per CUDA thread with
branchy scalar code.  Here every routine is written **branch-free over
batches** so ``vmap`` lays thousands of 3x3 problems across vector lanes:

* 2x2 SVD: closed-form rotation angles (no iteration).
* 3x3 symmetric eigen: cyclic Jacobi with a *fixed* sweep count (data
  -independent control flow; 4 sweeps exceed fp32 precision).
* 3x3 SVD: eigen of A^T A -> V, then QR/polar cleanup for U with sign
  handling for degenerate/reflective cases (det(U)=det(V)=+1 convention, as
  required by corotated constitutive models, physics/ConstitutiveModel.hpp).
* polar decomposition via SVD.

All fp32; a ``compensated`` fp64-free path is unnecessary at MPM tolerances.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .vecmat import mm, det3

__all__ = [
    "svd2x2",
    "svd3x3",
    "polar_decomposition",
    "polar_newton3x3",
    "eigh3x3",
    "qr3x3",
]


def _jacobi_rotation(app, aqq, apq):
    """Givens angle zeroing off-diagonal apq (branch-free)."""
    tau = (aqq - app) / (2.0 * jnp.where(apq == 0.0, 1.0, apq))
    sgn = jnp.where(tau >= 0.0, 1.0, -1.0)  # sign(0) must be 1, not 0
    t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(apq == 0.0, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def eigh3x3(A, sweeps: int = 6):
    """Symmetric 3x3 eigendecomposition by cyclic Jacobi, batched.

    Returns (eigenvalues desc-sorted [..., 3], eigenvectors [..., 3, 3]
    columns).  Fixed sweep count -> no data-dependent control flow.

    Scalar form: the symmetric matrix is carried as its 6 unique entries and
    V as 9 scalar components; each rotation is ~20 elementwise FMAs.  (A
    matrix-product formulation of tiny batched matmuls was far slower;
    chosen before the move to the GPU, not re-measured on the H100.)  No
    intermediate ever has a trailing length-1 axis: such values, when XLA
    hoists them out of a solver loop (e.g. the jvp-through-svd primal
    inside implicit CG), can be stored padded along that axis.
    """
    Ah = 0.5 * (A + jnp.swapaxes(A, -1, -2))
    a00, a11, a22 = Ah[..., 0, 0], Ah[..., 1, 1], Ah[..., 2, 2]
    a01, a02, a12 = Ah[..., 0, 1], Ah[..., 0, 2], Ah[..., 1, 2]
    one = jnp.ones_like(a00)
    zero = jnp.zeros_like(a00)
    # V columns as 9 scalar components: v<col><component>
    v0x, v0y, v0z = one, zero, zero
    v1x, v1y, v1z = zero, one, zero
    v2x, v2y, v2z = zero, zero, one

    def rot01(s):
        (a00, a11, a22, a01, a02, a12,
         v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = s
        c, sn = _jacobi_rotation(a00, a11, a01)
        n00 = c * c * a00 - 2 * sn * c * a01 + sn * sn * a11
        n11 = sn * sn * a00 + 2 * sn * c * a01 + c * c * a11
        n02 = c * a02 - sn * a12
        n12 = sn * a02 + c * a12
        nv0x, nv0y, nv0z = (c * v0x - sn * v1x, c * v0y - sn * v1y,
                            c * v0z - sn * v1z)
        nv1x, nv1y, nv1z = (sn * v0x + c * v1x, sn * v0y + c * v1y,
                            sn * v0z + c * v1z)
        return (n00, n11, a22, zero, n02, n12,
                nv0x, nv0y, nv0z, nv1x, nv1y, nv1z, v2x, v2y, v2z)

    def rot02(s):
        (a00, a11, a22, a01, a02, a12,
         v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = s
        c, sn = _jacobi_rotation(a00, a22, a02)
        n00 = c * c * a00 - 2 * sn * c * a02 + sn * sn * a22
        n22 = sn * sn * a00 + 2 * sn * c * a02 + c * c * a22
        n01 = c * a01 - sn * a12
        n12 = sn * a01 + c * a12
        nv0x, nv0y, nv0z = (c * v0x - sn * v2x, c * v0y - sn * v2y,
                            c * v0z - sn * v2z)
        nv2x, nv2y, nv2z = (sn * v0x + c * v2x, sn * v0y + c * v2y,
                            sn * v0z + c * v2z)
        return (n00, a11, n22, n01, zero, n12,
                nv0x, nv0y, nv0z, v1x, v1y, v1z, nv2x, nv2y, nv2z)

    def rot12(s):
        (a00, a11, a22, a01, a02, a12,
         v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = s
        c, sn = _jacobi_rotation(a11, a22, a12)
        n11 = c * c * a11 - 2 * sn * c * a12 + sn * sn * a22
        n22 = sn * sn * a11 + 2 * sn * c * a12 + c * c * a22
        n01 = c * a01 - sn * a02
        n02 = sn * a01 + c * a02
        nv1x, nv1y, nv1z = (c * v1x - sn * v2x, c * v1y - sn * v2y,
                            c * v1z - sn * v2z)
        nv2x, nv2y, nv2z = (sn * v1x + c * v2x, sn * v1y + c * v2y,
                            sn * v1z + c * v2z)
        return (a00, n11, n22, n01, n02, zero,
                v0x, v0y, v0z, nv1x, nv1y, nv1z, nv2x, nv2y, nv2z)

    s = (a00, a11, a22, a01, a02, a12,
         v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z)
    for _ in range(sweeps):
        s = rot12(rot02(rot01(s)))
    (a00, a11, a22, a01, a02, a12,
     v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = s

    # descending sort by a 3-element compare-swap network (argsort +
    # take_along_axis costs minor-axis gathers; where-swaps are free)
    def cswap(wa, va, wb, vb):
        swap = wb > wa
        wa2 = jnp.where(swap, wb, wa)
        wb2 = jnp.where(swap, wa, wb)
        va2 = tuple(jnp.where(swap, b, a) for a, b in zip(va, vb))
        vb2 = tuple(jnp.where(swap, a, b) for a, b in zip(va, vb))
        return wa2, va2, wb2, vb2

    w0, w1, w2 = a00, a11, a22
    v0, v1, v2 = (v0x, v0y, v0z), (v1x, v1y, v1z), (v2x, v2y, v2z)
    w0, v0, w1, v1 = cswap(w0, v0, w1, v1)
    w1, v1, w2, v2 = cswap(w1, v1, w2, v2)
    w0, v0, w1, v1 = cswap(w0, v0, w1, v1)
    w = jnp.stack([w0, w1, w2], -1)
    V = jnp.stack([
        jnp.stack([v0[0], v1[0], v2[0]], -1),
        jnp.stack([v0[1], v1[1], v2[1]], -1),
        jnp.stack([v0[2], v1[2], v2[2]], -1)], -2)   # columns
    return w, V


def svd2x2(A):
    """Closed-form 2x2 SVD with rotation U, V (det=+1) and signed sigma.

    Returns (U, sigma[...,2], V) with A = U @ diag(sigma) @ V^T.
    """
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    E = 0.5 * (a + d)
    F = 0.5 * (a - d)
    G = 0.5 * (c + b)
    H = 0.5 * (c - b)
    Q = jnp.sqrt(E * E + H * H)
    R = jnp.sqrt(F * F + G * G)
    sx = Q + R
    sy = Q - R
    a1 = jnp.arctan2(G, F)
    a2 = jnp.arctan2(H, E)
    theta = 0.5 * (a2 - a1)   # V angle
    phi = 0.5 * (a2 + a1)     # U angle
    cU, sU = jnp.cos(phi), jnp.sin(phi)
    cV, sV = jnp.cos(theta), jnp.sin(theta)
    U = jnp.stack([jnp.stack([cU, -sU], -1), jnp.stack([sU, cU], -1)], -2)
    V = jnp.stack([jnp.stack([cV, sV], -1), jnp.stack([-sV, cV], -1)], -2)
    sigma = jnp.stack([sx, sy], -1)
    return U, sigma, V


def _svd3x3_impl(A, sweeps: int = 6):
    ATA = mm(jnp.swapaxes(A, -1, -2), A)
    _, V = eigh3x3(ATA, sweeps)
    # det(V) = +1: negate the third column if needed — scalar-form sign
    # multiply (a [..,1,1]-shaped where mask would be hoisted lane-padded
    # out of solver loops, see eigh3x3 docstring)
    sgn = jnp.where(det3(V) < 0, -1.0, 1.0)
    V = jnp.stack([
        jnp.stack([V[..., i, 0], V[..., i, 1], sgn * V[..., i, 2]], -1)
        for i in range(3)], -2)
    B = mm(A, V)                    # = U diag(s)
    # Build U by normalizing B's columns, Gram-Schmidt completing any
    # degenerate ones.  Everything below is written in *scalar form* —
    # per-component [..] arrays, never a trailing length-1 axis — because
    # values of shape [.., 1] that survive to a loop boundary get laid out
    # lane-padded 128x by XLA (each bf16[16384,128,1] hoisted residual of
    # this function cost 512 MB inside the implicit CG loop at 1M
    # particles; scalar form keeps every crossing value [..]-shaped).
    eps = jnp.asarray(1e-12, A.dtype)
    b0x, b0y, b0z = B[..., 0, 0], B[..., 1, 0], B[..., 2, 0]
    b1x, b1y, b1z = B[..., 0, 1], B[..., 1, 1], B[..., 2, 1]
    b2x, b2y, b2z = B[..., 0, 2], B[..., 1, 2], B[..., 2, 2]
    s0 = jnp.sqrt(jnp.maximum(b0x * b0x + b0y * b0y + b0z * b0z, 0.0))
    s1 = jnp.sqrt(jnp.maximum(b1x * b1x + b1y * b1y + b1z * b1z, 0.0))
    inv0 = 1.0 / jnp.maximum(s0, eps)
    u0x, u0y, u0z = b0x * inv0, b0y * inv0, b0z * inv0
    d = b1x * u0x + b1y * u0y + b1z * u0z
    w1x, w1y, w1z = b1x - d * u0x, b1y - d * u0y, b1z - d * u0z
    n1 = jnp.sqrt(jnp.maximum(w1x * w1x + w1y * w1y + w1z * w1z, 0.0))
    # fallback direction when column degenerate: any vector orthogonal to
    # u0 — cross(u0, e_x) = (0, u0z, -u0y), cross(u0, e_y) = (-u0z, 0, u0x)
    na = jnp.sqrt(u0y * u0y + u0z * u0z)
    use_ex = na > 1e-6
    ax = jnp.where(use_ex, 0.0, -u0z)
    ay = jnp.where(use_ex, u0z, 0.0)
    az = jnp.where(use_ex, -u0y, u0x)
    inva = 1.0 / jnp.maximum(jnp.sqrt(ax * ax + ay * ay + az * az), eps)
    ok1 = n1 > 1e-8
    inv1 = 1.0 / jnp.maximum(n1, eps)
    u1x = jnp.where(ok1, w1x * inv1, ax * inva)
    u1y = jnp.where(ok1, w1y * inv1, ay * inva)
    u1z = jnp.where(ok1, w1z * inv1, az * inva)
    # right-handed completion => det(U) = +1
    u2x = u0y * u1z - u0z * u1y
    u2y = u0z * u1x - u0x * u1z
    u2z = u0x * u1y - u0y * u1x
    # degenerate first column (A ~ 0): fall back to identity frame
    tiny = s0 < 1e-12
    one = jnp.ones_like(s0)
    zero = jnp.zeros_like(s0)
    u0x = jnp.where(tiny, one, u0x)
    u0y = jnp.where(tiny, zero, u0y)
    u0z = jnp.where(tiny, zero, u0z)
    u1x = jnp.where(tiny, zero, u1x)
    u1y = jnp.where(tiny, one, u1y)
    u1z = jnp.where(tiny, zero, u1z)
    u2x = jnp.where(tiny, zero, u2x)
    u2y = jnp.where(tiny, zero, u2y)
    u2z = jnp.where(tiny, one, u2z)
    U = jnp.stack([
        jnp.stack([u0x, u1x, u2x], -1),
        jnp.stack([u0y, u1y, u2y], -1),
        jnp.stack([u0z, u1z, u2z], -1)], -2)
    # Signed sigma_2: U is a rotation by construction, so for reflective A
    # (det < 0) the third column of B = U diag(s) points along -u2; the
    # projection gives the correctly signed singular value directly.
    s2 = u2x * b2x + u2y * b2y + u2z * b2z
    s = jnp.stack([s0, s1, s2], -1)
    return U, s, V


@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def svd3x3(A, sweeps: int = 6):
    """Batched 3x3 SVD, rotation convention: ``A = U diag(s) V^T`` with
    ``det(U) = det(V) = +1`` and ``s0 >= s1 >= |s2|`` (s2 may be negative for
    reflective A) — the convention corotated elasticity expects
    (reference QRSVD.hpp).

    Carries a closed-form ``custom_jvp``: differentiating *through* the
    unrolled Jacobi sweeps makes jvp graphs explode (XLA:CPU compiles took
    tens of minutes inside the implicit solver tests) and litters solver
    loops with hoisted intermediates.  The analytic rule below is ~60
    elementwise ops.
    """
    return _svd3x3_impl(A, sweeps)


@svd3x3.defjvp
def _svd3x3_jvp(sweeps, primals, tangents):
    """Analytic SVD differential.

    With ``U^T dU = Om_U`` and ``V^T dV = Om_V`` (both skew) and
    ``P = U^T dA V``:  ``P = Om_U S + diag(ds) - S Om_V``, giving
    ``ds_i = P_ii`` and, per off-diagonal pair (i < j), the 2x2 system
    ``s_j x - s_i y = P_ij``, ``s_j y - s_i x = P_ji`` for
    ``x = Om_U[i,j]``, ``y = Om_V[i,j]``.  Solved via the conditioning
    split ``x + y = (P_ij + P_ji) / (s_j - s_i)`` (singular at repeated
    singular values — U, V individually are non-differentiable there) and
    ``x - y = (P_ij - P_ji) / (s_j + s_i)`` (the part rotations R = U V^T
    actually consume), with scale-invariant clamped inverses so repeated /
    opposite singular values degrade gracefully instead of producing inf.
    """
    (A,) = primals
    (dA,) = tangents
    U, s, V = _svd3x3_impl(A, sweeps)
    P = mm(mm(jnp.swapaxes(U, -1, -2), dA), V)
    ds = jnp.stack([P[..., 0, 0], P[..., 1, 1], P[..., 2, 2]], -1)

    def _pair(i, j):
        si, sj = s[..., i], s[..., j]
        pij, pji = P[..., i, j], P[..., j, i]
        d, t = sj - si, sj + si
        # absolute floor 1e-12 (not epsilon-tiny): accelerators may flush
        # subnormals to zero, and 1e-8 * 1e-30 == 1e-38 flushes -> 0/0 = NaN
        # for zero/near-zero matrices (caught by a degenerate-input probe on
        # real hardware)
        m2 = si * si + sj * sj + 1e-12
        inv_d = d / (d * d + 1e-8 * m2)
        inv_t = t / (t * t + 1e-8 * m2)
        xpy = (pij + pji) * inv_d
        xmy = (pij - pji) * inv_t
        return 0.5 * (xpy + xmy), 0.5 * (xpy - xmy)

    u01, v01 = _pair(0, 1)
    u02, v02 = _pair(0, 2)
    u12, v12 = _pair(1, 2)
    zero = jnp.zeros_like(ds[..., 0])

    def _skew(w01, w02, w12):
        return jnp.stack([
            jnp.stack([zero, w01, w02], -1),
            jnp.stack([-w01, zero, w12], -1),
            jnp.stack([-w02, -w12, zero], -1)], -2)

    dU = mm(U, _skew(u01, u02, u12))
    dV = mm(V, _skew(v01, v02, v12))
    return (U, s, V), (dU, ds, dV)


def polar_decomposition(A, sweeps: int = 6):
    """A = R S with R rotation, S symmetric PSD-ish (reference polar in
    QRSVD.hpp) — used by corotated models."""
    U, s, V = svd3x3(A, sweeps)
    R = mm(U, jnp.swapaxes(V, -1, -2))
    Vt = jnp.swapaxes(V, -1, -2)
    sVt = jnp.stack([jnp.stack(
        [s[..., i] * Vt[..., i, j] for j in range(3)], -1)
        for i in range(3)], -2)
    S = mm(V, sVt)
    return R, S


def _cof3(F):
    """Cofactor matrix via column cross products (valid for singular F)."""
    c0 = jnp.cross(F[..., :, 1], F[..., :, 2], axis=-1)
    c1 = jnp.cross(F[..., :, 2], F[..., :, 0], axis=-1)
    c2 = jnp.cross(F[..., :, 0], F[..., :, 1], axis=-1)
    return jnp.stack([c0, c1, c2], axis=-1)


def polar_newton3x3(F, iters: int = 4, eps: float = 1e-6):
    """Orthogonal polar factor by determinant-scaled Newton iteration,
    batched & branch-free: ``X <- (g X + (1/g) X^-T) / 2``,
    ``g = |det X|^(-1/3)`` (Higham scaling).

    Quadratic convergence for the MPM regime (F near a rotation): 4
    iterations reach 6e-7 relative agreement with the SVD polar factor
    at 15% strain, at a fraction of the cost of ``svd3x3`` (chosen before
    the move to the GPU; not re-measured on the H100).  ``det`` is
    clamped away from 0 so degenerate F stays finite.

    Inversion caveat: for ``det F < 0`` this converges to the *improper*
    orthogonal factor (det = -1), not the Irving-convention proper
    rotation (flip on the smallest singular direction) that
    ``polar_decomposition`` returns — callers needing inversion-robust
    corotated response must use the SVD path (QRSVD.hpp lineage).
    """
    X = F
    for _ in range(iters):
        cof = _cof3(X)
        det = jnp.sum(X[..., :, 0] * cof[..., :, 0], -1)
        det = jnp.where(jnp.abs(det) < eps,
                        jnp.where(det < 0, -eps, eps), det)
        inv_t = cof / det[..., None, None]
        g = jnp.abs(det) ** (-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X + inv_t / g[..., None, None])
    return X


def qr3x3(A):
    """3x3 QR via Gram-Schmidt (reference Givens-based QR, Givens.hpp)."""
    eps = jnp.asarray(1e-12, A.dtype)
    a0 = A[..., :, 0]
    q0 = a0 / jnp.maximum(jnp.linalg.norm(a0, axis=-1, keepdims=True), eps)
    a1 = A[..., :, 1]
    a1p = a1 - jnp.sum(a1 * q0, -1, keepdims=True) * q0
    q1 = a1p / jnp.maximum(jnp.linalg.norm(a1p, axis=-1, keepdims=True), eps)
    q2 = jnp.cross(q0, q1)
    Q = jnp.stack([q0, q1, q2], axis=-1)
    R = mm(jnp.swapaxes(Q, -1, -2), A)
    return Q, R
