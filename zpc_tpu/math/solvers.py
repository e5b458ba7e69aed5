"""Matrix-free iterative solvers (CG / CR / MinRes).

Reference: ``math/linear/ConjugateGradient.hpp`` (operator contract
``A.multiply(pol, in, out)``, ``A.project(pol, v)`` boundary projection,
``A.precondition(pol, r, q)``; solve loop ``:73-164``),
``ConjugateResidual.hpp``, ``MinimumResidual.hpp``, and the dof-view helpers
``LinearOperators.hpp:14-41``.

Re-design: the operator contract becomes plain callables over pytrees —
any pytree of arrays is a valid "dof view", so the same solver runs the
128^3 Poisson bench and the implicit-MPM grid unknowns (``[nb,4,4,4,3]``)
unchanged.  The solve loop is a ``lax.while_loop`` (single compiled program;
no host round-trip per iteration, unlike the reference's per-iteration
kernel launches + 1-element DtoH dot-product copies at
ConjugateGradient.hpp:61-70 — here the whole solve is one XLA program).

All dot products are pytree-wide fp32 reductions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["SolveResult", "cg", "conjugate_residual", "minres", "dot", "axpy"]


def dot(a, b):
    """Pytree-wide inner product (DofCompwiseOp + reduce analog)."""
    leaves = jax.tree.leaves(jax.tree.map(
        lambda x, y: jnp.sum(x.astype(jnp.float32) * y.astype(jnp.float32)),
        a, b))
    return sum(leaves[1:], leaves[0]) if len(leaves) > 1 else leaves[0]


def axpy(alpha, x, y):
    """y + alpha*x over pytrees (DofCompwiseOp analog)."""
    return jax.tree.map(lambda xi, yi: yi + alpha * xi, x, y)


class SolveResult(NamedTuple):
    x: object          # solution pytree
    iters: jax.Array   # iterations taken
    residual: jax.Array  # final |r|^2 (preconditioned norm for cg)
    converged: jax.Array


def _identity(v):
    return v


def cg(A: Callable, b, x0=None, *, project: Optional[Callable] = None,
       precondition: Optional[Callable] = None, max_iters: int = 100,
       rel_tol: float = 1e-4, abs_tol: float = 0.0) -> SolveResult:
    """Preconditioned conjugate gradient (ConjugateGradient.hpp:73-164).

    ``A``: x -> A x (matrix-free multiply); ``project``: zero out Dirichlet
    dofs (reference ``A.project``); ``precondition``: r -> M^-1 r.
    Stops when r.z <= max(rel_tol^2 * r0.z0, abs_tol).
    """
    project = project or _identity
    precondition = precondition or _identity
    x = jax.tree.map(jnp.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))          # r = P(b - A x)
    z = project(precondition(r))
    p = z
    zTr = dot(z, r)
    threshold = jnp.maximum(rel_tol * rel_tol * zTr, abs_tol)

    def cond(state):
        _, _, _, zTr, it, _ = state
        return (zTr > threshold) & (it < max_iters)

    def body(state):
        x, r, p, zTr, it, _ = state
        Ap = project(A(p))
        pAp = dot(p, Ap)
        alpha = zTr / jnp.where(pAp == 0, 1.0, pAp)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = project(precondition(r))
        zTr_new = dot(z, r)
        beta = zTr_new / jnp.where(zTr == 0, 1.0, zTr)
        p = axpy(beta, p, z)
        return x, r, p, zTr_new, it + 1, zTr_new <= threshold

    x, r, p, zTr, iters, conv = jax.lax.while_loop(
        cond, body, (x, r, p, zTr, jnp.int32(0), zTr <= threshold))
    return SolveResult(x, iters, zTr, zTr <= threshold)


def conjugate_residual(A: Callable, b, x0=None, *,
                       project: Optional[Callable] = None,
                       max_iters: int = 100, rel_tol: float = 1e-4
                       ) -> SolveResult:
    """Conjugate residual method (math/linear/ConjugateResidual.hpp) —
    for symmetric (possibly indefinite) systems; minimizes |r|."""
    project = project or _identity
    x = jax.tree.map(jnp.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))
    p = r
    Ar = project(A(r))
    Ap = Ar
    rAr = dot(r, Ar)
    r0 = dot(r, r)
    threshold = rel_tol * rel_tol * r0

    def cond(state):
        _, r, *_ , it = state
        return (dot(r, r) > threshold) & (it < max_iters)

    def body(state):
        x, r, p, Ap, rAr, it = state
        ApAp = dot(Ap, Ap)
        alpha = rAr / jnp.where(ApAp == 0, 1.0, ApAp)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        Ar = project(A(r))
        rAr_new = dot(r, Ar)
        beta = rAr_new / jnp.where(rAr == 0, 1.0, rAr)
        p = axpy(beta, p, r)
        Ap = axpy(beta, Ap, Ar)
        return x, r, p, Ap, rAr_new, it + 1

    x, r, p, Ap, rAr, iters = jax.lax.while_loop(
        cond, body, (x, r, p, Ap, rAr, jnp.int32(0)))
    rr = dot(r, r)
    return SolveResult(x, iters, rr, rr <= threshold)


def minres(A: Callable, b, x0=None, *, project: Optional[Callable] = None,
           max_iters: int = 100, rel_tol: float = 1e-4) -> SolveResult:
    """Minimum residual method (math/linear/MinimumResidual.hpp) via the
    Lanczos recurrence with Givens rotations — symmetric indefinite systems."""
    project = project or _identity
    x = jax.tree.map(jnp.zeros_like, b) if x0 is None else x0
    r = project(axpy(-1.0, A(x), b))
    beta0 = jnp.sqrt(jnp.maximum(dot(r, r), 0.0))
    threshold = rel_tol * beta0

    zeros = jax.tree.map(jnp.zeros_like, b)
    safe = lambda d: jnp.where(d == 0, 1.0, d)
    v_prev, v = zeros, jax.tree.map(lambda t: t / safe(beta0), r)
    d_prev, d_pprev = zeros, zeros
    state0 = (x, v_prev, v, d_prev, d_pprev,
              beta0,                       # beta_k
              jnp.float32(1.0), jnp.float32(0.0),  # c, s prev rotation
              jnp.float32(1.0), jnp.float32(0.0),  # c2, s2 rotation before
              beta0,                       # eta (rhs component)
              jnp.int32(0))

    def cond(st):
        eta, it = st[10], st[11]
        return (jnp.abs(eta) > threshold) & (it < max_iters)

    def body(st):
        (x, v_prev, v, d_prev, d_pprev, beta, c, s, c2, s2, eta, it) = st
        Av = project(A(v))
        alpha = dot(v, Av)
        w = axpy(-alpha, v, axpy(-beta, v_prev, Av))
        beta_new = jnp.sqrt(jnp.maximum(dot(w, w), 0.0))
        v_new = jax.tree.map(lambda t: t / safe(beta_new), w)
        # apply previous two Givens rotations to the new column
        delta = c * alpha - c2 * s * beta
        rho2 = s * alpha + c2 * c * beta
        rho3 = s2 * beta
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        c_new = delta / safe(rho1)
        s_new = beta_new / safe(rho1)
        dvec = jax.tree.map(
            lambda vv, dp, dpp: (vv - rho2 * dp - rho3 * dpp) / safe(rho1),
            v, d_prev, d_pprev)
        x = axpy(c_new * eta, dvec, x)
        eta = -s_new * eta
        return (x, v, v_new, dvec, d_prev, beta_new,
                c_new, s_new, c, s, eta, it + 1)

    out = jax.lax.while_loop(cond, body, state0)
    x, eta, iters = out[0], out[10], out[11]
    return SolveResult(x, iters, eta * eta, jnp.abs(eta) <= threshold)
