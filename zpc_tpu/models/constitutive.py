"""Constitutive models (hyperelasticity + fluids), batched & differentiable.

Reference: ``physics/ConstitutiveModel.hpp`` (CRTP interfaces, principal
-stretch energies ``do_psi_sigma/do_dpsi_dsigma``, invariant-based variants),
``physics/constitutive_models/{NeoHookean,FixedCorotated,StvkWithHencky,
EquationOfState}``, and the fused stress kernels
``ConstitutiveModel_Vol_dP.hpp`` consumed by P2G
(simulation/transfer/P2G.hpp:87-101).

Re-design: every model is a frozen pytree dataclass with **batched**
methods over ``[..., dim, dim]`` deformation gradients:

* ``psi(F)``          — energy density
* ``first_piola(F)``  — P = dpsi/dF (hand-derived, elementwise)
* ``kirchhoff(F)``    — tau = P F^T, the quantity the MPM transfer scatters

Because everything is JAX, ``dP/dF`` for implicit integration comes from
``jax.jvp`` on ``first_piola`` — no hand-derived Hessians needed (the
reference hand-codes them).  Lame parameters from (E, nu) as usual.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..math.svd import svd3x3, svd2x2
from ..math.vecmat import mm, det3, scale_trailing

__all__ = [
    "lame_parameters",
    "bcast_scalar",
    "ElasticModel",
    "NeoHookean",
    "FixedCorotated",
    "StvkWithHencky",
    "EquationOfState",
    "AnisotropicArap",
]


def lame_parameters(E: float, nu: float) -> Tuple[float, float]:
    """(mu, lam) from Young's modulus / Poisson ratio
    (ConstitutiveModel.hpp config structs)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def _svd(F):
    if F.shape[-1] == 2:
        return svd2x2(F)
    return svd3x3(F)


def _det(F):
    return det3(F)


def bcast_scalar(v, ref):
    """Broadcast a scalar-or-per-particle parameter against ``ref``:
    appends singleton dims so [N] params align with [N,3,3] tensors (and
    [B,K] with [B,K,3,3] in the binned layout)."""
    v = jnp.asarray(v)
    extra = ref.ndim - v.ndim
    return v.reshape(v.shape + (1,) * extra) if extra > 0 else v


def _cof(F):
    """Cofactor matrix: J F^-T, valid for singular F too (3x3 closed form)."""
    if F.shape[-1] == 2:
        a, b = F[..., 0, 0], F[..., 0, 1]
        c, d = F[..., 1, 0], F[..., 1, 1]
        return jnp.stack([jnp.stack([d, -c], -1),
                          jnp.stack([-b, a], -1)], -2)
    c0 = jnp.cross(F[..., :, 1], F[..., :, 2], axis=-1)
    c1 = jnp.cross(F[..., :, 2], F[..., :, 0], axis=-1)
    c2 = jnp.cross(F[..., :, 0], F[..., :, 1], axis=-1)
    return jnp.stack([c0, c1, c2], axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ElasticModel:
    """Base: stores Lame parameters; subclasses define psi / first_piola."""

    mu: jax.Array
    lam: jax.Array

    @classmethod
    def from_young_poisson(cls, E: float, nu: float, **kw):
        mu, lam = lame_parameters(E, nu)
        return cls(jnp.float32(mu), jnp.float32(lam), **kw)

    def psi(self, F):
        raise NotImplementedError

    def first_piola(self, F):
        raise NotImplementedError

    def kirchhoff(self, F):
        """tau = P F^T — the stress measure MPM scatters to the grid."""
        return mm(self.first_piola(F), jnp.swapaxes(F, -1, -2))

    def dP_dF_action(self, F, dF):
        """Directional derivative dP(F)[dF] via forward-mode autodiff —
        the matrix-free building block for implicit MPM (the reference
        hand-derives these per model)."""
        _, tangent = jax.jvp(self.first_piola, (F,), (dF,))
        return tangent


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NeoHookean(ElasticModel):
    """psi = mu/2 (tr(F^T F) - d) - mu log J + lam/2 log^2 J
    (constitutive_models/NeoHookean.hpp invariant form)."""

    def psi(self, F):
        d = F.shape[-1]
        J = _det(F)
        logJ = jnp.log(jnp.maximum(J, 1e-12))
        I1 = jnp.sum(F * F, (-2, -1))
        mu = bcast_scalar(self.mu, I1)
        lam = bcast_scalar(self.lam, I1)
        return 0.5 * mu * (I1 - d) - mu * logJ + 0.5 * lam * logJ * logJ

    def first_piola(self, F):
        J = _det(F)
        logJ = jnp.log(jnp.maximum(J, 1e-12))
        cof = _cof(F)
        Finv_T = cof / jnp.maximum(J, 1e-12)[..., None, None]
        mu = bcast_scalar(self.mu, F)
        lam = bcast_scalar(self.lam, F)
        return mu * (F - Finv_T) + lam * logJ[..., None, None] * Finv_T


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FixedCorotated(ElasticModel):
    """psi = mu |F - R|_F^2 + lam/2 (J-1)^2
    (constitutive_models/FixedCorotated.h); P = 2mu(F-R) + lam(J-1) cof(F)."""

    def psi(self, F):
        U, s, V = _svd(F)
        J = jnp.prod(s, -1)
        mu = bcast_scalar(self.mu, J)
        lam = bcast_scalar(self.lam, J)
        return mu * jnp.sum((s - 1.0) ** 2, -1) + 0.5 * lam * (J - 1.0) ** 2

    def first_piola(self, F):
        U, s, V = _svd(F)
        R = mm(U, jnp.swapaxes(V, -1, -2))
        J = jnp.prod(s, -1)
        # scale_trailing, not `[..., None, None] *`: this runs inside the
        # implicit CG loop (via jvp); hoisted trailing-1 broadcasts of the
        # loop-invariant primal are stored 128x lane-padded by XLA
        mu = bcast_scalar(self.mu, J)
        lam = bcast_scalar(self.lam, J)
        return scale_trailing(2.0 * mu * jnp.ones_like(J), F - R) + \
            scale_trailing(lam * (J - 1.0), _cof(F))

    def kirchhoff(self, F):
        """tau = P F^T with R from the Newton polar iteration (3-D).

        The corotated stress needs only R = polar(F), J and cof(F) — no
        singular values — so the explicit hot path skips the Jacobi SVD (chosen
        before the move to the GPU; not re-measured on the H100); 6e-7 relative
        agreement at 15% strain.  For inverted elements (det F < 0, outside the
        explicit stable-dt regime) the Newton factor is the improper orthogonal
        one; the SVD path (``first_piola``, 2-D, implicit linearization) keeps
        the Irving-convention handling.
        """
        if F.shape[-1] != 3:
            return super().kirchhoff(F)
        from ..math.svd import polar_newton3x3
        R = polar_newton3x3(F)
        cof = _cof(F)
        J = jnp.sum(F[..., :, 0] * cof[..., :, 0], -1)
        mu = bcast_scalar(self.mu, J)
        lam = bcast_scalar(self.lam, J)
        P = scale_trailing(2.0 * mu * jnp.ones_like(J), F - R) + \
            scale_trailing(lam * (J - 1.0), cof)
        return mm(P, jnp.swapaxes(F, -1, -2))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StvkWithHencky(ElasticModel):
    """St. Venant-Kirchhoff with Hencky (logarithmic) strain
    (constitutive_models/StvkWithHencky.hpp):
    psi = mu |log s|^2 + lam/2 (sum log s)^2 on principal stretches."""

    def psi(self, F):
        _, s, _ = _svd(F)
        eps = jnp.log(jnp.maximum(jnp.abs(s), 1e-12))
        tr = jnp.sum(eps, -1)
        mu = bcast_scalar(self.mu, tr)
        lam = bcast_scalar(self.lam, tr)
        return mu * jnp.sum(eps * eps, -1) + 0.5 * lam * tr ** 2

    def first_piola(self, F):
        U, s, V = _svd(F)
        s_safe = jnp.maximum(jnp.abs(s), 1e-12) * jnp.where(s < 0, -1.0, 1.0)
        eps = jnp.log(jnp.abs(s_safe))
        mu = bcast_scalar(self.mu, eps[..., 0])[..., None]
        lam = bcast_scalar(self.lam, eps[..., 0])[..., None]
        dpsi_dsigma = (2.0 * mu * eps + lam *
                       jnp.sum(eps, -1, keepdims=True)) / s_safe
        return mm(U, dpsi_dsigma[..., :, None] * jnp.swapaxes(V, -1, -2))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EquationOfState(ElasticModel):
    """Weakly-compressible fluid (constitutive_models/EquationOfState.hpp):
    pressure p = bulk/gamma (J^-gamma - 1); deviatoric-free Cauchy stress.

    Tracks volume ratio through det(F) (or a scalar J channel in the fluid
    pipeline).  ``mu`` is unused; ``lam`` doubles as the bulk modulus.
    """

    gamma: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(7.15))

    @property
    def bulk(self):
        return self.lam

    def pressure(self, J):
        return self.bulk / self.gamma * (jnp.power(jnp.maximum(J, 1e-6),
                                                   -self.gamma) - 1.0)

    def psi(self, F):
        J = _det(F)
        g = self.gamma
        # integral of -p dJ
        return -self.bulk / g * (jnp.power(jnp.maximum(J, 1e-6), 1.0 - g)
                                 / (1.0 - g) - J)

    def kirchhoff_from_J(self, J):
        """tau = -p J I, from the scalar volume ratio (fluid MPM path)."""
        p = self.pressure(J)
        eye = jnp.eye(3, dtype=J.dtype)
        return (-p * J)[..., None, None] * eye

    def first_piola(self, F):
        J = _det(F)
        p = self.pressure(J)
        return (-p)[..., None, None] * _cof(F)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AnisotropicArap(ElasticModel):
    """Corotated ARAP energy + transversely isotropic fiber reinforcement
    (constitutive_models/AnisotropicArap.hpp behavior):
    psi = mu |F - R|^2 + mu_fiber (|F a| - 1)^2 for unit fiber direction a.

    ``fiber`` may be one direction [3] or per-particle [..., 3].
    """

    fiber: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.asarray([1.0, 0.0, 0.0]))
    mu_fiber: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    def _fa(self, F):
        a = self.fiber
        if a.ndim < F.ndim - 1:
            a = jnp.broadcast_to(a, F.shape[:-2] + (3,))
        return jnp.einsum("...ij,...j->...i", F, a), a

    def psi(self, F):
        U, s, V = _svd(F)
        mu = bcast_scalar(self.mu, s[..., 0])
        arap = mu * jnp.sum((s - 1.0) ** 2, -1)
        Fa, _ = self._fa(F)
        ell = jnp.linalg.norm(Fa, axis=-1)
        muf = bcast_scalar(self.mu_fiber, ell)
        return arap + muf * (ell - 1.0) ** 2

    def first_piola(self, F):
        U, s, V = _svd(F)
        R = mm(U, jnp.swapaxes(V, -1, -2))
        mu = bcast_scalar(self.mu, F)
        P = 2.0 * mu * (F - R)
        Fa, a = self._fa(F)
        ell = jnp.maximum(jnp.linalg.norm(Fa, axis=-1, keepdims=True), 1e-12)
        muf = bcast_scalar(self.mu_fiber, F)
        dpsi = 2.0 * muf * (1.0 - 1.0 / ell)[..., None]
        return P + dpsi * Fa[..., :, None] * a[..., None, :]
