"""Plasticity models: return-mapping projections on principal stretches.

Reference: CRTP ``PlasticityModelInterface`` (physics/ConstitutiveModel.hpp:618)
with ``project_sigma`` / ``project_strain``; models
``physics/plasticity_models/{SnowPlasticity, VonMisesCapped,
NonAssociativeDruckerPrager}`` plus the NACC stress kernel
(ConstitutiveModel_Vol_dP.hpp ``compute_stress_nacc``).

Re-design: each model is a pure batched function
``F_projected, state' = project(F_trial, state)`` working on the SVD of the
trial deformation gradient — branch-free ``where`` selects replace the
reference's per-thread control flow.  State (e.g. ``logJp`` for hardening)
rides as an extra particle channel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..math.svd import svd3x3
from ..math.vecmat import mm

__all__ = ["SnowPlasticity", "VonMisesCapped", "DruckerPrager", "NACC",
           "NonAssociativeVonMises", "AssociativeVonMises"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SnowPlasticity:
    """Stomakhin snow: clamp principal stretches to
    [1-theta_c, 1+theta_s], harden by exp(xi (1 - Jp))
    (plasticity_models/SnowPlasticity.hpp behavior)."""

    theta_c: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(2.5e-2))
    theta_s: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(7.5e-3))
    xi: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(10.0))
    jp_min: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.1))
    jp_max: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(10.0))

    def project(self, F_trial, Jp):
        U, s, V = svd3x3(F_trial)
        s_clamped = jnp.clip(s, 1.0 - self.theta_c, 1.0 + self.theta_s)
        F_new = mm(U, s_clamped[..., :, None] * jnp.swapaxes(V, -1, -2))
        # volume moved into plastic part
        Jp_new = jnp.clip(Jp * jnp.prod(s, -1) / jnp.prod(s_clamped, -1),
                          self.jp_min, self.jp_max)
        return F_new, Jp_new

    def hardening(self, Jp):
        """Multiplier on (mu, lam) (Stomakhin hardening)."""
        return jnp.exp(self.xi * (1.0 - Jp))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VonMisesCapped:
    """Von Mises yield on the Hencky strain deviator with volumetric
    trace caps and optional Cowper-Symonds rate hardening
    (plasticity_models/VonMisesCapped.hpp:17-52,90-99 behavior:
    ``Z(G) = k1 |tr G| + k2 |dev G|``).

    ``k1_compress`` / ``k1_stretch`` cap ``tr(eps)`` at
    ``±k1 / (d lam + 2 mu)`` by a uniform rescale of the stretches
    (inf = uncapped, the pre-round-3 behavior).  ``project(...,
    strain_rate=r)`` scales the yield stress by ``1 + (r/c)^p``.
    """

    yield_stress: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1e4))
    mu: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1e5))
    lam: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))
    k1_compress: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(jnp.inf))
    k1_stretch: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(jnp.inf))
    rate_c: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1.0))
    rate_p: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1.0))

    def project(self, F_trial, state=None, strain_rate=None):
        d = F_trial.shape[-1]
        U, s, V = svd3x3(F_trial)
        eps = jnp.log(jnp.maximum(jnp.abs(s), 1e-12))
        tr = jnp.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = jnp.linalg.norm(dev, axis=-1)
        ys = self.yield_stress
        if strain_rate is not None:
            # Cowper-Symonds (VonMisesCapped.hpp:90-93)
            ys = ys * (1.0 + (strain_rate / self.rate_c) ** self.rate_p)
        # yield: 2 mu |dev| <= sqrt(2/3) sigma_y
        limit = jnp.sqrt(2.0 / 3.0) * ys / (2.0 * self.mu)
        scale = jnp.where(dev_norm > limit,
                          limit / jnp.maximum(dev_norm, 1e-12), 1.0)
        eps_new = (tr / d)[..., None] + dev * scale[..., None]
        # volumetric caps: project tr(eps) back to +-k1/(d lam + 2 mu)
        # by a uniform stretch rescale (VonMisesCapped.hpp:47-51)
        denom = d * self.lam + 2.0 * self.mu
        cap_hi = self.k1_stretch / denom
        cap_lo = -self.k1_compress / denom
        shift = jnp.where(tr > cap_hi, (cap_hi - tr) / d,
                          jnp.where(tr < cap_lo, (cap_lo - tr) / d, 0.0))
        eps_new = eps_new + shift[..., None]
        s_new = jnp.exp(eps_new)
        F_new = mm(U, s_new[..., :, None] * jnp.swapaxes(V, -1, -2))
        return F_new, state


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DruckerPrager:
    """Non-associative Drucker-Prager sand
    (plasticity_models/NonAssociativeDruckerPrager.hpp behavior):
    project Hencky strain onto the cone, no volume gain on expansion."""

    mu: jax.Array
    lam: jax.Array
    friction_angle: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(30.0))  # degrees
    cohesion: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    @property
    def alpha(self):
        phi = self.friction_angle * (jnp.pi / 180.0)
        s = jnp.sin(phi)
        return jnp.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)

    def project(self, F_trial, logJp):
        d = F_trial.shape[-1]
        U, s, V = svd3x3(F_trial)
        eps = jnp.log(jnp.maximum(jnp.abs(s), 1e-12)) + \
            (logJp / d)[..., None]   # restore stored plastic volume
        tr = jnp.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = jnp.linalg.norm(dev, axis=-1)
        # expansion: project to tip (all strain plastic)
        expanding = tr > 0.0
        # yield function on the cone
        dg = dev_norm + self.alpha * (d * self.lam + 2.0 * self.mu) / \
            (2.0 * self.mu) * tr - self.cohesion
        yielding = dg > 0.0
        scale = jnp.where(
            yielding & ~expanding,
            1.0 - dg / jnp.maximum(dev_norm, 1e-12), 1.0)
        scale = jnp.maximum(scale, 0.0)
        eps_new = jnp.where(expanding[..., None],
                            jnp.zeros_like(eps),
                            dev * scale[..., None] + (tr / d)[..., None] *
                            jnp.where(yielding, 1.0, 1.0)[..., None])
        # on shear yield keep volumetric part; on tip projection drop all
        eps_new = jnp.where((yielding & ~expanding)[..., None],
                            dev * scale[..., None] + (tr / d)[..., None],
                            eps_new)
        eps_new = jnp.where((~yielding & ~expanding)[..., None], eps, eps_new)
        dlogJp = jnp.sum(eps, -1) - jnp.sum(eps_new, -1)
        s_new = jnp.exp(eps_new)
        F_new = mm(U, s_new[..., :, None] * jnp.swapaxes(V, -1, -2))
        return F_new, logJp + dlogJp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NACC:
    """Non-Associated Cam-Clay (the ``compute_stress_nacc`` kernel family,
    ConstitutiveModel_Vol_dP.hpp): elliptic yield surface in (p, q) with
    hardening driven by logJp."""

    mu: jax.Array
    lam: jax.Array
    beta: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.5))
    M: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1.85))
    xi: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.8))
    hardening_on: bool = dataclasses.field(metadata=dict(static=True),
                                           default=True)

    def project(self, F_trial, logJp):
        d = F_trial.shape[-1]
        U, s, V = svd3x3(F_trial)
        eps = jnp.log(jnp.maximum(jnp.abs(s), 1e-12))
        tr = jnp.sum(eps, -1)
        dev = eps - (tr / d)[..., None]
        dev_norm = jnp.linalg.norm(dev, axis=-1)
        kappa = self.lam + 2.0 * self.mu / d   # bulk-ish modulus
        p0 = kappa * (1e-5 + jnp.sinh(self.xi * jnp.maximum(-logJp, 0.0)))
        p = -kappa * tr                         # pressure (compression +)
        q = jnp.sqrt(2.0) * self.mu * dev_norm  # shear measure
        # ellipse: y = (1+2beta) q^2 + M^2 (p + beta p0)(p - p0)
        y = (1.0 + 2.0 * self.beta) * q * q + \
            self.M * self.M * (p + self.beta * p0) * (p - p0)
        # case 1: p > p0 (compression cap) -> project to cap tip
        case_cap = p > p0
        # case 2: p < -beta p0 (tension tip)
        case_tip = p < -self.beta * p0
        # case 3: outside ellipse -> scale dev to the ellipse
        q_max = self.M * jnp.sqrt(jnp.maximum(
            -(p + self.beta * p0) * (p - p0), 0.0) /
            (1.0 + 2.0 * self.beta))
        scale = jnp.where((y > 0.0) & ~case_cap & ~case_tip,
                          q_max / jnp.maximum(q, 1e-12), 1.0)
        eps_new = dev * scale[..., None] + (tr / d)[..., None]
        eps_cap = jnp.broadcast_to((-p0 / kappa / d)[..., None], eps.shape)
        eps_tip = jnp.broadcast_to(
            ((self.beta * p0) / kappa / d)[..., None], eps.shape)
        eps_new = jnp.where(case_cap[..., None], eps_cap, eps_new)
        eps_new = jnp.where(case_tip[..., None], eps_tip, eps_new)
        dlogJp = jnp.where(case_cap | case_tip,
                           tr - jnp.sum(eps_new, -1), 0.0)
        logJp_new = logJp + (dlogJp if self.hardening_on else 0.0)
        s_new = jnp.exp(eps_new)
        F_new = mm(U, s_new[..., :, None] * jnp.swapaxes(V, -1, -2))
        return F_new, logJp_new


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NonAssociativeVonMises:
    """Ziran-style von Mises return map on the trial left Cauchy-Green
    tensor (plasticity_models/NonAssociativeVonMises.hpp:1-61 behavior):
    yield on the deviator of ``s_hat = mu J^{-2/d} dev(b_hat_trial)``
    with linear hardening ``tauY + hardening_coeff * alpha``, projected
    by shifting ``b_hat`` along the deviator (volume-preserving in
    stress, non-associative in strain).
    """

    tau_y: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1e4))
    mu: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1e5))
    alpha: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))
    hardening_coeff: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    def project(self, F_trial, state=None):
        d = F_trial.shape[-1]
        U, s, V = svd3x3(F_trial)
        s = jnp.maximum(jnp.abs(s), 1e-12)
        scaled_tau = jnp.sqrt(2.0 / (6.0 - d)) * \
            (self.tau_y + self.hardening_coeff * self.alpha)
        b_hat = s * s
        J = jnp.prod(s, axis=-1)
        scaled_mu = self.mu * J ** (-2.0 / d)
        dev_b = b_hat - jnp.mean(b_hat, -1, keepdims=True)
        s_hat = scaled_mu[..., None] * dev_b
        s_norm = jnp.linalg.norm(s_hat, axis=-1)
        y = s_norm - scaled_tau
        z = y / jnp.maximum(scaled_mu, 1e-30)
        b_new = b_hat - (z / jnp.maximum(s_norm, 1e-30))[..., None] * s_hat
        s_proj = jnp.sqrt(jnp.maximum(b_new, 1e-12))
        s_new = jnp.where((y >= 1e-4)[..., None], s_proj, s)
        F_new = mm(U, s_new[..., :, None] * jnp.swapaxes(V, -1, -2))
        return F_new, state


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AssociativeVonMises:
    """Associative von Mises return map in principal Kirchhoff-stress
    space (plasticity_models/AssociativeVonMises.hpp:1-129; "An adaptive
    generalized interpolation MPM", sec 4.2.2).

    The reference header ships a debug-printf Newton whose ``lambda``
    accumulates across iterations; this implementation keeps the model
    (flow direction ``P c / sqrt(2 c.Pc)``, ``P = 3I - 11^T``, principal
    Cauchy stress ``c = dpsi_dsigma * sigma / J`` from the *elastic
    model's* energy via autodiff) but runs a standard damped Newton on
    the scalar residual with an exact jvp directional derivative —
    branch-free, fixed ``iters`` rounds, batched via vmap.
    """

    initial_stress: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(1e4))
    iters: int = dataclasses.field(default=10, metadata=dict(static=True))

    def project(self, F_trial, model, state=None):
        d = F_trial.shape[-1]
        assert d == 3, "AssociativeVonMises: 3-D only"
        P = 3.0 * jnp.eye(3) - jnp.ones((3, 3))

        def residual(sig):
            c = jax.grad(
                lambda x: model.psi(jnp.diag(x)))(sig) * sig / \
                jnp.prod(sig)
            vm = jnp.sqrt(jnp.maximum(0.5 * c @ (P @ c), 1e-30))
            return vm - self.initial_stress, c

        def flow(c):
            return (P @ c) / jnp.sqrt(jnp.maximum(2.0 * c @ (P @ c),
                                                  1e-30))

        def one(f):
            U, sig, V = svd3x3(f)
            sig = jnp.maximum(jnp.abs(sig), 1e-6)
            res0, _ = residual(sig)

            def body(_, sig):
                res, c = residual(sig)
                n = flow(c)
                _, drds = jax.jvp(lambda s: residual(s)[0], (sig,), (n,))
                step = res / jnp.where(jnp.abs(drds) > 1e-30,
                                       drds, 1e-30)
                sig_new = jnp.maximum(sig - step * n, 1e-6)
                # bidirectional: an overshoot into the surface steps
                # back out on the next round
                return jnp.where(jnp.abs(res) >
                                 1e-6 * self.initial_stress,
                                 sig_new, sig)

            sig_p = jax.lax.fori_loop(0, self.iters, body, sig)
            sig_f = jnp.where(res0 > 0.0, sig_p, sig)
            return mm(U, sig_f[:, None] * V.T)

        batch = F_trial.shape[:-2]
        out = jax.vmap(one)(F_trial.reshape((-1, d, d)))
        return out.reshape(batch + (d, d)), state
