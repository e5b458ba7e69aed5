"""Analytic level sets + the level-set interface.

Reference: CRTP ``LevelSetInterface::getSignedDistance/getNormal/
getMaterialVelocity`` (geometry/LevelSetInterface.h:6-21) and
``AnalyticLevelSet`` Plane/Cuboid/Sphere/Cylinder/Torus
(geometry/AnalyticLevelSet.h:7-173).

Re-design: a level set is a frozen pytree dataclass with vectorized
``sdf(x)`` / ``normal(x)`` / ``velocity(x)`` over ``[..., dim]`` point
batches — one fused evaluation for a whole grid of query points, instead
of the reference's per-thread scalar calls.  Normals are computed
analytically where cheap, else by forward-mode autodiff (``jax.grad`` on the
sdf) — in place of hand-derived gradient code.

Composite/transformed level sets mirror the reference's ``LevelSet.h``
composition utilities.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "LevelSet", "HalfSpace", "Sphere", "Cuboid", "Cylinder", "Torus",
    "TransformedLevelSet", "UnionLevelSet", "IntersectionLevelSet",
    "ComplementLevelSet",
]


class LevelSet:
    """Interface: subclasses implement ``sdf``; ``normal``/``velocity`` have
    autodiff/zero defaults (LevelSetInterface.h contract)."""

    def sdf(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def normal(self, x: jax.Array) -> jax.Array:
        g = jax.grad(lambda p: jnp.sum(self.sdf(p[None]))[()])
        n = jax.vmap(g)(x.reshape(-1, x.shape[-1])).reshape(x.shape)
        return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True),
                               1e-12)

    def velocity(self, x: jax.Array) -> jax.Array:
        return jnp.zeros_like(x)

    def inside(self, x: jax.Array) -> jax.Array:
        return self.sdf(x) < 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HalfSpace(LevelSet):
    """Plane with outward normal; sdf > 0 outside (AnalyticLevelSet Plane)."""

    origin: jax.Array
    direction: jax.Array  # outward unit normal

    def sdf(self, x):
        return jnp.sum((x - self.origin) * self.direction, -1)

    def normal(self, x):
        return jnp.broadcast_to(self.direction, x.shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Sphere(LevelSet):
    center: jax.Array
    radius: jax.Array

    def sdf(self, x):
        return jnp.linalg.norm(x - self.center, axis=-1) - self.radius

    def normal(self, x):
        d = x - self.center
        return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True),
                               1e-12)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cuboid(LevelSet):
    """Axis-aligned box via min/max corners (AnalyticLevelSet Cuboid);
    exact exterior distance, interior = -min face distance."""

    minimum: jax.Array
    maximum: jax.Array

    def sdf(self, x):
        center = 0.5 * (self.minimum + self.maximum)
        half = 0.5 * (self.maximum - self.minimum)
        q = jnp.abs(x - center) - half
        outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
        inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return outside + inside

    def normal(self, x):
        """Analytic normal (autodiff fallback is ~10x slower per grid-node
        batch): outside, the clamped-offset direction; inside, the axis of
        the nearest face."""
        center = 0.5 * (self.minimum + self.maximum)
        half = 0.5 * (self.maximum - self.minimum)
        rel = x - center
        q = jnp.abs(rel) - half
        sgn = jnp.where(rel >= 0, 1.0, -1.0)
        out_dir = jnp.maximum(q, 0.0) * sgn
        out_n = out_dir / jnp.maximum(
            jnp.linalg.norm(out_dir, axis=-1, keepdims=True), 1e-12)
        # inside: one-hot of the largest q component
        amax = jnp.max(q, axis=-1, keepdims=True)
        onehot = (q == amax).astype(x.dtype)
        onehot = onehot / jnp.maximum(
            jnp.sum(onehot, -1, keepdims=True), 1.0)
        in_n = onehot * sgn
        inside = (jnp.max(q, axis=-1) <= 0.0)[..., None]
        return jnp.where(inside, in_n, out_n)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cylinder(LevelSet):
    """Capped cylinder along axis ``orient`` (AnalyticLevelSet Cylinder)."""

    bottom: jax.Array   # center of bottom cap
    radius: jax.Array
    length: jax.Array
    orient: int = dataclasses.field(metadata=dict(static=True), default=1)

    def sdf(self, x):
        d = x - self.bottom
        axial = d[..., self.orient]
        radial_sq = jnp.sum(d * d, -1) - axial * axial
        radial = jnp.sqrt(jnp.maximum(radial_sq, 0.0))
        qr = radial - self.radius
        qa = jnp.maximum(-axial, axial - self.length)
        outside = jnp.sqrt(jnp.maximum(qr, 0.0) ** 2 +
                           jnp.maximum(qa, 0.0) ** 2)
        inside = jnp.minimum(jnp.maximum(qr, qa), 0.0)
        return outside + inside


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Torus(LevelSet):
    """Torus in the plane normal to axis ``orient``."""

    center: jax.Array
    major_radius: jax.Array
    minor_radius: jax.Array
    orient: int = dataclasses.field(metadata=dict(static=True), default=1)

    def sdf(self, x):
        d = x - self.center
        axial = d[..., self.orient]
        radial_sq = jnp.sum(d * d, -1) - axial * axial
        radial = jnp.sqrt(jnp.maximum(radial_sq, 0.0))
        q = jnp.sqrt((radial - self.major_radius) ** 2 + axial * axial)
        return q - self.minor_radius


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransformedLevelSet(LevelSet):
    """Rigid-motion wrapper: evaluates the base set in local frame and adds
    rigid-body velocity v + omega x r (the reference Collider's trans/rot
    motion, geometry/Collider.h)."""

    base: LevelSet
    rotation: jax.Array          # [3,3] local->world
    translation_v: jax.Array     # [3]
    linear_velocity: jax.Array   # [3]
    angular_velocity: jax.Array  # [3]

    def _to_local(self, x):
        return (x - self.translation_v) @ self.rotation  # R^T applied

    def sdf(self, x):
        return self.base.sdf(self._to_local(x))

    def normal(self, x):
        n = self.base.normal(self._to_local(x))
        return n @ self.rotation.T

    def velocity(self, x):
        r = x - self.translation_v
        return self.linear_velocity + jnp.cross(
            jnp.broadcast_to(self.angular_velocity, r.shape), r)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class UnionLevelSet(LevelSet):
    sets: Tuple[LevelSet, ...]

    def sdf(self, x):
        ds = jnp.stack([s.sdf(x) for s in self.sets], 0)
        return jnp.min(ds, 0)

    def velocity(self, x):
        ds = jnp.stack([s.sdf(x) for s in self.sets], 0)
        vs = jnp.stack([s.velocity(x) for s in self.sets], 0)
        which = jnp.argmin(ds, 0)
        return jnp.take_along_axis(vs, which[None, ..., None], 0)[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IntersectionLevelSet(LevelSet):
    sets: Tuple[LevelSet, ...]

    def sdf(self, x):
        return jnp.max(jnp.stack([s.sdf(x) for s in self.sets], 0), 0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ComplementLevelSet(LevelSet):
    base: LevelSet

    def sdf(self, x):
        return -self.base.sdf(x)

    def normal(self, x):
        return -self.base.normal(x)

    def velocity(self, x):
        return self.base.velocity(x)
