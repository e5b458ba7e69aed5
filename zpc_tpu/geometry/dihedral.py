"""Dihedral-angle kernels for hinge bending (cloth / codim-IPC).

Parity surface for ``math/DihedralAngle.hpp:1-180`` (bow/codim-ipc
lineage): signed dihedral angle of the hinge

::

            v1 --- v3
           /  \\    /
          /    \\  /
         v2 --- v0

(triangles (v2, v0, v1) and (v0, v1, v3) sharing edge v0-v1), its
12-gradient and 12x12 Hessian, plus the discrete hinge bending energy
consuming them.

Re-design: the reference hand-expands the gradient (rusmas forms,
DihedralAngle.hpp:38-70) and the Hessian (Disney "Discrete Bending
Forces and Their Jacobians", :82-180).  Here the angle is computed in
an ``atan2`` form — smooth where the reference's ``acos`` + sign-flip
is non-differentiable (flat hinge: ``acos'(1)`` is infinite) — and the
derivatives come from autodiff through it, batched over hinges, in the
same style as :mod:`zpc_tpu.geometry.contact`.  Vertex ordering in the
12-vectors is ``(v2, v0, v1, v3)``, matching the reference's gradient
row layout (DihedralAngle.hpp:62-68).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "dihedral_angle", "dihedral_angle_gradient", "dihedral_angle_hessian",
    "hinge_bending_energy", "hinge_bending_gradient",
    "hinge_bending_hessian",
]


def _angle_x12(x12):
    v2, v0, v1, v3 = (x12[..., 0:3], x12[..., 3:6],
                      x12[..., 6:9], x12[..., 9:12])
    n1 = jnp.cross(v0 - v2, v1 - v2)
    n2 = jnp.cross(v1 - v3, v0 - v3)
    e = v0 - v1
    # |n1 x n2| = |n1||n2| sin(theta) and n2 x n1 is parallel to the
    # shared edge, so the projection keeps the reference's sign test
    # (DihedralAngle.hpp:26: flip where (n2 x n1).(v0 - v1) < 0)
    sin_s = jnp.sum(jnp.cross(n2, n1) * e, axis=-1) / \
        jnp.maximum(jnp.linalg.norm(e, axis=-1), 1e-30)
    cos_s = jnp.sum(n1 * n2, axis=-1)
    return jnp.arctan2(sin_s, cos_s)


def _stack(v2, v0, v1, v3):
    return jnp.concatenate([v2, v0, v1, v3], axis=-1)


def dihedral_angle(v2, v0, v1, v3, branch: int = 0):
    """Signed hinge angle in (-pi, pi); ``branch`` +1/-1 shifts to
    (0, 2pi) / (-2pi, 0) (DihedralAngle.hpp:13-15)."""
    theta = _angle_x12(_stack(v2, v0, v1, v3))
    if branch > 0:
        theta = jnp.where(theta < 0, theta + 2 * jnp.pi, theta)
    elif branch < 0:
        theta = jnp.where(theta > 0, theta - 2 * jnp.pi, theta)
    return theta


def _batched_grad(f, x12):
    g = jax.grad(f)
    for _ in range(x12.ndim - 1):
        g = jax.vmap(g)
    return g(x12)


def _batched_hess(f, x12):
    h = jax.hessian(f)
    for _ in range(x12.ndim - 1):
        h = jax.vmap(h)
    return h(x12)


def dihedral_angle_gradient(v2, v0, v1, v3) -> jax.Array:
    """d theta / d(v2, v0, v1, v3) as ``[..., 12]``
    (DihedralAngle.hpp:38-70)."""
    return _batched_grad(_angle_x12, _stack(v2, v0, v1, v3))


def dihedral_angle_hessian(v2, v0, v1, v3) -> jax.Array:
    """``[..., 12, 12]`` hinge Hessian (DihedralAngle.hpp:82-180)."""
    return _batched_hess(_angle_x12, _stack(v2, v0, v1, v3))


def hinge_bending_energy(v2, v0, v1, v3, rest_angle, stiffness):
    """Discrete hinge bending ``k (theta - theta_rest)^2`` (the empty
    upstream Bending.hpp's codim-IPC consumer form; scale ``stiffness``
    by ``|e|/h_e`` externally for the mesh-aware variant)."""
    theta = dihedral_angle(v2, v0, v1, v3)
    d = theta - rest_angle
    return stiffness * d * d


def hinge_bending_gradient(v2, v0, v1, v3, rest_angle, stiffness):
    """``[..., 12]`` energy gradient: ``2k (theta - rest) dtheta``."""
    theta = dihedral_angle(v2, v0, v1, v3)
    g = dihedral_angle_gradient(v2, v0, v1, v3)
    return (2.0 * stiffness * (theta - rest_angle))[..., None] * g


def hinge_bending_hessian(v2, v0, v1, v3, rest_angle, stiffness):
    """``[..., 12, 12]`` Gauss-Newton-exact energy Hessian
    ``2k (g g^T + (theta - rest) H)``."""
    theta = dihedral_angle(v2, v0, v1, v3)
    g = dihedral_angle_gradient(v2, v0, v1, v3)
    H = dihedral_angle_hessian(v2, v0, v1, v3)
    outer = g[..., :, None] * g[..., None, :]
    sb = jnp.asarray(stiffness)[..., None, None] if jnp.ndim(
        stiffness) else stiffness
    return 2.0 * sb * (outer + (theta - rest_angle)[..., None, None] * H)
