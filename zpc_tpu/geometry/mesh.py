"""Simplicial meshes (reference ``geometry/Mesh.hpp`` ``Mesh<T,dim,Tn,codim>``
node/element arrays; surface extraction + normals in ``Mesh.cpp``; remesh
``spray_points`` in ``geometry/remesh/Retile.hpp``).

Build: a mesh is a pytree of (vertices, elements); surface ops are
vectorized; the boundary-face extraction uses the sort-based face-matching
idiom (faces appearing once are boundary) instead of hash sets.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TriMesh", "TetMesh", "tri_normals", "vertex_normals",
           "tet_surface", "mesh_aabbs", "spray_points", "tet_volumes"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriMesh:
    vertices: jax.Array   # [nv, 3]
    faces: jax.Array      # [nf, 3] int32

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_faces(self):
        return self.faces.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TetMesh:
    vertices: jax.Array   # [nv, 3]
    elements: jax.Array   # [ne, 4] int32


def tri_normals(mesh: TriMesh, normalize: bool = True) -> jax.Array:
    v = mesh.vertices
    f = mesh.faces
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = jnp.cross(b - a, c - a)
    if normalize:
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True),
                            1e-12)
    return n


def vertex_normals(mesh: TriMesh) -> jax.Array:
    """Area-weighted vertex normals (Mesh.cpp surface normal compute)."""
    fn = tri_normals(mesh, normalize=False)   # area-weighted
    nv = mesh.num_vertices
    acc = jnp.zeros((nv, 3), fn.dtype)
    for k in range(3):
        acc = acc.at[mesh.faces[:, k]].add(fn)
    return acc / jnp.maximum(jnp.linalg.norm(acc, axis=-1, keepdims=True),
                             1e-12)


def tet_volumes(mesh: TetMesh) -> jax.Array:
    v = mesh.vertices
    e = mesh.elements
    a, b, c, d = (v[e[:, i]] for i in range(4))
    return jnp.einsum("ni,ni->n", jnp.cross(b - a, c - a), d - a) / 6.0


def tet_surface(mesh: TetMesh) -> TriMesh:
    """Boundary triangles of a tet mesh: faces referenced exactly once
    (sort-match replaces the reference's hash-based face sets).  Host-side
    (numpy) — meshes are host assets."""
    e = np.asarray(mesh.elements)
    # local faces with outward orientation for positive tets
    local = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)]
    faces = np.concatenate([e[:, f] for f in local])
    key = np.sort(faces, axis=1)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    ks = key[order]
    fs = faces[order]
    same_prev = np.concatenate([[False],
                                (ks[1:] == ks[:-1]).all(1)])
    same_next = np.concatenate([(ks[1:] == ks[:-1]).all(1), [False]])
    boundary = fs[~(same_prev | same_next)]
    return TriMesh(mesh.vertices, jnp.asarray(boundary, jnp.int32))


def mesh_aabbs(mesh: TriMesh, pad: float = 0.0):
    """Per-face AABBs (LBvh build input for mesh collision)."""
    v = mesh.vertices
    f = mesh.faces
    pts = jnp.stack([v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]], 1)
    return pts.min(1) - pad, pts.max(1) + pad


def spray_points(mesh: TriMesh, density: float, seed: int = 0) -> jax.Array:
    """Area-proportional surface point sampling (remesh/Retile.hpp
    ``spray_points``)."""
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    rng = np.random.default_rng(seed)
    counts = rng.poisson(np.maximum(area * density, 0.0))
    total = int(counts.sum())
    if total == 0:
        return jnp.zeros((0, 3), jnp.float32)
    fidx = np.repeat(np.arange(len(f)), counts)
    r1 = np.sqrt(rng.uniform(size=total))
    r2 = rng.uniform(size=total)
    w0 = 1 - r1
    w1 = r1 * (1 - r2)
    w2 = r1 * r2
    pts = (w0[:, None] * a[fidx] + w1[:, None] * b[fidx] +
           w2[:, None] * c[fidx])
    return jnp.asarray(pts, jnp.float32)
