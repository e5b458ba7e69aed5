"""Isosurface extraction: marching tetrahedra over dense SDF grids.

Reference capability: surface reconstruction / mesh export goes through
OpenVDB tools (``geometry/VdbLevelSet.h`` conversions + downstream zeno
nodes).  Redesign: marching *tetrahedra* instead of marching cubes —
the 16-entry case table is derived programmatically at import (no
ambiguous cases, no 256x16 baked table), and the whole pass is dense
slicing + tiny-table gathers, which XLA handles well.  Output is a
static-capacity triangle soup with a count + overflow flag (the
framework's standard static-shape contract).

Orientation is fixed at runtime: each triangle is flipped so its normal
points from the inside (sdf < iso) toward the outside, using the
inside/outside corner centroids of the generating tetrahedron.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["TriSoup", "marching_tets", "surface_from_levelset"]

# cube corners, bit order x + 2y + 4z
_CORNERS = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])

# 6-tet decomposition of the cube around the 0-7 diagonal
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])

# tet edges (pairs of local corner ids 0..3)
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _build_case_table():
    """[16, 2, 3] edge ids per case (-1 = unused slot): which of the 6
    tet edges carry the (up to 2) triangles' vertices."""
    def edge_id(a, b):
        for e, (u, v) in enumerate(_EDGES):
            if {a, b} == {u, v}:
                return e
        raise AssertionError

    table = -np.ones((16, 2, 3), np.int32)
    for case in range(1, 15):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if len(inside) == 1:
            a = inside[0]
            table[case, 0] = [edge_id(a, b) for b in outside]
        elif len(inside) == 3:
            a = outside[0]
            table[case, 0] = [edge_id(a, b) for b in inside]
        else:
            a, b = inside
            c, d = outside
            q = [edge_id(a, c), edge_id(a, d), edge_id(b, d), edge_id(b, c)]
            table[case, 0] = [q[0], q[1], q[2]]
            table[case, 1] = [q[0], q[2], q[3]]
    return table


_CASE_TABLE = _build_case_table()


class TriSoup(NamedTuple):
    verts: jax.Array      # [capacity, 3, 3] triangle corners (world)
    count: jax.Array      # scalar int32: valid triangles
    overflow: jax.Array   # bool: capacity exceeded (grow and re-run)


def marching_tets(sdf: jax.Array, dx, *, iso=0.0, origin=None,
                  capacity: int = 65536) -> TriSoup:
    """Extract the iso-surface of a dense [X, Y, Z] SDF as triangles."""
    X, Y, Z = sdf.shape
    if origin is None:
        origin = jnp.zeros((3,), sdf.dtype)
    dx = jnp.asarray(dx, sdf.dtype)
    # per-cube corner values, bit order x + 2y + 4z -> [Ncubes, 8]
    vals = jnp.stack([
        sdf[cx:cx + X - 1, cy:cy + Y - 1, cz:cz + Z - 1]
        for cx, cy, cz in _CORNERS], axis=-1).reshape(-1, 8)
    nC = vals.shape[0]
    cube_idx = jnp.stack(jnp.meshgrid(
        jnp.arange(X - 1), jnp.arange(Y - 1), jnp.arange(Z - 1),
        indexing="ij"), -1).reshape(-1, 3).astype(sdf.dtype)

    corners = jnp.asarray(_CORNERS, sdf.dtype)            # [8, 3]
    table = jnp.asarray(_CASE_TABLE)                       # [16, 2, 3]

    def one_tet(tet):
        tv = vals[:, tet]                                  # [nC, 4]
        tpos = (cube_idx[:, None, :] + corners[tet]) * dx + origin
        inside = (tv < iso).astype(jnp.int32)
        case = (inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
                + 8 * inside[:, 3])
        # 6 edge crossings, linear interpolation (clamped for robustness)
        ea, eb = _EDGES[:, 0], _EDGES[:, 1]
        va, vb = tv[:, ea], tv[:, eb]                      # [nC, 6]
        t = jnp.clip((iso - va) / jnp.where(jnp.abs(vb - va) > 1e-30,
                                            vb - va, 1.0), 0.0, 1.0)
        pa, pb = tpos[:, ea, :], tpos[:, eb, :]
        ep = pa + t[..., None] * (pb - pa)                 # [nC, 6, 3]
        # case-table gather
        tri_e = table[case]                                # [nC, 2, 3]
        valid = tri_e[:, :, 0] >= 0                        # [nC, 2]
        idx = jnp.maximum(tri_e, 0).reshape(nC, 6)
        tri_p = jnp.take_along_axis(ep, idx[..., None], axis=1)
        tri_p = tri_p.reshape(nC, 2, 3, 3)
        # orient: normal must point inside -> outside
        w = inside.astype(sdf.dtype)
        n_in = jnp.maximum(jnp.sum(w, -1, keepdims=True), 1.0)
        n_out = jnp.maximum(jnp.sum(1.0 - w, -1, keepdims=True), 1.0)
        c_in = jnp.einsum("nc,ncd->nd", w / n_in, tpos)
        c_out = jnp.einsum("nc,ncd->nd", (1.0 - w) / n_out, tpos)
        d = c_out - c_in                                   # [nC, 3]
        nrm = jnp.cross(tri_p[:, :, 1] - tri_p[:, :, 0],
                        tri_p[:, :, 2] - tri_p[:, :, 0])
        flip = jnp.einsum("nkd,nd->nk", nrm, d) < 0.0      # [nC, 2]
        p1 = jnp.where(flip[..., None], tri_p[:, :, 2], tri_p[:, :, 1])
        p2 = jnp.where(flip[..., None], tri_p[:, :, 1], tri_p[:, :, 2])
        tri_p = jnp.stack([tri_p[:, :, 0], p1, p2], axis=2)
        return tri_p, valid

    tris, valids = [], []
    for tet in _TETS:                      # static unroll: 6 passes
        tp, va = one_tet(tet)
        tris.append(tp)
        valids.append(va)
    tri_all = jnp.concatenate(tris, axis=1).reshape(-1, 3, 3)
    val_all = jnp.concatenate(valids, axis=1).reshape(-1)

    count = jnp.sum(val_all.astype(jnp.int32))
    (sel,) = jnp.nonzero(val_all, size=capacity, fill_value=0)
    verts = tri_all[sel]
    lane = jnp.arange(capacity) < count
    verts = jnp.where(lane[:, None, None], verts, 0.0)
    return TriSoup(verts=verts, count=count,
                   overflow=count > capacity)


def surface_from_levelset(ls, *, iso=0.0, capacity: int = 65536) -> TriSoup:
    """Surface a SparseLevelSet: densify its active bounding box (host-
    sized, like the reference's VDB-to-mesh conversions), then march."""
    from .sparse_grid import sparse_grid_to_dense
    g = ls.grid
    bs = g.block_size
    coords = np.asarray(g.table.active_coords)
    coords = coords[np.asarray(g.table.mask)]
    lo = coords.min(0) * bs - 1
    hi = (coords.max(0) + 1) * bs + 1
    dense = sparse_grid_to_dense(g, "sdf", lo, hi,
                                 default=float(ls.background))
    origin = g.index_to_world(jnp.asarray(lo, jnp.float32))
    return marching_tets(dense, g.dx, iso=iso, origin=origin,
                         capacity=capacity)
