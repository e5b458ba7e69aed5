"""Codimensional cloth: stretch + hinge bending + IPC ground barrier,
implicit Euler via Newton-CG.

This is the assembly consumer for the codim kernel set the reference
exposes (``math/DihedralAngle.hpp`` hinge bending via
:mod:`zpc_tpu.geometry.dihedral`; the IPC barrier of
``geometry/Distance.hpp`` via :mod:`zpc_tpu.geometry.contact`;
``ConjugateGradient.hpp`` via :mod:`zpc_tpu.math.solvers.cg`) — the
reference ships the kernels and leaves assembly to downstream (zeno
codim-IPC); here the assembled solver is part of the framework.

Design notes: the whole step is one traced program — the incremental
potential ``Phi(y) = 1/(2 dt^2) |y - xhat|^2_M + E(y)`` is differentiated
by autodiff, Newton directions come from matrix-free CG with
Hessian-vector products (``jax.jvp`` of the gradient — no 12x12
assembly), and the ground-plane step limiter is the analytic half-space
form of IPC's CCD line search (``alpha <= 0.9 d / (-n . dx)``), a pure
reduction.  Mesh topology (edges, hinges) is built host-side once;
per-step vertex gathers are small (cloth N << MPM N) so XLA's gather
path is acceptable here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry.contact import (barrier, barrier_grad, barrier_hess,
                                friction_f0, friction_f1_over_x)
from ..geometry.dihedral import (dihedral_angle, dihedral_angle_gradient,
                                 hinge_bending_energy)
from ..geometry.distance import point_triangle_ccd, point_triangle_closest
from ..math.solvers import cg

__all__ = ["ClothSim", "ClothStencil", "ContactWindow", "make_cloth_grid",
           "cloth_energy", "implicit_step", "self_contact_candidates",
           "self_contact_energy", "assemble_operator", "apply_operator",
           "build_incidence", "build_grid_stencil",
           "window_contact_energy", "classify_window_residue"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClothStencil:
    """Stencil (slice-form) topology for unions of regular grids.

    A cloth ablation pinned the CG apply to the indexed-ROW rate
    regardless of gather vs scatter direction (chosen before the move to the GPU; not re-measured on the H100); rearranging which
    side indexes conserves rows.
    The only way OUT is structure: on a regular ``nx x ny`` grid every
    edge and hinge family lives at a static (i, j) offset, so the
    stretch/bend terms of the energy, the assembled GN operator, its
    application, and its diagonal are pure SLICE arithmetic — zero
    indexed rows (the same structured/unstructured split the MPM grid
    exploits; reference analog: regular-lattice cloth in zeno's codim
    scenes).  Families per grid, with ``vid(i,j) = start + i*ny + j``:

    * stretch: horizontal ``(i,j)-(i+1,j)``, vertical ``(i,j)-(i,j+1)``,
      diagonal ``(i,j)-(i+1,j+1)`` (the cell-split diagonal);
    * bending (hinge rows ``(v2, v0, v1, v3) = (opp0, a, b, opp1)``):
      over interior horizontal / vertical / diagonal edges, each with
      all four vertices at static offsets.

    ``rest_len`` / ``rest_angle`` hold the per-family rest quantities
    reshaped to the family's ``[sx, sy]`` patch, gathered host-side
    from the sim's edge/hinge-ordered arrays (build_grid_stencil
    verifies the family decomposition covers the topology EXACTLY —
    every edge and hinge claimed once, hinge vertex order matching —
    so the stencil operator equals the edge-list operator up to f32
    summation order; oracle: tests/test_cloth.py).
    """

    rest_len: Tuple[jax.Array, ...]     # 3 per grid (h, v, d), [sx, sy]
    rest_angle: Tuple[jax.Array, ...]   # 3 per grid (bh, bv, bd)
    grids: Tuple[Tuple[int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True), default=())   # (start, nx, ny)
    # triangle-id base per grid when sim.tris follows make_cloth_grid's
    # cell-raster order (tri = base + 2*(ci*(ny-1)+cj) + parity) — the
    # window-stencil contact path needs this id <-> cell bijection;
    # None when sim.tris is ordered differently (window unavailable).
    tri_starts: Optional[Tuple[int, ...]] = dataclasses.field(
        metadata=dict(static=True), default=None)


def _stretch_slices(nx, ny):
    """(s0, s1) index tuples per stretch family on a [nx, ny, ...]
    grid view (h, v, d — see ClothStencil)."""
    a = slice(None)
    return (((slice(0, nx - 1), a), (slice(1, nx), a)),
            ((a, slice(0, ny - 1)), (a, slice(1, ny))),
            ((slice(0, nx - 1), slice(0, ny - 1)),
             (slice(1, nx), slice(1, ny))))


def _bend_slices(nx, ny):
    """(s_v2, s_v0, s_v1, s_v3) per bend family (bh, bv, bd), matching
    make_cloth_grid's hinge construction (opp0 = first triangle in
    cell-iteration order)."""
    return (
        # over horizontal interior edges (i,j)-(i+1,j), j in [1, ny-2]:
        # (opp0=(i,j-1), a=(i,j), b=(i+1,j), opp1=(i+1,j+1))
        ((slice(0, nx - 1), slice(0, ny - 2)),
         (slice(0, nx - 1), slice(1, ny - 1)),
         (slice(1, nx), slice(1, ny - 1)),
         (slice(1, nx), slice(2, ny))),
        # over vertical interior edges (i,j)-(i,j+1), i in [1, nx-2]:
        # (opp0=(i-1,j), a=(i,j), b=(i,j+1), opp1=(i+1,j+1))
        ((slice(0, nx - 2), slice(0, ny - 1)),
         (slice(1, nx - 1), slice(0, ny - 1)),
         (slice(1, nx - 1), slice(1, ny)),
         (slice(2, nx), slice(1, ny))),
        # over diagonal edges (i,j)-(i+1,j+1) (both triangles share the
        # cell): (opp0=(i+1,j), a=(i,j), b=(i+1,j+1), opp1=(i,j+1))
        ((slice(1, nx), slice(0, ny - 1)),
         (slice(0, nx - 1), slice(0, ny - 1)),
         (slice(1, nx), slice(1, ny)),
         (slice(0, nx - 1), slice(1, ny))))


def build_grid_stencil(sim: ClothSim, grids) -> ClothSim:
    """Attach a :class:`ClothStencil` for a union of regular grids.

    ``grids``: iterable of ``(start, nx, ny)`` vertex-id ranges that
    must PARTITION ``[0, N)`` contiguously (multi-layer scenes pass one
    tuple per layer).  Host-side: maps every family position to its
    edge/hinge index in ``sim`` and verifies exact coverage — raises if
    the mesh is not the union of make_cloth_grid topologies."""
    grids = tuple((int(s), int(a), int(b)) for s, a, b in grids)
    N = int(sim.mass.shape[0])
    off = 0
    for s, gx, gy in grids:      # diag/apply concatenate in grid order
        if s != off:
            raise ValueError("grids must partition [0, N) contiguously"
                             " in increasing-start order")
        off += gx * gy
    if off != N:
        raise ValueError("grids must partition [0, N)")
    edges = np.asarray(sim.edges)
    hinges = np.asarray(sim.hinges)
    e_ix = {(int(a), int(b)): k for k, (a, b) in enumerate(edges)}
    h_ix = {(int(r[1]), int(r[2])): k for k, r in enumerate(hinges)}
    rl = np.asarray(sim.rest_len)
    ra = np.asarray(sim.rest_angle)
    rest_len, rest_angle = [], []
    e_used = np.zeros(len(edges), bool)
    h_used = np.zeros(len(hinges), bool)
    for start, nx, ny in grids:
        vid = start + (np.arange(nx)[:, None] * ny
                       + np.arange(ny)[None, :]).astype(np.int64)
        for s0, s1 in _stretch_slices(nx, ny):
            ks = np.asarray([[e_ix[(int(a), int(b))]
                              for a, b in zip(ra_, rb_)]
                             for ra_, rb_ in zip(vid[s0], vid[s1])],
                            np.int64)
            if e_used[ks.ravel()].any():
                raise ValueError("edge claimed twice")
            e_used[ks.ravel()] = True
            rest_len.append(jnp.asarray(rl[ks], jnp.float32))
        for s2, s0, s1, s3 in _bend_slices(nx, ny):
            rows = np.stack([vid[s2], vid[s0], vid[s1], vid[s3]], -1)
            sx, sy = rows.shape[:2]
            ks = np.asarray([[h_ix[(int(r[1]), int(r[2]))]
                              for r in row] for row in rows], np.int64)
            if not np.array_equal(hinges[ks.reshape(-1)],
                                  rows.reshape(-1, 4)):
                raise ValueError("hinge vertex order mismatch")
            if h_used[ks.ravel()].any():
                raise ValueError("hinge claimed twice")
            h_used[ks.ravel()] = True
            rest_angle.append(jnp.asarray(ra[ks], jnp.float32))
    if not (e_used.all() and h_used.all()):
        raise ValueError("mesh has edges/hinges outside the grid union")
    # triangle-id <-> (cell, parity) bijection check (window contact)
    tris = np.asarray(sim.tris)
    tri_starts, t0, ok = [], 0, True
    for start, nx, ny in grids:
        vid = start + (np.arange(nx)[:, None] * ny
                       + np.arange(ny)[None, :]).astype(np.int64)
        a = vid[:-1, :-1].reshape(-1)
        b = vid[1:, :-1].reshape(-1)
        d = vid[1:, 1:].reshape(-1)
        c = vid[:-1, 1:].reshape(-1)
        exp = np.stack([np.stack([a, b, d], -1),
                        np.stack([a, d, c], -1)], 1).reshape(-1, 3)
        nt = exp.shape[0]
        if t0 + nt > len(tris) or not np.array_equal(
                tris[t0:t0 + nt], exp):
            ok = False
            break
        tri_starts.append(t0)
        t0 += nt
    tri_starts = tuple(tri_starts) if ok and t0 == len(tris) else None
    sten = ClothStencil(rest_len=tuple(rest_len),
                        rest_angle=tuple(rest_angle), grids=grids,
                        tri_starts=tri_starts)
    return dataclasses.replace(sim, stencil=sten)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClothSim:
    """Static topology + material for a triangle-mesh cloth."""

    tris: jax.Array        # [M, 3] int32
    edges: jax.Array       # [E, 2] int32
    hinges: jax.Array      # [H, 4] int32 rows (v2, v0, v1, v3)
    rest_len: jax.Array    # [E]
    rest_angle: jax.Array  # [H]
    mass: jax.Array        # [N]
    free: jax.Array        # [N] bool, False = pinned (Dirichlet)
    k_stretch: jax.Array
    k_bend: jax.Array
    gravity: jax.Array     # [3]
    ground_n: jax.Array    # [3] unit normal
    ground_off: jax.Array  # plane: n.x = off
    dhat: jax.Array        # barrier activation distance
    kappa: jax.Array       # barrier stiffness
    mu: jax.Array          # ground friction coefficient (0 = off)
    epsv: jax.Array        # friction velocity mollifier (m/s)
    # static transpose tables (see build_incidence): scatter-adds with
    # duplicate indices serialized and dominated the apply (chosen before the move to the GPU; not re-measured on the H100) — with
    # these, every scatter in the CG operator becomes a bounded gather.  None -> scatter fallback.
    edge_inc: Optional[jax.Array] = None    # [N, De] side*E+e, -1 pad
    hinge_inc: Optional[jax.Array] = None   # [N, Dh] h*4+slot, -1 pad
    # slice-form topology for unions of regular grids (round 4):
    # stretch/bend with ZERO indexed rows — see ClothStencil /
    # build_grid_stencil.  None -> incidence/scatter paths.
    stencil: Optional["ClothStencil"] = None


def make_cloth_grid(nx: int, ny: int, spacing: float, *,
                    height: float = 0.5, k_stretch: float = 1e3,
                    k_bend: float = 1e-3, mass: float = 1.0,
                    pinned=(), ground_n=(0.0, 1.0, 0.0),
                    ground_off: float = 0.0, dhat: float = 0.01,
                    kappa: float = 1e2, mu: float = 0.0,
                    epsv: float = 1e-3,
                    gravity=(0.0, -9.8, 0.0)) -> Tuple[ClothSim, jax.Array]:
    """Regular nx x ny cloth in the XZ plane at ``height``; host-side
    topology build (edges from tris; hinges = interior edges with their
    two opposite vertices, the (v2, v0, v1, v3) layout of
    DihedralAngle.hpp)."""
    xs, zs = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pos = np.stack([xs * spacing, np.full(xs.shape, height),
                    zs * spacing], axis=-1).reshape(-1, 3)
    vid = np.arange(nx * ny).reshape(nx, ny)
    tris = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a, b = vid[i, j], vid[i + 1, j]
            c, d = vid[i, j + 1], vid[i + 1, j + 1]
            tris.append((a, b, d))
            tris.append((a, d, c))
    tris = np.asarray(tris, np.int32)
    edge_opp = {}
    for t in tris:
        for k in range(3):
            e = (int(t[k]), int(t[(k + 1) % 3]))
            key = (min(e), max(e))
            edge_opp.setdefault(key, []).append(int(t[(k + 2) % 3]))
    edges = np.asarray(sorted(edge_opp), np.int32)
    hinges = np.asarray(
        [(opp[0], a, b, opp[1])
         for (a, b), opp in sorted(edge_opp.items()) if len(opp) == 2],
        np.int32).reshape(-1, 4)
    x0 = jnp.asarray(pos, jnp.float32)
    rest_len = jnp.linalg.norm(x0[edges[:, 0]] - x0[edges[:, 1]], axis=-1)
    rest_angle = dihedral_angle(x0[hinges[:, 0]], x0[hinges[:, 1]],
                                x0[hinges[:, 2]], x0[hinges[:, 3]])
    free = np.ones(nx * ny, bool)
    free[list(pinned)] = False
    f32 = jnp.float32
    sim = ClothSim(
        tris=jnp.asarray(tris), edges=jnp.asarray(edges),
        hinges=jnp.asarray(hinges), rest_len=rest_len,
        rest_angle=rest_angle,
        mass=jnp.full((nx * ny,), mass, f32),
        free=jnp.asarray(free), k_stretch=f32(k_stretch),
        k_bend=f32(k_bend), gravity=jnp.asarray(gravity, f32),
        ground_n=jnp.asarray(ground_n, f32), ground_off=f32(ground_off),
        dhat=f32(dhat), kappa=f32(kappa), mu=f32(mu),
        epsv=f32(epsv))
    return build_grid_stencil(build_incidence(sim), ((0, nx, ny),)), x0


def build_incidence(sim: ClothSim) -> ClothSim:
    """Host-side static transpose tables (round 4).

    Scatter-adds serialize on duplicate indices: the assembled CG
    operator's three scatters dominated its apply (chosen before the move to the GPU; not re-measured on the H100).  Topology is
    static, so the transposes are
    precomputable: per vertex, the incident (edge, side) and
    (hinge, slot) contributions, padded to the max degree — apply
    becomes bounded row-gathers + masked sums, bit-equivalent up to f32
    summation order.  Call once per topology (make_cloth_grid does;
    call directly after hand-assembling a ClothSim, e.g. multi-layer
    scenes)."""
    N = int(sim.mass.shape[0])
    edges = np.asarray(sim.edges)
    hinges = np.asarray(sim.hinges)
    E = len(edges)
    einc = [[] for _ in range(N)]
    for e in range(E):
        einc[int(edges[e, 0])].append(e)          # +f side
        einc[int(edges[e, 1])].append(E + e)      # -f side
    hinc = [[] for _ in range(N)]
    for hg in range(len(hinges)):
        for slot in range(4):
            hinc[int(hinges[hg, slot])].append(hg * 4 + slot)
    de = max(1, max((len(l) for l in einc), default=1))
    dh = max(1, max((len(l) for l in hinc), default=1))
    et = np.full((N, de), -1, np.int32)
    ht = np.full((N, dh), -1, np.int32)
    for i in range(N):
        et[i, :len(einc[i])] = einc[i]
        ht[i, :len(hinc[i])] = hinc[i]
    return dataclasses.replace(sim, edge_inc=jnp.asarray(et),
                               hinge_inc=jnp.asarray(ht))


def _grid_views(sten: ClothStencil, x: jax.Array):
    """Per-grid [nx, ny, 3] views of a [N, 3] field (grids partition
    [0, N) contiguously — enforced by build_grid_stencil)."""
    if sum(nx * ny for _, nx, ny in sten.grids) != x.shape[0]:
        raise ValueError(
            "stale ClothStencil: grids cover {} vertices but the field "
            "has {} — after dataclasses.replace on topology, rebuild "
            "with build_grid_stencil or set stencil=None".format(
                sum(nx * ny for _, nx, ny in sten.grids), x.shape[0]))
    return [x[s:s + nx * ny].reshape(nx, ny, 3)
            for s, nx, ny in sten.grids]


def _stencil_elastic_energy(sim: ClothSim, x: jax.Array) -> jax.Array:
    """Stretch + bend energy in slice form (zero indexed rows); equals
    the edge/hinge-list energy up to f32 summation order, so autodiff
    through it yields the same gradient with slice-scatter adjoints."""
    sten = sim.stencil
    e = jnp.float32(0.0)
    views = _grid_views(sten, x)
    for g, (_, nx, ny) in enumerate(sten.grids):
        X = views[g]
        for f, (s0, s1) in enumerate(_stretch_slices(nx, ny)):
            d = X[s0] - X[s1]
            lens = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-20)
            e = e + 0.5 * sim.k_stretch * jnp.sum(
                (lens - sten.rest_len[3 * g + f]) ** 2)
        for f, (s2, s0, s1, s3) in enumerate(_bend_slices(nx, ny)):
            e = e + jnp.sum(hinge_bending_energy(
                X[s2], X[s0], X[s1], X[s3],
                sten.rest_angle[3 * g + f], sim.k_bend))
    return e


def cloth_energy(sim: ClothSim, x: jax.Array) -> jax.Array:
    """Elastic + barrier energy (gravity enters through the inertia
    target, the standard incremental-potential split)."""
    if sim.stencil is not None:
        e_elastic = _stencil_elastic_energy(sim, x)
    else:
        d = x[sim.edges[:, 0]] - x[sim.edges[:, 1]]
        lens = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-20)
        e_stretch = 0.5 * sim.k_stretch * jnp.sum(
            (lens - sim.rest_len) ** 2)
        e_bend = jnp.sum(hinge_bending_energy(
            x[sim.hinges[:, 0]], x[sim.hinges[:, 1]],
            x[sim.hinges[:, 2]], x[sim.hinges[:, 3]],
            sim.rest_angle, sim.k_bend))
        e_elastic = e_stretch + e_bend
    gap = x @ sim.ground_n - sim.ground_off
    e_contact = jnp.sum(barrier(gap * gap, sim.dhat * sim.dhat,
                                sim.kappa))
    return e_elastic + e_contact


def self_contact_candidates(sim: ClothSim, x: jax.Array,
                            max_cand: int = 8, tile: int = 512):
    """Lagged vertex-triangle candidate set for self-contact.

    LBVH over the current triangle boxes (complete-tree build: cloth M
    is small and the build is jit-traced every step), one dhat-padded
    AABB query per vertex through the sorted banded join, triangles
    incident to the vertex excluded.  Returns ``(cand [N, max_cand]
    int32, overflow)`` — overflow True when a vertex had more than
    ``max_cand`` candidates or fell out of the band (caller re-traces
    with a larger budget, the framework's standard contract).

    Round 5: the broad phase runs the DECOMPOSED banded join
    (``decompose=True, cells=8``).  A flat sheet is the adversarial
    case for the plain band — every vertex box straddles a high morton
    plane, so the plain join certified NOTHING at the settled two-layer
    state (in-band fraction 0.0000) and
    the overflow flag was permanently True.  Decomposed entries get
    SHORT morton intervals by construction, but short in CODE space is
    not short in LEAF space: once the sheets settle and wrinkle, leaf
    density inside a covering cell grows until the interval spills the
    join's 3*TL-leaf tile window — at ``tile=128`` (window ~96 leaves)
    51% of queries fell out of band at the settled 8k bench state;
    ``tile=512`` (window ~375 leaves) certifies 100% with the compare
    volume still trivial at cloth-scale M.
    Returns are entry-granular with duplicated qid and are combined
    here by segment ops (counts scatter-ADD, band scatter-AND, hit
    slots via an occurrence-rank scatter — the cells are disjoint so
    the union has no duplicates).

    Reference lineage: codim-IPC's spatial-hash/BVH broad phase feeding
    ``geometry/Distance.hpp`` barriers (the reference ships the kernels
    and leaves assembly to zeno's codim solver; here it is assembled).
    """
    from ..containers.bvh import build_lbvh_complete, query_overlaps_sorted
    N = x.shape[0]
    M = int(sim.tris.shape[0])
    tv = x[sim.tris]                                    # [M, 3, 3]
    vid = jnp.arange(N, dtype=jnp.int32)[:, None]
    if M <= 512:
        # toy scales: the banded join's window granularity (3 tiles of
        # ceil(M/ntiles) leaves) is coarser than a tiny tree, so the
        # band certificate fails spuriously — brute-force the [N, M]
        # AABB table instead (exact, and trivial at this size)
        tlo, thi = jnp.min(tv, 1), jnp.max(tv, 1)
        ov = (jnp.all(tlo[None] <= (x + sim.dhat)[:, None], -1)
              & jnp.all(thi[None] >= (x - sim.dhat)[:, None], -1))
        incident = jnp.zeros((N, M), bool)       # column form: no
        for k in range(3):                       # [N, M, 3] lane pad
            incident = incident | (sim.tris[:, k][None, :] == vid)
        keep = ov & ~incident
        cand_all = jnp.where(keep, jnp.arange(M, dtype=jnp.int32)[None],
                             -1)
        rank = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
        slot = jnp.where(keep & (rank < max_cand), rank, max_cand)
        cand = jnp.full((N, max_cand + 1), -1, jnp.int32).at[
            vid, slot].set(cand_all)[:, :max_cand]
        n_keep = jnp.sum(keep.astype(jnp.int32), axis=1)
        return cand, jnp.any(n_keep > max_cand)
    bvh = build_lbvh_complete(jnp.min(tv, 1), jnp.max(tv, 1))
    nq = -(-N // tile) * tile
    far = jnp.float32(1e9)
    pad = nq - N
    # vertex +- dhat boxes share one extent -> uniform_extent fast path
    # (3 center columns ride the entry sort instead of 6 box columns)
    pts = jnp.concatenate([x, jnp.full((pad, 3), far, x.dtype)])
    R, C = 8, max_cand + 3      # per-CELL slot budget (hits split
    #                             across a vertex's <= 8 covering cells)
    qid, hits, cnt, band = query_overlaps_sorted(
        bvh, pts, pts, C, tile=tile, uniform_extent=sim.dhat,
        decompose=True, cells=R)
    E = nq * R
    # occurrence rank: every qid appears EXACTLY R times (invalid
    # cells return empty intervals, never dropped), so after a stable
    # sort by qid, sorted position j belongs to query j // R at
    # occurrence j % R
    pos = jnp.arange(E, dtype=jnp.int32)
    _, perm = jax.lax.sort((qid, pos), num_keys=1, is_stable=True)
    occ = jnp.zeros((E,), jnp.int32).at[perm].set(pos % R)
    hits_v = jnp.full((nq, R, C), -1, jnp.int32
                      ).at[qid, occ].set(hits)[:N].reshape(N, R * C)
    cnt_e_ok = cnt <= C                 # per-entry slot truncation
    live_q = qid < N
    band_ok = jnp.all(jnp.where(live_q, band & cnt_e_ok, True))
    # drop triangles incident to the vertex (statically excluded from
    # the window term; the dhat ball at rest sees few of the <= 6).
    # Per-CORNER-column gathers: a [N, R*C, 3] row-gather pads its
    # 3-wide minor dim in the device layout (it ran out of memory at 128k
    # verts; chosen before the move to the GPU; not re-measured on the H100), while three [N, R*C] column gathers are unpadded
    hs = jnp.maximum(hits_v, 0)
    incident = jnp.zeros(hits_v.shape, bool)
    for k in range(3):
        incident = incident | (sim.tris[:, k][hs] == vid)
    incident = incident & (hits_v >= 0)
    cand_all = jnp.where(incident, -1, hits_v)
    # compact the survivors into max_cand slots (static small R*C)
    keep = cand_all >= 0
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    slot = jnp.where(keep & (rank < max_cand), rank, max_cand)
    cand = jnp.full((N, max_cand + 1), -1, jnp.int32).at[
        vid, slot].set(cand_all)[:, :max_cand]
    n_keep = jnp.sum(keep.astype(jnp.int32), axis=1)
    overflow = jnp.any(n_keep > max_cand) | ~band_ok
    return cand, overflow


def self_contact_energy(sim: ClothSim, x: jax.Array,
                        cand: jax.Array) -> jax.Array:
    """IPC barrier over the lagged vertex-triangle candidate set."""
    valid = cand >= 0
    tv = x[sim.tris[jnp.maximum(cand, 0)]]              # [N, C, 3, 3]
    _, cl = point_triangle_closest(x[:, None, :], tv[:, :, 0],
                                   tv[:, :, 1], tv[:, :, 2])
    diff = x[:, None, :] - cl
    d2 = jnp.sum(diff * diff, axis=-1)
    e = barrier(d2, sim.dhat * sim.dhat, sim.kappa)
    return jnp.sum(jnp.where(valid, e, 0.0))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ContactWindow:
    """Static config for window-stencil self-contact (round 4).

    The round-4 cloth ablation pinned the step cost to indexed-row
    rate, and after the grid stencil removed the stretch/bend rows the
    CONTACT rows (4 x N x C per CG apply) are the floor.  For layered
    regular-grid cloth — the codim-IPC regime the bench models — a
    vertex's contact partners in another layer sit at STATIC grid
    offsets from its own (i, j): triangles of cells
    ``(i+di, j+dj, parity)`` for ``|di|,|dj| <= radius``.  The window
    term therefore evaluates ALL in-window pairs in slice form (zero
    indexed rows; out-of-range cells masked, barriers beyond dhat are
    exactly zero), and the LBVH broad phase — still run — certifies
    completeness: any candidate NOT covered by the window (own-layer
    folds, slid-apart layers) is compacted into an indexed RESIDUE of
    budget ``max_residue`` under the standard overflow contract.
    window + residue == the LBVH candidate set exactly (in-window
    non-candidates are farther than dhat -> barrier contributes 0), so
    the energy/operator equal the gathered path up to f32 summation
    order (oracle: tests/test_cloth.py).

    Requires ``sim.stencil`` with ``tri_starts`` (make_cloth_grid /
    build_grid_stencil meshes).  Reference lineage: the same
    structured/unstructured split as MPM's fixed B-spline stencil vs
    scattered particles.
    """

    radius: int = dataclasses.field(        # offsets in [-r, r] cells
        metadata=dict(static=True), default=1)
    max_residue: int = dataclasses.field(   # indexed residue budget
        metadata=dict(static=True), default=64)


_FAR = 1.0e6               # padding sentinel: farther than any dhat


# own-grid offsets whose triangle CONTAINS vertex (i, j) — static per
# (di, dj, parity): par 0 corners (0,0),(1,0),(1,1); par 1 corners
# (0,0),(1,1),(0,1); the triangle of cell (i+di, j+dj) contains the
# vertex iff (di+u, dj+v) == (0, 0) for one of its corners (u, v).
_INCIDENT = ({(0, 0), (-1, 0), (-1, -1)},      # parity 0
             {(0, 0), (-1, -1), (0, -1)})      # parity 1


def _window_offsets(sten: ClothStencil, cw: ContactWindow):
    """Static (g, gp, di, dj, par) list over same-shape grid pairs
    (including g == gp, with the vertex-incident offsets statically
    excluded — the compile-time form of the broad phase's incident-
    triangle filter); the per-offset triangle is cell (i+di, j+dj)
    parity ``par`` of grid ``gp`` seen from vertex (i, j) of ``g``."""
    out = []
    r = cw.radius
    for g, (_, nx, ny) in enumerate(sten.grids):
        for gp, (_, mx, my) in enumerate(sten.grids):
            if (nx, ny) != (mx, my):
                continue
            for di in range(-r, r + 1):
                for dj in range(-r, r + 1):
                    for par in (0, 1):
                        if g == gp and (di, dj) in _INCIDENT[par]:
                            continue
                        out.append((g, gp, di, dj, par))
    return out


def _pad_grid(view, r, fill):
    return jnp.pad(view, ((r, r + 1), (r, r + 1), (0, 0)),
                   constant_values=fill)


_CORNER_UV = (((0, 0), (1, 0), (1, 1)),        # parity 0: (a, b, d)
              ((0, 0), (1, 1), (0, 1)))        # parity 1: (a, d, c)


def _window_groups(sten: ClothStencil, cw: ContactWindow):
    """Offsets grouped by (g, gp) pair: [(g, gp, [(di, dj, par)...])].
    Grouping lets each pair run ONE batched [O, nx, ny, .] kernel —
    per-offset subgraphs blow up compile time ~60x."""
    groups = {}
    for g, gp, di, dj, par in _window_offsets(sten, cw):
        groups.setdefault((g, gp), []).append((di, dj, par))
    return [(g, gp, offs) for (g, gp), offs in groups.items()]


def _stack_corners(pad_view, nx, ny, r, offs):
    """Corner stacks (A, B, C) each [O, nx, ny, 3] for a batch of
    offsets, in sim.tris row order."""
    cols = [[], [], []]
    for di, dj, par in offs:
        for c, (u, v) in enumerate(_CORNER_UV[par]):
            i0, j0 = r + di + u, r + dj + v
            cols[c].append(pad_view[i0:i0 + nx, j0:j0 + ny, :])
    return tuple(jnp.stack(col, axis=0) for col in cols)


def _stack_masks(nx, ny, offs):
    """Static [O, nx, ny] validity (cell exists).  Masking — not the
    FAR padding — guarantees exactness: a partially-padded triangle
    can pass arbitrarily near a vertex."""
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    m = np.stack([(i + di >= 0) & (i + di <= nx - 2)
                  & (j + dj >= 0) & (j + dj <= ny - 2)
                  for di, dj, _ in offs], axis=0)
    return jnp.asarray(m)


_SAFE_TRI = (jnp.asarray([1.0, 0.0, 0.0]),     # masked-pair dummy
             jnp.asarray([1.0, 0.1, 0.0]),     # triangle offsets from
             jnp.asarray([1.0, 0.0, 0.1]))     # the query vertex


def _sanitize_tri(mask3, xv, A, B, C):
    """Replace masked/invalid triangles by a well-conditioned dummy at
    ~unit distance from the query vertex.  The output mask already
    zeroes their contribution; this input-side mask is the standard
    double-where: grad(point_triangle_closest) is NaN on degenerate
    (e.g. FAR-padded) triangles, and 0 * NaN = NaN would leak through
    the output where()."""
    return (jnp.where(mask3, A, xv + _SAFE_TRI[0]),
            jnp.where(mask3, B, xv + _SAFE_TRI[1]),
            jnp.where(mask3, C, xv + _SAFE_TRI[2]))


def window_contact_energy(sim: ClothSim, cw: ContactWindow,
                          x: jax.Array) -> jax.Array:
    """IPC barrier energy over all in-window vertex-triangle pairs,
    slice form (autodiff adjoint is pad-add — no gathers)."""
    sten = sim.stencil
    views = _grid_views(sten, x)
    r = cw.radius
    pads = [_pad_grid(v, r, _FAR) for v in views]
    d2h = sim.dhat * sim.dhat
    e = jnp.float32(0.0)
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        xv = views[g][None]
        mask = _stack_masks(nx, ny, offs)
        A, B, C = _sanitize_tri(mask[..., None], xv,
                                *_stack_corners(pads[gp], nx, ny, r,
                                                offs))
        _, cl = point_triangle_closest(xv, A, B, C)
        diff = xv - cl
        d2 = jnp.sum(diff * diff, axis=-1)
        e = e + jnp.sum(jnp.where(mask, barrier(d2, d2h, sim.kappa),
                                  0.0))
    return e


def _window_gn(sim: ClothSim, cw: ContactWindow, y: jax.Array):
    """Frozen GN-PSD data per (g, gp) group: (bary, diff, bpp) stacks
    [O, nx, ny, ...] (the same projection as the gathered contact
    term)."""
    sten = sim.stencil
    views = _grid_views(sten, y)
    r = cw.radius
    pads = [_pad_grid(v, r, _FAR) for v in views]
    d2h = sim.dhat * sim.dhat
    data = []
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        A, B, C = _stack_corners(pads[gp], nx, ny, r, offs)
        bary, cl = point_triangle_closest(views[g][None], A, B, C)
        diff = views[g][None] - cl
        s = jnp.sum(diff * diff, axis=-1)
        bpp = jnp.where(_stack_masks(nx, ny, offs),
                        jnp.maximum(barrier_hess(s, d2h, sim.kappa),
                                    0.0), 0.0)
        data.append((jax.lax.stop_gradient(bary),
                     jax.lax.stop_gradient(diff), bpp))
    return tuple(data)


def _window_apply(sim: ClothSim, cw: ContactWindow, data, p: jax.Array):
    """Window contact term of the CG apply: batched slice reads of the
    partner grids, elementwise GN algebra, slice-add accumulation into
    padded per-grid buffers — zero indexed rows."""
    sten = sim.stencil
    views = _grid_views(sten, p)
    r = cw.radius
    pads = [_pad_grid(v, r, 0.0) for v in views]
    outs = [jnp.zeros_like(v) for v in views]
    accs = [jnp.zeros_like(pv) for pv in pads]
    for k, (g, gp, offs) in enumerate(_window_groups(sten, cw)):
        _, nx, ny = sten.grids[g]
        bary, diff, bpp = data[k]
        A, B, C = _stack_corners(pads[gp], nx, ny, r, offs)
        rel = (views[g][None]
               - (bary[..., 0:1] * A + bary[..., 1:2] * B
                  + bary[..., 2:3] * C))
        coef = bpp * (2.0 * jnp.sum(diff * rel, axis=-1))  # [O, nx, ny]
        outs[g] = outs[g] + jnp.sum(
            2.0 * coef[..., None] * diff, axis=0)
        ct = (-2.0 * coef[..., None, None]
              * bary[..., :, None] * diff[..., None, :])   # [O,nx,ny,3,3]
        for o, (di, dj, par) in enumerate(offs):
            for c, (u, v) in enumerate(_CORNER_UV[par]):
                i0, j0 = r + di + u, r + dj + v
                accs[gp] = accs[gp].at[i0:i0 + nx, j0:j0 + ny, :].add(
                    ct[o, :, :, c, :])
    for g, (_, nx, ny) in enumerate(sten.grids):
        outs[g] = outs[g] + accs[g][r:r + nx, r:r + ny, :]
    return jnp.concatenate([o.reshape(-1, 3) for o in outs], axis=0)


def _window_diag(sim: ClothSim, cw: ContactWindow, data):
    """Exact diagonal contribution of the window term."""
    sten = sim.stencil
    r = cw.radius
    shapes = [(nx, ny) for _, nx, ny in sten.grids]
    outs = [jnp.zeros((nx, ny, 3), jnp.float32) for nx, ny in shapes]
    accs = [jnp.zeros((nx + 2 * r + 1, ny + 2 * r + 1, 3), jnp.float32)
            for nx, ny in shapes]
    for k, (g, gp, offs) in enumerate(_window_groups(sten, cw)):
        nx, ny = shapes[g]
        bary, diff, bpp = data[k]
        dv = 4.0 * bpp[..., None] * diff * diff            # [O, nx, ny, 3]
        outs[g] = outs[g] + jnp.sum(dv, axis=0)
        dt_ = (bary ** 2)[..., :, None] * dv[..., None, :]  # [O,nx,ny,3,3]
        for o, (di, dj, par) in enumerate(offs):
            for c, (u, v) in enumerate(_CORNER_UV[par]):
                i0, j0 = r + di + u, r + dj + v
                accs[gp] = accs[gp].at[i0:i0 + nx, j0:j0 + ny, :].add(
                    dt_[o, :, :, c, :])
    for g, (nx, ny) in enumerate(shapes):
        outs[g] = outs[g] + accs[g][r:r + nx, r:r + ny, :]
    return jnp.concatenate([o.reshape(-1, 3) for o in outs], axis=0)


def _window_ccd_alpha(sim: ClothSim, cw: ContactWindow, x, dx):
    """CCD step limit over the in-window pairs, batched slice form
    (one conservative-advancement loop per grid pair)."""
    sten = sim.stencil
    vx = _grid_views(sten, x)
    vd = _grid_views(sten, dx)
    r = cw.radius
    px = [_pad_grid(v, r, _FAR) for v in vx]
    pd = [_pad_grid(v, r, 0.0) for v in vd]
    alpha = jnp.float32(1.0)
    for g, gp, offs in _window_groups(sten, cw):
        _, nx, ny = sten.grids[g]
        A, B, C = _stack_corners(px[gp], nx, ny, r, offs)
        dA, dB, dC = _stack_corners(pd[gp], nx, ny, r, offs)
        toi = point_triangle_ccd(vx[g][None], A, B, C,
                                 vd[g][None], dA, dB, dC, min_sep=1e-5)
        toi = jnp.where(_stack_masks(nx, ny, offs), toi, 1.0)
        alpha = jnp.minimum(alpha, 0.9 * jnp.min(toi))
    return alpha


def classify_window_residue(sim: ClothSim, cw: ContactWindow,
                            cand: jax.Array):
    """Split the LBVH candidate set into window-covered pairs (handled
    in slice form) and an indexed RESIDUE of budget ``max_residue``.

    Returns ``(vid [K], tidx [K, 3], valid [K], overflow)`` — the
    overflow flag is True when live residue pairs exceed the budget
    (caller re-traces with a larger budget or radius)."""
    sten = sim.stencil
    if sten is None or sten.tri_starts is None:
        raise ValueError("window contact needs a grid stencil with "
                         "make_cloth_grid triangle ordering")
    N, C = cand.shape
    G = len(sten.grids)
    r = cw.radius
    # vertex -> (g, i, j): static concatenation over grids
    gv = jnp.concatenate([jnp.full((nx * ny,), g, jnp.int32)
                          for g, (_, nx, ny) in enumerate(sten.grids)])
    iv = jnp.concatenate([jnp.arange(nx * ny, dtype=jnp.int32) // ny
                          for _, nx, ny in sten.grids])
    jv = jnp.concatenate([jnp.arange(nx * ny, dtype=jnp.int32) % ny
                          for _, nx, ny in sten.grids])
    # candidate triangle -> (g', ci, cj)
    t = jnp.maximum(cand, 0)
    gt = jnp.zeros(cand.shape, jnp.int32)
    for k, ts in enumerate(sten.tri_starts[1:], 1):
        gt = jnp.where(t >= ts, k, gt)
    ci = jnp.zeros(cand.shape, jnp.int32)
    cj = jnp.zeros(cand.shape, jnp.int32)
    for k, (_, nx, ny) in enumerate(sten.grids):
        lk = (t - sten.tri_starts[k]) // 2
        ci = jnp.where(gt == k, lk // (ny - 1), ci)
        cj = jnp.where(gt == k, lk % (ny - 1), cj)
    shp = [s[1:] for s in sten.grids]
    pair_ok = np.array([[shp[g] == shp[gp] for gp in range(G)]
                        for g in range(G)])
    di = ci - iv[:, None]
    dj = cj - jv[:, None]
    par = t % 2
    own = gv[:, None] == gt
    incident = jnp.zeros(cand.shape, bool)
    for p_, combos in enumerate(_INCIDENT):
        for (ui, uj) in combos:
            incident = incident | ((par == p_) & (di == ui)
                                   & (dj == uj))
    covered = (jnp.asarray(pair_ok)[gv[:, None], gt]
               & (jnp.abs(di) <= r) & (jnp.abs(dj) <= r)
               & ~(own & incident))
    live = ((cand >= 0) & ~covered).reshape(-1)
    K = cw.max_residue
    perm = jnp.argsort(jnp.where(live, 0, 1).astype(jnp.int32),
                       stable=True)[:K]
    vid = (perm // C).astype(jnp.int32)
    tri = cand.reshape(-1)[perm]
    valid = live[perm]
    overflow = jnp.sum(live.astype(jnp.int32)) > K
    tidx = sim.tris[jnp.maximum(tri, 0)]
    return vid, tidx, valid, overflow


def _pair_contact_energy(sim: ClothSim, x, vid, tidx, valid):
    """Barrier energy over an explicit (vertex, triangle) pair list
    (the window residue)."""
    tv = x[tidx]                                        # [K, 3, 3]
    xv = x[vid]
    a, b, c = _sanitize_tri(valid[:, None], xv,
                            tv[:, 0], tv[:, 1], tv[:, 2])
    _, cl = point_triangle_closest(xv, a, b, c)
    diff = xv - cl
    d2 = jnp.sum(diff * diff, axis=-1)
    e = barrier(d2, sim.dhat * sim.dhat, sim.kappa)
    return jnp.sum(jnp.where(valid, e, 0.0))


def _pair_gn(sim: ClothSim, y, vid, tidx, valid):
    """GN-PSD data for a pair list in the ``contact_c`` layout consumed
    by apply_operator: (vid, tidx, bary, diff, bpp)."""
    tv = y[tidx]
    yv = y[vid]
    bary, cl = point_triangle_closest(yv, tv[:, 0], tv[:, 1], tv[:, 2])
    diff = yv - cl
    s = jnp.sum(diff * diff, axis=-1)
    bpp = jnp.where(valid, jnp.maximum(
        barrier_hess(s, sim.dhat * sim.dhat, sim.kappa), 0.0), 0.0)
    return (vid, tidx, jax.lax.stop_gradient(bary),
            jax.lax.stop_gradient(diff), bpp)


def _pair_ccd_alpha(sim: ClothSim, x, dx, vid, tidx, valid):
    v3 = valid[:, None]
    a, b, c = _sanitize_tri(v3, x[vid],
                            *(x[tidx[:, k]] for k in range(3)))
    da, db, dc = (jnp.where(v3, dx[tidx[:, k]], 0.0) for k in range(3))
    toi = point_triangle_ccd(x[vid], a, b, c, dx[vid], da, db, dc,
                             min_sep=1e-5)
    toi = jnp.where(valid, toi, 1.0)
    return jnp.minimum(1.0, 0.9 * jnp.min(toi))


def _self_contact_alpha(sim: ClothSim, x, dx, cand):
    """CCD step limit over the candidate set (ccd_tight lineage via
    point_triangle_ccd's conservative advancement)."""
    valid = cand >= 0
    tidx = sim.tris[jnp.maximum(cand, 0)]               # [N, C, 3]
    a, b, c = (x[tidx[..., k]] for k in range(3))
    da, db, dc = (dx[tidx[..., k]] for k in range(3))
    toi = point_triangle_ccd(x[:, None, :], a, b, c,
                             dx[:, None, :], da, db, dc,
                             min_sep=1e-5)
    toi = jnp.where(valid, toi, 1.0)
    return jnp.minimum(1.0, 0.9 * jnp.min(toi))


def assemble_operator(sim: ClothSim, y: jax.Array, x: jax.Array, dt,
                      *, cand=None, lam=None, contact_budget=None,
                      window=None, window_res=None):
    """Cache per-element Gauss-Newton(-PSD) Hessian data at ``y``, ONCE
    per Newton iteration (round 4).

    The round-3 solver evaluated a full ``jvp``-of-grad per CG
    iteration — ~50 autodiff energy/HVP sweeps per step.  Every term of the incremental potential
    has a standard assembled form whose CG-side application is a few
    batched gathers/3-vector ops/scatter-adds:

    * stretch (exact, PSD-clamped): per-edge ``k [d d^T + (1 - L/l)
      (I - d d^T)]`` stored as the unit edge + two scalars (the
      compression clamp is the standard spring PSD projection);
    * bending (GN): ``E''(theta) grad-theta grad-theta^T`` with the
      12-vector ``grad theta`` from one batched autodiff at assembly —
      exact at the rest angle where ``E' = 0``;
    * ground barrier (exact, clamped): ``(2 b' + 4 d^2 b'') n n^T``;
    * lagged friction (standard IPC PSD form): ``mu lam f1(|u|)/|u|``
      on the tangent plane (Friction.hpp's ``f1_SF_div_relDXNorm``);
    * self-contact (GN-PSD, frozen barycentric weights): ``b''(s)
      grad-s grad-s^T`` with ``grad s = 2 (c kron diff)``, the
      ``b' * hess s`` term dropped (negative semi-definite, since
      ``b' < 0`` and ``hess s`` is PSD) — the same projection
      contact_implicit.py uses in the MPM coupling.

    Returns an operator pytree consumed by :func:`apply_operator`; its
    ``diag [N, 3]`` is the exact diagonal of the assembled operator and
    serves as the Jacobi preconditioner (anisotropic, supersedes the
    round-3 analytic guess).  The Newton GRADIENT stays exact autodiff,
    so converged states are unchanged; only the search direction uses
    the PSD model (the universal IPC practice — the exact projected
    Hessian is what the reference's downstream codim solver builds).

    ``contact_budget`` (round 4, active-set compaction): an ablation
    showed the CG apply is indexed-ROW-rate bound (chosen before the move to the GPU; not re-measured on the H100) and the
    self-contact term holds most of the rows (4 x N x C
    per apply).  With a budget K, the live (``bpp > 0``) rows are
    compacted ONCE at assembly (stable sort over the liveness mask)
    and the apply touches 4 x K rows instead — bit-equivalent up to
    f32 summation order, since dropped rows have ``bpp == 0`` exactly.
    This decouples apply cost from the CANDIDATE budget; its winning
    regime is live-SPARSE states (draping, glancing/early contact)
    where ``max_cand`` is sized for the worst vertex but few barriers
    are active.  Resting contact with ``dhat ~ spacing`` is live-DENSE
    (69% of slots live in the two-layer bench), where only a covering
    budget is legitimate and the win is small.  ``act_ovf`` in the returned
    operator is True when live rows exceeded K (the standard overflow
    contract: caller re-traces with a larger budget; padding rows
    carry ``bpp = 0`` so a clipped apply stays PSD — it under-models
    contact stiffness, never corrupts it).
    """
    dt = jnp.asarray(dt, y.dtype)
    n_hat = sim.ground_n
    coef_h = 2.0 * sim.k_bend                    # E = k (theta-rest)^2
    if sim.stencil is not None:
        # slice-form stretch/bend element data + diagonal (round 4):
        # per-family (ed, coef_b) and gth patches, diag accumulated on
        # per-grid [nx, ny, 3] blocks — zero indexed rows
        sten = sim.stencil
        views = _grid_views(sten, y)
        s_fam, b_fam, dblk = [], [], []
        for g, (_, nx, ny) in enumerate(sten.grids):
            Y = views[g]
            Dg = jnp.zeros((nx, ny, 3), y.dtype)
            for f, (s0, s1) in enumerate(_stretch_slices(nx, ny)):
                d = Y[s0] - Y[s1]
                l = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-20)
                ed_f = d / l[..., None]
                cb = sim.k_stretch * jnp.maximum(
                    0.0, 1.0 - sten.rest_len[3 * g + f] / l)
                s_fam.append((ed_f, cb))
                ds = (cb[..., None]
                      + (sim.k_stretch - cb)[..., None] * ed_f * ed_f)
                Dg = Dg.at[s0].add(ds).at[s1].add(ds)
            for f, sl in enumerate(_bend_slices(nx, ny)):
                gth_f = dihedral_angle_gradient(
                    Y[sl[0]], Y[sl[1]], Y[sl[2]], Y[sl[3]]
                ).reshape(Y[sl[0]].shape[:2] + (4, 3))
                b_fam.append(gth_f)
                dv = coef_h * gth_f * gth_f
                for k in range(4):
                    Dg = Dg.at[sl[k]].add(dv[:, :, k, :])
            dblk.append(Dg.reshape(-1, 3))
        sten_op = (tuple(s_fam), tuple(b_fam))
        diag_elastic = jnp.concatenate(dblk, axis=0)
        ed = coef_a = coef_b = gth = None
    else:
        sten_op = None
        e0, e1 = sim.edges[:, 0], sim.edges[:, 1]
        d = y[e0] - y[e1]
        l = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-20)
        ed = d / l[:, None]
        coef_a = jnp.broadcast_to(sim.k_stretch, l.shape)
        coef_b = sim.k_stretch * jnp.maximum(0.0, 1.0 - sim.rest_len / l)

        gth = dihedral_angle_gradient(
            y[sim.hinges[:, 0]], y[sim.hinges[:, 1]],
            y[sim.hinges[:, 2]], y[sim.hinges[:, 3]]).reshape(-1, 4, 3)

    gap = y @ n_hat - sim.ground_off
    g2 = gap * gap
    d2h = sim.dhat * sim.dhat
    curv = jnp.maximum(
        2.0 * barrier_grad(g2, d2h, sim.kappa)
        + 4.0 * g2 * barrier_hess(g2, d2h, sim.kappa), 0.0)

    if lam is not None:
        u = (y - x) - ((y - x) @ n_hat)[:, None] * n_hat[None, :]
        un = jnp.sqrt(jnp.sum(u * u, axis=-1) + 1e-18)
        fr_c = sim.mu * lam * friction_f1_over_x(un, sim.epsv * dt)
    else:
        fr_c = jnp.zeros(y.shape[:1], y.dtype)

    if cand is not None:
        tidx = sim.tris[jnp.maximum(cand, 0)]     # [N, C, 3]
        tv = y[tidx]                              # [N, C, 3, 3]
        bary, cl = point_triangle_closest(y[:, None, :], tv[:, :, 0],
                                          tv[:, :, 1], tv[:, :, 2])
        diff = y[:, None, :] - cl                 # [N, C, 3]
        s = jnp.sum(diff * diff, axis=-1)
        bpp = jnp.maximum(barrier_hess(s, d2h, sim.kappa), 0.0)
        bpp = jnp.where(cand >= 0, bpp, 0.0)
        bary = jax.lax.stop_gradient(bary)
        diff = jax.lax.stop_gradient(diff)
        contact = (tidx, bary, diff, bpp)
    else:
        contact = None

    win = None
    if window is not None:
        # window-stencil contact (round 4, see ContactWindow): in-
        # window pairs in slice form + indexed residue in contact_c
        # layout; mutually exclusive with the cand-based dense path
        win = (window, _window_gn(sim, window, y))

    contact_c = act_ovf = None
    if window_res is not None:
        contact_c = _pair_gn(sim, y, *window_res)
    if contact is not None and contact_budget is not None:
        # active-set compaction: stable-sort the [N*C] rows by liveness
        # and keep the first K.  Non-live rows carry bpp == 0 exactly,
        # so any non-live rows inside the budget are harmless padding.
        C = cand.shape[1]
        R = y.shape[0] * C
        live = (bpp > 0.0).reshape(R)
        perm = jnp.argsort(jnp.where(live, 0, 1).astype(jnp.int32),
                           stable=True)[:contact_budget]
        cvid = (perm // C).astype(jnp.int32)
        contact_c = (cvid, tidx.reshape(R, 3)[perm],
                     bary.reshape(R, 3)[perm], diff.reshape(R, 3)[perm],
                     bpp.reshape(R)[perm])
        act_ovf = jnp.sum(live.astype(jnp.int32)) > contact_budget

    # exact diagonal of the assembled operator -> Jacobi preconditioner
    N = y.shape[0]
    diag = (sim.mass / (dt * dt))[:, None] * jnp.ones((1, 3), y.dtype)
    if sten_op is not None:
        diag = diag + diag_elastic
    else:
        ds = (coef_b[:, None] + (coef_a - coef_b)[:, None] * ed * ed)
        diag = diag.at[e0].add(ds).at[e1].add(ds)
        diag = diag.at[sim.hinges.reshape(-1)].add(
            (coef_h * gth * gth).reshape(-1, 3))
    diag = diag + curv[:, None] * (n_hat * n_hat)[None, :]
    diag = diag + fr_c[:, None] * (1.0 - n_hat * n_hat)[None, :]
    if contact is not None:
        tidx, bary, diff, bpp = contact
        dv = 4.0 * bpp[..., None] * diff * diff            # [N, C, 3]
        diag = diag + jnp.sum(dv, axis=1)
        dtk = (4.0 * bpp[..., None, None] * (bary * bary)[..., None]
               * (diff * diff)[:, :, None, :])             # [N, C, 3, 3]
        diag = diag.at[tidx.reshape(-1)].add(dtk.reshape(-1, 3))
    if win is not None:
        diag = diag + _window_diag(sim, win[0], win[1])
    if window_res is not None:
        cvid_r, tidx_r, bary_r, diff_r, bpp_r = contact_c
        dv_r = 4.0 * bpp_r[:, None] * diff_r * diff_r      # [K, 3]
        diag = diag.at[cvid_r].add(dv_r)
        dtk_r = ((bary_r * bary_r)[..., None]
                 * dv_r[:, None, :])                       # [K, 3, 3]
        diag = diag.at[tidx_r.reshape(-1)].add(dtk_r.reshape(-1, 3))
    return dict(ed=ed, coef_a=coef_a, coef_b=coef_b, gth=gth,
                coef_h=coef_h, curv=curv, fr_c=fr_c, sten=sten_op,
                win=win,
                contact=None if contact_c is not None else contact,
                contact_c=contact_c, act_ovf=act_ovf, diag=diag)


def apply_operator(sim: ClothSim, op, p: jax.Array, dt) -> jax.Array:
    """Apply the assembled GN operator (see :func:`assemble_operator`):
    a handful of batched gathers, 3-vector arithmetic, and scatter-adds
    — no autodiff in the CG loop."""
    dt = jnp.asarray(dt, p.dtype)
    n_hat = sim.ground_n
    q = (sim.mass / (dt * dt))[:, None] * p
    if op.get("sten") is not None:
        # slice-form stretch/bend (round 4): pure slicing + fma on the
        # per-grid [nx, ny, 3] views — ZERO indexed rows (the indexed-
        # row rate bounds the apply)
        sten = sim.stencil
        s_fam, b_fam = op["sten"]
        views = _grid_views(sten, p)
        qblk, fi, bi = [], 0, 0
        for g, (_, nx, ny) in enumerate(sten.grids):
            P = views[g]
            Qg = jnp.zeros((nx, ny, 3), p.dtype)
            for s0, s1 in _stretch_slices(nx, ny):
                ed_f, cb = s_fam[fi]
                fi += 1
                u = P[s0] - P[s1]
                du = jnp.sum(ed_f * u, axis=-1)
                f = (cb[..., None] * u
                     + ((sim.k_stretch - cb) * du)[..., None] * ed_f)
                Qg = Qg.at[s0].add(f).at[s1].add(-f)
            for sl in _bend_slices(nx, ny):
                gth_f = b_fam[bi]
                bi += 1
                ph = jnp.stack([P[sl[k]] for k in range(4)], axis=2)
                w = jnp.sum(gth_f * ph, axis=(-1, -2))
                hv = (op["coef_h"] * w)[..., None, None] * gth_f
                for k in range(4):
                    Qg = Qg.at[sl[k]].add(hv[:, :, k, :])
            qblk.append(Qg.reshape(-1, 3))
        q = q + jnp.concatenate(qblk, axis=0)
    else:
        e0, e1 = sim.edges[:, 0], sim.edges[:, 1]
        u = p[e0] - p[e1]
        du = jnp.sum(op["ed"] * u, axis=-1)
        f = (op["coef_b"][:, None] * u
             + ((op["coef_a"] - op["coef_b"]) * du)[:, None] * op["ed"])
        ph = p[sim.hinges]                        # [H, 4, 3]
        w = jnp.sum(op["gth"] * ph, axis=(-1, -2))
        hv = ((op["coef_h"] * w)[:, None, None]
              * op["gth"]).reshape(-1, 3)
        if sim.edge_inc is not None and sim.hinge_inc is not None:
            # scatter-free transpose (round 4): bounded row-gathers via
            # the static incidence tables — scatter-adds with
            # duplicate indices serialize
            ft = jnp.concatenate([f, -f], axis=0)  # [2E, 3]
            gi = sim.edge_inc
            q = q + jnp.sum(jnp.where((gi >= 0)[..., None],
                                      ft[jnp.maximum(gi, 0)], 0.0),
                            axis=1)
            gj = sim.hinge_inc
            q = q + jnp.sum(jnp.where((gj >= 0)[..., None],
                                      hv[jnp.maximum(gj, 0)], 0.0),
                            axis=1)
        else:
            q = q.at[e0].add(f).at[e1].add(-f)
            q = q.at[sim.hinges.reshape(-1)].add(hv)
    pn = p @ n_hat
    q = q + (op["curv"] * pn)[:, None] * n_hat[None, :]
    q = q + op["fr_c"][:, None] * (p - pn[:, None] * n_hat[None, :])
    if op.get("win") is not None:
        # window-stencil contact (round 4): slice form, zero indexed
        # rows; the indexed residue (if any) rides contact_c below
        cw, wdata = op["win"]
        q = q + _window_apply(sim, cw, wdata, p)
    if op.get("contact_c") is not None:
        # compacted active set (round 4): 4K indexed rows per apply
        # instead of 4NC — see assemble_operator(contact_budget=...)
        cvid, tidx, bary, diff, bpp = op["contact_c"]
        pt = p[tidx]                              # [K, 3, 3]
        rel = p[cvid] - jnp.sum(bary[..., None] * pt, axis=1)
        dots = 2.0 * jnp.sum(diff * rel, axis=-1)            # grad s . p
        coef = bpp * dots                                    # [K]
        q = q.at[cvid].add(2.0 * coef[:, None] * diff)
        ct = (-2.0 * coef[:, None, None] * bary[:, :, None]
              * diff[:, None, :])                            # [K, 3, 3]
        q = q.at[tidx.reshape(-1)].add(ct.reshape(-1, 3))
    elif op["contact"] is not None:
        tidx, bary, diff, bpp = op["contact"]
        pt = p[tidx]                              # [N, C, 3, 3]
        rel = p[:, None, :] - jnp.sum(bary[..., None] * pt, axis=2)
        dots = 2.0 * jnp.sum(diff * rel, axis=-1)            # grad s . p
        coef = bpp * dots                                    # [N, C]
        q = q + jnp.sum(2.0 * coef[..., None] * diff, axis=1)
        ct = (-2.0 * coef[..., None, None] * bary[..., None]
              * diff[:, :, None, :])                         # [N, C, 3, 3]
        q = q.at[tidx.reshape(-1)].add(ct.reshape(-1, 3))
    return q


def implicit_step(sim: ClothSim, x: jax.Array, v: jax.Array,
                  dt, *, newton_iters: int = 2,
                  cg_iters: int = 40, self_contact: bool = False,
                  max_cand: int = 8, precondition: bool = True,
                  operator: str = "assembled",
                  contact_budget: Optional[int] = None,
                  contact_window: Optional[ContactWindow] = None):
    """One implicit-Euler step: minimize the incremental potential with
    ``newton_iters`` Newton-CG rounds; a half-space step limiter keeps
    iterates strictly outside the ground (IPC line-search analog,
    analytic for a plane).

    ``precondition`` (round 4): Jacobi-precondition the CG with an
    analytic lagged diagonal — mass/dt^2 + per-vertex stretch stiffness
    (k_stretch x incident-edge count) + the ground-barrier normal
    curvature.  The un-preconditioned solve is stiffness-dominated
    (k/m dt^2 >> 1 near contact), so this cuts CG iterations at equal
    tolerance rather than changing the converged step (reference
    contract: ``A.precondition`` in ConjugateGradient.hpp:61-70).

    ``operator`` (round 4): ``"assembled"`` (default) builds the
    GN-PSD element operator once per Newton iteration
    (:func:`assemble_operator`) so each CG iteration is a few batched
    gathers/scatters instead of a full ``jvp``-of-grad autodiff sweep
    — the round-3 cost model was ~50 autodiff evals/step.  With the
    assembled operator the Jacobi preconditioner is its exact
    anisotropic diagonal.  ``"autodiff"`` keeps the exact-Hessian HVP
    (the test oracle: the two agree exactly where GN is exact —
    tests/test_cloth.py).

    ``contact_budget`` (round 4): compact the self-contact rows of the
    assembled operator to the live active set (see
    :func:`assemble_operator`); the returned overflow flag then also
    covers active-set overflow (re-trace with a larger budget)."""
    dt = jnp.asarray(dt, x.dtype)
    free3 = sim.free[:, None]
    m3 = sim.mass[:, None]
    xhat = x + dt * v + (dt * dt) * sim.gravity[None, :]
    xhat = jnp.where(free3, xhat, x)

    if self_contact:
        # lagged candidate set: frozen over the step (standard IPC
        # practice), indices are non-differentiable
        cand, sc_ovf = self_contact_candidates(sim, x, max_cand)
        cand = jax.lax.stop_gradient(cand)
        wres = None
        if contact_window is not None:
            # window-stencil mode (round 4): the LBVH set certifies
            # completeness; out-of-window pairs become the indexed
            # residue, everything else runs in slice form
            res_vid, res_tidx, res_valid, r_ovf = \
                classify_window_residue(sim, contact_window, cand)
            wres = (jax.lax.stop_gradient(res_vid),
                    jax.lax.stop_gradient(res_tidx),
                    jax.lax.stop_gradient(res_valid))
            sc_ovf = sc_ovf | r_ovf

    # lagged IPC friction (Friction.hpp consumed here): normal force
    # magnitude from the START-of-step barrier (constant through the
    # solve), tangential displacement mollified by f0
    n = sim.ground_n
    gap0 = x @ n - sim.ground_off
    lam = jnp.maximum(0.0, -2.0 * gap0 * barrier_grad(
        gap0 * gap0, sim.dhat * sim.dhat, sim.kappa))
    lam = jax.lax.stop_gradient(lam)
    epsvh = sim.epsv * dt

    def friction_energy(y):
        u = (y - x) - ((y - x) @ n)[:, None] * n[None, :]
        un = jnp.sqrt(jnp.sum(u * u, axis=-1) + 1e-18)
        return jnp.sum(sim.mu * lam * friction_f0(un, epsvh))

    def phi_grad(y):
        def energy(z):
            e = cloth_energy(sim, z) + friction_energy(z)
            if self_contact:
                if contact_window is not None:
                    e = (e + window_contact_energy(
                            sim, contact_window, z)
                         + _pair_contact_energy(sim, z, *wres))
                else:
                    e = e + self_contact_energy(sim, z, cand)
            return e
        g = (m3 / (dt * dt)) * (y - xhat) + jax.grad(energy)(y)
        return jnp.where(free3, g, 0.0)

    def project(p):
        return jnp.where(free3, p, 0.0)

    M_pre = None
    if precondition and operator != "assembled":
        N = x.shape[0]
        deg = jnp.zeros((N,), x.dtype).at[sim.edges.reshape(-1)].add(1.0)
        g2 = gap0 * gap0
        d2h = sim.dhat * sim.dhat
        # barrier(d^2(y)) with d = n.y - off: Hessian = (2 b' + 4 d^2
        # b'') n n^T; clamp the (possibly indefinite) curvature at 0 so
        # the preconditioner stays SPD
        bpp = jax.grad(lambda s: jnp.sum(barrier_grad(
            s, d2h, sim.kappa)))(g2)
        curv = jnp.maximum(2.0 * barrier_grad(g2, d2h, sim.kappa)
                           + 4.0 * g2 * bpp, 0.0)
        diag = sim.mass / (dt * dt) + sim.k_stretch * deg + curv
        M_pre = lambda r: r / jax.lax.stop_gradient(diag)[:, None]

    y = x
    for _ in range(newton_iters):
        g = phi_grad(y)
        if operator == "assembled":
            win_mode = self_contact and contact_window is not None
            op = assemble_operator(
                sim, y, x, dt,
                cand=cand if self_contact and not win_mode else None,
                lam=lam,
                contact_budget=(contact_budget
                                if self_contact and not win_mode
                                else None),
                window=contact_window if win_mode else None,
                window_res=wres if win_mode else None)
            if self_contact and op["act_ovf"] is not None:
                sc_ovf = sc_ovf | op["act_ovf"]
            hvp = lambda p, _op=op: project(
                apply_operator(sim, _op, project(p), dt))
            pre = ((lambda r, _d=op["diag"]: r / _d)
                   if precondition else None)
        else:
            hvp = lambda p: project(
                jax.jvp(phi_grad, (y,), (project(p),))[1])
            pre = M_pre
        res = cg(hvp, -g, project=project, precondition=pre,
                 max_iters=cg_iters, rel_tol=1e-3)
        dx = project(res.x)
        # plane step limiter: keep gap(y + a dx) >= 0.1 * current gap
        gap = y @ sim.ground_n - sim.ground_off
        dgap = dx @ sim.ground_n
        closing = dgap < 0
        a_vert = jnp.where(closing,
                           0.9 * gap / jnp.maximum(-dgap, 1e-30), 1.0)
        alpha = jnp.minimum(1.0, jnp.min(jnp.where(sim.free, a_vert,
                                                   jnp.inf)))
        if self_contact:
            if contact_window is not None:
                alpha = jnp.minimum(alpha, _window_ccd_alpha(
                    sim, contact_window, y, dx))
                alpha = jnp.minimum(alpha, _pair_ccd_alpha(
                    sim, y, dx, *wres))
            else:
                alpha = jnp.minimum(
                    alpha, _self_contact_alpha(sim, y, dx, cand))
        y = y + alpha * dx
    v_new = jnp.where(free3, (y - x) / dt, 0.0)
    if self_contact:
        return y, v_new, sc_ovf
    return y, v_new
