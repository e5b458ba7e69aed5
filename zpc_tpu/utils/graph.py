"""Graph algorithms (reference §2.9 ``graph/``).

* connected components — reference: parallel union-find over SparseMatrix
  topology (``graph/ConnectedComponents.hpp:7-65``).  Here: label propagation
  with **pointer jumping** (min-label hooking + path doubling) — converges in
  O(log n) semiring SpMV rounds, no atomics.
* greedy graph coloring with random priorities (``graph/Coloring.hpp:8-92``,
  Gauss-Seidel ordering helper).  Here: Luby/Jones-Plassmann rounds inside a
  ``lax.while_loop``.
* max flow (``graph/MaximumFlow.hpp:13-96``, BFS augmentation).  Here:
  Edmonds-Karp with a frontier BFS as masked semiring SpMV rounds — bounded
  loops, dense frontier masks.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..math.sparse import CSRMatrix, spmv_semiring

__all__ = ["connected_components", "greedy_color", "max_flow"]


def connected_components(A: CSRMatrix, max_rounds: Optional[int] = None
                         ) -> jax.Array:
    """Component label (min vertex id in component) per vertex.

    Label propagation: L <- min(L, min-neighbor L) followed by pointer
    jumping L <- L[L]; O(log n) rounds.
    """
    import math

    n = A.nrows
    rounds = max_rounds or (int(math.ceil(math.log2(max(n, 2)))) + 2)
    ones_vals = jnp.ones_like(A.vals)
    Aone = CSRMatrix(A.indptr, A.cols, ones_vals, A.nnz, A.nrows, A.ncols)

    def body(_, L):
        neigh = spmv_semiring(Aone, L.astype(jnp.float32), "min_times")
        neigh = jnp.where(jnp.isfinite(neigh), neigh, jnp.inf)
        L2 = jnp.minimum(L, neigh.astype(L.dtype))
        # pointer jumping
        L2 = jnp.minimum(L2, L2[jnp.clip(L2, 0, n - 1)])
        return L2

    L0 = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.fori_loop(0, rounds, body, L0)


def greedy_color(A: CSRMatrix, seed: int = 0, max_colors: int = 64
                 ) -> jax.Array:
    """Jones-Plassmann style coloring: rounds of 'local max priority picks
    the smallest color unused by colored neighbors' (Coloring.hpp random
    -priority idiom).  Returns color id per vertex (0-based)."""
    n = A.nrows
    key = jax.random.PRNGKey(seed)
    prio = jax.random.uniform(key, (n,))
    rid = A.row_ids
    cols = jnp.maximum(A.cols, 0)
    valid_e = A.cols >= 0
    colors = jnp.full((n,), -1, jnp.int32)

    def round_body(state):
        colors, it = state
        uncol = colors < 0
        # neighbor max priority among uncolored
        pn = jnp.where(valid_e & uncol[cols], prio[cols], -1.0)
        nmax = jnp.full((n + 1,), -1.0).at[
            jnp.where(valid_e, rid, n)].max(pn)[:n]
        winner = uncol & (prio > nmax)
        # smallest color unused by colored neighbors: segment one-hot OR
        ccol = jnp.clip(colors[cols], 0, 31)
        seg = jnp.where(valid_e, rid, n)
        taken = jnp.zeros((n + 1, 32), bool).at[seg, ccol].max(
            valid_e & (colors[cols] >= 0))[:n]
        first_free = jnp.argmin(taken.astype(jnp.int32), axis=1)
        colors = jnp.where(winner, first_free.astype(jnp.int32), colors)
        return colors, it + 1

    def cond(state):
        colors, it = state
        return jnp.any(colors < 0) & (it < max_colors)

    colors, _ = jax.lax.while_loop(cond, round_body, (colors, jnp.int32(0)))
    return colors


def max_flow(A_cap: CSRMatrix, source: int, sink: int,
             max_aug: Optional[int] = None) -> jax.Array:
    """Edmonds-Karp max flow on a capacity matrix (dense residual form for
    moderate n — the reference's BFS-augmentation algorithm class,
    MaximumFlow.hpp:13-96).
    """
    n = A_cap.nrows
    C = A_cap.todense()
    R0 = C  # residual
    max_aug = max_aug or (n * 4)

    def bfs_parents(R):
        INF = jnp.int32(n + 1)
        dist = jnp.full((n,), INF).at[source].set(0)
        parent = jnp.full((n,), -1, jnp.int32).at[source].set(source)

        def body(_, dp):
            dist, parent = dp
            reach = dist < INF
            # relax: for edge u->v with residual>0 and u reached, v unreached
            cand = reach[:, None] & (R > 1e-9) & ~reach[None, :]
            # choose any predecessor: argmax over u
            has = jnp.any(cand, axis=0)
            pred = jnp.argmax(cand, axis=0).astype(jnp.int32)
            parent = jnp.where(has & (parent < 0), pred, parent)
            dist = jnp.where(has & (dist == INF),
                             jnp.min(jnp.where(cand, dist[:, None] + 1, INF),
                                     axis=0), dist)
            return dist, parent

        dist, parent = jax.lax.fori_loop(0, n, body, (dist, parent))
        return parent

    def aug_body(state):
        R, flow, it, alive = state
        parent = bfs_parents(R)
        found = parent[sink] >= 0

        # walk back from sink collecting bottleneck (bounded loop)
        def walk(carry, _):
            v, bott = carry
            u = parent[jnp.maximum(v, 0)]
            cap = R[u, jnp.maximum(v, 0)]
            active = (v != source) & (v >= 0)
            bott = jnp.where(active, jnp.minimum(bott, cap), bott)
            v = jnp.where(active, u, v)
            return (v, bott), None

        (_, bottleneck), _ = jax.lax.scan(
            walk, (jnp.int32(sink), jnp.asarray(jnp.inf, R.dtype)),
            None, length=n)
        bottleneck = jnp.where(found, bottleneck, 0.0)

        def upd(carry, _):
            v, R = carry
            u = parent[jnp.maximum(v, 0)]
            active = (v != source) & (v >= 0)
            vv = jnp.maximum(v, 0)
            R = jnp.where(active,
                          R.at[u, vv].add(-bottleneck)
                           .at[vv, u].add(bottleneck), R)
            v = jnp.where(active, u, v)
            return (v, R), None

        (_, R), _ = jax.lax.scan(upd, (jnp.int32(sink), R), None, length=n)
        return R, flow + bottleneck, it + 1, found

    def cond(state):
        _, _, it, alive = state
        return alive & (it < max_aug)

    _, flow, _, _ = jax.lax.while_loop(
        cond, aug_body, (R0, jnp.asarray(0.0, R0.dtype), jnp.int32(0),
                         jnp.bool_(True)))
    return flow
