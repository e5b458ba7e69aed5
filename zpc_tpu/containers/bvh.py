"""Linear BVH (LBVH) — GPU-style broad-phase.

Reference: ``container/Bvh.hpp`` — Karras-2012 build (morton codes :184,
radix sort, split-prefix topology :198-338 with ``clz`` :346, ordered
reorder :304-338, bottom-up refit with atomic arrival flags :467) and
stackless traversal queries (``iter_neighbors`` :662-733, ``find_nearest``
:551-621, ``ray_intersect`` :526-543); plus ``BvttFront`` pair caching
(container/Bvtt.hpp).

Re-design:

* **Build** is fully vectorized: morton quantization -> ``lax.sort`` ->
  Karras split computation *per internal node in parallel* (pure integer
  math, no per-thread loops beyond two bounded ``while_loop`` binary
  searches) -> **levelwise refit**: instead of atomic arrival flags, refit
  iterates ``ceil(log2(n))`` rounds updating every internal node from its
  children each round (converges bottom-up deterministically; O(n log n)
  work but bandwidth-trivial vs the queries it serves).
* **Escape-index ("rope") traversal**: queries use the classic stackless
  scheme — each node stores the node to jump to when skipping its subtree;
  traversal is a bounded ``lax.while_loop`` with pure gathers, batched over
  query boxes by ``vmap``.
* Primitive count is static (padded); inactive leaves carry inverted boxes
  that fail every overlap test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..math.bits import morton3d, common_prefix_length

__all__ = ["LBvh", "build_lbvh", "build_lbvh_complete",
           "query_overlaps",
           "query_overlaps_sorted", "query_nearest", "query_nearest_sorted", "query_ray",
           "aabb_overlap", "BvttFront"]


def aabb_overlap(lo_a, hi_a, lo_b, hi_b):
    return jnp.all(lo_a <= hi_b, -1) & jnp.all(lo_b <= hi_a, -1)


def _rank_sorted(codes, vals, side: str):
    """``searchsorted(codes, vals, side)`` for SORTED ``vals``: one
    packed merge sort + cumsum + compaction scatter.

    ``jnp.searchsorted`` is a chain of dependent gathers (a binary search);
    both arrays here are already sorted, so the ranks come from a single
    2M-element 1-op sort of ``(value << 1) | origin-tag`` — u32 so the
    int32-max invalid-leaf sentinel survives the shift; bit-exact vs
    searchsorted (chosen before the move to the GPU; not re-measured on the
    H100).
    """
    m = vals.shape[0]
    tq = jnp.uint32(0 if side == "left" else 1)
    packed = jnp.concatenate([
        (codes.astype(jnp.uint32) << 1) | (jnp.uint32(1) - tq),
        (vals.astype(jnp.uint32) << 1) | tq])
    sp = jax.lax.sort(packed, is_stable=False)
    isq = (sp & 1) == tq
    iscode = (~isq).astype(jnp.int32)
    before = jnp.cumsum(iscode) - iscode        # codes strictly before
    qrank = jnp.cumsum(isq.astype(jnp.int32)) - 1
    return jnp.zeros((m,), jnp.int32).at[
        jnp.where(isq, qrank, m)].set(before, mode="drop")


def _rank_any(codes, vals, side: str):
    """``searchsorted(codes, vals, side)`` for vals in ANY order: the
    same packed merge with the original index carried as the sort
    payload (one 2-op sort instead of :func:`_rank_sorted`'s 1-op)."""
    n = codes.shape[0]
    m = vals.shape[0]
    tq = jnp.uint32(0 if side == "left" else 1)
    packed = jnp.concatenate([
        (codes.astype(jnp.uint32) << 1) | (jnp.uint32(1) - tq),
        (vals.astype(jnp.uint32) << 1) | tq])
    idx = jnp.concatenate([jnp.full((n,), m, jnp.int32),
                           jnp.arange(m, dtype=jnp.int32)])
    sp, si = jax.lax.sort((packed, idx), num_keys=1, is_stable=False)
    iscode = ((sp & 1) != tq).astype(jnp.int32)
    before = jnp.cumsum(iscode) - iscode
    return jnp.zeros((m,), jnp.int32).at[si].set(before, mode="drop")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LBvh:
    """n leaves (primitives, sorted by morton), n-1 internal nodes.

    Node ids: internal nodes [0, n-1), leaves [n-1, 2n-1) (leaf i of the
    sorted order = node n-1+i).  ``escape`` is the stackless skip pointer in
    a preorder-equivalent traversal; -1 terminates.

    ``codes``/``scene_lo``/``scene_extent``/``half_max`` record the morton
    quantization so queries can reuse it (sorted banded join,
    :func:`query_overlaps_sorted`).
    """

    lo: jax.Array        # [2n-1, dim] node box min
    hi: jax.Array        # [2n-1, dim] node box max
    left: jax.Array      # [2n-1] left child (-1 for leaves)
    right: jax.Array     # [2n-1] right child
    escape: jax.Array    # [2n-1] skip pointer
    leaf_prim: jax.Array  # [2n-1] original primitive id (-1 for internal)
    count: jax.Array     # active primitive count
    codes: jax.Array     # [n] sorted leaf morton codes
    scene_lo: jax.Array      # [dim]
    scene_extent: jax.Array  # [dim]
    half_max: jax.Array      # [dim] max leaf half-extent

    @property
    def num_leaves(self) -> int:
        return (self.lo.shape[0] + 1) // 2


def _nse_dir_chunked(d: jax.Array, strict: bool, chunk: int = 8192):
    """One direction of the Karras NSE sweep, FUSED over all 63 values:
    nearest j < i with ``d[j] <= d[i]``
    (``strict=False``) or ``d[j] < d[i]`` (``strict=True``), as ONE
    ``lax.scan`` over position chunks carrying a 64-wide register of
    packed ``(pos << 6) | value`` bests.

    Per chunk the masked per-value positions form a [64, C] block whose axis-1
    cummax, 64-carry fold, and axis-0 value-prefix cummax all stay small — a
    batched [64, g] form is semantics-identical but materializes [64, g]
    intermediates in device memory and was slower than the 126-scan loop
    (chosen before the move to the GPU; not re-measured on the H100).
    Max-by-position wins ties by construction (positions are unique); the low 6
    bits recover the winner's d value, replacing the run_lv/run_rv carries.

    Returns packed int32 [g]: ``(pos << 6) | d[pos]`` of the nearest
    element, or a negative sentinel when none exists.
    """
    g = d.shape[0]
    C = min(chunk, _next_mult(g, 128))
    n_pad = -(-g // C) * C
    NONE = jnp.int32(-(1 << 30))
    dp = jnp.concatenate([d, jnp.zeros((n_pad - g,), d.dtype)])
    xs = dp.reshape(-1, C)
    offs = jnp.arange(xs.shape[0], dtype=jnp.int32) * C
    viota = jax.lax.broadcasted_iota(jnp.int32, (64, C), 0)

    def body(carry, inp):
        dc, off = inp
        pos = off + jnp.arange(C, dtype=jnp.int32)
        mask = viota == dc[None, :]
        packed = jnp.where(mask & (pos < g)[None, :],
                           (pos << 6) | dc[None, :], NONE)
        p = jax.lax.cummax(packed, axis=1)
        p_excl = jnp.concatenate(
            [jnp.full((64, 1), NONE, jnp.int32), p[:, :-1]], axis=1)
        full = jnp.maximum(p_excl, carry[:, None])
        f = jax.lax.cummax(full, axis=0)        # prefix over values
        w = dc - (1 if strict else 0)           # d >= 1 always
        sel = jnp.max(jnp.where(viota == w[None, :], f, NONE), axis=0)
        carry = jnp.maximum(carry, p[:, -1])
        return carry, sel

    _, sels = jax.lax.scan(body, jnp.full((64,), NONE, jnp.int32),
                           (xs, offs))
    return sels.reshape(-1)[:g]


def _next_mult(n, m):
    return -(-n // m) * m


def _karras_topology(codes: jax.Array):
    """Karras-2012 radix-tree topology as a min-Cartesian tree over the
    adjacent-gap delta array — vectorized nearest-smaller-element sweeps
    instead of per-node binary searches.

    The binary radix tree over n sorted augmented-unique keys is exactly
    the min-Cartesian tree of ``d[i] = cpl(key[i], key[i+1])`` on the
    n-1 gaps: internal node i splits at gap i, covers leaves
    ``[NSEl(i)+1, NSEr(i)]`` with NSEl = nearest j<i with d[j] <= d[i],
    NSEr = nearest j>i with d[j] < d[i] (leftmost-minimum-wins
    tie-break), and its parent is the deeper (larger-d) of the two NSE gaps
    (equal d: the right gap is the left one's descendant, so it is the deeper).
    ``d`` lives in a 65-value alphabet (cpl in [0,32], +32 index augmentation
    for duplicate codes), so both NSE sweeps are 65 masked cummax/cummin passes
    over [n] — no gathers, no binary searches.  It replaces the reference's
    per-thread doubling + binary searches (Bvh.hpp:198-338), which vectorize
    into ~67 dependent gather rounds (chosen before the move to the GPU; not
    re-measured on the H100).

    Returns (left, right, range_lo, range_hi) for the n-1 internal
    nodes, renumbered so the root is node 0 (query entry convention).
    """
    n = codes.shape[0]
    g = n - 1
    gi = jnp.arange(g, dtype=jnp.int32)
    d = common_prefix_length(codes[:-1], codes[1:]).astype(jnp.int32)
    same = codes[:-1] == codes[1:]
    d = jnp.where(same, 32 + common_prefix_length(gi, gi + 1).astype(
        jnp.int32), d)

    BIG = jnp.int32(1 << 30)
    none_l = jnp.full((g,), -1, jnp.int32)
    none_r = jnp.full((g,), BIG, jnp.int32)
    # d = 0 impossible (codes and the invalid sentinel are non-negative:
    # sign bits equal); d = 64 impossible (tie delta = 32 + cpl(i, i+1)
    # and adjacent indices always differ)
    if g >= 1024:
        # fused sweep: both directions over all 63 values in two
        # streaming chunk-scans (_nse_dir_chunked, oracle-pinned in
        # tests/test_bvh.py); the 126-scan loop below is the small-size
        # form
        sel_l = _nse_dir_chunked(d, False)
        nsel = jnp.where(sel_l < 0, -1, sel_l >> 6)
        dl = jnp.where(sel_l < 0, -1, sel_l & 63)
        sel_r = _nse_dir_chunked(d[::-1], True)[::-1]
        nser = jnp.where(sel_r < 0, BIG, g - 1 - (sel_r >> 6))
        dr = jnp.where(sel_r < 0, -1, sel_r & 63)
    else:
        # the 63-value sweep as 126 cumulative scans
        nsel, nser = none_l, none_r
        dl = jnp.full((g,), -1, jnp.int32)   # d at nsel (-1 = none)
        dr = jnp.full((g,), -1, jnp.int32)   # d at nser
        run_l, run_r = none_l, none_r    # best position so far over values
        run_lv = jnp.full((g,), -1, jnp.int32)  # d value at run_l / run_r
        run_rv = jnp.full((g,), -1, jnp.int32)
        for v in range(1, 64):
            eq = d == v
            # NSEr first: strict (u < d[i]) -> capture BEFORE folding in v
            nser = jnp.where(eq, run_r, nser)
            dr = jnp.where(eq, run_rv, dr)
            fp = jax.lax.cummin(jnp.where(eq, gi, BIG), reverse=True)
            fp_excl = jnp.concatenate([fp[1:], none_r[:1]])
            br = fp_excl < run_r
            run_rv = jnp.where(br, v, run_rv)
            run_r = jnp.where(br, fp_excl, run_r)
            # NSEl: non-strict (u <= d[i]) -> capture AFTER folding in v
            lp = jax.lax.cummax(jnp.where(eq, gi, -1))
            lp_excl = jnp.concatenate([none_l[:1], lp[:-1]])
            bl = lp_excl > run_l
            run_lv = jnp.where(bl, v, run_lv)
            run_l = jnp.where(bl, lp_excl, run_l)
            nsel = jnp.where(eq, run_l, nsel)
            dl = jnp.where(eq, run_lv, dl)

    rlo = nsel + 1
    rhi = jnp.minimum(nser, g)

    # parent gap: the deeper of (nsel, nser); ties -> the right one
    is_root = (dl < 0) & (dr < 0)
    par = jnp.where(dr >= dl, jnp.minimum(nser, jnp.int32(g - 1)),
                    jnp.maximum(nsel, 0))
    int_isl = par > gi                   # i sits in parent's left range

    # leaf j attaches under the deeper of gaps (j-1, j); ties -> gap j
    lj = jnp.arange(n, dtype=jnp.int32)
    d_rgt = jnp.concatenate([d, none_l[:1]])          # gap j  (right of j)
    d_lft = jnp.concatenate([none_l[:1], d])          # gap j-1 (left of j)
    leaf_par = jnp.where(d_rgt >= d_lft, lj, lj - 1)
    leaf_isl = d_rgt >= d_lft            # parent right of leaf -> left child

    ids = jnp.concatenate([gi, g + lj])  # internal gap ids, then leaf ids
    pars = jnp.concatenate([par, leaf_par])
    isl = jnp.concatenate([int_isl, leaf_isl])
    has_par = jnp.concatenate([~is_root, jnp.ones((n,), bool)])
    # children via ONE unstable 2-op sort instead of [2n-1]->[g] scatters
    # (chosen before the move to the GPU; not re-measured on the H100): every
    # internal node has exactly two children, so sorting by (parent*2 +
    # is_right) lays them out pairwise and left/right fall out as strided
    # slices
    ckey = jnp.where(has_par,
                     pars * 2 + jnp.where(isl, 0, 1).astype(jnp.int32),
                     jnp.int32(2 * g))       # the root sorts last
    _, child_sorted = jax.lax.sort((ckey, ids), num_keys=1,
                                   is_stable=False)
    left = child_sorted[0:2 * g:2]
    right = child_sorted[1:2 * g:2]

    # renumber so the root lands at node 0 (swap 0 <-> root everywhere)
    r = jnp.argmax(is_root).astype(jnp.int32)

    def swap_pos(a):
        a0, ar = a[0], a[r]
        return a.at[0].set(ar).at[r].set(a0)

    def remap_ids(x):
        # internal ids 0 and r trade places; leaves (>= g) and -1 pass
        zero = jnp.zeros_like(x)
        return jnp.where(x == 0, r, jnp.where(x == r, zero, x))

    left = remap_ids(swap_pos(left))
    right = remap_ids(swap_pos(right))
    rlo = swap_pos(rlo)
    rhi = swap_pos(rhi)
    return (left.astype(jnp.int32), right.astype(jnp.int32),
            rlo.astype(jnp.int32), rhi.astype(jnp.int32))


def build_lbvh(prim_lo: jax.Array, prim_hi: jax.Array,
               valid: Optional[jax.Array] = None) -> LBvh:
    """Build from primitive AABBs ``[n, 3]`` (Bvh.hpp ``build`` :176-338).

    jit-safe, static n.  Invalid primitives sort last and get inverted boxes.
    """
    n = prim_lo.shape[0]
    dim = prim_lo.shape[-1]
    if valid is None:
        valid = jnp.ones((n,), bool)
    count = jnp.sum(valid.astype(jnp.int32))
    big = jnp.asarray(3.4e38, prim_lo.dtype)
    # quantize centers to 10-bit morton within the scene box
    centers = 0.5 * (prim_lo + prim_hi)
    vlo = jnp.where(valid[:, None], prim_lo, big)
    vhi = jnp.where(valid[:, None], prim_hi, -big)
    scene_lo = jnp.min(vlo, 0)
    scene_hi = jnp.max(vhi, 0)
    # CUBIC quantization cells (round 5): per-axis normalization puts
    # 10 full morton bits on a degenerate axis — for a flat sheet the
    # thin axis becomes noise bits that destroy code locality, and any
    # query dilated past the thin extent quantizes to the WHOLE axis,
    # so its covering cells degenerate to the full domain (measured:
    # the cloth broad phase's primary cell spanned all leaves,
    # tests/test_cloth.py decomposed-completeness oracle).  One shared
    # scale keeps cells world-space cubes, the assumption every morton
    # consumer here (band, decompose, half_max dilation) is built on.
    extent = jnp.broadcast_to(
        jnp.max(jnp.maximum(scene_hi - scene_lo, 1e-12)),
        scene_lo.shape)
    q = jnp.clip(((centers - scene_lo) / extent * 1024.0), 0, 1023).astype(
        jnp.int32)
    codes = morton3d(q)
    codes = jnp.where(valid, codes,
                      jnp.asarray(np.iinfo(np.int32).max, jnp.int32))
    order = jnp.argsort(codes)  # stable; invalid go last
    codes_s = codes[order]

    half_max = 0.5 * jnp.max(jnp.where(valid[:, None],
                                       prim_hi - prim_lo, 0.0), axis=0)
    if n == 1:
        return LBvh(prim_lo, prim_hi,
                    jnp.full((1,), -1, jnp.int32),
                    jnp.full((1,), -1, jnp.int32),
                    jnp.full((1,), -1, jnp.int32),
                    jnp.zeros((1,), jnp.int32), count,
                    codes, scene_lo, extent, half_max)

    left, right, rlo, rhi = _karras_topology(codes_s)
    ninternal = n - 1
    total = 2 * n - 1

    # leaf boxes in sorted order; invalid leaves inverted
    leaf_lo = jnp.where(valid[order][:, None], prim_lo[order], big)
    leaf_hi = jnp.where(valid[order][:, None], prim_hi[order], -big)

    # Internal boxes by range-min/max queries over the sorted leaf boxes:
    # Karras gives every internal node its sorted-leaf range [rlo, rhi];
    # a sparse table (log2(n) strided-min rounds, slice ops only — no
    # gathers) answers all n-1 box unions with 2 gathers per node.  This
    # replaces the depth-bound levelwise refit (tree depth is bounded by the
    # augmented key length ~50, i.e. 50 gather rounds for skewed geometry).
    levels = int(np.ceil(np.log2(n))) + 1

    def sparse_table(base, combine, pad):
        tabs = [base]
        for k in range(1, levels):
            h = 1 << (k - 1)
            prev = tabs[-1]
            shifted = jnp.concatenate(
                [prev[h:], jnp.full((min(h, n),) + prev.shape[1:], pad,
                                    prev.dtype)])[:n]
            tabs.append(combine(prev, shifted))
        return jnp.stack(tabs)              # [levels, n, dim]

    tmin = sparse_table(leaf_lo, jnp.minimum, big)
    tmax = sparse_table(leaf_hi, jnp.maximum, -big)
    length = (rhi - rlo + 1).astype(jnp.int32)
    # k = floor(log2(length)) via clz
    from ..math.bits import clz32

    kk = 31 - clz32(length)
    pow2 = (jnp.int32(1) << kk)
    a = rlo
    b = rhi - pow2 + 1
    flat_min = tmin.reshape(levels * n, dim)
    flat_max = tmax.reshape(levels * n, dim)
    int_lo = jnp.minimum(flat_min[kk * n + a], flat_min[kk * n + b])
    int_hi = jnp.maximum(flat_max[kk * n + a], flat_max[kk * n + b])
    lo = jnp.concatenate([int_lo, leaf_lo])
    hi = jnp.concatenate([int_hi, leaf_hi])

    # escape pointers without pointer doubling: the skip target of a node
    # with sorted-leaf range [a, b] is the LARGEST node whose range starts
    # at b+1 (no node starting at b+1 can be an ancestor of [a, b]).  Two
    # scatter-max passes find that winner per start position — O(n), no
    # J = J[J] gather rounds (which dominated the old build).
    node_rlo = jnp.concatenate([rlo, jnp.arange(n, dtype=jnp.int32)])
    node_rhi = jnp.concatenate([rhi, jnp.arange(n, dtype=jnp.int32)])
    maxr = jnp.full((n,), -1, jnp.int32).at[node_rlo].max(node_rhi)
    idx_all = jnp.arange(total, dtype=jnp.int32)
    is_winner = node_rhi == maxr[node_rlo]
    winner = jnp.full((n,), -1, jnp.int32).at[
        jnp.where(is_winner, node_rlo, n - 1)].max(
        jnp.where(is_winner, idx_all, -1))
    nxt = node_rhi + 1
    escape = jnp.where(nxt < n, winner[jnp.minimum(nxt, n - 1)], -1)

    leftc = jnp.concatenate([left, jnp.full((n,), -1, jnp.int32)])
    rightc = jnp.concatenate([right, jnp.full((n,), -1, jnp.int32)])
    leaf_prim = jnp.concatenate([
        jnp.full((ninternal,), -1, jnp.int32),
        jnp.where(valid[order], order, -1).astype(jnp.int32)])
    return LBvh(lo, hi, leftc, rightc, escape, leaf_prim, count,
                codes_s, scene_lo, extent, half_max)


def build_lbvh_complete(prim_lo: jax.Array, prim_hi: jax.Array,
                        valid: Optional[jax.Array] = None) -> LBvh:
    """Gather-free LBVH: implicit complete binary tree over the sorted
    morton order.

    The Karras topology needs ~67 dynamic-index passes over the code
    array (doubling + two binary searches, each a gather).  A complete
    tree over the same sorted leaf
    order replaces ALL of it with arithmetic: heap numbering (node i →
    children 2i+1, 2i+2) lands leaves exactly on the LBvh convention
    [m-1, 2m-1), escape pointers come from log2(m) rounds of pure vector
    parent-chasing, and internal boxes are pairwise reshape-reductions.
    Build cost ≈ one radix sort + 2 passes over the boxes.

    Trade-off vs Karras: subtree ranges are fixed powers of two instead
    of adapting to morton-code splits, so clustered scenes test somewhat
    more boxes per query.  Same LBvh type; every query path works
    unchanged.  Leaf count is padded to a power of two (invalid leaves
    carry inverted boxes).
    """
    n = prim_lo.shape[0]
    dim = prim_lo.shape[-1]
    if valid is None:
        valid = jnp.ones((n,), bool)
    m = 1 << int(np.ceil(np.log2(max(n, 2))))
    count = jnp.sum(valid.astype(jnp.int32))
    big = jnp.asarray(3.4e38, prim_lo.dtype)
    centers = 0.5 * (prim_lo + prim_hi)
    vlo = jnp.where(valid[:, None], prim_lo, big)
    vhi = jnp.where(valid[:, None], prim_hi, -big)
    scene_lo = jnp.min(vlo, 0)
    scene_hi = jnp.max(vhi, 0)
    # CUBIC quantization cells (round 5): per-axis normalization puts
    # 10 full morton bits on a degenerate axis — for a flat sheet the
    # thin axis becomes noise bits that destroy code locality, and any
    # query dilated past the thin extent quantizes to the WHOLE axis,
    # so its covering cells degenerate to the full domain (measured:
    # the cloth broad phase's primary cell spanned all leaves,
    # tests/test_cloth.py decomposed-completeness oracle).  One shared
    # scale keeps cells world-space cubes, the assumption every morton
    # consumer here (band, decompose, half_max dilation) is built on.
    extent = jnp.broadcast_to(
        jnp.max(jnp.maximum(scene_hi - scene_lo, 1e-12)),
        scene_lo.shape)
    q = jnp.clip(((centers - scene_lo) / extent * 1024.0), 0, 1023).astype(
        jnp.int32)
    codes = morton3d(q)
    sentinel = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
    codes = jnp.where(valid, codes, sentinel)
    order = jnp.argsort(codes)
    codes_s = codes[order]
    half_max = 0.5 * jnp.max(jnp.where(valid[:, None],
                                       prim_hi - prim_lo, 0.0), axis=0)

    # padded sorted leaf boxes
    pad = m - n
    leaf_lo = jnp.where(valid[order][:, None], prim_lo[order], big)
    leaf_hi = jnp.where(valid[order][:, None], prim_hi[order], -big)
    if pad:
        leaf_lo = jnp.concatenate(
            [leaf_lo, jnp.full((pad, dim), big, prim_lo.dtype)])
        leaf_hi = jnp.concatenate(
            [leaf_hi, jnp.full((pad, dim), -big, prim_lo.dtype)])
        codes_s = jnp.concatenate(
            [codes_s, jnp.full((pad,), sentinel, jnp.int32)])

    # bottom-up pairwise unions; heap level ell occupies [2^ell-1, 2^(ell+1)-1)
    levels_lo, levels_hi = [leaf_lo], [leaf_hi]
    while levels_lo[-1].shape[0] > 1:
        ll = levels_lo[-1].reshape(-1, 2, dim)
        hh = levels_hi[-1].reshape(-1, 2, dim)
        levels_lo.append(jnp.min(ll, axis=1))
        levels_hi.append(jnp.max(hh, axis=1))
    lo = jnp.concatenate(levels_lo[::-1])          # [2m-1, dim]
    hi = jnp.concatenate(levels_hi[::-1])

    total = 2 * m - 1
    idx = jnp.arange(total, dtype=jnp.int32)
    is_leaf = idx >= m - 1
    left = jnp.where(is_leaf, -1, 2 * idx + 1)
    right = jnp.where(is_leaf, -1, 2 * idx + 2)

    # escape = right sibling of the deepest ancestor (or self) that is a
    # left child; -1 past the root.  log2(m)+1 rounds of vector math.
    esc = jnp.full((total,), -1, jnp.int32)
    cur = idx
    for _ in range(int(np.log2(m)) + 1):
        is_left = (cur > 0) & (cur % 2 == 1)
        esc = jnp.where((esc == -1) & is_left, cur + 1, esc)
        cur = jnp.where(cur > 0, (cur - 1) // 2, 0)

    leaf_prim = jnp.concatenate([
        jnp.full((m - 1,), -1, jnp.int32),
        jnp.where(valid[order], order, -1).astype(jnp.int32),
        jnp.full((pad,), -1, jnp.int32)])
    return LBvh(lo, hi, left, right, esc, leaf_prim, count,
                codes_s, scene_lo, extent, half_max)


def query_overlaps(bvh: LBvh, q_lo: jax.Array, q_hi: jax.Array,
                   max_hits: int, valid: Optional[jax.Array] = None
                   ) -> Tuple[jax.Array, jax.Array]:
    """AABB overlap query, batched over query boxes.

    Returns (hits [nq, max_hits] primitive ids (-1 padding), counts [nq]).
    Stackless escape-pointer walk (Bvh.hpp iter_neighbors :662-733) inside a
    bounded ``while_loop``, vmapped across queries.

    This is the reference-shaped traversal and the correctness oracle
    for the banded-join paths; it is latency-bound (a dependent gather
    chain per query, all queries stepping in lockstep until the LAST
    finishes).  Round 4 packs the per-node fields into one [total, 8+dim]
    f32 row (node ids < 2^24 are f32-exact) so each step issues ONE
    contiguous row gather instead of five element gathers.  Production
    queries belong on :func:`query_overlaps_sorted`.
    """
    total = bvh.lo.shape[0]
    dim = q_lo.shape[-1]
    nq = q_lo.shape[0]
    if valid is None:
        valid = jnp.ones((nq,), bool)
    f32 = bvh.lo.dtype
    if total >= (1 << 24):
        raise ValueError(
            "query_overlaps packs node ids into f32 rows (exact below "
            "2^24 nodes); use query_overlaps_sorted for trees this big")
    packed = jnp.concatenate(
        [bvh.lo, bvh.hi,
         bvh.left.astype(f32)[:, None], bvh.escape.astype(f32)[:, None],
         bvh.leaf_prim.astype(f32)[:, None]], axis=1)    # [total, 2d+3]

    def one(qlo, qhi, qvalid):
        def cond(state):
            node, hits, cnt = state
            return node >= 0

        def body(state):
            node, hits, cnt = state
            row = packed[node]
            nlo, nhi = row[:dim], row[dim:2 * dim]
            left = row[2 * dim].astype(jnp.int32)
            esc = row[2 * dim + 1].astype(jnp.int32)
            prim = row[2 * dim + 2].astype(jnp.int32)
            overlap = aabb_overlap(nlo, nhi, qlo, qhi) & qvalid
            is_leaf = left < 0
            record = overlap & is_leaf & (prim >= 0)
            hits = jnp.where(record & (cnt < max_hits),
                             hits.at[jnp.minimum(cnt, max_hits - 1)].set(prim),
                             hits)
            cnt = cnt + record.astype(jnp.int32)
            # descend if internal & overlapping, else escape
            nxt = jnp.where(overlap & ~is_leaf, left, esc)
            return nxt, hits, cnt

        hits0 = jnp.full((max_hits,), -1, jnp.int32)
        node0 = jnp.int32(0)
        _, hits, cnt = jax.lax.while_loop(cond, body, (node0, hits0,
                                                       jnp.int32(0)))
        return hits, cnt   # TRUE count (hit list truncates, cnt never)

    return jax.vmap(one)(q_lo, q_hi, valid)


def query_overlaps_sorted(bvh: LBvh, q_lo: jax.Array, q_hi: jax.Array,
                          max_hits: int, tile: int = 128,
                          group: int = 128, extract: str = "peel",
                          decompose: bool = False, cells: int = 8,
                          compact: Optional[int] = None,
                          uniform_extent=None,
                          _upto: str = ""):
    """High-throughput AABB overlap query: sorted banded tile join.

    A replacement for per-query tree walks (which serialize into
    lockstep gather chains): sort the queries by morton code
    — then, because node/leaf order is morton too, every query's
    overlapping leaves live in a contiguous sorted-leaf interval
    ``[searchsorted(codes, m(qlo - h)), searchsorted(codes, m(qhi + h))]``
    (componentwise dominance of morton codes; ``h`` = max leaf
    half-extent).  Queries tile the diagonal; each tile tests its ``tile``
    queries against a 3-tile leaf window with pure elementwise compares
    over static slices — zero gathers.  ``extract`` picks the hit-list
    strategy: ``"bitpeel"`` (bit-packed mask, lowest-set-bit peeling on
    W=3TL/32 int32 sublanes + one flat prim gather — fastest),
    ``"peel"`` (composite-key argmin over the raw window), ``"topk"``,
    ``"scan"`` (rank-compaction scatter), or ``"none"`` (counts only).

    Returns ``(qid, hits, counts, in_band)`` in sorted-query order:
    ``qid [nq]`` original query index, ``hits [nq, max_hits]`` primitive
    ids (-1 padded), ``counts [nq]`` true overlap counts, ``in_band [nq]``
    False where the band was too narrow (caller falls back to
    :func:`query_overlaps` for those or increases ``tile``).

    ``decompose=True`` fixes the band failure mode at scale: a tiny box
    whose corners straddle a high morton plane has a corner-to-corner
    leaf interval covering a large fraction of the tree (measured
    in-band fraction 0.002 at 1M uniform prims/queries), so the plain
    band answers almost nothing.  Each query is instead expanded into
    its (at most 8, by construction) covering *aligned* octree cells at
    the smallest power-of-two cell size — each cell is one SHORT
    contiguous morton interval, so entries land in-band.  The join
    compare volume is invariant (8x entries x 1/8 window); returns are
    then ENTRY-granular with duplicated ``qid``: callers combine with
    segment ops (counts scatter-ADD, in_band scatter-AND; hit lists
    union without duplicates — the cells are disjoint).

    ``compact`` (decompose only) is a global VALID-entry budget: the
    ~2-3 live covering cells per query are compacted to the front of
    the sorted entry order (invalid slots key to +inf in the same wide
    sort the join already pays for — compaction itself is a slice) and
    only ``compact`` entries run the front+join.  Since the join is
    entry-bound, a budget of ~0.4x nq*cells cuts its cost ~2.5x at
    unchanged exactness.  If more than ``compact`` entries are live,
    every query is flagged out of band (caller re-traces with a larger
    budget — the standard overflow contract).

    ``cells`` (8, 4 or 2) bounds the entries per decomposed query.  The
    decomposed join is ENTRY-bound, not compare-bound (chosen before the move
    to the GPU; not re-measured on the H100), so fewer entries is a direct win:
    for
    ``cells=4`` each query instead uses the smallest aligned-cell level
    at which at most TWO axes straddle a cell boundary (level =
    ``max(ext_level, min_d bitlen(lo_d ^ hi_d))``), so 4 covering cells
    suffice by construction; ``cells=2`` lifts to the median, leaving
    at most one straddling axis.  Queries forced to a coarser level get
    a wider morton interval and may fall out of band (flagged, caller
    falls back) — run_all.py prints the in-band fraction beside each
    decomposed row.

    ``uniform_extent`` is the broad-phase fast path: when every query box is
    ``center +- r`` for one shared ``r`` (point-vs-mesh contact, cloth vertex
    self-contact — the dominant consumers), pass the CENTERS as ``q_lo``
    (``q_hi`` is ignored) and ``r`` here (scalar or per-axis).  Only the 3
    center columns ride the entry sort (the sort is the decomposed join's
    largest cost and is linear in operand count, chosen before the move to the
    GPU; not re-measured on the H100); the join reconstructs ``lo/hi = c -+ r``
    in f32, bit-identical to the caller's own ``p - r``/ ``p + r``, so
    exactness is unchanged.

    Reference analog: ``container/Bvh.hpp`` ``iter_neighbors`` (:662-733);
    the banded join is a gather-free formulation of the same broad
    phase.
    """
    n = bvh.num_leaves
    nq = q_lo.shape[0]
    dim = q_lo.shape[-1]
    leaf_lo = bvh.lo[n - 1:]
    leaf_hi = bvh.hi[n - 1:]
    leaf_prim = bvh.leaf_prim[n - 1:]
    big = jnp.asarray(3.4e38, q_lo.dtype)
    if uniform_extent is not None:
        uext = jnp.broadcast_to(
            jnp.asarray(uniform_extent, q_lo.dtype), (dim,))
        centers = q_lo
        q_lo = centers - uext
        q_hi = centers + uext

    def quant(x):
        return jnp.clip((x - bvh.scene_lo) / bvh.scene_extent * 1024.0,
                        0, 1023).astype(jnp.int32)

    if decompose:
        from ..math.bits import clz32
        # NOTE a query-level pre-sort + blockwise expansion (saving the
        # 8x entry sort) was tried and REVERTED: keeping a query's 8
        # cells in one tile makes the tile's leaf span the union of the
        # cells — for plane-straddling queries that union is exactly the
        # wide interval decomposition exists to disperse (in-band 0.99
        # -> 0.76 measured).  The global entry sort is load-bearing.
        if cells not in (8, 4, 2):
            raise ValueError("decompose cells must be 8, 4 or 2")
        if nq > (1 << 26):
            raise ValueError("decompose packs qid into 26 bits of one "
                             "sort operand; split batches beyond 2^26")
        R = cells
        # Column-form generation: every array below is [nq] or [R, nq] — nq
        # minor.  [nq, 3]/[nq, R, 3] forms pad their 3/4-wide minor dims in the
        # device layout (chosen before the move to the GPU; not re-measured on
        # the H100). Entries flatten R-MAJOR (entry order is irrelevant
        # pre-sort).
        from ..math.bits import expand_bits_3d

        def quant_d(x, d):
            return jnp.clip(
                (x - bvh.scene_lo[d]) / bvh.scene_extent[d] * 1024.0,
                0, 1023).astype(jnp.int32)

        lo_cd = [quant_d(q_lo[:, d] - bvh.half_max[d], d)
                 for d in range(dim)]
        hi_cd = [quant_d(q_hi[:, d] + bvh.half_max[d], d)
                 for d in range(dim)]
        # smallest 2^k >= ext so the box spans <= 2 cells per axis
        ext = jnp.maximum(jnp.maximum(hi_cd[0] - lo_cd[0],
                                      hi_cd[1] - lo_cd[1]),
                          hi_cd[2] - lo_cd[2])
        k = jnp.maximum(
            32 - clz32(jnp.maximum(ext - 1, 0).astype(jnp.uint32)), 0)
        if R < 8:
            # lift k until <= log2(R) axes straddle: axis d stops
            # straddling exactly at level bitlen(lo_d ^ hi_d), so the
            # bound is the (3 - log2(R))-th smallest of those levels
            h = [32 - clz32((lo_cd[d] ^ hi_cd[d]).astype(jnp.uint32))
                 for d in range(dim)]
            hmax = jnp.maximum(jnp.maximum(h[0], h[1]), h[2])
            hmin = jnp.minimum(jnp.minimum(h[0], h[1]), h[2])
            lift = hmin if R == 4 else (h[0] + h[1] + h[2]
                                        - hmax - hmin)   # median: <= 1
            k = jnp.maximum(k, lift)
        k = jnp.minimum(k, 10).astype(jnp.int32)
        c0d = [lo_cd[d] >> k for d in range(dim)]
        c1d = [hi_cd[d] >> k for d in range(dim)]
        ii = jnp.arange(R, dtype=jnp.int32)[:, None]     # [R, 1]
        if R == 8:
            # entry r's bit (2-d) drives axis d
            cell = [c0d[d][None, :] + ((ii >> (2 - d)) & 1)
                    for d in range(dim)]                 # [R, nq]
            valid = ((cell[0] <= c1d[0][None, :])
                     & (cell[1] <= c1d[1][None, :])
                     & (cell[2] <= c1d[2][None, :]))
        else:
            # entry i's bit j drives the j-th straddling axis; entries
            # past 2**nstraddle would duplicate earlier cells (entry i
            # repeats cell i mod 2**nstraddle) -> invalidated
            s = [(c1d[d] > c0d[d]).astype(jnp.int32) for d in range(dim)]
            sidx = [jnp.zeros_like(s[0]), s[0], s[0] + s[1]]
            cell = [c0d[d][None, :]
                    + ((ii >> sidx[d][None, :]) & 1) * s[d][None, :]
                    for d in range(dim)]
            nstraddle = s[0] + s[1] + s[2]
            valid = ii < jnp.left_shift(1, nstraddle)[None, :]
        base = (((expand_bits_3d(cell[0]) << 2)
                 | (expand_bits_3d(cell[1]) << 1)
                 | expand_bits_3d(cell[2])).astype(jnp.int32)
                << (3 * k)[None, :])                     # [R, nq]
        # invalid entries take their query's primary cell base with an
        # EMPTY interval (m_hi < m_lo -> in_band, inverted boxes -> no
        # hits).  A far sentinel would pile all ~6/8 invalid entries at
        # the top of the sorted order and wreck the rank<->leaf-space
        # alignment the positional band depends on; anchored at the
        # query's own base they stay uniformly interleaved.
        if compact is None:
            m_lo = jnp.where(valid, base, base[0:1, :]).reshape(-1)
        else:
            # under compaction invalid entries sort to the END (they are
            # sliced off, so the anchored-interleaving concern above is
            # moot) — the budget slice below keeps only live entries
            m_lo = jnp.where(valid, base,
                             jnp.int32(2 ** 31 - 1)).reshape(-1)
        vflat = valid.reshape(-1)
        qid0 = jnp.tile(jnp.arange(nq, dtype=jnp.int32), R)
        # pack (qid, k, valid) into ONE sort operand: the entry sort is the
        # decomposed join's single largest cost and is LINEAR in operand count
        # (chosen before the move to the GPU; not re-measured on the H100).
        # m_hi leaves the sort (and the generation) entirely — it is
        # reconstructed post-sort as m_lo + valid * 2^{3k} - 1 (invalid entries
        # keep their empty anchored interval).  Unstable is sound here: every
        # entry's result is independent and consumers combine by qid-keyed
        # segment ops, so equal-key permutation cannot change answers.
        qidk = ((qid0 << 5) | (jnp.tile(k, R) << 1)
                | vflat.astype(jnp.int32))
        nq = nq * R
        n_valid = jnp.sum(valid.astype(jnp.int32))
    else:
        # morton interval of each query (dilated by max leaf half-extent)
        m_lo = morton3d(quant(q_lo - bvh.half_max))
        m_hi = morton3d(quant(q_hi + bvh.half_max))
        qid0 = jnp.arange(nq, dtype=jnp.int32)

    if compact is not None:
        if not decompose:
            raise ValueError("compact requires decompose=True")
        if compact % tile or compact > nq:
            raise ValueError(f"compact budget {compact} must be a "
                             f"multiple of tile <= {nq}")

    T = tile
    assert nq % T == 0, "query count must be a multiple of tile"
    ntiles = (compact if compact is not None else nq) // T
    G = min(group, ntiles)
    while ntiles % G:
        G -= 1

    # sort entries by interval start (wide sort: no gathers — a 3-op sort +
    # post-gather of the 6 box columns was slower).  Per-dimension 1-D columns
    # throughout (NO [.., dim] stacks): a dim-minor array in the window gather
    # / scan operands pads 3 -> 128 in the device layout, with relayout copies
    # (chosen before the move to the GPU; not re-measured on the H100)
    if uniform_extent is not None:
        qcols_in = [centers[:, d] for d in range(dim)]
        qfills = [big] * dim
    else:
        qcols_in = ([q_lo[:, d] for d in range(dim)]
                    + [q_hi[:, d] for d in range(dim)])
        qfills = [big] * dim + [-big] * dim
    if decompose:
        # per-1-D-column expansion to entries (R-major, matching m_lo);
        # invalid entries get fill boxes that overlap nothing
        qcols_in = [jnp.where(vflat, jnp.tile(c, R), f)
                    for c, f in zip(qcols_in, qfills)]
    if _upto == "gen":                           # perf bisection hook
        return ((m_lo, qidk) if decompose else (m_lo, m_hi, qid0)
                ) + tuple(qcols_in)
    if decompose:
        ops = jax.lax.sort((m_lo, qidk, *qcols_in),
                           num_keys=1, is_stable=False)
    else:
        ops = jax.lax.sort((m_lo, m_hi, qid0, *qcols_in),
                           num_keys=1, is_stable=True)
    if compact is not None:
        # valid-entry compaction to a budget (the overflow contract):
        # the decomposed join is entry-bound, so slicing the ~2-3
        # valid cells/query down from the R allocated slots cuts the
        # front+join cost proportionally.  When the budget is exceeded,
        # surviving queries would silently lose entries — flag EVERY
        # query out of band instead (caller re-traces with a larger
        # budget, the framework's _buildSuccess idiom).
        cut = n_valid > compact
        ops = tuple(o[:compact] for o in ops)
        nq = compact
    if decompose:
        sm_lo, sqidk = ops[0], ops[1]
        qid = sqidk >> 5
        sval = sqidk & 1
        sm_hi = sm_lo + jax.lax.shift_left(
            sval, ((sqidk >> 1) & 15) * 3) - 1
        qcols_s = list(ops[2:])
    else:
        sm_lo, sm_hi, qid = ops[0], ops[1], ops[2]
        qcols_s = list(ops[3:])
    if uniform_extent is not None:
        scent_d = qcols_s
        sq_lo_d = [scent_d[d] - uext[d] for d in range(dim)]
        sq_hi_d = [scent_d[d] + uext[d] for d in range(dim)]
    else:
        sq_lo_d = qcols_s[:dim]
        sq_hi_d = qcols_s[dim:2 * dim]
    if _upto == "sort":                          # perf bisection hook
        return (qid, sm_lo, sm_hi) + tuple(qcols_s)

    # leaf window per query tile, anchored at the tile's OWN smallest
    # interval start.  Round 2 anchored windows positionally
    # ([(t-1)TL, (t+2)TL) around the tile's rank), which silently
    # assumed query rank tracks leaf rank — morton-code dilation shift
    # and decomposed-entry multiplicity both break that (almost no
    # query stayed in band at 1M).  sm_lo is sorted, so the tile's min
    # interval start is its FIRST entry — ONE rank lookup per TILE
    # ([ntiles] searchsorted, trivial), not per entry: a per-entry
    # _rank_sorted/_rank_any front was most of a decomposed counts query
    # (chosen before the move to the GPU; not re-measured on the H100).
    TL = -(-n // ntiles)
    # window base = the tile's own min interval start, floored to a TL-block
    # boundary (the gather then moves whole [TL,...] blocks; element-row
    # gathers of the same bytes were far slower, chosen before the move to the
    # GPU; not re-measured on the H100)
    nlt = -(-n // TL) + 3
    # per-tile min (decomposed entries are only 8-blockwise sorted;
    # for the globally sorted case the min IS the first entry)
    tile_min = jnp.min(sm_lo.reshape(ntiles, T), axis=1)
    # block-boundary rank: w0 is only needed at TL-block
    # granularity, so rank tile_min against the ceil(n/TL) block-LEADING
    # codes with one fused compare+sum instead of searchsorted into all
    # n codes (~20 dependent gather rounds).  With left-rank r in codes,
    # #{j : codes[j*TL] < v} = ceil(r/TL), so blk = that - 1 equals
    # r//TL except when r lands exactly on a block boundary, where the
    # window shifts one block early — coverage the edge-code certificate
    # below still validates exactly.
    bound = bvh.codes[::TL]                                 # [ceil(n/TL)]
    jstar = jnp.sum((bound[None, :] < tile_min[:, None])
                    .astype(jnp.int32), axis=1)
    w0 = jnp.clip(jstar - 1, 0, nlt - 3) * TL
    w0_q = jnp.repeat(w0, T)                     # [nq]
    # in-band certificate from the window's EDGE codes (per tile):
    # every leaf whose code falls in [m_lo, m_hi] lies inside
    # [w0, w0+3TL) iff the code just before the window is < m_lo and
    # the code just after is > m_hi — no per-entry ranks needed.
    edge_l = jnp.take(bvh.codes, jnp.clip(w0 - 1, 0, n - 1))
    edge_r = jnp.take(bvh.codes, jnp.clip(w0 + 3 * TL, 0, n - 1))
    left_ok = jnp.repeat(w0 == 0, T) | (jnp.repeat(edge_l, T) < sm_lo)
    right_ok = (jnp.repeat(w0 + 3 * TL >= n, T)
                | (jnp.repeat(edge_r, T) > sm_hi))
    in_band = (left_ok & right_ok) | (sm_lo > sm_hi)
    if compact is not None:
        in_band = in_band & ~cut

    big = jnp.asarray(3.4e38, leaf_lo.dtype)
    blk = w0[:, None] // TL + jnp.arange(3, dtype=jnp.int32)[None]

    def window(a, fill):
        # 1-D payload column -> [ntiles, 3TL]: whole-TL-block takes
        ap = jnp.concatenate(
            [a, jnp.full((nlt * TL - n,), fill, a.dtype)])
        tiles = ap.reshape(nlt, TL)
        return jnp.take(tiles, blk, axis=0).reshape(ntiles, 3 * TL)

    # all scan operands (windows AND q-side) are materialized through
    # one optimization_barrier below, before the scan — left fused, XLA
    # re-materializes producers inside the loop body every step
    # (chosen before the move to the GPU; not re-measured on the H100)
    wins = ([window(leaf_lo[:, d], big) for d in range(dim)]
            + [window(leaf_hi[:, d], -big) for d in range(dim)]
            + [window(leaf_prim, jnp.int32(-1))])
    if decompose:
        # leaf morton codes ride the window as TWO f32 halves (15 bits each —
        # f32-exact): hits are clamped to the entry's own cell by EXACT
        # code-interval membership [m_lo, m_hi], replacing the per-entry [s, e)
        # lane clamp (whose rank lookups dominated the query).  int32 compares
        # in the join broke its bool fusion — hence the f32 pair (chosen before
        # the move to the GPU; not re-measured on the H100).
        wc = window(bvh.codes, jnp.int32(2 ** 31 - 1))
        wins += [(wc >> 15).astype(leaf_lo.dtype),
                 (wc & 0x7FFF).astype(leaf_lo.dtype)]
        ah = (sm_lo >> 15).astype(leaf_lo.dtype)
        al = (sm_lo & 0x7FFF).astype(leaf_lo.dtype)
        bh = (sm_hi >> 15).astype(leaf_lo.dtype)
        bl = (sm_hi & 0x7FFF).astype(leaf_lo.dtype)
    if _upto == "front":                         # perf bisection hook
        return (qid, w0_q, in_band, sm_lo, sm_hi) + tuple(
            sq_lo_d) + tuple(sq_hi_d)
    if _upto == "win":                           # perf bisection hook
        return (qid, w0_q, in_band, sm_lo, sm_hi) + tuple(
            sq_lo_d) + tuple(sq_hi_d) + tuple(wins)

    def per_group(carry, tgroup):
        # positional unpack (all operands are per-dimension 2-D rows)
        wl = tgroup[0:dim]
        wh = tgroup[dim:2 * dim]
        wp = tgroup[2 * dim]
        i0 = 2 * dim + 1
        if decompose:
            wc_h, wc_l = tgroup[i0:i0 + 2]
            i0 += 2
        ql = tgroup[i0:i0 + dim]
        qh = tgroup[i0 + dim:i0 + 2 * dim]
        i0 += 2 * dim
        if decompose:
            eah, eal, ebh, ebl = tgroup[i0:i0 + 4]
        if extract == "bitpeel":
            # Transposed [G, 3TL, T] mask (T = tile is the 128-lane minor
            # dim), bit-packed into int32 words on the *sublane* axis:
            # words [G, W, T] with W = ceil(3TL/32).  Each extraction
            # round then peels the lowest set bit across W sublanes
            # (~32x fewer lane-ops than a min-reduce over the raw 3TL
            # window) and returns window-lane ids; prim ids are resolved
            # by ONE flat gather after the scan.
            # margin-min join (see peel orientation note)
            mg = jnp.broadcast_to(
                wp.astype(wl[0].dtype)[:, :, None], (G, 3 * TL, T))
            if decompose:
                mg = jnp.minimum(
                    mg, (wc_h[:, :, None] - eah[:, None, :]) * 65536.0
                    + (wc_l[:, :, None] - eal[:, None, :]))
                mg = jnp.minimum(
                    mg, (ebh[:, None, :] - wc_h[:, :, None]) * 65536.0
                    + (ebl[:, None, :] - wc_l[:, :, None]))
            for d in range(dim):
                mg = jnp.minimum(mg, wh[d][:, :, None] - ql[d][:, None, :])
                mg = jnp.minimum(mg, qh[d][:, None, :] - wl[d][:, :, None])
            ov = mg >= 0                           # [G, 3TL, T]
            cnt = jnp.sum(ov, axis=1).astype(jnp.int32)      # [G, T]
            WL = -(-(3 * TL) // 32) * 32
            if WL > 3 * TL:
                ov = jnp.concatenate(
                    [ov, jnp.zeros((G, WL - 3 * TL, T), bool)], axis=1)
            W = WL // 32
            # sum of distinct powers of two == OR (int32 wrap is exact
            # two's-complement; jnp.sum keeps int32 exactness)
            shifts = jax.lax.shift_left(
                jnp.int32(1), jnp.arange(32, dtype=jnp.int32))
            words = jnp.stack(
                [jnp.sum(jnp.where(ov[:, w * 32:(w + 1) * 32, :],
                                   shifts[None, :, None], 0), axis=1)
                 for w in range(W)], axis=1)       # [G, W, T] int32
            word_base = (jnp.arange(W, dtype=jnp.int32) * 32
                         )[None, :, None]
            sent = jnp.int32(WL)                   # > any window lane
            lanes_out = []
            for _ in range(max_hits):
                lb = words & -words                # lowest set bit
                bit = jax.lax.population_count(lb - 1)   # 32 iff lb==0
                comp = jnp.where(words != 0, word_base + bit, sent)
                m = jnp.min(comp, axis=1)          # [G, T] = lane id
                lanes_out.append(m)
                # comp is unique across nonzero words (disjoint bases),
                # so exactly the selected word clears its lowest bit
                words = words ^ jnp.where(comp == m[:, None, :], lb, 0)
            # stack hits [G, max_hits, T]: T is the 128-multiple minor
            # dim.  A [.., T, max_hits] layout pads max_hits -> 128 in
            # the scan's stacked output, which dominated extraction
            # (chosen before the move to the GPU; not re-measured on the H100)
            hits = jnp.stack(lanes_out, axis=1)    # [G, max_hits, T]
            return carry, (hits, cnt)
        if decompose and extract in ("none", "peel"):
            # Transposed [G, 3TL, T] orientation: the decomposed window is
            # NARROW (3TL = 3n/ntiles, e.g. 192 at cells=4/T=128) and as the
            # MINOR dim it vectorized poorly (chosen before the move to the
            # GPU; not re-measured on the H100).  Putting T (a 128 multiple)
            # minor restores full vectorization; the margin-min join is
            # orientation-symmetric so only the broadcast axes change
            # (bitpeel's mask already ran this way — its pathology was the
            # bit-pack padding, not the orientation).
            mg = jnp.broadcast_to(
                wp.astype(wl[0].dtype)[:, :, None], (G, 3 * TL, T))
            mg = jnp.minimum(
                mg, (wc_h[:, :, None] - eah[:, None, :]) * 65536.0
                + (wc_l[:, :, None] - eal[:, None, :]))
            mg = jnp.minimum(
                mg, (ebh[:, None, :] - wc_h[:, :, None]) * 65536.0
                + (ebl[:, None, :] - wc_l[:, :, None]))
            for d in range(dim):
                mg = jnp.minimum(mg, wh[d][:, :, None] - ql[d][:, None, :])
                mg = jnp.minimum(mg, qh[d][:, None, :] - wl[d][:, :, None])
            ov = mg >= 0                           # [G, 3TL, T]
            cnt = jnp.sum(ov, axis=1).astype(jnp.int32)      # [G, T]
            if extract == "none":
                return carry, (jnp.zeros((G, 1, T), jnp.int32), cnt)
            # peel, transposed: same composite-key argmin rounds, over
            # the SUBLANE (window) axis
            prim_bits = max(1, int(n - 1).bit_length())
            lane_bits = int(3 * TL - 1).bit_length()
            if prim_bits + lane_bits > 31:
                raise ValueError(
                    f"peel extract: {n} prims x {3 * TL}-lane window "
                    f"exceeds the 31-bit composite key; use "
                    f"extract='topk' or a smaller tile")
            big_c = jnp.int32(2 ** 31 - 1)
            lane_ids = jnp.arange(3 * TL, dtype=jnp.int32)
            comp = jnp.where(
                ov, (lane_ids[None, :, None] << prim_bits)
                | jnp.maximum(wp, 0)[:, :, None], big_c)
            cols_out = []
            for _ in range(max_hits):
                m = jnp.min(comp, axis=1)          # [G, T]
                cols_out.append(jnp.where(
                    m < big_c, m & ((1 << prim_bits) - 1), -1))
                comp = jnp.where(comp == m[:, None, :], big_c, comp)
            hits = jnp.stack(cols_out, axis=1)     # [G, mh, T]
            return carry, (hits, cnt)
        # [G, T, 3TL] overlap mask, built per-dimension: a fused jnp.all(...,
        # -1) materializes [G,T,3TL,dim] whose dim-minor pads 128x in the
        # device layout (chosen before the move to the GPU; not re-measured on
        # the H100) margin-min join: every condition becomes an f32 MARGIN (>=
        # 0 iff satisfied) and the conditions reduce by jnp.minimum — full-rate
        # f32 ops with ONE final pred, instead of 8 compares + 7 pred-ands
        # whose conversions slowed the scan-body fusion (chosen before the move
        # to the GPU; not re-measured on the H100).  Margins: prim validity =
        # wp itself (f32-exact, ids < 2^24); cell membership = the sign-exact
        # fma pair-compare values (when the 15-bit high halves differ,
        # |dh*65536| >= 2|dl|, and f32 rounding never flips the sign of a
        # +-2^31-bounded sum); box overlap = the 6 coordinate differences.
        # Window fills (+-3.4e38) make the box margins -inf on padded lanes —
        # no NaN combination is reachable (fills pair only with finite or
        # opposite-sign values).
        mg = jnp.broadcast_to(
            wp.astype(wl[0].dtype)[:, None, :], (G, T, 3 * TL))
        if decompose:
            mg = jnp.minimum(
                mg, (wc_h[:, None, :] - eah[:, :, None]) * 65536.0
                + (wc_l[:, None, :] - eal[:, :, None]))
            mg = jnp.minimum(
                mg, (ebh[:, :, None] - wc_h[:, None, :]) * 65536.0
                + (ebl[:, :, None] - wc_l[:, None, :]))
        for d in range(dim):
            mg = jnp.minimum(mg, wh[d][:, None, :] - ql[d][:, :, None])
            mg = jnp.minimum(mg, qh[d][:, :, None] - wl[d][:, None, :])
        ov = mg >= 0
        cnt = jnp.sum(ov, axis=-1).astype(jnp.int32)
        lane_ids = jnp.arange(3 * TL, dtype=jnp.int32)
        if extract == "none":
            # no hit output: a constant [.., max_hits] ys still costs
            # its (padded) device-memory writes every step
            return carry, (jnp.zeros((ov.shape[0], 1, ov.shape[1]),
                                     jnp.int32), cnt)
        if extract == "peel":
            # argmin peeling on a composite (lane << prim_bits | prim)
            # key: max_hits rounds of min-reduce + clear — no per-row
            # sort (top_k) and no scatters.  The key is sized from the
            # static n and window width so it can never overflow int32
            # (a fixed 21-bit shift wrapped negative for 3TL > 1024,
            # silently scrambling hit order at wide tiles).
            prim_bits = max(1, int(n - 1).bit_length())
            lane_bits = int(3 * TL - 1).bit_length()
            if prim_bits + lane_bits > 31:
                raise ValueError(
                    f"peel extract: {n} prims x {3 * TL}-lane window "
                    f"exceeds the 31-bit composite key; use "
                    f"extract='topk' or a smaller tile")
            big_c = jnp.int32(2 ** 31 - 1)
            comp0 = jnp.where(
                ov, (lane_ids[None, None, :] << prim_bits) |
                jnp.maximum(wp, 0)[:, None, :], big_c)
            comp = comp0
            cols_out = []
            for _ in range(max_hits):
                m = jnp.min(comp, axis=-1)                 # [G, T]
                cols_out.append(jnp.where(m < big_c,
                                          m & ((1 << prim_bits) - 1),
                                          -1))
                comp = jnp.where(comp == m[..., None], big_c, comp)
            hits = jnp.stack(cols_out, axis=1)     # [G, mh, T]
            return carry, (hits, cnt)
        if extract == "scan":
            # rank-compaction scatter: hit slot = prefix count of the
            # overlap mask (top_k over the 768-lane window costs a sort
            # per query — this is one cumsum + one scatter)
            rank = jnp.cumsum(ov.astype(jnp.int32), axis=-1)
            slot = jnp.where(ov & (rank <= max_hits), rank - 1, max_hits)
            gi = jnp.arange(ov.shape[0])[:, None, None]
            ti = jnp.arange(ov.shape[1])[None, :, None]
            prim_b = jnp.broadcast_to(wp[:, None, :], ov.shape)
            hits = jnp.full(ov.shape[:2] + (max_hits + 1,), -1,
                            jnp.int32).at[gi, ti, slot].set(
                jnp.where(ov, prim_b, -1))[..., :max_hits]
            return carry, (hits.swapaxes(1, 2), cnt)
        # "topk"
        lane = jnp.arange(3 * TL, dtype=jnp.int32)
        key = jnp.where(ov, lane[None, None, :], 3 * TL)
        neg, _ = jax.lax.top_k(-key, max_hits)   # smallest lanes first
        lanes = -neg                             # [G, T, max_hits]
        hit_prim = jnp.take_along_axis(
            jnp.broadcast_to(wp[:, None, :], ov.shape),
            jnp.minimum(lanes, 3 * TL - 1), axis=-1)
        hits = jnp.where(lanes < 3 * TL, hit_prim, -1)
        return carry, (hits.swapaxes(1, 2), cnt)

    # operand order MUST match per_group's unpack.  The loop is a fori_loop
    # with explicit dynamic slices, NOT lax.scan: scan bundles its xs into the
    # while-loop carried tuple, and XLA assigned the window operands a
    # transposed loop layout ({1,0,2} in the compiled HLO) — a whole-array
    # relayout copy before the loop that dwarfed the join itself (chosen before
    # the move to the GPU; not re-measured on the H100).  Slicing from the
    # barriered arrays leaves them in their natural layout.
    qcols = sq_lo_d + sq_hi_d
    if decompose:
        qcols = qcols + [ah, al, bh, bl]
    flat_ops = jax.lax.optimization_barrier(tuple(wins) + tuple(qcols))
    wins_f = flat_ops[:len(wins)]
    qcols_f = flat_ops[len(wins):]
    nsteps = ntiles // G
    mh_t = 1 if extract == "none" else max_hits
    hits_all = jnp.full((nsteps, G, mh_t, T), -1, jnp.int32)
    cnt_all = jnp.zeros((nsteps, G, T), jnp.int32)

    def loop_body(s, st):
        h_all, c_all = st
        tg = tuple(
            [jax.lax.dynamic_slice_in_dim(w, s * G, G, 0)
             for w in wins_f]
            + [jax.lax.dynamic_slice_in_dim(q, s * (G * T), G * T, 0)
               .reshape(G, T) for q in qcols_f])
        _, (h, c) = per_group(jnp.int32(0), tg)
        h_all = jax.lax.dynamic_update_slice_in_dim(h_all, h[None], s, 0)
        c_all = jax.lax.dynamic_update_slice_in_dim(c_all, c[None], s, 0)
        return h_all, c_all

    hits, cnt = jax.lax.fori_loop(0, nsteps, loop_body,
                                  (hits_all, cnt_all))
    cnt = cnt.reshape(nq)
    if extract == "none":
        hits = jnp.full((nq, max_hits), -1, jnp.int32)
    else:
        # ys come out [steps, G, max_hits, T] (T-minor, lane-aligned);
        # one transpose outside the loop restores query-major hits
        hits = hits.transpose(0, 1, 3, 2).reshape(nq, max_hits)
    if extract == "bitpeel":
        # window lane -> global leaf -> prim id (one flat gather)
        lanes = hits
        live = lanes < 3 * TL
        leaf = w0_q[:, None] + lanes
        prim = jnp.take(leaf_prim, jnp.clip(leaf, 0, n - 1), axis=0)
        hits = jnp.where(live, prim, -1)
    return qid, hits, cnt, in_band


def query_overlaps_exact(bvh: LBvh, q_lo: jax.Array, q_hi: jax.Array,
                         max_hits: int, *, tile: int = 128,
                         group: int = 512, cells: int = 4,
                         residue_budget: Optional[int] = None,
                         uniform_extent=None):
    """Exact per-query overlap answers with static shapes: decomposed
    banded join + bounded escape-walk residue.

    The banded join certifies exactness per query; this driver closes the
    contract framework-side instead of leaving the residue to the caller:
    out-of-band queries (typically a few percent) are compacted into a STATIC
    ``residue_budget`` buffer and answered by the reference-shaped escape walk
    (:func:`query_overlaps`), which is latency-bound and only economical at
    exactly this bounded-residue scale — residue engine + test oracle, not a
    query path.  If more than ``residue_budget`` queries fall out of band,
    ``overflow`` is returned True and the caller re-traces with a larger budget
    — the standard contract.

    Returns ``(qid_rows, hits_rows, counts, overflow)``:
    ``counts [nq]`` is the EXACT per-query overlap count for every
    query; ``(qid_rows, hits_rows)`` are entry-granular union rows
    (same consumption pattern as :func:`query_overlaps_sorted`, cells
    are disjoint so rows of one query never duplicate a primitive;
    residue queries' banded rows are invalidated and their walk rows
    appended).  A query with ``counts > max_hits`` has a truncated hit
    list (its count stays exact).

    Reference analog: ``Bvh.hpp`` ``iter_neighbors`` — the guaranteed-
    exact query surface, here with the banded join as the fast path.
    """
    nq0 = q_lo.shape[0]
    dim = q_lo.shape[-1]
    if residue_budget is None:
        residue_budget = max(tile, nq0 // 64)
    nq = -(-nq0 // tile) * tile
    pad = nq - nq0
    if pad:
        far = jnp.full((pad, dim), 1e9, q_lo.dtype)
        q_lo = jnp.concatenate([q_lo, far])
        q_hi = jnp.concatenate([q_hi, far])
    qid, hits_e, cnt_e, band_e = query_overlaps_sorted(
        bvh, q_lo, q_hi, max_hits, tile=tile, group=group,
        extract="peel", decompose=True, cells=cells,
        uniform_extent=uniform_extent)
    # per-query combine (disjoint cells: counts ADD, band AND)
    cnt_q = jnp.zeros((nq,), jnp.int32).at[qid].add(cnt_e)
    band_q = jnp.ones((nq,), jnp.int32).at[qid].min(
        band_e.astype(jnp.int32)) > 0
    # residue compaction to the static budget
    res = ~band_q
    rank = jnp.cumsum(res.astype(jnp.int32)) - 1
    slot = jnp.where(res & (rank < residue_budget), rank, residue_budget)
    ridx = jnp.full((residue_budget + 1,), nq, jnp.int32).at[slot].set(
        jnp.arange(nq, dtype=jnp.int32))[:residue_budget]
    n_res = jnp.sum(res.astype(jnp.int32))
    overflow = n_res > residue_budget
    rvalid = ridx < nq
    rclip = jnp.clip(ridx, 0, nq - 1)
    if uniform_extent is not None:
        uext = jnp.broadcast_to(
            jnp.asarray(uniform_extent, q_lo.dtype), (dim,))
        r_lo = q_lo[rclip] - uext
        r_hi = q_lo[rclip] + uext
    else:
        r_lo = q_lo[rclip]
        r_hi = q_hi[rclip]
    w_hits, w_cnt = query_overlaps(bvh, r_lo, r_hi, max_hits,
                                   valid=rvalid)
    cnt_q = jnp.where(band_q, cnt_q, 0).at[rclip].add(
        jnp.where(rvalid, w_cnt, 0))
    # union rows: invalidate residue queries' banded rows, append walk
    hits_e = jnp.where(band_q[qid][:, None], hits_e, -1)
    qid_rows = jnp.concatenate([qid, jnp.where(rvalid, rclip, 0)])
    hits_rows = jnp.concatenate(
        [hits_e, jnp.where(rvalid[:, None], w_hits, -1)])
    return qid_rows, hits_rows, cnt_q[:nq0], overflow


def query_nearest_sorted(bvh: LBvh, points: jax.Array,
                         prim_points: jax.Array, tile: int = 128,
                         group: int = 128):
    """High-throughput nearest-point query for point primitives:
    sorted banded scan with an a-posteriori exactness certificate.

    Same shape as :func:`query_overlaps_sorted`: queries are
    morton-sorted onto the leaf diagonal, each tile computes exact
    squared distances to a 3-tile window of leaf points (pure
    broadcasting, zero per-query traversal), takes the window argmin,
    then certifies it: any primitive closer than the found ``rb``
    has a morton code in ``[m(q - rb), m(q + rb)]`` (componentwise
    dominance), so if that leaf interval lies inside the window the
    result is globally exact — ``in_band=True``.  Callers fall back to
    :func:`query_nearest` (rope walk) for the out-of-band residue.

    ``prim_points [n_prims, dim]`` are the primitive coordinates in
    ORIGINAL prim order.  Returns ``(qid, best_prim, best_d2, in_band)``
    in sorted-query order.

    Reference analog: ``container/Bvh.hpp`` ``find_nearest`` (:551-621);
    the traversal is replaced by the banded formulation, which was
    orders of magnitude faster on uniform point sets (chosen before the
    move to the GPU; not re-measured on the H100).
    """
    n = bvh.num_leaves
    nq = points.shape[0]
    dim = points.shape[-1]
    T = tile
    assert nq % T == 0, "query count must be a multiple of tile"
    ntiles = nq // T
    G = min(group, ntiles)
    while ntiles % G:
        G -= 1
    big = jnp.asarray(3.4e38, points.dtype)
    leaf_prim = bvh.leaf_prim[n - 1:]
    lpts = jnp.where((leaf_prim >= 0)[:, None],
                     prim_points[jnp.maximum(leaf_prim, 0)], big)

    def mcode(x):
        qz = jnp.clip((x - bvh.scene_lo) / bvh.scene_extent * 1024.0,
                      0, 1023).astype(jnp.int32)
        return morton3d(qz)

    qid0 = jnp.arange(nq, dtype=jnp.int32)
    ops = jax.lax.sort(
        (mcode(points), qid0, *[points[:, d] for d in range(dim)]),
        num_keys=1, is_stable=True)
    qid = ops[1]
    sp = jnp.stack(ops[2:2 + dim], axis=1)

    TL = -(-n // ntiles)
    pad = ntiles * TL - n
    lt = jnp.concatenate([lpts, jnp.full((pad, dim), big, lpts.dtype)])
    lt = lt.reshape(ntiles, TL, dim)
    wpts = jnp.concatenate([
        jnp.concatenate([jnp.full_like(lt[:1], big), lt[:-1]], 0),
        lt,
        jnp.concatenate([lt[1:], jnp.full_like(lt[:1], big)], 0)],
        axis=1)                                     # [ntiles, 3TL, dim]
    sq = sp.reshape(ntiles, T, dim)

    def per_group(carry, tgroup):
        w, q = tgroup                               # [G,3TL,dim],[G,T,dim]
        d2 = jnp.zeros((w.shape[0], 3 * TL, T), q.dtype)
        for d in range(dim):
            diff = w[:, :, None, d] - q[:, None, :, d]
            d2 = d2 + diff * diff
        best = jnp.min(d2, axis=1)                  # [G, T]
        lane = jnp.argmin(d2, axis=1).astype(jnp.int32)
        return carry, (best, lane)

    scanned = (wpts.reshape(ntiles // G, G, 3 * TL, dim),
               sq.reshape(ntiles // G, G, T, dim))
    _, (best, lane) = jax.lax.scan(per_group, 0, scanned)
    best = best.reshape(nq)
    lane = lane.reshape(nq)
    found = best < 1e37
    tile_of = jnp.arange(nq, dtype=jnp.int32) // T
    leaf = jnp.clip((tile_of - 1) * TL + lane, 0, n - 1)
    best_prim = jnp.where(found, jnp.take(leaf_prim, leaf, axis=0), -1)

    # a-posteriori certificate: the whole candidate morton interval
    # must fall inside this tile's window
    rb = jnp.sqrt(jnp.where(found, best, 0.0))[:, None]
    s = _rank_any(bvh.codes, mcode(sp - rb), "left")
    e = _rank_any(bvh.codes, mcode(sp + rb), "right")
    in_band = found & (s >= (tile_of - 1) * TL) & (e <= (tile_of + 2) * TL)
    return qid, best_prim, best, in_band


def query_nearest(bvh: LBvh, points: jax.Array, prim_dist: Callable,
                  max_iters: Optional[int] = None
                  ) -> Tuple[jax.Array, jax.Array]:
    """Nearest-primitive query (Bvh.hpp find_nearest :551-621).

    ``prim_dist(prim_id, p) -> float`` exact distance to a primitive
    in the SAME linear units as space (pruning uses a linear-norm box
    lower bound).  Box lower-bound pruning + escape walk.  Returns
    (ids, dists).  ``max_iters`` defaults to the full preorder bound
    (2n-1 nodes) — an explicit smaller cap trades exactness for time
    (a 512 cap on a 2048-leaf tree silently mis-answered ~20% of
    clustered queries; regression-tested).
    """
    if max_iters is None:
        max_iters = bvh.lo.shape[0]
    def one(p):
        def box_lb(node):
            d = jnp.maximum(bvh.lo[node] - p, 0.0) + \
                jnp.maximum(p - bvh.hi[node], 0.0)
            return jnp.linalg.norm(d, axis=-1)

        def cond(state):
            node, best_id, best_d, it = state
            return (node >= 0) & (it < max_iters)

        def body(state):
            node, best_id, best_d, it = state
            lb = box_lb(node)
            prune = lb >= best_d
            is_leaf = bvh.left[node] < 0
            prim = bvh.leaf_prim[node]
            dist = jnp.where(is_leaf & (prim >= 0) & ~prune,
                             prim_dist(jnp.maximum(prim, 0), p), jnp.inf)
            better = dist < best_d
            best_d = jnp.where(better, dist, best_d)
            best_id = jnp.where(better, prim, best_id)
            nxt = jnp.where(~prune & ~is_leaf, bvh.left[node],
                            bvh.escape[node])
            return nxt, best_id, best_d, it + 1

        _, bid, bd, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.int32(-1),
                         jnp.asarray(jnp.inf, points.dtype), jnp.int32(0)))
        return bid, bd

    return jax.vmap(one)(points)


def query_ray(bvh: LBvh, origins: jax.Array, dirs: jax.Array,
              prim_hit: Callable, t_max: float = np.inf,
              max_iters: Optional[int] = None
              ) -> Tuple[jax.Array, jax.Array]:
    """Ray cast (Bvh.hpp ray_intersect :526-543): ``prim_hit(id, o, d) -> t``
    (inf on miss).  Returns (prim ids, t).  ``max_iters`` defaults to
    the full preorder bound (see :func:`query_nearest`)."""
    if max_iters is None:
        max_iters = bvh.lo.shape[0]
    def one(o, dvec):
        inv = 1.0 / jnp.where(jnp.abs(dvec) < 1e-12,
                              jnp.where(dvec < 0, -1e-12, 1e-12), dvec)

        def box_hit(node, t_best):
            t0 = (bvh.lo[node] - o) * inv
            t1 = (bvh.hi[node] - o) * inv
            tmin = jnp.max(jnp.minimum(t0, t1))
            tmax = jnp.min(jnp.maximum(t0, t1))
            return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best)

        def cond(state):
            node, _, _, it = state
            return (node >= 0) & (it < max_iters)

        def body(state):
            node, best_id, best_t, it = state
            hit = box_hit(node, best_t)
            is_leaf = bvh.left[node] < 0
            prim = bvh.leaf_prim[node]
            t = jnp.where(hit & is_leaf & (prim >= 0),
                          prim_hit(jnp.maximum(prim, 0), o, dvec), jnp.inf)
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_id = jnp.where(better, prim, best_id)
            nxt = jnp.where(hit & ~is_leaf, bvh.left[node],
                            bvh.escape[node])
            return nxt, best_id, best_t, it + 1

        _, bid, bt, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.int32(-1),
                         jnp.asarray(t_max, origins.dtype), jnp.int32(0)))
        return bid, bt

    return jax.vmap(one)(origins, dirs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BvttFront:
    """Broad-phase pair front (reference ``container/Bvtt.hpp``): a
    retained set of candidate (query, primitive) pairs, rebuilt from BVH
    overlap queries and re-validated cheaply between rebuilds.

    Form: padded pair arrays + count.  ``refresh`` re-tests the cached
    pairs against current boxes (pure gathers, no traversal); ``rebuild``
    runs the full traversal.  This mirrors the reference's front idiom of
    amortizing traversals across frames.
    """

    qid: jax.Array     # [cap] query index, -1 padding
    pid: jax.Array     # [cap] primitive index
    count: jax.Array

    @property
    def capacity(self) -> int:
        return self.qid.shape[0]

    @staticmethod
    def rebuild(bvh: "LBvh", q_lo, q_hi, max_hits_per_query: int,
                capacity: int) -> "BvttFront":
        hits, cnt = query_overlaps(bvh, q_lo, q_hi, max_hits_per_query)
        nq, mh = hits.shape
        qid = jnp.broadcast_to(jnp.arange(nq, dtype=jnp.int32)[:, None],
                               (nq, mh)).reshape(-1)
        pid = hits.reshape(-1)
        ok = pid >= 0
        pos = jnp.cumsum(ok.astype(jnp.int32)) - 1
        total = pos[-1] + 1
        dst = jnp.where(ok, jnp.minimum(pos, capacity - 1), capacity)
        qout = jnp.full((capacity + 1,), -1, jnp.int32).at[dst].set(
            qid)[:capacity]
        pout = jnp.full((capacity + 1,), -1, jnp.int32).at[dst].set(
            pid)[:capacity]
        return BvttFront(qout, pout,
                         jnp.minimum(total, capacity).astype(jnp.int32))

    def refresh(self, prim_lo, prim_hi, q_lo, q_hi) -> jax.Array:
        """Mask of pairs still overlapping under updated boxes (the cheap
        per-frame front validation)."""
        qs = jnp.maximum(self.qid, 0)
        ps = jnp.maximum(self.pid, 0)
        live = (self.qid >= 0)
        return live & aabb_overlap(prim_lo[ps], prim_hi[ps],
                                   q_lo[qs], q_hi[qs])
