"""Parallel primitives on XLA.

Reference surface (``include/zensim/execution/ExecutionPolicy.hpp:684-781``
pattern wrappers; serial impls ``:240-612``; OpenMP
``omp/execution/ExecutionPolicy.hpp:264-1180``; CUDA delegating to CUB
``cuda/execution/ExecutionPolicy.cuh:560-870``):

``for_each / transform / reduce / inclusive_scan / exclusive_scan /
sort / sort_pair / merge_sort(_pair) / radix_sort(_pair) / histogram``

Mapping:

* reduce      -> XLA's native reductions (``jnp.sum`` etc.), generic
  ``lax.reduce`` for custom ops
* scans       -> ``lax.cumsum``/``cummax``/``cummin`` for the standard
  monoids, ``jax.lax.associative_scan`` (log-depth) otherwise
* sorts       -> ``jax.lax.sort``; the reference's *merge sort* (stable)
  and *radix sort* (stable, bit-ranged) both lower to stable ``lax.sort``.
* radix_sort's ``sbit/ebit`` bit-window semantics
  (``execution/ExecutionPolicy.hpp:458-612``) are honored by masking keys to
  the window for comparison while carrying original keys as values.
* histogram   -> one-hot matmul for small bin counts / segment_sum
  otherwise — in place of atomic increments.
* segment_reduce -> ``jax.ops.segment_*`` — the framework-wide replacement
  for atomic scatter (``execution/Atomics.hpp``), per SURVEY §2.11(5).

Identity elements are deduced from the op via the monoid registry, mirroring
``zs::monoid`` (``ZpcFunctional.hpp``, used at ExecutionPolicy.hpp:80-84).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.executor import Executor

__all__ = [
    "monoid_identity",
    "reduce",
    "inclusive_scan",
    "exclusive_scan",
    "sort",
    "sort_pair",
    "merge_sort",
    "merge_sort_pair",
    "radix_sort",
    "radix_sort_pair",
    "histogram",
    "segment_reduce",
    "count_if",
    "select_if",
    "unique",
    "argsort_stable",
]


# -- monoid registry (zs::monoid, ZpcFunctional.hpp) --------------------------

def _ident_add(dt):
    return np.zeros((), dt)


def _ident_mul(dt):
    return np.ones((), dt)


def _ident_min(dt):
    if jnp.issubdtype(dt, jnp.floating):
        return np.array(np.inf, dt)
    return np.array(np.iinfo(dt).max, dt)


def _ident_max(dt):
    if jnp.issubdtype(dt, jnp.floating):
        return np.array(-np.inf, dt)
    return np.array(np.iinfo(dt).min, dt)


_MONOIDS = {}
for _ops, _fn in [
    ((jnp.add, jax.lax.add, "add", "sum"), _ident_add),
    ((jnp.multiply, jax.lax.mul, "mul", "prod"), _ident_mul),
    ((jnp.minimum, jax.lax.min, "min"), _ident_min),
    ((jnp.maximum, jax.lax.max, "max"), _ident_max),
]:
    for _o in _ops:
        _MONOIDS[_o] = _fn


def monoid_identity(op, dtype):
    """Identity element for ``op`` at ``dtype`` (``zs::monoid<Op>::identity``)."""
    fn = _MONOIDS.get(op)
    if fn is None:
        raise ValueError(
            f"no known identity for op {op!r}; pass init= explicitly")
    return fn(np.dtype(dtype))


def _resolve_op(op) -> Callable:
    named = {"add": jnp.add, "sum": jnp.add, "mul": jnp.multiply,
             "prod": jnp.multiply, "min": jnp.minimum, "max": jnp.maximum}
    return named.get(op, op)


# -- reduce -------------------------------------------------------------------

_FULL_REDUCERS = {jnp.add: jnp.sum, jax.lax.add: jnp.sum,
                  jnp.multiply: jnp.prod, jax.lax.mul: jnp.prod,
                  jnp.minimum: jnp.min, jax.lax.min: jnp.min,
                  jnp.maximum: jnp.max, jax.lax.max: jnp.max}


def reduce(pol: Executor, arr, op=jnp.add, init=None):
    """Full reduction (reference ``zs::reduce``, ExecutionPolicy.hpp:267-277;
    CUDA path cub::DeviceReduce, cuda/execution/ExecutionPolicy.cuh:650-690).

    Standard monoids route through XLA's native reductions, which keep
    exact int32 accumulation, whereas generic ``lax.reduce`` with a
    custom computation may accumulate at reduced precision on an
    accelerator.  Custom ops take the generic path with an explicit
    ``init``.
    """
    opf = _resolve_op(op)
    full = _FULL_REDUCERS.get(opf)
    if full is not None and init is None:
        return pol.run(lambda a: full(a), arr, label="reduce")
    if init is None:
        init = monoid_identity(op if not isinstance(op, str) else opf, arr.dtype)

    def kern(a):
        return jax.lax.reduce(a, jnp.asarray(init, a.dtype), opf,
                              tuple(range(a.ndim)))

    return pol.run(kern, arr, label="reduce")


# -- scans --------------------------------------------------------------------

# standard monoids lower to XLA's cumulative reductions; custom ops take the
# generic log-depth associative_scan
_CUMULATIVE = {jnp.add: jax.lax.cumsum, jax.lax.add: jax.lax.cumsum,
               jnp.maximum: jax.lax.cummax, jax.lax.max: jax.lax.cummax,
               jnp.minimum: jax.lax.cummin, jax.lax.min: jax.lax.cummin}


def _inclusive(opf, a):
    cum = _CUMULATIVE.get(opf)
    if cum is not None and a.dtype != jnp.bool_:
        return cum(a, axis=0)
    return jax.lax.associative_scan(opf, a)


def inclusive_scan(pol: Executor, arr, op=jnp.add):
    """Inclusive scan (ExecutionPolicy.hpp:247-255; cub::DeviceScan on CUDA)."""
    opf = _resolve_op(op)
    return pol.run(lambda a: _inclusive(opf, a), arr, label="inclusive_scan")


def exclusive_scan(pol: Executor, arr, op=jnp.add, init=None):
    """Exclusive scan (ExecutionPolicy.hpp:256-266)."""
    opf = _resolve_op(op)
    if init is None:
        init = monoid_identity(op if not isinstance(op, str) else opf, arr.dtype)

    def kern(a):
        shifted = jnp.roll(_inclusive(opf, a), 1)
        first = jnp.asarray(init, a.dtype)
        return shifted.at[0].set(first) if a.shape[0] else shifted

    return pol.run(kern, arr, label="exclusive_scan")


# -- sorts --------------------------------------------------------------------

def _bits_for(bound) -> int:
    """Bits needed for values in [0, bound)."""
    return max(1, int(np.ceil(np.log2(max(int(bound), 2)))))


def _pack_ok(key_bound, val_bound) -> bool:
    """Static bound hints small enough to pack (key, val) into one i32.

    A 1-operand unstable ``lax.sort`` beat the 2-operand pair form and the
    3-operand stable one (chosen before the move to the GPU; not re-measured on
    the H100) — packing is the cheapest pair sort whenever the widths allow
    (CUB pair-sort analog).
    """
    return (key_bound is not None and val_bound is not None
            and _bits_for(key_bound) + _bits_for(val_bound) <= 31)


def sort(pol: Executor, keys):
    """Unstable-contract sort (``zs::sort``, ExecutionPolicy.hpp:278).

    Lowers to ``lax.sort`` (on the GPU, XLA calls CUB's radix sort)."""
    return pol.run(lambda k: jax.lax.sort(k, is_stable=False), keys,
                   label="sort")


def sort_pair(pol: Executor, keys, vals, key_bound=None, val_bound=None):
    """Key-value sort (``zs::sort_pair``).

    ``key_bound``/``val_bound`` are optional *static* exclusive upper
    bounds for non-negative int32 keys/vals; when their widths fit 31
    bits the pair sorts as ONE packed array (1.75x, see
    :func:`_pack_ok`).  Packed ties order by value (still a valid
    unstable pair sort)."""
    if _pack_ok(key_bound, val_bound):
        vb = _bits_for(val_bound)

        def kern_packed(k, v):
            p = (k.astype(jnp.int32) << vb) | v.astype(jnp.int32)
            sp = jax.lax.sort(p, is_stable=False)
            return (sp >> vb).astype(keys.dtype), \
                (sp & ((1 << vb) - 1)).astype(vals.dtype)

        return pol.run(kern_packed, keys, vals, label="sort_pair")

    def kern(k, v):
        return jax.lax.sort((k, v), num_keys=1, is_stable=False)

    return pol.run(kern, keys, vals, label="sort_pair")


def merge_sort(pol: Executor, keys):
    """Stable sort (``zs::merge_sort``, ExecutionPolicy.hpp:311-456)."""
    return pol.run(lambda k: jax.lax.sort(k, is_stable=True), keys,
                   label="merge_sort")


def merge_sort_pair(pol: Executor, keys, vals):
    def kern(k, v):
        return jax.lax.sort((k, v), num_keys=1, is_stable=True)

    return pol.run(kern, keys, vals, label="merge_sort_pair")


def _bit_window(keys, sbit: int, ebit: int):
    """Mask integer keys to bit window [sbit, ebit) for comparison."""
    nbits = np.dtype(keys.dtype).itemsize * 8
    if sbit == 0 and ebit >= nbits:
        return keys
    ukeys = keys.astype(jnp.uint32 if nbits == 32 else jnp.uint64)
    width = ebit - sbit
    mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(~np.uint64(0))
    return ((ukeys >> sbit) & jnp.asarray(mask, ukeys.dtype))


def radix_sort(pol: Executor, keys, sbit: int = 0, ebit: Optional[int] = None):
    """Stable sort on the bit window [sbit, ebit) of integer keys
    (``zs::radix_sort``, ExecutionPolicy.hpp:458-612; cub::DeviceRadixSort on
    CUDA).  Lowers to a stable ``lax.sort`` of windowed keys."""
    nbits = np.dtype(keys.dtype).itemsize * 8
    ebit = nbits if ebit is None else ebit

    w = ebit - sbit
    n = keys.shape[0]
    if sbit == 0 and ebit >= nbits:
        # whole-key window: stable == unstable for a key-only sort
        # (equal keys are indistinguishable) -> 1-op unstable
        return sort(pol, keys)
    if w + _bits_for(n) <= 31:
        # pack (window, rank): rank ties reproduce stability; the full
        # keys ride as the single payload (2-op unstable, cheaper than
        # the 2-op stable windowed form)
        rb = _bits_for(n)

        def kern_packed(k):
            wk = _bit_window(k, sbit, ebit).astype(jnp.int32)
            rank = jnp.arange(n, dtype=jnp.int32)
            _, out = jax.lax.sort(((wk << rb) | rank, k), num_keys=1,
                                  is_stable=False)
            return out

        return pol.run(kern_packed, keys, label="radix_sort")

    def kern(k):
        w = _bit_window(k, sbit, ebit)
        _, out = jax.lax.sort((w, k), num_keys=1, is_stable=True)
        return out

    return pol.run(kern, keys, label="radix_sort")


def radix_sort_pair(pol: Executor, keys, vals, sbit: int = 0,
                    ebit: Optional[int] = None, vals_are_ranks=False):
    """Stable key-value sort on the bit window [sbit, ebit).

    ``vals_are_ranks=True`` asserts vals are distinct and ascending with
    position (the permutation-builder idiom, ``vals = arange``): ties
    ordered by val are then exactly the stable order, enabling the
    packed fast path when window + val widths fit 31 bits (faster than
    the 3-op stable form; chosen before the move to the GPU, not
    re-measured on the H100)."""
    nbits = np.dtype(keys.dtype).itemsize * 8
    ebit = nbits if ebit is None else ebit
    w = ebit - sbit
    n = keys.shape[0]
    if vals_are_ranks and w + _bits_for(n) <= 31:
        rb = _bits_for(n)
        mask = (1 << rb) - 1

        def kern_ranks(k, v):
            wk = _bit_window(k, sbit, ebit).astype(jnp.int32)
            p, ko = jax.lax.sort(((wk << rb) | v.astype(jnp.int32), k),
                                 num_keys=1, is_stable=False)
            return ko, (p & mask).astype(vals.dtype)

        return pol.run(kern_ranks, keys, vals, label="radix_sort_pair")
    if w + _bits_for(n) <= 31:
        # stability via packed rank; keys and vals ride (3-op unstable)
        rb = _bits_for(n)

        def kern_packed(k, v):
            wk = _bit_window(k, sbit, ebit).astype(jnp.int32)
            rank = jnp.arange(n, dtype=jnp.int32)
            _, ko, vo = jax.lax.sort(((wk << rb) | rank, k, v),
                                     num_keys=1, is_stable=False)
            return ko, vo

        return pol.run(kern_packed, keys, vals, label="radix_sort_pair")

    def kern(k, v):
        w = _bit_window(k, sbit, ebit)
        _, ko, vo = jax.lax.sort((w, k, v), num_keys=1, is_stable=True)
        return ko, vo

    return pol.run(kern, keys, vals, label="radix_sort_pair")


def argsort_stable(pol: Executor, keys, key_bound=None):
    """Stable argsort — the backbone of the sort+segment scatter idiom.

    With a static ``key_bound`` whose width + rank width fits 31 bits,
    the permutation comes from ONE packed unstable sort."""
    n = keys.shape[0]
    if key_bound is not None and _bits_for(key_bound) + _bits_for(n) <= 31:
        rb = _bits_for(n)
        mask = (1 << rb) - 1

        def kern_packed(k):
            p = (k.astype(jnp.int32) << rb) | jnp.arange(n, dtype=jnp.int32)
            return jax.lax.sort(p, is_stable=False) & mask

        return pol.run(kern_packed, keys, label="argsort_stable")

    def kern(k):
        idx = jnp.arange(k.shape[0], dtype=jnp.int32)
        _, perm = jax.lax.sort((k, idx), num_keys=1, is_stable=True)
        return perm

    return pol.run(kern, keys, label="argsort_stable")


# -- histogram / segment ops (atomics replacement) ----------------------------

def histogram(pol: Executor, indices, num_bins: int, weights=None,
              dtype=None):
    """Counting histogram — in place of ``atomic_add`` counters
    (``execution/Atomics.hpp:28-60``).

    Small ``num_bins`` uses a one-hot matmul (full float32 products);
    large bin counts fall back to XLA ``segment_sum``.
    """
    dtype = dtype or (weights.dtype if weights is not None else jnp.int32)

    def kern(idx, w):
        n = idx.shape[0]
        data = jnp.ones((n,), dtype) if w is None else w.astype(dtype)
        if num_bins <= 1024:
            onehot = (idx[:, None] ==
                      jnp.arange(num_bins, dtype=idx.dtype)[None, :])
            # HIGHEST: a default-precision float32 product may run as TF32
            return jnp.matmul(jnp.asarray(onehot, dtype).T, data,
                              precision=jax.lax.Precision.HIGHEST)
        return jax.ops.segment_sum(data, idx, num_segments=num_bins)

    return pol.run(kern, indices, weights, label="histogram")


def segment_reduce(pol: Executor, data, segment_ids, num_segments: int,
                   op=jnp.add, indices_are_sorted: bool = False):
    """Segmented reduction — scatter-accumulate without atomics."""
    fns = {jnp.add: jax.ops.segment_sum, "add": jax.ops.segment_sum,
           "sum": jax.ops.segment_sum,
           jnp.minimum: jax.ops.segment_min, "min": jax.ops.segment_min,
           jnp.maximum: jax.ops.segment_max, "max": jax.ops.segment_max,
           jnp.multiply: jax.ops.segment_prod, "prod": jax.ops.segment_prod}
    fn = fns.get(op)
    if fn is None:
        raise ValueError(f"unsupported segment op {op!r}")

    def kern(d, sid):
        return fn(d, sid, num_segments=num_segments,
                  indices_are_sorted=indices_are_sorted)

    return pol.run(kern, data, segment_ids, label="segment_reduce")


# -- stream compaction --------------------------------------------------------

def scatter_drop(target, dst, vals, op: str = "set"):
    """Scatter with drop semantics that stays in-bounds (checkify-clean):
    the buffer grows a trash slot, lanes with ``dst >= n`` land there, and
    the slot is sliced off.  ``op``: "set" | "add" | "max" | "min"."""
    n = target.shape[0]
    trash = jnp.zeros((1,) + target.shape[1:], target.dtype)
    buf = jnp.concatenate([target, trash])
    d = jnp.clip(dst, 0, n)
    at = buf.at[d]
    buf = getattr(at, op)(vals)
    return buf[:n]


def count_if(pol: Executor, mask):
    return pol.run(lambda m: jnp.sum(m.astype(jnp.int32)), mask,
                   label="count_if")


def select_if(pol: Executor, data, mask, fill=0):
    """Compact elements where mask is true into the front of a same-capacity
    buffer; returns (packed, count).  Static shapes: the tail is ``fill``.

    (The reference's ``filter/copy_if`` idiom; static shapes need padded
    capacities, SURVEY §7 hard-part 3.)
    """
    def kern(d, m):
        n = d.shape[0]
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        cnt = pos[-1] + 1 if n else jnp.int32(0)
        dst = jnp.where(m, pos, n)  # dropped lanes land in the trash slot
        out_shape = (n,) + d.shape[1:]
        packed = scatter_drop(jnp.full(out_shape, fill, d.dtype), dst, d)
        return packed, cnt

    return pol.run(kern, data, mask, label="select_if")


def unique(pol: Executor, sorted_keys, valid_mask=None, fill=None):
    """Unique over **sorted** keys: returns (unique_padded, count, inverse).

    ``inverse[i]`` is the index of ``sorted_keys[i]`` in the unique list —
    the compaction used to build block tables (reference HashTable
    ``_activeKeys`` compaction, container/HashTable.hpp).
    """
    if fill is None:
        fill = np.iinfo(np.dtype(sorted_keys.dtype)).max

    def kern(k, vm):
        n = k.shape[0]
        neq = jnp.concatenate([jnp.ones((1,), bool), k[1:] != k[:-1]])
        if vm is not None:
            neq = neq & vm
        inv = jnp.cumsum(neq.astype(jnp.int32)) - 1
        cnt = inv[-1] + 1 if n else jnp.int32(0)
        dst = jnp.where(neq, inv, n)
        uniq = scatter_drop(jnp.full((n,), fill, k.dtype), dst, k)
        if vm is not None:
            inv = jnp.where(vm, inv, -1)
        return uniq, cnt, inv

    return pol.run(kern, sorted_keys, valid_mask, label="unique")
