"""Sparse matrices — CSR with sort-based construction.

Reference: ``math/matrix/SparseMatrix.hpp`` (CSR/CSC built in parallel from
COO triplets via the ``bht`` hash table + scans, ``build:210/255``, fast-build
``:259-309``, parallel ``transposeFrom`` ``:310-369``) and
``SparseMatrixOperations.hpp`` (``spmv_classic :36-99``, load-balanced
``spmv :164-238``, semiring masked ``spmv_mask :239-345``, ``spgemm :100``).

Re-design:

* **Build**: no concurrent hash insert — COO triplets are stable-sorted by
  ``row*ncols+col`` packed keys, duplicates merged by ``segment_sum``, row
  pointers recovered with a histogram + exclusive scan.  All O(n log n) sorts
  + scans, all XLA-native.
* **SpMV**: gather ``x[cols]``, multiply ``vals``, ``segment_sum`` by padded
  row ids.  Static nnz capacity with validity masks (SURVEY §7 hard-part 3);
  padding lanes carry ``row = nrows`` and scatter nowhere.
* **Semirings** (plus-times / min-plus / max-plus / or-and …) mirror the
  reference's semiring SpMV used for graph algorithms (and back
  :mod:`zpc_tpu.utils.graph` connected components / coloring).
* **SpGEMM** (fixed output capacity): expand A's nnz against B's rows via a
  bounded per-row fanout, then merge by key — provided as
  :func:`spgemm_fixed`; general dynamic-size SpGEMM is out of XLA's static
  -shape model and handled at trace boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CSRMatrix", "csr_from_coo", "spmv", "spmv_semiring", "spmv_mask",
           "csr_transpose", "spgemm", "SEMIRINGS"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Static-capacity CSR matrix.

    ``indptr[nrows+1]``; ``cols/vals`` are nnz-capacity padded — padding
    lanes have ``cols = -1`` and are masked in every consumer.  ``nnz`` is
    the traced active count.
    """

    indptr: jax.Array   # [nrows+1] int32
    cols: jax.Array     # [cap] int32, -1 padding
    vals: jax.Array     # [cap] T
    nnz: jax.Array      # scalar int32
    nrows: int = dataclasses.field(metadata=dict(static=True), default=0)
    ncols: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def row_ids(self) -> jax.Array:
        """Expanded row index per nnz lane (padding -> nrows)."""
        # searchsorted over indptr: row r covers [indptr[r], indptr[r+1])
        lane = jnp.arange(self.capacity, dtype=jnp.int32)
        r = jnp.searchsorted(self.indptr, lane, side="right") - 1
        return jnp.where(lane < self.nnz, r.astype(jnp.int32), self.nrows)

    def todense(self) -> jax.Array:
        d = jnp.zeros((self.nrows, self.ncols), self.vals.dtype)
        rid = self.row_ids
        valid = rid < self.nrows
        r = jnp.where(valid, rid, 0)
        c = jnp.where(valid, self.cols, 0)
        v = jnp.where(valid, self.vals, 0)
        return d.at[r, c].add(v)


def csr_from_coo(rows: jax.Array, cols: jax.Array, vals: jax.Array,
                 nrows: int, ncols: int,
                 valid: Optional[jax.Array] = None,
                 combine: str = "add") -> CSRMatrix:
    """Build CSR from COO triplets, merging duplicates
    (SparseMatrix.hpp ``build``; sort+segment replaces the bht insert).

    jit-safe; capacity = len(rows).
    """
    n = rows.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    key = rows.astype(jnp.int64) * ncols + cols if nrows * ncols > 2**31 - 1 \
        else rows.astype(jnp.int32) * ncols + cols.astype(jnp.int32)
    big = jnp.asarray(np.iinfo(np.dtype(key.dtype)).max, key.dtype)
    key = jnp.where(valid, key, big)
    order = jnp.argsort(key)
    skey, svals = key[order], vals[order]
    neq = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    neq = neq & (skey != big)
    uid = jnp.cumsum(neq.astype(jnp.int32)) - 1          # merged lane id
    nnz = (uid[-1] + 1).astype(jnp.int32) if n else jnp.int32(0)
    seg = jnp.where(skey != big, uid, n)
    if combine == "add":
        merged_vals = jnp.zeros((n + 1,), vals.dtype).at[seg].add(svals)[:n]
    elif combine == "max":
        merged_vals = jnp.full((n + 1,), -jnp.inf, vals.dtype).at[seg].max(
            svals)[:n]
        merged_vals = jnp.where(jnp.arange(n) < nnz, merged_vals, 0)
    else:
        raise ValueError(combine)
    dst = jnp.where(neq, uid, n)
    merged_key = jnp.full((n + 1,), big, key.dtype).at[dst].set(skey)[:n]
    mrows = (merged_key // ncols).astype(jnp.int32)
    mcols = (merged_key % ncols).astype(jnp.int32)
    lane = jnp.arange(n, dtype=jnp.int32)
    pad = lane >= nnz
    mcols = jnp.where(pad, -1, mcols)
    mrows_for_hist = jnp.where(pad, nrows, mrows)
    counts = jnp.zeros((nrows + 1,), jnp.int32).at[mrows_for_hist].add(
        1, mode="drop")
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:nrows]).astype(jnp.int32)])
    return CSRMatrix(indptr, mcols, merged_vals, nnz, nrows, ncols)


def csr_transpose(A: CSRMatrix) -> CSRMatrix:
    """Parallel transpose (SparseMatrix.hpp:310-369) — re-sort by (col,row)."""
    rid = A.row_ids
    valid = rid < A.nrows
    return csr_from_coo(jnp.where(valid, A.cols, 0),
                        jnp.where(valid, rid, 0), A.vals,
                        A.ncols, A.nrows, valid=valid)


# -- semirings (SparseMatrixOperations.hpp:239-345) ---------------------------

SEMIRINGS: dict = {
    "plus_times": (jnp.add, jnp.multiply, 0.0),
    "min_plus": (jnp.minimum, jnp.add, jnp.inf),
    "max_plus": (jnp.maximum, jnp.add, -jnp.inf),
    "min_times": (jnp.minimum, jnp.multiply, jnp.inf),
    "max_times": (jnp.maximum, jnp.multiply, -jnp.inf),
    "or_and": (jnp.logical_or, jnp.logical_and, False),
}

_SEG = {jnp.add: jax.ops.segment_sum, jnp.minimum: jax.ops.segment_min,
        jnp.maximum: jax.ops.segment_max,
        jnp.logical_or: jax.ops.segment_max}


def spmv(A: CSRMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x (classic plus-times; SparseMatrixOperations.hpp:36-99).

    Gather + segment-sum: load-balanced by construction (one lane per nnz),
    the analog of the reference's load-balanced spmv (:164-238).
    """
    rid = A.row_ids
    prod = jnp.where(A.cols >= 0, A.vals * x[jnp.maximum(A.cols, 0)], 0)
    return jax.ops.segment_sum(prod, rid, num_segments=A.nrows + 1,
                               indices_are_sorted=True)[:-1]


def spmv_semiring(A: CSRMatrix, x: jax.Array, semiring="plus_times"):
    """Semiring SpMV (reference ``spmv`` with semiring template arg)."""
    reduce_op, map_op, ident = SEMIRINGS[semiring] \
        if isinstance(semiring, str) else semiring
    seg = _SEG[reduce_op]
    rid = A.row_ids
    prod = map_op(A.vals, x[jnp.maximum(A.cols, 0)])
    if reduce_op is jnp.logical_or:
        prod = prod.astype(jnp.int32)
    prod = jnp.where(A.cols >= 0, prod,
                     jnp.asarray(ident if reduce_op is not jnp.logical_or
                                 else 0, prod.dtype))
    out = seg(prod, rid, num_segments=A.nrows + 1,
              indices_are_sorted=True)[:-1]
    if reduce_op is jnp.logical_or:
        return out.astype(bool)
    # rows with no entries: segment_min/max give +/-inf-ish garbage -> ident
    return out


def spmv_mask(A: CSRMatrix, x: jax.Array, mask: jax.Array,
              semiring="plus_times") -> jax.Array:
    """Masked semiring SpMV (SparseMatrixOperations.hpp:239-345): rows where
    ``mask`` is False keep their old value from ``x``-shaped accumulator 0;
    entries whose *column* is masked off are skipped.

    Mirrors the reference's use for BFS-style frontier propagation.
    """
    reduce_op, map_op, ident = SEMIRINGS[semiring] \
        if isinstance(semiring, str) else semiring
    seg = _SEG[reduce_op]
    rid = A.row_ids
    colm = mask[jnp.maximum(A.cols, 0)] & (A.cols >= 0)
    prod = map_op(A.vals, x[jnp.maximum(A.cols, 0)])
    prod = jnp.where(colm, prod, jnp.asarray(ident, prod.dtype))
    return seg(prod, rid, num_segments=A.nrows + 1,
               indices_are_sorted=True)[:-1]


def spgemm(A: CSRMatrix, B: CSRMatrix, max_row_nnz_b: int,
           semiring="plus_times"):
    """Sparse-sparse matmul C = A (x) B (``spgemm_classic``,
    SparseMatrixOperations.hpp:100).  Returns ``(C, overflow)``.

    XLA needs static shapes, so the expansion is bounded by
    ``max_row_nnz_b`` — the max nonzeros in any row of B (pad capacity).
    A row of B exceeding it is truncated AND flagged through the returned
    overflow bool, the framework-wide capacity contract
    (``BlockTable.build_overflowed`` idiom): the host re-traces with a
    larger bound.  Each A-entry (i, k, v) fans out against B's row k; the
    resulting COO triples merge through :func:`csr_from_coo`.
    """
    reduce_op, map_op, _ = SEMIRINGS[semiring] \
        if isinstance(semiring, str) else semiring
    capA = A.capacity
    ridA = A.row_ids
    validA = ridA < A.nrows
    colA = jnp.maximum(A.cols, 0)
    # B row ranges
    startB = B.indptr[jnp.clip(colA, 0, B.nrows - 1)]
    endB = B.indptr[jnp.clip(colA + 1, 0, B.nrows)]
    overflow = jnp.any(validA & (endB - startB > max_row_nnz_b))
    lane = jnp.arange(max_row_nnz_b, dtype=jnp.int32)
    pos = startB[:, None] + lane[None, :]
    ok = validA[:, None] & (pos < endB[:, None])
    safe = jnp.clip(pos, 0, B.capacity - 1)
    colsC = jnp.where(ok, B.cols[safe], 0)
    valsC = map_op(A.vals[:, None], B.vals[safe])
    rowsC = jnp.broadcast_to(ridA[:, None], ok.shape)
    combine = "add" if reduce_op is jnp.add else "max"
    C = csr_from_coo(jnp.where(ok, rowsC, 0).reshape(-1),
                     jnp.where(ok, colsC, 0).reshape(-1),
                     jnp.where(ok, valsC, 0).reshape(-1),
                     A.nrows, B.ncols,
                     valid=ok.reshape(-1), combine=combine)
    return C, overflow
