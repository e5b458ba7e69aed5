"""Intra-block cooperative lane ops — the vocabulary for the
reference's warp layer (``execution/Intrinsics.hpp:102-165``:
``shfl_up/down/xor_sync``, ``ballot_sync``; ``container/Bht.hpp:545-560``
warp-cooperative ``tile_insert``).

Here the natural "warp" is a 128-wide lane axis of a tile, and cross-lane
cooperation is expressed with full-width vector ops (roll, reversed-block
reshapes, log-step scans) rather than per-thread intrinsics.  Every function
here is pure ``jnp`` over a designated lane axis, so the same code runs

* inside a Pallas kernel body (``roll``/reshape/select),
* under ``pl.pallas_call(..., interpret=True)`` for oracle tests, and
* in plain traced JAX (host-level analogs, like ``math/bits.py`` for
  the scalar intrinsics).

Semantics follow CUDA's width-bounded shuffles: lanes are grouped into
independent windows of ``width`` lanes; data never crosses a window
boundary (out-of-window sources yield ``fill``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["shfl_up", "shfl_down", "shfl_xor", "ballot", "popcount",
           "lane_any", "lane_all", "lane_sum", "lane_scan",
           "segment_scan"]


def _norm_axis(x, axis):
    return axis % x.ndim


def _move(x, axis):
    """Move the lane axis last; return (moved, restore)."""
    axis = _norm_axis(x, axis)
    if axis == x.ndim - 1:
        return x, lambda y: y
    moved = jnp.moveaxis(x, axis, -1)
    return moved, lambda y: jnp.moveaxis(y, -1, axis)


def _split_windows(x, width):
    """[..., L] -> [..., L/width, width]."""
    L = x.shape[-1]
    assert L % width == 0, (L, width)
    return x.reshape(x.shape[:-1] + (L // width, width))


def shfl_up(x, delta: int, *, width: Optional[int] = None, axis: int = -1,
            fill=0):
    """Lane ``i`` receives lane ``i - delta`` of its window
    (``__shfl_up_sync``); the first ``delta`` lanes of each window get
    ``fill``."""
    x, restore = _move(x, axis)
    W = width or x.shape[-1]
    xs = _split_windows(x, W)
    shifted = jnp.roll(xs, delta, axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    out = jnp.where(idx >= delta, shifted, jnp.asarray(fill, x.dtype))
    return restore(out.reshape(x.shape))


def shfl_down(x, delta: int, *, width: Optional[int] = None,
              axis: int = -1, fill=0):
    """Lane ``i`` receives lane ``i + delta`` (``__shfl_down_sync``)."""
    x, restore = _move(x, axis)
    W = width or x.shape[-1]
    xs = _split_windows(x, W)
    shifted = jnp.roll(xs, -delta, axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    out = jnp.where(idx < W - delta, shifted, jnp.asarray(fill, x.dtype))
    return restore(out.reshape(x.shape))


def shfl_xor(x, mask: int, *, width: Optional[int] = None, axis: int = -1):
    """Lane ``i`` receives lane ``i ^ mask`` (``__shfl_xor_sync``) — the
    butterfly exchange.  Decomposes the mask into its set bits; each
    single-bit swap is a reversed-pair block reshape (no gathers)."""
    x, restore = _move(x, axis)
    W = width or x.shape[-1]
    assert mask < W, (mask, W)
    out = _split_windows(x, W)
    lead = out.shape[:-1]
    bit = 1
    while bit < W:
        if mask & bit:
            g = out.reshape(lead + (W // (2 * bit), 2, bit))
            out = jnp.flip(g, axis=-2).reshape(lead + (W,))
        bit <<= 1
    return restore(out.reshape(x.shape))


def ballot(pred, *, width: int = 32, axis: int = -1):
    """Pack each ``width``-lane window of a boolean vector into one
    integer (``__ballot_sync``): bit ``k`` of word ``w`` = lane
    ``w*width + k``.  Returns uint32 with the lane axis shrunk by
    ``width``."""
    assert width <= 32
    p, restore = _move(pred, axis)
    ps = _split_windows(p.astype(jnp.uint32), width)
    weights = (jnp.uint32(1) << jax.lax.broadcasted_iota(
        jnp.uint32, (width,), 0))
    packed = jnp.sum(ps * weights, axis=-1, dtype=jnp.uint32)
    return restore(packed)


def popcount(word):
    """Per-element population count of a uint32/int32 vector (the vector
    form of ``math/bits.py``'s scalar popc; SWAR, no loops)."""
    x = word.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def _window_reduce(x, op, width, axis):
    x, restore = _move(x, axis)
    W = width or x.shape[-1]
    xs = _split_windows(x, W)
    red = op(xs, axis=-1, keepdims=True)
    return restore(jnp.broadcast_to(red, xs.shape).reshape(x.shape))


def lane_any(pred, *, width: Optional[int] = None, axis: int = -1):
    """``__any_sync``: every lane sees whether any lane of its window is
    true (broadcast back to all lanes)."""
    return _window_reduce(pred.astype(jnp.bool_), jnp.any, width, axis)


def lane_all(pred, *, width: Optional[int] = None, axis: int = -1):
    """``__all_sync``."""
    return _window_reduce(pred.astype(jnp.bool_), jnp.all, width, axis)


def lane_sum(x, *, width: Optional[int] = None, axis: int = -1):
    """Window sum broadcast to every lane (the shfl_xor reduction tree
    collapsed into one vector reduce — same result, fewer ops)."""
    return _window_reduce(x, jnp.sum, width, axis)


def lane_scan(x, *, width: Optional[int] = None, axis: int = -1,
              exclusive: bool = False):
    """Inclusive (or exclusive) additive prefix scan within each lane
    window: the log2(W) roll-add ladder of the chunked-carry Pallas scan
    (``ops/scan_pallas.py``), exposed as a reusable cooperative op."""
    x, restore = _move(x, axis)
    W = width or x.shape[-1]
    xs = _split_windows(x, W)
    idx = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    v = xs
    d = 1
    while d < W:
        sh = jnp.roll(v, d, axis=-1)
        v = v + jnp.where(idx >= d, sh, jnp.zeros_like(sh))
        d <<= 1
    if exclusive:
        sh = jnp.roll(v, 1, axis=-1)
        v = jnp.where(idx >= 1, sh, jnp.zeros_like(sh))
    return restore(v.reshape(x.shape))


def segment_scan(x, seg_start, *, width: Optional[int] = None,
                 axis: int = -1):
    """Segmented inclusive additive scan within lane windows:
    ``seg_start`` marks the first lane of each segment; the running sum
    resets there (Sengupta et al.'s flag-propagating ladder — the
    cooperative primitive behind warp-level compaction/histogram
    patterns like Bht.hpp's tile_insert bookkeeping)."""
    x, restore = _move(x, axis)
    f0, _ = _move(seg_start, axis)
    W = width or x.shape[-1]
    xs = _split_windows(x, W)
    fs = _split_windows(f0.astype(jnp.bool_), W)
    idx = jax.lax.broadcasted_iota(jnp.int32, (W,), 0)
    v, f = xs, fs
    d = 1
    while d < W:
        vs = jnp.roll(v, d, axis=-1)
        fsh = jnp.roll(f, d, axis=-1)
        in_range = idx >= d
        vs = jnp.where(in_range, vs, jnp.zeros_like(vs))
        fsh = jnp.where(in_range, fsh, jnp.ones_like(fsh))
        v = jnp.where(f, v, v + vs)
        f = f | fsh
        d <<= 1
    return restore(v.reshape(x.shape))
