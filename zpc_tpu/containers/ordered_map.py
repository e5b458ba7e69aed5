"""``OrderedMap`` — the ``RBTreeMap`` (container/RBTreeMap.hpp)
plus ``RingBuffer`` (container/RingBuffer.hpp).

A red-black tree gives per-thread ordered insert/erase/lookup on CUDA; under
XLA the natural ordered container is a **sorted key/value array** with batch
operations: bulk insert/erase are merge+compact passes (O((n+m) log) sorts),
lookup is binary search, ordered iteration is the array itself.  Same
capability (ordered associative map), hardware-native costs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["OrderedMap", "ordered_map", "RingBuffer", "ring_buffer"]

_SENTINEL = np.int32(np.iinfo(np.int32).max)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OrderedMap:
    keys: jax.Array     # [capacity] int32 sorted, sentinel padded
    values: jax.Array   # [capacity, ...] aligned with keys
    count: jax.Array    # scalar int32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def mask(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.count

    # -- queries --------------------------------------------------------------
    def find(self, qkeys: jax.Array) -> jax.Array:
        """Index per query key, -1 when absent."""
        idx = jnp.searchsorted(self.keys, qkeys).astype(jnp.int32)
        idx = jnp.minimum(idx, self.capacity - 1)
        hit = (self.keys[idx] == qkeys) & (qkeys != _SENTINEL)
        return jnp.where(hit, idx, -1)

    def get(self, qkeys: jax.Array, default=0) -> jax.Array:
        idx = self.find(qkeys)
        safe = jnp.maximum(idx, 0)
        val = self.values[safe]
        miss = (idx < 0).reshape(idx.shape + (1,) * (val.ndim - idx.ndim))
        return jnp.where(miss, jnp.asarray(default, val.dtype), val)

    def lower_bound(self, qkeys: jax.Array) -> jax.Array:
        return jnp.searchsorted(self.keys, qkeys).astype(jnp.int32)

    # -- bulk mutation (functional) -------------------------------------------
    def insert(self, new_keys: jax.Array,
               new_values: jax.Array) -> "OrderedMap":
        """Batch upsert: later duplicates win (within the batch, the last
        occurrence; against existing entries, the new value)."""
        cap = self.capacity
        m = new_keys.shape[0]
        # priority: existing = 0, new = 1 + batch index (last wins)
        all_keys = jnp.concatenate([self.keys, new_keys])
        vshape = self.values.shape[1:]
        all_vals = jnp.concatenate(
            [self.values, new_values.reshape((m,) + vshape)])
        prio = jnp.concatenate([
            jnp.zeros((cap,), jnp.int32),
            1 + jnp.arange(m, dtype=jnp.int32)])
        live = jnp.concatenate([self.mask, jnp.ones((m,), bool)])
        keys_m = jnp.where(live, all_keys, _SENTINEL)
        # sort by (key asc, prio desc) -> first of each run is the winner
        order = jnp.lexsort((-prio, keys_m))
        sk = keys_m[order]
        sv = all_vals[order]
        first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
        first = first & (sk != _SENTINEL)
        rank = jnp.cumsum(first.astype(jnp.int32)) - 1
        count = rank[-1] + 1
        dst = jnp.where(first, jnp.minimum(rank, cap), cap)
        out_keys = jnp.full((cap + 1,), _SENTINEL, jnp.int32
                            ).at[dst].set(sk)[:cap]
        out_vals = jnp.zeros((cap + 1,) + vshape, sv.dtype
                             ).at[dst].set(sv)[:cap]
        return OrderedMap(out_keys, out_vals,
                          jnp.minimum(count, cap).astype(jnp.int32))

    def erase(self, del_keys: jax.Array) -> "OrderedMap":
        cap = self.capacity
        hit = self.find(del_keys)
        kill = jnp.zeros((cap,), bool).at[jnp.maximum(hit, 0)].set(
            hit >= 0)
        keep = self.mask & ~kill
        keys_m = jnp.where(keep, self.keys, _SENTINEL)
        order = jnp.argsort(keys_m)
        sk = keys_m[order]
        sv = self.values[order]
        count = jnp.sum(keep.astype(jnp.int32))
        return OrderedMap(sk, sv, count)


def ordered_map(capacity: int, value_shape=(), value_dtype=jnp.float32
                ) -> OrderedMap:
    return OrderedMap(
        jnp.full((capacity,), _SENTINEL, jnp.int32),
        jnp.zeros((capacity,) + tuple(value_shape), value_dtype),
        jnp.int32(0))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RingBuffer:
    """Fixed-capacity FIFO (container/RingBuffer.hpp), functional."""

    data: jax.Array     # [capacity, ...]
    head: jax.Array     # scalar int32 (oldest)
    size: jax.Array     # scalar int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def push(self, value) -> "RingBuffer":
        cap = self.capacity
        tail = (self.head + self.size) % cap
        data = self.data.at[tail].set(value)
        full = self.size >= cap
        return RingBuffer(data,
                          jnp.where(full, (self.head + 1) % cap, self.head),
                          jnp.minimum(self.size + 1, cap))

    def pop(self) -> Tuple["RingBuffer", jax.Array]:
        val = self.data[self.head]
        empty = self.size == 0
        return (RingBuffer(self.data,
                           jnp.where(empty, self.head,
                                     (self.head + 1) % self.capacity),
                           jnp.maximum(self.size - 1, 0)), val)

    def peek(self, i) -> jax.Array:
        return self.data[(self.head + i) % self.capacity]


def ring_buffer(capacity: int, item_shape=(), dtype=jnp.float32
                ) -> RingBuffer:
    return RingBuffer(jnp.zeros((capacity,) + tuple(item_shape), dtype),
                      jnp.int32(0), jnp.int32(0))
