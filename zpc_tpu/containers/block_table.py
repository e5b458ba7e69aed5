"""``BlockTable`` — the sort-built spatial hash table.

The reference uses concurrent GPU hash tables for block partitioning:
``HashTable`` open addressing with ``atomicKeyCAS`` spin insert
(container/HashTable.hpp:356-427) and ``bht`` bucketed cuckoo hashing with
warp-cooperative inserts (container/Bht.hpp:489-560).  Here concurrent
insertion (device atomics, per-thread divergent probing) is replaced by the
**sort-based build** (SURVEY §7 hard-part 2):

    pack block coords -> stable sort -> unique-compact -> sorted key table

Queries are binary searches (``searchsorted``) over the sorted keys — O(log n)
gathers, fully vectorized, no divergence.  The ``_activeKeys`` compaction of
the reference comes for free: the table *is* the compacted active-key list.

Overflow semantics: the reference ``bht`` sets ``_buildSuccess=false`` on
overflow for host-side rebuild (Bht.hpp:163-175).  Here the analog is
``count > capacity`` after a build — the count is exact, so the host can
re-enter with a larger capacity (re-trace), and :func:`build_overflowed`
exposes the flag.

Coordinate packing: block coords in ``[-2^(b-1), 2^(b-1))`` per axis are
offset-shifted and bit-packed into one int32 key (dim=3: 10 bits/axis ->
1024^3 blocks; dim=2: 15 bits/axis).  With 4^3-cell blocks that addresses a
4096^3-cell domain — widen to dual-int32 keys when needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "KEY_SENTINEL",
    "pack_coords",
    "unpack_key",
    "BlockTable",
    "build_block_table",
    "build_overflowed",
    "WideBlockTable",
    "build_wide_block_table",
    "pack_coords_wide",
    "unpack_key_wide",
]

KEY_SENTINEL = np.int32(np.iinfo(np.int32).max)

_BITS = {2: 15, 3: 10}


def _offset(dim: int) -> int:
    return 1 << (_BITS[dim] - 1)


def pack_coords(coords: jax.Array) -> jax.Array:
    """Pack integer block coords ``[..., dim]`` into sortable int32 keys."""
    dim = coords.shape[-1]
    bits, off = _BITS[dim], _offset(dim)
    key = jnp.zeros(coords.shape[:-1], jnp.int32)
    for d in range(dim):
        key = (key << bits) | (coords[..., d].astype(jnp.int32) + off)
    return key


def unpack_key(key: jax.Array, dim: int) -> jax.Array:
    bits, off = _BITS[dim], _offset(dim)
    mask = (1 << bits) - 1
    comps = []
    for d in range(dim):
        shift = bits * (dim - 1 - d)
        comps.append(((key >> shift) & mask) - off)
    return jnp.stack(comps, axis=-1).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockTable:
    """Sorted-unique key table over packed block coordinates.

    ``keys`` is capacity-padded with ``KEY_SENTINEL`` (sorts last); ``count``
    is the *traced* number of active entries (active-block count varies per
    step under jit — SURVEY §7 hard-part 3).
    """

    keys: jax.Array   # [capacity] int32, sorted ascending, sentinel-padded
    count: jax.Array  # scalar int32
    dim: int = dataclasses.field(metadata=dict(static=True), default=3)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def active_coords(self) -> jax.Array:
        """Unpacked block coords per table slot ``[capacity, dim]``
        (reference ``_activeKeys``); sentinel slots give garbage coords —
        mask with :meth:`mask`."""
        return unpack_key(self.keys, self.dim)

    @property
    def mask(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.count

    # -- queries (bht::query analog) -----------------------------------------
    def query_keys(self, qkeys: jax.Array) -> jax.Array:
        """Return slot index per packed query key, -1 if absent."""
        idx = jnp.searchsorted(self.keys, qkeys).astype(jnp.int32)
        idx = jnp.minimum(idx, self.capacity - 1)
        hit = (self.keys[idx] == qkeys) & (qkeys != KEY_SENTINEL)
        return jnp.where(hit, idx, -1)

    def query(self, coords: jax.Array) -> jax.Array:
        """Return slot index per block coord ``[..., dim]``, -1 if absent."""
        return self.query_keys(pack_coords(coords))


def build_block_table(coords: jax.Array, capacity: int,
                      valid: Optional[jax.Array] = None,
                      dim: Optional[int] = None) -> Tuple[BlockTable, jax.Array]:
    """Build a BlockTable from (possibly duplicated) candidate block coords.

    Sort-based replacement for concurrent hash insert (HashTable.hpp:356-427).
    Returns ``(table, inverse)`` where ``inverse[i]`` is the table slot of
    ``coords[i]`` (or -1 for invalid lanes) — so callers immediately know each
    candidate's block index without a second query.

    jit-safe: all shapes static; ``capacity`` bounds the active block count.
    """
    dim = dim if dim is not None else coords.shape[-1]
    n = coords.shape[0]
    keys = pack_coords(coords)
    if valid is not None:
        keys = jnp.where(valid, keys, KEY_SENTINEL)
    order = jnp.argsort(keys)                     # stable
    skeys = keys[order]
    neq = jnp.concatenate([jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])
    neq = neq & (skeys != KEY_SENTINEL)
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1  # unique slot of sorted lane
    count = rank[-1] + 1 if n else jnp.int32(0)
    dst = jnp.where(neq, rank, capacity)          # overflow lanes dropped
    table_keys = jnp.full((capacity + 1,), KEY_SENTINEL, jnp.int32)
    table_keys = table_keys.at[jnp.clip(dst, 0, capacity)].set(skeys)[:capacity]
    # scatter sorted-lane ranks back to the original order
    inverse = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.where(skeys != KEY_SENTINEL, rank, -1))
    inverse = jnp.where(inverse >= capacity, -1, inverse)
    return BlockTable(table_keys, count.astype(jnp.int32), dim), inverse


def build_overflowed(table) -> jax.Array:
    """True when the last build exceeded capacity (bht ``_buildSuccess``
    analog, Bht.hpp:163-175); host should rebuild with a larger capacity."""
    return table.count > table.capacity


# ---------------------------------------------------------------------------
# Wide (dual-int32) keys — domains beyond 1024^3 blocks
# ---------------------------------------------------------------------------

_YW_OFF = 1 << 14         # y in [-16384, 16384) blocks (15 bits, no sign)
_ZW_OFF = 1 << 15         # z in [-32768, 32768) blocks (16 bits)
_XW_OFF = 1 << 29         # x in [-2^29, 2^29) (sentinel-collision-free)


def pack_coords_wide(coords: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Pack 3-D block coords into a lexicographic (kx, kyz) int32 pair.

    Lifts the single-int32 1024^3-block cap (10 bits/axis) to
    ±2^29 x ±16384 x ±32768 blocks (kyz keeps the sign bit clear so the
    pair sorts lexicographically as plain int32s).
    """
    kx = coords[..., 0].astype(jnp.int32) + _XW_OFF
    kyz = ((coords[..., 1].astype(jnp.int32) + _YW_OFF) << 16) | \
        (coords[..., 2].astype(jnp.int32) + _ZW_OFF)
    return kx, kyz


def unpack_key_wide(kx: jax.Array, kyz: jax.Array) -> jax.Array:
    x = kx - _XW_OFF
    y = ((kyz >> 16) & 0x7FFF) - _YW_OFF
    z = (kyz & 0xFFFF) - _ZW_OFF
    return jnp.stack([x, y, z], axis=-1).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WideBlockTable:
    """Dual-int32-key table: same contract as :class:`BlockTable`, domains
    beyond the packed-int32 1024^3-block cap (the reference's 64-bit key
    hash tables, Bht.hpp key_t; enabled via ``sparse_grid(wide_keys=True)``).
    """

    kx: jax.Array     # [capacity] int32, lexicographic major
    kyz: jax.Array    # [capacity] int32, minor
    count: jax.Array
    dim: int = dataclasses.field(metadata=dict(static=True), default=3)

    @property
    def capacity(self) -> int:
        return self.kx.shape[0]

    @property
    def keys(self) -> jax.Array:
        """Major key column (sentinel-padded) — kept for shape-generic
        callers; identity lives in (kx, kyz)."""
        return self.kx

    @property
    def active_coords(self) -> jax.Array:
        return unpack_key_wide(self.kx, self.kyz)

    @property
    def mask(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.count

    def query(self, coords: jax.Array) -> jax.Array:
        """Slot per block coord, -1 if absent: vectorized lexicographic
        binary search over the sorted (kx, kyz) pair."""
        qx, qyz = pack_coords_wide(coords)
        cap = self.capacity
        lo = jnp.zeros(qx.shape, jnp.int32)
        hi = jnp.full(qx.shape, cap, jnp.int32)
        steps = int(np.ceil(np.log2(max(cap, 2)))) + 1
        for _ in range(steps):
            mid = (lo + hi) // 2
            midc = jnp.minimum(mid, cap - 1)
            mx = self.kx[midc]
            myz = self.kyz[midc]
            less = (mx < qx) | ((mx == qx) & (myz < qyz))
            lo = jnp.where(less, mid + 1, lo)
            hi = jnp.where(less, hi, mid)
        idx = jnp.minimum(lo, cap - 1)
        hit = (self.kx[idx] == qx) & (self.kyz[idx] == qyz) & \
            (lo < self.count)
        return jnp.where(hit, idx, -1)


def build_wide_block_table(coords: jax.Array, capacity: int,
                           valid: Optional[jax.Array] = None
                           ) -> Tuple[WideBlockTable, jax.Array]:
    """Sort-based build over dual-int32 keys (3-D only)."""
    n = coords.shape[0]
    kx, kyz = pack_coords_wide(coords)
    if valid is not None:
        kx = jnp.where(valid, kx, KEY_SENTINEL)
        kyz = jnp.where(valid, kyz, KEY_SENTINEL)
    lane = jnp.arange(n, dtype=jnp.int32)
    sx, syz, sl = jax.lax.sort((kx, kyz, lane), num_keys=2, is_stable=True)
    neq = jnp.concatenate(
        [jnp.ones((1,), bool), (sx[1:] != sx[:-1]) | (syz[1:] != syz[:-1])])
    neq = neq & (sx != KEY_SENTINEL)
    rank = jnp.cumsum(neq.astype(jnp.int32)) - 1
    count = rank[-1] + 1
    dst = jnp.clip(jnp.where(neq, rank, capacity), 0, capacity)
    tx = jnp.full((capacity + 1,), KEY_SENTINEL, jnp.int32).at[dst].set(
        sx)[:capacity]
    tyz = jnp.full((capacity + 1,), KEY_SENTINEL, jnp.int32).at[dst].set(
        syz)[:capacity]
    inverse = jnp.zeros((n,), jnp.int32).at[sl].set(
        jnp.where(sx != KEY_SENTINEL, rank, -1))
    inverse = jnp.where(inverse >= capacity, -1, inverse)
    return WideBlockTable(tx, tyz, count.astype(jnp.int32), 3), inverse
