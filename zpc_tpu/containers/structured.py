"""``StructuredField`` — the SoA ``zs::TileVector``
(container/TileVector.hpp).

The reference TileVector is an AoSoA container: runtime-declared named
multi-channel properties, stored in lane-width tiles so CUDA threads get
coalesced loads.  Under XLA the compiler owns physical layout and tiles arrays
itself, so AoSoA is counterproductive (SURVEY §7): a StructuredField is a
**dict of SoA arrays**, one per property, each ``[capacity, *prop_shape]``.

API parity:

* property declaration via :class:`PropertyTag` lists (TileVector ctor)
* ``pack<N...>(name)``  -> :meth:`get` (returns the tensor-shaped array)
* named access views    -> dict-style ``sf["vel"]``
* ``append_channels``   -> :meth:`with_props`
* ``reorderTiles``      -> :meth:`permute` (gather by permutation — used by
  the sort-based scatter pipeline)
* ``clone``             -> :meth:`to_device`
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.config import PropertyTag, default_float

__all__ = ["StructuredField", "structured_field"]

PropsSpec = Sequence[Union[PropertyTag, Tuple[str, Union[int, Tuple[int, ...]]]]]


def _as_tags(props: PropsSpec) -> Tuple[PropertyTag, ...]:
    out = []
    for p in props:
        if isinstance(p, PropertyTag):
            out.append(p)
        else:
            name, nch = p
            out.append(PropertyTag(name, nch))
    return tuple(out)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredField:
    channels: Dict[str, jax.Array]
    size: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def capacity(self) -> int:
        for v in self.channels.values():
            return v.shape[0]
        return 0

    @property
    def prop_names(self) -> Tuple[str, ...]:
        return tuple(self.channels.keys())

    def has_prop(self, name: str) -> bool:
        return name in self.channels

    def __len__(self) -> int:
        return self.size

    @property
    def mask(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.size

    # -- access ---------------------------------------------------------------
    def __getitem__(self, name: str) -> jax.Array:
        return self.channels[name]

    def get(self, name: str) -> jax.Array:
        """``pack`` analog: full tensor-shaped property array."""
        return self.channels[name]

    def active(self, name: str) -> jax.Array:
        return self.channels[name][: self.size]

    # -- functional update ----------------------------------------------------
    def set(self, name: str, value: jax.Array) -> "StructuredField":
        ch = dict(self.channels)
        assert value.shape[0] == self.capacity, (
            f"channel {name}: {value.shape[0]} != capacity {self.capacity}")
        ch[name] = value
        return dataclasses.replace(self, channels=ch)

    def update(self, **named_values) -> "StructuredField":
        ch = dict(self.channels)
        for k, v in named_values.items():
            ch[k] = v
        return dataclasses.replace(self, channels=ch)

    def with_props(self, props: PropsSpec, dtype=default_float,
                   fill=0) -> "StructuredField":
        """``append_channels`` analog: add missing properties."""
        ch = dict(self.channels)
        for tag in _as_tags(props):
            if tag.name not in ch:
                ch[tag.name] = jnp.full((self.capacity,) + tag.shape, fill,
                                        dtype)
        return dataclasses.replace(self, channels=ch)

    def permute(self, perm: jax.Array) -> "StructuredField":
        """Reorder all properties by a permutation (``reorderTiles`` analog;
        the gather half of the sort+segment scatter idiom)."""
        ch = {k: v[perm] for k, v in self.channels.items()}
        return dataclasses.replace(self, channels=ch)

    def resize(self, new_size: int, fill=0) -> "StructuredField":
        cap = self.capacity
        if new_size > cap:
            new_cap = max(new_size, 2 * cap if cap else 8)
            ch = {}
            for k, v in self.channels.items():
                pad = jnp.full((new_cap - cap,) + v.shape[1:], fill, v.dtype)
                ch[k] = jnp.concatenate([v, pad])
            return StructuredField(ch, new_size)
        return dataclasses.replace(self, size=new_size)

    # -- placement ------------------------------------------------------------
    def to_device(self, device_or_sharding) -> "StructuredField":
        ch = {k: jax.device_put(v, device_or_sharding)
              for k, v in self.channels.items()}
        return dataclasses.replace(self, channels=ch)


def structured_field(props: PropsSpec, capacity: int, dtype=default_float,
                     data: Optional[Mapping[str, jax.Array]] = None,
                     size: Optional[int] = None) -> StructuredField:
    """Construct with declared properties (TileVector ctor analog)."""
    ch: Dict[str, jax.Array] = {}
    for tag in _as_tags(props):
        ch[tag.name] = jnp.zeros((capacity,) + tag.shape, dtype)
    n = 0
    if data:
        for k, v in data.items():
            v = jnp.asarray(v)
            n = max(n, v.shape[0])
            if k in ch:
                v = v.astype(ch[k].dtype)
            if v.shape[0] < capacity:
                pad = jnp.zeros((capacity - v.shape[0],) + v.shape[1:],
                                v.dtype)
                v = jnp.concatenate([v, pad])
            ch[k] = v
    return StructuredField(ch, size if size is not None else n)
