"""Core property/type vocabulary.

Re-design of the reference's property system
(``include/zensim/types/Property.h``, ``types/SmallVector.hpp:109``):

* ``memsrc_e {host, device, um}``  ->  :class:`MemSrc` — this maps to
  host (numpy / committed-to-CPU) vs device (default jax device) placement;
  unified memory aliases device.
* ``execspace_e``                  ->  executor backends (see
  :mod:`zpc_tpu.core.executor`).
* ``layout_e {aos, soa, aosoa}``   ->  :class:`Layout` — kept for API parity,
  but this build always stores SoA: XLA owns physical layout and tiling, so
  AoSoA (the reference TileVector's raison d'etre) would only
  obstruct the compiler.
* ``PropertyTag{name, numChannels}`` -> :class:`PropertyTag` (same role:
  declaring named multi-channel properties of a structured field).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple, Union

import jax.numpy as jnp

__all__ = [
    "MemSrc",
    "Layout",
    "PropertyTag",
    "default_float",
    "default_int",
    "index_dtype",
]

# defaults: fp32 compute, int32 indices.
default_float = jnp.float32
default_int = jnp.int32
index_dtype = jnp.int32


class MemSrc(enum.Enum):
    """Memory source (reference ``memsrc_e``, types/Property.h:7)."""

    host = "host"
    device = "device"
    um = "um"  # alias of device


class Layout(enum.Enum):
    """Storage layout (reference ``layout_e``, types/Property.h:104).

    Retained for API parity only; all containers are physically SoA.
    """

    aos = "aos"
    soa = "soa"
    aosoa = "aosoa"


@dataclasses.dataclass(frozen=True)
class PropertyTag:
    """Named multi-channel property (reference ``PropertyTag``,
    types/SmallVector.hpp:109).

    ``num_channels`` may be an int (flat channel count) or a shape tuple for
    tensor-valued properties (e.g. ``(3, 3)`` for a deformation gradient).
    """

    name: str
    num_channels: Union[int, Tuple[int, ...]] = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        if isinstance(self.num_channels, tuple):
            return self.num_channels
        if self.num_channels == 1:
            return ()
        return (int(self.num_channels),)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def prop(name: str, num_channels: Union[int, Tuple[int, ...]] = 1) -> PropertyTag:
    """Shorthand constructor mirroring the reference's brace-init tags."""
    return PropertyTag(name, num_channels)
