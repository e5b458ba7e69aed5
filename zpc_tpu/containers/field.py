"""``Field`` — the ``zs::Vector`` (container/Vector.hpp).

Design notes (vs the reference):

* The reference Vector is an allocator-aware dynamic array with host-side
  ``resize/push_back`` and cross-space ``clone(MemoryLocation)``
  (container/Vector.hpp:11,188).  Under XLA all shapes are static, so a Field
  is a **padded capacity buffer + active size**: ``data[capacity, ...]`` with
  the logical size carried as a static python int (changing it re-traces, as
  the reference's ``resize`` reallocates).
* ``view<space>()`` POD views (Vector.hpp:455-534) are unnecessary: a Field
  is itself an immutable pytree captured by traced kernels.
* ``clone(mloc)`` -> :meth:`to_device` (``jax.device_put``); host/device
  spaces become JAX placements.
* ``setVal/getVal`` cross-space scalar access (Vector.hpp) -> plain indexing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Field", "field"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Field:
    data: jax.Array                                  # [capacity, *item_shape]
    size: int = dataclasses.field(metadata=dict(static=True), default=0)

    # -- shape info -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def item_shape(self) -> Tuple[int, ...]:
        return self.data.shape[1:]

    @property
    def dtype(self):
        return self.data.dtype

    def __len__(self) -> int:
        return self.size

    # -- accessors ------------------------------------------------------------
    @property
    def active(self) -> jax.Array:
        """View of the active prefix (static slice)."""
        return self.data[: self.size]

    @property
    def mask(self) -> jax.Array:
        """Validity mask over capacity lanes."""
        return jnp.arange(self.capacity) < self.size

    def __getitem__(self, idx):
        return self.data[idx]

    # -- functional mutation ---------------------------------------------------
    def set(self, idx, value) -> "Field":
        return dataclasses.replace(self, data=self.data.at[idx].set(value))

    def fill(self, value) -> "Field":
        return dataclasses.replace(
            self, data=jnp.full_like(self.data, value))

    def resize(self, new_size: int, fill=0) -> "Field":
        """Grow/shrink the logical size; grows capacity geometrically when
        needed (reference Vector::resize semantics)."""
        cap = self.capacity
        if new_size > cap:
            new_cap = max(new_size, 2 * cap if cap else 8)
            pad = jnp.full((new_cap - cap,) + self.item_shape, fill,
                           self.dtype)
            return Field(jnp.concatenate([self.data, pad]), new_size)
        return dataclasses.replace(self, size=new_size)

    def append(self, values: jax.Array) -> "Field":
        """Bulk ``push_back`` (host-side; static shapes)."""
        n = values.shape[0]
        out = self.resize(self.size + n)
        return dataclasses.replace(
            out, data=jax.lax.dynamic_update_slice_in_dim(
                out.data, values.astype(self.dtype), self.size, 0))

    # -- placement (clone(MemoryLocation) analog) -----------------------------
    def to_device(self, device_or_sharding) -> "Field":
        return dataclasses.replace(
            self, data=jax.device_put(self.data, device_or_sharding))

    def to_host(self) -> np.ndarray:
        return np.asarray(self.data[: self.size])


def field(values=None, *, capacity: Optional[int] = None, item_shape=(),
          dtype=jnp.float32, fill=0) -> Field:
    """Construct a Field from values or as an empty capacity buffer."""
    if values is not None:
        values = jnp.asarray(values, dtype)
        n = values.shape[0]
        cap = capacity or n
        if cap > n:
            pad = jnp.full((cap - n,) + values.shape[1:], fill, values.dtype)
            values = jnp.concatenate([values, pad])
        return Field(values, n)
    cap = capacity or 0
    return Field(jnp.full((cap,) + tuple(item_shape), fill, dtype), 0)
