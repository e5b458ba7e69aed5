"""Device mesh / topology layer — the distributed communication backend.

The reference has **no** distributed backend (SURVEY §5.8): its multi-device
story is per-GPU contexts + peer copies + groups-by-MemoryLocation
(simulation/mpm/Simulator.cpp:44-118, cuda/Cuda.cu:345-348).  The
equivalent is first-class here:

* device discovery       -> ``jax.devices()`` (replaces ``Cuda::instance``)
* ``clone(MemoryLocation)`` cross-device copies -> shardings +
  ``jax.device_put``
* peer-to-peer copies    -> XLA collectives over the interconnect
  (``psum``, ``all_gather``, ``ppermute``) inside ``shard_map``
* multi-process          -> the same code over a multi-host mesh (DCN);
  mesh axes are logical, placement is jax's.

Helpers here wrap the small amount of boilerplate the sim layer needs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_leading", "replicated", "P", "Mesh",
           "local_to_global_index"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "d",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (data/domain axis)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_leading(mesh: Mesh, axis: str = "d") -> NamedSharding:
    """Sharding that splits the leading array axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_to_global_index(n_local: int, axis: str = "d"):
    """Inside shard_map: global indices of this shard's leading axis."""
    import jax.numpy as jnp

    shard = jax.lax.axis_index(axis)
    return shard * n_local + jnp.arange(n_local)


# -- multi-host (DCN) wiring -------------------------------------------------

def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None) -> None:
    """Multi-host bring-up: wraps ``jax.distributed.initialize``.

    After this, ``jax.devices()`` spans every process (cross-host mesh
    axes are exactly as cheap to express as in-host ones — XLA routes
    collectives over the right fabric).  Arguments default to the standard env variables
    (``JAX_COORDINATOR_ADDRESS`` etc. / cloud auto-detection); explicit
    values are for tests and manual clusters.  No-op when already
    initialized or when running single-process with no coordinator.
    """
    # must not touch the backend before initialize (jax.process_count()
    # would initialise XLA); peek at the distributed client state instead
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return                       # already initialized
    if coordinator_address is None and num_processes is None:
        import os
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None:
            return                   # single-process run
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def process_info():
    """(process_index, process_count, local_device_count)."""
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count())


def make_global_mesh(axis: str = "d") -> Mesh:
    """1-D mesh over ALL global devices — identical call on every process
    of a multi-host job (device order is jax's canonical global order, so
    every process constructs the same mesh)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def global_array(mesh: Mesh, local_shard: "np.ndarray", axis: str = "d"):
    """Assemble a global leading-axis-sharded array from this process's
    local shard (multi-host input path; single-host: device_put)."""
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(local_shard, sharding)
    return jax.make_array_from_process_local_data(sharding, local_shard)
