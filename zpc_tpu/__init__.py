"""zpc_tpu — a parallel-compute framework for physics simulation on JAX.

A ground-up re-design of the capabilities of zenustech/zpc (zensim):
JAX/XLA is the device compiler (the GPU is the target accelerator),
``jax.sharding`` meshes the multi-device fabric.  See ``SURVEY.md`` at the
repo root for the reference structural map this build follows.

Layer map (mirrors SURVEY §1):

====  =======================================  =============================
ref   reference layer                           zpc_tpu module
====  =======================================  =============================
0-1   meta/types, memory & resources            ``core`` (config, executor)
2-3   backend runtimes, execution policies      ``core.executor``, ``parallel``
4     containers                                ``containers``
5     math                                      ``math``
6     geometry / spatial structures             ``geometry``
7     physics models                            ``models``
8     simulation (MPM)                          ``sim``
9-11  IO/tools, interop/JIT, aux                ``utils``, ``ops``
—     distributed (absent in ref; SURVEY §5.8)  ``parallel.mesh``
====  =======================================  =============================
"""

from .core.config import Layout, MemSrc, PropertyTag, prop
from .core.executor import Executor, jit_exec, seq_exec, tpu_exec
from .containers.field import Field, field
from .containers.structured import StructuredField, structured_field
from .containers.block_table import (BlockTable, build_block_table,
                                     pack_coords, unpack_key)
from .parallel import primitives
from .parallel.primitives import (count_if, exclusive_scan, histogram,
                                  inclusive_scan, merge_sort,
                                  merge_sort_pair, radix_sort,
                                  radix_sort_pair, reduce, segment_reduce,
                                  select_if, sort, sort_pair, unique)

__version__ = "0.1.0"

__all__ = [
    "Layout", "MemSrc", "PropertyTag", "prop",
    "Executor", "seq_exec", "tpu_exec", "jit_exec",
    "Field", "field", "StructuredField", "structured_field",
    "BlockTable", "build_block_table", "pack_coords", "unpack_key",
    "primitives", "reduce", "inclusive_scan", "exclusive_scan",
    "sort", "sort_pair", "merge_sort", "merge_sort_pair",
    "radix_sort", "radix_sort_pair", "histogram", "segment_reduce",
    "count_if", "select_if", "unique",
]
