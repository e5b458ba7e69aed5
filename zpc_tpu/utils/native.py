"""ctypes bindings for the native host runtime (``zpc_tpu/native/``).

The reference ships its host runtime as C++ with a C ABI for frontends
(py_interop/).  Here the native library accelerates host-side hot loops —
bgeo record packing, morton key generation, host radix sort, an arena
allocator — and is **optional**: every consumer has a NumPy fallback, so
the framework works without a compiler present.

The library is built lazily with g++ on first use and cached next to the
source (the reference's CMake build becomes a one-liner because there is
no device code to compile here — XLA owns that).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["load", "available", "morton3d_host", "radix_sort_pairs_host",
           "pack_be_records", "unpack_be_records"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "native", "host_ops.cpp")


def _build() -> Optional[str]:
    """Compile from source into a cache dir keyed by a source hash.

    Never loads a pre-built blob: the artifact name embeds the sha256 of
    host_ops.cpp, so only a library compiled from the checked-in source on
    this machine is ever dlopen'd (binaries are gitignored).
    """
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        cache = os.environ.get(
            "ZPC_TPU_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache", "zpc_tpu"))
        os.makedirs(cache, exist_ok=True)
        out = os.path.join(cache, f"libzpc_host-{tag}.so")
        if os.path.exists(out):
            return out
        tmp = out + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            assert lib.zpc_abi_version() == 1
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def available() -> bool:
    return load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def morton3d_host(coords: np.ndarray) -> np.ndarray:
    """Host morton keys; native if available, numpy fallback otherwise."""
    lib = load()
    coords = np.ascontiguousarray(coords, np.int32)
    n = len(coords)
    if lib is None:
        import jax.numpy as jnp

        from ..math.bits import morton3d

        return np.asarray(morton3d(jnp.asarray(coords)))
    out = np.empty(n, np.int32)
    lib.zpc_morton3d(_i32p(coords), ctypes.c_int64(n), _i32p(out))
    return out


def radix_sort_pairs_host(keys: np.ndarray, vals: np.ndarray,
                          sbit: int = 0, ebit: int = 32):
    """In-place host LSD radix sort of int32 pairs (bit-windowed)."""
    lib = load()
    keys = np.ascontiguousarray(keys, np.int32)
    vals = np.ascontiguousarray(vals, np.int32)
    if lib is None:
        w = (keys.astype(np.uint32) >> sbit) & ((1 << (ebit - sbit)) - 1) \
            if ebit - sbit < 32 else keys.astype(np.uint32)
        order = np.argsort(w, kind="stable")
        return keys[order], vals[order]
    lib.zpc_radix_sort_pairs_i32(_i32p(keys), _i32p(vals),
                                 ctypes.c_int64(len(keys)),
                                 ctypes.c_int(sbit), ctypes.c_int(ebit))
    return keys, vals


def pack_be_records(cols, widths) -> Optional[np.ndarray]:
    """Interleave float columns into big-endian records; None if no lib."""
    lib = load()
    if lib is None:
        return None
    n = len(cols[0])
    cols = [np.ascontiguousarray(c, np.float32).reshape(n, -1)
            for c in cols]
    stride = sum(widths)
    out = np.empty((n, stride), np.float32)
    arr_t = ctypes.POINTER(ctypes.c_float) * len(cols)
    w_t = (ctypes.c_int * len(widths))(*widths)
    lib.zpc_pack_be_records(arr_t(*[_f32p(c) for c in cols]), w_t,
                            ctypes.c_int(len(cols)), ctypes.c_int64(n),
                            _f32p(out))
    return out


def unpack_be_records(records: np.ndarray, widths):
    lib = load()
    if lib is None:
        return None
    records = np.ascontiguousarray(records, np.float32)
    n = len(records)
    cols = [np.empty((n, w), np.float32) for w in widths]
    arr_t = ctypes.POINTER(ctypes.c_float) * len(cols)
    w_t = (ctypes.c_int * len(widths))(*widths)
    lib.zpc_unpack_be_records(_f32p(records), w_t, ctypes.c_int(len(cols)),
                              ctypes.c_int64(n),
                              arr_t(*[_f32p(c) for c in cols]))
    return cols
