"""Particle / mesh / grid IO.

Reference (§2.9): partio writers (``io/ParticleIO.hpp:11-34``), OBJ tri-mesh
and VTK tet-mesh readers/writers (``io/MeshIO.hpp:23-140``), plus the
background IO worker thread (``io/IO.h:7-40``).

Build: host-side IO in plain Python/NumPy with an optional C-accelerated
bgeo codec (:mod:`zpc_tpu.utils.native`, used when the compiled extension is
present).  The async worker (:class:`AsyncIO`) mirrors the reference's
singleton background-thread queue so sims overlap device compute with
checkpoint/export writes.  Array checkpointing of whole pytree states uses
npz (orbax-compatible layouts can be layered on top).
"""

from __future__ import annotations

import io as _io
import os
import queue
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "write_obj", "read_obj", "write_vtk_tets", "read_vtk_tets",
    "write_bgeo", "read_bgeo", "save_state", "load_state", "AsyncIO",
]


# -- OBJ tri meshes (MeshIO.hpp read/write_tri_mesh_obj) ----------------------

def write_obj(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None):
    v = np.asarray(vertices)
    with open(path, "w") as f:
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if faces is not None:
            for t in np.asarray(faces):
                f.write("f " + " ".join(str(int(i) + 1) for i in t) + "\n")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    fs.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(vs, np.float32),
            np.asarray(fs, np.int32) if fs else np.zeros((0, 3), np.int32))


# -- VTK legacy tet meshes (MeshIO.hpp read/write_tet_mesh_vtk) ---------------

def write_vtk_tets(path: str, vertices: np.ndarray, tets: np.ndarray):
    v = np.asarray(vertices, np.float64)
    t = np.asarray(tets, np.int64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nzpc_tpu tet mesh\nASCII\n"
                "DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(v)} double\n")
        for p in v:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        f.write(f"CELLS {len(t)} {len(t) * 5}\n")
        for c in t:
            f.write("4 " + " ".join(map(str, c.tolist())) + "\n")
        f.write(f"CELL_TYPES {len(t)}\n")
        f.write("\n".join(["10"] * len(t)) + "\n")


def read_vtk_tets(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, cells = [], []
    mode = None
    remaining = 0
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "POINTS":
                mode, remaining = "points", int(t[1])
                continue
            if t[0] == "CELLS":
                mode, remaining = "cells", int(t[1])
                continue
            if t[0] == "CELL_TYPES":
                mode = None
                continue
            if mode == "points" and remaining > 0:
                vals = list(map(float, t))
                for k in range(0, len(vals), 3):
                    verts.append(vals[k:k + 3])
                    remaining -= 1
            elif mode == "cells" and remaining > 0:
                if t[0] == "4":
                    cells.append(list(map(int, t[1:5])))
                remaining -= 1
    return np.asarray(verts, np.float32), np.asarray(cells, np.int32)


# -- bgeo (Houdini/partio-compatible particle format) -------------------------
# Minimal BGEOV5 ASCII-free writer: we emit the classic "Bgeo" binary used by
# partio (magic 'Bgeo' 'V' version 5), points + float attributes.

def write_bgeo(path: str, positions: np.ndarray,
               attributes: Optional[Dict[str, np.ndarray]] = None):
    """partio-compatible classic Bgeo binary (big-endian, version 5)."""
    pos = np.asarray(positions, np.float32)
    n = len(pos)
    attributes = attributes or {}
    attrs = {k: np.asarray(v, np.float32).reshape(n, -1)
             for k, v in attributes.items()}
    nattrib = len(attrs)
    buf = _io.BytesIO()
    w = buf.write
    w(b"BgeoV")
    w(struct.pack(">i", 5))                     # version
    w(struct.pack(">i", n))                     # nPoints
    w(struct.pack(">i", 0))                     # nPrims
    w(struct.pack(">i", 0))                     # nPointGroups
    w(struct.pack(">i", 0))                     # nPrimGroups
    w(struct.pack(">i", nattrib))               # nPointAttrib
    w(struct.pack(">i", 0))                     # nVertexAttrib
    w(struct.pack(">i", 0))                     # nPrimAttrib
    w(struct.pack(">i", 0))                     # nAttrib (detail)
    # attribute definitions
    for name, arr in attrs.items():
        nb = name.encode()
        w(struct.pack(">h", len(nb)))
        w(nb)
        size = arr.shape[1]
        w(struct.pack(">i", size))
        w(struct.pack(">i", 0))                 # FLOAT type
        w(struct.pack(f">{size}f", *([0.0] * size)))  # defaults
    # point data: x y z w followed by attributes — native interleave+byteswap
    # codec when the C library is available (utils/native.py)
    from . import native

    cols = [pos, np.ones((n, 1), np.float32)] + [attrs[k] for k in attrs]
    widths = [3, 1] + [attrs[k].shape[1] for k in attrs]
    packed = native.pack_be_records(cols, widths)
    if packed is not None:
        w(packed.tobytes())
    else:
        data = np.concatenate(cols, axis=1).astype(">f4")
        w(data.tobytes())
    # end markers
    w(struct.pack(">B", 0x00))
    w(struct.pack(">B", 0xff))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_bgeo(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def rd(fmt):
        nonlocal off
        vals = struct.unpack_from(">" + fmt, raw, off)
        off += struct.calcsize(">" + fmt)
        return vals if len(vals) > 1 else vals[0]

    magic = raw[:5]
    off = 5
    assert magic == b"BgeoV", f"not a classic bgeo: {magic!r}"
    _ver = rd("i")
    n = rd("i")
    rd("i")
    rd("i")
    rd("i")
    nattr = rd("i")
    rd("i")
    rd("i")
    rd("i")
    names, sizes = [], []
    for _ in range(nattr):
        ln = rd("h")
        name = raw[off:off + ln].decode()
        off += ln
        size = rd("i")
        rd("i")
        rd(f"{size}f")
        names.append(name)
        sizes.append(size)
    width = 4 + sum(sizes)
    data = np.frombuffer(raw, dtype=">f4", count=n * width,
                         offset=off).reshape(n, width).astype(np.float32)
    pos = data[:, :3]
    out, col = {}, 4
    for name, size in zip(names, sizes):
        out[name] = data[:, col:col + size]
        col += size
    return pos, out


# -- state checkpointing (SURVEY §5.4: absent in reference; orbax-style) ------

def save_state(path: str, pytree):
    """Checkpoint an arbitrary pytree of arrays to npz (flat key paths)."""
    import jax

    flat = {}
    leaves = jax.tree_util.tree_flatten_with_path(pytree)[0]
    for kp, leaf in leaves:
        key = "/".join(str(k) for k in kp)
        flat[key] = np.asarray(leaf)
    np.savez_compressed(path, **flat)


def load_state(path: str, like):
    """Restore into the structure of ``like`` (keys must match)."""
    import jax

    data = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    new = []
    for kp, leaf in leaves:
        key = "/".join(str(k) for k in kp)
        arr = data[key]
        new.append(type(leaf)(arr) if not hasattr(leaf, "dtype")
                   else arr.astype(np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, new)


# -- async IO worker (io/IO.h singleton background thread) --------------------

class AsyncIO:
    """Background IO thread with a job queue (reference ``IO::instance``)."""

    _instance: Optional["AsyncIO"] = None

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @classmethod
    def instance(cls) -> "AsyncIO":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                fn(*args, **kwargs)
            except Exception as e:  # pragma: no cover
                import traceback
                traceback.print_exc()
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs):
        """Enqueue a write job (device arrays are snapshotted to host now so
        the sim can donate/overwrite them)."""
        materialized = [np.asarray(a) if hasattr(a, "device") else a
                        for a in args]
        self._q.put((fn, materialized, kwargs))

    def wait(self):
        self._q.join()
