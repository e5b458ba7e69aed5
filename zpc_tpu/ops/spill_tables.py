"""Static one-hot slab-shuffle tables for 6^3 halo-cube spill/pull.

A bin's 6-node window overlaps its own 4^3 block plus up to 7 (+1-per-axis)
neighbors.  ``_SPILL_ALL[d]`` maps a spiller's halo cube onto the 64 nodes
of its ``-d`` neighbor block; ``_PULL_ALL[d]`` gathers the ``+d``
neighbor's 64 block nodes back into the halo cube.  A one-hot [64, 216]
dot *is* the slab shuffle: the matmuls express the spill reduction
exactly (fp32 one-hot matmuls at HIGHEST precision are exact).

Consumed by the binned MPM/fluid transfer paths (mpm_binned.py,
mpm_binned2.py slack=0 mode, fluid_binned2.py).  Reference lineage: the
shared-memory halo merges of claymore-style G2P2G
(simulation/transfer/G2P2G.hpp), re-expressed as selection matmuls.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SIDE", "CUBE", "LCUBE", "_DIRS", "_SPILL_ALL", "_PULL_ALL"]

SIDE = 6         # 4-cell block + 2-cell halo
CUBE = SIDE ** 3
LCUBE = 256      # lane-padded cube

_DIRS = [d for d in
         [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
         if any(d)]


def _spill_matrix(d) -> np.ndarray:
    """[64, LCUBE] one-hot: block node <- spiller (-d neighbor) cube."""
    M = np.zeros((64, LCUBE), np.float32)
    for i in range(4):
        for j in range(4):
            for k in range(4):
                si, sj, sk = i + 4 * d[0], j + 4 * d[1], k + 4 * d[2]
                if si < SIDE and sj < SIDE and sk < SIDE:
                    M[(i * 4 + j) * 4 + k, (si * SIDE + sj) * SIDE + sk] = 1.0
    return M


def _pull_matrix(d) -> np.ndarray:
    """[CUBE, 128] one-hot: halo cube node <- +d neighbor block node
    (block nodes live in the first 64 lanes)."""
    P = np.zeros((CUBE, 128), np.float32)
    for a in range(SIDE):
        for b in range(SIDE):
            for c in range(SIDE):
                da, db, dc = a >= 4, b >= 4, c >= 4
                if (da, db, dc) != tuple(bool(x) for x in d):
                    continue
                i, j, k = a - 4 * da, b - 4 * db, c - 4 * dc
                P[(a * SIDE + b) * SIDE + c, (i * 4 + j) * 4 + k] = 1.0
    return P


_SPILL_ALL = np.stack([_spill_matrix(d) for d in [(0, 0, 0)] + _DIRS])
_PULL_ALL = np.stack([_pull_matrix(d) for d in [(0, 0, 0)] + _DIRS])
