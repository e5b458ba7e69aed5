"""Particle seeding samplers.

Reference: ``geometry/PoissonDisk.hpp:19-129`` (Poisson-disk sampler used by
Scene init; the reference loads a pre-baked 1000k-point pattern from disk) and
the level-set sample paths in ``simulation/init/Scene.cpp:36-91``.

Build: host-side NumPy (seeding is one-time init):

* :func:`sample_lattice` — jittered ppc-per-cell lattice restricted to a
  level set / box (the common MPM seeding; deterministic given a seed);
* :func:`poisson_disk` — Bridson dart throwing (no pre-baked asset needed);
* :func:`sample_levelset` — rejection of either pattern against an SDF.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["sample_lattice", "poisson_disk", "sample_levelset"]


def sample_lattice(lo, hi, dx: float, ppc: float = 8.0,
                   jitter: float = 0.5, seed: int = 0) -> np.ndarray:
    """Jittered lattice with ~ppc particles per dx^3 cell inside [lo, hi]."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    spacing = dx / (ppc ** (1.0 / dim))
    axes = [np.arange(lo[d] + spacing / 2, hi[d], spacing)
            for d in range(dim)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    rng = np.random.default_rng(seed)
    grid = grid + rng.uniform(-jitter, jitter, grid.shape) * spacing
    return np.clip(grid, lo, hi).astype(np.float32)


def poisson_disk(lo, hi, radius: float, k: int = 30,
                 seed: int = 0, max_points: Optional[int] = None
                 ) -> np.ndarray:
    """Bridson (2007) Poisson-disk sampling in an axis-aligned box."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    cell = radius / np.sqrt(dim)
    dims = np.maximum(((hi - lo) / cell).astype(int) + 1, 1)
    grid = -np.ones(dims, dtype=np.int64)
    pts = []
    active = []

    def gcoord(p):
        return tuple(((p - lo) / cell).astype(int))

    p0 = lo + rng.uniform(0, 1, dim) * (hi - lo)
    pts.append(p0)
    grid[gcoord(p0)] = 0
    active.append(0)
    neigh = [np.array(t) for t in np.ndindex(*([5] * dim))]
    neigh = [t - 2 for t in neigh]

    while active and (max_points is None or len(pts) < max_points):
        ai = rng.integers(len(active))
        base = pts[active[ai]]
        placed = False
        for _ in range(k):
            d = rng.standard_normal(dim)
            d /= np.linalg.norm(d)
            r = radius * (1 + rng.uniform())
            cand = base + d * r
            if np.any(cand < lo) or np.any(cand >= hi):
                continue
            gc = np.array(gcoord(cand))
            ok = True
            for off in neigh:
                nc = gc + off
                if np.any(nc < 0) or np.any(nc >= dims):
                    continue
                j = grid[tuple(nc)]
                if j >= 0 and np.linalg.norm(pts[j] - cand) < radius:
                    ok = False
                    break
            if ok:
                pts.append(cand)
                grid[tuple(gc)] = len(pts) - 1
                active.append(len(pts) - 1)
                placed = True
                break
        if not placed:
            active.pop(ai)
    return np.asarray(pts, np.float32)


def sample_levelset(sdf: Callable, lo, hi, dx: float, ppc: float = 8.0,
                    seed: int = 0, method: str = "lattice",
                    radius: Optional[float] = None) -> np.ndarray:
    """Sample inside ``sdf(x) < 0`` within the box (Scene.cpp seeding)."""
    if method == "lattice":
        pts = sample_lattice(lo, hi, dx, ppc, seed=seed)
    elif method == "poisson":
        r = radius or dx / (ppc ** (1.0 / len(np.atleast_1d(lo))))
        pts = poisson_disk(lo, hi, r, seed=seed)
    else:
        raise ValueError(method)
    import jax.numpy as jnp

    d = np.asarray(sdf(jnp.asarray(pts)))
    return pts[d < 0.0]
