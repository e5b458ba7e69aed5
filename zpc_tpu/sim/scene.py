"""Scene builder — fluent construction of MPM simulations.

Reference: ``simulation/init/Scene.hpp:13-54`` fluent builder
(``addParticles/addCuboid/addCube/addSphere``, ``setBoundary``), impl
``Scene.cpp:36-91`` (level-set sampling via PoissonDisk, bgeo export), and
the ``MPMSimulator`` builder's grouping + default-dt logic
(``simulation/mpm/Simulator.cpp:44-130``).

Build: objects accumulate host-side; ``build()`` packs every object into
one particle state (per-particle Lame fields support heterogeneous stiffness
with one model type) and derives the CFL dt from the stiffest object.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..geometry.collider import Collider
from ..geometry.levelset import Cuboid, LevelSet, Sphere
from ..geometry.sampling import sample_lattice, sample_levelset
from ..models import constitutive as cm
from ..models.cfl import timestep_linear_elasticity
from .mpm import MPMSim, MPMState, make_mpm_state

__all__ = ["Scene"]


@dataclasses.dataclass
class _Object:
    positions: np.ndarray
    velocity: np.ndarray
    rho: float
    E: float
    nu: float


class Scene:
    """Fluent scene builder (reference Scene::create() idiom)."""

    def __init__(self, dx: float, ppc: float = 8.0, seed: int = 0):
        self.dx = float(dx)
        self.ppc = float(ppc)
        self.seed = seed
        self._objects: List[_Object] = []
        self._colliders: List[Collider] = []
        self._gravity = np.array([0.0, -9.8, 0.0], np.float32)
        self._model_cls = cm.FixedCorotated
        self._plasticity = None

    # -- objects (addCuboid/addSphere/addParticles) ---------------------------
    def add_particles(self, x: np.ndarray, *, velocity=(0, 0, 0),
                      rho: float = 1e3, E: float = 5e4, nu: float = 0.3
                      ) -> "Scene":
        self._objects.append(_Object(
            np.asarray(x, np.float32),
            np.asarray(velocity, np.float32), rho, E, nu))
        return self

    def add_cuboid(self, lo, hi, **kw) -> "Scene":
        pts = sample_lattice(lo, hi, self.dx, self.ppc,
                             seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    def add_cube(self, center, side, **kw) -> "Scene":
        c = np.asarray(center, np.float64)
        h = side / 2.0
        return self.add_cuboid(c - h, c + h, **kw)

    def add_sphere(self, center, radius, **kw) -> "Scene":
        c = np.asarray(center, np.float64)
        ls = Sphere(jnp.asarray(c, jnp.float32), jnp.float32(radius))
        pts = sample_levelset(ls.sdf, c - radius, c + radius, self.dx,
                              self.ppc,
                              seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    def add_levelset_object(self, ls: LevelSet, lo, hi, **kw) -> "Scene":
        pts = sample_levelset(ls.sdf, lo, hi, self.dx, self.ppc,
                              seed=self.seed + len(self._objects))
        return self.add_particles(pts, **kw)

    # -- boundaries / globals --------------------------------------------------
    def add_boundary(self, collider: Collider) -> "Scene":
        self._colliders.append(collider)
        return self

    def set_gravity(self, g) -> "Scene":
        self._gravity = np.asarray(g, np.float32)
        return self

    def set_model(self, model_cls) -> "Scene":
        self._model_cls = model_cls
        return self

    def set_plasticity(self, plas) -> "Scene":
        self._plasticity = plas
        return self

    # -- build ----------------------------------------------------------------
    def num_particles(self) -> int:
        return sum(len(o.positions) for o in self._objects)

    def suggest_dt(self, cfl: float = 0.4) -> float:
        """Default dt from the stiffest object (Simulator.cpp:52-64)."""
        dts = [float(timestep_linear_elasticity(o.E, o.nu, o.rho, self.dx,
                                                cfl))
               for o in self._objects]
        return min(dts) if dts else 1e-4
    def build(self, *, block_capacity: int = 4096,
              capacity: Optional[int] = None,
              with_Jp: bool = False, Jp0: float = 1.0
              ) -> Tuple[MPMSim, MPMState, float]:
        """Pack objects -> (sim, state, dt).  Heterogeneous (E, nu, rho)
        become per-particle Lame/mass fields."""
        assert self._objects, "empty scene"
        xs = np.concatenate([o.positions for o in self._objects])
        n = len(xs)
        vs = np.concatenate([
            np.broadcast_to(o.velocity, (len(o.positions), 3))
            for o in self._objects])
        vol0 = self.dx ** 3 / self.ppc
        masses = np.concatenate([
            np.full(len(o.positions), o.rho * vol0, np.float32)
            for o in self._objects])
        mus, lams = [], []
        for o in self._objects:
            mu, lam = cm.lame_parameters(o.E, o.nu)
            mus.append(np.full(len(o.positions), mu, np.float32))
            lams.append(np.full(len(o.positions), lam, np.float32))
        st = make_mpm_state(jnp.asarray(xs), dx=self.dx, ppc=self.ppc,
                            block_capacity=block_capacity,
                            velocity=jnp.asarray(vs), capacity=capacity,
                            with_Jp=with_Jp, Jp0=Jp0)
        st = MPMState(st.particles.update(m=_pad(masses, st.particles)),
                      st.grid, st.max_vel)
        model = self._model_cls(jnp.asarray(np.concatenate(mus)),
                                jnp.asarray(np.concatenate(lams)))
        # pad per-particle Lame to capacity
        cap = st.particles.capacity
        if cap != n:
            model = self._model_cls(
                _pad(np.concatenate(mus), st.particles),
                _pad(np.concatenate(lams), st.particles))
        sim = MPMSim(model=model, gravity=jnp.asarray(self._gravity),
                     colliders=tuple(self._colliders),
                     plasticity=self._plasticity)
        return sim, st, self.suggest_dt()


def _pad(arr: np.ndarray, particles) -> jnp.ndarray:
    cap = particles.capacity
    if len(arr) < cap:
        arr = np.concatenate([arr, np.zeros(cap - len(arr), arr.dtype)])
    return jnp.asarray(arr)
