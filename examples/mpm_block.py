"""Explicit MPM elastic block benchmark/example (BASELINE config 3).

256k-particle elastic block falling onto a sticky ground plane inside a box,
quadratic APIC transfers on a block-sparse grid — the reference's flagship
workload (SURVEY §3.3), re-designed on XLA.

Run:  python examples/mpm_block.py [--particles 262144] [--steps 100]
"""

import argparse
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from zpc_tpu.utils.compile_cache import enable_compile_cache
from zpc_tpu.geometry.collider import Collider, ColliderType
from zpc_tpu.geometry.levelset import HalfSpace, Cuboid, ComplementLevelSet
from zpc_tpu.models.constitutive import FixedCorotated
from zpc_tpu.models.cfl import timestep_linear_elasticity
from zpc_tpu.sim.mpm import MPMSim, make_mpm_state, explicit_step
from zpc_tpu.utils.profile import bench


def build(n_particles: int, dx: float, block_capacity: int = 4096):
    rng = np.random.default_rng(7)
    # cube of side L centered in a unit domain, dropped from height
    L = 0.25
    x = rng.uniform(0.5 - L / 2, 0.5 + L / 2,
                    (n_particles, 3)).astype(np.float32)
    x[:, 1] += 0.2
    st = make_mpm_state(jnp.asarray(x), dx=dx, rho=1e3, ppc=8.0,
                        block_capacity=block_capacity)
    E, nu = 5e4, 0.3
    model = FixedCorotated.from_young_poisson(E, nu)
    ground = Collider(HalfSpace(jnp.asarray([0.0, 0.05, 0.0]),
                                jnp.asarray([0.0, 1.0, 0.0])),
                      ColliderType.sticky)
    walls = Collider(ComplementLevelSet(Cuboid(jnp.full(3, 0.02),
                                               jnp.full(3, 0.98))),
                     ColliderType.sticky)
    sim = MPMSim(model=model, gravity=jnp.asarray([0.0, -9.8, 0.0]),
                 colliders=(ground, walls))
    dt = float(timestep_linear_elasticity(E, nu, 1e3, dx, cfl=0.4))
    return sim, st, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dx", type=float, default=1.0 / 128)
    ap.add_argument("--vdb", type=str, default="",
                    help="write the final grid to this .vdb file")
    args = ap.parse_args()
    enable_compile_cache()

    sim, st, dt = build(args.particles, args.dx)
    print(f"n={args.particles} dx={args.dx} dt={dt:.2e} "
          f"device={jax.devices()[0]}")

    step = jax.jit(lambda s: explicit_step(sim, s, jnp.float32(dt)))
    t0 = time.perf_counter()
    st = jax.block_until_ready(step(st))
    print(f"compile+first step: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    for _ in range(args.steps):
        st = step(st)
    jax.block_until_ready(st)
    dt_wall = time.perf_counter() - t0
    pps = args.particles * args.steps / dt_wall
    print(f"{args.steps} steps in {dt_wall:.3f}s -> "
          f"{pps/1e6:.2f}M particles*steps/sec")
    x = np.asarray(st.particles["x"])
    print(f"active blocks={int(st.grid.table.count)} "
          f"max_vel={float(st.max_vel):.3f} "
          f"y-range=[{x[:,1].min():.3f},{x[:,1].max():.3f}]")
    if args.vdb:
        # export the final grid state as an OpenVDB-format file
        from zpc_tpu.geometry.vdb_bridge import save_vdb
        save_vdb(args.vdb, st.grid, ["m", "v"], grid_class="fog volume")
        print(f"wrote {args.vdb}")


if __name__ == "__main__":
    main()
