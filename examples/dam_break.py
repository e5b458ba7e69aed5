"""Dam break: J-only fluid MPM + surface reconstruction + OBJ export.

Runs on CPU (pass --cpu) or the GPU.  End-to-end drive of the fluid
pipeline (sim/fluid.py), particle surfacing (levelset_from_points), and
marching-tets meshing (geometry/marching.py).

  python examples/dam_break.py --particles 8192 --steps 200 --out /tmp/dam
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dx", type=float, default=1.0 / 64)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--binned", action="store_true",
                    help="binned-v2 fluid fast path (adaptive rebinning)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zpc_tpu.geometry.collider import Collider, ColliderType
    from zpc_tpu.geometry.levelset import HalfSpace
    from zpc_tpu.models.constitutive import EquationOfState
    from zpc_tpu.sim.mpm import MPMSim
    from zpc_tpu.sim.fluid import make_fluid_state, explicit_fluid_step
    from zpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rng = np.random.default_rng(0)
    # water column in the left quarter of a unit box
    x = np.stack([rng.uniform(0.05, 0.3, args.particles),
                  rng.uniform(0.05, 0.6, args.particles),
                  rng.uniform(0.05, 0.95, args.particles)], -1)
    x = jnp.asarray(x, jnp.float32)

    def wall(origin, direction):
        return Collider(HalfSpace(origin=jnp.asarray(origin),
                                  direction=jnp.asarray(direction)),
                        kind=ColliderType.slip)

    colliders = (wall([0.0, 0.02, 0.0], [0.0, 1.0, 0.0]),
                 wall([0.02, 0.0, 0.0], [1.0, 0.0, 0.0]),
                 wall([0.98, 0.0, 0.0], [-1.0, 0.0, 0.0]),
                 wall([0.0, 0.0, 0.02], [0.0, 0.0, 1.0]),
                 wall([0.0, 0.0, 0.98], [0.0, 0.0, -1.0]))
    model = EquationOfState(mu=jnp.float32(0.0), lam=jnp.float32(4e4),
                            gamma=jnp.float32(7.15))
    sim = MPMSim(model=model, gravity=jnp.asarray([0.0, -9.8, 0.0]),
                 colliders=colliders)
    st = make_fluid_state(x, dx=args.dx, block_capacity=2048)
    dt = jnp.float32(2e-4)

    if args.binned:
        from zpc_tpu.sim.fluid_binned2 import rollout_fluid_binned2
        from zpc_tpu.sim.mpm_binned2 import BinnedConfig2
        # bins must cover occupied blocks (each part-filled block pads to
        # K): particles/K for the bulk + headroom for dilute blocks
        cfg = BinnedConfig2(
            bins_capacity=args.particles // 128 + 1536,
            block_capacity=4096)
        roll = jax.jit(lambda s: rollout_fluid_binned2(
            sim, s, dt, cfg, args.steps))
        t0 = time.time()
        st, overflow = roll(s=st)
        st = jax.block_until_ready(st)
        assert not bool(overflow), "bin overflow: grow bins_capacity"
    else:
        def body(_, s):
            return explicit_fluid_step(sim, s, dt)

        roll = jax.jit(lambda s: jax.lax.fori_loop(0, args.steps, body, s))
        t0 = time.time()
        st = jax.block_until_ready(roll(st))
    wall_s = time.time() - t0
    xs = np.asarray(st.particles["x"])
    J = np.asarray(st.particles["J"])
    print(f"{args.steps} steps x {args.particles} particles: "
          f"{wall_s:.2f}s ({args.particles * args.steps / wall_s / 1e6:.2f}"
          f" M pps)")
    print(f"x range {xs.min(0).round(3)}..{xs.max(0).round(3)}  "
          f"J [{J.min():.3f}, {J.max():.3f}]  max_vel "
          f"{float(st.max_vel):.2f}")
    assert np.isfinite(xs).all()

    if args.out:
        from zpc_tpu.geometry.sparse_levelset import levelset_from_points
        from zpc_tpu.geometry.marching import surface_from_levelset
        from zpc_tpu.utils.io import write_obj
        ls = levelset_from_points(jnp.asarray(xs), dx=args.dx,
                                  radius=1.5 * args.dx,
                                  block_capacity=4096)
        soup = surface_from_levelset(ls, iso=1.2 * args.dx,
                                     capacity=200_000)
        cnt = int(soup.count)
        tris = np.asarray(soup.verts)[:cnt]
        verts = tris.reshape(-1, 3)
        faces = np.arange(len(verts)).reshape(-1, 3)
        write_obj(args.out + ".obj", verts, faces)
        print(f"wrote {args.out}.obj ({cnt} triangles, "
              f"overflow={bool(soup.overflow)})")


if __name__ == "__main__":
    main()
