"""2-D MPM demo: elastic discs falling into a box (dimension-generic
pipeline; the reference templates dim=2/3).

Run:  python examples/mpm2d.py --steps 200
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
from zpc_tpu.geometry.levelset import HalfSpace
from zpc_tpu.models.constitutive import FixedCorotated
from zpc_tpu.sim.mpm import MPMSim, make_mpm_state, explicit_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--particles", type=int, default=8192)
    ap.add_argument("--binned", action="store_true",
                    help="use the binned2 fast path")
    args = ap.parse_args()
    enable_compile_cache()

    rng = np.random.default_rng(3)
    # two discs
    pts = []
    for c in ([0.35, 0.6], [0.65, 0.75]):
        p = rng.uniform(-0.1, 0.1, (args.particles // 2, 2))
        p = p[np.linalg.norm(p, axis=1) < 0.1] + c
        pts.append(p)
    x = jnp.asarray(np.concatenate(pts), jnp.float32)

    ground = Collider(HalfSpace(jnp.asarray([0.0, 0.1]),
                                jnp.asarray([0.0, 1.0])),
                      ColliderType.slip, friction=0.2)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(5e4, 0.3),
                 gravity=jnp.asarray([0.0, -9.8]), colliders=(ground,))
    st = make_mpm_state(x, dx=1.0 / 128, block_capacity=2048)
    dt = 1e-4
    if args.binned:
        from zpc_tpu.sim.mpm_binned2 import BinnedConfig2, rollout_binned2
        cfg = BinnedConfig2(bins_capacity=max(
            256, st.particles.capacity // 128 * 4))
        roll = jax.jit(lambda s: rollout_binned2(
            sim, s, jnp.float32(dt), cfg, args.steps))
        t0 = time.perf_counter()
        st, overflow = jax.block_until_ready(roll(st))
        assert not bool(overflow), "bin overflow: raise bins_capacity"
    else:
        step = jax.jit(lambda s: explicit_step(sim, s, jnp.float32(dt)))
        t0 = time.perf_counter()
        for _ in range(args.steps):
            st = step(st)
        jax.block_until_ready(st)
    pos = np.asarray(st.particles["x"])[: st.particles.size]
    print(f"{args.steps} steps in {time.perf_counter() - t0:.2f}s; "
          f"y range [{pos[:, 1].min():.3f}, {pos[:, 1].max():.3f}] "
          f"finite={np.isfinite(pos).all()}")


if __name__ == "__main__":
    main()
