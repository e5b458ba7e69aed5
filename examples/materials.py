"""Model-family demos: elastic jello, snow, sand, weakly-compressible fluid.

Mirrors the reference's zeno-driven MPM material setups (SnowPlasticity,
NonAssociativeDruckerPrager, EquationOfState).  Run:

    python examples/materials.py --material snow --steps 200
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
from zpc_tpu.models.constitutive import (EquationOfState, FixedCorotated,
                                         StvkWithHencky)
from zpc_tpu.models.plasticity import DruckerPrager, SnowPlasticity
from zpc_tpu.sim.mpm import MPMSim, make_mpm_state, explicit_step
from zpc_tpu.utils.io import write_bgeo


def build(material: str, n: int = 32768, dx: float = 1.0 / 64):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.4, 0.6, (n, 3)).astype(np.float32)
    x[:, 1] += 0.15
    ground = Collider(HalfSpace(jnp.asarray([0.0, 0.1, 0.0]),
                                jnp.asarray([0.0, 1.0, 0.0])),
                      ColliderType.slip, friction=0.4)
    g = jnp.asarray([0.0, -9.8, 0.0])
    with_Jp, Jp0 = False, 1.0
    plasticity = None
    if material == "jello":
        model = FixedCorotated.from_young_poisson(5e4, 0.3)
        dt = 2e-4
    elif material == "snow":
        model = FixedCorotated.from_young_poisson(1.4e5, 0.2)
        plasticity = SnowPlasticity()
        with_Jp, Jp0 = True, 1.0
        dt = 1e-4
    elif material == "sand":
        from zpc_tpu.models.constitutive import lame_parameters
        mu, lam = lame_parameters(3.5e5, 0.3)
        model = StvkWithHencky(jnp.float32(mu), jnp.float32(lam))
        plasticity = DruckerPrager(jnp.float32(mu), jnp.float32(lam),
                                   jnp.float32(35.0))
        with_Jp, Jp0 = True, 0.0   # logJp
        dt = 1e-4
    elif material == "fluid":
        model = EquationOfState(jnp.float32(0.0), jnp.float32(2e4),
                                jnp.float32(7.15))
        dt = 2e-4
    else:
        raise SystemExit(f"unknown material {material}")
    st = make_mpm_state(jnp.asarray(x), dx=dx, rho=1e3,
                        block_capacity=4096, with_Jp=with_Jp, Jp0=Jp0)
    sim = MPMSim(model=model, gravity=g, colliders=(ground,),
                 plasticity=plasticity)
    return sim, st, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--material", default="snow",
                    choices=["jello", "snow", "sand", "fluid"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--particles", type=int, default=32768)
    ap.add_argument("--out", default=None, help="bgeo output path")
    args = ap.parse_args()
    enable_compile_cache()

    sim, st, dt = build(args.material, args.particles)
    step = jax.jit(lambda s: explicit_step(sim, s, jnp.float32(dt)))
    t0 = time.perf_counter()
    for i in range(args.steps):
        st = step(st)
    jax.block_until_ready(st)
    x = np.asarray(st.particles["x"])
    print(f"{args.material}: {args.steps} steps in "
          f"{time.perf_counter() - t0:.2f}s; "
          f"y in [{x[:, 1].min():.3f}, {x[:, 1].max():.3f}] "
          f"finite={np.isfinite(x).all()}")
    if args.out:
        write_bgeo(args.out, x, {"v": np.asarray(st.particles["v"])})
        print("wrote", args.out)


if __name__ == "__main__":
    main()
