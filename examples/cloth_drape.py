"""Cloth drape demo: pinned-corner cloth sags, a free cloth falls and
settles on the ground under IPC barrier + friction (sim/cloth.py).

Writes an OBJ sequence viewable in any mesh viewer:

    python examples/cloth_drape.py --out /tmp/cloth --frames 40
"""

import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from zpc_tpu.utils.compile_cache import enable_compile_cache
from zpc_tpu.sim.cloth import make_cloth_grid, implicit_step
from zpc_tpu.utils.io import write_obj


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=24)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--substeps", type=int, default=4)
    ap.add_argument("--dt", type=float, default=0.008)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--pin", action="store_true",
                    help="pin two corners (hang) instead of dropping")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    pins = (0, (args.nx - 1) * args.ny) if args.pin else ()
    sim, x = make_cloth_grid(
        args.nx, args.ny, 0.02, height=0.3, pinned=pins,
        k_stretch=5e2, k_bend=5e-5, mass=0.005,
        dhat=0.02, kappa=2.0, mu=0.4)
    v = jnp.zeros_like(x)

    def frame(x, v):
        for _ in range(args.substeps):
            x, v = implicit_step(sim, x, v, jnp.float32(args.dt))
        return x, v

    step = jax.jit(frame)
    x, v = jax.block_until_ready(step(x, v))     # compile
    t0 = time.time()
    for f in range(args.frames):
        x, v = step(x, v)
        if args.out:
            write_obj(f"{args.out}_{f:04d}.obj", np.asarray(x),
                      np.asarray(sim.tris))
    x = jax.block_until_ready(x)
    dtw = (time.time() - t0) / args.frames
    n = x.shape[0]
    print(f"cloth {args.nx}x{args.ny} ({n} verts, "
          f"{sim.hinges.shape[0]} hinges): {dtw * 1e3:.1f} ms/frame "
          f"({args.substeps} substeps), ymin={float(x[:, 1].min()):.4f}, "
          f"vmax={float(jnp.abs(v).max()):.3f}")


if __name__ == "__main__":
    main()
