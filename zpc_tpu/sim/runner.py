"""Simulation driver: step loop + export/checkpoint hooks.

The app-layer loop the reference leaves to zeno: runs a chosen transfer
path, adapts dt by the grid CFL, exports frames through the async IO worker
(io/IO.h idiom) and checkpoints state (the resume capability the reference
lacks, SURVEY §5.4).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..models.cfl import timestep_velocity
from ..utils.io import AsyncIO, save_state, write_bgeo
from .mpm import MPMSim, MPMState, explicit_step
from .mpm_binned import BinnedConfig, explicit_step_binned
from .mpm_binned2 import BinnedConfig2, rollout_binned2

__all__ = ["simulate"]


def simulate(sim: MPMSim, state: MPMState, *, dt: float, steps: int,
             path: str = "auto", bins_capacity: Optional[int] = None,
             frame_every: int = 0, frame_prefix: str = "frame",
             checkpoint_every: int = 0, checkpoint_path: str = "ckpt.npz",
             adapt_dt: bool = False, cfl: float = 0.5,
             on_frame: Optional[Callable] = None) -> MPMState:
    """Run ``steps`` explicit MPM steps.

    ``path``: "baseline" | "binned" | "binned2" | "auto".  "binned2" (the
    auto choice without dt adaptation) runs whole frame segments as one
    jitted bin-ordered rollout — the fast path on every backend.  Frames
    are
    written as bgeo through the background IO worker so exports overlap
    device compute.
    """
    if path == "auto":
        path = "binned" if adapt_dt else "binned2"
    cfg = BinnedConfig(bins_capacity=bins_capacity or
                       max(64, state.particles.capacity // 128 * 2))
    if path == "binned2":
        if adapt_dt:
            raise ValueError("binned2 rollouts use a fixed dt; "
                             "use path='binned' with adapt_dt")
        return _simulate_binned2(sim, state, dt=dt, steps=steps,
                                 bins_capacity=bins_capacity,
                                 frame_every=frame_every,
                                 frame_prefix=frame_prefix,
                                 checkpoint_every=checkpoint_every,
                                 checkpoint_path=checkpoint_path,
                                 on_frame=on_frame)
    if path == "baseline":
        step = jax.jit(lambda s, d: explicit_step(sim, s, d))
    elif path == "binned":
        step = jax.jit(lambda s, d: explicit_step_binned(sim, s, d, cfg)[0])
    else:
        raise ValueError(path)

    io = AsyncIO.instance()
    dt_j = jnp.float32(dt)
    for i in range(steps):
        state = step(state, dt_j)
        if adapt_dt:
            dx = float(state.grid.dx)
            dt_j = jnp.minimum(
                jnp.float32(dt),
                timestep_velocity(state.max_vel, dx, cfl, dt_max=dt))
        if frame_every and (i + 1) % frame_every == 0:
            n = state.particles.size
            x = np.asarray(state.particles["x"][:n])
            v = np.asarray(state.particles["v"][:n])
            io.submit(write_bgeo, f"{frame_prefix}.{i + 1:05d}.bgeo", x,
                      {"v": v})
            if on_frame is not None:
                on_frame(i + 1, state)
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_state(checkpoint_path, state)
    io.wait()
    return state


def _simulate_binned2(sim, state, *, dt, steps, bins_capacity, frame_every,
                      frame_prefix, checkpoint_every, checkpoint_path,
                      on_frame):
    """Frame-segmented bin-ordered rollouts (one jit per segment length)."""
    io = AsyncIO.instance()
    cap = state.particles.capacity
    cfg = BinnedConfig2(bins_capacity=bins_capacity or
                        max(64, cap // 128 + cap // 512 + 8))
    seg = min(x for x in (frame_every or steps, checkpoint_every or steps,
                          steps) if x > 0)
    roll = jax.jit(lambda s, n_: rollout_binned2(sim, s, jnp.float32(dt),
                                                 cfg, n_),
                   static_argnums=1)
    done = 0
    while done < steps:
        n_ = min(seg, steps - done)
        state, overflow = roll(state, n_)
        done += n_
        if bool(overflow):
            raise RuntimeError("binned2 overflow: grow bins_capacity")
        if frame_every and done % frame_every == 0:
            n = state.particles.size
            x = np.asarray(state.particles["x"][:n])
            v = np.asarray(state.particles["v"][:n])
            io.submit(write_bgeo, f"{frame_prefix}.{done:05d}.bgeo", x,
                      {"v": v})
            if on_frame is not None:
                on_frame(done, state)
        if checkpoint_every and done % checkpoint_every == 0:
            save_state(checkpoint_path, state)
    io.wait()
    return state
