"""Implicit MPM on the binned transfer machinery — gather-free PCG.

Same system as :mod:`zpc_tpu.sim.implicit` ((M + dt^2 K) v = M v_pred with
Dirichlet projection), but every transfer in the CG operator rides the
binned workspace (:mod:`zpc_tpu.sim.mpm_binned`): stencils and selection
matrices are built once per step, so each CG iteration is two einsum sweeps
+ two one-hot matmuls — no scatter/gather inside the solve loop.  This is
what made BASELINE config 5 (1M-particle implicit step) viable.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry.collider import resolve_boundaries
from ..math.solvers import cg
from ..math.vecmat import mm, scale_trailing
from .mpm import MPMSim, MPMState
from .mpm_binned import BinnedConfig, prepare_bins

__all__ = ["implicit_step_binned"]


def implicit_step_binned(sim: MPMSim, state: MPMState, dt,
                         cfg: BinnedConfig, cg_iters: int = 50,
                         cg_tol: float = 1e-3
                         ) -> Tuple[MPMState, jax.Array]:
    p = state.particles
    ws = prepare_bins(sim, state, cfg)
    grid = ws.grid
    dx = grid.dx
    Dinv = 4.0 / (dx * dx)
    model = ws.bin_leaves(sim.model)
    plasticity = ws.bin_leaves(sim.plasticity)
    Fb = ws.Fb
    zero = jnp.zeros_like(ws.mban)[..., None]

    # ---- one P2G pass for mass, APIC momentum, and internal force ----------
    tau = model.kirchhoff(Fb)
    A_m = ws.mban[..., None, None] * ws.Cb
    A_f = (-Dinv * ws.volb)[..., None, None] * tau
    mom0 = ws.mban[..., None] * ws.vb + \
        jnp.einsum("bkij,bkj->bki", A_m, ws.rel0)
    f0 = jnp.einsum("bkij,bkj->bki", A_f, ws.rel0)
    Q0 = jnp.concatenate([ws.mban[..., None], mom0, f0], -1)   # [B,K,7]
    QA = [jnp.concatenate(
        [zero, dx * A_m[..., :, d], dx * A_f[..., :, d]], -1)
        for d in range(3)]
    acc = ws.p2g(Q0, QA)                                       # [nb,64,7]
    gm = acc[..., 0]
    gmv = acc[..., 1:4]
    fint = acc[..., 4:7]

    # ---- predictor + Dirichlet mask -----------------------------------------
    has_mass = gm > 0.0
    minv = jnp.where(has_mass, 1.0 / jnp.maximum(gm, 1e-30), 0.0)
    v_pred = (gmv + dt * fint) * minv[..., None] + \
        dt * sim.gravity[None, None, :]
    v_pred = jnp.where(has_mass[..., None], v_pred, 0.0)
    node_x = ws.node_positions()
    v_bc = resolve_boundaries(sim.colliders, node_x, v_pred)
    constrained = jnp.any(jnp.abs(v_bc - v_pred) > 0.0, axis=-1)
    free = has_mass & ~constrained

    # NOTE: every scalar-field-times-tensor product consumed inside the CG
    # while_loop goes through :func:`scale_trailing` — a plain
    # ``field[..., None] *`` broadcast of a loop-invariant is hoisted by XLA
    # and stored 128x lane-padded (512 MB per bf16[16384,128,1] at 1M
    # particles, which OOMed this step).  Same for the invariant
    # ``rel0[..., None, :]`` outer-product operand: unrolled per component.
    free_f = free.astype(jnp.float32)
    rel = [ws.rel0[..., d] for d in range(3)]

    def project(u):
        return scale_trailing(free_f, u)

    # ---- matrix-free (M + dt^2 K) u over [nb, 64, 3] ------------------------
    def K_action(u):
        s0, (sx, sy, sz) = ws.g2p(u)
        sidx = dx * jnp.stack([sx, sy, sz], axis=-1)
        dB = jnp.stack([
            jnp.stack([s0[..., i] * rel[j] for j in range(3)], -1)
            for i in range(3)], -2) + sidx
        dC = Dinv * dB
        dF = dt * mm(dC, Fb)
        _, dP = jax.jvp(model.first_piola, (Fb,), (dF,))
        dtau = mm(dP, jnp.swapaxes(Fb, -1, -2))
        A2 = scale_trailing(dt * Dinv * ws.volb, dtau)
        Qk = jnp.stack([
            A2[..., i, 0] * rel[0] + A2[..., i, 1] * rel[1] +
            A2[..., i, 2] * rel[2] for i in range(3)], -1)
        QAk = [dx * A2[..., :, d] for d in range(3)]
        return ws.p2g(Qk, QAk)

    def A(u):
        return scale_trailing(gm, u) + K_action(u)

    def precondition(r):
        return scale_trailing(minv, r)

    rhs = project(scale_trailing(gm, v_pred))
    res = cg(A, rhs, x0=project(v_pred), project=project,
             precondition=precondition, max_iters=cg_iters, rel_tol=cg_tol)
    gv = jnp.where(free[..., None], res.x, v_bc)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))
    grid = grid.with_data(m=gm, v=gv)

    # ---- G2P + advect ---------------------------------------------------------
    s0, (sx, sy, sz) = ws.g2p(gv)
    v_new = s0
    Bmat = v_new[..., :, None] * ws.rel0[..., None, :] + \
        dx * jnp.stack([sx, sy, sz], axis=-1)
    C_new = Dinv * Bmat
    eye = jnp.eye(3, dtype=Fb.dtype)
    F_new = mm(eye + dt * C_new, Fb)
    upd_Jp = None
    if plasticity is not None and p.has_prop("Jp"):
        Jpb = ws.bin_leaves(p["Jp"])
        F_new, upd_Jp = plasticity.project(F_new, Jpb)
    x_new = ws.xb + dt * v_new
    channels = dict(
        x=ws.unbin(x_new, p["x"]), v=ws.unbin(v_new, p["v"]),
        F=ws.unbin(F_new, p["F"]), C=ws.unbin(C_new, p["C"]))
    if upd_Jp is not None:
        channels["Jp"] = ws.unbin(upd_Jp, p["Jp"])
    particles = p.update(**channels)
    return MPMState(particles, grid, max_vel), ws.overflow
