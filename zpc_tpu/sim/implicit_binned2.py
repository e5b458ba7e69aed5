"""Implicit MPM on the binned-v2 (bin-ordered, gather-free) machinery.

Same system as :mod:`zpc_tpu.sim.implicit` — ``(M + dt^2 K) v = M v_pred``
with Dirichlet projection — but the transfer context (:class:`_Ctx3`:
direct-eval stencils, frozen bin->block mapping, spill selection) is
built ONCE per step and shared by every CG operator application, and the
particle state stays in bin order across a rollout.  This supersedes
:mod:`zpc_tpu.sim.implicit_binned` (v1 workspace) as the BASELINE
config-5 path: the v1 step re-packed/unpacked the particle state through row
gathers every step (chosen before the move to the GPU; not re-measured on the
H100).

Reference lineage: ``simulation/mpm/ImplicitMPM.hpp:11-60`` (matrix-free
``multiply`` = G2P force-differential + ForceDtSqrPlusMass), boundary
``Projector`` (``:63-80``), solved by ``math/linear/ConjugateGradient.hpp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..geometry.collider import resolve_boundaries
from ..math.solvers import cg
from ..math.vecmat import mm, scale_trailing
from .mpm import MPMSim, MPMState
from .mpm_binned2 import (BinnedConfig2, BinState, K, _ctx_g2p, _ctx_p2g,
                          _make_ctx3, _node_positions, _rebin, adaptive_chain,
                          bin_state, rebin_adaptive, unbin_state)

__all__ = ["implicit_step_binned2", "implicit_rollout_binned2"]


def _implicit_bin_step(sim: MPMSim, st: BinState, dt, cfg: BinnedConfig2,
                       cg_iters: int, cg_tol: float,
                       contact=None, with_stats: bool = False,
                       contact_precond: bool = False) -> BinState:
    """One implicit step on a BinState (bin order in/out).

    ``contact``: optional :class:`~zpc_tpu.sim.contact_implicit.
    ContactCoupling` adding IPC barrier forces/Hessians to the system.
    """
    grid = st.grid
    dx = grid.dx
    B = cfg.bins_capacity
    L = B * K
    Dinv = 4.0 / (dx * dx)

    cols = st.cols.reshape(B, K, -1)
    xb = cols[..., 0:3]
    vb = cols[..., 3:6]
    Fb = cols[..., 6:15].reshape(B, K, 3, 3)
    Cb = cols[..., 15:24].reshape(B, K, 3, 3)
    lane_alive = (st.pid >= 0).reshape(B, K)
    mban = jnp.where(lane_alive, cols[..., 24], 0.0)
    volb = jnp.where(lane_alive, cols[..., 25], 0.0)

    ctx = _make_ctx3(st, cfg)
    overflow = ctx.overflow
    rel0 = ctx.rel0
    rel = [rel0[..., d] for d in range(3)]
    # bin-chunked transfers: every CG operator application re-streams the
    # [B,K,·] plane intermediates; chunking bounds their working set as in the
    # explicit step (chosen before the move to the GPU; not re-measured on the
    # H100)
    chunk = cfg.chunk_bins if (cfg.chunk_bins and ctx.use_seg) else 0

    # ---- one P2G pass for mass, APIC momentum, internal force --------------
    tau = sim.model.kirchhoff(Fb)
    A_m = mban[..., None, None] * Cb
    A_f = (-Dinv * volb)[..., None, None] * tau
    mom0 = mban[..., None] * vb + jnp.einsum("bkij,bkj->bki", A_m, rel0)
    f0 = jnp.einsum("bkij,bkj->bki", A_f, rel0)
    # contact forces at t^n ride the SAME transfer: fc is plain-weight
    # (no affine plane), so folding it into the f channels costs nothing
    # while a separate plain P2G pass would cost a full transfer
    pdiag = None
    if contact is not None:
        cset = contact.broad_phase(ctx, lane_alive)
        overflow = overflow | cset.overflow
        fc, Hc = contact.forces_and_hessians(cset, xb, lane_alive)
        f0 = f0 + fc
        if contact_precond:
            # barrier-diag Jacobi: grid
            # row-norm estimate of diag(dt^2 Kc) via the squared-weight
            # P2G the round-2 stiffness study built — once per STEP,
            # not per CG iteration.  The barrier Hessian is rank-1-ish
            # per particle (kappa n n^T scale), so unlike the elastic
            # K (whose diag estimate HURT — see the note below), its
            # diagonal is an honest row norm.
            dHc = jnp.maximum(
                jnp.diagonal(Hc, axis1=-2, axis2=-1), 0.0)   # [B,K,3]
            pdiag = _ctx_p2g(ctx, dHc, None, squared=True, chunk=chunk)
    Q0 = jnp.concatenate([mban[..., None], mom0, f0], -1)      # [B,K,7]
    # mass plane of the index-weighted transfer is structurally zero —
    # pass the 6 live channels, _ctx_p2g pads
    QA = [jnp.concatenate([dx * A_m[..., :, d], dx * A_f[..., :, d]], -1)
          for d in range(3)]
    acc = _ctx_p2g(ctx, Q0, QA, chunk=chunk)                   # [nb,64,7]
    gm = acc[..., 0]
    gmv = acc[..., 1:4]
    fint = acc[..., 4:7]

    # ---- predictor + Dirichlet mask -----------------------------------------
    has_mass = gm > 0.0
    minv = jnp.where(has_mass, 1.0 / jnp.maximum(gm, 1e-30), 0.0)
    v_pred = (gmv + dt * fint) * minv[..., None] + \
        dt * sim.gravity[None, None, :]
    v_pred = jnp.where(has_mass[..., None], v_pred, 0.0)
    node_x = _node_positions(ctx)
    v_bc = resolve_boundaries(sim.colliders, node_x, v_pred)
    constrained = jnp.any(jnp.abs(v_bc - v_pred) > 0.0, axis=-1)
    free = has_mass & ~constrained
    free_f = free.astype(jnp.float32)

    def project(u):
        return scale_trailing(free_f, u)

    # ---- matrix-free (M + dt^2 K [+ dt^2 Kc]) u over [nb,64,3] -------------
    # Linearize the stress once per step: jvp inside the CG body re-emits
    # the primal chain (SVD sweeps) every iteration and XLA's loop-
    # invariant hoisting does not reliably lift a subgraph that large out
    # of the while loop; ``linearize`` stores the primal residuals and the
    # body replays only the tangent ops (ImplicitMPM.hpp precomputes the
    # per-particle stress derivative in the same spirit).
    _, dP_lin = jax.linearize(sim.model.first_piola, Fb)

    def K_action(u):
        s0, sx, sy, sz = _ctx_g2p(ctx, u, chunk=chunk)
        sidx = dx * jnp.stack([sx, sy, sz], axis=-1)
        dB = jnp.stack([
            jnp.stack([s0[..., i] * rel[j] for j in range(3)], -1)
            for i in range(3)], -2) + sidx
        dC = Dinv * dB
        dF = dt * mm(dC, Fb)
        dP = dP_lin(dF)
        dtau = mm(dP, jnp.swapaxes(Fb, -1, -2))
        A2 = scale_trailing(dt * Dinv * volb, dtau)
        Qk = jnp.stack([
            A2[..., i, 0] * rel[0] + A2[..., i, 1] * rel[1] +
            A2[..., i, 2] * rel[2] for i in range(3)], -1)
        if contact is not None:
            # contact Hessian acts on particle velocity: dv_p = G2P(u),
            # df_p = dt^2 H_p dv_p — plain-weight channels folded into
            # Qk's plain part (same one-transfer trick as the rhs; a
            # separate P2G here would cost one transfer per iteration).
            # Distance.hpp
            # grads/Hessians consumed by the grid solve.
            Qk = Qk + (dt * dt) * jnp.einsum("bkij,bkj->bki", Hc, s0)
        QAk = [dx * A2[..., :, d] for d in range(3)]
        return _ctx_p2g(ctx, Qk, QAk, chunk=chunk)

    def A_op(u):
        return scale_trailing(gm, u) + K_action(u)

    # Mass-only Jacobi (ImplicitMPM.hpp precondition()).  A scalar diag(M +
    # dt^2 K) estimate via a squared-weight P2G of c0*dt^2*Dinv*vol*(2mu+lam)
    # was tried and HURTS (7 -> 11-15 iters at stiff dt for c0 in [4,16]) — the
    # stiffness row norm does not capture K's near-null bending modes, and
    # distorting the mass balance slows exactly those.  Mass-only converges in
    # <= 7 iters at rel_tol 1e-3 across the probe regimes; the solver stops on
    # tolerance.
    if pdiag is not None:
        pd = jnp.maximum(gm[..., None] + (dt * dt) * pdiag, 1e-30)

        def precondition(r):
            return jnp.where(has_mass[..., None], r / pd, 0.0)
    else:
        def precondition(r):
            return scale_trailing(minv, r)

    rhs = project(scale_trailing(gm, v_pred))
    res = cg(A_op, rhs, x0=project(v_pred), project=project,
             precondition=precondition, max_iters=cg_iters, rel_tol=cg_tol)
    gv = jnp.where(free[..., None], res.x, v_bc)
    gv = jnp.where(has_mass[..., None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))

    # ---- G2P + advect --------------------------------------------------------
    s0, sx, sy, sz = _ctx_g2p(ctx, gv, chunk=chunk)
    v_new = s0
    Bmat = v_new[..., :, None] * rel0[..., None, :] + \
        dx * jnp.stack([sx, sy, sz], axis=-1)
    C_new = Dinv * Bmat
    eye = jnp.eye(3, dtype=Fb.dtype)
    F_new = mm(eye + dt * C_new, Fb)
    if sim.plasticity is not None and st.has_jp:
        F_new, Jp_new = sim.plasticity.project(F_new, cols[..., 26])
    x_new = xb + dt * v_new
    if contact is not None and getattr(contact, "use_ccd", False):
        # conservative-advancement step limiting against the candidate
        # set (ccd_tight lineage): clamp advection, never the solve
        alpha = contact.toi(cset, xb, dt * v_new, lane_alive)
        x_new = xb + alpha[..., None] * (dt * v_new)

    # escape check + Galilean recentering: same contract as the explicit
    # v2 step (mpm_binned2._step3d)
    base_new = jnp.floor((x_new - ctx.origin_w) / dx - 0.5).astype(jnp.int32)
    off_new = base_new - ctx.borigin[:, None, :]
    if cfg.recenter:
        asum = jnp.maximum(jnp.sum(lane_alive.astype(jnp.int32)), 1)
        mean_off = (jnp.sum(jnp.where(lane_alive[..., None], off_new, 0),
                            axis=(0, 1)).astype(jnp.float32) / asum)
        shift = jnp.clip(jnp.round(mean_off - 0.5 * (cfg.side - 3)),
                         -1.0, 1.0).astype(jnp.int32)
        off_new = off_new - shift[None, None, :]
        tm = grid.transform.matrix.at[:3, 3].add(
            shift.astype(jnp.float32) * dx)
        grid = dataclasses.replace(
            grid, transform=dataclasses.replace(grid.transform, matrix=tm))
    escaped = jnp.any(lane_alive[..., None] &
                      ((off_new < 0) | (off_new > cfg.side - 3)))

    ok3 = lane_alive[..., None]
    newcols = [jnp.where(ok3, x_new, xb), jnp.where(ok3, v_new, vb),
               jnp.where(ok3[..., None], F_new, Fb).reshape(B, K, 9),
               jnp.where(ok3[..., None], C_new, Cb).reshape(B, K, 9),
               mban[..., None], volb[..., None]]
    if st.has_jp:
        jpcol = (Jp_new if sim.plasticity is not None else cols[..., 26])
        newcols.append(jnp.where(ok3, jpcol[..., None], cols[..., 26:27]))
    ncols = jnp.concatenate(newcols, axis=-1).reshape(L, -1)

    grid = dataclasses.replace(grid, data={"m": gm, "v": gv})
    out = dataclasses.replace(st, cols=ncols, grid=grid, max_vel=max_vel,
                              overflow=overflow, needs_rebin=escaped)
    if with_stats:
        return out, res.iters
    return out


def implicit_step_binned2(sim: MPMSim, state, dt, cfg: BinnedConfig2,
                          cg_iters: int = 50, cg_tol: float = 1e-3,
                          contact=None, *, rebin: bool = True,
                          with_stats: bool = False,
                          contact_precond: bool = False):
    """Implicit step: MPMState -> (MPMState, overflow), or BinState ->
    BinState when called with a BinState (rollout-internal form).
    ``with_stats=True`` (BinState form) also returns the CG iteration
    count the solve actually used (tol-based early exit).
    ``contact_precond``: add the barrier Hessian's squared-weight grid
    diagonal to the Jacobi preconditioner (round-4 study; the design log
    is in git history, docs/design.md)."""
    if isinstance(state, BinState):
        st = _rebin(sim, state, cfg) if rebin else state
        return _implicit_bin_step(sim, st, dt, cfg, cg_iters, cg_tol,
                                  contact, with_stats=with_stats,
                                  contact_precond=contact_precond)
    bst = bin_state(sim, state, cfg)
    out = _implicit_bin_step(sim, bst, dt, cfg, cg_iters, cg_tol, contact,
                             contact_precond=contact_precond)
    return unbin_state(out, state), out.overflow


def implicit_rollout_binned2(sim: MPMSim, state: MPMState, dt,
                             cfg: BinnedConfig2, n_steps: int,
                             cg_iters: int = 50, cg_tol: float = 1e-3,
                             contact=None) -> Tuple[MPMState, jax.Array]:
    """n implicit steps in bin order with adaptive rebinning (same
    two-level cond-hoisted structure as the explicit rollout)."""
    st = bin_state(sim, state, cfg)
    st = adaptive_chain(
        lambda s: _implicit_bin_step(sim, s, dt, cfg, cg_iters, cg_tol,
                                     contact),
        lambda s: rebin_adaptive(sim, s, cfg), st, n_steps)
    return unbin_state(st, state), st.overflow
