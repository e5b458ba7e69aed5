"""Implicit MPM: matrix-free backward-Euler grid solve with PCG.

Reference: ``simulation/mpm/ImplicitMPM.hpp`` — ``ImplicitMPMSystem`` whose
``multiply`` is a fused G2P2G force-differential pass plus
``ForceDtSqrPlusMass`` (:11-60), a boundary ``Projector`` (:63-80), plugged
into ``ConjugateGradient::solve`` over grid-velocity dofs (SURVEY §3.3).

Re-design: the operator is the same gather -> dP/dF -> scatter pipeline
as one explicit transfer round, expressed with the *same* stencil arrays
(computed once per step and closed over by the CG lambda).  The
force-differential dP(F)[dF] comes from ``jax.jvp`` on the constitutive
model's ``first_piola`` — no hand-derived Hessians (the reference
hand-codes per-model derivatives).  The whole Newton(1-step)-PCG solve is a
single XLA program via ``lax.while_loop`` — no per-iteration kernel
launches or device-host dot-product copies
(cf. ConjugateGradient.hpp:61-70).

System solved (mass-PSD form, one Newton step per time step):
    (M + dt^2 K) v_new = M v_pred,   v_pred = (mv + dt f_int + dt M g)/M
with K the elastic stiffness action and Dirichlet projection at collider
nodes.  Diagonal (Jacobi) preconditioning by M.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..geometry.collider import resolve_boundaries
from ..math.solvers import cg
from ..math.vecmat import mm
from .mpm import MPMSim, MPMState, _stencil

__all__ = ["implicit_step"]


def implicit_step(sim: MPMSim, state: MPMState, dt,
                  cg_iters: int = 50, cg_tol: float = 1e-3,
                  newton_iters: int = 1, hessian_clamp: float = 0.0
                  ) -> MPMState:
    """One implicit (backward-Euler) MPM step — single XLA program.

    ``newton_iters=1`` (default) is the reference-equivalent single
    linearized solve.  ``newton_iters>1`` adds true Newton refinement of
    the nonlinear grid residual G(v) = M(v - v_mom) - dt f_int(F(v)),
    each refinement guarded by a backtracking line search on |G| (the
    reference's ImplicitMPM has neither; they matter for stiff materials
    at large dt).  ``hessian_clamp=s`` evaluates the force differential
    at F with singular values clamped to >= s — a Gauss-Newton-style
    positive-definiteness guard near inversion (cf. the reference's
    hand-coded per-model Hessians, ImplicitMPM.hpp:11-60).
    """
    p = state.particles
    grid = state.grid
    dim, bs = grid.dim, grid.block_size
    ncell = grid.cells_per_block
    cap_cells = grid.block_capacity * ncell
    dx = grid.dx
    pmask = p.mask
    m = jnp.where(pmask, p["m"], 0.0)
    vol = jnp.where(pmask, p["vol"], 0.0)
    Dinv = 4.0 / (dx * dx)

    # -- partition + stencil (shared with explicit path) ----------------------
    cells, w3, base, xi = _stencil(sim, grid, p["x"])
    pblock = jnp.floor_divide(base, bs)
    grid = grid.activate(pblock, valid=pmask, dilation=1)
    slot = grid.cell_slot(cells)
    slot = jnp.where(slot >= 0, slot, cap_cells)
    flat = slot.reshape(-1)
    xdiff = (cells.astype(xi.dtype) - xi[:, None, :]) * dx   # [N,S^3,3]
    F = p["F"]

    def scatter4(mass_c, mom):
        payload = jnp.concatenate([mass_c[..., None], mom], -1)
        acc = jnp.zeros((cap_cells + 1, 1 + dim), payload.dtype)
        return acc.at[flat].add(payload.reshape(-1, 1 + dim))[:cap_cells]

    def scatter3(vecs):
        acc = jnp.zeros((cap_cells + 1, dim), vecs.dtype)
        return acc.at[flat].add(vecs.reshape(-1, dim))[:cap_cells]

    def gather3(g):
        safe = jnp.minimum(slot, cap_cells - 1)
        out = g[safe]
        return jnp.where((slot < cap_cells)[..., None], out, 0.0)

    # -- P2G: mass, APIC momentum, internal force -----------------------------
    tau = sim.model.kirchhoff(F)
    mom = w3[..., None] * (m[:, None, None] * p["v"][:, None, :] +
                           jnp.einsum("nij,nkj->nki",
                                      m[:, None, None] * p["C"], xdiff))
    acc = scatter4(w3 * m[:, None], mom)
    gm, gmv = acc[:, 0], acc[:, 1:]
    # MLS nodal force: f_i = -sum_p vol tau Dinv (x_i - x_p) w
    fint = scatter3(-w3[..., None] * Dinv * vol[:, None, None] *
                    jnp.einsum("nij,nkj->nki", tau, xdiff))

    # -- predictor + boundary mask --------------------------------------------
    has_mass = gm > 0.0
    minv = jnp.where(has_mass, 1.0 / jnp.maximum(gm, 1e-30), 0.0)
    v_pred = (gmv + dt * fint) * minv[:, None] + dt * sim.gravity[None, :]
    v_pred = jnp.where(has_mass[:, None], v_pred, 0.0)
    node_x = grid.node_world_positions().reshape(cap_cells, dim)
    # Dirichlet mask: nodes inside any collider get fully constrained to the
    # boundary-resolved velocity (sticky semantics for the implicit solve)
    v_bc = resolve_boundaries(sim.colliders, node_x, v_pred)
    constrained = jnp.any(jnp.abs(v_bc - v_pred) > 0.0, axis=-1)
    free = has_mass & ~constrained

    def project(u):
        return jnp.where(free[:, None], u, 0.0)

    # Hessian linearization point: optionally clamp F's singular values
    # away from inversion (scalar-form svd, math/svd.py) so dP/dF stays
    # positive-definite-ish for the corotated/NH family
    if hessian_clamp > 0.0:
        from ..math.svd import svd3x3, svd2x2
        svd = svd3x3 if dim == 3 else svd2x2
        U, S, V = svd(F)
        Sc = jnp.maximum(S, hessian_clamp)
        F_h = mm(U * Sc[..., None, :], jnp.swapaxes(V, -1, -2))
    else:
        F_h = F

    # -- matrix-free operator: A u = M u + dt^2 K u ---------------------------
    def K_action(u):
        du = gather3(u)                                   # [N,S^3,3]
        dC = Dinv * jnp.einsum("nk,nki,nkj->nij", w3, du, xdiff)
        dF = dt * mm(dC, F_h)
        _, dP = jax.jvp(sim.model.first_piola, (F_h,), (dF,))
        dtau = mm(dP, jnp.swapaxes(F_h, -1, -2))
        return scatter3(w3[..., None] * Dinv * vol[:, None, None] * dt *
                        jnp.einsum("nij,nkj->nki", dtau, xdiff))

    def A(u):
        # K_action carries dt^2: one dt in dF (position change dt*u), one in
        # the force integral -> (M + dt^2 K) u
        return gm[:, None] * u + K_action(u)

    def precondition(r):
        return r * minv[:, None]

    rhs = project(gm[:, None] * v_pred)
    res = cg(lambda u: A(u), rhs, x0=project(v_pred), project=project,
             precondition=precondition, max_iters=cg_iters, rel_tol=cg_tol)
    gv = jnp.where(free[:, None], res.x, v_bc)

    # -- optional Newton refinement with backtracking line search -------------
    if newton_iters > 1:
        eye_d = jnp.eye(dim, dtype=F.dtype)
        v_mom = gmv * minv[:, None] + dt * sim.gravity[None, :]
        v_mom = jnp.where(has_mass[:, None], v_mom, 0.0)

        def residual(v):
            du = gather3(v)
            Cv = Dinv * jnp.einsum("nk,nki,nkj->nij", w3, du, xdiff)
            Fv = mm(eye_d + dt * Cv, F)
            tau_v = sim.model.kirchhoff(Fv)
            fv = scatter3(-w3[..., None] * Dinv * vol[:, None, None] *
                          jnp.einsum("nij,nkj->nki", tau_v, xdiff))
            return project(gm[:, None] * v - gm[:, None] * v_mom
                           - dt * fv)

        def norm2(u):
            return jnp.sum(u * u)

        vk = jnp.where(free[:, None], gv, 0.0)
        for _ in range(newton_iters - 1):
            Gk = residual(vk)
            gn = norm2(Gk)
            delta = cg(lambda u: A(u), -Gk, project=project,
                       precondition=precondition, max_iters=cg_iters,
                       rel_tol=cg_tol).x
            # backtracking: first alpha in {1, 1/2, 1/4, 1/8} that
            # reduces |G|; keep vk if none does
            best_v, best_n = vk, gn
            accepted = jnp.bool_(False)
            for alpha in (1.0, 0.5, 0.25, 0.125):
                cand = project(vk + alpha * delta)
                cn = norm2(residual(cand))
                take = (~accepted) & (cn < gn)
                best_v = jnp.where(take, cand, best_v)
                best_n = jnp.where(take, cn, best_n)
                accepted = accepted | take
            vk = best_v
        gv = jnp.where(free[:, None], vk, v_bc)
    gv = jnp.where(has_mass[:, None], gv, 0.0)
    max_vel = jnp.sqrt(jnp.max(jnp.sum(gv * gv, -1)))
    grid = grid.with_data(
        m=gm.reshape(grid.block_capacity, ncell),
        v=gv.reshape(grid.block_capacity, ncell, dim))

    # -- G2P + advect ---------------------------------------------------------
    vnode = gather3(gv)
    v_new = jnp.einsum("nk,nki->ni", w3, vnode)
    C_new = Dinv * jnp.einsum("nk,nki,nkj->nij", w3, vnode, xdiff)
    eye = jnp.eye(dim, dtype=F.dtype)
    F_new = mm(eye + dt * C_new, F)
    upd = {}
    if sim.plasticity is not None and p.has_prop("Jp"):
        F_new, Jp_new = sim.plasticity.project(F_new, p["Jp"])
        upd["Jp"] = jnp.where(pmask, Jp_new, p["Jp"])
    x_new = p["x"] + dt * v_new
    mk = pmask[:, None]
    particles = p.update(
        x=jnp.where(mk, x_new, p["x"]), v=jnp.where(mk, v_new, p["v"]),
        F=jnp.where(mk[..., None], F_new, p["F"]),
        C=jnp.where(mk[..., None], C_new, p["C"]), **upd)
    return MPMState(particles, grid, max_vel)
