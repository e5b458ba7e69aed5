"""Cloth assembly solver: stretch + hinge bending + IPC ground barrier
via Newton-CG (sim/cloth.py; consumes DihedralAngle.hpp + Distance.hpp
barrier + ConjugateGradient.hpp analogs)."""

import numpy as np
import jax
import jax.numpy as jnp

from zpc_tpu.sim.cloth import (ClothSim, cloth_energy, implicit_step,
                               make_cloth_grid)


def test_topology_build():
    sim, x0 = make_cloth_grid(4, 3, 0.1)
    assert sim.tris.shape == (12, 3)
    # edges: 4*3 grid -> E = horizontal 3*3 + vertical 4*2 + diagonal 6
    assert sim.edges.shape[0] == 9 + 8 + 6
    # hinges = interior edges (shared by two tris)
    assert sim.hinges.shape[0] == sim.edges.shape[0] - (2 * 3 + 2 * 2)
    # flat rest state: rest angles all ~0
    np.testing.assert_allclose(np.asarray(sim.rest_angle), 0.0,
                               atol=1e-6)
    # every hinge row's middle two vertices form a real edge
    e = set(map(tuple, np.sort(np.asarray(sim.edges), axis=1).tolist()))
    h = np.asarray(sim.hinges)
    for r in h:
        assert tuple(sorted((r[1], r[2]))) in e


def test_pinned_corners_hang():
    """Cloth pinned at two corners sags but pins stay fixed, system
    stays finite and kinetic energy settles."""
    nx, ny = 6, 6
    sim, x0 = make_cloth_grid(nx, ny, 0.05, height=0.5,
                              pinned=(0, (nx - 1) * ny),
                              k_stretch=2e2, k_bend=1e-4, mass=0.01)
    v = jnp.zeros_like(x0)
    step = jax.jit(lambda x, v: implicit_step(sim, x, v, 0.02))
    x = x0
    for _ in range(30):
        x, v = step(x, v)
    xn = np.asarray(x)
    assert np.isfinite(xn).all()
    np.testing.assert_allclose(xn[0], np.asarray(x0)[0], atol=1e-6)
    np.testing.assert_allclose(xn[(nx - 1) * ny],
                               np.asarray(x0)[(nx - 1) * ny], atol=1e-6)
    # it sagged
    assert xn[:, 1].min() < 0.5 - 0.02
    # and is settling (velocities bounded well below free fall)
    assert np.abs(np.asarray(v)).max() < 2.0


def test_falls_onto_ground_no_penetration():
    """Free cloth falls onto the ground plane; the barrier + analytic
    step limiter keep every vertex strictly above it at every step."""
    sim, x0 = make_cloth_grid(5, 5, 0.05, height=0.08,
                              k_stretch=2e2, k_bend=1e-4, mass=0.01,
                              dhat=0.02, kappa=1e-1)
    v = jnp.zeros_like(x0)
    step = jax.jit(lambda x, v: implicit_step(sim, x, v, 0.01))
    x = x0
    min_gap = 1e9
    for _ in range(40):
        x, v = step(x, v)
        g = float(np.min(np.asarray(x)[:, 1]))
        min_gap = min(min_gap, g)
        assert g > 0.0, "vertex crossed the ground plane"
    # it actually came down near the barrier zone and rested
    assert min_gap < 0.04
    assert np.abs(np.asarray(v)).max() < 0.5


def test_energy_decreases_statics():
    """With zero velocity and no gravity-free direction to go, Newton
    steps decrease the incremental potential's elastic part from a
    stretched start."""
    sim, x0 = make_cloth_grid(5, 5, 0.05, height=0.5, k_stretch=1e3,
                              k_bend=1e-3, mass=0.01)
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.asarray(x0) +
                    0.01 * rng.standard_normal(x0.shape).astype(np.float32))
    e0 = float(cloth_energy(sim, x))
    v = jnp.zeros_like(x)
    x1, _ = jax.jit(lambda a, b: implicit_step(sim, a, b, 0.05,
                                               newton_iters=3))(x, v)
    e1 = float(cloth_energy(sim, x1))
    assert np.isfinite(e1)
    assert e1 < e0


def test_ground_friction_arrests_sliding():
    """Lagged IPC friction (Friction.hpp f0/f1 consumed by the cloth
    solver): a cloth sliding in the barrier zone is arrested with
    mu=0.6 but keeps sliding with mu=0."""
    def slide_dist(mu):
        sim, x0 = make_cloth_grid(5, 5, 0.05, height=0.008,
                                  k_stretch=2e2, k_bend=1e-4,
                                  mass=0.01, dhat=0.02, kappa=2.0,
                                  mu=mu)
        v = jnp.zeros_like(x0).at[:, 0].set(0.5)
        step = jax.jit(lambda x, v: implicit_step(sim, x, v, 0.01))
        x = x0
        for _ in range(30):
            x, v = step(x, v)
        dx = np.asarray(x)[:, 0] - np.asarray(x0)[:, 0]
        return float(np.mean(dx)), float(np.abs(np.asarray(v)).max())

    d_free, v_free = slide_dist(0.0)
    d_fric, v_fric = slide_dist(0.6)
    assert v_free > 0.1          # frictionless keeps sliding
    assert d_fric < 0.3 * d_free  # friction arrests early
    assert v_fric < 0.05          # ... to rest


def _two_layer(nx, ny, spacing, gap, dhat, shift=0.5, **kw):
    """One ClothSim holding two disconnected layers: layer A (pinned,
    flat) below, layer B (free) above by ``gap``, offset half a cell so
    B vertices land over A triangle interiors."""
    simA, xA = make_cloth_grid(nx, ny, spacing, height=0.2, dhat=dhat,
                               ground_off=-10.0, **kw)
    N = xA.shape[0]
    xB = xA + jnp.asarray([shift * spacing, gap, shift * spacing])
    free = np.concatenate([np.zeros(N, bool), np.ones(N, bool)])
    sim = ClothSim(
        tris=jnp.concatenate([simA.tris, simA.tris + N]),
        edges=jnp.concatenate([simA.edges, simA.edges + N]),
        hinges=jnp.concatenate([simA.hinges, simA.hinges + N]),
        rest_len=jnp.concatenate([simA.rest_len, simA.rest_len]),
        rest_angle=jnp.concatenate([simA.rest_angle, simA.rest_angle]),
        mass=jnp.concatenate([simA.mass, simA.mass]),
        free=jnp.asarray(free),
        k_stretch=simA.k_stretch, k_bend=simA.k_bend,
        gravity=simA.gravity, ground_n=simA.ground_n,
        ground_off=simA.ground_off, dhat=simA.dhat, kappa=simA.kappa,
        mu=simA.mu, epsv=simA.epsv)
    return sim, jnp.concatenate([xA, xB])


def test_self_contact_candidates_complete():
    """Broad phase: every non-incident triangle within dhat of a vertex
    appears in its candidate list (oracle: brute-force distances)."""
    from zpc_tpu.geometry.distance import point_triangle_closest
    from zpc_tpu.sim.cloth import self_contact_candidates
    dhat = 0.02
    sim, x0 = _two_layer(5, 5, 0.05, 0.015, dhat, k_stretch=2e2,
                         k_bend=1e-4, mass=0.01)
    cand, ovf = jax.jit(lambda x: self_contact_candidates(sim, x, 8))(x0)
    assert not bool(ovf)
    cand = np.asarray(cand)
    x = np.asarray(x0)
    tris = np.asarray(sim.tris)
    for vtx in range(x.shape[0]):
        _, cl = point_triangle_closest(
            jnp.asarray(x[vtx])[None, :],
            jnp.asarray(x[tris[:, 0]]), jnp.asarray(x[tris[:, 1]]),
            jnp.asarray(x[tris[:, 2]]))
        d = np.linalg.norm(np.asarray(cl) - x[vtx], axis=-1)
        for t in np.nonzero(d < dhat * 0.999)[0]:
            if vtx in tris[t]:
                continue
            assert t in cand[vtx], (vtx, t, d[t])


def test_self_contact_two_layers_no_interpenetration():
    """Layer B falls onto pinned layer A: with self-contact every B
    vertex stays above A; without it B falls straight through."""
    dhat = 0.012
    sim, x0 = _two_layer(5, 5, 0.05, 0.02, dhat, k_stretch=2e2,
                         k_bend=1e-4, mass=0.01)
    v0 = jnp.zeros_like(x0)
    dt = 0.01
    step = jax.jit(lambda x, v: implicit_step(
        sim, x, v, dt, newton_iters=2, cg_iters=40, self_contact=True))
    # B vertices strictly over A's triangulated footprint (the +0.5-cell
    # shift leaves B's last row/col hanging over A's edge, where sagging
    # below A's plane is legitimate)
    inner = np.asarray([25 + i * 5 + j for i in range(4)
                        for j in range(4)])
    x, v = x0, v0
    any_ovf = False
    for _ in range(40):
        x, v, ovf = step(x, v)
        any_ovf |= bool(ovf)
        assert np.isfinite(np.asarray(x)).all()
        assert np.asarray(x)[inner, 1].min() > 0.2 - 1e-4, "penetrated A"
    assert not any_ovf
    # B actually rests on A (settled within a few dhat above the plane)
    assert np.asarray(x)[inner, 1].min() < 0.2 + 3 * dhat

    # negative control: without self-contact B falls through
    step0 = jax.jit(lambda x, v: implicit_step(sim, x, v, dt))
    x, v = x0, v0
    for _ in range(40):
        x, v = step0(x, v)
    assert np.asarray(x)[25:, 1].min() < 0.2 - 0.02


def test_assembled_operator_matches_autodiff_where_gn_exact():
    """The assembled GN operator (round 4) equals the autodiff HVP
    exactly in the regime where GN is exact: at the rest state the
    bending E' = 0 (GN drop vanishes), stretch is at its clamp boundary
    (l == L), ground barrier inactive, no friction/contact."""
    from zpc_tpu.sim.cloth import apply_operator, assemble_operator
    sim, x0 = make_cloth_grid(8, 8, 0.1, ground_off=-100.0, mu=0.0)
    dt = jnp.float32(0.02)
    m3 = sim.mass[:, None]

    def grad_phi(y):
        return (m3 / (dt * dt)) * (y - x0) + jax.grad(
            lambda z: cloth_energy(sim, z))(y)

    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.normal(size=x0.shape).astype(np.float32))
    hvp_auto = jax.jit(
        lambda y, q: jax.jvp(grad_phi, (y,), (q,))[1])(x0, p)
    op = jax.jit(lambda y: assemble_operator(sim, y, y, dt))(x0)
    hvp_asm = jax.jit(
        lambda _op, q: apply_operator(sim, _op, q, dt))(op, p)
    scale = float(jnp.max(jnp.abs(hvp_auto)))
    np.testing.assert_allclose(np.asarray(hvp_asm),
                               np.asarray(hvp_auto),
                               rtol=2e-3, atol=2e-4 * scale)


def test_assembled_operator_symmetric_psd_general_state():
    """In a general deformed state with active contact and friction the
    assembled operator must stay symmetric and PSD (that is its job —
    the exact Hessian there is indefinite)."""
    from zpc_tpu.sim.cloth import (apply_operator, assemble_operator,
                                   self_contact_candidates)
    nx = 8
    sim, x0 = make_cloth_grid(nx, nx, 0.05, height=0.004, dhat=0.01,
                              kappa=1e2, mu=0.3, k_stretch=2e2,
                              k_bend=1e-4, mass=0.01)
    rng = np.random.default_rng(5)
    y = x0 + jnp.asarray(
        0.02 * rng.normal(size=x0.shape).astype(np.float32))
    cand, _ = self_contact_candidates(sim, y, 8)
    lam = jnp.asarray(rng.uniform(0, 1, x0.shape[0]).astype(np.float32))
    op = jax.jit(lambda z: assemble_operator(
        sim, z, x0, 0.02, cand=cand, lam=lam))(y)
    apply = jax.jit(lambda q: apply_operator(sim, op, q, 0.02))
    for _ in range(5):
        p = jnp.asarray(rng.normal(size=x0.shape).astype(np.float32))
        q = jnp.asarray(rng.normal(size=x0.shape).astype(np.float32))
        hp, hq = apply(p), apply(q)
        a = float(jnp.vdot(q, hp))
        b = float(jnp.vdot(p, hq))
        assert abs(a - b) <= 1e-4 * max(abs(a), abs(b), 1.0)
        assert float(jnp.vdot(p, hp)) >= 0.0
    assert bool(jnp.all(op["diag"] > 0.0))


def test_contact_active_set_compaction_matches_dense():
    """assemble_operator(contact_budget=K): the compacted apply equals
    the dense apply (dropped rows have bpp == 0 exactly), the diag and
    non-contact blocks are untouched, and the overflow flag fires
    exactly when live rows exceed the budget."""
    from zpc_tpu.sim.cloth import (apply_operator, assemble_operator,
                                   self_contact_candidates)
    nx = 8
    sim, x0 = make_cloth_grid(nx, nx, 0.05, height=0.004, dhat=0.01,
                              kappa=1e2, mu=0.3, k_stretch=2e2,
                              k_bend=1e-4, mass=0.01)
    rng = np.random.default_rng(7)
    y = x0 + jnp.asarray(
        0.02 * rng.normal(size=x0.shape).astype(np.float32))
    cand, _ = self_contact_candidates(sim, y, 8)
    lam = jnp.asarray(rng.uniform(0, 1, x0.shape[0]).astype(np.float32))
    dense = jax.jit(lambda z: assemble_operator(
        sim, z, x0, 0.02, cand=cand, lam=lam))(y)
    n_live = int(jnp.sum((jnp.asarray(dense["contact"][3]) > 0)
                         .astype(jnp.int32)))
    assert n_live > 0  # the scene must actually exercise contact
    comp = jax.jit(lambda z: assemble_operator(
        sim, z, x0, 0.02, cand=cand, lam=lam,
        contact_budget=n_live + 3))(y)
    assert comp["contact"] is None and comp["contact_c"] is not None
    assert not bool(comp["act_ovf"])
    np.testing.assert_array_equal(np.asarray(comp["diag"]),
                                  np.asarray(dense["diag"]))
    for _ in range(4):
        p = jnp.asarray(rng.normal(size=x0.shape).astype(np.float32))
        qd = jax.jit(lambda q: apply_operator(sim, dense, q, 0.02))(p)
        qc = jax.jit(lambda q: apply_operator(sim, comp, q, 0.02))(p)
        scale = float(jnp.max(jnp.abs(qd)))
        np.testing.assert_allclose(np.asarray(qc), np.asarray(qd),
                                   rtol=1e-5, atol=1e-6 * scale)
    # overflow contract: budget below the live count flags
    tight = jax.jit(lambda z: assemble_operator(
        sim, z, x0, 0.02, cand=cand, lam=lam,
        contact_budget=max(1, n_live - 1)))(y)
    assert bool(tight["act_ovf"])


def test_implicit_step_contact_budget_matches_dense():
    """implicit_step(contact_budget=K) with an ample budget reproduces
    the dense two-layer trajectory bit-for-bit up to f32 summation
    order, and reports no overflow."""
    nx = 6
    spacing, gap, dhat = 0.3 / nx, 0.01, 0.008
    simA, xA = make_cloth_grid(nx, nx, spacing, height=0.2, dhat=dhat,
                               ground_off=-10.0, k_stretch=2e2,
                               k_bend=1e-4, mass=0.01)
    N = xA.shape[0]
    xB = xA + jnp.asarray([0.5 * spacing, gap, 0.5 * spacing])
    free = np.concatenate([np.zeros(N, bool), np.ones(N, bool)])
    import dataclasses
    from zpc_tpu.sim.cloth import build_incidence
    sim = build_incidence(dataclasses.replace(
        simA,
        tris=jnp.concatenate([simA.tris, simA.tris + N]),
        edges=jnp.concatenate([simA.edges, simA.edges + N]),
        hinges=jnp.concatenate([simA.hinges, simA.hinges + N]),
        rest_len=jnp.concatenate([simA.rest_len, simA.rest_len]),
        rest_angle=jnp.concatenate([simA.rest_angle, simA.rest_angle]),
        mass=jnp.concatenate([simA.mass, simA.mass]),
        free=jnp.asarray(free), edge_inc=None, hinge_inc=None,
        stencil=None))
    x = jnp.concatenate([xA, xB])
    v = jnp.zeros_like(x)
    dt = jnp.float32(0.005)
    step_d = jax.jit(lambda c: implicit_step(
        sim, c[0], c[1], dt, newton_iters=2, cg_iters=12,
        self_contact=True))
    step_c = jax.jit(lambda c: implicit_step(
        sim, c[0], c[1], dt, newton_iters=2, cg_iters=12,
        self_contact=True, contact_budget=2 * int(x.shape[0])))
    xd, vd, xc, vc = x, v, x, v
    for _ in range(8):
        xd, vd, _ = step_d((xd, vd))
        xc, vc, ovf = step_c((xc, vc))
        assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(xc), np.asarray(xd),
                               rtol=3e-4, atol=3e-6)


def test_grid_stencil_matches_edge_list_operator():
    """The slice-form (stencil) energy, assembled operator, its
    application, and its exact diagonal equal the edge/hinge-list forms
    up to f32 summation order — on a single grid and on a two-grid
    union (the bench topology)."""
    import dataclasses
    from zpc_tpu.sim.cloth import (assemble_operator, apply_operator,
                                   build_grid_stencil)
    # single grid (make_cloth_grid attaches the stencil)
    sim, x0 = make_cloth_grid(9, 7, 0.05, dhat=0.008, kappa=50.0)
    assert sim.stencil is not None
    sim0 = dataclasses.replace(sim, stencil=None)
    y = x0 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), x0.shape)
    p = jax.random.normal(jax.random.PRNGKey(1), x0.shape)
    np.testing.assert_allclose(float(cloth_energy(sim, y)),
                               float(cloth_energy(sim0, y)), rtol=1e-6)
    op1 = assemble_operator(sim, y, x0, 0.01)
    op0 = assemble_operator(sim0, y, x0, 0.01)
    np.testing.assert_allclose(
        np.asarray(apply_operator(sim, op1, p, 0.01)),
        np.asarray(apply_operator(sim0, op0, p, 0.01)),
        rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(op1["diag"]),
                               np.asarray(op0["diag"]),
                               rtol=2e-5, atol=1e-4)
    # two-grid union: the bench two-layer topology
    nx = 6
    simT, xT = _two_layer(nx, nx, 0.05, 0.012, 0.01, k_stretch=2e2,
                          k_bend=1e-4, mass=0.01)
    N = nx * nx
    simS = build_grid_stencil(simT, ((0, nx, nx), (N, nx, nx)))
    yT = xT + 0.005 * jax.random.normal(jax.random.PRNGKey(2), xT.shape)
    pT = jax.random.normal(jax.random.PRNGKey(3), xT.shape)
    np.testing.assert_allclose(float(cloth_energy(simS, yT)),
                               float(cloth_energy(simT, yT)), rtol=1e-6)
    opS = assemble_operator(simS, yT, xT, 0.005)
    opT = assemble_operator(simT, yT, xT, 0.005)
    np.testing.assert_allclose(
        np.asarray(apply_operator(simS, opS, pT, 0.005)),
        np.asarray(apply_operator(simT, opT, pT, 0.005)),
        rtol=2e-5, atol=1e-4)


def test_grid_stencil_trajectory_and_guards():
    """implicit_step trajectories agree stencil vs edge-list (same CG,
    same states to tolerance); stale/invalid stencils fail loudly."""
    import dataclasses
    import pytest
    from zpc_tpu.sim.cloth import build_grid_stencil
    sim, x0 = make_cloth_grid(7, 7, 0.05, height=0.05, dhat=0.01,
                              kappa=100.0)
    sim0 = dataclasses.replace(sim, stencil=None)
    v0 = jnp.zeros_like(x0)
    xs, vs = x0, v0
    xe, ve = x0, v0
    for _ in range(5):
        xs, vs = implicit_step(sim, xs, vs, 0.005)
        xe, ve = implicit_step(sim0, xe, ve, 0.005)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xe),
                               rtol=1e-4, atol=1e-6)
    # stale stencil (wrong vertex count) raises, not corrupts
    bad = dataclasses.replace(
        sim0, mass=jnp.concatenate([sim.mass, sim.mass]),
        stencil=sim.stencil)
    with pytest.raises(ValueError, match="stale"):
        cloth_energy(bad, jnp.concatenate([x0, x0]))
    # non-grid topology: build_grid_stencil refuses
    with pytest.raises(ValueError):
        build_grid_stencil(sim, ((0, 7, 7), (49, 1, 1)))


def _two_layer_sten(nx, spacing, gap, dhat, **kw):
    """Two-layer bench topology WITH the grid stencil attached (the
    form the window-stencil contact path requires)."""
    from zpc_tpu.sim.cloth import build_grid_stencil, build_incidence
    sim, x0 = _two_layer(nx, nx, spacing, gap, dhat, **kw)
    N = nx * nx
    sim = build_grid_stencil(build_incidence(sim),
                             ((0, nx, nx), (N, nx, nx)))
    return sim, x0


def test_window_contact_matches_candidate_set():
    """ContactWindow completeness contract: window + residue == the
    LBVH gathered path for the barrier energy, the assembled operator
    apply, and its exact diagonal (in-window non-candidates are farther
    than dhat and contribute exactly 0)."""
    from zpc_tpu.sim.cloth import (ContactWindow, _pair_contact_energy,
                                   apply_operator, assemble_operator,
                                   classify_window_residue,
                                   self_contact_candidates,
                                   self_contact_energy,
                                   window_contact_energy)
    sim, x0 = _two_layer_sten(8, 0.05, 0.006, 0.008, k_stretch=2e2,
                              k_bend=1e-4, mass=0.01)
    rng = np.random.default_rng(11)
    y = x0 + jnp.asarray(0.002 * rng.normal(size=x0.shape),
                         jnp.float32)
    cand, ovf = jax.jit(
        lambda z: self_contact_candidates(sim, z, 8))(y)
    assert not bool(ovf)
    cw = ContactWindow(radius=1, max_residue=64)
    vid, tidx, valid, rovf = jax.jit(
        lambda c: classify_window_residue(sim, cw, c))(cand)
    assert not bool(rovf)
    e_dense = float(self_contact_energy(sim, y, cand))
    assert e_dense > 0  # the state must actually exercise contact
    e_win = float(window_contact_energy(sim, cw, y)
                  + _pair_contact_energy(sim, y, vid, tidx, valid))
    np.testing.assert_allclose(e_win, e_dense, rtol=1e-5)

    dt = 0.005
    dense = jax.jit(lambda z: assemble_operator(
        sim, z, x0, dt, cand=cand))(y)
    win = jax.jit(lambda z: assemble_operator(
        sim, z, x0, dt, window=cw,
        window_res=(vid, tidx, valid)))(y)
    scale_d = float(jnp.max(jnp.abs(dense["diag"])))
    np.testing.assert_allclose(np.asarray(win["diag"]),
                               np.asarray(dense["diag"]),
                               rtol=1e-5, atol=1e-6 * scale_d)
    for k in range(4):
        p = jnp.asarray(rng.normal(size=x0.shape).astype(np.float32))
        qd = jax.jit(lambda q: apply_operator(sim, dense, q, dt))(p)
        qw = jax.jit(lambda q: apply_operator(sim, win, q, dt))(p)
        scale = float(jnp.max(jnp.abs(qd)))
        np.testing.assert_allclose(np.asarray(qw), np.asarray(qd),
                                   rtol=1e-5, atol=2e-6 * scale)


def test_window_trajectory_matches_dense():
    """implicit_step(contact_window=...) reproduces the dense gathered
    trajectory through settle + rest (same CCD limits, same CG), with
    no overflow."""
    from zpc_tpu.sim.cloth import ContactWindow
    sim, x0 = _two_layer_sten(6, 0.05, 0.012, 0.008, k_stretch=2e2,
                              k_bend=1e-4, mass=0.01)
    cw = ContactWindow(radius=1, max_residue=64)
    dt = jnp.float32(0.005)
    step_d = jax.jit(lambda c: implicit_step(
        sim, c[0], c[1], dt, newton_iters=2, cg_iters=12,
        self_contact=True))
    step_w = jax.jit(lambda c: implicit_step(
        sim, c[0], c[1], dt, newton_iters=2, cg_iters=12,
        self_contact=True, contact_window=cw))
    xd = xw = x0
    vd = vw = jnp.zeros_like(x0)
    for _ in range(12):
        xd, vd, _ = step_d((xd, vd))
        xw, vw, ovf = step_w((xw, vw))
        assert not bool(ovf)
    assert np.isfinite(np.asarray(xw)).all()
    np.testing.assert_allclose(np.asarray(xw), np.asarray(xd),
                               rtol=3e-4, atol=5e-6)
    # B rests on A, no interpenetration (same invariant as the dense
    # two-layer test)
    N = 36
    inner = np.asarray([N + i * 6 + j for i in range(5)
                        for j in range(5)])
    assert np.asarray(xw)[inner, 1].min() > 0.2 - 1e-4


def test_window_residue_overflow_contract():
    """A radius-0 window pushes (nearly) all candidates into the
    residue; with a tiny budget the overflow flag must fire, with an
    ample one the split stays exact."""
    from zpc_tpu.sim.cloth import (ContactWindow, _pair_contact_energy,
                                   classify_window_residue,
                                   self_contact_candidates,
                                   self_contact_energy,
                                   window_contact_energy)
    sim, x0 = _two_layer_sten(6, 0.05, 0.006, 0.008, k_stretch=2e2,
                              k_bend=1e-4, mass=0.01)
    cand, _ = self_contact_candidates(sim, x0, 8)
    n_cand = int(jnp.sum((cand >= 0).astype(jnp.int32)))
    assert n_cand > 4
    tiny = ContactWindow(radius=0, max_residue=2)
    *_, ovf = classify_window_residue(sim, tiny, cand)
    assert bool(ovf)
    ample = ContactWindow(radius=0, max_residue=n_cand + 8)
    vid, tidx, valid, ovf = classify_window_residue(sim, ample, cand)
    assert not bool(ovf)
    e_dense = float(self_contact_energy(sim, x0, cand))
    e_split = float(window_contact_energy(sim, ample, x0)
                    + _pair_contact_energy(sim, x0, vid, tidx, valid))
    np.testing.assert_allclose(e_split, e_dense, rtol=1e-5)


def test_self_contact_candidates_complete_decomposed():
    """Broad phase at DECOMPOSED scale (M > 512 routes through the
    cells=8 banded join — round 5): completeness oracle on a 24x24
    two-layer sheet, which is exactly the adversarial flat-slab
    geometry where the plain band certified nothing (in-band 0.0000)."""
    from zpc_tpu.geometry.distance import point_triangle_closest
    from zpc_tpu.sim.cloth import self_contact_candidates
    dhat = 0.02
    sim, x0 = _two_layer(24, 24, 0.05, 0.015, dhat, k_stretch=2e2,
                         k_bend=1e-4, mass=0.01)
    assert int(sim.tris.shape[0]) > 512     # decomposed path engaged
    mc = 24
    cand, ovf = jax.jit(
        lambda x: self_contact_candidates(sim, x, mc))(x0)
    assert not bool(ovf)
    cand = np.asarray(cand)
    # vectorized brute oracle: [N, M] vertex-triangle distances
    tv = x0[sim.tris]
    _, cl = point_triangle_closest(
        x0[:, None, :], tv[None, :, 0], tv[None, :, 1], tv[None, :, 2])
    d = np.linalg.norm(np.asarray(cl) - np.asarray(x0)[:, None], axis=-1)
    tris = np.asarray(sim.tris)
    vs, ts = np.nonzero(d < dhat * 0.999)
    n_pairs = 0
    for vtx, t in zip(vs, ts):
        if vtx in tris[t]:
            continue
        assert t in cand[vtx], (vtx, t, d[vtx, t])
        n_pairs += 1
    assert n_pairs > 100        # the oracle actually exercised pairs
