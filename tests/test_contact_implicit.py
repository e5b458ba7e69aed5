"""Config-5 assembly tests: LBVH broad phase -> barrier derivatives ->
implicit grid solve (oracle: finite-difference force check, penetration
invariants vs the contact-free solve)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zpc_tpu.models.constitutive import FixedCorotated
from zpc_tpu.sim.mpm import MPMSim, make_mpm_state
from zpc_tpu.sim.mpm_binned2 import BinnedConfig2, bin_state, K, _make_ctx3
from zpc_tpu.sim.contact_implicit import MeshContact
from zpc_tpu.sim.implicit_binned2 import (implicit_rollout_binned2,
                                          implicit_step_binned2)


def _floor_mesh(y=0.2, lo=-1.0, hi=2.0):
    """Two triangles spanning the y=const plane square [lo,hi]^2."""
    a = [lo, y, lo]
    b = [hi, y, lo]
    c = [hi, y, hi]
    d = [lo, y, hi]
    return jnp.asarray([[a, b, c], [a, c, d]], jnp.float32)


def _setup(rng, n=512, ylo=0.3, yhi=0.5):
    x = np.stack([rng.uniform(0.3, 0.7, n),
                  rng.uniform(ylo, yhi, n),
                  rng.uniform(0.3, 0.7, n)], -1)
    st = make_mpm_state(jnp.asarray(x, jnp.float32), dx=0.05,
                        block_capacity=512)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(1e4, 0.3),
                 gravity=jnp.asarray([0.0, -9.8, 0.0]))
    return sim, st


class TestBroadPhase:
    def test_finds_near_triangles_only(self, rng):
        sim, st = _setup(rng)
        cfg = BinnedConfig2(bins_capacity=64)
        bst = bin_state(sim, st, cfg)
        ctx = _make_ctx3(bst, cfg)
        lane_alive = (bst.pid >= 0).reshape(cfg.bins_capacity, K)
        near = MeshContact.build(_floor_mesh(y=0.3), dhat=0.02, kappa=1.0)
        far = MeshContact.build(_floor_mesh(y=-5.0), dhat=0.02, kappa=1.0)
        cs_near = near.broad_phase(ctx, lane_alive)
        cs_far = far.broad_phase(ctx, lane_alive)
        assert not bool(cs_near.overflow)
        assert int(jnp.sum(cs_near.hits >= 0)) > 0
        assert int(jnp.sum(cs_far.hits >= 0)) == 0

    def test_force_matches_energy_gradient(self, rng):
        sim, st = _setup(rng, n=256, ylo=0.21, yhi=0.25)
        cfg = BinnedConfig2(bins_capacity=64)
        bst = bin_state(sim, st, cfg)
        ctx = _make_ctx3(bst, cfg)
        B = cfg.bins_capacity
        lane_alive = (bst.pid >= 0).reshape(B, K)
        mc = MeshContact.build(_floor_mesh(y=0.2), dhat=0.05, kappa=1e-3)
        xb = bst.cols.reshape(B, K, -1)[..., 0:3]
        cset = mc.broad_phase(ctx, lane_alive)
        fc, Hc = mc.forces_and_hessians(cset, xb, lane_alive)
        # autodiff oracle: fc == -dE/dx exactly (same active set)
        g = jax.grad(lambda x: mc.energy(cset, x, lane_alive))(xb)
        np.testing.assert_allclose(np.asarray(fc), -np.asarray(g),
                                   rtol=1e-4, atol=1e-8)
        # GN Hessian is PSD by construction: check symmetric + nonneg diag
        H = np.asarray(Hc)
        np.testing.assert_allclose(H, np.swapaxes(H, -1, -2), atol=1e-6)
        assert (np.einsum("...ii->...", H) >= -1e-7).all()

    def test_toi_blocks_tunneling(self, rng):
        mc = MeshContact.build(_floor_mesh(y=0.0), dhat=0.01, kappa=1.0)
        # synthetic: one bin, one lane heading straight through the floor
        xb = jnp.asarray([[[0.5, 0.05, 0.5]] * K], jnp.float32)
        dxb = jnp.asarray([[[0.0, -0.2, 0.0]] * K], jnp.float32)
        lane_alive = jnp.ones((1, K), bool)
        from zpc_tpu.sim.contact_implicit import ContactSet
        cset = ContactSet(hits=jnp.asarray([[0, 1]], jnp.int32),
                          overflow=jnp.bool_(False))
        alpha = mc.toi(cset, xb, dxb, lane_alive)
        a = np.asarray(alpha)
        assert (a < 1.0).all() and (a > 0.0).all()
        # end point stays above the floor by ~min_sep
        yend = 0.05 - 0.2 * a
        assert (yend > 0).all()


class TestContactCoupledSolve:
    def test_no_penetration_vs_free_fall(self, rng):
        sim, st = _setup(rng, n=512, ylo=0.26, yhi=0.4)
        cfg = BinnedConfig2(bins_capacity=96)
        floor_y = 0.2
        mc = MeshContact.build(_floor_mesh(y=floor_y), dhat=0.03,
                               kappa=2e-2, max_tris=4)
        dt = jnp.float32(2e-3)
        steps = 12
        free, ovf = jax.jit(lambda s: implicit_rollout_binned2(
            sim, s, dt, cfg, steps, cg_iters=40))(st)
        withc, ovc = jax.jit(lambda s: implicit_rollout_binned2(
            sim, s, dt, cfg, steps, cg_iters=40, contact=mc))(st)
        assert not bool(ovf) and not bool(ovc)
        y_free = np.asarray(free.particles["x"])[:, 1]
        y_c = np.asarray(withc.particles["x"])[:, 1]
        assert np.isfinite(y_c).all()
        # free fall dips toward/through the barrier band; contact holds
        # every particle above the floor
        assert y_c.min() > floor_y
        assert y_c.min() > y_free.min() - 1e-6

    def test_sustained_load_no_penetration_100_steps(self, rng):
        """VERDICT r3 item 5: the outcome invariant a downstream user
        notices breaking — under sustained gravity load onto the mesh,
        no particle EVER crosses the mesh by more than dhat across a
        100-step implicit rollout (checked every 10 steps, including
        the impact transient, not just the settled end state)."""
        sim, st = _setup(rng, n=512, ylo=0.22, yhi=0.42)
        cfg = BinnedConfig2(bins_capacity=96)
        floor_y, dhat = 0.2, 0.02
        # the d^2 barrier is sign-blind once a point crosses, so IPC's
        # non-penetration guarantee is barrier + CCD advection clamp
        # (use_ccd) — this test runs the full mechanism.  kappa is sized
        # from physics: barrier force ~ 7.7e-5 * kappa at gap dhat/4 vs
        # ~1.2 N column weight -> kappa ~ 2e4 for support INSIDE the
        # dhat shell (a too-weak kappa leaves CCD holding a falling
        # pile, which is exactly the failure this test must catch)
        mc = MeshContact.build(_floor_mesh(y=floor_y), dhat=dhat,
                               kappa=2e4, max_tris=4, use_ccd=True)
        dt = jnp.float32(2e-3)
        roll = jax.jit(lambda s: implicit_rollout_binned2(
            sim, s, dt, cfg, 10, cg_iters=30, contact=mc))
        cur = st
        min_y = np.inf
        for _ in range(10):                      # 100 steps total
            cur, ov = roll(cur)
            assert not bool(ov)
            y = np.asarray(cur.particles["x"])[:, 1]
            assert np.isfinite(y).all()
            min_y = min(min_y, float(y.min()))
        assert min_y > floor_y - dhat, min_y
        # settled: the pile is at rest on the barrier, not bouncing
        vy = np.asarray(cur.particles["v"])[:, 1]
        assert abs(float(vy.mean())) < 0.5

    def test_single_step_forces_point_up(self, rng):
        sim, st = _setup(rng, n=256, ylo=0.205, yhi=0.23)
        cfg = BinnedConfig2(bins_capacity=64)
        mc = MeshContact.build(_floor_mesh(y=0.2), dhat=0.03, kappa=2e-2,
                               max_tris=4)
        dt = jnp.float32(1e-3)
        out_c, ov = implicit_step_binned2(sim, st, dt, cfg, cg_iters=50,
                                          contact=mc)
        out_f, _ = implicit_step_binned2(sim, st, dt, cfg, cg_iters=50)
        assert not bool(ov)
        # barrier decelerates the fall: contact-coupled vertical velocity
        # exceeds (is less negative than) the free solve's
        vy_c = np.asarray(out_c.particles["v"])[:, 1].mean()
        vy_f = np.asarray(out_f.particles["v"])[:, 1].mean()
        assert vy_c > vy_f


def test_contact_precond_variant_converges(rng):
    """The barrier-diag Jacobi variant (round-4 study: a documented
    NEGATIVE result at stiff kappa) must still compile
    and converge; it is kept as evidence, not as the default."""
    x = np.stack([rng.uniform(0.3, 0.7, 512),
                  rng.uniform(0.21, 0.3, 512),
                  rng.uniform(0.3, 0.7, 512)], -1)
    st = make_mpm_state(jnp.asarray(x, jnp.float32), dx=0.05,
                        block_capacity=512)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(1e4, 0.3),
                 gravity=jnp.asarray([0.0, -9.8, 0.0]))
    cfg = BinnedConfig2(bins_capacity=96)
    mc = MeshContact.build(_floor_mesh(), dhat=0.02, kappa=5e-2,
                           max_tris=4)
    bst = bin_state(sim, st, cfg)
    out, it = implicit_step_binned2(
        sim, bst, jnp.float32(2e-3), cfg, cg_iters=40, contact=mc,
        rebin=False, with_stats=True, contact_precond=True)
    assert int(it) <= 40
    assert bool(jnp.isfinite(out.cols).all())
