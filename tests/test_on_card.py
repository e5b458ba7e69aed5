"""Card-only checks (``@pytest.mark.chip``): they skip unless JAX's first
device is a GPU.  Run on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.chip


def test_transfer_precision_is_full_float32(gpu):
    """The binned transfers' einsum precision keeps float32 products:
    TF32 (10 mantissa bits) would put ~1e-3 relative error here."""
    from zpc_tpu.sim.mpm_binned2 import _PREC
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128, 36)).astype(np.float32)
    b = rng.standard_normal((64, 128, 24)).astype(np.float32)
    got = np.asarray(jnp.einsum("bkm,bkA->bmA", a, b, precision=_PREC,
                                preferred_element_type=jnp.float32))
    want = np.einsum("bkm,bkA->bmA", a.astype(np.float64),
                     b.astype(np.float64))
    scale = np.einsum("bkm,bkA->bmA", np.abs(a).astype(np.float64),
                      np.abs(b).astype(np.float64))
    assert np.max(np.abs(got - want) / scale) < 1e-6


def test_binned2_matches_reference_on_card(gpu):
    """binned2 rollout vs the plain reference (full-precision products)
    at the oracle tolerances of tests/test_mpm_binned2.py."""
    from zpc_tpu.models.constitutive import FixedCorotated
    from zpc_tpu.sim.mpm import MPMSim, explicit_step, make_mpm_state
    from zpc_tpu.sim.mpm_binned2 import BinnedConfig2, rollout_binned2
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(0.3, 0.7, (8192, 3)), jnp.float32)
    st = make_mpm_state(x, dx=0.02, block_capacity=2048)
    sim = MPMSim(model=FixedCorotated.from_young_poisson(1e4, 0.3),
                 gravity=jnp.asarray([0.0, -9.8, 0.0]))
    dt = jnp.float32(1e-4)
    steps = 10
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda s: jax.lax.fori_loop(
            0, steps, lambda i, t: explicit_step(sim, t, dt), s))(st)
    out, overflow = jax.jit(lambda s: rollout_binned2(
        sim, s, dt, BinnedConfig2(bins_capacity=512), steps))(st)
    assert not bool(overflow)
    for key, tol in (("x", 1e-5), ("v", 2e-4), ("F", 1e-5)):
        np.testing.assert_allclose(np.asarray(out.particles[key]),
                                   np.asarray(ref.particles[key]), atol=tol)
