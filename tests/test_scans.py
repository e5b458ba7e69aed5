"""Large 1-D scans through the public primitives vs numpy oracles.

Sizes straddle multiples of 131072 (ragged tails included), the range
where XLA's cumulative reductions switch to blocked forms; the scans are
plain XLA on every backend (reference ``zs::inclusive_scan`` /
``exclusive_scan``, ExecutionPolicy.hpp:247-266)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zpc_tpu import exclusive_scan, inclusive_scan, jit_exec

BLOCK = 131072


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("n", [BLOCK, BLOCK + 777, 3 * BLOCK])
def test_inclusive_matches_numpy(dtype, n):
    rng = np.random.default_rng(42)
    if dtype == np.float32:
        x = rng.standard_normal(n).astype(np.float32)
    else:
        x = rng.integers(0, 1000, n).astype(dtype)
    out = np.asarray(inclusive_scan(jit_exec(), jnp.asarray(x)))
    if dtype == np.float32:
        ref = np.cumsum(x.astype(np.float64))
        # summation order differs from the sequential float64 reference
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-3)
    else:
        ref = np.cumsum(x.astype(np.int64))
        assert np.array_equal(out.astype(np.int64), ref)


def test_exclusive_int_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, 2 * BLOCK + 13).astype(np.int32)
    out = np.asarray(exclusive_scan(jit_exec(), jnp.asarray(x)))
    ref = np.cumsum(x.astype(np.int64)) - x
    assert np.array_equal(out.astype(np.int64), ref)


@pytest.mark.parametrize("op,npop", [("max", np.maximum),
                                     ("min", np.minimum)])
def test_max_min_scan(op, npop):
    rng = np.random.default_rng(3)
    x = rng.integers(-10000, 10000, BLOCK + 513).astype(np.int32)
    out = np.asarray(inclusive_scan(jit_exec(), jnp.asarray(x), op))
    np.testing.assert_array_equal(out, npop.accumulate(x))


def test_max_scan_float():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(2 * BLOCK).astype(np.float32)
    out = np.asarray(inclusive_scan(jit_exec(), jnp.asarray(x), "max"))
    np.testing.assert_array_equal(out, np.maximum.accumulate(x))


def test_no_kernel_in_any_scan():
    """Every scan form lowers to plain XLA: no Pallas call in the jaxpr
    at sizes where a kernel used to be routed."""
    x = jnp.zeros((3 * BLOCK,), jnp.float32)
    pol = jit_exec()
    for op in ("add", "max", "min"):
        for fn in (inclusive_scan, exclusive_scan):
            jaxpr = str(jax.make_jaxpr(lambda a: fn(pol, a, op))(x))
            assert "pallas_call" not in jaxpr, (fn.__name__, op)
