"""Cooperative lane-op oracles (ops/lanes.py vs per-element numpy), in
plain JAX and inside interpret-mode Pallas kernels (the reference's warp
layer: execution/Intrinsics.hpp:102-165)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zpc_tpu.ops.lanes import (ballot, lane_all, lane_any, lane_scan,
                               lane_sum, popcount, segment_scan, shfl_down,
                               shfl_up, shfl_xor)


def _np_shfl(x, src_of, width):
    """Oracle: out[..., i] = x[..., src] per window, -1 src = fill 0."""
    L = x.shape[-1]
    out = np.zeros_like(x)
    for i in range(L):
        w0 = (i // width) * width
        s = src_of(i - w0)
        if 0 <= s < width:
            out[..., i] = x[..., w0 + s]
    return out


class TestShuffles:
    @pytest.mark.parametrize("width,delta", [(32, 1), (32, 5), (128, 17),
                                             (8, 3)])
    def test_shfl_up_down(self, rng, width, delta):
        x = rng.standard_normal((4, 128)).astype(np.float32)
        up = np.asarray(shfl_up(jnp.asarray(x), delta, width=width))
        np.testing.assert_array_equal(
            up, _np_shfl(x, lambda i: i - delta, width))
        dn = np.asarray(shfl_down(jnp.asarray(x), delta, width=width))
        np.testing.assert_array_equal(
            dn, _np_shfl(x, lambda i: i + delta, width))

    @pytest.mark.parametrize("width,mask", [(32, 1), (32, 16), (32, 21),
                                            (128, 127), (16, 5)])
    def test_shfl_xor(self, rng, width, mask):
        x = rng.standard_normal((3, 128)).astype(np.float32)
        got = np.asarray(shfl_xor(jnp.asarray(x), mask, width=width))
        np.testing.assert_array_equal(
            got, _np_shfl(x, lambda i: i ^ mask, width))

    def test_axis_argument(self, rng):
        x = rng.standard_normal((64, 5)).astype(np.float32)
        got = np.asarray(shfl_up(jnp.asarray(x), 2, width=32, axis=0))
        want = np.asarray(shfl_up(jnp.asarray(x.T), 2, width=32)).T
        np.testing.assert_array_equal(got, want)


class TestBallotReduce:
    def test_ballot_and_popcount(self, rng):
        p = rng.uniform(size=(2, 128)) < 0.4
        words = np.asarray(ballot(jnp.asarray(p), width=32))
        assert words.dtype == np.uint32
        assert words.shape == (2, 4)
        for r in range(2):
            for w in range(4):
                want = sum(int(p[r, w * 32 + k]) << k for k in range(32))
                assert int(words[r, w]) == want
        np.testing.assert_array_equal(
            np.asarray(popcount(jnp.asarray(words))),
            p.reshape(2, 4, 32).sum(-1))

    def test_any_all_sum(self, rng):
        x = rng.standard_normal((128,)).astype(np.float32)
        p = x > 0.5
        got_any = np.asarray(lane_any(jnp.asarray(p), width=32))
        got_all = np.asarray(lane_all(jnp.asarray(p), width=32))
        got_sum = np.asarray(lane_sum(jnp.asarray(x), width=32))
        for w in range(4):
            sl = slice(w * 32, (w + 1) * 32)
            assert got_any[sl].all() == p[sl].any()
            assert got_all[sl].all() == p[sl].all()
            np.testing.assert_allclose(got_sum[sl], x[sl].sum(),
                                       rtol=1e-5)


class TestScans:
    @pytest.mark.parametrize("width", [8, 32, 128])
    @pytest.mark.parametrize("exclusive", [False, True])
    def test_lane_scan(self, rng, width, exclusive):
        x = rng.integers(-5, 5, (3, 128)).astype(np.int32)
        got = np.asarray(lane_scan(jnp.asarray(x), width=width,
                                   exclusive=exclusive))
        want = np.zeros_like(x)
        for w0 in range(0, 128, width):
            c = np.cumsum(x[:, w0:w0 + width], axis=1)
            if exclusive:
                c = np.concatenate([np.zeros((3, 1), x.dtype),
                                    c[:, :-1]], axis=1)
            want[:, w0:w0 + width] = c
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("width", [32, 128])
    def test_segment_scan(self, rng, width):
        x = rng.integers(-5, 5, (128,)).astype(np.int32)
        f = rng.uniform(size=(128,)) < 0.2
        got = np.asarray(segment_scan(jnp.asarray(x), jnp.asarray(f),
                                      width=width))
        want = np.zeros_like(x)
        for w0 in range(0, 128, width):
            run = 0
            for i in range(w0, w0 + width):
                run = x[i] if (f[i] or i == w0) else run + x[i]
                want[i] = run
        np.testing.assert_array_equal(got, want)


class TestInsidePallas:
    """The point of the module: the same ops compile inside a Pallas
    kernel body (interpret mode here)."""

    def _run_kernel(self, fn, x, out_dtype=None):
        from jax.experimental import pallas as pl
        out_dtype = out_dtype or x.dtype

        def kernel(x_ref, o_ref):
            o_ref[...] = fn(x_ref[...])

        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, out_dtype),
            interpret=True)(x)

    def test_shfl_and_scan_in_kernel(self, rng):
        x = jnp.asarray(rng.standard_normal((8, 128)), jnp.float32)
        got = self._run_kernel(lambda v: shfl_xor(v, 7, width=32), x)
        np.testing.assert_array_equal(
            np.asarray(got),
            np.asarray(shfl_xor(x, 7, width=32)))
        got = self._run_kernel(lambda v: lane_scan(v, width=128), x)
        # in-kernel result must match the host lane_scan exactly (same
        # roll-add ladder); vs sequential cumsum only to reassociation
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(lane_scan(x, width=128)))
        np.testing.assert_allclose(np.asarray(got),
                                   np.cumsum(np.asarray(x), -1),
                                   rtol=1e-3, atol=1e-5)

    def test_segment_scan_in_kernel(self, rng):
        x = jnp.asarray(rng.integers(0, 9, (4, 128)), jnp.int32)
        f = x > 6

        def body(v):
            return segment_scan(v, v > 6, width=128)

        got = self._run_kernel(body, x)
        want = np.asarray(segment_scan(x, f, width=128))
        np.testing.assert_array_equal(np.asarray(got), want)
