"""Oracle tests for parallel primitives (reference test strategy, SURVEY §4:
run under the policy under test, compare to a serial recomputation — exact
for ints, 1e-6 relative for floats)."""

import numpy as np
import jax.numpy as jnp
import pytest

import zpc_tpu as z
from zpc_tpu.parallel import primitives as P

POLICIES = [z.jit_exec(), z.seq_exec()]
POL_IDS = ["jit", "seq"]


@pytest.fixture(params=POLICIES, ids=POL_IDS)
def pol(request):
    return request.param


def _rnd_ints(rng, n, lo=-1000, hi=1000):
    return rng.integers(lo, hi, size=n).astype(np.int32)


def _rnd_floats(rng, n):
    return rng.standard_normal(n).astype(np.float32)


class TestReduce:
    def test_sum_int(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        got = P.reduce(pol, jnp.asarray(a), jnp.add)
        assert int(got) == int(a.sum())

    def test_min_max(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        assert int(P.reduce(pol, jnp.asarray(a), jnp.minimum)) == a.min()
        assert int(P.reduce(pol, jnp.asarray(a), jnp.maximum)) == a.max()

    def test_sum_float(self, pol, oracle_size, rng):
        a = _rnd_floats(rng, oracle_size)
        got = float(P.reduce(pol, jnp.asarray(a), "sum"))
        np.testing.assert_allclose(got, a.sum(), rtol=1e-5, atol=1e-5)


class TestScan:
    def test_inclusive(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        got = np.asarray(P.inclusive_scan(pol, jnp.asarray(a)))
        np.testing.assert_array_equal(got, np.cumsum(a))

    def test_exclusive(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        got = np.asarray(P.exclusive_scan(pol, jnp.asarray(a)))
        ref = np.concatenate([[0], np.cumsum(a)[:-1]])
        np.testing.assert_array_equal(got, ref)

    def test_inclusive_max(self, pol, rng):
        a = _rnd_ints(rng, 1024)
        got = np.asarray(P.inclusive_scan(pol, jnp.asarray(a), jnp.maximum))
        np.testing.assert_array_equal(got, np.maximum.accumulate(a))


class TestSort:
    def test_sort(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        got = np.asarray(P.sort(pol, jnp.asarray(a)))
        np.testing.assert_array_equal(got, np.sort(a))

    def test_sort_pair(self, pol, oracle_size, rng):
        k = _rnd_ints(rng, oracle_size, 0, 50)
        v = np.arange(oracle_size, dtype=np.int32)
        ko, vo = P.sort_pair(pol, jnp.asarray(k), jnp.asarray(v))
        ko, vo = np.asarray(ko), np.asarray(vo)
        np.testing.assert_array_equal(ko, np.sort(k))
        np.testing.assert_array_equal(k[vo], ko)  # consistent permutation

    def test_merge_sort_pair_stable(self, pol, rng):
        k = _rnd_ints(rng, 4096, 0, 10)
        v = np.arange(4096, dtype=np.int32)
        ko, vo = P.merge_sort_pair(pol, jnp.asarray(k), jnp.asarray(v))
        perm = np.argsort(k, kind="stable")
        np.testing.assert_array_equal(np.asarray(vo), v[perm])

    def test_radix_sort_full(self, pol, oracle_size, rng):
        a = _rnd_ints(rng, oracle_size)
        got = np.asarray(P.radix_sort(pol, jnp.asarray(a)))
        np.testing.assert_array_equal(got, np.sort(a))

    def test_radix_sort_bit_window(self, pol, rng):
        # sort only on bits [4, 12): orders by those bits, stable otherwise
        a = rng.integers(0, 1 << 16, size=2048).astype(np.int32)
        got = np.asarray(P.radix_sort(pol, jnp.asarray(a), sbit=4, ebit=12))
        window = (a >> 4) & 0xFF
        perm = np.argsort(window, kind="stable")
        np.testing.assert_array_equal(got, a[perm])

    def test_radix_sort_pair_bit_window(self, pol, rng):
        k = rng.integers(0, 1 << 20, size=1024).astype(np.int32)
        v = np.arange(1024, dtype=np.int32)
        ko, vo = P.radix_sort_pair(pol, jnp.asarray(k), jnp.asarray(v),
                                   sbit=8, ebit=20)
        perm = np.argsort((k >> 8) & 0xFFF, kind="stable")
        np.testing.assert_array_equal(np.asarray(ko), k[perm])
        np.testing.assert_array_equal(np.asarray(vo), v[perm])

    def test_radix_sort_pair_wide_window_stable(self, pol, rng):
        # window + rank wider than 31 bits -> the stable 3-op fallback
        k = rng.integers(0, 1 << 30, size=4096).astype(np.int32)
        v = np.arange(4096, dtype=np.int32)
        ko, vo = P.radix_sort_pair(pol, jnp.asarray(k), jnp.asarray(v),
                                   sbit=0, ebit=30)
        perm = np.argsort(k & ((1 << 30) - 1), kind="stable")
        np.testing.assert_array_equal(np.asarray(ko), k[perm])
        np.testing.assert_array_equal(np.asarray(vo), v[perm])

    def test_sort_pair_packed_bounds(self, pol, rng):
        # static bound hints trigger the packed 1-op fast path
        k = rng.integers(0, 700, size=3000).astype(np.int32)
        v = np.arange(3000, dtype=np.int32)
        ko, vo = P.sort_pair(pol, jnp.asarray(k), jnp.asarray(v),
                             key_bound=700, val_bound=3000)
        perm = np.argsort(k, kind="stable")  # ties order by val = rank
        np.testing.assert_array_equal(np.asarray(ko), k[perm])
        np.testing.assert_array_equal(np.asarray(vo), v[perm])

    def test_radix_sort_pair_ranks_fast_path(self, pol, rng):
        k = rng.integers(0, 1 << 18, size=2048).astype(np.int32)
        v = np.arange(2048, dtype=np.int32)
        ko, vo = P.radix_sort_pair(pol, jnp.asarray(k), jnp.asarray(v),
                                   sbit=4, ebit=16, vals_are_ranks=True)
        perm = np.argsort((k >> 4) & 0xFFF, kind="stable")
        np.testing.assert_array_equal(np.asarray(ko), k[perm])
        np.testing.assert_array_equal(np.asarray(vo), v[perm])

    def test_argsort_stable_bounded(self, pol, rng):
        k = rng.integers(0, 5000, size=4096).astype(np.int32)
        got = np.asarray(P.argsort_stable(pol, jnp.asarray(k),
                                          key_bound=5000))
        np.testing.assert_array_equal(got, np.argsort(k, kind="stable"))


class TestHistogramSegment:
    def test_histogram_small_bins(self, pol, rng):
        idx = rng.integers(0, 37, size=10000).astype(np.int32)
        got = np.asarray(P.histogram(pol, jnp.asarray(idx), 37))
        np.testing.assert_array_equal(got, np.bincount(idx, minlength=37))

    def test_histogram_large_bins(self, pol, rng):
        idx = rng.integers(0, 5000, size=20000).astype(np.int32)
        got = np.asarray(P.histogram(pol, jnp.asarray(idx), 5000))
        np.testing.assert_array_equal(got, np.bincount(idx, minlength=5000))

    def test_histogram_weighted(self, pol, rng):
        idx = rng.integers(0, 16, size=512).astype(np.int32)
        w = _rnd_floats(rng, 512)
        got = np.asarray(P.histogram(pol, jnp.asarray(idx), 16,
                                     jnp.asarray(w)))
        ref = np.zeros(16, np.float32)
        np.add.at(ref, idx, w)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_segment_sum(self, pol, rng):
        sid = np.sort(rng.integers(0, 100, size=5000)).astype(np.int32)
        d = _rnd_floats(rng, 5000)
        got = np.asarray(P.segment_reduce(pol, jnp.asarray(d),
                                          jnp.asarray(sid), 100,
                                          indices_are_sorted=True))
        ref = np.zeros(100, np.float32)
        np.add.at(ref, sid, d)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_segment_max(self, pol, rng):
        sid = rng.integers(0, 8, size=256).astype(np.int32)
        d = _rnd_ints(rng, 256)
        got = np.asarray(P.segment_reduce(pol, jnp.asarray(d),
                                          jnp.asarray(sid), 8, jnp.maximum))
        for s in range(8):
            if (sid == s).any():
                assert got[s] == d[sid == s].max()


class TestCompaction:
    def test_count_select(self, pol, rng):
        d = _rnd_ints(rng, 1000)
        m = d > 0
        cnt = int(P.count_if(pol, jnp.asarray(m)))
        assert cnt == int(m.sum())
        packed, n = P.select_if(pol, jnp.asarray(d), jnp.asarray(m))
        assert int(n) == cnt
        np.testing.assert_array_equal(np.asarray(packed)[:cnt], d[m])

    def test_unique(self, pol, rng):
        d = np.sort(rng.integers(0, 50, size=1000)).astype(np.int32)
        uniq, cnt, inv = P.unique(pol, jnp.asarray(d))
        ref_u, ref_inv = np.unique(d, return_inverse=True)
        assert int(cnt) == len(ref_u)
        np.testing.assert_array_equal(np.asarray(uniq)[:len(ref_u)], ref_u)
        np.testing.assert_array_equal(np.asarray(inv), ref_inv)


class TestMonoid:
    def test_identities(self):
        assert P.monoid_identity(jnp.add, np.float32) == 0
        assert P.monoid_identity(jnp.multiply, np.int32) == 1
        assert P.monoid_identity(jnp.minimum, np.float32) == np.inf
        assert P.monoid_identity(jnp.maximum, np.int32) == np.iinfo(np.int32).min
