"""LBVH oracle tests: brute-force overlap/nearest/ray comparisons
(reference test strategy; the reference itself ships no BVH tests)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zpc_tpu.containers.bvh import (build_lbvh, query_nearest,
                                    query_overlaps, query_ray)


def _random_boxes(rng, n, size=0.05):
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32) * size
    return c - h, c + h


class TestBuild:
    @pytest.mark.parametrize("n", [1, 2, 7, 64, 500])
    def test_topology_covers_all_leaves(self, rng, n):
        lo, hi = _random_boxes(rng, n)
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        # root box = union of all
        np.testing.assert_allclose(np.asarray(bvh.lo[0]), lo.min(0),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(bvh.hi[0]), hi.max(0),
                                   atol=1e-6)
        prim = np.asarray(bvh.leaf_prim)
        leaves = prim[prim >= 0]
        assert sorted(leaves.tolist()) == list(range(n))

    def test_escape_terminates(self, rng):
        lo, hi = _random_boxes(rng, 100)
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        esc = np.asarray(bvh.escape)
        left = np.asarray(bvh.left)
        # full preorder walk visits every node exactly once
        visited = 0
        node = 0
        while node >= 0 and visited <= 500:
            visited += 1
            node = left[node] if left[node] >= 0 else esc[node]
        assert visited == 2 * 100 - 1

    def test_duplicate_positions(self, rng):
        # all identical boxes: degenerate morton codes must still build
        lo = np.zeros((32, 3), np.float32)
        hi = np.ones((32, 3), np.float32) * 0.1
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        prim = np.asarray(bvh.leaf_prim)
        assert sorted(prim[prim >= 0].tolist()) == list(range(32))


class TestQueries:
    def test_overlaps_vs_bruteforce(self, rng):
        n, nq = 300, 64
        lo, hi = _random_boxes(rng, n)
        qlo, qhi = _random_boxes(rng, nq, size=0.1)
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        hits, cnt = jax.jit(lambda a, b: query_overlaps(bvh, a, b, 128))(
            jnp.asarray(qlo), jnp.asarray(qhi))
        hits, cnt = np.asarray(hits), np.asarray(cnt)
        for qi in range(nq):
            ref = set(np.nonzero(
                (lo <= qhi[qi]).all(1) & (qlo[qi] <= hi).all(1))[0].tolist())
            got = set(hits[qi][hits[qi] >= 0].tolist())
            assert got == ref, f"query {qi}"
            assert cnt[qi] == len(ref)

    def test_overlaps_with_invalid(self, rng):
        n = 100
        lo, hi = _random_boxes(rng, n)
        valid = np.arange(n) < 60
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi),
                         valid=jnp.asarray(valid))
        big_lo = jnp.asarray([[-1.0, -1, -1]], jnp.float32)
        big_hi = jnp.asarray([[2.0, 2, 2]], jnp.float32)
        hits, cnt = query_overlaps(bvh, big_lo, big_hi, 128)
        got = set(np.asarray(hits[0][hits[0] >= 0]).tolist())
        assert got == set(range(60))

    def test_nearest_point_boxes(self, rng):
        n = 200
        lo, hi = _random_boxes(rng, n)
        centers = 0.5 * (lo + hi)
        pts = rng.uniform(0, 1, (32, 3)).astype(np.float32)
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        cj = jnp.asarray(centers)

        def prim_dist(pid, p):
            return jnp.linalg.norm(cj[pid] - p)

        ids, dists = jax.jit(
            lambda p: query_nearest(bvh, p, prim_dist))(jnp.asarray(pts))
        ids, dists = np.asarray(ids), np.asarray(dists)
        ref_d = np.linalg.norm(centers[None] - pts[:, None], axis=-1)
        np.testing.assert_allclose(dists, ref_d.min(1), atol=1e-5)
        np.testing.assert_array_equal(ids, ref_d.argmin(1))

    def test_ray_vs_bruteforce_spheres(self, rng):
        n = 100
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        r = np.full(n, 0.03, np.float32)
        lo, hi = c - r[:, None], c + r[:, None]
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        cj, rj = jnp.asarray(c), jnp.asarray(r)

        def prim_hit(pid, o, d):
            oc = o - cj[pid]
            b = jnp.dot(oc, d)
            disc = b * b - (jnp.dot(oc, oc) - rj[pid] ** 2)
            t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
            return jnp.where((disc >= 0) & (t > 0), t, jnp.inf)

        o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (16, 1))
        d = rng.standard_normal((16, 3)).astype(np.float32)
        d[:, 2] = np.abs(d[:, 2]) + 0.5
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ids, ts = jax.jit(
            lambda o, d: query_ray(bvh, o, d, prim_hit))(
            jnp.asarray(o), jnp.asarray(d))
        # brute force
        for qi in range(16):
            oc = o[qi] - c
            b = (oc * d[qi]).sum(1)
            disc = b * b - ((oc * oc).sum(1) - r ** 2)
            t = -b - np.sqrt(np.maximum(disc, 0))
            t = np.where((disc >= 0) & (t > 0), t, np.inf)
            if np.isinf(t.min()):
                assert int(ids[qi]) == -1
            else:
                assert abs(float(ts[qi]) - t.min()) < 1e-5
                assert int(ids[qi]) == int(t.argmin())


class TestBvttFront:
    def test_rebuild_and_refresh(self, rng):
        from zpc_tpu.containers.bvh import BvttFront
        n, nq = 200, 40
        lo, hi = _random_boxes(rng, n)
        qlo, qhi = _random_boxes(rng, nq, size=0.08)
        bvh = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        front = BvttFront.rebuild(bvh, jnp.asarray(qlo), jnp.asarray(qhi),
                                  max_hits_per_query=64, capacity=4096)
        cnt = int(front.count)
        ref_pairs = set()
        for qi in range(nq):
            for pi in np.nonzero((lo <= qhi[qi]).all(1) &
                                 (qlo[qi] <= hi).all(1))[0]:
                ref_pairs.add((qi, int(pi)))
        got = set(zip(np.asarray(front.qid)[:cnt].tolist(),
                      np.asarray(front.pid)[:cnt].tolist()))
        assert got == ref_pairs
        # refresh against unchanged boxes: all pairs stay live
        live = front.refresh(jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(qlo), jnp.asarray(qhi))
        assert int(jnp.sum(live)) == cnt
        # move queries away: pairs die
        live2 = front.refresh(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(qlo + 10), jnp.asarray(qhi + 10))
        assert int(jnp.sum(live2)) == 0


class TestBvs:
    def test_query_vs_bruteforce(self, rng):
        from zpc_tpu.containers.bvs import build_bvs, bvs_query
        n, nq = 300, 50
        lo, hi = _random_boxes(rng, n)
        qlo, qhi = _random_boxes(rng, nq, size=0.1)
        bvs = build_bvs(jnp.asarray(lo), jnp.asarray(hi))
        ids, mask = jax.jit(
            lambda a, b: bvs_query(bvs, a, b, max_candidates=n))(
            jnp.asarray(qlo), jnp.asarray(qhi))
        ids, mask = np.asarray(ids), np.asarray(mask)
        for qi in range(nq):
            ref = set(np.nonzero((lo <= qhi[qi]).all(1) &
                                 (qlo[qi] <= hi).all(1))[0].tolist())
            got = set(ids[qi][mask[qi]].tolist())
            assert got == ref, qi

    def test_invalid_excluded(self, rng):
        from zpc_tpu.containers.bvs import build_bvs, bvs_query
        lo, hi = _random_boxes(rng, 100)
        valid = np.arange(100) < 70
        bvs = build_bvs(jnp.asarray(lo), jnp.asarray(hi),
                        valid=jnp.asarray(valid))
        ids, mask = bvs_query(bvs, jnp.asarray([[-1.0] * 3], jnp.float32),
                              jnp.asarray([[2.0] * 3], jnp.float32), 128)
        got = set(np.asarray(ids)[np.asarray(mask)].tolist())
        assert got == set(range(70))


class TestSortedBandedJoin:
    def _oracle_sets(self, bvh, qlo, qhi, max_hits):
        from zpc_tpu.containers.bvh import query_overlaps
        hits, cnt = query_overlaps(bvh, qlo, qhi, max_hits)
        return [set(int(h) for h in row if h >= 0) for row in
                np.asarray(hits)], np.asarray(cnt)

    def test_matches_rope_walk(self, rng):
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 1024
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.01, np.float32)
        lo = jnp.asarray(c - h)
        hi = jnp.asarray(c + h)
        bvh = build_lbvh(lo, hi)
        nq = 512
        qlo = lo[:nq] - 0.02
        qhi = hi[:nq] + 0.02
        max_hits = 32
        qid, hits, cnt, in_band = jax.jit(
            lambda *a: query_overlaps_sorted(*a, max_hits, tile=64)
        )(bvh, qlo, qhi)
        in_band = np.asarray(in_band)
        # most queries resolve in-band; out-of-band ones use the fallback
        assert in_band.mean() > 0.7
        ref_sets, ref_cnt = self._oracle_sets(bvh, qlo, qhi, 64)
        qid = np.asarray(qid)
        hits = np.asarray(hits)
        cnt = np.asarray(cnt)
        checked = 0
        for row in range(nq):
            if not in_band[row]:
                continue
            q = int(qid[row])
            got = set(int(p) for p in hits[row] if p >= 0)
            assert cnt[row] == ref_cnt[q], (row, q)
            assert got == ref_sets[q], (row, q)
            checked += 1
        assert checked > 0.7 * nq

    @pytest.mark.parametrize("cells", [8, 4, 2])
    def test_decomposed_matches_oracle(self, rng, cells):
        # aligned-cell decomposition: entry-granular results combine to
        # the exact per-query answer, with high in-band fraction on a
        # scene where the plain band fails (plane-crossing tiny boxes).
        # cells=4/2 use per-query lifted cell levels (fewer entries)
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 4096
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.004, np.float32)
        lo = jnp.asarray(c - h)
        hi = jnp.asarray(c + h)
        bvh = build_lbvh(lo, hi)
        nq = 1024
        qlo = lo[:nq] - 0.008
        qhi = hi[:nq] + 0.008
        max_hits = 32
        qid, hits, cnt, band = jax.jit(
            lambda *a: query_overlaps_sorted(*a, max_hits, tile=64,
                                             decompose=True, cells=cells)
        )(bvh, qlo, qhi)
        qid, hits = np.asarray(qid), np.asarray(hits)
        cnt, band = np.asarray(cnt), np.asarray(band)
        assert qid.shape[0] == cells * nq
        cnt_q = np.zeros(nq, np.int64)
        band_q = np.ones(nq, bool)
        sets = [set() for _ in range(nq)]
        trunc = np.zeros(nq, bool)
        for row in range(len(qid)):
            q = int(qid[row])
            cnt_q[q] += cnt[row]
            band_q[q] &= bool(band[row])
            trunc[q] |= cnt[row] > max_hits
            for p in hits[row]:
                if p >= 0:
                    assert int(p) not in sets[q], "duplicate across cells"
                    sets[q].add(int(p))
        assert band_q.mean() > 0.8, f"in-band only {band_q.mean():.3f}"
        ref_sets, ref_cnt = self._oracle_sets(bvh, qlo, qhi, 64)
        checked = 0
        for q in range(nq):
            if not band_q[q] or trunc[q]:
                continue
            assert cnt_q[q] == ref_cnt[q], q
            assert sets[q] == ref_sets[q], q
            checked += 1
        assert checked > 0.8 * nq

    @pytest.mark.parametrize("decompose", [False, True])
    def test_uniform_extent_matches_explicit_boxes(self, rng, decompose):
        # broad-phase fast path: centers + one shared extent must give
        # the same per-query answers as caller-computed p-r / p+r boxes
        # (the join reconstructs the same f32 values bit-identically)
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 4096
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.004, np.float32)
        bvh = build_lbvh(jnp.asarray(c - h), jnp.asarray(c + h))
        nq = 1024
        pts = jnp.asarray(c[:nq])
        r = jnp.float32(0.01)
        kw = dict(tile=64, decompose=decompose)
        if decompose:
            kw["cells"] = 4
        out_u = jax.jit(lambda *a: query_overlaps_sorted(
            *a, 32, uniform_extent=r, **kw))(bvh, pts, pts)
        out_e = jax.jit(lambda *a: query_overlaps_sorted(
            *a, 32, **kw))(bvh, pts - r, pts + r)

        def per_query(out):
            qid, hits, cnt, band = (np.asarray(o) for o in out)
            cnt_q = np.zeros(nq, np.int64)
            band_q = np.ones(nq, bool)
            sets = [set() for _ in range(nq)]
            for row in range(len(qid)):
                q = int(qid[row])
                cnt_q[q] += cnt[row]
                band_q[q] &= bool(band[row])
                sets[q].update(int(p) for p in hits[row] if p >= 0)
            return cnt_q, band_q, sets

        cu, bu, su = per_query(out_u)
        ce, be, se = per_query(out_e)
        np.testing.assert_array_equal(cu, ce)
        np.testing.assert_array_equal(bu, be)
        assert su == se
        assert bu.mean() > 0.8

    def test_band_overflow_flagged(self, rng):
        # one gigantic query box must fall out of the 3-tile band
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 4096
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.002, np.float32)
        bvh = build_lbvh(jnp.asarray(c - h), jnp.asarray(c + h))
        qlo = jnp.asarray(c[:128] - 0.004)
        qhi = jnp.asarray(c[:128] + 0.004)
        qlo = qlo.at[0].set(jnp.asarray([0.0, 0.0, 0.0]))
        qhi = qhi.at[0].set(jnp.asarray([1.0, 1.0, 1.0]))
        qid, hits, cnt, in_band = query_overlaps_sorted(
            bvh, qlo, qhi, 16, tile=32)
        ib = np.asarray(in_band)[np.argsort(np.asarray(qid))]
        assert not ib[0]                 # the huge box is flagged


class TestCompleteBuild:
    """build_lbvh_complete: gather-free implicit complete tree."""

    @pytest.mark.parametrize("n", [1, 2, 7, 64, 500])
    def test_root_and_leaves(self, rng, n):
        from zpc_tpu.containers.bvh import build_lbvh_complete
        lo, hi = _random_boxes(rng, n)
        bvh = build_lbvh_complete(jnp.asarray(lo), jnp.asarray(hi))
        np.testing.assert_allclose(np.asarray(bvh.lo[0]), lo.min(0),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(bvh.hi[0]), hi.max(0),
                                   atol=1e-6)
        prim = np.asarray(bvh.leaf_prim)
        leaves = prim[prim >= 0]
        assert sorted(leaves.tolist()) == list(range(n))

    def test_overlap_oracle(self, rng):
        from zpc_tpu.containers.bvh import build_lbvh_complete
        n, nq = 400, 64
        lo, hi = _random_boxes(rng, n)
        bvh = build_lbvh_complete(jnp.asarray(lo), jnp.asarray(hi))
        qlo, qhi = _random_boxes(rng, nq, size=0.1)
        hits, cnt = query_overlaps(bvh, jnp.asarray(qlo),
                                   jnp.asarray(qhi), 64)
        hits = np.asarray(hits)
        cnt = np.asarray(cnt)
        for qi in range(nq):
            want = set(np.nonzero(
                (lo <= qhi[qi]).all(1) & (qlo[qi] <= hi).all(1))[0])
            got = set(hits[qi][hits[qi] >= 0].tolist())
            assert got == want, qi
            assert cnt[qi] == len(want)

    def test_with_invalid(self, rng):
        from zpc_tpu.containers.bvh import build_lbvh_complete
        n = 100
        lo, hi = _random_boxes(rng, n)
        valid = jnp.asarray(rng.uniform(size=n) > 0.3)
        bvh = build_lbvh_complete(jnp.asarray(lo), jnp.asarray(hi),
                                  valid=valid)
        qlo, qhi = _random_boxes(rng, 16, size=0.2)
        hits, cnt = query_overlaps(bvh, jnp.asarray(qlo),
                                   jnp.asarray(qhi), 64)
        va = np.asarray(valid)
        for qi in range(16):
            want = set(np.nonzero(
                (lo <= qhi[qi]).all(1) & (qlo[qi] <= hi).all(1) & va)[0])
            got = set(np.asarray(hits[qi])[np.asarray(hits[qi]) >= 0]
                      .tolist())
            assert got == want

    def test_matches_karras_queries(self, rng):
        from zpc_tpu.containers.bvh import build_lbvh_complete
        n, nq = 300, 32
        lo, hi = _random_boxes(rng, n)
        b1 = build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
        b2 = build_lbvh_complete(jnp.asarray(lo), jnp.asarray(hi))
        qlo, qhi = _random_boxes(rng, nq, size=0.15)
        h1, c1 = query_overlaps(b1, jnp.asarray(qlo), jnp.asarray(qhi), 96)
        h2, c2 = query_overlaps(b2, jnp.asarray(qlo), jnp.asarray(qhi), 96)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        for qi in range(nq):
            s1 = set(np.asarray(h1[qi])[np.asarray(h1[qi]) >= 0].tolist())
            s2 = set(np.asarray(h2[qi])[np.asarray(h2[qi]) >= 0].tolist())
            assert s1 == s2


class TestExtractVariants:
    def test_scan_equals_topk(self, rng):
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 1024
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.01, np.float32)
        lo = jnp.asarray(c - h)
        hi = jnp.asarray(c + h)
        bvh = build_lbvh(lo, hi)
        qlo = lo[:512] - 0.02
        qhi = hi[:512] + 0.02
        r_scan = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=64,
                                       extract="scan")
        r_topk = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=64,
                                       extract="topk")
        np.testing.assert_array_equal(np.asarray(r_scan[1]),
                                      np.asarray(r_topk[1]))
        np.testing.assert_array_equal(np.asarray(r_scan[2]),
                                      np.asarray(r_topk[2]))
        r_none = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=64,
                                       extract="none")
        np.testing.assert_array_equal(np.asarray(r_none[2]),
                                      np.asarray(r_topk[2]))
        r_peel = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=64,
                                       extract="peel")
        np.testing.assert_array_equal(np.asarray(r_peel[1]),
                                      np.asarray(r_topk[1]))
        np.testing.assert_array_equal(np.asarray(r_peel[2]),
                                      np.asarray(r_topk[2]))
        r_bp = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=64,
                                     extract="bitpeel")
        np.testing.assert_array_equal(np.asarray(r_bp[1]),
                                      np.asarray(r_topk[1]))
        np.testing.assert_array_equal(np.asarray(r_bp[2]),
                                      np.asarray(r_topk[2]))

    def test_bitpeel_unaligned_window(self, rng):
        """bitpeel with a window not a multiple of 32 lanes (TL=63,
        3TL=189 -> padded to 192) must match topk exactly."""
        from zpc_tpu.containers.bvh import (build_lbvh_complete,
                                            query_overlaps_sorted)
        n = 1000
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.015, np.float32)
        lo = jnp.asarray(c - h)
        hi = jnp.asarray(c + h)
        bvh = build_lbvh_complete(lo, hi)
        qlo = lo[:512] - 0.02
        qhi = hi[:512] + 0.02
        r_bp = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=32,
                                     extract="bitpeel")
        r_tk = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=32,
                                     extract="topk")
        np.testing.assert_array_equal(np.asarray(r_bp[1]),
                                      np.asarray(r_tk[1]))
        np.testing.assert_array_equal(np.asarray(r_bp[2]),
                                      np.asarray(r_tk[2]))
        np.testing.assert_array_equal(np.asarray(r_bp[3]),
                                      np.asarray(r_tk[3]))

    def test_peel_wide_tile_sentinel(self, rng):
        """Regression: peel's composite key must fit int32.  With
        tile=256 here the leaf window is 3TL=3072 lanes and the old
        fixed lane<<21 shift wrapped negative, silently scrambling
        hit order (and the old 2^30 sentinel dropped high lanes)."""
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_sorted)
        n = 2048
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.01, np.float32)
        lo = jnp.asarray(c - h)
        hi = jnp.asarray(c + h)
        bvh = build_lbvh(lo, hi)
        qlo = lo[:512] - 0.02
        qhi = hi[:512] + 0.02
        r_peel = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=256,
                                       extract="peel")
        r_topk = query_overlaps_sorted(bvh, qlo, qhi, 32, tile=256,
                                       extract="topk")
        np.testing.assert_array_equal(np.asarray(r_peel[1]),
                                      np.asarray(r_topk[1]))
        np.testing.assert_array_equal(np.asarray(r_peel[2]),
                                      np.asarray(r_topk[2]))


class TestNearestBanded:
    def test_certified_results_are_exact(self, rng):
        """query_nearest_sorted: every in_band result equals the brute
        oracle; out-of-band results are never better than truth (so the
        rope-walk fallback only improves them)."""
        from zpc_tpu.containers.bvh import (build_lbvh_complete,
                                            query_nearest_sorted)
        n = 4096
        pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 1e-4, np.float32)
        bvh = jax.jit(build_lbvh_complete)(jnp.asarray(pts - h),
                                           jnp.asarray(pts + h))
        q = jnp.asarray(rng.uniform(0.1, 0.9, (1024, 3)
                                    ).astype(np.float32))
        qid, prim, d2, ok = jax.jit(
            lambda b, qq, p: query_nearest_sorted(b, qq, p, tile=64)
        )(bvh, q, jnp.asarray(pts))
        qn = np.asarray(q)[np.asarray(qid)]
        dd = ((qn[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        tp, td = dd.argmin(1), dd.min(1)
        okn, pn, dn = np.asarray(ok), np.asarray(prim), np.asarray(d2)
        assert okn.mean() > 0.5      # the band is useful, not vacuous
        assert (pn[okn] == tp[okn]).all()
        np.testing.assert_allclose(dn[okn], td[okn], rtol=1e-5,
                                   atol=1e-9)
        assert (dn >= td - 1e-6).all()

    def test_fallback_completes_the_answer(self, rng):
        """banded + rope-walk fallback on ~in_band == exact nearest
        everywhere (the intended usage pattern)."""
        from zpc_tpu.containers.bvh import (build_lbvh_complete,
                                            query_nearest,
                                            query_nearest_sorted)
        n = 2048
        # clustered points stress the band (queries far from their
        # morton neighborhood)
        centers = rng.uniform(0.2, 0.8, (8, 3))
        pts = (centers[rng.integers(0, 8, n)] +
               0.02 * rng.standard_normal((n, 3))).astype(np.float32)
        h = np.full((n, 3), 1e-4, np.float32)
        bvh = jax.jit(build_lbvh_complete)(jnp.asarray(pts - h),
                                           jnp.asarray(pts + h))
        q = jnp.asarray(rng.uniform(0, 1, (512, 3)).astype(np.float32))
        pj = jnp.asarray(pts)
        qid, prim, d2, ok = query_nearest_sorted(bvh, q, pj, tile=32)
        qs = jnp.asarray(np.asarray(q)[np.asarray(qid)])
        # NOTE prim_dist must be in LINEAR units: query_nearest prunes
        # with a linear-norm box lower bound
        ids_walk, d_walk = query_nearest(
            bvh, qs, lambda j, p: jnp.linalg.norm(p - pj[j]))
        prim_f = np.where(np.asarray(ok), np.asarray(prim),
                          np.asarray(ids_walk))
        dd = ((np.asarray(qs)[:, None, :] - pts[None, :, :]) ** 2
              ).sum(-1)
        np.testing.assert_array_equal(prim_f, dd.argmin(1))


class TestExactDriver:
    """query_overlaps_exact: banded join + bounded walk residue — every
    query answered exactly, no in_band for the caller to handle."""

    def test_every_query_exact_including_residue(self, rng):
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_exact)
        n = 4096
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.002, np.float32)
        lo, hi = jnp.asarray(c - h), jnp.asarray(c + h)
        bvh = build_lbvh(lo, hi)
        nq = 700                           # deliberate non-tile-multiple
        qlo = (c[:nq] - 0.004).copy()
        qhi = (c[:nq] + 0.004).copy()
        for i in (0, 13, 250):             # pathological: whole scene
            qlo[i] = -0.1
            qhi[i] = 1.1
        max_hits = 64
        qid_r, hits_r, cnt, ovf = jax.jit(
            lambda *a: query_overlaps_exact(*a, max_hits, tile=64,
                                            residue_budget=64))(
            bvh, jnp.asarray(qlo), jnp.asarray(qhi))
        assert not bool(ovf)
        qid_r, hits_r = np.asarray(qid_r), np.asarray(hits_r)
        cnt = np.asarray(cnt)
        lo_n, hi_n = np.asarray(lo), np.asarray(hi)
        sets = [set() for _ in range(nq)]
        for row in range(len(qid_r)):
            q = int(qid_r[row])
            if q < nq:
                for p in hits_r[row]:
                    if p >= 0:
                        assert int(p) not in sets[q], "duplicate hit"
                        sets[q].add(int(p))
        for q in range(nq):
            ref = np.where(np.all((lo_n <= qhi[q]) & (hi_n >= qlo[q]),
                                  axis=1))[0]
            assert cnt[q] == len(ref), q   # counts EXACT for every query
            if len(ref) <= max_hits:
                assert sets[q] == set(ref.tolist()), q

    def test_residue_budget_overflow_flagged(self, rng):
        from zpc_tpu.containers.bvh import (build_lbvh,
                                            query_overlaps_exact)
        n = 2048
        c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        h = np.full((n, 3), 0.002, np.float32)
        bvh = build_lbvh(jnp.asarray(c - h), jnp.asarray(c + h))
        nq = 256
        qlo = np.full((nq, 3), -0.1, np.float32)   # ALL pathological
        qhi = np.full((nq, 3), 1.1, np.float32)
        *_, ovf = query_overlaps_exact(bvh, jnp.asarray(qlo),
                                       jnp.asarray(qhi), 16, tile=64,
                                       residue_budget=64)
        assert bool(ovf)


def test_nse_fused_matches_bruteforce():
    """The fused chunked NSE sweep (round 5) == classic stack NSE, both
    directions, across chunk boundaries (chunk=512 forces several)."""
    from zpc_tpu.containers.bvh import _nse_dir_chunked
    rng = np.random.default_rng(3)
    g = 3000
    d = rng.integers(1, 64, g).astype(np.int32)

    def brute(strict):
        sel = np.full(g, -(1 << 30), np.int64)
        for i in range(g):
            for j in range(i - 1, -1, -1):
                if (d[j] < d[i]) if strict else (d[j] <= d[i]):
                    sel[i] = (j << 6) | d[j]
                    break
        return sel

    for strict in (False, True):
        got = np.asarray(jax.jit(
            lambda x, _s=strict: _nse_dir_chunked(x, _s, chunk=512))(
            jnp.asarray(d)))
        want = brute(strict)
        none = got < 0
        assert ((want < 0) == none).all()
        np.testing.assert_array_equal(got[~none], want[~none])


@pytest.mark.parametrize("strict", [False, True])
def test_nse_chunked_matches_numpy_bruteforce(strict):
    """The fused chunk-scan NSE sweep at its default chunk (the only form
    for g >= 1024) == an all-pairs numpy brute force: several chunks plus
    a ragged tail."""
    from zpc_tpu.containers.bvh import _nse_dir_chunked
    rng = np.random.default_rng(5)
    g = 2 * 4096 + 1234
    d = rng.integers(1, 64, g).astype(np.int32)
    want = np.full(g, -1, np.int64)
    j = np.arange(g)
    for i0 in range(0, g, 1024):
        i = np.arange(i0, min(i0 + 1024, g))[:, None]
        ok = (j[None, :] < i) & ((d[None, :] < d[i]) if strict
                                 else (d[None, :] <= d[i]))
        last = g - 1 - np.argmax(ok[:, ::-1], axis=1)
        want[i[:, 0]] = np.where(ok.any(axis=1), last, -1)
    got = np.asarray(jax.jit(
        lambda x: _nse_dir_chunked(x, strict))(jnp.asarray(d)))
    none = got < 0
    assert ((want < 0) == none).all()
    np.testing.assert_array_equal(got[~none] >> 6, want[~none])
    np.testing.assert_array_equal(got[~none] & 63, d[want[~none]])
