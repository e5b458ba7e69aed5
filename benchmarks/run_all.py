"""Full benchmark harness — the five BASELINE.md configs plus the fluid
and cloth scenes.

Measurement (measure.py): data-dependent iterations inside one jitted
``fori_loop``, waited for with ``block_until_ready``; chain dependences
pass through abs-sums so XLA can neither narrow nor factorize them;
median of post-warmup reps.  A section that fails makes the run exit
nonzero.

Writes BENCHMARKS.md at the repo root.
Run on the GPU:  python benchmarks/run_all.py [--quick] [--only ...]
"""

import argparse
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.measure import chained_ms, dep_scalar


def bytes_gb(n):
    return n / 1e9


def bench_primitives(n=1_000_000):
    """Config 1: reduce / scan / sort on 1M elements (dependent chains)."""
    rng = np.random.default_rng(0)
    xf = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    xi = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int32))
    rows = []

    def red(i, c):
        s, = c
        return (s + jnp.sum(jnp.abs(xf + s * 1e-37)),)
    ms = chained_ms(red, (jnp.float32(0),), iters=40)
    rows.append(("reduce 1M f32", f"{ms:.3f} ms",
                 f"{bytes_gb(n * 4 / (ms / 1e3)):.0f} GB/s"))

    def scan(i, c):
        x, = c
        return (x + jnp.cumsum(x) * 1e-37,)
    ms = chained_ms(scan, (xf,), iters=20)
    rows.append(("inclusive-scan 1M f32", f"{ms:.3f} ms",
                 f"{bytes_gb(2 * n * 4 / (ms / 1e3)):.0f} GB/s"))

    # sort rows: fused-LCG key evolution keeps every iteration's input
    # fresh without a host round trip
    M31 = 0x7FFFFFFF

    def evolve(k, i):
        return (k * jnp.int32(1664525) + i) & M31

    def srt(i, c):
        return (jax.lax.sort(evolve(c[0], i), is_stable=False),)
    ms = chained_ms(srt, (xi,), iters=64)
    rows.append(("sort 1M i32", f"{ms:.3f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mkeys/s"))

    vals = jnp.arange(n, dtype=jnp.int32)

    def sp(i, c):
        return jax.lax.sort((evolve(c[0], i), c[1]), num_keys=1)[:2]
    ms = chained_ms(sp, (xi, vals), iters=32)
    rows.append(("sort_pair 1M i32 (2-op unstable)", f"{ms:.3f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))

    def sppk(i, c):
        # primitives.sort_pair packed fast path (key 11b | val 20b)
        k = evolve(c[0], i) >> 20
        s = jax.lax.sort((k << 20) | vals, is_stable=False)
        return (s >> 20, s & ((1 << 20) - 1))
    ms = chained_ms(sppk, (xi, vals), iters=64)
    rows.append(("sort_pair 1M packed (11b key|20b rank)", f"{ms:.3f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))

    def rsp(i, c):
        # wide-window stable fallback (3-op) — radix_sort_pair at w+rank>31
        k = evolve(c[0], i)
        w = (k >> 4) & 0xFFFFFFF
        _, ko, vo = jax.lax.sort((w, k, c[1]), num_keys=1, is_stable=True)
        return (ko, vo)
    ms = chained_ms(rsp, (xi, vals), iters=16)
    rows.append(("radix_sort_pair 1M [4,32) stable 3-op", f"{ms:.3f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))

    def rspr(i, c):
        # radix_sort_pair vals_are_ranks packed path ([8,19) window)
        k = evolve(c[0], i)
        w = (k >> 8) & 0x7FF
        p, ko = jax.lax.sort(((w << 20) | vals, k), num_keys=1)
        return (ko, p & ((1 << 20) - 1))
    ms = chained_ms(rspr, (xi, vals), iters=32)
    rows.append(("radix_sort_pair 1M [8,19) ranks-packed", f"{ms:.3f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))
    return rows


def bench_primitives_16m(n=1 << 24):
    """Config 1 at 16M: the memory-bound regime (1M rows are shape-bound)."""
    from zpc_tpu import inclusive_scan, jit_exec
    pol = jit_exec()
    rng = np.random.default_rng(0)
    xf = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    xi = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int32))
    vals = jnp.asarray(rng.integers(0, 1 << 20, n).astype(np.int32))
    rows = []
    M31 = 0x7FFFFFFF

    def red(i, c):
        s, = c
        return (s + jnp.sum(jnp.abs(xf + s * 1e-37)),)
    ms = chained_ms(red, (jnp.float32(0),), iters=40)
    rows.append(("reduce 16M f32", f"{ms:.3f} ms",
                 f"{bytes_gb(n * 4 / (ms / 1e3)):.0f} GB/s"))

    def copy_x(i, c):
        x, = c
        return (x + 1e-37,)
    ms = chained_ms(copy_x, (xf,), iters=20)
    rows.append(("elementwise r+w 16M f32 (copy bound)", f"{ms:.3f} ms",
                 f"{bytes_gb(2 * n * 4 / (ms / 1e3)):.0f} GB/s"))

    def scan_x(i, c):
        x, = c
        return (x + inclusive_scan(pol, x) * 1e-37,)
    ms = chained_ms(scan_x, (xf,), iters=20)
    rows.append(("inclusive_scan 16M f32", f"{ms:.3f} ms",
                 f"{bytes_gb(2 * n * 4 / (ms / 1e3)):.0f} GB/s"))

    def evolve(k, i):
        return (k * jnp.int32(1664525) + i) & M31

    def srt(i, c):
        return (jax.lax.sort(evolve(c[0], i), is_stable=False),)
    ms = chained_ms(srt, (xi,), iters=8)
    rows.append(("sort 16M i32", f"{ms:.2f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mkeys/s"))

    def sp2(i, c):
        return jax.lax.sort((evolve(c[0], i), c[1]), num_keys=1)[:2]
    ms = chained_ms(sp2, (xi, vals), iters=6)
    rows.append(("sort_pair 16M (2-op unstable)", f"{ms:.2f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))

    def sppk(i, c):
        k = evolve(c[0], i) >> 20
        s = jax.lax.sort((k << 20) | c[1], is_stable=False)
        return (s >> 20, s & ((1 << 20) - 1))
    ms = chained_ms(sppk, (xi, vals), iters=8)
    rows.append(("sort_pair 16M packed (11b|20b)", f"{ms:.2f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))

    def rsp3(i, c):
        k = evolve(c[0], i)
        w = (k >> 4) & 0xFFFFFFF
        _, ko, vo = jax.lax.sort((w, k, c[1]), num_keys=1, is_stable=True)
        return (ko, vo)
    ms = chained_ms(rsp3, (xi, vals), iters=4)
    rows.append(("radix_sort_pair 16M [4,32) stable 3-op", f"{ms:.2f} ms",
                 f"{n / (ms / 1e3) / 1e6:.0f} Mpairs/s"))
    return rows


def bench_poisson(n=128):
    """Config 2: matrix-free CG on a dense n^3 Poisson problem."""
    from zpc_tpu.math.solvers import cg

    def laplace(u):
        out = 6.0 * u
        out = out - jnp.pad(u[1:], ((0, 1), (0, 0), (0, 0)))
        out = out - jnp.pad(u[:-1], ((1, 0), (0, 0), (0, 0)))
        out = out - jnp.pad(u[:, 1:], ((0, 0), (0, 1), (0, 0)))
        out = out - jnp.pad(u[:, :-1], ((0, 0), (1, 0), (0, 0)))
        out = out - jnp.pad(u[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
        out = out - jnp.pad(u[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
        return out

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((n, n, n)).astype(np.float32))
    iters = 100

    def solve_chain(i, c):
        bb, = c
        res = cg(laplace, bb, max_iters=iters, rel_tol=0.0)
        return (bb + 1e-30 * jnp.abs(res.x),)

    ms = chained_ms(solve_chain, (b,), iters=1, reps=3)
    it_s = iters / (ms / 1e3)
    bw = bytes_gb(iters * 8 * n ** 3 * 4 / (ms / 1e3))
    return [(f"CG Poisson {n}^3 (100 iters)",
             f"{ms:.1f} ms", f"{it_s:.0f} iters/s, ~{bw:.0f} GB/s")]


def bench_mpm(n=262144, quick=False):
    """Config 3: explicit MPM, all transfer paths."""
    from examples.mpm_block import build
    from zpc_tpu.sim.mpm import explicit_step
    from zpc_tpu.sim.mpm_binned import BinnedConfig, explicit_step_binned
    from zpc_tpu.sim.mpm_binned2 import (BinnedConfig2, _rebin, bin_state,
                                         explicit_step_binned2,
                                         rebin_adaptive)

    sim, st0, dt = build(n, dx=1.0 / 128)
    dtj = jnp.float32(dt)
    cfg = BinnedConfig(bins_capacity=4096)
    rows = []
    iters = 5 if quick else 10

    def add(name, ms):
        rows.append((f"MPM 256k {name}", f"{ms:.1f} ms/step",
                     f"{n / (ms / 1e3) / 1e6:.2f} M particle-steps/s"))

    cfg2 = BinnedConfig2(bins_capacity=2560, block_capacity=2048,
                         chunk_bins=640)
    bst = jax.block_until_ready(
        jax.jit(lambda s: bin_state(sim, s, cfg2))(st0))

    def v2(_, s):
        s = jax.lax.cond(s.needs_rebin,
                         lambda t: rebin_adaptive(sim, t, cfg2),
                         lambda t: t, s)
        return explicit_step_binned2(sim, s, dtj, cfg2, rebin=False)
    add("binned2 adaptive", chained_ms(v2, bst, iters=iters))

    def v2bare(_, s):
        return explicit_step_binned2(sim, s, dtj, cfg2, rebin=False)
    add("binned2 bare step", chained_ms(v2bare, bst, iters=iters))

    def v1(_, c):
        s, ov = c
        s2, ov2 = explicit_step_binned(sim, s, dtj, cfg)
        return s2, ov | ov2
    add("binned", chained_ms(v1, (st0, jnp.bool_(False)), iters=iters))

    if not quick:
        n1 = 1048576
        sim1, st1, dt1 = build(n1, dx=1.0 / 128, block_capacity=8192)
        dtj1 = jnp.float32(dt1)
        cfg1 = BinnedConfig2(bins_capacity=9216, block_capacity=8192,
                             chunk_bins=768)
        bst1 = jax.block_until_ready(
            jax.jit(lambda s: bin_state(sim1, s, cfg1))(st1))

        def v2m(_, s):
            s = jax.lax.cond(s.needs_rebin,
                             lambda t: rebin_adaptive(sim1, t, cfg1),
                             lambda t: t, s)
            return explicit_step_binned2(sim1, s, dtj1, cfg1, rebin=False)
        ms = chained_ms(v2m, bst1, iters=iters)
        rows.append((f"MPM 1048k binned2 adaptive", f"{ms:.1f} ms/step",
                     f"{n1 / (ms / 1e3) / 1e6:.2f} M particle-steps/s"))

    if not quick:
        def vb(_, s):
            return explicit_step(sim, s, dtj)
        add("baseline", chained_ms(vb, st0, iters=3, reps=2))
    return rows


def bench_bvh(n=1_048_576, quick=False):
    """Config 4: LBVH build + AABB query (sorted banded join)."""
    from zpc_tpu.containers.bvh import (build_lbvh, build_lbvh_complete,
                                        query_overlaps,
                                        query_overlaps_sorted)

    if quick:
        n = 262144
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.full((n, 3), 0.002, np.float32)
    lo = jnp.asarray(c - h)
    hi = jnp.asarray(c + h)

    def build_body(i, lohi):
        l, h2 = lohi
        bvh = build_lbvh(l, h2)
        eps = dep_scalar(bvh.lo)
        return l + eps, h2 + eps

    ms = chained_ms(build_body, (lo, hi), iters=4, reps=3)
    rows = [(f"LBVH build (Karras) {n // 1000}k", f"{ms:.1f} ms",
             f"{n / (ms / 1e3) / 1e6:.1f} Mprims/s")]

    # topology alone: the rest of the full build is per-node box and
    # reorder gathers
    from zpc_tpu.containers.bvh import _karras_topology
    from zpc_tpu.math.bits import morton3d
    codes0 = jax.block_until_ready(jax.jit(lambda l, h2: jnp.sort(
        morton3d(jnp.clip(((0.5 * (l + h2) - jnp.min(l, 0))
                           / jnp.max(jnp.maximum(jnp.max(h2, 0)
                                                 - jnp.min(l, 0), 1e-12))
                           * 1024.0), 0, 1023).astype(jnp.int32))))(lo, hi))

    def topo_body(i, cc):
        lft, rgt, rl, rh = _karras_topology(cc[0])
        eps = (dep_scalar(lft) + dep_scalar(rgt) + dep_scalar(rl)
               + dep_scalar(rh)).astype(jnp.int32)
        return (cc[0] + eps,)

    ms = chained_ms(topo_body, (codes0,), iters=4, reps=3)
    rows.append((f"LBVH Karras topology only {n // 1000}k",
                 f"{ms:.1f} ms", f"{n / (ms / 1e3) / 1e6:.1f} Mprims/s"))

    def build_body2(i, lohi):
        l, h2 = lohi
        bvh = build_lbvh_complete(l, h2)
        eps = dep_scalar(bvh.lo)
        return l + eps, h2 + eps

    ms = chained_ms(build_body2, (lo, hi), iters=6, reps=3)
    rows.append((f"LBVH build (complete tree) {n // 1000}k", f"{ms:.1f} ms",
                 f"{n / (ms / 1e3) / 1e6:.1f} Mprims/s"))

    bvh = jax.block_until_ready(jax.jit(build_lbvh)(lo, hi))
    nq = n
    qlo = lo - 0.004
    qhi = hi + 0.004

    # decompose=True: aligned-cell decomposition keeps entries in-band
    # at this scale (plain corner-span bands keep almost no query in
    # band at 1M).  The in-band fraction is printed alongside so the rows
    # certify answers.
    def band_frac(qa, qb, **kw):
        qid, _, _, ok = jax.jit(lambda a, c: query_overlaps_sorted(
            bvh, a, c, 16, **kw))(qa, qb)
        if kw.get("decompose"):
            # entry-granular returns: a query is exact only if ALL its
            # covering-cell entries are in-band -> per-query scatter-AND
            ok = jnp.ones((nq,), bool).at[qid].min(ok)
        return float(jnp.mean(ok.astype(jnp.float32)))

    # this scene's query boxes share one extent (prim half 0.002 + pad
    # 0.004) -> the decomposed rows ride the uniform_extent fast path
    # (5-operand entry sort)
    pts = jnp.asarray(c)
    uext = jnp.float32(0.006)

    def q_sorted(i, q, consts):
        b, = consts
        p, = q
        qid, hits, cnt, ok = query_overlaps_sorted(
            b, p, p, 16, tile=128, group=512, extract="peel",
            decompose=True, cells=4, uniform_extent=uext)
        eps = dep_scalar(cnt) + dep_scalar(hits[:, 0])
        return (p + eps,)

    ms = chained_ms(q_sorted, (pts,), iters=3, const=(bvh,))
    bf = band_frac(pts, pts, tile=128, group=512, extract="peel",
                   decompose=True, cells=4, uniform_extent=uext)
    rows.append((f"AABB query (banded join c4 uniform, 16 hits) "
                 f"{nq // 1000}k", f"{ms:.1f} ms",
                 f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s (in-band {bf:.3f})"))

    # plain-band rows: the throughput where the band holds (clustered
    # scenes; in-band is certified per query, consumers fall back on
    # the flagged residue).  bitpeel under decompose is pathological and
    # not benchmarked.
    def q_plain(i, q, consts):
        b, = consts
        ql, qh = q
        qid, hits, cnt, ok = query_overlaps_sorted(b, ql, qh, 16,
                                                   tile=128, group=256,
                                                   extract="peel")
        eps = dep_scalar(cnt) + dep_scalar(hits[:, 0])
        return ql + eps, qh + eps

    ms = chained_ms(q_plain, (qlo, qhi), iters=3, const=(bvh,))
    rows.append((f"AABB query (plain band, peel, 16 hits) {nq // 1000}k",
                 f"{ms:.1f} ms", f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s"))

    def q_plain_cnt(i, q, consts):
        b, = consts
        ql, qh = q
        qid, hits, cnt, ok = query_overlaps_sorted(b, ql, qh, 16,
                                                   tile=256, group=512,
                                                   extract="none")
        eps = dep_scalar(cnt)
        return ql + eps, qh + eps

    ms = chained_ms(q_plain_cnt, (qlo, qhi), iters=3, const=(bvh,))
    rows.append((f"AABB query (plain band, counts) {nq // 1000}k",
                 f"{ms:.1f} ms", f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s"))

    def q_counts(i, q, consts):
        b, = consts
        p, = q
        qid, hits, cnt, ok = query_overlaps_sorted(
            b, p, p, 16, tile=128, group=512, extract="none",
            decompose=True, uniform_extent=uext)
        eps = dep_scalar(cnt)
        return (p + eps,)

    ms = chained_ms(q_counts, (pts,), iters=3, const=(bvh,))
    bf = band_frac(pts, pts, tile=128, group=512, extract="none",
                   decompose=True, uniform_extent=uext)
    rows.append((f"AABB query (counts c8 uniform) {nq // 1000}k",
                 f"{ms:.1f} ms",
                 f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s (in-band {bf:.3f})"))

    # cells=4: per-query lifted cell levels — half the entries of the
    # cells=8 decomposition (the decomposed join is entry-bound), at a
    # modestly lower in-band fraction (flagged residue falls back)
    def q_counts4(i, q, consts):
        b, = consts
        p, = q
        qid, hits, cnt, ok = query_overlaps_sorted(
            b, p, p, 16, tile=128, group=512, extract="none",
            decompose=True, cells=4, uniform_extent=uext)
        eps = dep_scalar(cnt)
        return (p + eps,)

    ms = chained_ms(q_counts4, (pts,), iters=3, const=(bvh,))
    bf = band_frac(pts, pts, tile=128, group=512, extract="none",
                   decompose=True, cells=4, uniform_extent=uext)
    rows.append((f"AABB query (counts c4 uniform) {nq // 1000}k",
                 f"{ms:.1f} ms",
                 f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s (in-band {bf:.3f})"))

    # exact driver: banded join + bounded walk residue — EVERY query
    # answered exactly, static shapes (the rope walk is the residue
    # engine + oracle, not a query path)
    from zpc_tpu.containers.bvh import query_overlaps_exact

    def q_exact(i, q, consts):
        b, = consts
        p, = q
        qid, hits, cnt, ovf = query_overlaps_exact(
            b, p, p, 16, tile=128, group=512, cells=8,
            residue_budget=16384, uniform_extent=uext)
        eps = dep_scalar(cnt) + 1e-30 * ovf
        return (p + eps,)

    ms = chained_ms(q_exact, (pts,), iters=2, reps=2, const=(bvh,))
    rows.append((f"AABB query (EXACT driver c8 + walk residue, 16 hits) "
                 f"{nq // 1000}k", f"{ms:.1f} ms",
                 f"{nq / (ms / 1e3) / 1e6:.2f} Mq/s (every query exact)"))
    return rows


def terrain_mesh(res=32, y0=0.56, amp=0.02, lo=0.0, hi=1.0):
    """res x res heightfield -> 2*res^2 triangles (contact broad-phase
    has real LBVH work, peaks graze the particle cube's underside)."""
    xs = np.linspace(lo, hi, res + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = y0 + amp * np.sin(6.2832 * X) * np.cos(6.2832 * Z)
    V = np.stack([X, Y, Z], -1).astype(np.float32)
    a = V[:-1, :-1].reshape(-1, 3)
    b = V[1:, :-1].reshape(-1, 3)
    c = V[1:, 1:].reshape(-1, 3)
    d = V[:-1, 1:].reshape(-1, 3)
    return jnp.asarray(np.concatenate(
        [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]))


def bench_implicit(n=1_000_000, quick=False):
    """Config 5: implicit MPM step on the v2 bin-ordered operator, plus
    the LBVH-contact-coupled variant (BASELINE config 5 as specified)."""
    from examples.mpm_block import build
    from zpc_tpu.sim.contact_implicit import MeshContact
    from zpc_tpu.sim.implicit_binned2 import implicit_step_binned2
    from zpc_tpu.sim.mpm_binned2 import (BinnedConfig2, bin_state,
                                         rebin_adaptive)

    if quick:
        n = 262144
    big = n > 500_000
    sim, st, dt = build(n, dx=1.0 / 128,
                        block_capacity=8192 if big else 4096)
    cfg = BinnedConfig2(bins_capacity=9216 if big else 2560,
                        block_capacity=8192 if big else 2048,
                        chunk_bins=768 if big else 640)
    bst = jax.block_until_ready(
        jax.jit(lambda s: bin_state(sim, s, cfg))(st))
    rows = []

    # PCG stops on tolerance (rel_tol 1e-3, the production contract);
    # the iteration count each solve actually used is measured and
    # reported alongside — a fixed-20-iteration row overstated the cost
    # ~3x (mass-Jacobi PCG of (M + dt^2 K) converges in ~4-8 iters at
    # this dt; condition is bounded by the mass term, so the count is
    # resolution-independent)
    dtj = jnp.float32(5e-4)

    def make_step(contact):
        def step(_, s):
            s = jax.lax.cond(s.needs_rebin,
                             lambda t: rebin_adaptive(sim, t, cfg),
                             lambda t: t, s)
            return implicit_step_binned2(sim, s, dtj, cfg, cg_iters=50,
                                         cg_tol=1e-3, contact=contact,
                                         rebin=False)
        return step

    def measured_iters(contact):
        _, it = implicit_step_binned2(sim, bst, dtj, cfg, cg_iters=50,
                                      cg_tol=1e-3, contact=contact,
                                      rebin=False, with_stats=True)
        return int(it)

    it0 = measured_iters(None)
    ms = chained_ms(make_step(None), bst, iters=2, reps=2)
    rows.append((f"implicit MPM v2 {n // 1000}k (tol 1e-3, {it0} CG iters)",
                 f"{ms:.0f} ms/step",
                 f"{n / (ms / 1e3) / 1e6:.2f} M particles/s"))

    mesh = terrain_mesh()
    mc = MeshContact.build(mesh, dhat=0.01, kappa=10.0, max_tris=8)

    itc = measured_iters(mc)
    ms = chained_ms(make_step(mc), bst, iters=2, reps=2)
    rows.append((f"implicit MPM v2 + LBVH contact {n // 1000}k "
                 f"({mesh.shape[0]} tris, tol 1e-3, {itc} CG iters)",
                 f"{ms:.0f} ms/step",
                 f"{n / (ms / 1e3) / 1e6:.2f} M particles/s"))

    # reference-scale contact scene: >=100k tris —
    # the broad phase still issues ONE banded-join query per bin, so
    # the triangle count only deepens the LBVH, not the pair lists
    mesh_big = terrain_mesh(res=224)              # 100,352 tris
    mc_big = MeshContact.build(mesh_big, dhat=0.01, kappa=10.0,
                               max_tris=8)
    itb = measured_iters(mc_big)
    ms = chained_ms(make_step(mc_big), bst, iters=2, reps=2)
    rows.append((f"implicit MPM v2 + LBVH contact {n // 1000}k "
                 f"({mesh_big.shape[0]} tris, tol 1e-3, {itb} CG iters)",
                 f"{ms:.0f} ms/step",
                 f"{n / (ms / 1e3) / 1e6:.2f} M particles/s"))
    return rows


def fluid_scene(n):
    """EOS weakly-compressible dam break: (sim, MPMState, BinnedConfig2).

    The dam is a cubic column at 8 ppc, jittered-grid seeded (2 per cell
    per axis +-0.1 dx).  Uniform-random seeding puts ~8x density variance
    in every cell; with the EOS sound speed ~24 m/s the resulting pressure
    noise ejects particles from their windows every step and the step
    becomes mostly rebin.  Grid seeding is also how the reference's Scene
    builders seed fluids (simulation/init/Scene.cpp PoissonDisk / grid
    fills).
    """
    from zpc_tpu.models.constitutive import EquationOfState
    from zpc_tpu.sim.fluid import make_fluid_state
    from zpc_tpu.sim.mpm_binned2 import BinnedConfig2
    from zpc_tpu.geometry.collider import Collider, ColliderType
    from zpc_tpu.geometry.levelset import ComplementLevelSet, Cuboid
    from zpc_tpu.sim.mpm import MPMSim

    rng = np.random.default_rng(11)
    dx = 1.0 / 128
    side_c = round((n / 8) ** (1 / 3))         # 32 cells per axis at 262k
    cell = np.arange(side_c)
    ci = np.stack(np.meshgrid(cell, cell, cell, indexing="ij"),
                  -1).reshape(-1, 3)
    offs = np.stack(np.meshgrid(*([np.asarray([0.25, 0.75])] * 3),
                                indexing="ij"), -1).reshape(-1, 3)
    x = (ci[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    x = (x + rng.uniform(-0.1, 0.1, x.shape)) * dx + 0.05
    x = x.astype(np.float32)[:n]
    # lane/table budgets scale with n: the chunked transfers sweep ALL
    # static bins, so an oversized bins_capacity is a direct per-step
    # tax.  1M: 10240 bins — the collapsing column spreads over more
    # blocks than the elastic cube, so keep pad headroom.  (Chosen before
    # the move to the GPU; not re-measured on the H100.)
    big = n > 524288
    nb_cap = 8192 if big else 4096
    st = make_fluid_state(jnp.asarray(x), dx=dx, rho=1e3,
                          block_capacity=nb_cap)
    tank = Collider(ComplementLevelSet(Cuboid(jnp.full(3, 0.02),
                                              jnp.full(3, 0.98))),
                    ColliderType.slip)
    sim = MPMSim(model=EquationOfState(mu=jnp.float32(0.0),
                                       lam=jnp.float32(8e4),
                                       gamma=jnp.float32(7.0)),
                 gravity=jnp.asarray([0.0, -9.8, 0.0]), colliders=(tank,))
    cfg = BinnedConfig2(bins_capacity=10240 if big else 2560,
                        block_capacity=nb_cap,
                        chunk_bins=640 if big else 512)
    return sim, st, cfg


def bench_fluid(n=262144, quick=False):
    """EOS weakly-compressible dam break on the fluid binned2 fast path."""
    from zpc_tpu.sim.fluid_binned2 import (bin_fluid_state, _rebin,
                                           explicit_fluid_step_binned2)

    sim, st, cfg = fluid_scene(n)
    bst = jax.block_until_ready(
        jax.jit(lambda s: bin_fluid_state(sim, s, cfg))(st))
    dtj = jnp.float32(2e-4)

    def stepf(_, s):
        s = jax.lax.cond(s.needs_rebin,
                         lambda t: _rebin(sim, t, cfg), lambda t: t, s)
        return explicit_fluid_step_binned2(sim, s, dtj, cfg, rebin=False)

    # advance past the release transient so the row measures the
    # sustained collapsing-column regime, not the first pressure shock
    warm = jax.jit(lambda s: jax.lax.fori_loop(0, 100, stepf, s))
    bst = jax.block_until_ready(warm(bst))
    ms = chained_ms(stepf, bst, iters=10 if quick else 20)
    return [(f"fluid dam break {n // 1000}k (binned2 adaptive, jittered"
             f"-grid 8ppc)", f"{ms:.1f} ms/step",
             f"{n / (ms / 1e3) / 1e6:.2f} M particle-steps/s")]


def cloth_scene(nx):
    """Two-layer codim cloth drop: (ClothSim, x0).

    Scale-similar: dhat and the layer gap track the mesh spacing, so the
    contact regime (and candidate counts) do not depend on nx; at nx=64
    they are 0.008 / 0.015.  Stretch and bend run in slice form over the
    two-layer grid union; the incidence tables stay as the fallback."""
    from zpc_tpu.sim.cloth import (ClothSim, build_grid_stencil,
                                   build_incidence, make_cloth_grid)
    spacing = 0.6 / nx
    gap, dhat = 1.6 * spacing, 0.8533333 * spacing
    simA, xA = make_cloth_grid(nx, nx, spacing, height=0.2, dhat=dhat,
                               ground_off=-10.0, k_stretch=2e2,
                               k_bend=1e-4, mass=0.01)
    N = xA.shape[0]
    xB = xA + jnp.asarray([0.5 * spacing, gap, 0.5 * spacing])
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
    sim = build_grid_stencil(build_incidence(sim),
                             ((0, nx, nx), (N, nx, nx)))
    return sim, jnp.concatenate([xA, xB])


# candidate budget per vertex for the cloth self-contact broad phase: it
# covers the worst vertex of the settled two-layer scene (26 raw AABB
# overlaps incl. incident ones) with slack.  The trajectory depends on it,
# and a budget that overflows mid-settle drops contacts -> penetrations ->
# a slower, uncertified regime.
CLOTH_MAX_CAND = 32


def bench_cloth(nx=64, quick=False):
    """Codim cloth: two-layer drop with LBVH self-contact (the assembled
    codim-IPC solver — stretch + bending + ground IPC + self-contact
    barriers + CCD limiter, Newton-CG implicit Euler)."""
    from zpc_tpu.sim.cloth import (ContactWindow, implicit_step,
                                   self_contact_candidates)

    if quick:
        nx = 24
    sim, x0 = cloth_scene(nx)
    nv, ntris = int(x0.shape[0]), int(sim.tris.shape[0])
    dtj = jnp.float32(0.005)
    mc = CLOTH_MAX_CAND
    cw = ContactWindow(radius=1, max_residue=1024)

    def step(i, c, budget=None, window=None):
        x, v = c
        x, v, _ = implicit_step(sim, x, v, dtj, newton_iters=2,
                                cg_iters=24, self_contact=True,
                                max_cand=mc, contact_budget=budget,
                                contact_window=window)
        return x, v

    # settle layer B onto A so the row measures the in-contact regime.
    # Settle with the WINDOW step: its in-window contact is stencil-
    # complete regardless of the cand budget, so a transient mid-impact
    # cand overflow cannot drop contacts and settle into a penetrating
    # (permanently-overflowing, CG-saturating) state, as dense settling
    # at the same budget does.
    stepw = lambda i, c: step(i, c, window=cw)
    warm = jax.jit(lambda c: jax.lax.fori_loop(0, 40, stepw, c))
    c0 = jax.block_until_ready(warm((x0, jnp.zeros_like(x0))))
    _, ovf = jax.jit(lambda x: self_contact_candidates(sim, x, mc))(c0[0])
    tag = "certified" if not bool(ovf) else "OVERFLOWED"
    ms = chained_ms(stepw, c0, iters=5 if quick else 10, reps=3)
    rows = [(f"cloth two-layer self-contact {nv // 1000}k verts "
             f"({ntris} tris, Newton 2 x CG 24, WINDOW-stencil contact "
             f"r=1, broad phase {tag} mc={mc})",
             f"{ms:.1f} ms/step",
             f"{nv / (ms / 1e3) / 1e6:.2f} M vert-steps/s")]
    ms = chained_ms(step, c0, iters=5 if quick else 10, reps=3)
    rows.append((f"cloth two-layer self-contact {nv // 1000}k verts "
                 f"(dense gathered contact, assembled GN operator, "
                 f"mc={mc})",
                 f"{ms:.1f} ms/step",
                 f"{nv / (ms / 1e3) / 1e6:.2f} M vert-steps/s"))
    return rows


def bench_cloth_128k(nx=256):
    """Reference-scale codim row: 128k verts (two 256x256 layers),
    window-stencil contact."""
    from zpc_tpu.sim.cloth import ContactWindow, implicit_step
    sim, x0 = cloth_scene(nx)
    nv = int(x0.shape[0])
    dtj = jnp.float32(0.005)
    cw = ContactWindow(radius=1, max_residue=8192)

    def stepw(i, c):
        x, v = c
        x, v, _ = implicit_step(sim, x, v, dtj, newton_iters=2,
                                cg_iters=24, self_contact=True,
                                max_cand=CLOTH_MAX_CAND, contact_window=cw)
        return x, v

    warm = jax.jit(lambda c: jax.lax.fori_loop(0, 20, stepw, c))
    c0 = jax.block_until_ready(warm((x0, jnp.zeros_like(x0))))
    ms = chained_ms(stepw, c0, iters=5, reps=3)
    return [(f"cloth two-layer self-contact {nv // 1000}k verts "
             f"({int(sim.tris.shape[0])} tris, Newton 2 x CG 24, "
             f"WINDOW-stencil contact r=1)",
             f"{ms:.1f} ms/step",
             f"{nv / (ms / 1e3) / 1e6:.2f} M vert-steps/s")]


def main():
    from zpc_tpu.utils.compile_cache import enable_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma list: prim,prim16,poisson,mpm,bvh,implicit,"
                         "fluid,cloth")
    ap.add_argument("--out", default="BENCHMARKS.md")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    enable_compile_cache()

    devs = jax.devices()
    sections = []
    failed = []

    def add_section(title, fn):
        try:
            rows = fn()
        except Exception as e:          # report, run the rest, exit nonzero
            traceback.print_exc()
            failed.append(title)
            rows = [("FAILED", "n/a", f"{type(e).__name__}: {e}"[:120])]
        sections.append((title, rows))
        print(f"== {title}", flush=True)
        for r in rows:
            print("   " + " | ".join(r), flush=True)

    if not only or "prim" in only:
        add_section("Parallel primitives (config 1)", bench_primitives)
    if not only or "prim16" in only:
        add_section("Parallel primitives at 16M (config 1)",
                    bench_primitives_16m)
    if not only or "poisson" in only:
        add_section("Poisson CG (config 2)",
                    lambda: bench_poisson(64 if args.quick else 128))
    if not only or "mpm" in only:
        add_section("Explicit MPM (config 3)",
                    lambda: bench_mpm(quick=args.quick))
    if not only or "bvh" in only:
        add_section("LBVH (config 4)", lambda: bench_bvh(quick=args.quick))
    if not only or "implicit" in only:
        add_section("Implicit MPM + contact (config 5)",
                    lambda: bench_implicit(quick=args.quick))
    if not only or "fluid" in only:
        add_section("Fluid dam break (EOS)",
                    lambda: bench_fluid(quick=args.quick))
        if not args.quick:   # scale-flatness row
            add_section("Fluid dam break at 1M (EOS)",
                        lambda: bench_fluid(n=1 << 20))
    if not only or "cloth" in only:
        add_section("Codim cloth (self-contact)",
                    lambda: bench_cloth(quick=args.quick))
        if not args.quick:   # reference-scale row
            add_section("Codim cloth at 128k verts",
                        bench_cloth_128k)
    lines = [f"# BENCHMARKS — {devs[0].platform} {devs[0].device_kind} "
             f"x{len(devs)} ({time.strftime('%Y-%m-%d')})",
             "",
             "Times are per iteration of data-dependent chains inside one",
             "compiled program, waited for with block_until_ready, median",
             "of warm reps (benchmarks/measure.py).", ""]
    for title, rows in sections:
        lines.append(f"## {title}\n")
        lines.append("| case | time | throughput |")
        lines.append("|---|---|---|")
        for r in rows:
            lines.append("| " + " | ".join(r) + " |")
        lines.append("")
    out = "\n".join(lines)
    print(out)
    if not only:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    if failed:
        sys.exit(f"run_all: {len(failed)} section(s) failed: "
                 + ", ".join(failed))


if __name__ == "__main__":
    main()
