"""On-card smoke test: drive the main paths once, at full size, on one GPU.

    python chip_smoke.py              # one card: phases mpm, prims, lbvh, reach
    python chip_smoke.py --cards 4    # only the multi-card tiers, 4 cards

Phases (each prints compile seconds, warm ms per step and
``peak_bytes_in_use``, and every error beside its limit):

* ``mpm``    explicit MPM on the binned2 adaptive path (bin_state ->
  adaptive_chain -> unbin_state) at 1,048,576 particles against the plain
  reference ``sim/mpm.py:explicit_step``; then 8,388,608 particles (the
  same scene at dx=1/256) for 50 steps, checked for overflow, finiteness,
  mass conservation and free-fall momentum.
* ``prims``  16M-element scans (add/max/min, inclusive/exclusive; int32,
  uint32, float32) and sorts against numpy, timed beside a 16M copy.
* ``lbvh``   LBVH build at 1M primitives, ``_karras_topology`` alone, and
  exact overlap counts checked against brute force on a 4096-query sample.
* ``reach``  one step each of implicit MPM at 1M with mesh contact, the 1M
  fluid dam break and the 8k two-layer cloth.

Everything runs in this one process.  Any failure exits nonzero; the last
line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# oracle tolerances of tests/test_mpm_binned2.py (absolute)
TOL_X, TOL_V, TOL_F = 1e-5, 2e-4, 1e-5
# mass: the grid total is a float32 sum of partition-of-unity weights
TOL_MASS = 1e-6
# free-fall momentum: float32 weight sums round at ~1e-7 per step
TOL_MOMENTUM = 1e-4
# float32 add-scans: the device sums in another order than numpy's
# sequential float64 reference; allow 2^-16 of the running |x| sum
# (about 500 float32 roundings of every term)
TOL_SCAN_F32 = 2.0 ** -16

FULL = dict(
    mpm=dict(n=1 << 20, dx=1.0 / 128, bins=9216, blocks=8192, chunk=768,
             steps=10, n_big=8 << 20, dx_big=1.0 / 256, bins_big=73728,
             blocks_big=65536, chunk_big=768, steps_big=50),
    prims=dict(n=1 << 24),
    lbvh=dict(n=1 << 20, n_sample=4096),
    # implicit: run_all config 5 at 1M; fluid: the 1M dam break
    reach=dict(implicit=dict(n=1_000_000, dx=1.0 / 128, bins=9216,
                             blocks=8192, chunk=768),
               fluid=dict(n=1 << 20), cloth_nx=64, terrain_res=32),
    cards=dict(n=1 << 20, dx=1.0 / 128, blocks=8192, steps=5,
               nb_local=2048, mig_cap=16384),
)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu():
    """Exit nonzero unless JAX's first device is a GPU.  Never falls back."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform is "
                 f"{dev.platform!r}); this script runs only on the card")
    return dev


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes():
    import jax
    stats = jax.local_devices()[0].memory_stats()
    return "n/a" if not stats else stats.get("peak_bytes_in_use", "n/a")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def compile_fn(fn, *args):
    """AOT-compile ``jax.jit(fn)`` for ``args``: (compiled, seconds)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def warm_ms(compiled, *args, reps=3):
    """(output, best warm wall-ms) of ``compiled(*args)``."""
    import jax
    out = jax.block_until_ready(compiled(*args))          # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def report_error(phase, name, err, limit):
    say(phase, f"  {name} = {err:.3e} (limit {limit:.0e})")
    check(np.isfinite(err) and err <= limit,
          f"{phase}: {name} {err:.3e} exceeds {limit:.0e}")


# ---------------------------------------------------------------------------
# phase mpm
# ---------------------------------------------------------------------------

def _binned_run(n, dx, bins, blocks, chunk, steps, label):
    """Build the elastic-block scene and run the binned2 adaptive chain.

    Returns (sim, initial MPMState, dt, final BinState, grid BinState).
    The grid BinState holds a P2G result for the mass check: the final
    state itself, or one step further when the chain ended on a rebin
    (which rebuilds an empty grid)."""
    import jax
    import jax.numpy as jnp
    from examples.mpm_block import build
    from zpc_tpu.sim.mpm_binned2 import (BinnedConfig2, adaptive_chain,
                                         bin_state, explicit_step_binned2,
                                         rebin_adaptive)

    sim, st, dt = build(n, dx=dx, block_capacity=blocks)
    dtj = jnp.float32(dt)
    cfg = BinnedConfig2(bins_capacity=bins, block_capacity=blocks,
                        chunk_bins=chunk)
    bst = jax.jit(lambda s: bin_state(sim, s, cfg))(st)

    def chain(s):
        return adaptive_chain(
            lambda t: explicit_step_binned2(sim, t, dtj, cfg, rebin=False),
            lambda t: rebin_adaptive(sim, t, cfg), s, steps)

    compiled, secs = compile_fn(chain, bst)
    out, ms = warm_ms(compiled, bst)
    say("mpm", f"{label}: n={n} dx=1/{round(1 / dx)} steps={steps} "
               f"compile {secs:.1f} s, {ms / steps:.3f} ms/step, "
               f"peak_bytes_in_use {peak_bytes()}")
    check(not bool(out.overflow), f"mpm: {label} bin overflow")
    check(bool(jnp.all(jnp.isfinite(out.cols))), f"mpm: {label} non-finite")
    gst = out
    if not float(jnp.sum(out.grid.data["m"])) > 0.0:
        gst = jax.jit(lambda s: explicit_step_binned2(
            sim, s, dtj, cfg, rebin=False))(out)
        say("mpm", f"{label}: the chain ended on a rebin; one more step "
                   "fills the grid for the mass check")
    return sim, st, dt, out, gst


def _mass_errors(st, bst):
    """Relative errors of (particle mass after the run vs before, grid mass
    of the last P2G vs particle mass)."""
    m0 = np.asarray(st.particles["m"], np.float64)[:st.particles.size].sum()
    alive = np.asarray(bst.pid) >= 0
    m_p = np.asarray(bst.cols[:, 24], np.float64)[alive].sum()
    m_g = np.asarray(bst.grid.data["m"], np.float64).sum()
    return abs(m_p - m0) / m0, abs(m_g - m_p) / m_p


def _report_mass(st, bst, label):
    e_p, e_g = _mass_errors(st, bst)
    report_error("mpm", f"{label}relative particle-mass change", e_p,
                 TOL_MASS)
    report_error("mpm", f"{label}relative grid-mass error", e_g, TOL_MASS)


def phase_mpm(n, dx, bins, blocks, chunk, steps, n_big, dx_big, bins_big,
              blocks_big, chunk_big, steps_big):
    import jax
    import jax.numpy as jnp
    from zpc_tpu.sim.mpm import explicit_step
    from zpc_tpu.sim.mpm_binned2 import unbin_state

    sim, st, dt, bst, gst = _binned_run(n, dx, bins, blocks, chunk, steps,
                                        "binned2 adaptive chain")
    got = jax.jit(unbin_state)(bst, st).particles

    dtj = jnp.float32(dt)

    def ref_chain(s):
        return jax.lax.fori_loop(
            0, steps, lambda i, t: explicit_step(sim, t, dtj), s)

    # the reference runs with full float32 products (no TF32)
    with jax.default_matmul_precision("highest"):
        rc, secs = compile_fn(ref_chain, st)
        ref, ms = warm_ms(rc, st)
    say("mpm", f"reference explicit_step: compile {secs:.1f} s, "
               f"{ms / steps:.3f} ms/step, peak_bytes_in_use {peak_bytes()}")
    ref = ref.particles
    for key, tol in (("x", TOL_X), ("v", TOL_V), ("F", TOL_F)):
        err = float(jnp.max(jnp.abs(got[key] - ref[key])))
        report_error("mpm", f"max|{key} - {key}_ref| after {steps} steps",
                     err, tol)
    _report_mass(st, gst, "")
    del got, ref, bst, gst, st

    sim, st, dt, bst, gst = _binned_run(
        n_big, dx_big, bins_big, blocks_big, chunk_big, steps_big,
        "binned2 adaptive chain (large)")
    _report_mass(st, gst, "large: ")
    alive = np.asarray(bst.pid) >= 0
    cols = np.asarray(bst.cols, np.float64)[alive]
    m = cols[:, 24]
    p = (m[:, None] * cols[:, 3:6]).sum(0)     # initial momentum is zero
    g = np.asarray(sim.gravity, np.float64)
    want = m.sum() * g * steps_big * dt
    scale = np.linalg.norm(want)
    report_error("mpm", f"free-fall momentum error / |M g t| "
                        f"({steps_big} steps)",
                 float(np.max(np.abs(p - want)) / scale), TOL_MOMENTUM)


# ---------------------------------------------------------------------------
# phase prims
# ---------------------------------------------------------------------------

def _np_scan(x, op, exclusive):
    wide = {np.dtype(np.int32): np.int64, np.dtype(np.uint32): np.uint64,
            np.dtype(np.float32): np.float64}[x.dtype]
    xw = x.astype(wide)
    if op == "add":
        inc, ident = np.cumsum(xw), 0
    elif op == "max":
        inc = np.maximum.accumulate(xw)
        ident = (-np.inf if x.dtype.kind == "f" else np.iinfo(x.dtype).min)
    else:
        inc = np.minimum.accumulate(xw)
        ident = (np.inf if x.dtype.kind == "f" else np.iinfo(x.dtype).max)
    if not exclusive:
        return inc
    return np.concatenate([np.asarray([ident], wide), inc[:-1]])


def phase_prims(n):
    import jax.numpy as jnp
    from benchmarks.measure import chained_ms
    from zpc_tpu import (exclusive_scan, inclusive_scan, jit_exec, sort,
                         sort_pair)

    pol = jit_exec()
    rng = np.random.default_rng(0)
    data = {
        # partial sums stay inside each type's range (exact integer refs)
        np.int32: rng.integers(-100, 100, n).astype(np.int32),
        np.uint32: rng.integers(0, 200, n).astype(np.uint32),
        np.float32: rng.standard_normal(n).astype(np.float32),
    }
    t0 = time.perf_counter()
    for dt, x in data.items():
        xd = jnp.asarray(x)
        s_abs = np.cumsum(np.abs(x.astype(np.float64)))
        for op in ("add", "max", "min"):
            for exclusive in (False, True):
                fn = exclusive_scan if exclusive else inclusive_scan
                got = np.asarray(fn(pol, xd, op))
                want = _np_scan(x, op, exclusive)
                name = (f"{'exclusive' if exclusive else 'inclusive'}_scan "
                        f"{op} {np.dtype(dt).name}")
                if dt is np.float32 and op == "add":
                    bound = TOL_SCAN_F32 * (
                        np.concatenate([[0.0], s_abs[:-1]]) if exclusive
                        else s_abs)
                    ratio = float(np.max(np.abs(got - want)
                                         / np.maximum(bound, 1e-30)))
                    report_error("prims", f"{name}: max |err| / "
                                 "(2^-16 running |x| sum)", ratio, 1.0)
                else:
                    check(np.array_equal(got.astype(want.dtype), want),
                          f"prims: {name} differs from numpy")
                    say("prims", f"  {name}: exact")
    keys = rng.integers(0, 1 << 30, n).astype(np.int32)
    check(np.array_equal(np.asarray(sort(pol, jnp.asarray(keys))),
                         np.sort(keys)), "prims: sort int32")
    fk = data[np.float32]
    check(np.array_equal(np.asarray(sort(pol, jnp.asarray(fk))),
                         np.sort(fk)), "prims: sort float32")
    vals = np.arange(n, dtype=np.int32)
    for kb, vb in ((None, None), (1 << 7, n)):
        k = keys if kb is None else keys % kb
        ko, vo = sort_pair(pol, jnp.asarray(k), jnp.asarray(vals),
                           key_bound=kb, val_bound=vb)
        ko, vo = np.asarray(ko), np.asarray(vo)
        check(np.array_equal(ko, np.sort(k)), "prims: sort_pair keys")
        check(np.array_equal(np.sort(vo), vals), "prims: sort_pair perm")
        check(np.array_equal(k[vo], ko), "prims: sort_pair pairing")
    say("prims", f"  sort int32/float32, sort_pair (plain, packed): exact")
    say("prims", f"checks at n={n}: {time.perf_counter() - t0:.1f} s "
                 f"(compiles included)")

    # timing: 16M scans beside a 16M elementwise read+write (copy bound)
    xf = jnp.asarray(data[np.float32])
    xi = jnp.asarray(data[np.int32])
    bodies = {"copy (x + c)": lambda x: x + jnp.asarray(1, x.dtype)}
    for op in ("add", "max", "min"):
        bodies[f"inclusive_scan {op}"] = (
            lambda x, _o=op: inclusive_scan(pol, x, _o))
        bodies[f"exclusive_scan {op}"] = (
            lambda x, _o=op: exclusive_scan(pol, x, _o))
    for name, f in bodies.items():
        for x in (xi, xf):
            def body(i, c, _f=f):
                return c + (_f(c) >> 31 if c.dtype == jnp.int32
                            else _f(c) * jnp.float32(1e-37))
            ms = chained_ms(body, x, iters=20, reps=3)
            say("prims", f"  {name} {x.dtype} n={n}: {ms:.4f} ms "
                         f"({2 * n * 4 / (ms / 1e3) / 1e9:.0f} GB/s r+w)")
    say("prims", f"peak_bytes_in_use {peak_bytes()}")


# ---------------------------------------------------------------------------
# phase lbvh
# ---------------------------------------------------------------------------

def phase_lbvh(n, n_sample):
    import jax.numpy as jnp
    from benchmarks.measure import chained_ms, dep_scalar
    from zpc_tpu.containers.bvh import (_karras_topology, build_lbvh,
                                        query_overlaps_exact)

    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = np.float32(0.002)
    lo, hi = jnp.asarray(c - h), jnp.asarray(c + h)
    compiled, secs = compile_fn(build_lbvh, lo, hi)
    bvh, ms = warm_ms(compiled, lo, hi)
    say("lbvh", f"build_lbvh n={n}: compile {secs:.1f} s, {ms:.3f} ms, "
                f"peak_bytes_in_use {peak_bytes()}")

    def topo(i, cc):
        lft, rgt, rl, rh = _karras_topology(cc)
        eps = (dep_scalar(lft) + dep_scalar(rgt) + dep_scalar(rl)
               + dep_scalar(rh)).astype(jnp.int32)
        return cc + eps

    ms = chained_ms(topo, bvh.codes, iters=4, reps=3)
    say("lbvh", f"_karras_topology n={n}: {ms:.3f} ms")

    r = jnp.float32(0.006)          # query half extent (prim 0.002 + pad)
    pts = jnp.asarray(c)

    # a residue budget of nq cannot overflow: every out-of-band query is
    # answered by the walk, so the counts are exact whatever the band does
    def query(b, p):
        return query_overlaps_exact(b, p, p, 16, tile=128, group=512,
                                    cells=8, residue_budget=n,
                                    uniform_extent=r)[2:]

    compiled, secs = compile_fn(query, bvh, pts)
    (cnt, ovf), ms = warm_ms(compiled, bvh, pts)
    say("lbvh", f"query_overlaps_exact nq={n} residue_budget={n}: "
                f"compile {secs:.1f} s, {ms:.3f} ms, "
                f"peak_bytes_in_use {peak_bytes()}")
    check(not bool(ovf), "lbvh: residue budget overflowed")

    # brute force on the host, in the same float32 arithmetic: an exact
    # x-interval prefilter on the x-sorted boxes, then all three axes
    sample = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    rf = np.float32(r)
    lo_h, hi_h = np.asarray(lo), np.asarray(hi)
    order = np.argsort(lo_h[:, 0], kind="stable")
    lo_s, hi_s = lo_h[order], hi_h[order]
    span = np.float32(np.max(hi_h[:, 0] - lo_h[:, 0]))
    want = np.empty(len(sample), np.int64)
    for k, q in enumerate(c[sample]):
        q_lo, q_hi = q - rf, q + rf
        a = np.searchsorted(lo_s[:, 0], q_lo[0] - span, side="left")
        b = np.searchsorted(lo_s[:, 0], q_hi[0], side="right")
        want[k] = np.sum(np.all((q_lo <= hi_s[a:b]) & (lo_s[a:b] <= q_hi),
                                axis=1))
    got = np.asarray(cnt)[sample]
    check(np.array_equal(got, want),
          f"lbvh: {int(np.sum(got != want))} of {len(sample)} sampled "
          "counts differ from brute force")
    say("lbvh", f"  exact counts == brute force on {len(sample)} queries "
                f"(mean {want.mean():.2f} overlaps)")


# ---------------------------------------------------------------------------
# phase reach
# ---------------------------------------------------------------------------

def phase_reach(implicit, fluid, cloth_nx, terrain_res):
    """``fluid`` may override the scene's ``bins``/``chunk`` capacities."""
    import jax
    import jax.numpy as jnp
    from benchmarks.run_all import (CLOTH_MAX_CAND, cloth_scene,
                                    fluid_scene, terrain_mesh)
    from examples.mpm_block import build
    from zpc_tpu.sim.cloth import ContactWindow, implicit_step
    from zpc_tpu.sim.contact_implicit import MeshContact
    from zpc_tpu.sim.fluid_binned2 import (bin_fluid_state,
                                           explicit_fluid_step_binned2)
    from zpc_tpu.sim.implicit_binned2 import implicit_step_binned2
    from zpc_tpu.sim.mpm_binned2 import BinnedConfig2, bin_state

    def finite(tree):
        return all(bool(jnp.all(jnp.isfinite(a)))
                   for a in jax.tree.leaves(tree)
                   if jnp.issubdtype(a.dtype, jnp.floating))

    ni = implicit["n"]
    sim, st, _ = build(ni, dx=implicit["dx"],
                       block_capacity=implicit["blocks"])
    cfg = BinnedConfig2(bins_capacity=implicit["bins"],
                        block_capacity=implicit["blocks"],
                        chunk_bins=implicit["chunk"])
    bst = jax.jit(lambda s: bin_state(sim, s, cfg))(st)
    mc = MeshContact.build(terrain_mesh(res=terrain_res), dhat=0.01,
                           kappa=10.0, max_tris=8)

    check(not bool(bst.overflow), "reach: implicit bin overflow")
    for contact in (None, mc):
        def implicit(s, _c=contact):
            return implicit_step_binned2(sim, s, jnp.float32(5e-4), cfg,
                                         cg_iters=50, cg_tol=1e-3,
                                         contact=_c, rebin=False,
                                         with_stats=True)

        compiled, secs = compile_fn(implicit, bst)
        (out, iters), ms = warm_ms(compiled, bst)
        what = ("" if contact is None
                else f" + mesh contact ({mc.tri.shape[0]} tris)")
        say("reach", f"implicit MPM{what} n={ni}: compile {secs:.1f} s, "
                     f"{ms:.3f} ms/step, {int(iters)} CG iters, overflow "
                     f"{bool(out.overflow)}, peak_bytes_in_use "
                     f"{peak_bytes()}")
        check(finite(out.cols), "reach: implicit non-finite")
        if contact is None:
            check(not bool(out.overflow), "reach: implicit overflow")
        # with contact the flag also carries the mesh broad phase's
        # out-of-band verdict, which this scene raises on every backend
        # (the per-bin windows are too large for the plain banded join);
        # reported above, not asserted
    del bst, out, st

    sim, st, cfg = fluid_scene(fluid["n"])
    if "bins" in fluid:
        cfg = dataclasses.replace(cfg, bins_capacity=fluid["bins"],
                                  chunk_bins=fluid["chunk"])
    bst = jax.jit(lambda s: bin_fluid_state(sim, s, cfg))(st)
    compiled, secs = compile_fn(
        lambda s: explicit_fluid_step_binned2(sim, s, jnp.float32(2e-4),
                                              cfg, rebin=False), bst)
    out, ms = warm_ms(compiled, bst)
    say("reach", f"fluid dam break n={fluid['n']}: compile {secs:.1f} s, "
                 f"{ms:.3f} ms/step, peak_bytes_in_use {peak_bytes()}")
    check(not bool(out.overflow), "reach: fluid overflow")
    check(finite(out.cols), "reach: fluid non-finite")
    del bst, out, st

    sim, x0 = cloth_scene(cloth_nx)
    cw = ContactWindow(radius=1, max_residue=1024)

    def cloth(x, v):
        return implicit_step(sim, x, v, jnp.float32(0.005), newton_iters=2,
                             cg_iters=24, self_contact=True,
                             max_cand=CLOTH_MAX_CAND, contact_window=cw)

    v0 = jnp.zeros_like(x0)
    compiled, secs = compile_fn(cloth, x0, v0)
    (x, v, ovf), ms = warm_ms(compiled, x0, v0)
    say("reach", f"cloth two-layer nv={x0.shape[0]}: compile {secs:.1f} s, "
                 f"{ms:.3f} ms/step, peak_bytes_in_use {peak_bytes()}")
    check(not bool(ovf), "reach: cloth contact overflow")
    check(finite((x, v)), "reach: cloth non-finite")


# ---------------------------------------------------------------------------
# --cards: the multi-card tiers against one card
# ---------------------------------------------------------------------------

def phase_cards(n_cards, n, dx, blocks, steps, nb_local, mig_cap):
    import jax
    import jax.numpy as jnp
    from examples.mpm_block import build
    from zpc_tpu.parallel.mesh import make_mesh
    from zpc_tpu.sim.distributed import explicit_step_sharded, shard_state
    from zpc_tpu.sim.domain_decomp import (explicit_step_dd,
                                           gather_dd_particles,
                                           make_dd_state)
    from zpc_tpu.sim.mpm import explicit_step

    devs = jax.devices()
    check(len(devs) >= n_cards, f"cards: need {n_cards} devices, "
                                f"found {len(devs)}")
    mesh = make_mesh(n_cards)
    sim, st, dt = build(n, dx=dx, block_capacity=blocks)
    dtj = jnp.float32(dt)

    def chain(step):
        return lambda s: jax.lax.fori_loop(0, steps, lambda i, t: step(t), s)

    with jax.default_matmul_precision("highest"):
        st1 = jax.device_put(st, devs[0])
        rc, secs = compile_fn(chain(lambda t: explicit_step(sim, t, dtj)),
                              st1)
        ref, ms = warm_ms(rc, st1)
        say("cards", f"one card explicit_step n={n}: compile {secs:.1f} s,"
                     f" {ms / steps:.3f} ms/step")
        ref = {k: np.asarray(ref.particles[k]) for k in ("x", "v", "F")}

        sst = shard_state(st, mesh)
        sc, secs = compile_fn(
            chain(lambda t: explicit_step_sharded(sim, t, dtj, mesh)), sst)
        out, ms = warm_ms(sc, sst)
        say("cards", f"explicit_step_sharded {n_cards} cards: compile "
                     f"{secs:.1f} s, {ms / steps:.3f} ms/step")
        for key, tol in (("x", TOL_X), ("v", TOL_V), ("F", TOL_F)):
            err = float(np.max(np.abs(np.asarray(out.particles[key])
                                      - ref[key])))
            report_error("cards", f"sharded max|{key} - {key}_ref| after "
                                  f"{steps} steps", err, tol)
        del out, sst

        dds = make_dd_state(st, mesh)

        def dd_chain(s):
            def body(i, c):
                t, ov = c
                t, o = explicit_step_dd(sim, t, dtj, mesh,
                                        grid_template=st.grid,
                                        nb_local=nb_local, mig_cap=mig_cap)
                return t, ov | o
            return jax.lax.fori_loop(0, steps, body, (s, jnp.bool_(False)))

        dc, secs = compile_fn(dd_chain, dds)
        (out, ovf), ms = warm_ms(dc, dds)
        say("cards", f"explicit_step_dd {n_cards} cards: compile "
                     f"{secs:.1f} s, {ms / steps:.3f} ms/step")
        check(not bool(ovf), "cards: domain-decomposed step overflowed")
        got = gather_dd_particles(out, n)
        for key, tol in (("x", TOL_X), ("v", TOL_V), ("F", TOL_F)):
            err = float(np.max(np.abs(got[key] - ref[key][:n])))
            report_error("cards", f"dd max|{key} - {key}_ref| after "
                                  f"{steps} steps", err, tol)
    say("cards", f"peak_bytes_in_use (card 0) {peak_bytes()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card tiers on 4 cards")
    args = ap.parse_args(argv)
    dev = require_gpu()

    import jax
    from zpc_tpu.utils.compile_cache import enable_compile_cache
    print(card_info(), flush=True)
    print(f"device_kind={dev.device_kind} jax={jax.__version__} "
          f"devices={len(jax.devices())} "
          f"compile_cache={enable_compile_cache()}", flush=True)
    if args.cards == 4:
        phases = [("cards", lambda: phase_cards(4, **FULL["cards"]))]
    else:
        phases = [(name, (lambda f=fn, k=name: f(**FULL[k])))
                  for name, fn in (("mpm", phase_mpm),
                                   ("prims", phase_prims),
                                   ("lbvh", phase_lbvh),
                                   ("reach", phase_reach))]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        say(name, f"ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
