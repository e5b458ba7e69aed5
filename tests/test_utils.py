"""IO + graph algorithm tests (reference §2.9 parity)."""

import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest

from zpc_tpu.math.sparse import csr_from_coo
from zpc_tpu.utils import io as zio
from zpc_tpu.utils.graph import connected_components, greedy_color, max_flow


class TestMeshIO:
    def test_obj_roundtrip(self, rng, tmp_path):
        v = rng.standard_normal((10, 3)).astype(np.float32)
        f = np.asarray([[0, 1, 2], [2, 3, 4]], np.int32)
        p = str(tmp_path / "m.obj")
        zio.write_obj(p, v, f)
        v2, f2 = zio.read_obj(p)
        np.testing.assert_allclose(v2, v, rtol=1e-5)
        np.testing.assert_array_equal(f2, f)

    def test_obj_quad_triangulation(self, tmp_path):
        p = str(tmp_path / "q.obj")
        with open(p, "w") as f:
            f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
        _, faces = zio.read_obj(p)
        assert faces.shape == (2, 3)

    def test_vtk_roundtrip(self, rng, tmp_path):
        v = rng.standard_normal((8, 3)).astype(np.float32)
        t = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
        p = str(tmp_path / "m.vtk")
        zio.write_vtk_tets(p, v, t)
        v2, t2 = zio.read_vtk_tets(p)
        np.testing.assert_allclose(v2, v, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t2, t)

    def test_bgeo_roundtrip(self, rng, tmp_path):
        pos = rng.standard_normal((100, 3)).astype(np.float32)
        vel = rng.standard_normal((100, 3)).astype(np.float32)
        m = rng.uniform(1, 2, (100, 1)).astype(np.float32)
        p = str(tmp_path / "p.bgeo")
        zio.write_bgeo(p, pos, {"v": vel, "mass": m})
        pos2, attrs = zio.read_bgeo(p)
        np.testing.assert_allclose(pos2, pos, rtol=1e-6)
        np.testing.assert_allclose(attrs["v"], vel, rtol=1e-6)
        np.testing.assert_allclose(attrs["mass"], m, rtol=1e-6)

    def test_async_io(self, rng, tmp_path):
        pos = rng.standard_normal((50, 3)).astype(np.float32)
        p = str(tmp_path / "async.bgeo")
        w = zio.AsyncIO.instance()
        w.submit(zio.write_bgeo, p, pos)
        w.wait()
        pos2, _ = zio.read_bgeo(p)
        np.testing.assert_allclose(pos2, pos, rtol=1e-6)

    def test_state_checkpoint(self, rng, tmp_path):
        from zpc_tpu.sim.mpm import make_mpm_state
        x = jnp.asarray(rng.uniform(0, 1, (64, 3)), jnp.float32)
        st = make_mpm_state(x, dx=0.1, block_capacity=64)
        p = str(tmp_path / "ckpt.npz")
        zio.save_state(p, st)
        st2 = zio.load_state(p, st)
        np.testing.assert_array_equal(np.asarray(st2.particles["x"]),
                                      np.asarray(st.particles["x"]))
        assert st2.particles.size == st.particles.size


class TestGraph:
    def _sym_csr(self, edges, n):
        e = np.asarray(edges + [(b, a) for a, b in edges], np.int32)
        v = np.ones(len(e), np.float32)
        return csr_from_coo(jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]),
                            jnp.asarray(v), n, n)

    def test_connected_components(self):
        # two components: {0,1,2,3}, {4,5}; isolated {6}
        A = self._sym_csr([(0, 1), (1, 2), (2, 3), (4, 5)], 7)
        L = np.asarray(connected_components(A))
        assert L[0] == L[1] == L[2] == L[3]
        assert L[4] == L[5]
        assert L[0] != L[4] != L[6]

    def test_components_chain(self):
        n = 64
        A = self._sym_csr([(i, i + 1) for i in range(n - 1)], n)
        L = np.asarray(connected_components(A))
        assert (L == L[0]).all()

    def test_coloring_proper(self, rng):
        n = 50
        edges = [(int(a), int(b)) for a, b in
                 rng.integers(0, n, (150, 2)) if a != b]
        A = self._sym_csr(edges, n)
        colors = np.asarray(greedy_color(A))
        assert (colors >= 0).all()
        for a, b in edges:
            assert colors[a] != colors[b]

    def test_max_flow_simple(self):
        # s=0 -> 1 (cap 3), 0 -> 2 (cap 2), 1 -> 3 (cap 2), 2 -> 3 (cap 3)
        rows = jnp.asarray([0, 0, 1, 2], jnp.int32)
        cols = jnp.asarray([1, 2, 3, 3], jnp.int32)
        caps = jnp.asarray([3.0, 2.0, 2.0, 3.0], jnp.float32)
        A = csr_from_coo(rows, cols, caps, 4, 4)
        f = float(max_flow(A, 0, 3))
        assert abs(f - 4.0) < 1e-5

    def test_max_flow_bottleneck(self):
        # path 0->1->2 with caps 5, 1 => flow 1
        rows = jnp.asarray([0, 1], jnp.int32)
        cols = jnp.asarray([1, 2], jnp.int32)
        caps = jnp.asarray([5.0, 1.0], jnp.float32)
        A = csr_from_coo(rows, cols, caps, 3, 3)
        assert abs(float(max_flow(A, 0, 2)) - 1.0) < 1e-5


class TestCompileCache:
    @pytest.mark.parametrize("env_dir", [True, False])
    def test_cache_dir(self, env_dir, tmp_path, monkeypatch):
        """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; unset, the
        cache goes to <checkout>/.jax_cache."""
        import jax
        from zpc_tpu.utils.compile_cache import (CHECKOUT_CACHE_DIR,
                                                 enable_compile_cache)
        before = jax.config.jax_compilation_cache_dir
        try:
            if env_dir:
                monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                                   str(tmp_path))
                assert enable_compile_cache() == str(tmp_path)
                assert jax.config.jax_compilation_cache_dir == before
            else:
                monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR",
                                   raising=False)
                repo = os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))
                assert CHECKOUT_CACHE_DIR == os.path.join(repo,
                                                          ".jax_cache")
                assert enable_compile_cache() == CHECKOUT_CACHE_DIR
                assert (jax.config.jax_compilation_cache_dir
                        == CHECKOUT_CACHE_DIR)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
