"""Executor policy tests (reference ExecutionPolicy interface semantics)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import zpc_tpu as z


class TestExecutor:
    def test_fluent_settings_are_value_semantic(self):
        a = z.jit_exec()
        b = a.profile(True).sync(True)
        assert not a.profile_flag and b.profile_flag
        assert not a.sync_flag and b.sync_flag
        c = b.check(True)
        assert c.check_flag and not b.check_flag

    def test_seq_is_oracle_policy(self):
        s = z.seq_exec()
        assert s.is_sequential and s.check_flag

    def test_run_jit_vs_interp_agree(self, rng):
        x = jnp.asarray(rng.standard_normal(128), jnp.float32)

        def f(a):
            return jnp.sum(a * a)

        r1 = z.jit_exec().run(f, x)
        r2 = z.seq_exec().run(f, x)
        np.testing.assert_allclose(float(r1), float(r2), rtol=1e-6)

    def test_foreach(self):
        pol = z.jit_exec()
        out = pol.foreach(lambda i: i * i, 10)
        np.testing.assert_array_equal(np.asarray(out),
                                      np.arange(10) ** 2)

    def test_map(self, rng):
        x = jnp.asarray(rng.standard_normal((64, 3)), jnp.float32)
        out = z.jit_exec().map(lambda v: jnp.sum(v * v), x)
        np.testing.assert_allclose(np.asarray(out),
                                   (np.asarray(x) ** 2).sum(1), rtol=1e-5)

    def test_checkify_catches_oob(self):
        pol = z.jit_exec().check(True)

        def bad(a):
            return a[jnp.asarray(100)]   # out of bounds

        x = jnp.arange(8.0)
        with pytest.raises(Exception):
            pol.run(bad, x)

    def test_checkify_catches_nan(self):
        pol = z.jit_exec().check(True)

        def bad(a):
            return jnp.log(a - 10.0)  # negative -> nan

        with pytest.raises(Exception):
            pol.run(bad, jnp.arange(4.0))

    def test_profile_prints(self, capsys):
        pol = z.jit_exec().profile(True)
        pol.run(lambda x: x + 1, jnp.zeros(4), label="probe")
        out = capsys.readouterr().out
        assert "probe" in out and "ms" in out

    def test_scope_timer(self, capsys):
        pol = z.jit_exec().profile(True)
        with pol.scope("region"):
            pass
        assert "region" in capsys.readouterr().out

    def test_donation(self, rng):
        pol = z.jit_exec()
        f = pol.compile(lambda a: a * 2, donate_argnums=(0,))
        x = jnp.asarray(rng.standard_normal(8), jnp.float32)
        xs = np.asarray(x)
        y = f(x)
        np.testing.assert_allclose(np.asarray(y), xs * 2, rtol=1e-6)
