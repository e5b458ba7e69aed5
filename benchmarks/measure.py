"""Device timing of chained iterations.

``chained_ms`` runs ``iters`` data-dependent applications of a body
inside one jitted ``fori_loop``, waits for the result with
``block_until_ready`` and reports the median per-iteration wall time
over warm reps; compilation and the first (warm-up) call are excluded.
Chain dependences must pass through ``abs``-sums (:func:`dep_scalar`) or
carry the full state: XLA folds and narrows naive timing loops (scalar
dependences sliced back through matmuls, bilinear forms factorized
through plain sums).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["chained_ms", "dep_scalar"]


def dep_scalar(x) -> jax.Array:
    """Fold an array into a chain-dependence scalar XLA cannot narrow or
    factorize (abs blocks bilinear factorization; sum needs all lanes)."""
    return 1e-30 * jnp.sum(jnp.abs(x))


def chained_ms(body, x0, iters=20, reps=4, const=None, label=None):
    """Median wall-ms of one ``body`` application over a data-dependent
    chain of ``iters`` applications.

    ``body(i, carry[, const])`` -> carry.  ``const`` rides as a jit
    argument so large workspaces are not baked into the program as
    constants.
    """
    if const is None:
        f = jax.jit(lambda x: jax.lax.fori_loop(0, iters, body, x))
        call = f
    else:
        f = jax.jit(lambda c, x: jax.lax.fori_loop(
            0, iters, lambda i, xx: body(i, xx, c), x))
        call = lambda x: f(const, x)

    x = jax.block_until_ready(call(x0))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = jax.block_until_ready(call(x))
        times.append((time.perf_counter() - t0) / iters)
    ms = float(np.median(times)) * 1e3
    if label:
        print(f"{label:46s} {ms:8.3f} ms", flush=True)
    return ms
