"""Random numbers, probability, and hashing utilities.

Reference: ``math/RandomNumber.hpp`` (per-thread xorshift/LCG generators),
``math/probability/`` (distribution sampling: PDF/CDF helpers), and
``math/Hash.hpp`` (``hash_combine``, invertible integer hash/unhash,
``universal_hash_base`` in py_interop/HashUtils.hpp:7-15).

Build: stateless counter-based randomness is the hardware-native model
— ``jax.random`` replaces per-thread generator state; this module adds the
reference's distribution helpers and the integer-hash family (used for
randomized algorithms like graph-coloring priorities and hash tables).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["hash_combine", "int_hash", "int_unhash", "universal_hash",
           "sample_uniform_sphere", "sample_uniform_ball",
           "sample_normal", "pdf_normal", "cdf_normal", "erf_inv",
           "sample_categorical"]


# -- integer hashing (math/Hash.hpp) ------------------------------------------

def _u(c):
    return jnp.asarray(np.uint32(c), jnp.uint32)


def hash_combine(seed, value):
    """boost-style hash_combine on uint32 lanes."""
    seed = seed.astype(jnp.uint32) if hasattr(seed, "astype") else \
        jnp.asarray(seed, jnp.uint32)
    v = jnp.asarray(value).astype(jnp.uint32)
    return seed ^ (v + _u(0x9E3779B9) + (seed << 6) + (seed >> 2))


def int_hash(x):
    """Invertible 32-bit mix (Hash.hpp ``hash``)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    x = ((x >> 16) ^ x) * _u(0x45D9F3B)
    x = ((x >> 16) ^ x) * _u(0x45D9F3B)
    x = (x >> 16) ^ x
    return x.astype(jnp.int32)


def int_unhash(x):
    """Inverse of :func:`int_hash` (Hash.hpp ``unhash``)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    x = ((x >> 16) ^ x) * _u(0x119DE1F3)
    x = ((x >> 16) ^ x) * _u(0x119DE1F3)
    x = (x >> 16) ^ x
    return x.astype(jnp.int32)


def universal_hash(x, a, b, m):
    """Carter-Wegman universal hash family (py_interop/HashUtils.hpp)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    return (((jnp.asarray(a, jnp.uint32) * x + jnp.asarray(b, jnp.uint32))
             >> 1) % jnp.asarray(m, jnp.uint32)).astype(jnp.int32)


# -- distribution sampling (RandomNumber.hpp / probability) -------------------

def sample_uniform_sphere(key, shape=()):
    """Uniform on the unit sphere surface."""
    v = jax.random.normal(key, shape + (3,))
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True),
                           1e-12)


def sample_uniform_ball(key, shape=()):
    k1, k2 = jax.random.split(key)
    d = sample_uniform_sphere(k1, shape)
    r = jax.random.uniform(k2, shape + (1,)) ** (1.0 / 3.0)
    return d * r


def sample_normal(key, shape=(), mean=0.0, std=1.0):
    return mean + std * jax.random.normal(key, shape)


def pdf_normal(x, mean=0.0, std=1.0):
    z = (x - mean) / std
    return jnp.exp(-0.5 * z * z) / (std * jnp.sqrt(2.0 * jnp.pi))


def cdf_normal(x, mean=0.0, std=1.0):
    return 0.5 * (1.0 + jax.scipy.special.erf(
        (x - mean) / (std * jnp.sqrt(2.0))))


def erf_inv(x):
    return jax.scipy.special.erfinv(x)


def sample_categorical(key, probs, shape=()):
    """Inverse-CDF categorical sampling (probability helpers)."""
    cdf = jnp.cumsum(probs)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, shape)
    return jnp.searchsorted(cdf, u).astype(jnp.int32)
