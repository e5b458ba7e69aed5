"""Bit tricks: morton codes, clz, power-of-two helpers.

Reference: ``math/bit/Bits.h`` (morton interleave, ``count_leading_zeros``,
``next_2pow``), consumed by the LBVH builder (container/Bvh.hpp:184,346).

Note: int32 throughout; 30-bit 3-D morton (10 bits/axis)
and 32-bit 2-D morton (16 bits/axis).  ``clz`` is computed arithmetically
(no hardware intrinsic surface in XLA: use floor(log2)).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _u32(c):
    return jnp.asarray(np.uint32(c), jnp.uint32)

__all__ = ["expand_bits_3d", "morton3d", "morton2d", "clz32",
           "common_prefix_length", "next_pow2"]


def expand_bits_3d(v):
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (the classic magic-number dilation)."""
    v = v.astype(jnp.uint32) & _u32(0x3FF)
    v = (v * _u32(0x00010001)) & _u32(0xFF0000FF)
    v = (v * _u32(0x00000101)) & _u32(0x0F00F00F)
    v = (v * _u32(0x00000011)) & _u32(0xC30C30C3)
    v = (v * _u32(0x00000005)) & _u32(0x49249249)
    return v


def morton3d(q):
    """30-bit morton code from integer coords ``[..., 3]`` in [0, 1024)."""
    x = expand_bits_3d(q[..., 0])
    y = expand_bits_3d(q[..., 1])
    z = expand_bits_3d(q[..., 2])
    return ((x << 2) | (y << 1) | z).astype(jnp.int32)


def _expand_bits_2d(v):
    v = v.astype(jnp.uint32) & _u32(0xFFFF)
    v = (v | (v << 8)) & _u32(0x00FF00FF)
    v = (v | (v << 4)) & _u32(0x0F0F0F0F)
    v = (v | (v << 2)) & _u32(0x33333333)
    v = (v | (v << 1)) & _u32(0x55555555)
    return v


def morton2d(q):
    """32-bit morton code from integer coords ``[..., 2]`` in [0, 65536)."""
    x = _expand_bits_2d(q[..., 0])
    y = _expand_bits_2d(q[..., 1])
    return ((x << 1) | y).astype(jnp.int32)


def clz32(x):
    """Count leading zeros of uint32 (Bits.h ``count_leading_zeros``).

    Arithmetic formulation: 31 - floor(log2(x)), with clz(0) = 32.
    """
    x = x.astype(jnp.uint32)
    # smear bits right then popcount
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    # popcount via bit tricks
    v = x - ((x >> 1) & _u32(0x55555555))
    v = (v & _u32(0x33333333)) + ((v >> 2) & _u32(0x33333333))
    v = (((v + (v >> 4)) & _u32(0x0F0F0F0F)) * _u32(0x01010101)) >> 24
    return (32 - v).astype(jnp.int32)


def common_prefix_length(a, b):
    """Length of the common binary prefix of two int32 keys (the Karras
    ``delta`` function, Bvh.hpp:346)."""
    return clz32(jnp.bitwise_xor(a.astype(jnp.uint32), b.astype(jnp.uint32)))


def next_pow2(x):
    """Smallest power of two >= x (Bits.h ``next_2pow``)."""
    x = jnp.maximum(x.astype(jnp.uint32), 1) - 1
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return (x + 1).astype(jnp.int32)
