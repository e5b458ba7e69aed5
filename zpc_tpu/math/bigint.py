"""Batched fixed-width exact integers + wide rationals (device-side).

Reference: ``include/zensim/math/Rational.hpp:86-360`` — an exact fraction
over int64 with Euclid-GCD normalization, used by the robust geometry /
CCD stack.  This module needs no int64 (x64 mode is process-wide in
JAX), and the reference's own
comment says "128 would be better"; here we go wider by construction:

* ``BigInt`` — sign-magnitude integers with ``L`` limbs of 12 bits each
  (radix 4096) stored in int32 lanes.  All ops are branch-free and
  jit-safe; the limb count is a static Python int, so adds/compares are
  unrolled at trace time.  Radix 2^12 keeps every intermediate of the
  schoolbook multiply convolution below 2^31 for L ≤ 32 (L·2^24 + carry).
* ``RationalW`` — exact fraction of two BigInts.  No normalization is
  needed for bounded-degree predicate work (width absorbs growth); an
  optional fixed-trip **binary** GCD (shift/subtract only — no division)
  is provided for long-running accumulation.

Default width L=16 → 192-bit magnitudes: exact for any product of two
int64-range values, which is strictly more than the reference's i64
``rational`` can represent without overflow UB.

Oracle tests compare against Python's unbounded ints / ``fractions``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BigInt", "bigint", "RationalW", "rational_w", "LIMB_BITS"]

LIMB_BITS = 12
_RADIX = 1 << LIMB_BITS
_MASK = _RADIX - 1
DEFAULT_LIMBS = 16  # 192 bits


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BigInt:
    """Sign-magnitude batched integer: ``sign`` in {-1,0,1} (int32,
    shape [...]), ``mag`` little-endian limbs (int32, shape [..., L],
    each in [0, 4096))."""

    sign: jax.Array
    mag: jax.Array

    # -- helpers -------------------------------------------------------
    @property
    def limbs(self) -> int:
        return self.mag.shape[-1]

    def _canon_sign(self) -> "BigInt":
        nz = jnp.any(self.mag != 0, axis=-1)
        return BigInt(jnp.where(nz, self.sign, 0), self.mag)

    # -- arithmetic ----------------------------------------------------
    def __neg__(self) -> "BigInt":
        return BigInt(-self.sign, self.mag)

    def __add__(self, o: "BigInt") -> "BigInt":
        ge = _mag_ge(self.mag, o.mag)
        same = self.sign == o.sign
        # same sign: add magnitudes; else subtract smaller from larger
        add_m = _mag_add(self.mag, o.mag)
        big = jnp.where(ge[..., None], self.mag, o.mag)
        small = jnp.where(ge[..., None], o.mag, self.mag)
        sub_m = _mag_sub(big, small)
        mag = jnp.where(same[..., None], add_m, sub_m)
        sgn = jnp.where(same, self.sign,
                        jnp.where(ge, self.sign, o.sign))
        return BigInt(sgn, mag)._canon_sign()

    def __sub__(self, o: "BigInt") -> "BigInt":
        return self + (-o)

    def __mul__(self, o: "BigInt") -> "BigInt":
        return BigInt(self.sign * o.sign,
                      _mag_mul(self.mag, o.mag))._canon_sign()

    def compare(self, o: "BigInt") -> jax.Array:
        """sign(self - o) as int32, exactly."""
        mc = _mag_cmp(self.mag, o.mag)  # compare |self| vs |o|
        s, t = self.sign, o.sign
        # different signs: sign order decides; same sign: magnitude order
        return jnp.where(s != t, jnp.sign(s - t),
                         jnp.where(s >= 0, mc, -mc)).astype(jnp.int32)

    def is_zero(self) -> jax.Array:
        return self.sign == 0

    def shift_right1(self) -> "BigInt":
        """Exact halving of the magnitude (floor for the magnitude)."""
        m = self.mag
        lo = jnp.concatenate(
            [m[..., 1:] & 1, jnp.zeros_like(m[..., :1])], axis=-1)
        return BigInt(self.sign,
                      (m >> 1) | (lo << (LIMB_BITS - 1)))._canon_sign()

    def shift_left1(self) -> "BigInt":
        m = self.mag
        hi = jnp.concatenate(
            [jnp.zeros_like(m[..., :1]), m[..., :-1] >> (LIMB_BITS - 1)],
            axis=-1)
        return BigInt(self.sign, ((m << 1) & _MASK) | hi)

    def is_even(self) -> jax.Array:
        return (self.mag[..., 0] & 1) == 0

    # -- conversion ----------------------------------------------------
    def to_float_scaled(self) -> Tuple[jax.Array, jax.Array]:
        """(mantissa, exponent) with value = mantissa * 2**exponent.

        The mantissa accumulates limbs relative to the top nonzero limb,
        so magnitudes beyond float32 range stay finite here (a plain
        float32 accumulation overflows to inf above ~2^128, well inside
        the default 192-bit width — advisor round-2 finding).  Limbs more
        than ~3 below the top underflow the float32 mantissa and drop
        out, matching float32 rounding."""
        k = jnp.arange(self.limbs, dtype=jnp.int32)
        nz = self.mag > 0
        top = jnp.max(jnp.where(nz, k, 0), axis=-1)
        shift = ((k - top[..., None]) * LIMB_BITS).astype(jnp.float32)
        # limbs above the top are zero; mask them so 0 * exp2(+shift)
        # cannot produce 0 * inf = nan
        scale = jnp.where(shift > 0, 0.0, jnp.exp2(shift))
        mant = jnp.sum(self.mag.astype(jnp.float32) * scale, axis=-1)
        return mant * self.sign.astype(jnp.float32), top * LIMB_BITS

    def to_float(self) -> jax.Array:
        """Approximate float32 value (top limbs dominate; exact when the
        value fits a float32 mantissa)."""
        mant, exp = self.to_float_scaled()
        return jnp.ldexp(mant, exp)

    def to_pyints(self):
        """Host: exact Python ints (flattened)."""
        sign = np.asarray(self.sign).ravel()
        mag = np.asarray(self.mag).reshape(-1, self.limbs)
        out = []
        for s, row in zip(sign, mag):
            v = 0
            for k in range(self.limbs - 1, -1, -1):
                v = (v << LIMB_BITS) + int(row[k])
            out.append(int(s) * v)
        return out


# -- magnitude kernels (unrolled over the static limb count) -----------

def _mag_add(a, b):
    L = a.shape[-1]
    digs = []
    carry = jnp.zeros(a.shape[:-1], jnp.int32)
    for k in range(L):
        t = a[..., k] + b[..., k] + carry
        digs.append(t & _MASK)
        carry = t >> LIMB_BITS
    # overflow past the top limb is truncated: widths must be chosen so
    # it cannot happen for the workload (see module docstring)
    return jnp.stack(digs, axis=-1)


def _mag_sub(a, b):
    """a - b elementwise magnitudes, requires a >= b."""
    L = a.shape[-1]
    digs = []
    borrow = jnp.zeros(a.shape[:-1], jnp.int32)
    for k in range(L):
        t = a[..., k] - b[..., k] - borrow
        borrow = (t < 0).astype(jnp.int32)
        digs.append(t + borrow * _RADIX)
    return jnp.stack(digs, axis=-1)


def _mag_cmp(a, b):
    """Lexicographic compare from the most significant limb: -1/0/+1."""
    L = a.shape[-1]
    res = jnp.zeros(a.shape[:-1], jnp.int32)
    for k in range(L - 1, -1, -1):
        c = jnp.sign(a[..., k] - b[..., k]).astype(jnp.int32)
        res = jnp.where(res == 0, c, res)
    return res


def _mag_ge(a, b):
    return _mag_cmp(a, b) >= 0


def _mag_mul(a, b):
    """Schoolbook convolution, truncated to L limbs.  Each partial sum is
    ≤ L·(2^12-1)^2 + carry < 2^31 for L ≤ 32."""
    L = a.shape[-1]
    cols = [jnp.zeros(a.shape[:-1], jnp.int32) for _ in range(L)]
    for i in range(L):
        ai = a[..., i]
        for j in range(L - i):
            cols[i + j] = cols[i + j] + ai * b[..., j]
    digs = []
    carry = jnp.zeros(a.shape[:-1], jnp.int32)
    for k in range(L):
        t = cols[k] + carry
        digs.append(t & _MASK)
        carry = t >> LIMB_BITS
    return jnp.stack(digs, axis=-1)


def bigint(x, limbs: int = DEFAULT_LIMBS) -> BigInt:
    """Build from int32/int64-ish array values (device, branch-free) or
    from a host list of arbitrary Python ints."""
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], int):
        sign = np.sign(x).astype(np.int32)
        mags = np.zeros((len(x), limbs), np.int32)
        for r, v in enumerate(x):
            v = abs(int(v))
            for k in range(limbs):
                mags[r, k] = v & _MASK
                v >>= LIMB_BITS
            if v:
                raise OverflowError("value does not fit limb width")
        return BigInt(jnp.asarray(sign), jnp.asarray(mags))
    x = jnp.asarray(x)
    sign = jnp.sign(x).astype(jnp.int32)
    v = jnp.abs(x)
    digs = []
    for _ in range(limbs):
        digs.append((v & _MASK).astype(jnp.int32))
        v = v >> LIMB_BITS
    return BigInt(sign, jnp.stack(digs, axis=-1))


def bigint_gcd(a: BigInt, b: BigInt, bits: int | None = None) -> BigInt:
    """Fixed-trip binary GCD on magnitudes (shift/subtract only).

    ``bits`` defaults to 2 × limb width — enough trips for any
    representable pair.  Cost is O(bits · L); use for normalization of
    long-running rationals, not in per-element hot loops.
    """
    L = a.limbs
    bits = bits if bits is not None else 2 * L * LIMB_BITS
    one = jnp.ones(a.mag.shape[:-1], jnp.int32)
    u = BigInt(jnp.where(a.is_zero(), 0, one), a.mag)
    v = BigInt(jnp.where(b.is_zero(), 0, one), b.mag)
    shift = jnp.zeros(a.mag.shape[:-1], jnp.int32)

    def body(_, carry):
        u, v, shift = carry
        # freeze as soon as either side is zero: gcd(0, v) = v must come
        # out untouched (the final select returns the survivor)
        live = ~u.is_zero() & ~v.is_zero()
        ue = u.is_even() & live
        ve = v.is_even() & live
        both = ue & ve
        # halve even operands; count common factors of two
        u2, v2 = u.shift_right1(), v.shift_right1()
        u = _bsel(ue, u2, u)
        v = _bsel(ve, v2, v)
        shift = shift + both.astype(jnp.int32)
        # both odd now: subtract smaller from larger (the unselected
        # _mag_sub result may wrap — it is discarded by the select)
        odd = ~u.is_even() & ~v.is_even() & ~u.is_zero() & ~v.is_zero()
        ge = _mag_ge(u.mag, v.mag)
        du = BigInt(u.sign, _mag_sub(u.mag, v.mag))._canon_sign()
        dv = BigInt(v.sign, _mag_sub(v.mag, u.mag))._canon_sign()
        u = _bsel(odd & ge, du, u)
        v = _bsel(odd & ~ge, dv, v)
        return u, v, shift

    u, v, shift = jax.lax.fori_loop(0, bits, body, (u, v, shift))
    # survivor is whichever is nonzero
    g = _bsel(u.is_zero(), v, u)

    def lshift(_, carry):
        g, shift = carry
        g2 = g.shift_left1()
        g = _bsel(shift > 0, g2, g)
        return g, jnp.maximum(shift - 1, 0)

    g, _ = jax.lax.fori_loop(0, L * LIMB_BITS, lshift, (g, shift))
    # gcd(0,0) -> 1 to keep denominators valid
    one_b = BigInt(jnp.ones_like(g.sign),
                   jnp.zeros_like(g.mag).at[..., 0].set(1))
    return _bsel(g.is_zero(), one_b, BigInt(jnp.abs(g.sign), g.mag))


def _bsel(cond, a: BigInt, b: BigInt) -> BigInt:
    return BigInt(jnp.where(cond, a.sign, b.sign),
                  jnp.where(cond[..., None], a.mag, b.mag))


# -- wide rational ------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RationalW:
    """Exact fraction of BigInts, den > 0 by construction."""

    num: BigInt
    den: BigInt

    def __add__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.den + o.num * self.den,
                         self.den * o.den)

    def __sub__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.den - o.num * self.den,
                         self.den * o.den)

    def __mul__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.num, self.den * o.den)

    def __truediv__(self, o: "RationalW") -> "RationalW":
        num = self.num * o.den
        den = self.den * o.num
        flip = den.sign < 0
        return RationalW(BigInt(jnp.where(flip, -num.sign, num.sign),
                                num.mag),
                         BigInt(jnp.abs(den.sign), den.mag))

    def __neg__(self) -> "RationalW":
        return RationalW(-self.num, self.den)

    def sign(self) -> jax.Array:
        return self.num.sign

    def compare(self, o: "RationalW") -> jax.Array:
        """Exact sign(self - o) (dens positive)."""
        return (self.num * o.den).compare(o.num * self.den)

    def to_float(self) -> jax.Array:
        # divide mantissas and recombine exponents so num/den pairs whose
        # magnitudes individually exceed float32 range (inf/inf = NaN
        # under plain to_float) still produce their representable ratio
        mn, en = self.num.to_float_scaled()
        md, ed = self.den.to_float_scaled()
        return jnp.ldexp(mn / md, en - ed)

    def normalized(self) -> "RationalW":
        g = bigint_gcd(self.num, self.den)
        # exact division by the gcd via shift-subtract long division
        return RationalW(_bigint_div_exact(self.num, g),
                         _bigint_div_exact(self.den, g))

    def to_fractions(self):
        from fractions import Fraction
        ns, ds = self.num.to_pyints(), self.den.to_pyints()
        return [Fraction(n, d) for n, d in zip(ns, ds)]


def _bigint_div_exact(a: BigInt, d: BigInt) -> BigInt:
    """a / d where d exactly divides a: restoring long division over the
    full bit width (static trip count)."""
    L = a.limbs
    nbits = L * LIMB_BITS
    rem = BigInt(jnp.zeros_like(a.sign), jnp.zeros_like(a.mag))
    quo = BigInt(jnp.zeros_like(a.sign), jnp.zeros_like(a.mag))
    amag = BigInt(jnp.where(a.is_zero(), 0, 1), a.mag)
    dmag = BigInt(jnp.abs(d.sign), d.mag)

    def body(i, carry):
        rem, quo = carry
        k = nbits - 1 - i
        limb, bit = k // LIMB_BITS, k % LIMB_BITS
        topbit = (amag.mag[..., limb] >> bit) & 1
        rem = rem.shift_left1()
        rem = BigInt(jnp.maximum(rem.sign, topbit),
                     rem.mag.at[..., 0].add(topbit))
        ge = _mag_ge(rem.mag, dmag.mag)
        rem = _bsel(ge, BigInt(rem.sign, _mag_sub(rem.mag, dmag.mag)),
                    rem)._canon_sign()
        quo = quo.shift_left1()
        quo = BigInt(quo.sign, quo.mag.at[..., 0].add(ge.astype(jnp.int32)))
        return rem, quo

    rem, quo = jax.lax.fori_loop(0, nbits, body, (rem, quo))
    sgn = a.sign * jnp.where(d.sign < 0, -1, 1)
    return BigInt(sgn, quo.mag)._canon_sign()


def rational_w(num, den=1, limbs: int = DEFAULT_LIMBS) -> RationalW:
    n = bigint(num, limbs) if not isinstance(num, BigInt) else num
    d = bigint(den, limbs) if not isinstance(den, BigInt) else den
    if isinstance(den, int) and den == 1:
        d = bigint(jnp.ones_like(n.sign), limbs)
    flip = d.sign < 0
    return RationalW(BigInt(jnp.where(flip, -n.sign, n.sign), n.mag),
                     BigInt(jnp.abs(d.sign), d.mag))
