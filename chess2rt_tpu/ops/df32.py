"""Double-float (two-float) f32 arithmetic — emulated ~f64 in f32 code.

A value is carried as an unevaluated sum
``hi + lo`` of two float32s (|lo| <= 0.5 ulp(hi)), giving ~48 bits of
significand — enough that a result rounded back to f32 is CORRECTLY
ROUNDED for every quantity this module is used on.

Used by the opt-in compensated camera ray-gen
(``SceneStatic.compensated_raygen``): the reference computes its screen
corners and per-pixel interpolation in f64 (camera.d:77-174), and plain
f32 corner arithmetic leaves 1-2 ulp errors that the ~1/dir.y horizon
amplification (~700x on lecture5) turns into whole-texel UV errors.
Interpolating df32 corners and rounding the final direction to f32
removes that tail (tests/test_parity.py::TestF32Production).

All functions are branch-free elementwise jnp ops (jit-friendly).
The error-free transforms (two_sum, two_prod via Dekker splitting — no
FMA dependence) require IEEE f32 semantics without reassociation, which
XLA preserves (it never licenses fast-math reassociation of user ops).

Representation: a pair ``(hi, lo)`` of equal-shaped f32 arrays.

References: Dekker (1971); Knuth TAOCP v2 §4.2.2; Hida/Li/Bailey's
double-double algorithms (public domain techniques).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_SPLIT = np.float32(4097.0)  # 2**12 + 1 for a 24-bit significand


def from_f64(x):
    """Split a host-side float64 into an (hi, lo) f32 constant pair."""
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return jnp.float32(hi), jnp.float32(lo)


def to_f32(a):
    """Round a df32 back to a single f32 (hi + lo, correctly rounded)."""
    return a[0] + a[1]


def two_sum(a, b):
    """Error-free a + b -> (s, err) for arbitrary magnitudes (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b -> (p, err) via Dekker splitting (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# -- df32 (pair) arithmetic --------------------------------------------------


def add(a, b):
    """df + df (Knuth add22, ~1 ulp of the 48-bit significand)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def sub(a, b):
    return add(a, (-b[0], -b[1]))


def mul(a, b):
    """df * df (Dekker mul22)."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def mul_f32(a, s):
    """df * plain-f32 (exact one-word factor)."""
    p, e = two_prod(a[0], s)
    e = e + a[1] * s
    return fast_two_sum(p, e)


def div(a, b):
    """df / df: f32 quotient seed + one df-residual correction."""
    q1 = a[0] / b[0]
    r = sub(a, mul_f32(b, q1))
    q2 = (r[0] + r[1]) / b[0]
    return fast_two_sum(q1, q2)


def sqrt(a):
    """df sqrt: f32 seed + one Heron step with a df residual."""
    s = jnp.sqrt(a[0])
    r = sub(a, mul((s, jnp.zeros_like(s)), (s, jnp.zeros_like(s))))
    e = (r[0] + r[1]) / (2.0 * s)
    return fast_two_sum(s, e)


def neg(a):
    return (-a[0], -a[1])


def const(x, like=None):
    hi, lo = from_f64(x)
    if like is not None:
        hi = jnp.broadcast_to(hi, jnp.shape(like))
        lo = jnp.broadcast_to(lo, jnp.shape(like))
    return hi, lo


# -- sin / cos ---------------------------------------------------------------

# Taylor coefficients of sin/cos as df32 constant pairs.  On the reduced
# range |y| <= pi/4 the truncation error of these orders is < 4e-18
# (sin: y^15/15!, cos: y^16/16!) — far below the ~2^-45 df32 noise floor.
_SIN_C = [1.0, -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880,
          -1.0 / 39916800, 1.0 / 6227020800.0]
_COS_C = [1.0, -0.5, 1.0 / 24, -1.0 / 720, 1.0 / 40320, -1.0 / 3628800,
          1.0 / 479001600.0, -1.0 / 87178291200.0]

_PI_2 = np.float64(np.pi) / 2


def _poly_even(y2, coeffs):
    """Evaluate sum_i c_i * (y^2)^i in df32 (Horner)."""
    acc = const(coeffs[-1], like=y2[0])
    for c in reversed(coeffs[:-1]):
        acc = add(mul(acc, y2), const(c, like=y2[0]))
    return acc


def sincos(x):
    """df32 sin and cos of a df32 argument (radians, |x| < ~1e3).

    Range-reduces by pi/2 (df32 constant, error ~|x|*2^-46) and evaluates
    Taylor polynomials on |y| <= pi/4 with df32 Horner steps.  Verified
    against numpy float64 to < 1e-12 absolute over [-720 deg, 720 deg]
    (tests/test_parity.py::TestCompensatedRayGen).
    """
    k = jnp.round((x[0] + x[1]) / np.float32(_PI_2))
    y = sub(x, mul_f32(const(_PI_2, like=k), k))
    y2 = mul(y, y)
    s_p = mul(y, _poly_even(y2, _SIN_C))  # sin on the reduced range
    c_p = _poly_even(y2, _COS_C)          # cos on the reduced range
    q = jnp.asarray(k, jnp.int32) & 3     # quadrant
    # sin(x) = [s, c, -s, -c][q],  cos(x) = [c, -s, -c, s][q]
    def pick(q0, a, b):
        hi = jnp.where(q0 % 2 == 0, a[0], b[0])
        lo = jnp.where(q0 % 2 == 0, a[1], b[1])
        sign = jnp.where(q0 < 2, 1.0, -1.0).astype(hi.dtype)
        return (hi * sign, lo * sign)

    sin = pick(q, s_p, c_p)
    cos = pick((q + 1) & 3, s_p, c_p)
    return sin, cos


def tan(x):
    s, c = sincos(x)
    return div(s, c)
