"""Reduced-range trig polynomials shared by the hot kernels.

Single source of truth for the coefficient tuples and the fused pair
evaluators used by the production XLA path (``models/mrbp``).

All evaluators assume the caller guarantees the reduced domain
``(-pi/2, pi/2]`` — no range reduction here.
"""

import jax.numpy as jnp

__all__ = [
    "SIN_COEFFS", "COS_COEFFS", "TAN_P_COEFFS", "TAN_Q_COEFFS",
    "sincos_poly32", "tancot_poly32",
]

#: Least-squares-on-Chebyshev-nodes coefficients of ``sin(x)/x`` and
#: ``cos(x)`` in ``x^2`` over ``[-pi/2, pi/2]``; max abs error 1.6e-7 /
#: 1.4e-7 in f32 arithmetic (~1 ULP).
SIN_COEFFS = (1.0, -1.66666666e-01, 8.33333098e-03, -1.98408615e-04,
              2.75252866e-06, -2.38894895e-08)
COS_COEFFS = (1.0, -4.99999994e-01, 4.16666362e-02, -1.38883608e-03,
              2.47601348e-05, -2.60510641e-07)

#: Order-13 continued-fraction truncation of tan, normalized:
#: tan x = x P(x^2)/Q(x^2) with P = 1 - z*17325/135135 + ... — the
#: pole of the truncation self-places at Q's root next to pi/2, so a
#: cot computed as Q/(xP) stays absolutely accurate (1.6e-7) right
#: where cot -> 0.
TAN_P_COEFFS = (1.0, -0.12820512820512820, 2.7972027972027972e-03,
                -7.4000074000074000e-06)
TAN_Q_COEFFS = (1.0, -0.46153846153846154, 2.3310023310023310e-02,
                -2.0720020720020720e-04)


def sincos_poly32(x):
    """(sin x, cos x) for ``x`` in ``(-pi/2, pi/2]`` via reduced-range
    polynomials (one shared ``x^2``, no range reduction), accurate to
    ~1 f32 ULP."""
    z2 = x * x
    s = jnp.float32(SIN_COEFFS[-1])
    c = jnp.float32(COS_COEFFS[-1])
    for k in range(len(SIN_COEFFS) - 2, -1, -1):
        s = s * z2 + jnp.float32(SIN_COEFFS[k])
        c = c * z2 + jnp.float32(COS_COEFFS[k])
    return x * s, c


def tancot_poly32(x):
    """``(x*P(x^2), Q(x^2))`` with ``tan x ~= xP/Q`` on
    ``(-pi/2, pi/2]``.

    The forward fast path consumes only the RATIO (tan inside the
    cutoff, cot outside), so the sin/cos pair can be replaced by this
    rational at two-thirds the op count (z^2 + 3+3 fma + 1 mul vs
    z^2 + 5+5 fma + 1 mul).  Measured f32 accuracy over the full
    argument domain: 1.44e-6 max relative (tan), 1.6e-7 absolute for
    cot near pi/2 — slightly BETTER than the f32-evaluated sincos pair
    (1.70e-6 / 1.9e-7): the f32 Horner noise dominates both forms.
    ``need_log`` paths keep :func:`sincos_poly32` (they need the
    factors themselves, not the ratio)."""
    z2 = x * x
    p = jnp.float32(TAN_P_COEFFS[-1])
    q = jnp.float32(TAN_Q_COEFFS[-1])
    for k in range(len(TAN_P_COEFFS) - 2, -1, -1):
        p = p * z2 + jnp.float32(TAN_P_COEFFS[k])
        q = q * z2 + jnp.float32(TAN_Q_COEFFS[k])
    return x * p, q
