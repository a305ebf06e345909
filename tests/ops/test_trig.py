"""Reduced-range f32 trig polynomials against numpy f64."""
import jax.numpy as jnp
import numpy as np

from phd_qmclib_tpu.ops import trig

#: Over the whole reduced domain (-pi/2, pi/2].
_X = np.linspace(-np.pi / 2, np.pi / 2, 200001)[1:].astype(np.float32)


def test_sincos_poly32_matches_numpy():
    s, c = trig.sincos_poly32(jnp.asarray(_X))
    x = _X.astype(np.float64)
    assert np.asarray(s).dtype == np.float32
    assert np.abs(np.asarray(s, np.float64) - np.sin(x)).max() < 3e-7
    assert np.abs(np.asarray(c, np.float64) - np.cos(x)).max() < 3e-7


def test_tancot_poly32_matches_numpy():
    xp, q = trig.tancot_poly32(jnp.asarray(_X))
    xp = np.asarray(xp, np.float64)
    q = np.asarray(q, np.float64)
    x = _X.astype(np.float64)
    # tan = xP/Q to 1.5e-6 relative away from the pole; cot = Q/(xP)
    # to 3e-7 absolute where it vanishes (next to pi/2).
    near = np.abs(x) < 1.5
    tan = np.tan(x[near])
    assert np.max(np.abs(xp[near] / q[near] - tan) / np.abs(tan)) < 2e-6
    far = np.abs(x) > 1.0
    cot = np.cos(x[far]) / np.sin(x[far])
    assert np.max(np.abs(q[far] / xp[far] - cot)) < 3e-7
