"""Factorized per-walker histogram: bit-equal to the one-hot formulation."""
import numpy as np
import pytest

import jax.numpy as jnp

from phd_qmclib_tpu.ops import histogram as hg


_SLOW = pytest.mark.slow  # re-tiered r5: the production shape and one
# padding edge stay fast; the remaining padding permutations run in
# the full tier


@pytest.mark.parametrize("w,n,b,rs", [
    (96, 128, 128, 32),
    pytest.param(64, 16, 12, 32,    # pad: 12 -> 4x3? ceil(12/12)
                 marks=_SLOW),
    (10, 8, 5, 2),                  # pad: q=3, qr=6 > 5
    pytest.param(32, 16, 100, 32,   # pad: q=4, qr=128 > 100
                 marks=_SLOW),
    pytest.param(16, 8, 1, 32, marks=_SLOW)])
def test_mxu_matches_onehot_exactly(w, n, b, rs):
    rng = np.random.default_rng(w * 7 + n)
    sc = float(b)
    for dtype in (jnp.float32, jnp.float64):
        pos = jnp.asarray(rng.uniform(0, sc, (w, n)), dtype=dtype)
        bs = jnp.asarray(sc / b, dtype)
        a = np.asarray(hg.walker_histogram_onehot(pos, bs, b))
        out = np.asarray(hg.walker_histogram_mxu(pos, bs, b, r_split=rs))
        np.testing.assert_array_equal(a, out)
        np.testing.assert_array_equal(a.sum(axis=1), n)


def test_mxu_bin_edges_match():
    b, sc = 16, 16.0
    vals = np.concatenate([np.arange(b) * (sc / b), [sc - 1e-6, 0.0],
                           [15.9999990]])
    pos = jnp.asarray(np.tile(vals, (4, 1)), dtype=jnp.float32)
    bs = jnp.float32(sc / b)
    np.testing.assert_array_equal(
        np.asarray(hg.walker_histogram_onehot(pos, bs, b)),
        np.asarray(hg.walker_histogram_mxu(pos, bs, b)))


@pytest.mark.slow  # re-tiered r5: the batched path runs fast-tier
# implicitly through every fused-sweep estimator test
def test_mxu_batched_leading_axes():
    # The sampler maps over leading axes in sweeps: (S, W, N) must work.
    rng = np.random.default_rng(11)
    pos = jnp.asarray(rng.uniform(0, 8.0, (3, 6, 16)), jnp.float32)
    bs = jnp.float32(0.5)
    out = np.asarray(hg.walker_histogram_mxu(pos, bs, 16))
    ref = np.stack([np.asarray(hg.walker_histogram_onehot(pos[s], bs, 16))
                    for s in range(3)])
    np.testing.assert_array_equal(out, ref)


def test_dispatch_matches_onehot_on_cpu():
    # The production entry point must be exact on CPU (any dtype).
    pos = jnp.asarray(np.random.default_rng(3).uniform(0, 8, (8, 8)))
    out = hg.walker_histogram(pos, jnp.asarray(1.0, pos.dtype), 8)
    np.testing.assert_array_equal(
        np.asarray(out),
        np.asarray(hg.walker_histogram_onehot(
            pos, jnp.asarray(1.0, pos.dtype), 8)))
