"""Per-walker position histogram without the (W, N, bins) intermediate.

The DMC density estimator needs ``hist[w, b] = #{i : bin(z_wi) = b}``
per step.  An XLA scatter-add serializes on duplicate bin indices, and
the one-hot compare-and-reduce (``(bins[:, :, None] == iota).sum(axis=1)``)
materializes the ``(W, N, B)`` broadcast — about 1.1 GB at the
production shape (17408 walkers x 128 particles x 128 bins, f32).

The production path is :func:`walker_histogram_mxu`: factorize the bin
id as ``b = q * R + r`` and the one-hot as a product of two narrow
one-hots, so the count becomes a batched matmul::

    hist[w, q*R + r] = sum_i [q_wi == q] * [r_wi == r]
                     = einsum('wiq,wir->wqr', A, B)

The ``(W, N, Q)`` / ``(W, N, R)`` compare factors are ~5x smaller than
the full one-hot, and counts are exact small integers so the result is
BIT-IDENTICAL to the one-hot formulation (asserted in
``tests/ops/test_histogram.py``).
"""
import math

import jax
import jax.numpy as jnp

__all__ = ["walker_histogram", "walker_histogram_mxu",
           "walker_histogram_onehot"]


def walker_histogram_onehot(pos, bin_size, num_bins: int):
    """Reference formulation: fused one-hot compare-and-reduce
    (materializes ``(W, N, B)``)."""
    bins = jnp.clip((pos // bin_size).astype(jnp.int32), 0, num_bins - 1)
    bin_ids = jnp.arange(num_bins, dtype=jnp.int32)
    onehot = (bins[..., :, None] == bin_ids).astype(pos.dtype)
    return onehot.sum(axis=-2)


def walker_histogram_mxu(pos, bin_size, num_bins: int, r_split: int = 32):
    """``(..., num_bins)`` histogram of ``pos (..., N)`` via a batched
    matmul of factorized one-hots (see module docstring).

    ``num_bins`` need not be divisible by ``r_split``: the coarse axis
    pads up and the padded columns are provably zero (bins are clipped
    to ``< num_bins``), so they are sliced off exactly.
    """
    r = min(r_split, num_bins)
    q = math.ceil(num_bins / r)
    bins = jnp.clip((pos // bin_size).astype(jnp.int32), 0, num_bins - 1)
    bq = bins // r
    br = bins % r
    # The factors are exact 0/1, so on f32 inputs they travel as bf16
    # (half the bytes) while the accumulation stays f32 — counts remain
    # EXACT integers (each dot sums <= N ones), bit-identical to the
    # f32-factor form.
    fdtype = jnp.bfloat16 if pos.dtype == jnp.float32 else pos.dtype
    fq = (bq[..., :, None]
          == jnp.arange(q, dtype=jnp.int32)).astype(fdtype)
    fr = (br[..., :, None]
          == jnp.arange(r, dtype=jnp.int32)).astype(fdtype)
    # 0/1 factors and integer sums are exact under any matmul precision.
    hqr = jnp.einsum("...iq,...ir->...qr", fq, fr,
                     preferred_element_type=pos.dtype,
                     precision=jax.lax.Precision.DEFAULT)
    return hqr.reshape(pos.shape[:-1] + (q * r,))[..., :num_bins]


def walker_histogram(pos, bin_size, num_bins: int):
    """Production entry point: the factorized formulation (plain XLA,
    exact in f32 and f64)."""
    return walker_histogram_mxu(pos, bin_size, num_bins)
