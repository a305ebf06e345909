"""Periodic-boundary-condition geometry primitives.

Vectorized JAX counterparts of the reference scalar kernels
(``/root/reference/src/phd_qmclib/qmc_base/utils.py:24-66``).  All
functions broadcast over arbitrary batch shapes and are dtype-polymorphic
(float32 in production runs, float64 in CPU parity tests).
"""
import jax.numpy as jnp

__all__ = ["min_image", "min_distance", "recast_to_supercell", "sign"]


def sign(v):
    """Sign of ``v`` following ``copysign(1, v)`` semantics: ``sign(0) = +1``.

    Reference: ``qmc_base/utils.py:24-31``.
    """
    return jnp.where(v >= 0, jnp.ones_like(v), -jnp.ones_like(v))


def min_image(z_ij, sc_size):
    """Minimum-image displacement for a supercell of size ``sc_size``.

    Maps a raw displacement to the representative in
    ``[-sc_size/2, sc_size/2)``.  Reference: ``qmc_base/utils.py:34-51``.
    """
    sc_half = 0.5 * sc_size
    wrapped = -sc_half + jnp.mod(z_ij + sc_half, sc_size)
    return jnp.where(jnp.abs(z_ij) > sc_half, wrapped, z_ij)


def min_image_bounded(z_ij, sc_size):
    """Minimum image for displacements already bounded to
    ``(-sc_size, sc_size)`` - differences of positions inside the
    supercell.  One round + fma instead of compare/mod/select; used in
    the O(N^2) hot kernels where every per-pair op counts.

    At ``|z_ij| == sc_size/2`` exactly, round-half-to-even may pick the
    opposite image - the same physical pair distance.
    """
    return z_ij - sc_size * jnp.round(z_ij / sc_size)


def min_distance(z_i, z_j, sc_size):
    """Signed minimum-image distance between two positions."""
    return min_image(z_i - z_j, sc_size)


def recast_to_supercell(z, z_min, z_max):
    """Wrap a position into the supercell ``[z_min, z_max)``.

    Reference: ``qmc_base/utils.py:54-66``.
    """
    sc_size = z_max - z_min
    return z_min + jnp.mod(z - z_min, sc_size)
