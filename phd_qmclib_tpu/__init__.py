"""phd-qmclib-tpu: a JAX Quantum Monte Carlo framework.

Estimates ground-state properties of a 1D interacting Bose gas in a
multi-rod (Kronig-Penney) optical lattice using Variational Monte Carlo
(VMC) and Diffusion Monte Carlo (DMC) with a Bijl-Jastrow trial
wavefunction.

This is a from-scratch accelerator-first re-design with the
capabilities of the reference CPU/numba library ``phd-qmclib``
(oarodriguez/PhD-QMCLib), run in production on NVIDIA GPUs:

* Walker ensembles are fixed-shape JAX arrays; the per-step hot loop is a
  ``lax.scan`` compiled once per block.
* The O(N^2) pairwise Bijl-Jastrow kernels (log-psi, fused local
  energy + drift) run as fused, vectorized XLA ops.
* DMC birth/death branching is the reference's stochastic comb,
  vectorized (floor(w+u) -> cumsum -> searchsorted) so the population
  dynamics are statistically identical while shapes stay static.
* Walkers shard across devices via ``shard_map`` over a
  ``jax.sharding`` Mesh, with ``psum`` ensemble reductions.
"""
from . import constants, ideal, models, parallel, qmc_exec, samplers, \
    utils, wf_opt  # noqa: F401
from .stats import reblock  # noqa: F401

__version__ = "0.1.0"
