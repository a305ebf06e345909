"""Card-only checks: each piece of the main path, run on the GPU,
against the repo's plain reference.

``python chip_smoke.py`` runs these first; by hand::

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py

(the CPU platform hosts the f64 references).  Without a GPU every test
here skips (the ``gpu`` fixture decides when the test runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phd_qmclib_tpu import flagship
from phd_qmclib_tpu.ops import histogram as hg
from phd_qmclib_tpu.samplers import dmc
from tests import kernel_reference as kr

pytestmark = pytest.mark.gpu

#: Production widths: the flagship walker buffer and particle count.
MAX_WALKERS, NOP = 17408, 128


def test_f32_kernels_on_card_match_f64(gpu, cpu):
    # 256 walkers of the flagship start (Proc seeds its start with
    # rng_seed=1).
    spec = flagship.spec(NOP)
    errors = kr.f32_errors(spec, kr.start_positions(spec, 256, seed=1),
                           gpu, cpu)
    print(f"\ncard f32 kernels vs f64 (worst error, tolerance): {errors}")
    kr.assert_within(errors)


def test_threefry_normals_match_cpu(gpu, cpu):
    key = jax.random.key(1234)
    shape = (MAX_WALKERS, NOP)
    # Threefry is integer arithmetic: the bits agree exactly.
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jax.device_put(key, gpu), shape)),
        np.asarray(jax.random.bits(jax.device_put(key, cpu), shape)))
    got = np.asarray(jax.random.normal(jax.device_put(key, gpu), shape,
                                       jnp.float32))
    ref = np.asarray(jax.random.normal(jax.device_put(key, cpu), shape,
                                       jnp.float32))
    # The uniform -> normal transform (an erf^-1 polynomial) may contract
    # into fused multiply-adds differently per backend: allow 8 ulp of
    # max(|x|, 1).
    ulp = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
    worst = float(np.max(np.abs(got - ref) / ulp))
    print(f"\ncard normals vs CPU: worst {worst:.2f} ulp (bound 8)")
    assert worst <= 8.0


@pytest.mark.parametrize("walker_sum", [True, False],
                         ids=["mixed", "pure"])
def test_itc_lag_products_full_f32_on_card(gpu, walker_sum):
    # Production widths: 17,408 walkers x 64 lags x 32 modes.
    err = kr.itc_errors(gpu, MAX_WALKERS, 64, 32, walker_sum)
    # The same products with TF32-rounded factors must fail the bound,
    # or the bound could not tell full f32 from TF32.
    tf32 = kr.itc_errors(gpu, MAX_WALKERS, 64, 32, walker_sum,
                         precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32)
    print(f"\ncard ITC lag products ({'mixed' if walker_sum else 'pure'})"
          f": rel error {err:.3g} in production, {tf32:.3g} in TF32")
    assert err <= kr.ITC_RTOL < tf32


def test_branching_comb_matches_searchsorted(gpu):
    rng = np.random.default_rng(5)
    weights = rng.uniform(0.0, 2.0, MAX_WALKERS).astype(np.float32)
    u = rng.uniform(size=MAX_WALKERS).astype(np.float32)
    num_walkers = 16384
    comb = jax.jit(lambda w, n, u: dmc.branching_comb(w, n, u=u))
    parent, new_num = comb(*jax.device_put(
        (weights, np.int32(num_walkers), u), gpu))
    clones = np.floor(weights + u).astype(np.int64)
    clones[num_walkers:] = 0
    cum = np.cumsum(clones)
    ref = np.clip(np.searchsorted(cum, np.arange(MAX_WALKERS),
                                  side="right"), 0, MAX_WALKERS - 1)
    np.testing.assert_array_equal(np.asarray(parent), ref)
    assert int(new_num) == min(int(cum[-1]), MAX_WALKERS)


def test_walker_histogram_exact_on_card(gpu):
    rng = np.random.default_rng(6)
    num_bins = 128
    pos = rng.uniform(0.0, float(NOP), (MAX_WALKERS, NOP)) \
        .astype(np.float32)
    pos, bin_size = jax.device_put((pos, np.float32(NOP / num_bins)), gpu)
    got = np.asarray(jax.jit(hg.walker_histogram_mxu, static_argnums=2)(
        pos, bin_size, num_bins))
    ref = np.asarray(jax.jit(hg.walker_histogram_onehot,
                             static_argnums=2)(pos, bin_size, num_bins))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.sum(axis=1), NOP)
