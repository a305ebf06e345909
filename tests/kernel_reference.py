"""The f32 production kernels against their plain f64 evaluation.

The f64 path (library sin/cos, no polynomial trig) is the one
``tests/models/test_mrbp.py`` ties to the scalar oracle at 1e-12; the f32
path is what production runs execute.  Shared by the CPU tests and the
card-only tests, which evaluate f32 on the GPU and f64 on the host CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np

from phd_qmclib_tpu.models import mrbp

#: log|psi| sums ~N^2/2 f32 pair terms; their rounding noise grows like
#: eps * sqrt(pairs) ~ 1e-5 relative at N=128.
LOG_PSI_RTOL = 1e-5
#: The local energy is a sum of kinetic terms that cancel against each
#: other and the drift squares, so its f32 rounding is amplified about
#: ten-fold over a plain sum.
ENERGY_RTOL = 1e-4
#: Drift components pass through zero, so they are compared against the
#: largest one: atol = DRIFT_ATOL_FRACTION * max |drift|.
DRIFT_ATOL_FRACTION = 1e-3
#: Relative tolerance of the f32 ITC lag products: full-f32 products and
#: sums err by ~1e-7; TF32-rounded factors would err by ~1e-3.
ITC_RTOL = 1e-5


def start_positions(spec: mrbp.Spec, num_walkers: int,
                    seed: int = 0) -> np.ndarray:
    """``(num_walkers, N)`` fresh random configurations, as a sampler
    starts from."""
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng)[mrbp.SysConfSlot.pos]
                     for _ in range(num_walkers)])


def evaluate(spec: mrbp.Spec, pos, dtype, device) -> dict:
    """log|psi|, the local energy (``energy_and_drift`` and ``energy``)
    and the drift of ``pos`` in ``dtype`` on ``device``, as float64."""
    funcs = mrbp.core_funcs(spec)
    cfc = jax.tree.map(lambda x: np.asarray(x, dtype), spec.cfc_params)
    cfc, pos = jax.device_put((cfc, np.asarray(pos, dtype)), device)
    energy, drift = funcs.energy_and_drift(pos, cfc)
    out = {"log_psi": funcs.log_psi(pos, cfc), "energy": energy,
           "drift": drift, "energy_only": funcs.energy(pos, cfc)}
    for value in out.values():
        assert value.dtype == jnp.dtype(dtype)
        assert value.devices() == {device}
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def f32_errors(spec: mrbp.Spec, pos, f32_device, f64_device) -> dict:
    """Worst errors of the f32 kernels on ``f32_device`` against the f64
    evaluation on ``f64_device``, each beside its tolerance."""
    got = evaluate(spec, pos, np.float32, f32_device)
    ref = evaluate(spec, pos, np.float64, f64_device)

    def rel(name):
        return float(np.max(np.abs(got[name] - ref[name])
                            / np.abs(ref[name])))

    drift_scale = float(np.max(np.abs(ref["drift"])))
    return {
        "log_psi_rel": (rel("log_psi"), LOG_PSI_RTOL),
        "energy_rel": (rel("energy"), ENERGY_RTOL),
        "energy_only_rel": (rel("energy_only"), ENERGY_RTOL),
        "drift_abs": (float(np.max(np.abs(got["drift"] - ref["drift"]))),
                      DRIFT_ATOL_FRACTION * drift_scale),
    }


def assert_within(errors: dict) -> None:
    bad = {k: v for k, v in errors.items() if not v[0] <= v[1]}
    assert not bad, f"f32 kernels off the f64 reference: {bad}"


def itc_errors(device, num_walkers: int, num_lags: int, num_modes: int,
               walker_sum: bool, precision=None, seed: int = 0) -> float:
    """Worst relative error of the f32 ITC lag products on ``device``
    against numpy f64: the walker sums (``walker_sum``, the mixed
    estimator) or the per-walker products (the pure estimator).  The
    factors are positive so no cancellation hides a rounding error.
    ``precision`` overrides the production matmul precision."""
    from phd_qmclib_tpu.samplers import dmc

    rng = np.random.default_rng(seed)
    buf = rng.uniform(0.0, 1.0, (num_walkers, num_lags, num_modes, 2)) \
        .astype(np.float32)
    reim = rng.uniform(0.0, 1.0, (num_walkers, num_modes, 2)) \
        .astype(np.float32)
    mask = (rng.uniform(size=num_walkers) < 0.95).astype(np.float32)
    operands = (buf, reim, mask) if walker_sum else (buf, reim)
    spec = "wlkc,wkc,w->lk" if walker_sum else "wlkc,wkc->wlk"
    args = jax.device_put(operands, device)
    if precision is not None:
        got = jnp.einsum(spec, *args, precision=precision)
    elif walker_sum:
        got = dmc.itc_lag_products(*args)
    else:
        got = dmc.itc_walker_lag_products(*args)
    ref = np.einsum(spec, *(x.astype(np.float64) for x in operands),
                    optimize=True)
    assert got.devices() == {device}
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)
                        / np.abs(ref)))
