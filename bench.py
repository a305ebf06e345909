"""Headline benchmark: DMC walker-steps/s on one GPU, mrbp model, N=128.

    python bench.py [--nop 128 --target 16384 --max-walkers 17408 ...]

Runs four stages in this one process, each printing one JSON line:

1. ``dmc``: bare DMC at the flagship configuration, with its E/N
   checked against the stored dt-band value;
2. ``vmc``: N=64, 16,384 Metropolis chains with S(k) on;
3. ``est_k8``: DMC with the production estimator load (pure 128-bin
   density + pure 64-mode S(k)) measured every 8th step;
4. ``production``: ``examples/dmc_production.yml`` through
   ``Proc.exec`` (``benchmarks/production_surface.py``).

The last line folds the stages into one JSON object.  Every line names
the device it ran on (JAX's platform, ``device_kind`` and device count,
and the card's name and power limit from ``nvidia-smi``).  Timed regions
end in ``jax.block_until_ready``.  Without a GPU the script exits
non-zero: a CPU timing is not a measurement of this program.

Baseline: the reference (oarodriguez/PhD-QMCLib) publishes no numbers
and its numba stack is not installed here, so ``vs_baseline`` divides by
the measured CPU reference proxy (``benchmarks/cpu_reference_proxy.py``,
same algorithm in vectorized NumPy: 79.7 walker-steps/s/core at N=128)
scaled by a generous 32-core workstation: ``32 * 79.66 = 2549
walker-steps/s``.  See BASELINE.md.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: Reference CPU estimate (walker-steps/s, N=128): measured proxy
#: 79.66 ws/s/core x 32 assumed cores.  See BASELINE.md.
REFERENCE_CPU_WALKER_STEPS_PER_SEC = 32 * 79.66

#: Reference CPU estimate for the VMC stage (chain-steps/s, N=64):
#: measured proxy ``benchmarks/cpu_reference_proxy.py --vmc --nop 64``
#: = 3180 chain-steps/s/core at its most cache-favorable chain count
#: (512), x 32 assumed cores.  See BASELINE.md.
REFERENCE_CPU_VMC_CHAIN_STEPS_PER_SEC = 32 * 3180.0

def run_dmc(nop: int, target: int, max_w: int, nts: int,
            timed_blocks: int, burn_blocks: int, estimators: bool = False,
            est_every: int = 1) -> dict:
    """Steady-state DMC rate after ``burn_blocks`` warm-up blocks."""
    import jax
    import numpy as np

    from phd_qmclib_tpu import flagship
    from phd_qmclib_tpu.samplers import dmc

    spec = flagship.spec(nop)
    est_kw = {}
    if estimators:
        est_kw = dict(
            density_est_spec=dmc.DensityEstSpec(num_bins=128,
                                                as_pure_est=True),
            ssf_est_spec=dmc.SSFEstSpec(num_modes=64, as_pure_est=True))
    sampling = dmc.Sampling(spec, time_step=1e-3, max_num_walkers=max_w,
                            target_num_walkers=target, rng_seed=1,
                            est_every=est_every, **est_kw)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(target)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)

    blocks = sampling.blocks(state, num_time_steps_block=nts,
                             burn_in_blocks=0)
    # Warm-up/burn-in blocks, compilation included (reported as
    # set-up, never timed).
    t_warm = time.perf_counter()
    for _ in range(burn_blocks):
        block = next(blocks)
    jax.block_until_ready(block)
    warmup_s = time.perf_counter() - t_warm

    # Each block's host fetches (walker counts, energies) are inside
    # the timed window, as they are in ``Proc.exec``.
    t0 = t_prev = time.perf_counter()
    block_rates = []
    total_wsteps = 0.0
    e_over_w = []
    for _ in range(timed_blocks):
        block = jax.block_until_ready(next(blocks))
        nw = np.asarray(block.iter_props.num_walkers, dtype=np.float64)
        e_over_w.append(
            float(np.asarray(block.iter_props.energy,
                             dtype=np.float64).sum())
            / float(np.asarray(block.iter_props.weight,
                               dtype=np.float64).sum()))
        t_now = time.perf_counter()
        total_wsteps += float(nw.sum())
        block_rates.append(float(nw.sum()) / (t_now - t_prev))
        t_prev = t_now
    rate = total_wsteps / (t_prev - t0)
    e = float(np.mean(e_over_w)) / nop
    result = {"value": rate, "unit": "walker-steps/s",
              "block_rates": block_rates, "warmup_s": warmup_s,
              "energy_per_boson": e}
    if nop == 128:
        # The stored dt-band value applies to N=128 only.
        result.update(energy_ref_dt_band=flagship.ENERGY_REF,
                      energy_dev=e - flagship.ENERGY_REF,
                      energy_check_ok=flagship.energy_ok(e))
    return result


def run_vmc(nop: int, num_chains: int, nts: int, timed_blocks: int,
            burn_blocks: int = 1) -> dict:
    """Steady-state VMC rate (Metropolis chains with S(k) on)."""
    import jax
    import numpy as np

    from phd_qmclib_tpu import flagship
    from phd_qmclib_tpu.samplers import vmc

    spec = flagship.spec(nop)
    sampling = vmc.Sampling(
        spec, move_spread=0.4, rng_seed=1, num_walkers=num_chains,
        ssf_est_spec=vmc.SSFEstSpec(num_modes=32))
    rng = np.random.default_rng(0)
    confs = rng.uniform(0.0, float(nop), size=(num_chains, nop)) \
        .astype(np.float32)
    blocks = sampling.blocks(nts, sampling.build_state(confs))
    t_warm = time.perf_counter()
    for _ in range(burn_blocks):
        block = next(blocks)
    jax.block_until_ready(block)
    warmup_s = time.perf_counter() - t_warm

    t0 = t_prev = time.perf_counter()
    block_rates = []
    for _ in range(timed_blocks):
        block = jax.block_until_ready(next(blocks))
        # Reduce on device, fetch scalars: the raw (nts, W) energies
        # are ~32 MB per block.
        acc = float(np.asarray(block.accept_rate))
        e = float(np.asarray(block.iter_props.energy[-1].mean()))
        t_now = time.perf_counter()
        block_rates.append(num_chains * nts / (t_now - t_prev))
        t_prev = t_now
    rate = num_chains * nts * timed_blocks / (t_prev - t0)
    return {"value": rate, "unit": "chain-steps/s",
            "block_rates": block_rates, "warmup_s": warmup_s,
            "energy_per_boson": e / nop, "accept_rate": acc}


def run_production(blocks: int) -> dict:
    """``examples/dmc_production.yml`` through ``Proc.exec``."""
    spec = importlib.util.spec_from_file_location(
        "production_surface",
        os.path.join(HERE, "benchmarks", "production_surface.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.measure(blocks=blocks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nop", type=int, default=128)
    parser.add_argument("--target", type=int, default=16384)
    # 6.25% buffer headroom above target: population control holds the
    # ensemble within ~2% of target, and every padded buffer row costs
    # O(N^2) pair work.
    parser.add_argument("--max-walkers", type=int, default=17408)
    # Production block length (the Proc default, matching the
    # reference's 512).
    parser.add_argument("--nts", type=int, default=512)
    parser.add_argument("--blocks", type=int, default=2)
    # Burn to tau ~ 3 before timing: the gas equilibrates in tau 3-4
    # (BASELINE.md), and the timed blocks' E/N feeds the dt-band
    # physics check.
    parser.add_argument("--burn", type=int, default=6)
    args = parser.parse_args(argv)

    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache
    from phd_qmclib_tpu.utils.device import card_name_and_power_limit, \
        require_gpu

    devices = require_gpu("bench")
    device = {"platform": devices[0].platform,
              "device_kind": devices[0].device_kind,
              "device_count": len(devices),
              "card": card_name_and_power_limit("bench")}

    enable_persistent_cache(min_compile_time_secs=0.5)

    def emit(stage: str, metric: str, record: dict, baseline=None):
        record = dict(record, stage=stage, metric=metric, **device)
        if baseline:
            record["vs_baseline"] = record["value"] / baseline
        print(json.dumps(record), flush=True)
        return record

    dmc = emit("dmc", "dmc_walker_steps_per_sec_per_chip", run_dmc(
        args.nop, args.target, args.max_walkers, args.nts, args.blocks,
        args.burn), REFERENCE_CPU_WALKER_STEPS_PER_SEC)
    vmc = emit("vmc", "vmc_chain_steps_per_sec_per_chip", run_vmc(
        64, 16384, 512, timed_blocks=4),
        REFERENCE_CPU_VMC_CHAIN_STEPS_PER_SEC)
    est = emit("est_k8",
               "dmc_walker_steps_per_sec_per_chip_estimators_on_cadence8",
               run_dmc(args.nop, args.target, args.max_walkers, args.nts,
                       timed_blocks=1, burn_blocks=1, estimators=True,
                       est_every=8))
    prod = emit("production", "dmc_production_surface",
                run_production(blocks=8))

    combined = dict(dmc, vmc_chain_steps_per_sec=vmc["value"],
                    vmc_vs_baseline=vmc["vs_baseline"],
                    vmc_accept_rate=vmc["accept_rate"],
                    estimators_on_k8_value=est["value"],
                    production_surface_value=prod["value"])
    print(json.dumps(combined))
    return 0


if __name__ == "__main__":
    sys.exit(main())
