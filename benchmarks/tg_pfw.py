"""Tonks-Girardeau pure-S(k) vs forward-walking window (round 3).

The reference pins the pure-estimator window to one block and silently
drops the ``pfw_num_time_steps`` config key
(``mrbp_qmc/dmc_exec/proc.py:274, 337``); round 3 honors it end to
end.  This driver measures the exact-limit TG structure factor (free
fermions: ``S(k_j)/N = j/N`` up to ``2 k_F``, then 1) at several
windows through the config-driven Proc.

Run: PYTHONPATH=. python benchmarks/tg_pfw.py
"""
import argparse
import json

import numpy as np


def measure(pfw, nts, walkers, blocks, dt, seed=19):
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec

    config = {
        "model_spec": {"lattice_depth": 0.0, "lattice_ratio": 1.0,
                       "interaction_strength": 5000.0,
                       "boson_number": 5, "supercell_size": 5.0,
                       "tbf_contact_cutoff": 0.25},
        "time_step": dt, "max_num_walkers": walkers + walkers // 8,
        "target_num_walkers": walkers, "num_blocks": blocks,
        "num_time_steps_block": nts, "burn_in_blocks": 2,
        "rng_seed": seed, "dtype": "float32",
        "ssf_spec": {"num_modes": 7, "as_pure_est": True,
                     **({"pfw_num_time_steps": pfw} if pfw else {})},
    }
    proc = dmc_exec.Proc.from_config(config)
    result = proc.exec(dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc))
    return np.asarray(result.data.blocks.ss_factor.mean,
                      dtype=np.float64) / 5.0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--walkers", type=int, default=8192)
    parser.add_argument("--nts", type=int, default=2048)
    parser.add_argument("--blocks", type=int, default=4)
    parser.add_argument("--dt", type=float, default=4e-5)
    args = parser.parse_args()

    exact = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.0])
    print(f"# TG pure S(k)/N vs forward-walking window: N=5, "
          f"{args.walkers} walkers, dt={args.dt}")
    # The last entry is a MULTI-BLOCK window (pfw = 2 blocks): the
    # pure accumulators persist across block boundaries (round-3 late
    # addition; the per-block entries reproduce the earlier table).
    for pfw in (256, 1024, None, 2 * args.nts):
        sk = measure(pfw, args.nts, args.walkers, args.blocks, args.dt)
        tau = (pfw or args.nts) * args.dt
        dev = np.abs(sk - exact)[1:]
        print(json.dumps({
            "pfw": pfw or args.nts, "tau_fw": round(tau, 5),
            "sk_over_n": [round(v, 4) for v in sk.tolist()],
            "max_dev": round(float(dev.max()), 4),
            "mean_dev": round(float(dev.mean()), 4)}))


if __name__ == "__main__":
    main()
