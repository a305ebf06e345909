"""Quantify the reference's branching-weight discretization quirk.

The reference's ``evolve_system`` reads the weight's ``E_prev`` from
the stale walker SLOT (``jastrow/dmc.py:846-847``, before the cloning
write at ``:941``) instead of the parent's energy.  Both are valid
O(dt) discretizations of the short-time Green's function, so they must
share the dt->0 limit while differing in the linear-bias slope.  This
driver measures both semantics (``dmc.Sampling(ref_compat=...)``) over
a fused dt sweep and extrapolates.

Measured (BASELINE.md "Branching-weight discretization"): the parent
scheme extrapolates cleanly (slope -1.12, E/N 8.4122(4) at N=16,
v0=20, gn=1); the stale-slot scheme stays ~4-6e-3 high even at
dt=5e-5 with an irregular walker-population dependence — branching
events shift slot lineages, so its ``E_prev`` belongs to an unrelated
walker with probability growing with W*dt.

Run: PYTHONPATH=. python benchmarks/ref_compat_bias.py
"""
import argparse
import json

import numpy as np


def sweep(spec, dts, target, max_w, blocks, nts, burn, ref_compat):
    from phd_qmclib_tpu.parallel.sweep import ParamSweep
    from phd_qmclib_tpu.samplers import dmc

    rows = tuple(
        dmc.Sampling(spec, time_step=dt, max_num_walkers=max_w,
                     target_num_walkers=target, rng_seed=3 + i,
                     ref_compat=ref_compat)
        for i, dt in enumerate(dts))
    sweep_ = ParamSweep(rows)
    rng = np.random.default_rng(0)
    conf_sets = [np.stack([spec.init_get_sys_conf(rng=rng)
                           for _ in range(target)]).astype(np.float32)
                 for _ in rows]
    state = sweep_.build_states(conf_sets, dtype=np.float32)
    it = sweep_.blocks(state, nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    es = []
    for _ in range(blocks):
        b = next(it)
        e = np.asarray(b.iter_props.energy, dtype=np.float64)
        w = np.asarray(b.iter_props.weight, dtype=np.float64)
        es.append(e.sum(axis=0) / w.sum(axis=0))
    es = np.array(es)
    return es.mean(axis=0), es.std(axis=0) / np.sqrt(len(es))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=16)
    parser.add_argument("--walkers", type=int, default=4096)
    parser.add_argument("--blocks", type=int, default=16)
    parser.add_argument("--nts", type=int, default=256)
    args = parser.parse_args()

    from phd_qmclib_tpu.models import mrbp

    nop = args.nop
    spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=1.0, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=0.4)
    dts = [4e-4, 1e-3, 2e-3, 4e-3]
    max_w = args.walkers + args.walkers // 8
    # burn tau ~ 3 at the smallest dt
    burn = max(2, int(round(3.0 / (dts[0] * args.nts))))

    results = {}
    for mode, label in ((False, "parent_energy"),
                        (True, "ref_compat_stale_slot")):
        means, errs = sweep(spec, dts, args.walkers, max_w,
                            args.blocks, args.nts, burn, mode)
        coeffs = np.polyfit(dts, means / nop, 1)
        results[label] = {"dts": dts,
                          "e_per_n": [round(v, 6)
                                      for v in (means / nop).tolist()],
                          "err": [round(v, 6)
                                  for v in (errs / nop).tolist()],
                          "slope": round(float(coeffs[0]), 3),
                          "e0_extrap": round(float(coeffs[1]), 5)}
        print(json.dumps({label: results[label]}))
    d = abs(results["parent_energy"]["e0_extrap"]
            - results["ref_compat_stale_slot"]["e0_extrap"])
    print(json.dumps({"extrapolated_difference": round(d, 5)}))


if __name__ == "__main__":
    main()
