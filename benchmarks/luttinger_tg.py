"""Luttinger parameter from the OBDM tail at near-Tonks coupling: an
honest estimator-bias study against the exactly-known limit.

The TG gas has K = 1 exactly (free fermions; the finite-coupling
Lieb-Liniger value at gamma is ~ 1 + 4/gamma), and the OBDM tail obeys
``n1(r) ~ d(r)^(-1/(2K))``.  The OBDM is off-diagonal, so every QMC
estimator of it carries trial-function bias; this benchmark fits K
from the variational, DMC-mixed, and value-extrapolated
(``2<mixed> - <VMC>``) OBDMs of one matched run pair.

Measured outcome (f32, gamma = 32, N = 32; recorded in BASELINE.md):
K_vmc = 0.981(14), K_mixed = 1.278(17), K_extrapolated = 1.744(51)
against the exact ~1.125.  The lesson is REAL and worth the record:
the second-order extrapolation corrects OBDM *values* but NOT tail
*exponents* — ``2 A_m d^-a_m - A_v d^-a_v`` is not a power law, and
when the trial tail differs substantially the extrapolated curve's
effective exponent overshoots.  Quantitative K should come from the
hydrodynamic route (``2 pi n f_s / c``; see
``analysis.luttinger_parameter_from_obdm`` notes) — this benchmark is
the measured evidence behind that guidance.  No reference analog.

Run: PYTHONPATH=. python benchmarks/luttinger_tg.py
"""
import argparse
import json

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=32)
    parser.add_argument("--gn", type=float, default=32.0)
    parser.add_argument("--walkers", type=int, default=2048)
    parser.add_argument("--num-pos", type=int, default=17)
    parser.add_argument("--nts", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=12)
    args = parser.parse_args()

    from phd_qmclib_tpu.analysis import (extrapolated_estimate,
                                         luttinger_parameter_from_obdm)
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc, vmc

    nop = args.nop
    sc = float(nop)
    spec = mrbp.Spec(lattice_depth=1e-6, lattice_ratio=1.0,
                     interaction_strength=args.gn, boson_number=nop,
                     supercell_size=sc, tbf_contact_cutoff=0.48)
    offsets = np.linspace(0.0, sc / 2, args.num_pos)
    rng = np.random.default_rng(1)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR, rng=rng)
        for _ in range(args.walkers)]).astype(np.float32)

    # -- VMC (the variational OBDM) ------------------------------------
    vs = vmc.Sampling(spec, move_spread=0.12, rng_seed=5,
                      num_walkers=args.walkers, est_every=4,
                      obd_est_spec=vmc.OBDEstSpec(
                          num_pos=args.num_pos, est_every_mult=2))
    vstate = vs.build_state(confs)
    vit = vs.blocks(args.nts, vstate)
    for _ in range(8):
        next(vit)  # burn
    n1_v = np.zeros(args.num_pos)
    samples = 0
    for _ in range(args.blocks):
        b = next(vit)
        n1_v += np.asarray(b.iter_obd, dtype=np.float64).sum(axis=0)
        samples += np.asarray(b.iter_obd).shape[0] * args.walkers
    n1_v /= samples

    # -- DMC (the MIXED OBDM; extrapolation needs mixed, not pure) -----
    ds = dmc.Sampling(spec, time_step=5e-4,
                      max_num_walkers=args.walkers + args.walkers // 16,
                      target_num_walkers=args.walkers, rng_seed=3,
                      est_every=4,
                      obd_est_spec=dmc.OBDEstSpec(
                          num_pos=args.num_pos, as_pure_est=False,
                          est_every_mult=2))
    dstate = ds.build_state(confs, dtype=np.float32)
    burn = max(8, int(round(4.0 / (5e-4 * args.nts))))
    dit = ds.blocks(dstate, args.nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(dit)
    n1_m = np.zeros(args.num_pos)
    wsum = 0.0
    for _ in range(args.blocks):
        b = next(dit)
        nw = np.asarray(b.iter_props.num_walkers, dtype=np.float64)
        cad = 8  # est_every * est_every_mult
        n1_m += np.asarray(b.iter_obd, dtype=np.float64).sum(axis=0)
        wsum += nw[cad - 1::cad].sum()
    n1_m /= wsum

    n1_ext = extrapolated_estimate(n1_m, n1_v)

    def k_of(n1):
        k, k_err = luttinger_parameter_from_obdm(offsets, n1, sc)
        return k, k_err

    k_v, k_v_err = k_of(n1_v)
    k_m, k_m_err = k_of(n1_m)
    k_e, k_e_err = k_of(np.maximum(n1_ext, 1e-12))
    gamma = args.gn  # density n = 1
    print(json.dumps({
        "metric": "luttinger_k_tg",
        "gamma": gamma, "nop": nop,
        "k_exact_tg": 1.0,
        "k_lieb_liniger_large_gamma": 1.0 + 4.0 / gamma,
        "k_vmc": k_v, "k_vmc_err": k_v_err,
        "k_dmc_mixed": k_m, "k_mixed_err": k_m_err,
        "k_extrapolated": k_e, "k_ext_err": k_e_err,
    }))
    for i in range(0, args.num_pos, 2):
        print(json.dumps({"sz": float(offsets[i]),
                          "n1_vmc": float(n1_v[i]),
                          "n1_mixed": float(n1_m[i]),
                          "n1_ext": float(n1_ext[i])}))


if __name__ == "__main__":
    main()
