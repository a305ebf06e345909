"""Pair correlation g2(r) at near-Tonks coupling vs the exact limit.

Measures, in ONE DMC run of a strongly-coupled uniform gas (v0 = 0
keeps the one-body factor trivial so the homogeneous free-fermion
mapping is exact in the gn -> infinity limit), BOTH g2 routes:

- the Fourier route — pure forward-walking S(k) inverted to g2(r)
  (``analysis.pair_correlation_from_ssf``), mode-cutoff-limited;
- the direct route — the pure pair-distance histogram estimator
  (``pair_corr_est_spec``), exact real-space binning, no cutoff —

and compares both with the finite-N Tonks-Girardeau closed form

    g2_TG(r) = N (1 - D(r)^2) / (N - 1),
    D(r) = sin(N pi r / L) / (N sin(pi r / L)).

Lieb-Liniger predicts the residual contact value g2(0) ~ 4 pi^2/(3 g^2)
at large coupling gamma, so at gamma = 16 expect g2(0) ~ 0.05, not 0.

Run: PYTHONPATH=. python benchmarks/g2_tg.py
"""
import argparse
import json

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=32)
    parser.add_argument("--gn", type=float, default=32.0)
    parser.add_argument("--walkers", type=int, default=2048)
    parser.add_argument("--nts", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=8)
    args = parser.parse_args()

    from phd_qmclib_tpu import analysis
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    nop = args.nop
    sc = float(nop)  # density n = 1
    # Shallow-but-finite lattice: v0=0 exactly would flip the is_free
    # static branch; 1e-6 keeps the generic path with a trivial orbital.
    spec = mrbp.Spec(lattice_depth=1e-6, lattice_ratio=1.0,
                     interaction_strength=args.gn, boson_number=nop,
                     supercell_size=sc, tbf_contact_cutoff=0.48)
    num_modes = 2 * nop + 3
    num_bins = 4 * nop
    sampling = dmc.Sampling(
        spec, time_step=5e-4,
        max_num_walkers=args.walkers + args.walkers // 16,
        target_num_walkers=args.walkers, rng_seed=3,
        ssf_est_spec=dmc.SSFEstSpec(num_modes=num_modes,
                                    as_pure_est=True),
        pair_corr_est_spec=dmc.PairCorrEstSpec(num_bins=num_bins,
                                               as_pure_est=True))
    rng = np.random.default_rng(1)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR, rng=rng)
        for _ in range(args.walkers)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    burn = max(4, int(round(4.0 / (5e-4 * args.nts))))
    it = sampling.blocks(state, args.nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    rho2 = np.zeros(num_modes)
    g2_counts = np.zeros(num_bins)
    wsum = 0.0
    for _ in range(args.blocks):
        b = next(it)
        # Pure estimator: end-of-window value weighted by the final
        # step's walker count (cf. qmc_exec/data/dmc._pure_aware_totals).
        nw = np.asarray(b.iter_props.num_walkers, dtype=np.float64)
        rho2 += np.asarray(b.iter_ssf, dtype=np.float64)[-1, :, 0]
        g2_counts += np.asarray(b.iter_g2, dtype=np.float64)[-1]
        wsum += nw[-1]
    rho2 /= wsum
    g2_counts /= wsum

    momenta = np.asarray(sampling.ssf_momenta, dtype=np.float64)
    r = np.linspace(0.0, sc / 2, 8 * nop + 1)
    g2 = analysis.pair_correlation_from_ssf(momenta, rho2, r, nop, sc)

    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.sin(nop * np.pi * r / sc) / (nop * np.sin(np.pi * r / sc))
    d[0] = 1.0
    g2_tg = nop * (1.0 - d ** 2) / (nop - 1)

    rms = float(np.sqrt(np.mean((g2 - g2_tg) ** 2)))

    # Direct histogram route: g2 at the bin centers.
    r_bins, g2_direct, _ = analysis.pair_correlation_from_counts(
        g2_counts, nop, sc)
    with np.errstate(invalid="ignore", divide="ignore"):
        d_b = np.sin(nop * np.pi * r_bins / sc) \
            / (nop * np.sin(np.pi * r_bins / sc))
    g2_tg_bins = nop * (1.0 - d_b ** 2) / (nop - 1)
    rms_direct = float(np.sqrt(np.mean((g2_direct - g2_tg_bins) ** 2)))

    print(json.dumps({
        "metric": "g2_vs_tonks_girardeau",
        "gn": args.gn, "nop": nop,
        "g2_contact": float(g2[0]),
        "g2_tg_contact": 0.0,
        "g2_half_L": float(g2[-1]),
        "rms_dev_from_tg": rms,
        "first_peak_r": float(r[1 + np.argmax(g2[1:])]),
        "g2_direct_contact_bin": float(g2_direct[0]),
        "g2_direct_half_L": float(g2_direct[-1]),
        "rms_dev_from_tg_direct": rms_direct,
    }))
    # Print the curves for the record.
    for i in range(0, len(r), 16):
        print(json.dumps({"r": float(r[i]), "g2": float(g2[i]),
                          "g2_tg": float(g2_tg[i])}))
    for i in range(0, num_bins, num_bins // 8):
        print(json.dumps({"r_bin": float(r_bins[i]),
                          "g2_direct": float(g2_direct[i]),
                          "g2_tg": float(g2_tg_bins[i])}))


if __name__ == "__main__":
    main()
