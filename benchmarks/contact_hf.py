"""Thermodynamic consistency: the Hellmann-Feynman contact relation.

For the Lieb-Liniger interaction ``g sum_{i<j} delta(x_i - x_j)``
(``g = interaction_strength`` in this codebase's units, hbar^2/2m = 1),
the Hellmann-Feynman theorem ties the coupling-derivative of the
ground-state energy to the pair-correlation contact value:

    dE/dg = <sum_{i<j} delta(x_ij)> = N (N - 1) / (2 L) * g2(0)

Two fully independent measurement chains of this framework must agree:

* **Energy route**: E(g) from a fused coupling sweep (one ``SweepProc``
  dispatch, each coupling at two time steps for the dt -> 0
  extrapolation), differentiated by a weighted quadratic fit in g.
* **Contact route**: the direct pure (forward-walking) pair-distance
  histogram (``pair_corr_est_spec``) of the MIDDLE coupling row,
  extrapolated to r -> 0 with a linear fit over the first bins (the
  exact short-distance cusp is ``g2(r) = g2(0)(1 + g r + O(r^2))``,
  so fine bins + a linear fit recover the contact to ~1%).

The delta interaction never appears as a potential-energy term here
(it is encoded by the trial-function cusp and the DMC projection), so
this is a stringent end-to-end check: the energy pipeline, the fused
sweep machinery, AND the new direct g2 estimator must all be right for
the two sides to match.  No reference analog.

Run: PYTHONPATH=. python benchmarks/contact_hf.py
"""
import argparse
import json

import numpy as np


def run_sweep(args, dts):
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
    from phd_qmclib_tpu.qmc_exec.sweep import SweepProc

    nop = args.nop
    sc = float(nop)  # density n = 1
    burn = max(3, int(round(2.0 / (min(dts) * args.nts))))
    procs = tuple(
        dmc_exec.Proc(
            model_spec=mrbp.Spec(
                lattice_depth=args.v0, lattice_ratio=1.0,
                interaction_strength=float(g), boson_number=nop,
                supercell_size=sc,
                tbf_contact_cutoff=(0.45 if args.v0 else 0.49) * sc),
            time_step=float(dt),
            max_num_walkers=int(1.0625 * args.walkers),
            target_num_walkers=args.walkers, num_blocks=args.blocks,
            num_time_steps_block=args.nts, burn_in_blocks=burn,
            rng_seed=29 + 11 * i + j, verbose=False,
            est_every=4,
            pair_corr_spec=dmc_exec.PairCorrEstSpec(
                num_bins=args.bins, as_pure_est=True))
        for i, g in enumerate(args.couplings)
        for j, dt in enumerate(dts))
    inputs = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), p)
        for p in procs]
    return SweepProc(procs).exec(inputs)


def contact_from_blocks(g2_blocks, g, nop, sc, num_fit_bins=8):
    """(g2(0), err): cusp-constrained r -> 0 extrapolation (see
    ``analysis.contact_from_pair_correlation``)."""
    from phd_qmclib_tpu.analysis import contact_from_pair_correlation
    r, g2, g2_err = g2_blocks.pair_correlation(nop, sc)
    return contact_from_pair_correlation(r, g2, g2_err, g,
                                         num_fit_bins=num_fit_bins)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=32)
    parser.add_argument("--v0", type=float, default=0.0,
                        help="lattice depth (the Hellmann-Feynman "
                             "relation dE/dg = <sum delta> holds for "
                             "any external potential)")
    parser.add_argument("--walkers", type=int, default=8192)
    parser.add_argument("--nts", type=int, default=1024)
    parser.add_argument("--blocks", type=int, default=16)
    parser.add_argument("--dt", type=float, default=5e-4)
    parser.add_argument("--dt-points", type=int, default=2,
                        help="number of time steps per coupling "
                             "(dt, dt/2, dt/4, ...); 3+ gives the "
                             "dt->0 fit residual degrees of freedom "
                             "and a calibrated error")
    parser.add_argument("--bins", type=int, default=256)
    parser.add_argument("--couplings", type=float, nargs="+",
                        default=[1.0, 1.5, 2.0, 2.5, 3.0])
    args = parser.parse_args()

    from phd_qmclib_tpu.analysis import zero_limit_extrapolation

    if args.dt_points == 2:
        dts = [args.dt, args.dt / 4.0]
    else:
        dts = [args.dt / 2.0 ** j for j in range(args.dt_points)]
    results = run_sweep(args, dts)
    nop = args.nop
    sc = float(nop)

    gs, es, errs = [], [], []
    contacts = {}
    for i, g in enumerate(args.couplings):
        row_e, row_e_err = [], []
        row_c, row_c_err = [], []
        for j, dt in enumerate(dts):
            res = results[len(dts) * i + j]
            e = res.data.blocks.energy
            row_e.append(float(e.mean))
            row_e_err.append(float(e.mean_error))
            c, c_err = contact_from_blocks(res.data.blocks.pair_corr,
                                           float(g), nop, sc)
            row_c.append(c)
            row_c_err.append(c_err)
        e0, e0_err, _ = zero_limit_extrapolation(
            np.asarray(dts), np.asarray(row_e), np.asarray(row_e_err),
            order=1)
        c0, c0_err, _ = zero_limit_extrapolation(
            np.asarray(dts), np.asarray(row_c), np.asarray(row_c_err),
            order=1)
        gs.append(g), es.append(e0), errs.append(e0_err)
        contacts[g] = (c0, c0_err)
        print(json.dumps({"g": g, "E_dt0": e0, "E_err": e0_err,
                          "g2_contact_dt0": c0,
                          "g2_contact_err": c0_err,
                          "E_raw": row_e, "contact_raw": row_c}),
              flush=True)

    # dE/dg at the middle coupling from a weighted quadratic fit.
    gs, es, errs = map(np.asarray, (gs, es, errs))
    w = 1.0 / np.maximum(errs, 1e-12)
    coeffs, cov = np.polyfit(gs, es, 2, w=w, cov="unscaled")
    g0 = float(gs[len(gs) // 2])
    dedg = float(2 * coeffs[0] * g0 + coeffs[1])
    grad = np.array([2 * g0, 1.0, 0.0])
    dedg_err = float(np.sqrt(grad @ cov @ grad))

    c0, c0_err = contacts[g0]
    hf_from_contact = nop * (nop - 1) / (2 * sc) * c0
    hf_err = nop * (nop - 1) / (2 * sc) * c0_err
    print(json.dumps({
        "metric": "hellmann_feynman_contact",
        "g0": g0, "gamma": g0 / 2.0,
        "dE_dg_from_energy_sweep": dedg,
        "dE_dg_err": dedg_err,
        "dE_dg_from_g2_contact": hf_from_contact,
        "contact_route_err": hf_err,
        "g2_contact": c0, "g2_contact_err": c0_err,
        "ratio": dedg / hf_from_contact if hf_from_contact else None,
        "consistent_2sigma": bool(
            abs(dedg - hf_from_contact) <= 2 * (dedg_err + hf_err)),
    }), flush=True)


if __name__ == "__main__":
    main()
