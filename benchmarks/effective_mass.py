"""Superfluid fraction / effective mass vs lattice depth.

Measures the center-of-mass imaginary-time diffusion estimator
(``cm_diffusion_est``) against the EXACT single-particle band-curvature
target ``ideal.effective_mass_ratio`` for the ideal lattice gas, plus
interacting points showing the many-body effective mass.  No reference
analog (the reference has no transport/superfluid observable at all).

Run: PYTHONPATH=. python benchmarks/effective_mass.py
"""
import argparse
import json

import numpy as np


def measure(v0, gn, nop, walkers, nts, blocks, dt, window_blocks=1,
            leggett=False):
    """Measure m/m*; with ``window_blocks > 1`` the CM accumulation
    window spans that many consecutive blocks (``cm_window_blocks``),
    extending tau to ``window_blocks * nts * dt`` — deep lattices need
    the longer window to reach the asymptotic diffusion slope."""
    from phd_qmclib_tpu import analysis
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    spec = mrbp.Spec(lattice_depth=v0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=0.3)
    est_kw = {}
    if leggett:
        # Pure ground-state density on 8 bins per lattice period: the
        # Leggett bound needs the true density profile.
        est_kw["density_est_spec"] = dmc.DensityEstSpec(
            num_bins=8 * nop, as_pure_est=True)
    sampling = dmc.Sampling(
        spec, time_step=dt, max_num_walkers=walkers + walkers // 8,
        target_num_walkers=walkers, rng_seed=7, cm_diffusion_est=True,
        cm_window_blocks=window_blocks, **est_kw)
    rng = np.random.default_rng(1)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(walkers)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    burn = max(2, int(round(2.0 / (dt * nts))))
    it = sampling.blocks(state, nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    cmds, nws, dens = [], [], []
    for _ in range(blocks * window_blocks):
        b = next(it)
        cmds.append(np.asarray(b.iter_cmd, dtype=np.float64))
        nws.append(np.asarray(b.iter_props.num_walkers,
                              dtype=np.float64))
        if leggett:
            # Fully forward-walked profile: last step of the block.
            dens.append(np.asarray(b.iter_density,
                                   dtype=np.float64)[-1]
                        / nws[-1][-1])
    # Stitch each window's blocks into one continuous tau series.
    cmd = np.stack(cmds).reshape(blocks, window_blocks * nts, 2)
    nw = np.stack(nws).reshape(blocks, window_blocks * nts)
    ratio, err = analysis.effective_mass_from_cm_diffusion(dt, cmd, nw,
                                                           nop)
    if not leggett:
        return ratio, err
    prof = np.stack(dens)
    bound, bound_err = analysis.leggett_bound(
        prof.mean(axis=0), prof.std(axis=0) / np.sqrt(len(dens)))
    return ratio, err, bound, bound_err


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=16)
    parser.add_argument("--walkers", type=int, default=4096)
    parser.add_argument("--nts", type=int, default=1024)
    parser.add_argument("--blocks", type=int, default=4)
    parser.add_argument("--dt", type=float, default=1e-3)
    parser.add_argument("--window-blocks", type=int, default=1,
                        help="CM window length in blocks "
                             "(tau = window_blocks * nts * dt)")
    parser.add_argument("--v0", type=float, default=None,
                        help="measure only this lattice depth")
    args = parser.parse_args()

    from phd_qmclib_tpu import ideal

    wb = args.window_blocks
    print(f"# m/m* via CM imaginary-time diffusion: N={args.nop}, "
          f"{args.walkers} walkers, window tau="
          f"{wb * args.nts * args.dt:.2f}")
    v0_list = [args.v0] if args.v0 is not None else [2.0, 10.0, 20.0,
                                                    40.0]
    for v0 in v0_list:
        exact = ideal.effective_mass_ratio(v0, 1.0)
        ratio, err, bound, bound_err = measure(
            v0, 0.0, args.nop, args.walkers, args.nts, args.blocks,
            args.dt, window_blocks=wb, leggett=True)
        print(json.dumps({"v0": v0, "gn": 0.0, "measured": ratio,
                          "fit_err": err, "exact_band": exact,
                          "rel_dev": abs(ratio - exact) / exact,
                          "leggett_bound": bound,
                          "leggett_err": bound_err,
                          "bound_satisfied": bool(ratio <= bound + 2 * (
                              err + bound_err))}))
    # Interacting points (no exact target; repulsion delocalizes the
    # gas, pushing m/m* back toward 1).
    for gn in [1.0, 4.0]:
        if args.v0 is not None:
            break
        ratio, err, bound, bound_err = measure(
            20.0, gn, args.nop, args.walkers, args.nts, args.blocks,
            args.dt, window_blocks=wb, leggett=True)
        print(json.dumps({"v0": 20.0, "gn": gn, "measured": ratio,
                          "fit_err": err,
                          "exact_band_ideal": 0.8245,
                          "leggett_bound": bound,
                          "leggett_err": bound_err,
                          "bound_satisfied": bool(ratio <= bound + 2 * (
                              err + bound_err))}))


if __name__ == "__main__":
    main()
