"""Thermodynamic consistency: sound speed from the equation of state
vs the Feynman phonon slope from S(k) — and, with ``--itc``, the full
FOUR-way closure at the central density (EOS curvature, Feynman S(k),
phonon-dispersion fits of F(k, tau), and the compressibility sum rule
chi(k -> 0) = -2/c^2 from the static response).

Two fully independent routes to the same observable, both measured by
this framework on hardware:

* **EOS route**: sweep the density ``n = N / L`` at fixed coupling via
  ``supercell_size`` rows of ONE fused ``SweepProc`` dispatch — and
  fold the time-step extrapolation into the SAME sweep (each density
  runs at two ``dt`` values as two more rows; the raw ``e(n)`` slope
  carries a dt bias that varies with the local coupling
  ``gamma(n) = gn/(2 n0 n)`` at fixed physical ``c_LL`` and flattens
  the curvature, so the extrapolation is essential, not cosmetic).
  Each row's ``interaction_strength`` scales linearly with its
  density so the PHYSICAL coupling stays fixed along the sweep (the
  model parameter is the reduced ``gamma = gn/(2 n^2)``,
  ``models/mrbp.py`` ``lgm``).  Hydrodynamics gives
  ``c^2 = (n/m) d mu / d n`` with ``mu = d(n e)/dn``; in this
  codebase's units (``hbar = 1``, energies in ``hbar^2/(2m)``, i.e.
  ``m = 1/2``): ``c^2 = 2 n (2 e' + n e'')``.  Closed-form check in
  the Tonks-Girardeau limit: ``e = pi^2 n^2 / 3`` gives ``c = 2 pi n``,
  the exact TG value.
* **S(k) route**: each density row also measures the pure static
  structure factor; the ``k -> 0`` Feynman phonon slope
  (``SSFBlocks.sound_speed``) bounds the sound speed from above and is
  exact in the phonon limit.

No reference analog (the reference has neither observable); the
agreement of the two routes on the interacting gas is an end-to-end
validation of the energy pipeline AND the estimator pipeline at once.

Run: PYTHONPATH=. python benchmarks/eos_sound_speed.py
"""
import argparse
import json

import numpy as np


def run_sweep(args, dts):
    """One fused sweep: len(lengths) x len(dts) rows."""
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
    from phd_qmclib_tpu.qmc_exec.sweep import SweepProc

    nop = args.nop
    # Burn long enough for the SLOWEST-equilibrating row: the
    # longest-wavelength density mode of the LARGEST box relaxes at
    # omega_1 = c 2 pi / L_max (~0.3 here), so the burn must cover
    # several 1/omega_1 — the shared block structure means the
    # smallest dt sets the burn block count for every row.
    burn = max(3, int(round(args.burn_tau / (min(dts) * args.nts))))
    # The model's interaction_strength is the REDUCED coupling
    # gamma = gn/(2 n^2) (models/mrbp.py ``lgm``), i.e. c_LL =
    # gn/(2 n).  A thermodynamic density sweep must hold the PHYSICAL
    # coupling c_LL fixed, so gn scales linearly with each row's
    # density (holding gn itself fixed walks a different path — the
    # first chip run did exactly that and its curvature was
    # meaningless against the fixed-g sound speed).
    n0 = nop / float(sorted(args.lengths)[len(args.lengths) // 2])
    procs = tuple(
        dmc_exec.Proc(
            model_spec=mrbp.Spec(
                lattice_depth=0.0, lattice_ratio=1.0,
                interaction_strength=args.gn * (nop / float(sc)) / n0,
                boson_number=nop,
                supercell_size=float(sc),
                tbf_contact_cutoff=0.25 * float(sc)),
            time_step=float(dt),
            max_num_walkers=int(1.0625 * args.walkers),
            target_num_walkers=args.walkers, num_blocks=args.blocks,
            num_time_steps_block=args.nts, burn_in_blocks=burn,
            rng_seed=13 + 7 * i + j, verbose=False,
            # 4-block forward-walking windows (scaled down when the
            # block budget cannot afford >= 2 window samples): at the
            # LARGE dt rows tau_fw = 4 nts dt ~ 2 covers the slowest
            # mode's relaxation (one-block windows leave S(k_1)
            # visibly trial-biased; the dt/4 rows project 4x less and
            # their S(k) is NOT used for the Feynman read-off below).
            ssf_spec=dmc_exec.SSFEstSpec(
                num_modes=args.modes, as_pure_est=True,
                pfw_num_time_steps=min(4, max(1, args.blocks // 2))
                * args.nts))
        for i, sc in enumerate(args.lengths)
        for j, dt in enumerate(dts))
    # Crystal-like start: near-minimal interaction energy and ordered
    # long-wavelength modes, so the burn relaxes a SMALL offset
    # instead of the big random-start one (same reasoning as the TG
    # itc_spectrum run).
    inputs = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="REGULAR"), p)
        for p in procs]
    return SweepProc(procs).exec(inputs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=32)
    parser.add_argument("--walkers", type=int, default=8192)
    parser.add_argument("--nts", type=int, default=1024)
    parser.add_argument("--blocks", type=int, default=16)
    parser.add_argument("--dt", type=float, default=5e-4,
                        help="largest time step; a dt/4 row per "
                             "density feeds the dt->0 extrapolation")
    parser.add_argument("--gn", type=float, default=4.0)
    parser.add_argument("--modes", type=int, default=12)
    parser.add_argument("--burn-tau", type=float, default=10.0,
                        help="imaginary-time burn per row (several "
                             "1/omega_1 of the largest box)")
    parser.add_argument("--lengths", type=float, nargs="+",
                        default=[40.0, 36.0, 32.0, 29.0, 26.5])
    parser.add_argument("--itc", action="store_true",
                        help="add a companion ITC run at the central "
                             "density: dispersion fits of F(k, tau) "
                             "and the compressibility sum rule "
                             "chi(k->0) = -2/c^2 close the FOUR-way "
                             "sound-speed comparison")
    parser.add_argument("--itc-walkers", type=int, default=8192)
    parser.add_argument("--itc-blocks", type=int, default=24)
    parser.add_argument("--itc-lags", type=int, default=48)
    parser.add_argument("--itc-mult", type=int, default=16)
    parser.add_argument("--itc-pfw-blocks", type=int, default=8,
                        help="pure-S(k) companion forward-walking "
                             "window, in 512-step blocks (tau_fw = "
                             "0.512 x this; 6 windows are run)")
    args = parser.parse_args()

    from phd_qmclib_tpu.analysis import zero_limit_extrapolation
    from phd_qmclib_tpu.lieb_liniger import (ground_state,
                                             ground_state_energy)

    dts = [args.dt, args.dt / 4.0]
    results = run_sweep(args, dts)
    nop = args.nop
    ns, es, errs, c_feyn = [], [], [], []
    for i, sc in enumerate(args.lengths):
        row = {}
        for j, dt in enumerate(dts):
            res = results[len(dts) * i + j]
            e = res.data.blocks.energy
            row[dt] = (float(e.mean) / nop, float(e.mean_error) / nop)
        # dt -> 0, linear (two points: exact interpolation with
        # propagated errors).
        e0, e0_err, _ = zero_limit_extrapolation(
            np.asarray(dts), np.asarray([row[dt][0] for dt in dts]),
            np.asarray([row[dt][1] for dt in dts]), order=1)
        n = nop / sc
        ns.append(n), es.append(e0), errs.append(e0_err)
        # Feynman c from the LARGE-dt row's pure S(k): its 4-block
        # window projects 4x more imaginary time than the dt/4 row's,
        # and the forward-walking projection error dominates the
        # Trotter one for S(k).
        ssf = results[len(dts) * i].data.blocks.ss_factor
        c, c_err = ssf.sound_speed(nop, sc,
                                   num_modes=min(4, args.modes - 1))
        c_feyn.append((c, c_err))
        # Exact Bethe-ansatz value at this density (v0 = 0 ONLY —
        # the lattice has no closed solution): per-point validation
        # of the whole energy pipeline.  gamma(row) = gn_row/(2 n^2)
        # with gn_row = gn n/n0 (fixed physical coupling), i.e.
        # gamma = gn/(2 n0 n).
        n0_c = nop / float(sorted(args.lengths)[len(args.lengths)
                                                // 2])
        e_exact = n ** 2 * ground_state_energy(
            args.gn / (2 * n0_c * n), num_points=256)
        print(json.dumps({"L": sc, "n": n,
                          "e_raw_dt": row[dts[0]][0],
                          "e_raw_dt4": row[dts[1]][0],
                          "e_dt0": e0, "e_err": e0_err,
                          "e_exact_ll": e_exact,
                          "dev_sigma": (e0 - e_exact) / e0_err,
                          "c_feynman": c, "c_feynman_err": c_err}),
              flush=True)

    # EOS fit: weighted quadratic e(n); c^2 = 2 n (2 e' + n e'').
    ns, es, errs = map(np.asarray, (ns, es, errs))
    w = 1.0 / np.maximum(errs, 1e-12)
    coeffs, cov = np.polyfit(ns, es, 2, w=w, cov="unscaled")
    a2, a1, _ = coeffs
    n0 = float(np.median(ns))
    de = 2 * a2 * n0 + a1
    d2e = 2 * a2
    c2 = 2 * n0 * (2 * de + n0 * d2e)
    c_eos = float(np.sqrt(max(c2, 0.0)))
    g = np.array([12 * n0 ** 2, 4 * n0, 0.0])
    c2_err = float(np.sqrt(g @ cov @ g))
    c_eos_err = 0.5 * c2_err / max(c_eos, 1e-12)

    ic = int(np.argmin(np.abs(ns - n0)))
    c_f0, c_f0_err = c_feyn[ic]
    # gamma(n0) = gn/(2 n0^2) (the model's reduced-coupling map).
    gs_exact = ground_state(args.gn / (2 * n0 ** 2), density=n0,
                            num_points=256)
    print(json.dumps({
        "n0": n0, "gn": args.gn,
        "gamma_at_n0": args.gn / (2 * n0 ** 2),
        "c_eos": c_eos, "c_eos_err": c_eos_err,
        "c_feynman_at_n0": c_f0, "c_feynman_err": c_f0_err,
        "c_exact_ll": gs_exact["sound_speed"],
        "luttinger_k_exact_ll": gs_exact["luttinger_k"],
        "ratio_eos_vs_exact": c_eos / gs_exact["sound_speed"],
        "consistent_2sigma_vs_exact": bool(
            abs(c_eos - gs_exact["sound_speed"])
            <= 2 * max(c_eos_err, 1e-12)),
        "c_tg_limit": 2 * np.pi * n0,
    }), flush=True)

    if not args.itc:
        return

    # FOUR-way closure at the central density: a companion DMC run
    # measures F(k, tau) deep enough (omega_1 tau_max ~ 3-4) for
    # (3) the phonon-dispersion fits (tail fit + spectral-inversion
    # peak, ITCBlocks machinery) and (4) the compressibility sum rule
    # chi(k -> 0) = -2/c^2 via the static response.  Routes (1) EOS
    # curvature and (2) Feynman S(k) come from the sweep above; all
    # four ride DIFFERENT functionals of different estimator chains.
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from itc_spectrum import itc_blocks, measure, pure_ssf

    sc_c = float(sorted(args.lengths)[len(args.lengths) // 2])
    out = measure(v0=0.0, gn=args.gn, nop=args.nop,
                  walkers=args.itc_walkers, nts=512,
                  blocks=args.itc_blocks, dt=1e-3, est_every=8,
                  num_modes=6, num_lags=args.itc_lags,
                  rm=0.25 * sc_c, burn=12, itc_mult=args.itc_mult,
                  supercell=sc_c)
    itcb = itc_blocks(out)
    kz = out["k"]
    # The ITC amplitude F(k, 0) = S(k)_mixed carries trial bias
    # (largest at small k) that enters m_{-1} linearly and the sound
    # speed at half weight; a pure (forward-walked) S(k) companion
    # re-anchors the amplitude while the mixed DECAY — exact in DMC —
    # provides the shape (ITCBlocks.static_response hybrid mode).
    s_pure, s_pure_err = pure_ssf(
        v0=0.0, gn=args.gn, nop=args.nop, walkers=args.itc_walkers,
        nts=512, blocks=6 * args.itc_pfw_blocks, dt=1e-3,
        num_modes=6, rm=0.25 * sc_c, burn=16,
        pfw_steps=512 * args.itc_pfw_blocks, supercell=sc_c)
    sr_mixed = itcb.static_response()
    sr = itcb.static_response(ssf=s_pure, ssf_err=s_pure_err)
    fit, fit_err = itcb.excitation_fit()
    spec = itcb.spectral_function(num_omega=96)
    with np.errstate(invalid="ignore", divide="ignore"):
        c_tail = fit / kz
        c_peak = spec["omega_peak"] / kz
        # Feynman c from the deep-projected pure companion:
        # omega_F/k = k / S_pure(k) -> c as k -> 0.
        c_feyn_pure = kz[1:3] / s_pure[1:3]
    print(json.dumps({
        "four_way_closure_at_n": args.nop / sc_c,
        "itc_tau_max": float(out["tau"][-1]),
        "c_exact_ll": gs_exact["sound_speed"],
        "c_eos": c_eos, "c_eos_err": c_eos_err,
        "c_feynman_pure_sweep": c_f0, "c_feynman_err": c_f0_err,
        "c_feynman_pure_companion_k1": float(c_feyn_pure[0]),
        "c_dispersion_tail_k1": float(c_tail[1]),
        "c_dispersion_tail_k1_err": float(fit_err[1] / kz[1]),
        "c_dispersion_peak_k1": float(c_peak[1]),
        "c_dispersion_peak_k1_err":
            float(spec["omega_peak_err"][1] / kz[1]),
        "c_compressibility_hybrid_k1": float(sr["sound_speed"][1]),
        "c_compressibility_hybrid_k1_err":
            float(sr["sound_speed_err"][1]),
        "c_compressibility_hybrid_k2": float(sr["sound_speed"][2]),
        "c_compressibility_mixed_k1":
            float(sr_mixed["sound_speed"][1]),
        "s_pure": s_pure.tolist(), "s_pure_err": s_pure_err.tolist(),
        "s_mixed_f0": out["f"][0].tolist(),
        "chi_hybrid_k": sr["chi"].tolist(),
        "chi_k0_exact_ll": gs_exact["chi_k0"],
        "omega_bound_vs_feynman_mixed": {
            "m0_over_m_minus1": sr["omega_bound"].tolist(),
            "feynman_mixed": out["feynman"].tolist()},
    }), flush=True)


if __name__ == "__main__":
    main()
