"""Excitation spectrum from the imaginary-time correlation F(k, tau).

Measures the intermediate-scattering-function estimator (``itc_spec``)
and extracts the effective excitation energies
``omega_eff(k, tau) = -d ln F / d tau`` — tau-dependent UPPER bounds on
the lowest excitation at each k that start at the Feynman bound
``k^2 N / S(k)`` (enforced by the f-sum rule) and tighten as tau grows.
Validation targets:

* **Tonks-Girardeau point** (``--tg``): density correlations map to
  free fermions exactly, so every F(k, tau) is a known particle-hole
  sum — the measured omega_eff must land on the exact multi-channel
  decay (the same gate ``tests/samplers/test_itc.py`` runs on tiny
  shapes; here at production scale on the chip).
* **Phonon regime** (default / ``--deep``): two internal-consistency
  gates.  (1) f-sum: the first-lag log-derivative must equal the same
  run's Feynman ratio k^2/S(k) mode by mode (both are f-sum / S(k)).
  (2) spectral narrowing: the per-mode tail fit (window
  ``tau in [1, 3]/omega_F(k)``, F-weighted) must land BELOW the
  first-lag mean energy wherever resolved — the decay stiffens toward
  the slowest surviving excitation.  The tail rate is only compared
  (not gated) against the MIXED-estimator Feynman ratio: at low k the
  mixed S(k) carries trial-wavefunction bias, so a tail rate a few
  10% above that ratio diagnoses the S(k) bias, not a bound
  violation.  ``--deep`` stretches the lag unit (est_every_mult) so
  ``omega_1 * tau_max ~ 3``; at the default shallow tau_max the tail
  fit sits near the f-sum average, by design.

No reference analog (the reference has no two-time observables).

Run: PYTHONPATH=. python benchmarks/itc_spectrum.py
"""
import argparse
import json

import numpy as np


def measure(v0, gn, nop, walkers, nts, blocks, dt, est_every,
            num_modes, num_lags, seed=7, rm=0.3, burn=4,
            regular_init=False, itc_mult=1, supercell=None,
            pure=False):
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    spec = mrbp.Spec(lattice_depth=v0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=nop,
                     supercell_size=float(supercell or nop),
                     tbf_contact_cutoff=rm)
    sampling = dmc.Sampling(
        spec, time_step=dt, max_num_walkers=walkers + walkers // 8,
        target_num_walkers=walkers, rng_seed=seed, est_every=est_every,
        ssf_est_spec=dmc.SSFEstSpec(num_modes=num_modes,
                                    as_pure_est=False),
        itc_est_spec=dmc.ITCEstSpec(num_modes=num_modes,
                                    num_lags=num_lags,
                                    est_every_mult=itc_mult,
                                    as_pure_est=pure))
    rng = np.random.default_rng(1)
    if regular_init:
        # Crystal-like start: the long-wavelength density modes relax
        # slowly (1/omega_1 can exceed the burn window for a random
        # start), so begin near the ordered configuration.
        confs = np.stack([
            spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                                   offset=rng.uniform(0, nop))
            for _ in range(walkers)]).astype(np.float32)
    else:
        confs = np.stack([spec.init_get_sys_conf(rng=rng)
                          for _ in range(walkers)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    it = sampling.blocks(state, nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    sums_b, counts_b = [], []
    ssf = np.zeros(num_modes)
    ssf_w = 0.0
    for _ in range(blocks):
        b = next(it)
        if pure:
            # Forward-walked: one window sample per block (the
            # end-of-window value; interior steps hold partial,
            # under-projected accumulations — cf. the Proc data
            # layer's win_final selection).
            sums_b.append(np.asarray(b.iter_itc, dtype=np.float64)[-1])
            counts_b.append(np.asarray(b.iter_itc_nw,
                                       dtype=np.float64)[-1])
        else:
            sums_b.append(np.asarray(b.iter_itc, dtype=np.float64)
                          .sum(axis=0))
            counts_b.append(np.asarray(b.iter_itc_nw,
                                       dtype=np.float64).sum(axis=0))
        parts = np.asarray(b.iter_ssf, dtype=np.float64)
        ssf += parts[..., 0].sum(axis=0)
        ssf_w += np.asarray(b.iter_props.num_walkers,
                            dtype=np.float64)[est_every - 1::est_every].sum()
    sums = np.sum(sums_b, axis=0)
    counts = np.sum(counts_b, axis=0)
    f = sums / counts[:, None] / nop            # F(k, tau) per particle
    # Delete-one-block jackknife errors per (lag, mode) — the honest
    # noise scale the spectral inversion needs (its smoothing weight
    # comes from the discrepancy principle, so an inflated sigma
    # over-smooths and biases omega_mean up).
    loo = np.stack([(sums - sb) / (counts - cb)[:, None] / nop
                    for sb, cb in zip(sums_b, counts_b)])
    f_err = np.sqrt((blocks - 1) / blocks
                    * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
    s_k = ssf / ssf_w / nop                     # mixed S(k) per particle
    lag_dt = est_every * itc_mult * dt
    tau = np.arange(num_lags + 1) * lag_dt
    kz = np.arange(num_modes) * 2 * np.pi / spec.supercell_size
    feynman = np.full(num_modes, np.nan)
    feynman[1:] = kz[1:] ** 2 / s_k[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        omega_eff = -np.diff(np.log(np.maximum(f, 1e-300)),
                             axis=0) / lag_dt
        # Per-mode tail fit on the window tau in [1, 3] / omega_F(k):
        # each mode's own decay scale sets where the fast (multi-
        # excitation) transients have died but F still rides above the
        # noise floor — one global window can't serve k_1 (needs
        # tau ~ 4) and k_4 (dead into noise past tau ~ 1.5) at once.
        # The fit is weighted by F (sigma_lnF ~ sigma_F / F with
        # sigma_F roughly tau-flat), which suppresses the concave
        # ln-of-noisy-mean upward bias of the deep-tail points.
        omega_fit = np.full(num_modes, np.nan)
        fit_windows = np.full((num_modes, 2), np.nan)
        for j in range(1, num_modes):
            lo, hi = 1.0 / feynman[j], 3.0 / feynman[j]
            sel = (tau >= lo) & (tau <= hi)
            ok = sel & np.isfinite(f[:, j]) & (f[:, j] > 0)
            if ok.sum() >= min(4, max(2, sel.sum())):
                omega_fit[j] = -np.polyfit(tau[ok], np.log(f[ok, j]),
                                           1, w=f[ok, j])[0]
                fit_windows[j] = (tau[ok][0], tau[ok][-1])
    return {"k": kz, "tau": tau, "f": f, "f_err": f_err, "s_k": s_k,
            "omega_eff": omega_eff, "omega_fit": omega_fit,
            "fit_windows": fit_windows, "feynman": feynman,
            "sums_b": np.stack(sums_b), "counts_b": np.stack(counts_b),
            "lag_dt": lag_dt, "nop": nop,
            "supercell": float(spec.supercell_size)}


def itc_blocks(out):
    """Wrap a measure() result in the production ITCBlocks container
    (jackknife machinery for the static-response closure below)."""
    from phd_qmclib_tpu.qmc_exec.data.dmc import ITCBlocks
    return ITCBlocks(out["sums_b"], out["counts_b"], out["lag_dt"],
                     out["nop"], out["supercell"])


def pure_ssf(v0, gn, nop, walkers, nts, blocks, dt, num_modes,
             seed=7, rm=0.3, burn=4, pfw_steps=None, supercell=None):
    """Forward-walked (pure) S(k) companion run: the mixed S(k) in the
    ITC run carries O(psi_T - phi_0) trial bias, largest at small k —
    the Feynman ratio k^2/S(k) is only an honest mean-excitation
    reference when it uses the pure S(k).  ``pfw_steps`` sets the
    forward-walking projection time (multi-block windows when it
    exceeds ``nts``): the residual trial bias decays like
    ``e^{-omega_1 tau_fw}``, so it must cover the SLOWEST mode's
    relaxation time 1/omega_1 — at the phonon-regime defaults that is
    1.35 while one block projects only 0.5."""
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    spec = mrbp.Spec(lattice_depth=v0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=nop,
                     supercell_size=float(supercell or nop),
                     tbf_contact_cutoff=rm)
    sampling = dmc.Sampling(
        spec, time_step=dt, max_num_walkers=walkers + walkers // 8,
        target_num_walkers=walkers, rng_seed=seed,
        ssf_est_spec=dmc.SSFEstSpec(num_modes=num_modes,
                                    as_pure_est=True,
                                    pfw_num_time_steps=pfw_steps or nts))
    rng = np.random.default_rng(1)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(walkers)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    it = sampling.blocks(state, nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    vals, ws = [], []
    win = max(1, (pfw_steps or nts) // nts)
    for i in range(blocks):
        b = next(it)
        if (i + 1) % win:
            continue                # window still accumulating
        # Fully-forward-walked value: the last step of the
        # window-final block (same selection as the exec driver's
        # `_BlockAccumulator.add`, qmc_exec/dmc.py win_final).
        vals.append(np.asarray(b.iter_ssf, dtype=np.float64)[-1, :, 0])
        ws.append(float(np.asarray(b.iter_props.num_walkers,
                                   dtype=np.float64)[-1]))
    vals = np.stack(vals)
    ws = np.asarray(ws)
    mean = vals.sum(axis=0) / ws.sum() / nop
    if len(ws) >= 2:          # delete-one-window jackknife
        loo = np.stack([(vals.sum(axis=0) - vals[i])
                        / (ws.sum() - ws[i]) / nop
                        for i in range(len(ws))])
        err = np.sqrt((len(ws) - 1) / len(ws)
                      * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
    else:
        err = np.full_like(mean, np.nan)
    return mean, err


def lattice_run(v0, gn, nop, walkers, nts, blocks, dt, est_every,
                num_modes, num_lags, itc_mult, pfw_blocks, cm_blocks,
                rm, burn, seed=7, pure_itc=False):
    """ONE deep-lattice run measuring the three ingredients of the
    lattice phonon-speed closure together: the imaginary-time
    correlation F(k, tau) (mixed by default, deep lags), the PURE
    forward-walked S(k) (``pfw_blocks``-block windows), and the
    CM-diffusion phase stiffness (``cm_blocks``-block windows).
    ``blocks`` must be a common multiple of both window lengths so
    every window closes.

    ``pure_itc=True`` swaps in the forward-walked ITC (accumulating
    across the same ``pfw_blocks``-block windows as the pure S(k), one
    statistics sample per window): at v0 > 0 the trial function is NOT
    exact, so pure-vs-hybrid is a REAL A/B — the natively-pure
    amplitude must agree with the mixed amplitude re-anchored to the
    pure S(k) (two independent bias-elimination routes).

    Physics: in a lattice, Galilean invariance is broken and the
    Luttinger relation ``c^2 = v_J v_N`` splits the sound speed into
    the phase stiffness ``v_J = v_F (m/m*)`` (CM diffusion; Leggett's
    T = 0 identity) and the thermodynamic ``v_N`` (compressibility sum
    rule ``m_{-1}(k -> 0) -> `` per-particle ``(1/2n) dn/dmu``), so::

        c_lattice = sqrt((m/m*) / m_{-1})

    while the same run's F(k, tau) dispersion fits read ``c`` directly
    — two routes through DIFFERENT estimator chains that must agree
    with NO exact solution available (the v0 = 0 limit of both is the
    Bethe-ansatz-validated four-way closure, eos_sound_speed.py).
    """
    from phd_qmclib_tpu import analysis
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    if blocks % pfw_blocks or blocks % cm_blocks:
        raise ValueError("blocks must close every pfw/cm window")
    spec = mrbp.Spec(lattice_depth=v0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=rm)
    sampling = dmc.Sampling(
        spec, time_step=dt, max_num_walkers=walkers + walkers // 8,
        target_num_walkers=walkers, rng_seed=seed, est_every=est_every,
        ssf_est_spec=dmc.SSFEstSpec(num_modes=num_modes,
                                    as_pure_est=True,
                                    pfw_num_time_steps=pfw_blocks * nts),
        itc_est_spec=dmc.ITCEstSpec(num_modes=num_modes,
                                    num_lags=num_lags,
                                    est_every_mult=itc_mult,
                                    as_pure_est=pure_itc,
                                    pfw_num_time_steps=(
                                        pfw_blocks * nts if pure_itc
                                        else None)),
        cm_diffusion_est=True, cm_window_blocks=cm_blocks)
    rng = np.random.default_rng(1)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                               offset=rng.uniform(0, nop))
        for _ in range(walkers)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    it = sampling.blocks(state, nts, burn_in_blocks=burn)
    for _ in range(burn):
        next(it)
    sums_b, counts_b = [], []
    ssf_vals, ssf_ws = [], []
    cmds, nws = [], []
    for i in range(blocks):
        b = next(it)
        if pure_itc:
            # One window sample per closed pfw window (the
            # end-of-window value; interior blocks hold partial,
            # under-projected accumulations).
            if not (i + 1) % pfw_blocks:
                sums_b.append(
                    np.asarray(b.iter_itc, dtype=np.float64)[-1])
                counts_b.append(
                    np.asarray(b.iter_itc_nw, dtype=np.float64)[-1])
        else:
            sums_b.append(np.asarray(b.iter_itc, dtype=np.float64)
                          .sum(axis=0))
            counts_b.append(np.asarray(b.iter_itc_nw,
                                       dtype=np.float64).sum(axis=0))
        nw_steps = np.asarray(b.iter_props.num_walkers,
                              dtype=np.float64)
        cmds.append(np.asarray(b.iter_cmd, dtype=np.float64))
        nws.append(nw_steps[est_every - 1::est_every]
                   if b.iter_cmd.shape[0] * est_every == nts
                   else nw_steps)
        if not (i + 1) % pfw_blocks:    # window-final pure S(k)
            ssf_vals.append(np.asarray(b.iter_ssf,
                                       dtype=np.float64)[-1, :, 0])
            ssf_ws.append(float(nw_steps[-1]))
    # Pure S(k): one sample per closed forward-walking window.
    vals, ws = np.stack(ssf_vals), np.asarray(ssf_ws)
    s_pure = vals.sum(axis=0) / ws.sum() / nop
    loo = np.stack([(vals.sum(axis=0) - vals[i]) / (ws.sum() - ws[i])
                    / nop for i in range(len(ws))])
    s_pure_err = np.sqrt((len(ws) - 1) / len(ws)
                         * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
    # Phase stiffness m/m* from the stitched CM-diffusion windows.
    rows = cmds[0].shape[0]
    cmd = np.stack(cmds).reshape(blocks // cm_blocks,
                                 cm_blocks * rows, 2)
    nw = np.stack(nws).reshape(blocks // cm_blocks, cm_blocks * rows)
    stiff, stiff_err = analysis.effective_mass_from_cm_diffusion(
        (nts // rows) * dt, cmd, nw, nop)
    lag_dt = est_every * itc_mult * dt
    kz = np.arange(num_modes) * 2 * np.pi / spec.supercell_size
    return {"k": kz, "sums_b": np.stack(sums_b),
            "counts_b": np.stack(counts_b), "lag_dt": lag_dt,
            "nop": nop, "supercell": float(spec.supercell_size),
            "s_pure": s_pure, "s_pure_err": s_pure_err,
            "stiffness": float(stiff),
            "stiffness_err": float(stiff_err)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tg", action="store_true",
                   help="Tonks-Girardeau free-fermion validation point")
    p.add_argument("--walkers", type=int, default=4096)
    p.add_argument("--nop", type=int, default=16)
    p.add_argument("--blocks", type=int, default=24)
    p.add_argument("--deep", action="store_true",
                   help="phonon mode with est_every_mult-stretched "
                   "lags (tau_max ~ 4.1, omega_1 tau_max > 1: the "
                   "regime where the tail fit actually undercuts the "
                   "Feynman bound) and 4x the walkers")
    p.add_argument("--lattice", action="store_true",
                   help="deep-lattice phonon closure: the ITC "
                   "dispersion vs the Galilean-broken Luttinger split "
                   "c = sqrt((m/m*)/m_{-1}) (CM-diffusion stiffness x "
                   "compressibility sum rule) — NO exact solution "
                   "exists at v0 > 0")
    p.add_argument("--v0", type=float, default=20.0,
                   help="lattice depth for --lattice (UE units; "
                   "20 = 2 ER, the production flagship regime)")
    p.add_argument("--gn", type=float, default=1.0,
                   help="interaction strength for --lattice")
    p.add_argument("--lat-blocks", type=int, default=96,
                   help="--lattice run length (a common multiple of "
                   "the pfw and cm windows)")
    p.add_argument("--lat-nts", type=int, default=512)
    p.add_argument("--lat-lags", type=int, default=64)
    p.add_argument("--lat-mult", type=int, default=16,
                   help="ITC est_every_mult for --lattice (lag unit "
                   "= est_every * this * dt)")
    p.add_argument("--lat-pfw-blocks", type=int, default=8)
    p.add_argument("--lat-cm-blocks", type=int, default=16)
    p.add_argument("--lat-burn", type=int, default=16)
    p.add_argument("--tg-mult", type=int, default=1,
                   help="ITC est_every_mult for --tg: stretches "
                   "tau_max at fixed lag count (4 -> omega_1 tau_max "
                   "~ 2.4, where the m_{-1} tail completion closes)")
    p.add_argument("--pure", action="store_true",
                   help="forward-walked (pure) ITC estimator instead "
                   "of mixed")
    args = p.parse_args()

    if args.lattice:
        # One run, three estimator chains (ITC deep lags + pure S(k)
        # windows + CM-diffusion windows) at the production lattice
        # regime scaled to a spectroscopy-friendly box (k_1 = 2 pi/16:
        # omega_1 ~ 0.4, so tau_max = 8.2 gives omega_1 tau_max ~ 3).
        out = lattice_run(v0=args.v0, gn=args.gn, nop=args.nop,
                          walkers=args.walkers, nts=args.lat_nts,
                          blocks=args.lat_blocks, dt=1e-3, est_every=8,
                          num_modes=6, num_lags=args.lat_lags,
                          itc_mult=args.lat_mult,
                          pfw_blocks=args.lat_pfw_blocks,
                          cm_blocks=args.lat_cm_blocks, rm=0.3,
                          burn=args.lat_burn, pure_itc=args.pure)
        itcb = itc_blocks(out)
        kz = out["k"]
        s_pure, s_pure_err = out["s_pure"], out["s_pure_err"]
        stiff, stiff_err = out["stiffness"], out["stiffness_err"]
        fit, fit_err = itcb.excitation_fit()
        spec = itcb.spectral_function(num_omega=96)
        # Mixed ITC: re-anchor the amplitude to the same run's pure
        # S(k) (hybrid).  Pure ITC: the amplitude is already pure —
        # no rescale, making pure-vs-hybrid a genuine two-route A/B.
        sr = itcb.static_response() if args.pure else \
            itcb.static_response(ssf=s_pure, ssf_err=s_pure_err)
        with np.errstate(invalid="ignore", divide="ignore"):
            c_tail = fit / kz
            c_tail_err = fit_err / kz
            c_peak = spec["omega_peak"] / kz
            # Galilean-broken Luttinger split: c^2 = v_J v_N with
            # v_J = v_F (m/m*) (Leggett stiffness = CM diffusion) and
            # v_N the thermodynamic branch the compressibility sum
            # rule measures (m_{-1} -> per-particle (1/2n) dn/dmu, a
            # lattice-blind identity), i.e. c = sqrt((m/m*) / m_{-1}).
            # sr["sound_speed"] is the hybrid 1/sqrt(m_{-1}); the
            # stiffness enters at half weight.
            c_split = np.sqrt(stiff) * sr["sound_speed"]
            c_split_err = c_split * np.sqrt(
                (0.5 * stiff_err / stiff) ** 2
                + (sr["sound_speed_err"] / sr["sound_speed"]) ** 2)
            feyn_pure = np.full_like(s_pure, np.nan)
            feyn_pure[1:] = kz[1:] ** 2 / s_pure[1:]
        # Bound ordering per resolved mode (2-sigma slack): the tail
        # decay rate is the lowest surviving excitation, m0/m_{-1} an
        # upper bound on the lowest, Feynman m1/m0 a (looser) mean.
        order_ok = []
        for j in range(1, len(kz)):
            if not (np.isfinite(fit[j])
                    and np.isfinite(sr["omega_bound"][j])):
                continue
            slack1 = 2.0 * (np.nan_to_num(fit_err[j])
                            + np.nan_to_num(sr["omega_bound_err"][j]))
            slack2 = 2.0 * (np.nan_to_num(sr["omega_bound_err"][j])
                            + np.nan_to_num(s_pure_err[j])
                            * feyn_pure[j] / max(s_pure[j], 1e-12))
            order_ok.append(bool(
                fit[j] <= sr["omega_bound"][j] + slack1
                and sr["omega_bound"][j] <= feyn_pure[j] + slack2))
        # Per-mode stiffness-corrected single-mode closure: when one
        # branch carries the density channel at mode k, the inversion
        # peak and the split speed are two functionals of the SAME
        # pole (omega_peak = sqrt(stiffness) k / sqrt(m_{-1})) read
        # through DIFFERENT estimator chains (F-shape vs CM-diffusion
        # x tau-integral x pure amplitude) — their ratio -> 1 is the
        # lattice analog of the v0 = 0 four-way closure.  Expected to
        # open at the lowest k, where the m_{-1} tail completion is
        # mostly extrapolation and multi-branch weight matters.
        with np.errstate(invalid="ignore", divide="ignore"):
            sma_ratio = c_peak / c_split
        # k -> 0 sound speed: quadratic-in-k extrapolation of the
        # split speed over the first three modes (the finite-k rise
        # is dispersion curvature, analytic in k^2).
        kk = kz[1:4] ** 2
        cc = c_split[1:4]
        if np.isfinite(cc).all():
            coef = np.polyfit(kk, cc, 1)
            c_split0 = float(coef[1])
        else:
            c_split0 = float("nan")
        # v0 = 0 exact values at the same physical coupling: the
        # lattice must REDUCE the k -> 0 sound speed and the
        # thermodynamic Luttinger K from these.
        from phd_qmclib_tpu.lieb_liniger import ground_state
        n = out["nop"] / out["supercell"]
        ll = ground_state(args.gn / (2.0 * n ** 2), density=n,
                          num_points=256)
        v_f = 2.0 * np.pi * n
        k_thermo = v_f * np.sqrt(stiff * sr["m_minus1"][1])
        print(json.dumps({
            "mode": "lattice", "v0": args.v0, "gn": args.gn,
            "itc_pure": bool(args.pure),
            "density": n, "tau_max": float(itcb.tau_grid[-1]),
            "stiffness_m_over_mstar": stiff,
            "stiffness_err": stiff_err,
            "s_k_pure": s_pure.tolist(),
            "s_k_pure_err": s_pure_err.tolist(),
            "c_dispersion_tail": c_tail.tolist(),
            "c_dispersion_tail_err": c_tail_err.tolist(),
            "c_dispersion_peak": c_peak.tolist(),
            "c_luttinger_split": c_split.tolist(),
            "c_luttinger_split_err": c_split_err.tolist(),
            "sma_closure_peak_over_split": sma_ratio.tolist(),
            "c_split_k0_extrapolated": c_split0,
            "feynman_pure": feyn_pure.tolist(),
            "omega_bound_m0_over_m_minus1":
                sr["omega_bound"].tolist(),
            "bound_ordering_ok": order_ok,
            "chi_hybrid": sr["chi"].tolist(),
            "chi_hybrid_err": sr["chi_err"].tolist(),
            "luttinger_k_thermo_k1": float(k_thermo),
            "c_exact_v0_0": ll["sound_speed"],
            "luttinger_k_exact_v0_0": ll["luttinger_k"],
            "galilean_breaking_ok": bool(
                stiff + 2.0 * stiff_err < 1.0
                and k_thermo < ll["luttinger_k"]),
            "lattice_reduces_c_ok": bool(
                np.isfinite(c_split0)
                and c_split0 < ll["sound_speed"]),
        }))
        return

    if args.tg:
        # gamma = 5000: free-fermion particle-hole decays, exact.
        nop = 5
        # 24 lags: omega_1 * tau_max ~ 0.6, deep enough that the
        # spectral-inversion moment closure below is conditioned (at
        # 8 lags the decay barely registers and omega_mean inflates
        # ~15% from smoothing alone).  --tg-mult stretches the lag
        # unit (tau_max scales with it at fixed buffer/lag count):
        # the documented ~2.5% m_{-1} tail-completion deficit at
        # omega_1 tau_max ~ 0.6 must shrink below ~1% at mult = 4
        # (omega_1 tau_max ~ 2.4), closing the static-response gate.
        # --pure swaps in the forward-walked estimator (identical
        # expectations here — the trial function is exact at the TG
        # point — so it A/Bs the pure transport at production scale).
        out = measure(v0=0.0, gn=1e4, nop=nop, walkers=args.walkers,
                      nts=512, blocks=args.blocks, dt=5e-5,
                      est_every=64, num_modes=4, num_lags=24, rm=1.2,
                      burn=8, regular_init=True,
                      itc_mult=args.tg_mult, pure=args.pure)
        kz, tau = out["k"], out["tau"]
        # Exact particle-hole sums.
        q = 2 * np.pi / nop * np.arange(-(nop // 2), nop // 2 + 1)
        fs = set(np.round(q, 12))
        exact = np.zeros((len(tau), len(kz)))
        for j, k in enumerate(kz):
            for qi in q:
                if j and round(qi + k, 12) not in fs:
                    exact[:, j] += np.exp(
                        -((qi + k) ** 2 - qi ** 2) * tau) / nop
        err = np.abs(out["f"][:, 1:] - exact[:, 1:]).max()
        # Spectral inversion closure: invert the MEASURED F(k, tau)
        # and compare the recovered moments against the exact
        # particle-hole spectrum (a handful of delta functions at
        # E_ph = (q+k)^2 - q^2, weight 1/N each).  The inversion can
        # never resolve the individual poles at this tau_max, but m0
        # and m1/m0 are exact functionals — they must land on the
        # free-fermion values within the measurement error.
        # The discrepancy-principle smoothing has its own finite
        # resolution (at sigma ~ 1e-3 and omega_1 tau_max ~ 0.6 the
        # smoothest consistent spectrum overshoots omega_mean by
        # ~10% at k_1) — so the pipeline gate is the deviation vs a
        # CONTROL inversion of the EXACT F on the same grid at the
        # same noise scale, which isolates what the measurement
        # itself contributes.
        from phd_qmclib_tpu.analysis import spectral_function_from_itc
        m0_exact = np.full(len(kz), np.nan)
        mean_exact = np.full(len(kz), np.nan)
        m0_meas = np.full(len(kz), np.nan)
        mean_meas = np.full(len(kz), np.nan)
        mean_ctrl = np.full(len(kz), np.nan)
        for j, k in enumerate(kz):
            if not j:
                continue
            e_ph = np.array([(qi + k) ** 2 - qi ** 2 for qi in q
                             if round(qi + k, 12) not in fs])
            m0_exact[j] = len(e_ph) / nop
            mean_exact[j] = e_ph.mean()
            sig = np.maximum(out["f_err"][:, j], 1e-7)
            _, _, info = spectral_function_from_itc(
                tau, out["f"][:, j], sig,
                omega_max=4.0 * e_ph.max(), num_omega=96)
            m0_meas[j] = info["m0"]
            mean_meas[j] = info["omega_mean"]
            _, _, ctrl = spectral_function_from_itc(
                tau, exact[:, j], sig,
                omega_max=4.0 * e_ph.max(), num_omega=96)
            mean_ctrl[j] = ctrl["omega_mean"]
        # Static-response closure: m_{-1}(k) = sum_ch (1/N)/E_ph
        # exactly at the TG point (each particle-hole channel is a
        # delta pole of weight 1/N).  k_1 has a SINGLE channel here
        # (N = 5), so its tail completion is exact up to noise; the
        # multi-channel modes carry the documented tail-fit
        # underestimate, which this closure quantifies.
        sr = itc_blocks(out).static_response()
        m_exact = np.full(len(kz), np.nan)
        for j, k in enumerate(kz):
            if not j:
                continue
            e_ph = np.array([(qi + k) ** 2 - qi ** 2 for qi in q
                             if round(qi + k, 12) not in fs])
            m_exact[j] = (1.0 / e_ph).sum() / nop
        sr_dev = np.nanmax(np.abs(sr["m_minus1"] / m_exact - 1.0))
        print(json.dumps({
            "mode": "tg", "max_abs_dev_vs_free_fermions": float(err),
            "static_m_minus1_measured": sr["m_minus1"].tolist(),
            "static_m_minus1_err": sr["m_minus1_err"].tolist(),
            "static_m_minus1_exact": m_exact.tolist(),
            "static_m_minus1_max_rel_dev": float(sr_dev),
            "static_omega_bound": sr["omega_bound"].tolist(),
            "s_k_measured": out["s_k"].tolist(),
            "s_k_exact": exact[0].tolist(),
            "inversion_m0_measured": m0_meas.tolist(),
            "inversion_m0_exact": m0_exact.tolist(),
            "inversion_omega_mean_measured": mean_meas.tolist(),
            "inversion_omega_mean_exact": mean_exact.tolist(),
            "inversion_omega_mean_smoothing_control": mean_ctrl.tolist(),
            "inversion_max_rel_dev_omega_mean": float(np.nanmax(
                np.abs(mean_meas / mean_exact - 1.0))),
            "inversion_max_rel_dev_vs_control": float(np.nanmax(
                np.abs(mean_meas / mean_ctrl - 1.0)))}))
        return

    # Phonon regime: quasi-flat gas, moderate coupling.  At the
    # default (shallow-lag) scale omega_1 * tau_max ~ 0.05 and the
    # log-derivative overshoots toward (and, noise-biased, past) the
    # f-sum average — only --deep stretches the lag unit far enough
    # (omega_1 * tau_max > 1) for the decay to resolve below the
    # Feynman bound.
    if args.deep:
        out = measure(v0=1.0, gn=2.0, nop=args.nop,
                      walkers=max(args.walkers, 16384), nts=512,
                      blocks=max(args.blocks, 64), dt=1e-3,
                      est_every=8, num_modes=8, num_lags=64,
                      itc_mult=8, burn=12, pure=args.pure)
    else:
        out = measure(v0=1.0, gn=2.0, nop=args.nop,
                      walkers=args.walkers, nts=512,
                      blocks=args.blocks, dt=1e-3, est_every=8,
                      num_modes=8, num_lags=12, pure=args.pure)
    kz = out["k"]
    # f-sum consistency: the FIRST log-derivative is the mean
    # excitation energy of the density channel, which IS the Feynman
    # ratio k^2/S(k) (both are f-sum / S(k)) up to the finite first
    # lag — these two columns must agree mode by mode.
    omega_first = out["omega_eff"][0]
    # Spectral narrowing: the per-mode tail fit must land BELOW the
    # first-lag mean energy wherever it resolved (the decay stiffens
    # toward the slowest surviving excitation).  Note the tail rate
    # is compared against the MIXED-estimator Feynman ratio: at low k
    # the mixed S(k) carries trial-wavefunction bias, so tail rates a
    # few 10% above that ratio diagnose the S(k) bias rather than a
    # bound violation (the true bound uses the exact S(k)).
    fit = out["omega_fit"]
    narrowing = (fit < omega_first) | ~np.isfinite(fit)
    c_itc = float(np.polyfit(kz[1:3], fit[1:3], 1)[0])
    # Spectral inversion per mode: omega_peak reads the dominant
    # excitation branch directly (the phonon dispersion), omega_mean
    # = m1/m0 must land on the same run's Feynman ratio (f-sum).  At
    # high k the decay dives under the noise floor within a lag or
    # two and the inversion is skipped (NaN).
    from phd_qmclib_tpu.analysis import spectral_function_from_itc
    inv_mean = np.full(len(kz), np.nan)
    inv_peak = np.full(len(kz), np.nan)
    for j in range(1, len(kz)):
        try:
            _, _, info = spectral_function_from_itc(
                out["tau"], out["f"][:, j],
                np.maximum(out["f_err"][:, j], 1e-7), num_omega=96)
        except ValueError:
            continue
        inv_mean[j] = info["omega_mean"]
        inv_peak[j] = info["omega_peak"]
    fin_pk = np.isfinite(inv_peak[1:3]).all()
    c_inv = float(np.polyfit(kz[1:3], inv_peak[1:3], 1)[0]) \
        if fin_pk else float("nan")
    from phd_qmclib_tpu.analysis import sound_speed_from_ssf
    c_ssf, c_ssf_err = sound_speed_from_ssf(
        kz, out["s_k"], np.full_like(out["s_k"], 1e-3), num_modes=3)
    payload = {
        "mode": "phonon-deep" if args.deep else "phonon",
        "k": kz.tolist(),
        "tau_max": float(out["tau"][-1]),
        "s_k_mixed": out["s_k"].tolist(),
        "omega_first_lag": omega_first.tolist(),
        "omega_tail_fit": fit.tolist(),
        "fit_windows_tau": out["fit_windows"].tolist(),
        "feynman_ratio_mixed": out["feynman"].tolist(),
        "narrowing_ok": narrowing.tolist(),
        "inversion_omega_mean": inv_mean.tolist(),
        "inversion_omega_peak": inv_peak.tolist(),
        "sound_speed_itc_tail": c_itc,
        "sound_speed_inversion_peak": c_inv,
        "sound_speed_feynman_mixed": float(c_ssf)}
    # Compressibility sum rule: chi(k) = -2 m_{-1}(k) -> -2/c^2 as
    # k -> 0, so 1/sqrt(m_{-1}(k_1)) is a THIRD sound-speed route,
    # independent of both the S(k) slope and the dispersion fits.
    # The tail completion uses the fitted decay (an upper bound), so
    # this c carries a small UPWARD bias that dies as omega_1 tau_max
    # grows — honest only in --deep (shallow lags barely resolve the
    # decay and the k_1 tail is nearly all extrapolation).
    sr = itc_blocks(out).static_response()
    payload.update({
        "static_chi": sr["chi"].tolist(),
        "static_chi_err": sr["chi_err"].tolist(),
        "static_omega_bound": sr["omega_bound"].tolist(),
        "sound_speed_compressibility": float(sr["sound_speed"][1]),
        "sound_speed_compressibility_err":
            float(sr["sound_speed_err"][1])})
    if args.deep:
        # The honest Feynman reference: pure (forward-walked) S(k)
        # from a companion run strips the trial bias the mixed S(k)
        # carries at small k.  Gate: tail rate <= pure ratio within
        # tolerance at every resolved mode.
        # 2048-step (4-block) forward-walking windows: tau_fw = 2.05
        # covers the slowest mode's relaxation time 1/omega_1 = 1.35
        # (one block projects only 0.5 and leaves S(k_1) visibly
        # trial-biased — the Feynman ratio then sits BELOW the
        # measured decay, a false bound violation).
        s_pure, _ = pure_ssf(v0=1.0, gn=2.0, nop=args.nop,
                             walkers=max(args.walkers, 16384), nts=512,
                             blocks=24, dt=1e-3, num_modes=8, burn=12,
                             pfw_steps=2048)
        feyn_pure = np.full_like(s_pure, np.nan)
        feyn_pure[1:] = kz[1:] ** 2 / s_pure[1:]
        below = (fit <= 1.05 * feyn_pure) | ~np.isfinite(fit)
        payload.update({
            "s_k_pure": s_pure.tolist(),
            "feynman_ratio_pure": feyn_pure.tolist(),
            "tail_below_pure_feynman_ok": below.tolist()})
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
