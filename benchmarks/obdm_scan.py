"""OBDM / momentum-distribution scan over the interaction strength.

Physics validation of the OBDM estimator at production scale: for the
1D lattice Bose gas the (quasi-)condensate fraction ``n(0)/N`` must
decrease monotonically with the contact coupling ``gn`` (stronger
correlations deplete the zero mode; in the Tonks-Girardeau limit the
occupations spread over many modes).  For each coupling the script
measures the variational (VMC), mixed (DMC), and extrapolated
``2*mixed - vmc`` OBDMs and the resulting mode occupations.

Run: PYTHONPATH=. python benchmarks/obdm_scan.py
"""
import argparse
import time

import numpy as np

from phd_qmclib_tpu import analysis
from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import dmc, vmc


def measure_vmc(spec, num_pos, num_walkers, nts, nblocks, seed):
    sampling = vmc.Sampling(
        spec, move_spread=0.25, rng_seed=seed, num_walkers=num_walkers,
        obd_est_spec=vmc.OBDEstSpec(num_pos=num_pos))
    # REGULAR (lattice-spaced) starts: RANDOM initial configurations
    # contain near-contact pairs whose wavefunction-ratio estimator
    # values are enormous (psi -> 0 in the denominator), and at strong
    # coupling the transient out of them dominates any feasible run
    # length - the n1 <= 1 bound only holds in equilibrium.
    rng = np.random.default_rng(seed)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.SysConfDistType.REGULAR,
                               rng=rng)
        for _ in range(num_walkers)]).astype(np.float32)
    state = sampling.build_state(confs)
    blocks = sampling.blocks(nts, state)
    for _ in range(6):
        next(blocks)  # burn-in / equilibration
    total = np.zeros(num_pos)
    for _ in range(nblocks):
        b = next(blocks)
        total += np.asarray(b.iter_obd, dtype=np.float64).mean(axis=0)
    return total / (nblocks * num_walkers), b.last_state


def measure_dmc(spec, num_pos, ini_pos, target, nts, nblocks, seed):
    sampling = dmc.Sampling(
        spec, time_step=1e-3, max_num_walkers=target + target // 8,
        target_num_walkers=target, rng_seed=seed,
        obd_est_spec=dmc.OBDEstSpec(num_pos=num_pos, as_pure_est=False))
    state = sampling.build_state(np.asarray(ini_pos), dtype=np.float32)
    blocks = sampling.blocks(state, num_time_steps_block=nts,
                             burn_in_blocks=2)
    for _ in range(2):
        next(blocks)
    total = np.zeros(num_pos)
    norm = 0.0
    for _ in range(nblocks):
        b = next(blocks)
        total += np.asarray(b.iter_obd, dtype=np.float64).sum(axis=0)
        norm += float(np.asarray(b.iter_props.num_walkers,
                                 dtype=np.float64).sum())
    return total / norm


def fused_scan(args):
    """All couplings fused: one VmcSweep dispatch stream for the
    variational stage, one ParamSweep stream for the DMC stage —
    4 x 2048 under-filled rows batch into full-chip dispatches."""
    from phd_qmclib_tpu.parallel.sweep import ParamSweep, VmcSweep

    N, L = args.nop, float(args.nop)
    gns = args.couplings
    num_pos = args.num_pos
    offsets = np.linspace(0.0, L / 2, num_pos)
    specs = [mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                       interaction_strength=gn, boson_number=N,
                       supercell_size=L, tbf_contact_cutoff=0.4)
             for gn in gns]

    # -- VMC stage, fused -------------------------------------------------
    vmc_rows = tuple(
        vmc.Sampling(spec, move_spread=0.25, rng_seed=101 + i,
                     num_walkers=args.walkers,
                     obd_est_spec=vmc.OBDEstSpec(num_pos=num_pos))
        for i, spec in enumerate(specs))
    sweep_v = VmcSweep(vmc_rows)
    conf_sets = []
    for i, spec in enumerate(specs):
        rng = np.random.default_rng(101 + i)
        conf_sets.append(np.stack([
            spec.init_get_sys_conf(
                dist_type=mrbp.SysConfDistType.REGULAR, rng=rng)
            for _ in range(args.walkers)]).astype(np.float32))
    state = sweep_v.build_states(conf_sets)
    it = sweep_v.blocks(args.nts, state)
    for _ in range(6):
        b = next(it)  # equilibration
    n1_vmc = np.zeros((len(gns), num_pos))
    for _ in range(args.blocks):
        b = next(it)
        n1_vmc += np.asarray(b.iter_obd, dtype=np.float64).mean(axis=1)
    n1_vmc /= args.blocks * args.walkers
    vmc_pos = np.asarray(b.last_state.pos)  # (R, W, N)

    # -- DMC stage, fused -------------------------------------------------
    target = args.walkers
    dmc_rows = tuple(
        dmc.Sampling(spec, time_step=1e-3,
                     max_num_walkers=target + target // 8,
                     target_num_walkers=target, rng_seed=202 + i,
                     obd_est_spec=dmc.OBDEstSpec(num_pos=num_pos,
                                                 as_pure_est=False))
        for i, spec in enumerate(specs))
    sweep_d = ParamSweep(dmc_rows)
    d_state = sweep_d.build_states(list(vmc_pos), dtype=np.float32)
    dit = sweep_d.blocks(d_state, args.nts, burn_in_blocks=2)
    for _ in range(2):
        next(dit)
    n1_mix = np.zeros((len(gns), num_pos))
    norm = np.zeros(len(gns))
    for _ in range(args.blocks):
        db = next(dit)
        n1_mix += np.asarray(db.iter_obd, dtype=np.float64).sum(axis=1)
        norm += np.asarray(db.iter_props.num_walkers,
                           dtype=np.float64).sum(axis=0)
    n1_mix /= norm[:, None]

    prev_f0 = None
    for r, gn in enumerate(gns):
        n1_ext = analysis.extrapolated_estimate(n1_mix[r], n1_vmc[r])
        _, occ_vmc = analysis.momentum_distribution(
            offsets, n1_vmc[r], L, N)
        _, occ_mix = analysis.momentum_distribution(
            offsets, n1_mix[r], L, N)
        _, occ_ext = analysis.momentum_distribution(
            offsets, n1_ext, L, N)
        f0 = occ_ext[0] / N
        print(f"  {gn:6.1f} {occ_vmc[0] / N:8.4f} "
              f"{occ_mix[0] / N:9.4f} {f0:8.4f} {n1_ext[-1]:8.4f}")
        if prev_f0 is not None:
            assert f0 < prev_f0 + 0.02, \
                "condensate fraction should fall with coupling"
        prev_f0 = f0
    print("# PASS: condensate depletion monotone in the coupling "
          "(fused)")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=32)
    parser.add_argument("--num-pos", type=int, default=17)
    parser.add_argument("--walkers", type=int, default=2048)
    parser.add_argument("--nts", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=6)
    parser.add_argument("--couplings", type=float, nargs="+",
                        default=[0.5, 2.0, 8.0, 32.0])
    parser.add_argument("--fused", action="store_true",
                        help="fuse all couplings into one VmcSweep + "
                             "ParamSweep dispatch stream")
    args = parser.parse_args()

    if args.fused:
        t0 = time.perf_counter()
        N, L = args.nop, float(args.nop)
        print(f"# OBDM fused scan: N={N}, L={L}, grid={args.num_pos}, "
              f"{args.walkers} walkers/row, {args.blocks}x{args.nts} "
              f"steps")
        print(f"# {'gn':>6} {'f0_vmc':>8} {'f0_mixed':>9} "
              f"{'f0_extr':>8} {'n1(L/2)':>8}")
        fused_scan(args)
        print(f"# elapsed {time.perf_counter() - t0:.1f} s")
        return

    N = args.nop
    L = float(N)
    print(f"# OBDM scan: N={N}, L={L}, grid={args.num_pos}, "
          f"{args.walkers} walkers, {args.blocks}x{args.nts} steps")
    print(f"# {'gn':>6} {'f0_vmc':>8} {'f0_mixed':>9} {'f0_extr':>8} "
          f"{'n1(L/2)':>8} {'secs':>6}")
    prev_f0 = None
    for gn in args.couplings:
        t0 = time.perf_counter()
        spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                         interaction_strength=gn, boson_number=N,
                         supercell_size=L, tbf_contact_cutoff=0.4)
        offsets = np.linspace(0.0, L / 2, args.num_pos)
        n1_vmc, vmc_state = measure_vmc(
            spec, args.num_pos, args.walkers, args.nts, args.blocks,
            seed=101)
        ini = np.asarray(vmc_state.pos)
        reps = -(-args.walkers // ini.shape[0])
        ini = np.tile(ini, (reps, 1))[:args.walkers]
        n1_mix = measure_dmc(spec, args.num_pos, ini, args.walkers,
                             args.nts, args.blocks, seed=202)
        n1_ext = analysis.extrapolated_estimate(n1_mix, n1_vmc)
        _, occ_vmc = analysis.momentum_distribution(offsets, n1_vmc, L, N)
        _, occ_mix = analysis.momentum_distribution(offsets, n1_mix, L, N)
        _, occ_ext = analysis.momentum_distribution(offsets, n1_ext, L, N)
        secs = time.perf_counter() - t0
        f0 = occ_ext[0] / N
        print(f"  {gn:6.1f} {occ_vmc[0] / N:8.4f} {occ_mix[0] / N:9.4f} "
              f"{f0:8.4f} {n1_ext[-1]:8.4f} {secs:6.1f}")
        if prev_f0 is not None:
            assert f0 < prev_f0 + 0.02, \
                "condensate fraction should fall with coupling"
        prev_f0 = f0
    print("# PASS: condensate depletion monotone in the coupling")


if __name__ == "__main__":
    main()
