"""Finite-size sweep E/N(N) -> E/N(inf) through the production path
(round-5 verdict item 4's measurement half).

Runs DMC rows at N = 32..256 at FIXED density and physical coupling
(same v0, gn, dt, walker target — the dt and population-control biases
are then common mode), stores every row as a group of one HDF5 file,
and runs the ``analyze --fs-fit`` extrapolation over it: a weighted
fit in x = 1/N^2 (the PBC Luttinger-liquid Casimir correction).

The N-scaling shapes are the proven-stable ones from
``benchmarks/n_scaling.py``; rows run sequentially (one device process
at a time).  For v0 = 0 the exact Bethe-ansatz energy would BE the
N -> inf target; at the flagship lattice regime (v0 = 20) no exact
solution exists and the fit's check-fit/chi2 diagnostics carry the
credibility.

Run: PYTHONPATH=. \
       python benchmarks/fs_sweep.py [--v0 0.0] [--out fs_sweep.h5]
"""
import argparse
import json
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--v0", type=float, default=20.0)
    parser.add_argument("--gn", type=float, default=1.0)
    parser.add_argument("--dt", type=float, default=1e-3)
    parser.add_argument("--walkers", type=int, default=4096)
    parser.add_argument("--blocks", type=int, default=24)
    parser.add_argument("--nts", type=int, default=512)
    parser.add_argument("--burn", type=int, default=8)
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[32, 64, 128, 256])
    parser.add_argument("--out", default="fs_sweep.h5")
    parser.add_argument("--dry", action="store_true",
                        help="tiny CPU smoke run (logic check only)")
    args = parser.parse_args()

    if args.dry:
        import jax
        jax.config.update("jax_platforms", "cpu")
        args.sizes = [4, 6, 8]
        args.walkers, args.blocks, args.nts, args.burn = 64, 3, 16, 1

    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache(min_compile_time_secs=0.5)

    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
    from phd_qmclib_tpu.qmc_exec.io import DmcHDF5FileHandler
    from phd_qmclib_tpu.qmc_exec.report import summarize_fs_fit

    entries = []
    for i, nop in enumerate(args.sizes):
        spec = mrbp.Spec(lattice_depth=args.v0, lattice_ratio=1.0,
                         interaction_strength=args.gn,
                         boson_number=nop, supercell_size=float(nop),
                         tbf_contact_cutoff=0.4 if not args.dry
                         else 0.3)
        proc = dmc_exec.Proc(
            model_spec=spec, time_step=args.dt,
            max_num_walkers=args.walkers + args.walkers // 8,
            target_num_walkers=args.walkers, num_blocks=args.blocks,
            num_time_steps_block=args.nts, burn_in_blocks=args.burn,
            rng_seed=11 + i,
            dtype="float64" if args.dry else "float32")
        pin = dmc_exec.ProcInput.from_model_sys_conf_spec(
            dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
        t0 = time.perf_counter()
        result = proc.exec(pin)
        wall = time.perf_counter() - t0
        group = f"n{i}"
        DmcHDF5FileHandler(location=args.out, group=group).dump(result)
        e = float(result.data.blocks.energy.mean) / nop
        err = float(result.data.blocks.energy.mean_error) / nop
        print(f"# N={nop:4d}  E/N = {e:.6f} +/- {err:.6f}  "
              f"({wall:.0f}s)", flush=True)
        entries.append((group, result))

    summary = summarize_fs_fit(entries)
    print(json.dumps({"metric": "fs_fit", "v0": args.v0,
                      "gn": args.gn, "dt": args.dt,
                      "walkers": args.walkers, **summary}))


if __name__ == "__main__":
    main()
