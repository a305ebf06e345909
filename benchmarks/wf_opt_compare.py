"""Wavefunction optimization: differential evolution vs gradient.

Production-scale comparison of the reference-behavior optimizer
(``differential_evolution`` over the correlated-sampling variance,
``/root/reference/src/phd_qmclib/mrbp_qmc/model.py:927-942``) against
the gradient path (grid scan + L-BFGS with the implicit-differentiation
d(variance)/d(rm) through the two-body ``custom_root`` solve — no
reference analog).

Run: PYTHONPATH=. python benchmarks/wf_opt_compare.py
"""
import argparse
import json
import time

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nop", type=int, default=128)
    parser.add_argument("--chains", type=int, default=4096)
    parser.add_argument("--rm0", type=float, default=0.2)
    parser.add_argument("--equil-steps", type=int, default=512)
    parser.add_argument("--joint", action="store_true",
                        help="also run the JOINT 2-parameter "
                        "optimization (rm + trial-orbital depth, "
                        "round 5 — the reference caps at one knob) "
                        "and A/B the optimized trials by honest VMC "
                        "re-runs at each spec")
    args = parser.parse_args()

    from phd_qmclib_tpu import wf_opt
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import vmc

    nop = args.nop
    spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=1.0, boson_number=nop,
                     supercell_size=float(nop),
                     tbf_contact_cutoff=args.rm0)
    sampling = vmc.Sampling(spec, move_spread=0.12, rng_seed=11,
                            num_walkers=args.chains)
    rng = np.random.default_rng(5)
    # Crystal-like start (one boson per well, random lattice offsets):
    # local Metropolis moves relax the long-wavelength density far too
    # slowly from a uniform-random start at this box size — an
    # under-equilibrated ensemble feeds the optimizer a wrong measure
    # AND breaks the variational bound on the readback energies (the
    # mean local energy is only a bound at equilibrium; a chip run
    # from the random start read E/N BELOW the DMC ground state).
    confs0 = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                               offset=rng.uniform(0, nop))
        for _ in range(args.chains)])
    state = sampling.build_state(confs0)
    it = sampling.blocks(args.equil_steps, state)
    for _ in range(2):
        block = next(it)  # equilibrate (2 blocks)
    print(f"# VMC equilibration: accept {block.accept_rate:.3f}, "
          f"E/N = {float(np.mean(np.asarray(block.iter_props.energy[-64:])))/nop:.5f}")
    pos_set = np.asarray(block.last_state.pos)
    lp_set = np.asarray(block.last_state.wf_abs_log)

    import jax.numpy as jnp

    class CountingDE(wf_opt.CSWFOptimizer):
        n_evals = 0

        def principal_function(self, rm):
            CountingDE.n_evals += 1
            return super().principal_function(rm)

    results = {}
    for method, cls in (("de", CountingDE),
                        ("grad", wf_opt.GradCSWFOptimizer)):
        opt = cls(spec, pos_set, lp_set)
        # Warm every jit cache outside the timed section.
        opt.principal_function(args.rm0)
        if method == "grad":
            opt._value_and_grad_fn(jnp.asarray(args.rm0, np.float32))
            (lo, hi), = opt.principal_function_bounds
            opt._grid_fn(jnp.linspace(lo, hi, opt.num_grid,
                                      dtype=np.float32))
        CountingDE.n_evals = 0
        t0 = time.perf_counter()
        opt_spec = opt.exec()
        el = time.perf_counter() - t0
        evals = CountingDE.n_evals if method == "de" else None
        rm = float(opt_spec.tbf_contact_cutoff)
        var = opt.principal_function(rm)
        results[method] = (rm, var, el)
        print(json.dumps({"method": method, "rm_opt": rm,
                          "variance": var, "wall_s": el,
                          "n_evals": evals}))

    rm_de, var_de, t_de = results["de"]
    rm_gr, var_gr, t_gr = results["grad"]
    print(f"# speedup {t_de / t_gr:.1f}x, "
          f"d(rm) = {abs(rm_de - rm_gr):.2e}, "
          f"d(var)/var = {abs(var_de - var_gr) / var_de:.2e}")

    if not args.joint:
        return

    # Joint 2-parameter optimization (rm + trial-orbital depth): the
    # variational payoff of the second knob, judged the honest way —
    # fresh VMC runs at each optimized spec (the orbital depth is a
    # params-pytree leaf, so every candidate reuses ONE compiled
    # sampler executable).
    opt2 = wf_opt.GradCSWFOptimizer(spec, pos_set, lp_set,
                                    opt_obf_lattice_depth=True)
    t0 = time.perf_counter()
    spec_joint = opt2.exec()
    t_joint = time.perf_counter() - t0
    rm_j = float(spec_joint.tbf_contact_cutoff)
    v0b_j = float(spec_joint.obf_lattice_depth)
    var_j = opt2.principal_function([rm_j, v0b_j])
    print(json.dumps({"method": "grad_joint", "rm_opt": rm_j,
                      "obf_lattice_depth_opt": v0b_j,
                      "physical_v0": float(spec.lattice_depth),
                      "variance": var_j, "wall_s": t_joint}))

    def vmc_energy(sp, seed=13):
        s2 = vmc.Sampling(sp, move_spread=0.12, rng_seed=seed,
                          num_walkers=args.chains)
        st = s2.build_state(confs0)
        it2 = s2.blocks(args.equil_steps, st)
        for _ in range(2):
            next(it2)                # equilibrate at THIS trial
        b = next(it2)                # measure
        e = np.asarray(b.iter_props.energy, dtype=np.float64) / nop
        chain_means = e.mean(axis=0)
        return float(chain_means.mean()), \
            float(chain_means.std() / np.sqrt(chain_means.size)), \
            float(np.asarray(b.accept_rate))

    rows = {}
    for name, sp in (("initial", spec),
                     ("rm_only", spec.evolve(tbf_contact_cutoff=rm_gr)),
                     ("joint", spec_joint)):
        e, err, acc = vmc_energy(sp)
        rows[name] = {"e_per_n": e, "err": err, "accept": acc}
        print(json.dumps({"vmc_at": name, "e_per_n": e, "err": err,
                          "accept": acc}))
    gain = rows["rm_only"]["e_per_n"] - rows["joint"]["e_per_n"]
    sig = gain / np.hypot(rows["rm_only"]["err"], rows["joint"]["err"])
    print(json.dumps({"metric": "joint_vs_rm_only_energy_gain",
                      "delta_e_per_n": gain, "sigma": float(sig),
                      "variance_ratio": var_j / var_gr}))


if __name__ == "__main__":
    main()
