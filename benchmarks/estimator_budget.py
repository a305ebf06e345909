"""Estimator-pass budget at K=1 (round-5 verdict item 3).

Round 3's liveness ablation produced the definitive STEP budget
(DESIGN.md section 7: drift-only 3.59 ms -> +comb 3.80 -> energy-live
4.65 ms at N=128, Wm=17408).  This driver applies the same
methodology to the MEASUREMENT pass: the estimators-on configuration
(pure 128-bin density + pure 64-mode S(k), the ``bench.py
--estimators`` config) runs at ~72% of the bare rate at K=1, and the
missing budget says where the remaining ~1.1 ms/step goes — or that
it is roofline-bound.

Unlike in-step dead-code ablations (which XLA silently deletes —
the round-3 warning), estimator toggles here change the SPEC, so the
measured deltas are structural: every variant's estimator outputs are
returned from the block function and fetched, hence live by
construction.  The walker dynamics are bit-identical across variants
(gated by the test suite), so per-variant time differences isolate
the estimator work exactly.

Variants (cumulative + isolation):

* ``bare``            — no estimators (the headline bench config),
* ``density``         — pure 128-bin density alone,
* ``ssf``             — pure 64-mode S(k) alone,
* ``density+ssf``     — the estimators-on config (K=1),
* ``mixed both``      — same pair, mixed (no ancestry transport /
                         window sampling: prices the PURE machinery),
* ``density+ssf K=8`` — the production cadence for reference.

Run: PYTHONPATH=. \
       python benchmarks/estimator_budget.py [--quick]
"""
import argparse
import json
import time


def measure(nop, target, max_w, nts, timed_blocks, est_every,
            density=None, ssf=None, seed=1, rounds=1):
    """One variant's steady-state rate; returns (ws/s, ms/step).

    ``rounds`` re-times the same stream ``rounds`` times and keeps the
    FASTEST round: host-side hiccups only ever ADD time, so the minimum
    is the steady-state reading."""
    import jax
    import numpy as np

    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=1.0, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=0.4)
    est_kw = {}
    if density is not None:
        est_kw["density_est_spec"] = dmc.DensityEstSpec(
            num_bins=density[0], as_pure_est=density[1])
    if ssf is not None:
        est_kw["ssf_est_spec"] = dmc.SSFEstSpec(
            num_modes=ssf[0], as_pure_est=ssf[1])
    sampling = dmc.Sampling(spec, time_step=1e-3,
                            max_num_walkers=max_w,
                            target_num_walkers=target, rng_seed=seed,
                            est_every=est_every, **est_kw)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(target)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    blocks = sampling.blocks(state, num_time_steps_block=nts,
                             burn_in_blocks=0)
    for _ in range(2):            # compile/load + warm
        block = next(blocks)
    float(np.asarray(block.iter_props.num_walkers[-1]))

    best_rate, best_ms = 0.0, float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        total = 0.0
        steps = 0
        for _ in range(timed_blocks):
            block = next(blocks)
            # Fetch estimator sums too — keeps every output observably
            # live (a scalar each; negligible transfer).
            nw = np.asarray(block.iter_props.num_walkers,
                            dtype=np.float64)
            if block.iter_density is not None:
                float(np.asarray(block.iter_density[-1]).sum())
            if block.iter_ssf is not None:
                float(np.asarray(block.iter_ssf[-1]).sum())
            total += float(nw.sum())
            steps += nts
        elapsed = time.perf_counter() - t0
        rate, ms = total / elapsed, 1e3 * elapsed / steps
        if rate > best_rate:
            best_rate, best_ms = rate, ms
    return best_rate, best_ms


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="smaller shapes (CPU smoke / fast chip)")
    parser.add_argument("--blocks", type=int, default=3)
    args = parser.parse_args()

    from phd_qmclib_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache(min_compile_time_secs=0.5)

    if args.quick:
        import jax
        shapes = dict(nop=16, target=256, max_w=288, nts=16,
                      timed_blocks=2)
    else:
        shapes = dict(nop=128, target=16384, max_w=17408, nts=512,
                      timed_blocks=args.blocks, rounds=3)

    variants = [
        ("bare", dict(est_every=1)),
        ("density_pure", dict(est_every=1, density=(128, True))),
        ("ssf_pure", dict(est_every=1, ssf=(64, True))),
        ("density+ssf_pure", dict(est_every=1, density=(128, True),
                                  ssf=(64, True))),
        ("density+ssf_mixed", dict(est_every=1, density=(128, False),
                                   ssf=(64, False))),
        ("density+ssf_pure_K8", dict(est_every=8,
                                     density=(128, True),
                                     ssf=(64, True))),
    ]
    rows = {}
    for name, kw in variants:
        rate, ms = measure(**shapes, **kw)
        rows[name] = {"walker_steps_per_sec": round(rate),
                      "ms_per_step": round(ms, 4)}
        print(f"# {name:22s} {rate/1e6:8.3f}M ws/s "
              f"{ms:7.3f} ms/step", flush=True)

    bare = rows["bare"]["ms_per_step"]
    both = rows["density+ssf_pure"]["ms_per_step"]
    budget = {
        # Isolation costs (each estimator alone, over bare).
        "density_ms": round(
            rows["density_pure"]["ms_per_step"] - bare, 4),
        "ssf_ms": round(rows["ssf_pure"]["ms_per_step"] - bare, 4),
        # Joint cost and the cross term (fusion interaction: joint
        # minus the sum of isolations; negative = the passes share
        # work when fused together).
        "joint_ms": round(both - bare, 4),
        "cross_term_ms": round(
            (both - bare)
            - (rows["density_pure"]["ms_per_step"] - bare)
            - (rows["ssf_pure"]["ms_per_step"] - bare), 4),
        # The pure machinery's price (ancestry gathers + window
        # divides) over the mixed pair.
        "pure_machinery_ms": round(
            both - rows["density+ssf_mixed"]["ms_per_step"], 4),
        "k1_fraction_of_bare": round(
            rows["density+ssf_pure"]["walker_steps_per_sec"]
            / rows["bare"]["walker_steps_per_sec"], 4),
        "k8_fraction_of_bare": round(
            rows["density+ssf_pure_K8"]["walker_steps_per_sec"]
            / rows["bare"]["walker_steps_per_sec"], 4),
    }
    print(json.dumps({"metric": "estimator_budget_k1",
                      "config": shapes, "rows": rows,
                      "budget": budget}))


if __name__ == "__main__":
    main()
