"""DMC throughput vs particle number (capacity / O(N^2) scaling).

The pairwise pass dominates the step, so walker-steps/s should fall
~N^2 once the chip saturates; the pair-evaluations/s column exposes
the (nearly N-independent) kernel efficiency.  Demonstrates capacity
beyond the reference's N=128 headline scale.

Run: PYTHONPATH=. python benchmarks/n_scaling.py

Not yet measured on the GPU.  The reference's own test sizes are
N=16-24 (``tests/mrbp_qmc/test_dmc.py:12-53`` of the reference).
"""
import argparse
import json
import time

import numpy as np


def measure(nop, target, nts, blocks):
    from phd_qmclib_tpu.models import mrbp
    from phd_qmclib_tpu.samplers import dmc

    spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=1.0, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=0.4)
    sampling = dmc.Sampling(spec, time_step=1e-3,
                            max_num_walkers=target + target // 16,
                            target_num_walkers=target, rng_seed=1)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(target)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    it = sampling.blocks(state, num_time_steps_block=nts,
                         burn_in_blocks=0)
    b = next(it)
    float(np.asarray(b.iter_props.energy).sum())  # sync after compile
    t0 = time.perf_counter()
    wsteps = 0.0
    for _ in range(blocks):
        b = next(it)
        wsteps += float(np.asarray(b.iter_props.num_walkers,
                                   dtype=np.float64).sum())
    float(np.asarray(b.iter_props.energy).sum())
    el = time.perf_counter() - t0
    return wsteps / el


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--walkers", type=int, default=16384)
    parser.add_argument("--nts", type=int, default=128)
    parser.add_argument("--blocks", type=int, default=3)
    parser.add_argument("--nops", type=int, nargs="+",
                        default=[32, 64, 128, 256])
    args = parser.parse_args()

    print(f"# DMC N-scaling, {args.walkers} walkers, f32, single chip")
    print(f"# {'N':>4} {'walker-steps/s':>15} {'pair-evals/s':>14}")
    for nop in args.nops:
        rate = measure(nop, args.walkers, args.nts, args.blocks)
        print(json.dumps({"nop": nop, "walker_steps_per_sec": rate,
                          "pair_evals_per_sec": rate * nop * nop}))


if __name__ == "__main__":
    main()
