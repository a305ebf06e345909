"""Isolated fused-kernel micro-benchmark (the DMC hot path).

Times ``funcs.energy_and_drift`` at production shape (Wm x N) on the
GPU: the pure pairwise+one-body fused kernel, no comb/normals/control
flow.  Used for A/B of per-pair op-count changes (DESIGN.md §7).

    PYTHONPATH=. python benchmarks/kernel_micro.py
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nop", type=int, default=128)
    ap.add_argument("--walkers", type=int, default=17408)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--v0", type=float, default=20.0)
    ap.add_argument("--gn", type=float, default=1.0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from phd_qmclib_tpu.models import mrbp

    spec = mrbp.Spec(lattice_depth=args.v0, lattice_ratio=1.0,
                     interaction_strength=args.gn,
                     boson_number=args.nop,
                     supercell_size=float(args.nop),
                     tbf_contact_cutoff=0.4)
    funcs = mrbp.core_funcs(spec)
    cfc = jax.tree.map(jnp.float32, spec.cfc_params)
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(0, args.nop,
                                  (args.walkers, args.nop)),
                      dtype=jnp.float32)

    @jax.jit
    def chain(p):
        # All iterations inside ONE dispatch; outputs feed back so no
        # cross-iteration elision, and the energy sum is consumed.
        def body(carry, _):
            q, acc = carry
            e, d = funcs.energy_and_drift(q, cfc)
            return (q + 1e-6 * d, acc + e.sum()), None

        (q, acc), _ = jax.lax.scan(body, (p, jnp.float32(0.0)),
                                   length=args.iters)
        return q, acc

    jax.block_until_ready(chain(pos))  # compile + warm
    t0 = time.perf_counter()
    _, acc = jax.block_until_ready(chain(pos))
    dt = (time.perf_counter() - t0) / args.iters
    tot = float(acc)
    pairs = args.walkers * args.nop * (args.nop - 1) / 2
    print(f"fused energy_and_drift: {dt * 1e3:.3f} ms/call "
          f"({pairs / dt / 1e9:.1f} Gpair/s, checksum {tot:.3e})")


if __name__ == "__main__":
    main()
