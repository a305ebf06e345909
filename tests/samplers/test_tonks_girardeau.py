"""Exact-limit validation: the Tonks-Girardeau gas.

At infinite contact repulsion the 1D Bose gas maps to free fermions
with the EXACT ground-state energy per particle (ring of density 1,
odd N): ``E/N = (pi^2/3) (1 - 1/N^2)``.  At large-but-finite coupling
``gamma`` the leading correction multiplies by ``(1 - 4/gamma)``.  The
phonon Jastrow family contains the exact TG wavefunction (beta -> 1,
am -> 1), so DMC must reproduce the analytic value to high precision -
a full-pipeline physics test with zero free parameters.

(f32 check at N=5, 8192 walkers: E/N = 3.1558(1) vs analytic 3.1557.)
"""
import numpy as np
import pytest

from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import dmc


def test_tonks_girardeau_energy():
    N, L = 3, 3.0
    gn = 1e4  # gamma = gn/2 = 5000
    spec = mrbp.Spec(lattice_depth=0.0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=N,
                     supercell_size=L, tbf_contact_cutoff=1.2)
    # The matched trial function approaches the exact TG state.
    assert spec.tbf_params.param_beta == pytest.approx(1.0, abs=2e-3)

    sampling = dmc.Sampling(spec, time_step=5e-5, max_num_walkers=320,
                            target_num_walkers=256, rng_seed=6)
    rng = np.random.default_rng(1)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                               offset=rng.uniform(0, L))
        for _ in range(256)])
    state = sampling.build_state(confs)
    blocks = sampling.blocks(state, num_time_steps_block=128,
                             burn_in_blocks=4)
    for _ in range(4):
        next(blocks)
    es = []
    for _ in range(4):
        b = next(blocks)
        es.append(float(np.asarray(b.iter_props.energy).sum())
                  / float(np.asarray(b.iter_props.weight).sum()))
    e_per_n = np.mean(es) / N

    gamma = gn / 2
    exact = np.pi ** 2 / 3 * (1 - 1 / N ** 2) * (1 - 4 / gamma)
    assert e_per_n == pytest.approx(exact, rel=2e-3)
