"""The DMC step has no backend branch: with ``jax.default_backend``
reporting a GPU, the f32 trajectory on the CPU is unchanged."""
import jax
import numpy as np

from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.samplers import dmc


def _f32_trajectory():
    spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                     interaction_strength=1.0, boson_number=8,
                     supercell_size=8.0, tbf_contact_cutoff=0.4)
    sampling = dmc.Sampling(spec, time_step=1e-3, max_num_walkers=48,
                            target_num_walkers=32, rng_seed=3)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(32)]).astype(np.float32)
    state = sampling.build_state(confs, dtype=np.float32)
    block = next(sampling.blocks(state, 8, burn_in_blocks=0))
    return (np.asarray(block.last_state.pos),
            np.asarray(block.iter_props.energy))


def test_f32_dmc_step_ignores_backend_name(monkeypatch):
    pos, energy = _f32_trajectory()
    assert pos.dtype == np.float32
    # Drop every traced block function so the step is rebuilt under the
    # patched backend name.
    dmc._shared_block_fn.cache_clear()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pos_gpu_name, energy_gpu_name = _f32_trajectory()
    dmc._shared_block_fn.cache_clear()
    np.testing.assert_array_equal(pos_gpu_name, pos)
    np.testing.assert_array_equal(energy_gpu_name, energy)
