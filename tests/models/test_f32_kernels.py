"""The f32 production kernels against the plain f64 reference across the
model-config space: free gas, ideal lattice gas, interacting lattice with
defects, varying couplings and sizes."""
import jax
import numpy as np
import pytest

from phd_qmclib_tpu.models import mrbp
from tests import kernel_reference as kr


def _random_spec(seed: int) -> mrbp.Spec:
    rng = np.random.default_rng(1000 + seed)
    nop = int(rng.choice([16, 64]))
    kwargs = dict(lattice_ratio=1.0, boson_number=nop,
                  supercell_size=float(nop),
                  tbf_contact_cutoff=float(rng.uniform(0.2, 0.45)))
    variant = seed % 3
    if variant == 0:      # free gas (no lattice)
        kwargs.update(lattice_depth=0.0,
                      interaction_strength=float(rng.uniform(0.5, 20)))
    elif variant == 1:    # ideal lattice gas
        kwargs.update(lattice_depth=float(rng.uniform(1.0, 30.0)),
                      interaction_strength=0.0)
    else:                 # interacting defected lattice
        kwargs.update(lattice_depth=float(rng.uniform(5.0, 30.0)),
                      interaction_strength=float(rng.uniform(0.5, 10)),
                      num_defects=max(1, nop // 8),
                      defect_magnitude=float(rng.uniform(0.1, 1.0)))
    return mrbp.Spec(**kwargs)


@pytest.mark.parametrize("seed", range(6))
def test_f32_kernels_match_f64_reference(seed):
    spec = _random_spec(seed)
    pos = kr.start_positions(spec, 16, seed=seed)
    cpu = jax.devices("cpu")[0]
    kr.assert_within(kr.f32_errors(spec, pos, cpu, cpu))
