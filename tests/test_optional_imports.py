"""The compute path runs without the file and CLI packages (h5py, PyYAML,
Jinja2, click); the features that need one name it when it is missing.

Each case runs in a fresh interpreter whose import system refuses those
packages.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).parent.parent

BLOCKER = """
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in {"h5py", "yaml", "jinja2", "click"}:
            raise ImportError(f"{name} is not installed")

sys.meta_path.insert(0, _Refuse())
"""

TINY_SPEC = """
from phd_qmclib_tpu.models import mrbp
spec = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                 interaction_strength=1.0, boson_number=4,
                 supercell_size=4.0, tbf_contact_cutoff=0.4)
"""

ENTRY_POINTS = {
    "import": """
import phd_qmclib_tpu
from phd_qmclib_tpu import mrbp_cli
from phd_qmclib_tpu.samplers import dmc, vmc
""",
    "dmc_exec": TINY_SPEC + """
import numpy as np
from phd_qmclib_tpu.qmc_exec import dmc
proc = dmc.Proc(model_spec=spec, time_step=1e-3, max_num_walkers=24,
                target_num_walkers=16, num_blocks=2,
                num_time_steps_block=4, burn_in_blocks=1, rng_seed=1,
                density_spec=dmc.DensityEstSpec(num_bins=4))
res = proc.exec(dmc.ProcInput.from_model_sys_conf_spec(
    dmc.ModelSysConfSpec(), proc))
assert np.isfinite(res.data.blocks.energy.mean)
""",
    "vmc_exec": TINY_SPEC + """
import numpy as np
from phd_qmclib_tpu.qmc_exec import vmc
proc = vmc.Proc(model_spec=spec, move_spread=0.4, num_blocks=2,
                num_steps_block=4, num_walkers=8, rng_seed=1,
                ssf_spec=vmc.SSFEstSpec(num_modes=3))
res = proc.exec(vmc.ProcInput.from_model_sys_conf_spec(
    vmc.ModelSysConfSpec(), proc))
assert np.isfinite(res.data.blocks.energy.mean)
""",
    "file_features_name_package": """
import pytest
from phd_qmclib_tpu import mrbp_cli
from phd_qmclib_tpu.qmc_exec import config, io
with pytest.raises(ImportError, match="'click' package"):
    mrbp_cli.dmc_cli
with pytest.raises(ImportError, match="'pyyaml' package"):
    config.Loader().load("run.yml")
with pytest.raises(ImportError, match="'h5py' package"):
    io.DmcHDF5FileHandler(location="out.h5", group="g").load()
""",
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_runs_without_optional_packages(entry, tmp_path):
    code = BLOCKER + textwrap.dedent(ENTRY_POINTS[entry]) + """
blocked = {"h5py", "yaml", "jinja2", "click"}
assert not blocked & {m.partition(".")[0] for m in sys.modules}
print("OK")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), \
        out.stderr[-3000:]
