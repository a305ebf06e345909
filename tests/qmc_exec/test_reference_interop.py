"""Interop tests against the reference's own committed result files.

The four fixtures under ``tests/fixtures`` are the reference's
numba-kernel-produced HDF5 results (recovered byte-exactly from the
CRLF-mangled copies in ``/root/reference/tests/mrbp_qmc``; see
``tests/fixtures/recover_reference_fixtures.py`` for the forensics).
They are the only direct numerical bridge to the reference in this
image, and they exercise:

* the full ``load`` path of the HDF5 handlers, including the
  reference's legacy state layouts (DMC ``props`` as one ``(3, Wm)``
  array, ``qmc_exec/dmc/io.py:66-76``; VMC state via group attrs,
  ``qmc_exec/vmc/io.py:37-58``);
* ``Proc.from_config`` absorbing numba-era keys (``jit_parallel``,
  ``jit_fastmath``);
* kernel parity: the stored walker energies/drifts and wavefunction
  logs must be reproduced by the JAX kernels at f64 round-off;
* the statistics layer recomputing the reference's block means;
* resuming a run from a reference-written state.
"""
import pathlib

import h5py
import numpy as np
import pytest

from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.qmc_exec.io import (DmcHDF5FileHandler,
                                        VmcHDF5FileHandler)

FIXTURES = pathlib.Path(__file__).parent.parent / "fixtures"

DMC_FIXTURES = [
    ("test-dmc-ssf-results.h5", "ssf-data-group"),
    ("test-dmc-density-results.h5", "density-data-group"),
]
VMC_FIXTURES = [
    ("test-vmc-results.h5", "test-group"),
    ("test-vmc-ssf-results.h5", "ssf-data-group"),
]


@pytest.mark.parametrize("name,group", DMC_FIXTURES)
def test_dmc_fixture_full_load(name, group):
    """The whole reference file loads: proc + legacy state + data."""
    handler = DmcHDF5FileHandler(str(FIXTURES / name), group)
    result = handler.load()

    proc = result.proc
    assert proc.time_step == 0.000625
    assert proc.max_num_walkers == 512
    assert proc.target_num_walkers == 480
    assert proc.model_spec.boson_number == 8
    assert proc.model_spec.supercell_size == 8.0

    state = result.state
    assert state.pos.shape == (512, 8)
    assert state.drift.shape == (512, 8)
    live = int(np.count_nonzero(~np.asarray(state.masks)))
    with h5py.File(FIXTURES / name, "r") as h5f:
        attrs = dict(h5f[f"{group}/dmc/state"].attrs)
    assert live == int(attrs["num_walkers"])
    assert float(state.weight) == float(attrs["weight"])
    assert float(state.ref_energy) == float(attrs["ref_energy"])

    blocks = result.data.blocks
    # The energy mean recomputed through the repo's reblocking layer
    # must equal the plain ratio of the stored totals (2 blocks only,
    # so no reblocking correction applies to the mean).
    with h5py.File(FIXTURES / name, "r") as h5f:
        totals = h5f[f"{group}/dmc/data/blocks/energy/totals"][()]
        wtotals = h5f[f"{group}/dmc/data/blocks/energy/weight_totals"][()]
    assert blocks.energy.mean == pytest.approx(
        totals.sum() / wtotals.sum(), rel=1e-12)
    energy_per_boson = blocks.energy.mean / 8
    assert 10.0 < energy_per_boson < 20.0


def test_dmc_fixture_ssf_statistics():
    handler = DmcHDF5FileHandler(
        str(FIXTURES / "test-dmc-ssf-results.h5"), "ssf-data-group")
    result = handler.load()
    ssf = result.data.blocks.ss_factor
    sk = np.asarray(ssf.mean)
    assert sk.shape == (16,)
    assert np.all(np.isfinite(sk))
    # S(k) of the reference run: the k=0 mode carries no fluctuation
    # information and S(k) -> positive values at finite k.
    assert np.all(sk[1:] > 0.0)


def test_dmc_fixture_density_statistics():
    handler = DmcHDF5FileHandler(
        str(FIXTURES / "test-dmc-density-results.h5"), "density-data-group")
    result = handler.load()
    density = result.data.blocks.density
    rho = np.asarray(density.mean)
    assert rho.shape == (256,)
    assert np.all(np.isfinite(rho)) and np.all(rho >= 0.0)
    # The profile integrates (sums, with the reference's bin convention)
    # to the boson number within a small pure-estimator tolerance.
    assert rho.sum() == pytest.approx(8.0, rel=0.05)


@pytest.mark.parametrize("name,group", DMC_FIXTURES)
def test_dmc_state_kernel_parity(name, group):
    """The reference's stored walker energies/drifts are reproduced by
    the JAX kernels at f64 round-off - direct numerical contact with
    the reference's numba kernels (``qmc_base/jastrow/model.py:777-856``)."""
    handler = DmcHDF5FileHandler(str(FIXTURES / name), group)
    result = handler.load()
    state = result.state
    live = ~np.asarray(state.masks)
    physical = mrbp.PhysicalFuncs(result.proc.model_spec)
    pos = np.asarray(state.pos)
    energy = np.asarray(physical.energy(pos))
    drift = np.asarray(physical.drift(pos))
    assert np.abs(energy[live]
                  - np.asarray(state.energies)[live]).max() < 1e-9
    assert np.abs(drift[live]
                  - np.asarray(state.drift)[live]).max() < 1e-9


@pytest.mark.parametrize("name,group", VMC_FIXTURES)
def test_vmc_fixture_full_load_and_wf_parity(name, group):
    handler = VmcHDF5FileHandler(str(FIXTURES / name), group)
    result = handler.load()

    proc = result.proc
    assert proc.move_spread == 0.125
    assert proc.num_steps_block == 4096
    assert proc.model_spec.boson_number == 24

    # Legacy single-config state: pos batched to (1, N); the stored
    # wf_abs_log attr must match the JAX kernel; the energy (absent in
    # the reference layout) must have been recomputed.
    state = result.state
    assert state.pos.shape == (1, 24)
    physical = mrbp.PhysicalFuncs(proc.model_spec)
    wf = float(np.asarray(physical.wf_abs_log(np.asarray(state.pos)))[0])
    assert wf == pytest.approx(float(state.wf_abs_log[0]), abs=1e-9)
    assert np.isfinite(float(state.energy[0]))

    blocks = result.data.blocks
    with h5py.File(FIXTURES / name, "r") as h5f:
        totals = h5f[f"{group}/vmc/data/blocks/energy/totals"][()]
    # VMC energy blocks are unweighted step means.
    assert blocks.energy.mean == pytest.approx(totals.mean(), rel=1e-12)


def test_vmc_ssf_fixture_parts():
    handler = VmcHDF5FileHandler(
        str(FIXTURES / "test-vmc-ssf-results.h5"), "ssf-data-group")
    result = handler.load()
    ssf = result.data.blocks.ss_factor
    sk = np.asarray(ssf.mean)
    assert sk.shape == (48,)
    assert np.all(np.isfinite(sk))
    # rho_0 = N exactly every step, so Im rho_0 accumulates to zero.
    with h5py.File(FIXTURES / "test-vmc-ssf-results.h5", "r") as h5f:
        imag = h5f["ssf-data-group/vmc/data/blocks/ss_factor/"
                   "fdk_imag/totals"][()]
    assert np.all(imag[:, 0] == 0.0)


def test_resume_dmc_from_reference_state():
    """A short continuation run from the reference-written walker
    ensemble produces finite, bracket-consistent energies."""
    from phd_qmclib_tpu.qmc_exec import dmc as dmc_proc

    handler = DmcHDF5FileHandler(
        str(FIXTURES / "test-dmc-ssf-results.h5"), "ssf-data-group")
    result = handler.load()
    proc = result.proc.evolve({
        "num_blocks": 2, "num_time_steps_block": 16,
        "burn_in_blocks": 0, "rng_seed": 123, "dtype": "float64",
        "ssf_spec": None, "verbose": False,
    })
    proc_input = dmc_proc.ProcInput.from_result(result, proc)
    out = proc.exec(proc_input)
    energy_per_boson = out.data.blocks.energy.mean / 8
    stored = result.data.blocks.energy.mean / 8
    assert np.isfinite(energy_per_boson)
    # Same ensemble, a handful of steps: stays in the same bracket.
    assert energy_per_boson == pytest.approx(stored, rel=0.05)
    nw = int(np.asarray(out.state.num_walkers).sum())
    assert 0 < nw <= proc.max_num_walkers


def test_resume_vmc_from_reference_state():
    from phd_qmclib_tpu.qmc_exec import vmc as vmc_proc

    handler = VmcHDF5FileHandler(
        str(FIXTURES / "test-vmc-results.h5"), "test-group")
    result = handler.load()
    proc = result.proc.evolve({
        "num_blocks": 2, "num_steps_block": 64, "burn_in_blocks": 0,
        "rng_seed": 3,
    })
    proc_input = vmc_proc.ProcInput.from_result(result, proc)
    out = proc.exec(proc_input)
    energy_per_boson = out.data.blocks.energy.mean / 24
    assert np.isfinite(energy_per_boson)
    # The stored chain is equilibrated: the short continuation stays
    # near the stored variational energy.
    stored = result.data.blocks.energy.mean / 24
    assert energy_per_boson == pytest.approx(stored, rel=0.25)
