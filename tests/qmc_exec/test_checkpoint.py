"""Mid-procedure checkpointing and jit retrace discipline."""
import jax
import numpy as np
import pytest

from phd_qmclib_tpu.models import mrbp
from phd_qmclib_tpu.qmc_exec import dmc as dmc_exec
from phd_qmclib_tpu.samplers import dmc as dmc_sampler

MODEL_CONFIG = dict(lattice_depth=10.0, lattice_ratio=1.0,
                    interaction_strength=1.0, boson_number=5,
                    supercell_size=5.0, tbf_contact_cutoff=0.3)


class _Killed(RuntimeError):
    """Simulated kill -9 right after a checkpoint write."""


def kill_after_checkpoint(monkeypatch, proc_cls, at_blocks: int):
    """Arrange for exec to die immediately after the checkpoint at
    ``at_blocks`` completed blocks hits the disk — the file then holds
    exactly what a real kill would leave behind."""
    original = proc_cls._write_checkpoint

    def dying(self, state, blocks_completed, *args, **kwargs):
        original(self, state, blocks_completed, *args, **kwargs)
        if blocks_completed == at_blocks:
            raise _Killed

    monkeypatch.setattr(proc_cls, "_write_checkpoint", dying)
    return _Killed


def test_mid_run_checkpoint_and_restore(tmp_path, monkeypatch):
    """Full-state resume: kill after a mid-run checkpoint, restore,
    finish — the result must equal the uninterrupted run bit-exactly
    (completed-block statistics included; beyond the reference, whose
    resume keeps only the walker state, ``qmc_exec/dmc/io.py:35-80``)."""
    def make(ckpt=None):
        return dmc_exec.Proc(model_spec=mrbp.Spec(**MODEL_CONFIG),
                             time_step=1e-3, max_num_walkers=64,
                             target_num_walkers=48, num_blocks=4,
                             num_time_steps_block=8, burn_in_blocks=1,
                             rng_seed=3, dtype="float64",
                             checkpoint_file=ckpt, checkpoint_every=2)

    ckpt = str(tmp_path / "ckpt.h5")
    proc = make(ckpt)
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    full = make().exec(dmc_exec.ProcInput(proc_input.state))

    with monkeypatch.context() as mp:
        killed = kill_after_checkpoint(mp, dmc_exec.Proc, at_blocks=2)
        with pytest.raises(killed):
            proc.exec(proc_input)

    proc2, proc_input2 = dmc_exec.Proc.restore_checkpoint(ckpt)
    assert proc2.model_spec == proc.model_spec
    assert proc2.time_step == proc.time_step
    assert proc2.num_blocks == proc.num_blocks  # ORIGINAL config
    assert proc_input2.resume["blocks_completed"] == 2
    resumed = proc2.evolve({"checkpoint_file": None}).exec(proc_input2)

    np.testing.assert_array_equal(np.asarray(resumed.state.pos),
                                  np.asarray(full.state.pos))
    np.testing.assert_array_equal(
        resumed.data.blocks.energy.totals,
        full.data.blocks.energy.totals)
    np.testing.assert_array_equal(
        resumed.data.blocks.num_walkers.totals,
        full.data.blocks.num_walkers.totals)


def test_checkpoint_mid_pfw_window_resume_bit_exact(tmp_path,
                                                    monkeypatch):
    """The VERDICT r3 item-2 gate: kill at a NON-window-boundary block
    of a run whose pure-estimator forward-walking window spans 3
    blocks, restore, finish — the pure window sample series must be
    IDENTICAL to the uninterrupted run (no dropped window, no phase
    shift).  Exercises the aux-carry + window-phase persistence."""
    nts = 8

    def make(ckpt=None):
        return dmc_exec.Proc(
            model_spec=mrbp.Spec(**MODEL_CONFIG),
            time_step=1e-3, max_num_walkers=64,
            target_num_walkers=48, num_blocks=6,
            num_time_steps_block=nts, burn_in_blocks=1,
            rng_seed=7, dtype="float64",
            density_spec=dmc_exec.DensityEstSpec(
                num_bins=8, as_pure_est=True,
                pfw_num_time_steps=3 * nts),
            ssf_spec=dmc_exec.SSFEstSpec(
                num_modes=3, as_pure_est=True,
                pfw_num_time_steps=3 * nts),
            checkpoint_file=ckpt, checkpoint_every=2)

    ckpt = str(tmp_path / "pfw-ckpt.h5")
    proc = make(ckpt)
    assert proc.sampling.pfw_window_blocks(nts) == 3
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    full = make().exec(dmc_exec.ProcInput(proc_input.state))

    # Kill after block 4 — windows are [0-2], [3-5]; block 4 is the
    # MIDDLE of the second window.
    with monkeypatch.context() as mp:
        killed = kill_after_checkpoint(mp, dmc_exec.Proc, at_blocks=4)
        with pytest.raises(killed):
            proc.exec(proc_input)

    proc2, proc_input2 = dmc_exec.Proc.restore_checkpoint(ckpt)
    assert "aux" in proc_input2.resume  # mid-window carry persisted
    resumed = proc2.evolve({"checkpoint_file": None}).exec(proc_input2)

    f_density = full.data.blocks.density
    r_density = resumed.data.blocks.density
    assert f_density.totals.shape[0] == 2  # 6 blocks / 3-block window
    np.testing.assert_array_equal(r_density.totals, f_density.totals)
    np.testing.assert_array_equal(r_density.weight_totals,
                                  f_density.weight_totals)
    f_ssf = full.data.blocks.ss_factor
    r_ssf = resumed.data.blocks.ss_factor
    np.testing.assert_array_equal(
        r_ssf.fdk_sqr_abs_part.totals, f_ssf.fdk_sqr_abs_part.totals)
    np.testing.assert_array_equal(np.asarray(resumed.state.pos),
                                  np.asarray(full.state.pos))


def test_block_fn_compiles_once():
    """The jit-retrace discipline guard (the JAX analog of the
    reference's numba memory-leak monitoring,
    ``tests/mrbp_qmc/test_dmc.py:223``): iterating blocks must not
    retrace or recompile the block kernel."""
    spec = mrbp.Spec(**MODEL_CONFIG)
    sampling = dmc_sampler.Sampling(spec, time_step=1e-3,
                                    max_num_walkers=64,
                                    target_num_walkers=48, rng_seed=5)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(48)])
    state = sampling.build_state(confs)
    blocks = sampling.blocks(state, num_time_steps_block=4)
    next(blocks)
    block_fn = sampling._block_fn_measure
    # Delta-based: the shared-trace cache may already hold entries for
    # OTHER block lengths from equal-hashing samplings earlier in the
    # session (num_time_steps_block is a static argname) — the guard
    # is that further iteration adds NO new trace.
    size_after_first = block_fn._cache_size()
    for _ in range(3):
        next(blocks)
    assert block_fn._cache_size() == size_after_first


def test_checkpoint_restore_with_cm_diffusion(tmp_path, monkeypatch):
    """CM-diffusion runs checkpoint their window accumulator: a kill
    inside a multi-block CM window resumes the WINDOW (the round-3
    version dropped ``cmd_accum`` and restarted it — VERDICT r3
    missing #1)."""
    def make(ckpt=None):
        return dmc_exec.Proc(
            model_spec=mrbp.Spec(**MODEL_CONFIG),
            time_step=1e-3, max_num_walkers=64,
            target_num_walkers=48, num_blocks=4,
            num_time_steps_block=8, burn_in_blocks=0,
            rng_seed=3, dtype="float64",
            cm_diffusion_spec=dmc_exec.CMDiffusionEstSpec(
                window_blocks=2),
            checkpoint_file=ckpt, checkpoint_every=1)

    ckpt = str(tmp_path / "cmd-ckpt.h5")
    proc = make(ckpt)
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    full = make().exec(dmc_exec.ProcInput(proc_input.state))

    # Kill after block 1 — INSIDE the first 2-block CM window.
    with monkeypatch.context() as mp:
        killed = kill_after_checkpoint(mp, dmc_exec.Proc, at_blocks=1)
        with pytest.raises(killed):
            proc.exec(proc_input)

    proc2, proc_input2 = dmc_exec.Proc.restore_checkpoint(ckpt)
    assert proc_input2.state.cmd_accum is not None  # persisted now
    result = proc2.evolve({"checkpoint_file": None}).exec(proc_input2)
    cmd = result.data.blocks.cm_diffusion
    full_cmd = full.data.blocks.cm_diffusion
    assert cmd is not None and cmd.num_windows == full_cmd.num_windows
    np.testing.assert_array_equal(cmd.w2_series, full_cmd.w2_series)
    ratio, err = cmd.effective_mass_ratio()
    assert np.isfinite(ratio) and np.isfinite(err)


def test_legacy_checkpoint_restores_with_fresh_window_warning(
        tmp_path, caplog):
    """Round-3 (v1) checkpoints carried only the walker state; they
    must still load — with a log line saying estimator windows reopen
    fresh (VERDICT r3 next #7)."""
    import h5py

    ckpt = str(tmp_path / "legacy.h5")
    proc = dmc_exec.Proc(
        model_spec=mrbp.Spec(**MODEL_CONFIG),
        time_step=1e-3, max_num_walkers=64, target_num_walkers=48,
        num_blocks=4, num_time_steps_block=8, burn_in_blocks=0,
        rng_seed=3, dtype="float64",
        density_spec=dmc_exec.DensityEstSpec(
            num_bins=4, as_pure_est=True, pfw_num_time_steps=16),
        checkpoint_file=ckpt, checkpoint_every=2)
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc)
    proc.exec(proc_input)
    # Strip the v2 resume payload -> a v1-shaped file.
    with h5py.File(ckpt, "a") as fp:
        del fp["checkpoint/dmc/resume"]

    import logging

    from phd_qmclib_tpu.qmc_exec.logging import exec_logger
    exec_logger.propagate = True  # expose records to caplog
    try:
        with caplog.at_level(logging.WARNING,
                             logger="phd-qmclib-tpu"):
            proc2, proc_input2 = dmc_exec.Proc.restore_checkpoint(ckpt)
    finally:
        exec_logger.propagate = False
    assert proc_input2.resume is None
    assert any("reopen FRESH" in rec.getMessage() for rec in caplog.records)
    # And the legacy input still executes.
    result = proc2.evolve({"num_blocks": 2, "burn_in_blocks": 0,
                           "checkpoint_file": None}).exec(proc_input2)
    assert np.isfinite(result.data.blocks.energy.mean)
