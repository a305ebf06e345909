"""Fused parameter-sweep execution: many DMC procedures, one dispatch.

Production form of the scan workflow: R procedures whose model specs
differ only in continuous parameters (coupling, lattice depth, time
step, seed) advance as ONE fused device dispatch per block via
:class:`phd_qmclib_tpu.parallel.sweep.ParamSweep`, then split into R
independent :class:`~phd_qmclib_tpu.qmc_exec.dmc.ProcResult` objects —
each identical in layout to what its procedure's standalone ``exec``
would produce, bit-identical on the CPU test mesh, and statistically
identical on an accelerator in f32 (vmap batching can change XLA
reduction order; see docs/DESIGN.md section 8).

The reference has no analog (its scans are sequential shell loops over
config files).  Underfilled rows batch into one ``R * W`` dispatch;
the speed-up over sequential runs is not yet measured on the GPU.
"""
import typing as t
from dataclasses import dataclass

import numpy as np

from ..parallel.sweep import ParamSweep, VmcSweep
from ..samplers import dmc as dmc_sampler
from .dmc import Proc, ProcInput, ProcResult, _BlockAccumulator
from .logging import exec_logger
from . import vmc as vmc_exec

__all__ = ["SweepProc", "VmcSweepProc"]


def _validate_sweep_checkpoints(procs):
    """Mid-run checkpointing across fused rows: all rows or none, into
    DISTINCT files, at one shared cadence (the rows advance in
    lockstep, so a shared ``checkpoint_every`` is structural)."""
    files = [p.checkpoint_file for p in procs]
    with_ckpt = [f for f in files if f is not None]
    if not with_ckpt:
        return
    if len(with_ckpt) != len(files):
        raise ValueError(
            "fused sweep checkpointing is all-or-none: give every row "
            "a checkpoint_file or none")
    if len(set(with_ckpt)) != len(with_ckpt):
        raise ValueError(
            "fused sweep rows must checkpoint into distinct files")
    everies = {p.checkpoint_every for p in procs}
    if len(everies) != 1:
        raise ValueError(
            "fused sweep rows must share checkpoint_every")


def _write_sweep_checkpoints(procs, last_state, block_idx: int,
                             burn_in_blocks: int, aux_carry=None,
                             accumulators=None):
    """Slice the fused state per row and write each row's standalone
    full-state checkpoint (schema v2) — a resumed row restores with
    ``Proc.restore_checkpoint`` exactly like an unfused run, and the
    restored rows compose back into a continuation sweep."""
    import jax

    # One host fetch for the whole fused state (device-side row
    # slicing would gather across the sharded sweep axis, which the
    # sharding-in-types rules reject — and every row gets written
    # anyway).
    host_state = jax.tree.map(np.asarray, last_state)
    host_aux = None if aux_carry is None else {
        name: np.asarray(arr) for name, arr in aux_carry.items()}
    for r, p in enumerate(procs):
        row_state = jax.tree.map(lambda x, r=r: x[r], host_state)
        row_aux = None
        if host_aux is not None:
            row_aux = {name: arr[r] for name, arr in host_aux.items()}
        p._write_checkpoint(
            row_state, blocks_completed=block_idx + 1,
            it_offset=p.block_offset, it_burn=burn_in_blocks,
            it_next=burn_in_blocks + block_idx + 1,
            aux=row_aux,
            accum=(accumulators[r] if accumulators is not None
                   else None))


@dataclass(frozen=True)
class SweepProc:
    """Run R DMC procedures as one fused sweep.

    All procs must share the sampling *shape*: block counts, walker
    buffers, estimator specs, ``keep_iter_data`` — anything that sets
    static structure.  Row-varying knobs are the continuous model
    parameters, ``time_step`` and ``rng_seed``.

    With ``mesh=None`` (the default) the rows vmap-fuse on ONE device —
    the production form when per-row walker counts underfill the chip.
    Passing a 2-D ``("sweep", "walkers")`` mesh instead maps rows onto
    mesh rows and shards each row's walkers within it (the workload's
    DCN-scalable layout, SURVEY §5.8): the FULL driver surface —
    estimators, pure windows, cadence, per-row checkpoints — then runs
    through one fused sharded dispatch per block, and each row is
    bit-identical to its standalone run on a same-size 1-D walker mesh
    (same seed, same per-shard key folds; gated in the multichip
    dryrun).  Rows' own ``num_mesh_devices`` stays rejected — the mesh
    belongs to the sweep.  Shard rebalancing does not run under a
    fused sweep (per-row populations are small by construction).
    """

    procs: t.Tuple[Proc, ...]
    mesh: t.Optional[t.Any] = None

    def __post_init__(self):
        if not self.procs:
            raise ValueError("need at least one procedure")
        ref = self.procs[0]
        for p in self.procs[1:]:
            same = (
                p.num_blocks == ref.num_blocks
                and p.num_time_steps_block == ref.num_time_steps_block
                and p.burn_in_blocks == ref.burn_in_blocks
                and p.keep_iter_data == ref.keep_iter_data
                and p.block_offset == ref.block_offset
                and p.density_spec == ref.density_spec
                and p.ssf_spec == ref.ssf_spec
                and p.obd_spec == ref.obd_spec
                and p.pair_corr_spec == ref.pair_corr_spec
                and p.est_every == ref.est_every
                and p.cm_diffusion_spec == ref.cm_diffusion_spec)
            if not same:
                raise ValueError(
                    "all sweep procedures must share block structure "
                    "and estimator specs")
        for p in self.procs:
            if p.num_mesh_devices is not None:
                raise ValueError(
                    "fused sweep rows are single-device; drop "
                    "num_mesh_devices (use the sampler-level ParamSweep "
                    "for multi-device sweeps)")
        _validate_sweep_checkpoints(self.procs)

    @property
    def sweep(self) -> ParamSweep:
        return ParamSweep(tuple(p.sampling for p in self.procs),
                          self.mesh)

    def exec(self, proc_inputs: t.Sequence[ProcInput]) \
            -> t.List[ProcResult]:
        """Advance every row through its full procedure; one device
        dispatch per block covers all rows."""
        import jax
        import jax.numpy as jnp

        procs = self.procs
        if len(proc_inputs) != len(procs):
            raise ValueError("one ProcInput per procedure")
        ref = procs[0]
        num_blocks = ref.num_blocks
        nts_block = ref.num_time_steps_block
        burn_in_blocks = ref.burn_in_blocks

        exec_logger.info(
            f"Starting fused DMC sweep ({len(procs)} rows)...")
        sweep = self.sweep
        resumes = [pi.resume for pi in proc_inputs]
        if self.mesh is not None and all(r is None for r in resumes):
            # Meshed sweep, fresh inputs: single-device input states
            # carry a one-shard walker layout (valid prefix of the
            # whole buffer, scalar shard count), but the sharded rows
            # need per-shard valid prefixes — rebuild through the
            # sweep's own layout from each row's valid walkers, which
            # is bit-identical to a standalone sharded build from the
            # same configurations.
            conf_sets = [np.asarray(pi.state.pos)[
                ~np.asarray(pi.state.masks)] for pi in proc_inputs]
            state = sweep.build_states(
                conf_sets, dtype=np.asarray(
                    proc_inputs[0].state.pos).dtype)
        else:
            # Row states share the layout (single-device, or restored
            # from a meshed sweep's own checkpoints), so the fused
            # initial state is a plain stack of the standalone states.
            state = jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *[pi.state for pi in proc_inputs])
        start_block = 0
        aux_init = None
        if any(r is not None for r in resumes):
            if any(r is None for r in resumes):
                raise ValueError(
                    "fused sweep resume is all-or-none: every row "
                    "must restore from a checkpoint or none")
            completed = {r["blocks_completed"] for r in resumes}
            if len(completed) != 1:
                raise ValueError(
                    "fused sweep rows must resume from the same "
                    "block (synchronized checkpoints)")
            for r, p in zip(resumes, procs):
                if r["it_offset"] != p.block_offset or \
                        r["it_burn"] != burn_in_blocks:
                    raise ValueError(
                        "a row's checkpoint stream position diverged "
                        "from the sweep stream (it was written by a "
                        "rebalanced standalone run?) — resume that "
                        "row unfused")
            start_block = completed.pop()
            if all("aux" in r for r in resumes):
                names = resumes[0]["aux"].keys()
                aux_init = {name: np.stack([r["aux"][name]
                                            for r in resumes])
                            for name in names}
        if start_block:
            blocks_iter = sweep.blocks(
                state, nts_block, burn_in_blocks,
                block_offset=ref.block_offset,
                start_block_idx=burn_in_blocks + start_block,
                aux_init=aux_init)
            exec_logger.info(
                f"resuming fused sweep from synchronized checkpoints "
                f"at block {start_block}/{num_blocks}")
        else:
            blocks_iter = sweep.blocks(state, nts_block,
                                       burn_in_blocks,
                                       block_offset=ref.block_offset)
            for _ in range(burn_in_blocks):
                next(blocks_iter)
            if burn_in_blocks:
                exec_logger.info("Burn-in stage completed.")

        accumulators = [_BlockAccumulator(p) for p in procs]
        for r, acc in zip(resumes, accumulators):
            if r is not None and "accum" in r:
                acc.restore(r["accum"])
        block_data = None
        for block_idx in range(start_block, num_blocks):
            block_data = next(blocks_iter)
            bp = block_data.iter_props
            # Fused props have a trailing row axis (nts, R); estimator
            # arrays have a leading row axis (R, nts, ...).
            energy = np.asarray(bp.energy, dtype=np.float64)
            weight = np.asarray(bp.weight, dtype=np.float64)
            num_walkers = np.asarray(bp.num_walkers, dtype=np.float64)
            ref_energy = np.asarray(bp.ref_energy, dtype=np.float64)
            accum_energy = np.asarray(bp.accum_energy, dtype=np.float64)
            density = np.asarray(block_data.iter_density,
                                 dtype=np.float64) \
                if block_data.iter_density is not None else None
            ssf = np.asarray(block_data.iter_ssf, dtype=np.float64) \
                if block_data.iter_ssf is not None else None
            obd = np.asarray(block_data.iter_obd, dtype=np.float64) \
                if block_data.iter_obd is not None else None
            cmd = np.asarray(block_data.iter_cmd, dtype=np.float64) \
                if block_data.iter_cmd is not None else None
            g2 = np.asarray(block_data.iter_g2, dtype=np.float64) \
                if block_data.iter_g2 is not None else None
            itc = np.asarray(block_data.iter_itc, dtype=np.float64) \
                if block_data.iter_itc is not None else None
            itc_nw = np.asarray(block_data.iter_itc_nw,
                                dtype=np.float64) \
                if block_data.iter_itc_nw is not None else None
            for r, acc in enumerate(accumulators):
                acc.add(block_idx, energy[:, r], weight[:, r],
                        num_walkers[:, r], ref_energy[:, r],
                        accum_energy[:, r],
                        iter_density=density[r]
                        if density is not None else None,
                        iter_ssf=ssf[r] if ssf is not None else None,
                        iter_obd=obd[r] if obd is not None else None,
                        iter_cmd=cmd[r] if cmd is not None else None,
                        iter_g2=g2[r] if g2 is not None else None,
                        iter_itc=itc[r] if itc is not None else None,
                        iter_itc_nw=itc_nw[r]
                        if itc_nw is not None else None)
            if ref.checkpoint_file is not None and \
                    (block_idx + 1) % ref.checkpoint_every == 0:
                _write_sweep_checkpoints(procs, block_data.last_state,
                                         block_idx, burn_in_blocks,
                                         aux_carry=block_data.aux_carry,
                                         accumulators=accumulators)
        exec_logger.info("Fused DMC sweep completed.")

        results = []
        # Host-side row split (device gathers across the sharded sweep
        # axis are rejected by the sharding-in-types rules; results
        # leave the device here anyway).
        host_last = jax.tree.map(np.asarray, block_data.last_state) \
            if block_data is not None else None
        for r, (proc, acc) in enumerate(zip(procs, accumulators)):
            row_state = jax.tree.map(lambda x, r=r: x[r], host_last) \
                if host_last is not None else proc_inputs[r].state
            results.append(proc.build_result(row_state, acc.package()))
        return results


@dataclass(frozen=True)
class VmcSweepProc:
    """Run R VMC procedures as one vmap-fused single-device sweep.

    The VMC analog of :class:`SweepProc`, built on
    :class:`~phd_qmclib_tpu.parallel.sweep.VmcSweep`: rows share block
    structure, chain count and estimator specs; continuous model
    parameters, ``move_spread`` and ``rng_seed`` vary per row.
    """

    procs: t.Tuple[vmc_exec.Proc, ...]

    def __post_init__(self):
        if not self.procs:
            raise ValueError("need at least one procedure")
        ref = self.procs[0]
        for p in self.procs[1:]:
            same = (
                p.num_blocks == ref.num_blocks
                and p.num_steps_block == ref.num_steps_block
                and p.burn_in_blocks == ref.burn_in_blocks
                and p.keep_iter_data == ref.keep_iter_data
                and p.block_offset == ref.block_offset
                and p.num_walkers == ref.num_walkers
                and p.est_every == ref.est_every
                and p.ssf_spec == ref.ssf_spec
                and p.obd_spec == ref.obd_spec
                and p.pair_corr_spec == ref.pair_corr_spec)
            if not same:
                raise ValueError(
                    "all sweep procedures must share block structure, "
                    "chain count and estimator specs")
        for p in self.procs:
            if p.num_mesh_devices is not None:
                raise ValueError(
                    "fused sweep rows are single-device; drop "
                    "num_mesh_devices")
        _validate_sweep_checkpoints(self.procs)

    @property
    def sweep(self) -> VmcSweep:
        return VmcSweep(tuple(p.sampling for p in self.procs))

    def exec(self, proc_inputs: t.Sequence[vmc_exec.ProcInput]) \
            -> t.List[vmc_exec.ProcResult]:
        """Advance every row through its full procedure; one device
        dispatch per block covers all rows."""
        import jax
        import jax.numpy as jnp

        procs = self.procs
        if len(proc_inputs) != len(procs):
            raise ValueError("one ProcInput per procedure")
        ref = procs[0]
        num_blocks = ref.num_blocks
        ns_block = ref.num_steps_block
        burn_in_blocks = ref.burn_in_blocks

        exec_logger.info(
            f"Starting fused VMC sweep ({len(procs)} rows)...")
        sweep = self.sweep
        state = jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[pi.state for pi in proc_inputs])
        resumes = [pi.resume for pi in proc_inputs]
        start_block = 0
        if any(r is not None for r in resumes):
            if any(r is None for r in resumes):
                raise ValueError(
                    "fused sweep resume is all-or-none: every row "
                    "must restore from a checkpoint or none")
            completed = {r["blocks_completed"] for r in resumes}
            if len(completed) != 1:
                raise ValueError(
                    "fused sweep rows must resume from the same "
                    "block (synchronized checkpoints)")
            start_block = completed.pop()
        if start_block:
            # VMC has no window phases; an offset shift by the
            # consumed count reproduces the per-position block keys.
            blocks_iter = sweep.blocks(
                ns_block, state,
                block_offset=(ref.block_offset + burn_in_blocks
                              + start_block))
            exec_logger.info(
                f"resuming fused VMC sweep from synchronized "
                f"checkpoints at block {start_block}/{num_blocks}")
        else:
            blocks_iter = sweep.blocks(ns_block, state,
                                       block_offset=ref.block_offset)
            for _ in range(burn_in_blocks):
                next(blocks_iter)
            if burn_in_blocks:
                exec_logger.info("Burn-in stage completed.")

        accumulators = [vmc_exec._VmcBlockAccumulator(p) for p in procs]
        for r, acc in zip(resumes, accumulators):
            if r is not None and "accum" in r:
                acc.restore(r["accum"])
        block_data = None
        for block_idx in range(start_block, num_blocks):
            block_data = next(blocks_iter)
            bp = block_data.iter_props
            # Fused arrays have a leading row axis (R, nts, ...); the
            # walker axis is reduced on device before the fetch
            # (see vmc_exec._walker_means) -> (R, nts).
            lp_m, en_m, mv_m = vmc_exec._walker_means(
                bp.wf_abs_log, bp.energy, bp.move_stat)
            lp = np.asarray(lp_m, dtype=np.float64)
            energy = np.asarray(en_m, dtype=np.float64)
            mv = np.asarray(mv_m, dtype=np.float64)
            accept = np.asarray(block_data.accept_rate, dtype=np.float64)
            ssf = np.asarray(block_data.iter_ssf, dtype=np.float64) \
                if block_data.iter_ssf is not None else None
            obd = np.asarray(block_data.iter_obd, dtype=np.float64) \
                if block_data.iter_obd is not None else None
            g2 = np.asarray(block_data.iter_g2, dtype=np.float64) \
                if block_data.iter_g2 is not None else None
            for r, acc in enumerate(accumulators):
                acc.add(block_idx, lp[r], energy[r], mv[r],
                        float(accept[r]),
                        iter_ssf=ssf[r] if ssf is not None else None,
                        iter_obd=obd[r] if obd is not None else None,
                        iter_g2=g2[r] if g2 is not None else None)
            if ref.checkpoint_file is not None and \
                    (block_idx + 1) % ref.checkpoint_every == 0:
                _write_sweep_checkpoints(procs, block_data.last_state,
                                         block_idx, burn_in_blocks,
                                         accumulators=accumulators)
        exec_logger.info("Fused VMC sweep completed.")

        results = []
        for r, (proc, acc) in enumerate(zip(procs, accumulators)):
            row_state = jax.tree.map(lambda x, r=r: x[r],
                                     block_data.last_state) \
                if block_data is not None else proc_inputs[r].state
            results.append(proc.build_result(row_state, acc.package()))
        return results
