"""Variational Monte Carlo: Metropolis-Hastings sampling of ``|psi|^2``.

JAX re-design of the reference VMC machine
(``/root/reference/src/phd_qmclib/qmc_base/vmc.py:418-902`` and its
Jastrow/mrbp bindings).  Differences by design:

* The reference runs ONE Markov chain through an infinite numba
  generator; here ``num_walkers`` independent chains advance in lockstep
  as a batched array, and a whole block of steps is a single
  ``lax.scan`` compiled once (the reference's "block" maps exactly to one
  scan).  With ``num_walkers=1`` the algorithm reduces to the
  reference's.
* RNG is ``jax.random`` with keys split per (block, step) - reproducible
  regardless of device count.
* The Metropolis acceptance rule is the reference's
  (``qmc_base/vmc.py:636``): accept when
  ``log|psi_prop| > 0.5*log(u) + log|psi|``.
* The proposal moves every particle with a uniform displacement of
  spread ``move_spread`` (``qmc_base/vmc.py:400-415``), recast into the
  supercell (``mrbp_qmc/vmc.py:216-233``); the Gaussian-proposal variant
  (reference ``vmc_ndf``) uses ``sigma = sqrt(time_step)``
  (``mrbp_qmc/vmc_ndf.py:38-45``).
* The local energy and S(k) parts are evaluated in the same fused pass
  as the wavefunction of the *proposal* and carried through rejections
  with a ``select`` - equivalent to the reference's
  evaluate-on-accept/copy-on-reject (``qmc_base/jastrow/vmc.py:228-351``)
  but branch-free.
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property, lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import utils
from ..models import mrbp

__all__ = [
    "OBDEstSpec",
    "PairCorrEstSpec",
    "PropsData",
    "Sampling",
    "SamplingBlock",
    "SSFEstSpec",
    "State",
]


class State(t.NamedTuple):
    """The walker-ensemble state of a VMC sampling (a pytree).

    ``pos`` has shape ``(W, N)``; scalar chain properties have shape
    ``(W,)``.  Mirrors the reference ``State(sys_conf, wf_abs_log,
    move_stat)`` (``qmc_base/vmc.py:128-132``) batched over walkers, and
    additionally carries the fused local energy and S(k) parts so
    rejected steps reuse them.
    """
    pos: jnp.ndarray
    wf_abs_log: jnp.ndarray
    energy: jnp.ndarray
    move_stat: jnp.ndarray
    ssf_parts: t.Optional[jnp.ndarray] = None  # (W, M, 3)
    obd_parts: t.Optional[jnp.ndarray] = None  # (W, M)


class PropsData(t.NamedTuple):
    """Per-step, per-walker properties of a block
    (``qmc_base/vmc.py:135-139``)."""
    wf_abs_log: jnp.ndarray  # (nts, W)
    energy: jnp.ndarray      # (nts, W)
    move_stat: jnp.ndarray   # (nts, W) bool


class SamplingBlock(t.NamedTuple):
    """The data yielded per block (``qmc_base/vmc.py:142-147``)."""
    iter_props: PropsData
    #: S(k) accumulators summed over walkers, shape ``(nts, M, 3)``
    #: (slots: |rho_k|^2, Re rho_k, Im rho_k); ``None`` when disabled.
    iter_ssf: t.Optional[jnp.ndarray]
    accept_rate: float
    last_state: State
    #: OBDM ``n1`` sums over walkers, shape ``(nts, M)``; ``None`` when
    #: disabled.
    iter_obd: t.Optional[jnp.ndarray] = None
    #: Direct pair-correlation histogram sums over walkers, shape
    #: ``(nts_measured, num_bins)``; ``None`` when disabled.
    iter_g2: t.Optional[jnp.ndarray] = None


@dataclass(frozen=True)
class SSFEstSpec:
    """Static structure factor estimator spec
    (``mrbp_qmc/vmc.py:62-67``)."""
    num_modes: int


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix estimator spec.

    The reference declares the OBDM machinery but leaves it stubbed
    (``qmc_base/vmc.py:444-450``, ``mrbp_qmc/vmc.py:238-240`` - its
    ``init_obd_est_data`` returns ``None``); this spec completes it.
    ``n1(sz)`` is evaluated on a uniform grid of ``num_pos``
    displacements over ``[0, L/2]``.

    Sampling note: the wavefunction-ratio estimator is heavy-tailed -
    a configuration with a near-contact pair (``psi -> 0``) reports an
    enormous ratio, and while such configurations carry vanishing
    equilibrium weight, chains STARTED there (e.g. from RANDOM initial
    configurations at strong coupling) dominate the average until they
    equilibrate away.  Prefer ``SysConfDistType.REGULAR`` starts and
    discard generous burn-in before trusting ``n1 <= 1``.
    """
    num_pos: int
    #: OBDM-specific cadence multiplier on top of ``Sampling.est_every``:
    #: evaluate the grid only every ``est_every * est_every_mult``-th
    #: step.  The grid costs ``num_pos`` shifted pair passes — many
    #: whole Metropolis steps — and consecutive samples are strongly
    #: correlated; chain dynamics and the S(k) estimator are
    #: bit-identical for any value.  ``iter_obd`` then carries
    #: ``num_steps_block // (est_every * est_every_mult)`` entries.
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation ``g2(r)`` estimator spec: a histogram of
    unordered-pair minimum-image distances on ``num_bins`` uniform bins
    over ``[0, L/2]``, evaluated on the chain configurations.

    Beyond the reference (which has no direct pair-correlation
    estimator; g2 there is only reachable by Fourier-inverting the
    truncated S(k)).  Normalization ``g2(r) = <counts> * L /
    (N (N-1) dr)`` is applied by the data layer.
    """
    num_bins: int
    #: Cadence multiplier on top of ``Sampling.est_every`` (the O(N^2)
    #: binning pass costs about one Metropolis step; consecutive
    #: samples are strongly correlated).  Chain dynamics are
    #: bit-identical for any value; ``iter_g2`` carries
    #: ``num_steps_block // (est_every * est_every_mult)`` entries.
    est_every_mult: int = 1


@lru_cache(maxsize=32)
def _shared_block_fn(sampling: "Sampling"):
    """One traced block function per distinct sampling spec (frozen
    dataclass: value-equal specs hash equal), so re-constructed drivers
    reuse traces and compiled executables instead of re-tracing the
    block ``lax.scan``.  Bounded for the same mapping-limit reason as
    the DMC twin (``samplers/dmc.py::_shared_block_fn``)."""
    return sampling._make_block_fn()


@dataclass(frozen=True)
class Sampling:
    """VMC sampling spec bound to an mrbp model.

    Reference: ``mrbp_qmc/vmc.py:70-171`` plus the walker-batch axis.
    """
    model_spec: mrbp.Spec
    move_spread: float
    rng_seed: t.Optional[int] = None
    ssf_est_spec: t.Optional[SSFEstSpec] = None
    obd_est_spec: t.Optional[OBDEstSpec] = None
    pair_corr_est_spec: t.Optional[PairCorrEstSpec] = None
    #: Number of independent Markov chains advanced in lockstep.
    num_walkers: int = 1
    #: Use Gaussian proposals of width ``move_spread`` (the reference's
    #: ``vmc_ndf`` sampling with ``sigma = sqrt(time_step)``).
    gaussian: bool = False
    #: Device mesh for multi-chip runs: chains shard over ``mesh_axis``
    #: (no cross-chain coupling; only the acceptance rate and S(k) sums
    #: reduce over the mesh).  ``None`` = single device.
    mesh: t.Optional[jax.sharding.Mesh] = None
    mesh_axis: str = "walkers"
    #: Estimator measurement cadence: evaluate the S(k)/OBDM grids only
    #: every K-th step (the OBDM grid costs ``num_pos`` extra wf-ratio
    #: passes per step; consecutive Metropolis steps are highly
    #: correlated, so K of 4-8 recovers most of the estimator cost at
    #: negligible statistical price).  Estimator outputs then carry
    #: one entry per measured step (``num_steps_block // est_every``).
    #: The chain dynamics (moves, energies) are identical for any K.
    est_every: int = 1

    def __post_init__(self):
        if self.est_every < 1:
            raise ValueError("est_every must be a positive integer")
        for spec in (self.obd_est_spec, self.pair_corr_est_spec):
            if spec is not None and spec.est_every_mult < 1:
                raise ValueError(
                    "est_every_mult must be a positive integer")
        if self.rng_seed is None:
            object.__setattr__(self, "rng_seed",
                               int(utils.get_random_rng_seed()))
        if self.mesh is not None:
            n = self.mesh.shape[self.mesh_axis]
            if self.num_walkers % n:
                raise ValueError(
                    f"num_walkers must be divisible by the mesh "
                    f"'{self.mesh_axis}' axis size ({n})")

    # -- derived ---------------------------------------------------------

    @property
    def cfc_params(self) -> mrbp.CFCParams:
        return self.model_spec.cfc_params

    @cached_property
    def core_funcs(self):
        return mrbp.core_funcs(self.model_spec)

    @property
    def ssf_momenta(self) -> np.ndarray:
        """Momenta ``k_j = 2 pi j / L`` (``mrbp_qmc/vmc.py:129-143``)."""
        if self.ssf_est_spec is None:
            raise TypeError("no S(k) estimator spec was configured "
                            "for this sampling")
        num_modes = self.ssf_est_spec.num_modes
        sc_size = self.model_spec.supercell_size
        return np.arange(num_modes) * 2 * np.pi / sc_size

    @property
    def obd_pos_offsets(self) -> np.ndarray:
        """OBDM displacement grid: ``num_pos`` uniform points over
        ``[0, L/2]`` (completes the reference's ``obd_pos_offset`` stub,
        ``qmc_base/vmc.py:311-314``)."""
        if self.obd_est_spec is None:
            raise TypeError("the one-body density matrix spec has not "
                            "been specified")
        sc_size = self.model_spec.supercell_size
        return np.linspace(0.0, 0.5 * sc_size, self.obd_est_spec.num_pos)

    @property
    def pair_corr_bin_edges(self) -> np.ndarray:
        if self.pair_corr_est_spec is None:
            raise TypeError(
                "the pair-correlation spec has not been specified")
        num_bins = self.pair_corr_est_spec.num_bins
        return np.linspace(0, 0.5 * self.model_spec.supercell_size,
                           num_bins + 1)

    # -- state construction ------------------------------------------------

    def build_state(self, sys_conf: np.ndarray) -> State:
        """Build the initial ensemble state from one configuration of
        shape ``(2, N)``/``(N,)`` or a batch ``(W, ..., N)``.

        Computes the initial ``log|psi|``, energy and S(k) parts
        (``mrbp_qmc/vmc.py:145-165``).
        """
        sys_conf = np.asarray(sys_conf)
        nop = self.model_spec.boson_number
        # Accept packed (2, N) buffers or bare (N,) position arrays.
        if sys_conf.ndim >= 2 and sys_conf.shape[-2] == 2 \
                and sys_conf.shape[-1] == nop:
            pos = sys_conf[..., mrbp.SysConfSlot.pos, :]
        elif sys_conf.shape[-1] == nop:
            pos = sys_conf
        else:
            raise ValueError("sys_conf shape does not match the "
                             "model spec")
        if pos.ndim == 1:
            pos = np.broadcast_to(pos, (self.num_walkers, nop))
        if pos.shape[0] != self.num_walkers:
            raise ValueError(f"need {self.num_walkers} walker "
                             f"configurations, got {pos.shape[0]}")

        pos = jnp.asarray(pos)
        cfc = self._cast_params(pos.dtype)
        # One jitted dispatch (eager evaluation would issue every op of
        # the O(N^2) kernels as its own executable — painful when
        # compilation is a remote service).
        wf_abs_log, energy, ssf_parts, obd_parts = self._prepare_fn(
            pos, cfc)
        move_stat = jnp.ones(pos.shape[0], dtype=bool)
        return State(pos, wf_abs_log, energy, move_stat, ssf_parts,
                     obd_parts)

    def _cast_params(self, dtype) -> mrbp.CFCParams:
        return jax.tree.map(lambda x: jnp.asarray(x, dtype=dtype),
                            self.cfc_params)

    @cached_property
    def _prepare_fn(self):
        """Jitted initial-state evaluation (wavefunction, energy and
        estimator parts in one dispatch)."""
        funcs = self.core_funcs
        use_ssf = self.ssf_est_spec is not None
        use_obd = self.obd_est_spec is not None
        momenta = np.asarray(self.ssf_momenta) if use_ssf else None
        offsets = np.asarray(self.obd_pos_offsets) if use_obd else None

        @jax.jit
        def prepare(pos, cfc):
            wf_abs_log, energy = funcs.log_psi_and_energy(pos, cfc)
            ssf_parts = funcs.fourier_density_parts(
                jnp.asarray(momenta, dtype=pos.dtype), pos, cfc) \
                if use_ssf else None
            obd_parts = funcs.one_body_density_grid(
                jnp.asarray(offsets, dtype=pos.dtype), pos, cfc) \
                if use_obd else None
            return wf_abs_log, energy, ssf_parts, obd_parts

        return prepare

    # -- the compiled block kernel ------------------------------------------

    def make_run_block(self, axis_name: t.Optional[str] = None):
        """The raw (unjitted, per-shard) block body — scan
        ``num_steps_block`` Metropolis steps and reduce estimator sums
        over ``axis_name`` once per block.  Used by :attr:`_block_fn`
        and by :class:`~phd_qmclib_tpu.parallel.sweep.VmcSweep`."""
        funcs = self.core_funcs
        gaussian = self.gaussian
        use_ssf = self.ssf_est_spec is not None
        num_modes = self.ssf_est_spec.num_modes if use_ssf else 0
        use_obd = self.obd_est_spec is not None
        obd_offsets = np.asarray(self.obd_pos_offsets) if use_obd else None
        use_g2 = self.pair_corr_est_spec is not None
        num_bins_g2 = self.pair_corr_est_spec.num_bins if use_g2 else 0

        def _psum(x):
            return jax.lax.psum(x, axis_name) if axis_name else x

        def _pmean(x):
            return jax.lax.pmean(x, axis_name) if axis_name else x

        cadence = self.est_every

        def make_step_core(with_est: bool):
            est_ssf = use_ssf and with_est
            est_obd = use_obd and with_est

            def step_core(carry: State, disp, u, cfc):
                """One Metropolis step given the pre-drawn noise.

                Shared by the production (key-driven) path and the
                injected-noise replay path (:meth:`replay_chain`), so
                both perform identical arithmetic.
                """
                pos = carry.pos
                prop = mrbp.recast(pos + disp, cfc)

                lp_prop, e_prop = funcs.log_psi_and_energy(prop, cfc)
                # Metropolis condition, reference qmc_base/vmc.py:636.
                accept = lp_prop > 0.5 * jnp.log(u) + carry.wf_abs_log

                new_pos = jnp.where(accept[:, None], prop, pos)
                new_lp = jnp.where(accept, lp_prop, carry.wf_abs_log)
                new_e = jnp.where(accept, e_prop, carry.energy)
                if est_ssf:
                    parts_prop = funcs.fourier_density_parts_harmonics(
                        num_modes, prop, cfc)
                    new_parts = jnp.where(accept[:, None, None],
                                          parts_prop, carry.ssf_parts)
                else:
                    new_parts = None
                if est_obd:
                    offsets = jnp.asarray(obd_offsets, dtype=pos.dtype)
                    obd_prop = funcs.one_body_density_grid(offsets, prop,
                                                           cfc)
                    new_obd = jnp.where(accept[:, None], obd_prop,
                                        carry.obd_parts)
                else:
                    new_obd = None
                new_state = State(new_pos, new_lp, new_e, accept,
                                  new_parts, new_obd)
                # Estimator sums are shard-local; the block runner
                # reduces once per block.
                out = (new_lp, new_e, accept,
                       new_parts.sum(axis=0) if est_ssf else 0.0,
                       new_obd.sum(axis=0) if est_obd else 0.0)
                return new_state, out

            def step(carry: State, key, cfc, move_spread):
                k_move, k_acc = jax.random.split(key)
                pos = carry.pos
                if gaussian:
                    disp = move_spread * jax.random.normal(
                        k_move, pos.shape, dtype=pos.dtype)
                else:
                    disp = move_spread * (jax.random.uniform(
                        k_move, pos.shape, dtype=pos.dtype) - 0.5)
                u = jax.random.uniform(k_acc, carry.wf_abs_log.shape,
                                       dtype=pos.dtype)
                return step_core(carry, disp, u, cfc)

            return step_core, step

        obd_mult = self.obd_est_spec.est_every_mult if use_obd else 1
        g2_mult = self.pair_corr_est_spec.est_every_mult if use_g2 else 1
        # The OBDM's own (sparser) cadence forces the chunked path even
        # at est_every == 1: chunk-final evaluation is identical to the
        # carried step_core values there (see the cadence note below).
        # The g2 histogram always takes the chunked path — it is a pure
        # function of the positions, so chunk-final evaluation needs no
        # carried parts in the State.
        chunked = cadence > 1 or obd_mult > 1 or use_g2
        step_core, step = make_step_core(with_est=not chunked)

        def run_block(state: State, block_key, cfc, move_spread,
                      num_steps_block: int):
            if axis_name is not None:
                block_key = jax.random.fold_in(
                    block_key, jax.lax.axis_index(axis_name))
            keys = jax.random.split(block_key, num_steps_block)

            g2 = 0.0
            if not chunked:
                final_state, (lps, es, accepts, ssf, obd) = jax.lax.scan(
                    lambda c, k: step(c, k, cfc, move_spread), state,
                    keys)
            else:
                # Measurement cadence: advance the chains in chunks of
                # ``cadence`` plain Metropolis steps (no estimator
                # work), then evaluate the S(k)/OBDM grids on the
                # chunk-final configurations.  The values are identical
                # to the every-step scheme's entries at the measured
                # steps (the carried parts always equal
                # ``parts(current pos)``), and the chain dynamics use
                # the exact same key sequence as ``cadence == 1``.
                if num_steps_block % (cadence * obd_mult) \
                        or num_steps_block % (cadence * g2_mult):
                    raise ValueError("num_steps_block must be divisible "
                                     "by est_every (x est_every_mult "
                                     "for the OBDM / pair-correlation "
                                     "estimators)")
                # Parts are not carried in cadence mode.
                state = state._replace(ssf_parts=None, obd_parts=None)
                num_chunks = num_steps_block // cadence
                keys_c = keys.reshape((num_chunks, cadence)
                                      + keys.shape[1:])

                def chunk(carry, inputs):
                    chunk_keys, chunk_idx = inputs
                    new_state, (lps, es, accepts, _, _) = jax.lax.scan(
                        lambda c, k: step(c, k, cfc, move_spread),
                        carry, chunk_keys)
                    pos = new_state.pos
                    ssf_sum = 0.0
                    obd_sum = 0.0
                    g2_sum = 0.0
                    if use_ssf:
                        parts = funcs.fourier_density_parts_harmonics(
                            num_modes, pos, cfc)
                        ssf_sum = parts.sum(axis=0)
                    if use_obd:
                        offsets = jnp.asarray(obd_offsets,
                                              dtype=pos.dtype)

                        def _obd_measure(p):
                            return funcs.one_body_density_grid(
                                offsets, p, cfc).sum(axis=0)

                        if obd_mult == 1:
                            obd_sum = _obd_measure(pos)
                        else:
                            # Skip-branch zeros derive from a varying
                            # operand so both cond branches carry the
                            # same shard_map vartype.
                            obd_sum = jax.lax.cond(
                                (chunk_idx + 1) % obd_mult == 0,
                                _obd_measure,
                                lambda p: jnp.zeros(
                                    (obd_offsets.shape[0],),
                                    pos.dtype) + 0.0 * p[0, 0],
                                pos)
                    if use_g2:
                        def _g2_measure(p):
                            return funcs.pair_dist_histogram(
                                num_bins_g2, p, cfc).sum(axis=0)

                        if g2_mult == 1:
                            g2_sum = _g2_measure(pos)
                        else:
                            g2_sum = jax.lax.cond(
                                (chunk_idx + 1) % g2_mult == 0,
                                _g2_measure,
                                lambda p: jnp.zeros(
                                    (num_bins_g2,),
                                    pos.dtype) + 0.0 * p[0, 0],
                                pos)
                    return new_state, (lps, es, accepts, ssf_sum,
                                       obd_sum, g2_sum)

                final_state, (lps, es, accepts, ssf, obd, g2) = \
                    jax.lax.scan(chunk, state,
                                 (keys_c, jnp.arange(num_chunks)))
                lps, es, accepts = (
                    x.reshape((num_steps_block,) + x.shape[2:])
                    for x in (lps, es, accepts))
                if use_obd and obd_mult > 1:
                    # One entry per OBDM-measured step.
                    obd = obd[obd_mult - 1::obd_mult]
                if use_g2 and g2_mult > 1:
                    g2 = g2[g2_mult - 1::g2_mult]

            if axis_name is not None and use_ssf:
                ssf = _psum(ssf)
            if axis_name is not None and use_obd:
                obd = _psum(obd)
            if axis_name is not None and use_g2:
                g2 = _psum(g2)
            accept_rate = _pmean(accepts.mean())
            return (final_state, PropsData(lps, es, accepts), ssf, obd,
                    g2, accept_rate)

        run_block.step_core = step_core
        return run_block

    @cached_property
    def _block_fn(self):
        return _shared_block_fn(self)

    def _make_block_fn(self):
        use_ssf = self.ssf_est_spec is not None
        use_obd = self.obd_est_spec is not None
        axis_name = self.mesh_axis if self.mesh is not None else None
        run_block = self.make_run_block(axis_name=axis_name)

        if self.mesh is None:
            return jax.jit(run_block,
                           static_argnames=("num_steps_block",))

        P = jax.sharding.PartitionSpec
        ax = self.mesh_axis
        state_spec = State(pos=P(ax), wf_abs_log=P(ax), energy=P(ax),
                           move_stat=P(ax),
                           ssf_parts=P(ax) if use_ssf else None,
                           obd_parts=P(ax) if use_obd else None)
        props_spec = PropsData(P(None, ax), P(None, ax), P(None, ax))

        def sharded_block(state, block_key, cfc, move_spread,
                          num_steps_block: int):
            fn = jax.shard_map(
                lambda st, k, cf, ms: run_block(st, k, cf, ms,
                                                num_steps_block),
                mesh=self.mesh,
                in_specs=(state_spec, P(), P(), P()),
                out_specs=(state_spec, props_spec, P(), P(), P(), P()))
            return fn(state, block_key, cfc, move_spread)

        return jax.jit(sharded_block,
                       static_argnames=("num_steps_block",))

    # -- public sampling APIs -------------------------------------------------

    def blocks(self, num_steps_block: int, ini_state: State,
               block_offset: int = 0) -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        Reference: ``qmc_base/vmc.py:669-770``; here one block is one
        compiled ``lax.scan`` dispatch.  Block keys derive from
        ``(rng_seed, block_offset + block_idx)``; continuation runs
        pass the consumed block count as ``block_offset`` to keep their
        stream independent of the original run's.
        """
        if num_steps_block < 1:
            raise ValueError("num_steps_block must be nonzero and positive")
        base_key = jax.random.PRNGKey(self.rng_seed)
        state = ini_state
        if self.ssf_est_spec is not None and state.ssf_parts is None:
            # A state built/loaded without S(k) data: compute the parts.
            cfc0 = self._cast_params(state.pos.dtype)
            momenta = jnp.asarray(self.ssf_momenta, dtype=state.pos.dtype)
            parts = self.core_funcs.fourier_density_parts(
                momenta, state.pos, cfc0)
            state = state._replace(ssf_parts=parts)
        if self.obd_est_spec is not None and state.obd_parts is None:
            cfc0 = self._cast_params(state.pos.dtype)
            offsets = jnp.asarray(self.obd_pos_offsets,
                                  dtype=state.pos.dtype)
            state = state._replace(
                obd_parts=self.core_funcs.one_body_density_grid(
                    offsets, state.pos, cfc0))
        cfc = self._cast_params(ini_state.pos.dtype)
        move_spread = jnp.asarray(self.move_spread,
                                  dtype=ini_state.pos.dtype)
        block_idx = int(block_offset)
        while True:
            block_key = jax.random.fold_in(base_key, block_idx)
            state, props, ssf, obd, g2, accept_rate = self._block_fn(
                state, block_key, cfc, move_spread, num_steps_block)
            yield SamplingBlock(props, ssf if self.ssf_est_spec else None,
                                float(accept_rate), state,
                                obd if self.obd_est_spec else None,
                                g2 if self.pair_corr_est_spec else None)
            block_idx += 1

    def replay_chain(self, ini_state: State, moves_u: np.ndarray,
                     accept_u: np.ndarray):
        """Drive the sampler with *injected* noise instead of
        ``jax.random`` draws — the bit-comparable reference-replay mode
        (SURVEY §5 RNG discipline; see
        :mod:`phd_qmclib_tpu.reference_replay`).

        ``moves_u``: raw uniforms of the per-particle move draws
        (with ``gaussian=True``: the PRE-SCALED Gaussian
        displacements, as the reference's ``normal(0, sigma)`` draws),
        shape ``(nts, N)`` for a single chain or ``(nts, W, N)``
        batched.
        ``accept_u``: raw Metropolis uniforms, shape ``(nts,)`` or
        ``(nts, W)``.  The displacement/acceptance arithmetic is the
        production step's own (``make_run_block.step_core``), so a
        trajectory match against the NumPy replay certifies the
        production sampler.

        Returns ``(pos (nts, W, N), wf_abs_log (nts, W),
        accepted (nts, W))`` — the post-step chain states.
        """
        moves_u = jnp.asarray(moves_u, dtype=ini_state.pos.dtype)
        accept_u = jnp.asarray(accept_u, dtype=ini_state.pos.dtype)
        if moves_u.ndim == 2:
            moves_u = moves_u[:, None, :]
        if accept_u.ndim == 1:
            accept_u = accept_u[:, None]
        step_core = self.make_run_block().step_core
        cfc = self._cast_params(ini_state.pos.dtype)
        move_spread = jnp.asarray(self.move_spread,
                                  dtype=ini_state.pos.dtype)

        @jax.jit
        def run(state, moves_u, accept_u):
            def body(carry, noise):
                mu, au = noise
                if self.gaussian:
                    # Injected draws are the pre-scaled displacements.
                    disp = mu
                else:
                    disp = move_spread * (mu - 0.5)
                new_state, _ = step_core(carry, disp, au, cfc)
                return new_state, (new_state.pos, new_state.wf_abs_log,
                                   new_state.move_stat)
            _, traj = jax.lax.scan(body, state, (moves_u, accept_u))
            return traj

        return run(ini_state, moves_u, accept_u)

    def as_chain(self, num_steps: int, ini_state: State) -> SamplingBlock:
        """The VMC sampling as a single block of ``num_steps`` steps
        (``qmc_base/vmc.py:772-806``)."""
        if num_steps < 1:
            raise ValueError("num_steps must be at least 1")
        return next(self.blocks(num_steps, ini_state))

    def states(self, ini_state: State) -> t.Iterator[State]:
        """Step-by-step state generator (reference
        ``qmc_base/vmc.py:244-251``); one device dispatch per step -
        use :meth:`blocks` for production."""
        for block in self.blocks(1, ini_state):
            yield block.last_state

    def state_data_blocks(self, num_steps_block: int, ini_state: State,
                          thin: int = 1, block_offset: int = 0):
        """Yield blocks that additionally record the chain
        configurations (reference ``qmc_base/vmc.py:808-902``).

        Yields ``(confs, block)`` where ``confs`` has shape
        ``(num_steps_block // thin, W, N)`` - every ``thin``-th step's
        walker positions - and ``block`` is the usual
        :class:`SamplingBlock`.  Feeds the wavefunction-optimization
        workflow (configurations + their log-psi values).
        """
        if num_steps_block % thin:
            raise ValueError("num_steps_block must be divisible by thin")

        funcs = self.core_funcs
        base_fn = self._block_fn

        @jax.jit
        def collect(state, block_key, cfc, move_spread):
            # Sub-blocks of `thin` steps; keep each sub-block's final
            # configuration.
            def body(carry, key):
                # Calling the jitted block fn inside jit inlines it.
                new_state, props, ssf, _obd, _g2, _ = base_fn(
                    carry, key, cfc, move_spread, thin)
                return new_state, (new_state.pos, props, ssf)
            keys = jax.random.split(block_key, num_steps_block // thin)
            final_state, (confs, props, ssf) = jax.lax.scan(body, state,
                                                            keys)
            return final_state, confs, props, ssf

        base_key = jax.random.PRNGKey(self.rng_seed)
        state = ini_state
        cfc = self._cast_params(ini_state.pos.dtype)
        move_spread = jnp.asarray(self.move_spread,
                                  dtype=ini_state.pos.dtype)
        block_idx = int(block_offset)
        while True:
            block_key = jax.random.fold_in(base_key, block_idx)
            state, confs, props, ssf = collect(state, block_key, cfc,
                                               move_spread)
            props_flat = PropsData(
                *(x.reshape((-1,) + x.shape[2:]) for x in props))
            accept_rate = float(np.asarray(props_flat.move_stat,
                                           dtype=np.float64).mean())
            block = SamplingBlock(props_flat,
                                  None if self.ssf_est_spec is None
                                  else ssf.reshape((-1,) + ssf.shape[2:]),
                                  accept_rate, state)
            yield confs, block
            block_idx += 1
