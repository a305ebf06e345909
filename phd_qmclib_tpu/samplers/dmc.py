"""Diffusion Monte Carlo: drift-diffusion propagation with birth/death
branching and population control.

JAX re-design of the reference DMC machine
(``/root/reference/src/phd_qmclib/qmc_base/dmc.py:476-1070`` and
``qmc_base/jastrow/dmc.py``).  Key design translations:

* **Vectorized branching comb.**  The reference's serial stochastic comb
  (clone factor ``int(w_i + u_i)`` filling a cloning table until
  ``max_num_walkers``, ``qmc_base/dmc.py:621-653``) becomes
  ``floor(w + u) -> cumsum -> searchsorted``: the parent index of child
  ``j`` is the first walker whose cumulative clone count exceeds ``j``.
  This produces the *same* child multiset as the reference (capped at
  the buffer size) with static shapes and O(W log W) parallel work, so
  the population dynamics are statistically identical while staying
  XLA-compilable.
* **One block = one ``lax.scan``** over time steps; the Python driver
  loops over blocks exactly like the reference's ``Proc.exec``.
* **Per-step pipeline** mirrors the reference generator
  (``qmc_base/dmc.py:739-785``): comb on the previous step's weights ->
  children are the *pre-diffusion* parent configurations with parent
  energies and unit weights (``jastrow/dmc.py:933-941``) -> ensemble
  sums update the reference-energy controller
  ``E_ref = E_accum - c * log(W / W_target) / dt``
  (``qmc_base/dmc.py:769-771``) -> children diffuse with the *previous*
  ``E_ref`` (``jastrow/dmc.py:742-827``): ``z' = z + 2 F dt + N(0,
  sigma)``, ``sigma = sqrt(2 dt)``, recast into the supercell, fused
  energy+drift recomputation, branching weight
  ``w = exp(-dt ((E' + E)/2 - E_ref))``.
* **Estimators** (density histogram, S(k) Fourier parts) are evaluated
  on the post-branching ensemble inside the scan, with *pure
  (forward-walking)* accumulators transported through the parent gather
  each step and frozen after ``pfw_num_time_steps``, divided by
  ``min(step+1, pfw)`` (``jastrow/dmc.py:362-573``).  NOTE: the
  reference's *density* transport copies the auxiliary array by walker
  slot instead of through the cloning table (``jastrow/dmc.py:246-252``
  vs the S(k) gather at ``:407``); this implementation transports both
  estimators through ancestry, which is the correct forward-walking
  scheme.
* **Multi-chip**: the same step runs under ``shard_map`` with the
  walker axis sharded; the comb is per-shard and the ensemble
  reductions become ``psum`` over the mesh (set ``axis_name``).
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property, lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import utils
from ..models import mrbp
from ..ops import histogram as hist_ops

__all__ = [
    "DensityEstSpec",
    "ITCEstSpec",
    "OBDEstSpec",
    "PairCorrEstSpec",
    "PropsData",
    "Sampling",
    "SamplingBlock",
    "SSFEstSpec",
    "State",
    "branching_comb",
    "itc_lag_products",
    "itc_walker_lag_products",
]


class State(t.NamedTuple):
    """DMC walker-ensemble state (a pytree).

    Mirrors the reference ``State`` (``qmc_base/dmc.py:117-127``):
    per-walker arrays sized to the ``max_num_walkers`` buffer plus the
    ensemble scalars, with two controller accumulators
    (``total_energy``, ``total_weight``) that the reference keeps as
    locals of its infinite generator (``qmc_base/dmc.py:734-735``).
    """
    pos: jnp.ndarray        # (Wm, N) walker positions
    drift: jnp.ndarray      # (Wm, N) drift forces at pos
    energies: jnp.ndarray   # (Wm,) local energies at pos
    weights: jnp.ndarray    # (Wm,) branching weights
    masks: jnp.ndarray      # (Wm,) bool; True = slot INVALID (ref conv.)
    energy: jnp.ndarray     # scalar: ensemble energy sum of last step
    weight: jnp.ndarray     # scalar: ensemble weight of last step
    num_walkers: jnp.ndarray    # scalar int: valid walkers
    ref_energy: jnp.ndarray     # scalar: E_ref for the next diffusion
    accum_energy: jnp.ndarray   # scalar: running growth-energy estimate
    total_energy: jnp.ndarray   # scalar: controller accumulator
    total_weight: jnp.ndarray   # scalar: controller accumulator
    #: CM-diffusion accumulator (``cm_diffusion_est``): each walker's
    #: ancestry-transported center-of-mass displacement since the
    #: current measurement window opened, shape ``(Wm,)``.  Lives in
    #: the State (not the per-block scratch) so the window can span
    #: blocks (``cm_window_blocks``).  ``None`` when disabled;
    #: persisted by the schema-v2 mid-run checkpoints (``qmc_exec/io``
    #: writes it as an extra state dataset) so a kill/restore resumes
    #: the window instead of reopening it.
    cmd_accum: t.Optional[jnp.ndarray] = None
    #: Imaginary-time-correlation lag ring buffer (``itc_est_spec``):
    #: each walker's ``(Re rho_k, Im rho_k)`` amplitudes from the last
    #: ``num_lags`` MEASURED steps, ancestry-transported every step,
    #: shape ``(Wm, num_lags, num_modes, 2)`` with lag 1 (the most
    #: recent measured step) first.  Rides the State for the same
    #: reasons as ``cmd_accum``: per-step transport, rebalance
    #: permutation, and checkpoint persistence all come with the
    #: walker buffers.  ``None`` when disabled.
    itc_buf: t.Optional[jnp.ndarray] = None
    #: Number of VALID lag rows in ``itc_buf`` (scalar int32,
    #: saturating at ``num_lags``): measured steps shift a row in, so
    #: lags ``1..itc_filled`` hold real amplitudes while deeper rows
    #: are still the zero fill of a fresh buffer.  ``None`` when
    #: disabled.
    itc_filled: t.Optional[jnp.ndarray] = None

    @property
    def max_num_walkers(self) -> int:
        return self.pos.shape[-2]

    @property
    def confs(self) -> jnp.ndarray:
        """Packed ``(Wm, 2, N)`` (pos, drift) buffer - the reference's
        state-confs layout for HDF5 interop."""
        return jnp.stack([self.pos, self.drift], axis=-2)


class PropsData(t.NamedTuple):
    """Per-step ensemble properties of a block
    (``qmc_base/dmc.py:130-143``)."""
    energy: jnp.ndarray        # (nts,)
    weight: jnp.ndarray        # (nts,)
    num_walkers: jnp.ndarray   # (nts,)
    ref_energy: jnp.ndarray    # (nts,)
    accum_energy: jnp.ndarray  # (nts,)


class SamplingBlock(t.NamedTuple):
    """Data yielded per block (``qmc_base/dmc.py:146-152``)."""
    iter_props: PropsData
    iter_density: t.Optional[jnp.ndarray]  # (nts, num_bins)
    iter_ssf: t.Optional[jnp.ndarray]      # (nts, num_modes, 3)
    last_state: State
    iter_obd: t.Optional[jnp.ndarray] = None  # (nts, num_pos)
    #: Center-of-mass imaginary-time diffusion accumulators, shape
    #: ``(nts, 2)``: per-step ``[sum_w W_cm^2, sum_w W_cm]`` over the
    #: valid walkers, where ``W_cm`` is each walker's accumulated CM
    #: displacement since the block start (ancestry-transported).
    #: ``None`` unless ``cm_diffusion_est`` is enabled.
    iter_cmd: t.Optional[jnp.ndarray] = None
    #: Direct pair-correlation histogram sums, shape
    #: ``(nts_measured, num_bins)``; ``None`` when disabled.
    iter_g2: t.Optional[jnp.ndarray] = None
    #: Imaginary-time density-density correlation sums, shape
    #: ``(nts_measured, num_lags + 1, num_modes)``: row 0 is the
    #: equal-time ``sum_w |rho_k|^2`` (the S(k) numerator), row ``l``
    #: the lag-``l`` ``sum_w Re[rho_k(t) rho_k(t - l K dt)^*]`` over
    #: the branching ancestry (``K = est_every``).  ``None`` when
    #: disabled.
    iter_itc: t.Optional[jnp.ndarray] = None
    #: Contributing-walker counts for ``iter_itc``, shape
    #: ``(nts_measured, num_lags + 1)``: ``num_walkers`` for every lag
    #: whose ring-buffer row was already filled, 0 for deeper lags
    #: during the initial fill — the denominators of the lag averages.
    iter_itc_nw: t.Optional[jnp.ndarray] = None
    #: Post-block pure-estimator forward-walking accumulators (the
    #: aux carry: ``{"aux_density": (Wm, bins), ...}``) when the pfw
    #: window spans several blocks; ``None`` otherwise.  Exposed so
    #: the execution layer can persist the COMPLETE measurement state
    #: in mid-run checkpoints (a window straddling a checkpoint then
    #: resumes bit-exactly instead of restarting).
    aux_carry: t.Optional[dict] = None


@dataclass(frozen=True)
class DensityEstSpec:
    """Density estimator spec (``mrbp_qmc/dmc.py:103-122``)."""
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class SSFEstSpec:
    """Static structure factor estimator spec
    (``mrbp_qmc/dmc.py:125-140``)."""
    num_modes: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix estimator spec: ``n1(sz)`` on a
    ``num_pos``-point grid over ``[0, L/2]``.

    Beyond the reference, which stubs the OBDM machinery out
    (``qmc_base/vmc.py:444-450``) and has no DMC analog at all.

    Estimator caveat (unlike density/S(k), which are diagonal in
    position): ``n1`` is an OFF-DIAGONAL observable, so no forward-
    walking scheme yields the exact pure ``<phi|n1|phi>``.  With
    ``as_pure_est=False`` this computes the standard mixed estimator
    ``<phi| n1_loc |psi_T>`` (``n1_loc(R) = (1/N) sum_i
    psi_T(R + sz e_i)/psi_T(R)``); with ``as_pure_est=True`` the
    per-walker ``n1_loc`` values transport through the branching
    ancestry, giving the forward-walking average ``<phi^2| n1_loc>`` -
    exact when ``psi_T`` equals the ground state (validated against the
    analytic integral in the ideal-gas limit,
    ``tests/samplers/test_dmc_obd.py``), otherwise an improved but not
    fully pure estimate.  For publication-grade OBDMs combine with the
    VMC estimator via the usual extrapolation ``2 <mixed> - <vmc>``.
    """
    num_pos: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    #: OBDM-specific cadence multiplier on top of ``Sampling.est_every``:
    #: evaluate the ``num_pos``-offset grid only every
    #: ``est_every * est_every_mult``-th step.  The grid costs
    #: ``num_pos`` shifted pair passes — tens of times the whole DMC
    #: step — while density/S(k) cost a fraction of one, so the OBDM
    #: wants a much sparser (and statistically near-free, the samples
    #: being strongly correlated) cadence than the cheap estimators.
    #: The walker dynamics and the other estimators are bit-identical
    #: for any value; pure-estimator ancestry transport still advances
    #: every step.  ``iter_obd`` then carries
    #: ``num_time_steps_block // (est_every * est_every_mult)`` entries.
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation ``g2(r)`` estimator spec: a histogram of
    unordered-pair minimum-image distances on ``num_bins`` uniform bins
    over ``[0, L/2]``.

    Beyond the reference, which has no direct pair-correlation
    estimator (there g2 is only reachable by Fourier-inverting the
    truncated S(k); cf. ``analysis.pair_correlation_from_ssf`` /
    ``SSFBlocks.pair_correlation``).  The direct histogram has no mode
    cutoff — exact real-space resolution at the bin width — at the
    cost of one O(N^2) binning pass per measured step (use
    ``est_every_mult`` to thin it like the OBDM grid).  Normalization:
    ``g2(r) = <counts> * L / (N (N-1) dr)`` (1 for uncorrelated
    uniform positions); the data layer applies it.
    """
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    #: Cadence multiplier on top of ``Sampling.est_every``: bin the
    #: pair distances only every ``est_every * est_every_mult``-th
    #: step.  The histogram costs about one extra pairwise pass —
    #: comparable to the whole bare step — while consecutive samples
    #: are strongly correlated; the walker dynamics and the other
    #: estimators are bit-identical for any value.
    est_every_mult: int = 1


@dataclass(frozen=True)
class ITCEstSpec:
    """Imaginary-time density-density correlation estimator spec:
    ``F(k, tau) = <rho_k(t + tau) rho_-k(t)> / N`` for the harmonic
    momenta ``k_j = j 2 pi / L`` at lags ``tau = l * est_every * dt``,
    ``l = 0..num_lags`` — the intermediate scattering function, whose
    imaginary-time decay bounds the excitation spectrum
    (``F(k, tau) -> Z_k e^{-omega_k tau}`` at large ``tau``, so an
    effective-energy fit gives an upper bound on ``omega_k`` that
    tightens with ``tau``; cf. the f-sum rule
    ``-dF/dtau|_0 = k^2`` in the framework's energy units).

    Beyond the reference, which has no two-time observables at all:
    each walker carries the ``rho_k`` amplitudes of its last
    ``num_lags`` measured steps in an ancestry-transported ring buffer
    (``State.itc_buf``), so the products follow the weighted DMC paths
    exactly.  Lag 0 reproduces the S(k) numerator (bit-identical to
    the ``ssf`` estimator's mixed slot-0 sums when both are enabled).

    **Mixed vs pure.**  The default is the MIXED estimator: the later
    insertion ``rho_k(t + tau)`` touches the trial function, so the
    amplitudes carry ``O(psi_T - phi_0)`` bias while the DECAY RATES
    stay exact (the early endpoint is already interior — DMC evolved
    past it).  ``as_pure_est=True`` applies the same forward-walking
    discipline as the other estimators (reference pure transport:
    ``qmc_base/jastrow/dmc.py:194-462``) to the two-time product: each
    measured per-walker product ``rho_k(t) rho_-k(t - l dtau)``
    accumulates into an ancestry-transported aux array and is sampled
    at the forward-walking window end, weighting every contribution by
    its number of descendants — in the long-projection limit BOTH
    endpoints become interior and the estimator converges to
    ``<phi_0| rho_k e^{-tau(H - E_0)} rho_-k |phi_0>`` over the
    projected norm.  Matching per-lag descendant-weighted counts ride
    along, so the ratio-of-means normalization is the standard pure
    one.  Mixed stays the default so lag 0 remains bit-identical to
    the ``ssf`` estimator's mixed slot-0 numerator and the recorded
    chip baselines stay reproducible; the production config opts into
    pure.  ``pfw_num_time_steps`` has the same window semantics as the
    other pure estimators (``None`` = accumulate all window long).

    Cost: the buffer must ride the branching every step, but gathers
    compose — so the per-step work is one ``(Wm,)`` int32 parent
    composition, and the full ``(Wm, num_lags, num_modes, 2)`` buffer
    gather happens only on ITC-MEASURED steps (bit-identical to
    per-step transport; A/B verified), plus one Chebyshev-harmonics
    pass (sliced from the S(k) estimator's when it ran this step) and
    the lag products per measured step.

    The buffer also rides shard rebalances (replicated transiently —
    size ``num_lags * num_modes`` per walker ample headroom at the
    documented configs, but count it on memory-tight meshes).

    ``est_every_mult`` (OBDM-style cadence multiplier) measures and
    shifts the ring buffer only every ``est_every * est_every_mult``-th
    step, so the lag unit becomes ``est_every * est_every_mult * dt``:
    the deep-decay regime ``omega_1 * tau_max >~ 1`` is reachable
    WITHOUT growing the buffer — tau_max scales with the multiplier at
    fixed memory, and the composed transport even spreads the buffer
    gathers ``mult`` times thinner.  The walker dynamics and the other
    estimators are bit-identical for any value.
    """
    num_modes: int
    num_lags: int
    est_every_mult: int = 1
    as_pure_est: bool = False
    pfw_num_time_steps: t.Optional[int] = None

    def __post_init__(self):
        if self.num_modes < 1:
            raise ValueError("num_modes must be a positive integer")
        if self.num_lags < 1:
            raise ValueError("num_lags must be a positive integer")
        if self.est_every_mult < 1:
            raise ValueError(
                "est_every_mult must be a positive integer")


#: The ITC lag products are real f32 sums over up to ~17k walkers; a
#: GPU's default matmul precision may round the factors to TF32 (about
#: three significant digits), so they ask for full f32.
ITC_PRECISION = jax.lax.Precision.HIGHEST


def itc_walker_lag_products(buf, reim):
    """Per-walker ITC lag products ``sum_c buf[w, l, k, c] reim[w, k, c]``
    of the ``(W, lags, modes, 2)`` ring buffer with the current
    ``(W, modes, 2)`` amplitudes: ``(W, lags, modes)``."""
    return jnp.einsum("wlkc,wkc->wlk", buf, reim, precision=ITC_PRECISION)


def itc_lag_products(buf, reim, maskf):
    """Walker sums of :func:`itc_walker_lag_products` weighted by
    ``maskf (W,)``: ``(lags, modes)``."""
    return jnp.einsum("wlkc,wkc,w->lk", buf, reim, maskf,
                      precision=ITC_PRECISION)


def branching_comb(weights: jnp.ndarray, num_walkers: jnp.ndarray,
                   key=None, *, u: t.Optional[jnp.ndarray] = None) \
        -> t.Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized stochastic branching comb.

    Each valid parent ``i`` is cloned ``floor(w_i + u_i)`` times; the
    first ``max_num_walkers`` children survive.  Statistically identical
    to the reference's serial comb (``qmc_base/dmc.py:621-653``) — and
    *exactly* identical given the same uniforms (pass them via ``u``;
    the replay harness does).

    :return: ``(parent_idx (Wm,), new_num_walkers scalar)``.
    """
    max_w = weights.shape[-1]
    if u is None:
        u = jax.random.uniform(key, weights.shape, dtype=weights.dtype)
    slots = jnp.arange(max_w)
    valid = slots < num_walkers
    n_clones = jnp.floor(weights + u).astype(jnp.int32)
    n_clones = jnp.where(valid, n_clones, 0)
    cum = jnp.cumsum(n_clones)
    new_num = jnp.minimum(cum[-1], max_w)
    # parent[slot] = #{i : cum[i] <= slot} (== searchsorted right,
    # bit-identical; one counting pass instead of a binary search).  The
    # count ``marks[v] = #{i : cum[i] = v}`` is an integer histogram,
    # built like ``ops/histogram.py`` instead of a scatter-add (which
    # serializes on duplicate indices): factorize ``v = q R + r`` into
    # two narrow one-hots whose contraction is ONE matmul.  Counts
    # <= max_w < 2^24 are exact in f32.
    idx = jnp.minimum(cum, max_w)
    r_split = 128
    q_count = (max_w + 1 + r_split - 1) // r_split
    fdtype = weights.dtype if weights.dtype in (jnp.float32,
                                                jnp.float64) \
        else jnp.float32
    fq = (idx[:, None] // r_split
          == jnp.arange(q_count)).astype(fdtype)
    fr = (idx[:, None] % r_split == jnp.arange(r_split)).astype(fdtype)
    # 0/1 factors and integer sums are exact under any matmul
    # precision (TF32 and bf16 represent 0 and 1 exactly).
    marks2d = jnp.einsum("iq,ir->qr", fq, fr,
                         preferred_element_type=fdtype,
                         precision=jax.lax.Precision.DEFAULT)
    marks = marks2d.reshape(q_count * r_split)[:max_w].astype(jnp.int32)
    parent = jnp.clip(jnp.cumsum(marks), 0, max_w - 1)
    return parent, new_num


@lru_cache(maxsize=32)
def _shared_block_fn(sampling: "Sampling", measure: bool):
    """One traced block function per distinct sampling spec.

    :class:`Sampling` is a frozen dataclass, so value-equal specs hash
    equal; re-constructing a driver (sweeps, checkpoint restores, the
    exec layer's run/variant pairs) reuses the existing trace and
    compiled executables instead of paying a full re-trace of the block
    ``lax.scan``.

    The cache is BOUNDED: every retained entry pins compiled
    executables, whose mmap'd code sections count against the kernel's
    per-process mapping limit (``vm.max_map_count``) — an unbounded
    cache exhausted it under a long test session ("LLVM ERROR: Unable
    to allocate section memory").  Eviction releases the executables;
    live ``Sampling`` instances keep theirs via ``cached_property``.
    """
    return sampling._make_block_fn(measure)


@dataclass(frozen=True)
class Sampling:
    """DMC sampling spec bound to an mrbp model.

    Reference: ``mrbp_qmc/dmc.py:143-334``.  The walker buffer has the
    fixed size ``max_num_walkers``; ``target_num_walkers`` drives the
    population controller.
    """
    model_spec: mrbp.Spec
    time_step: float
    max_num_walkers: int
    target_num_walkers: int
    num_walkers_control_factor: t.Optional[float] = None
    rng_seed: t.Optional[int] = None
    density_est_spec: t.Optional[DensityEstSpec] = None
    ssf_est_spec: t.Optional[SSFEstSpec] = None
    obd_est_spec: t.Optional[OBDEstSpec] = None
    pair_corr_est_spec: t.Optional[PairCorrEstSpec] = None
    itc_est_spec: t.Optional[ITCEstSpec] = None
    #: Device mesh for multi-chip runs: the walker axis shards over
    #: ``mesh_axis``; branching is per-shard, population control global
    #: (psum over the mesh).  ``None`` = single device.
    mesh: t.Optional[jax.sharding.Mesh] = None
    mesh_axis: str = "walkers"
    #: Every K blocks, redistribute the valid walkers evenly across the
    #: mesh shards.  Per-shard branching makes shard populations random
    #: walk, so on long multi-chip runs a shard can drift toward its
    #: buffer cap and silently clip its comb (docs/DESIGN.md section 4);
    #: ``None`` disables rebalancing (single-device runs never need it).
    rebalance_every: t.Optional[int] = None
    #: Center-of-mass imaginary-time diffusion estimator: accumulate
    #: each walker's CM displacement (drift + noise, pre-recast, so
    #: windings count) through the branching ancestry and emit per-step
    #: ``[sum W_cm^2, sum W_cm]`` over the ensemble.  The long-tau
    #: slope of ``N <W_cm^2> / (2 tau)`` is the superfluid fraction /
    #: inverse effective mass ``m/m*`` of the lattice gas (exact
    #: band-curvature target: ``ideal.effective_mass_ratio``; Galilean
    #: invariance pins it to 1 without a lattice for ANY interaction).
    #: The accumulation window is one block — use long blocks
    #: (``tau = nts * dt`` of order 1) for the asymptotic slope.  No
    #: reference analog.
    cm_diffusion_est: bool = False
    #: Measurement-window length for ``cm_diffusion_est``, in blocks:
    #: the CM accumulator resets every ``cm_window_blocks`` measured
    #: blocks, so the observable window is ``tau = K * nts * dt``.
    #: ``1`` = per-block window (round-2 behavior); ``None`` = one
    #: window spanning the whole run (deep lattices need long windows
    #: for the asymptotic diffusion slope — benchmarks/effective_mass).
    cm_window_blocks: t.Optional[int] = 1
    #: Estimator measurement cadence: evaluate density/S(k)/OBDM only
    #: every K-th time step (the walker dynamics — and the pure
    #: estimators' ancestry transport — still advance every step).  The
    #: density one-hot alone costs as much as the whole pairwise pass
    #: at production shapes, while samples one step apart are almost
    #: perfectly correlated, so K of 4-8 buys back most of the
    #: estimator overhead at negligible statistical cost.  1 (the
    #: reference's behavior, ``qmc_base/dmc.py:930-940``) measures
    #: every step.  Estimator outputs then carry one entry per
    #: MEASURED step (``num_time_steps_block // est_every``).
    est_every: int = 1
    #: Reference-exact branching-weight semantics: use the *slot's*
    #: previous-step energy as ``E_prev`` in
    #: ``w = exp(-dt ((E_next + E_prev)/2 - E_ref))`` — reproducing the
    #: reference's stale-slot read (``jastrow/dmc.py:846-847``; see
    #: :mod:`~phd_qmclib_tpu.reference_replay`) — instead of the
    #: parent's energy.  Needed for bit-exact replay
    #: (:meth:`replay_states`); both are valid O(dt) discretizations.
    ref_compat: bool = False

    def __post_init__(self):
        if self.rng_seed is None:
            object.__setattr__(self, "rng_seed",
                               int(utils.get_random_rng_seed()))
        if self.num_walkers_control_factor is None:
            # Reference default (``mrbp_qmc/dmc.py:168-170``).
            object.__setattr__(self, "num_walkers_control_factor", 0.125)
        if self.est_every < 1:
            raise ValueError("est_every must be a positive integer")
        for spec in (self.obd_est_spec, self.pair_corr_est_spec):
            if spec is not None and spec.est_every_mult < 1:
                raise ValueError(
                    "est_every_mult must be a positive integer")
        if self.est_every > 1 or any(
                spec is not None and spec.est_every_mult > 1
                for spec in (self.obd_est_spec,
                             self.pair_corr_est_spec)):
            for spec in (self.density_est_spec, self.ssf_est_spec,
                         self.obd_est_spec, self.pair_corr_est_spec):
                if spec is None or not spec.as_pure_est \
                        or not spec.pfw_num_time_steps:
                    continue
                every = self.est_every
                if spec in (self.obd_est_spec, self.pair_corr_est_spec):
                    every *= spec.est_every_mult
                if spec.pfw_num_time_steps % every:
                    raise ValueError(
                        "pfw_num_time_steps must be divisible by "
                        "est_every (x est_every_mult for the "
                        "OBDM/pair-correlation estimators)")
        if self.mesh is not None:
            n = self.mesh.shape[self.mesh_axis]
            if self.max_num_walkers % n or self.target_num_walkers % n:
                raise ValueError(
                    f"max_num_walkers and target_num_walkers must be "
                    f"divisible by the mesh '{self.mesh_axis}' axis "
                    f"size ({n})")

    @property
    def num_shards(self) -> int:
        return 1 if self.mesh is None \
            else self.mesh.shape[self.mesh_axis]

    # -- derived -----------------------------------------------------------

    @property
    def cfc_params(self) -> mrbp.CFCParams:
        return self.model_spec.cfc_params

    @cached_property
    def core_funcs(self):
        return mrbp.core_funcs(self.model_spec)

    @property
    def sigma_spread(self) -> float:
        """Diffusion step width ``sqrt(2 dt)``
        (``mrbp_qmc/dmc.py:173-185``)."""
        return float(np.sqrt(2 * self.time_step))

    @property
    def density_bins_edges(self) -> np.ndarray:
        if self.density_est_spec is None:
            raise TypeError("the density spec has not been specified")
        num_bins = self.density_est_spec.num_bins
        return np.linspace(0, self.model_spec.supercell_size, num_bins + 1)

    @property
    def ssf_momenta(self) -> np.ndarray:
        if self.ssf_est_spec is None:
            raise TypeError(
                "no S(k) estimator spec was configured for this sampling")
        num_modes = self.ssf_est_spec.num_modes
        sc_size = self.model_spec.supercell_size
        return np.arange(num_modes) * 2 * np.pi / sc_size

    @property
    def obd_pos_offsets(self) -> np.ndarray:
        if self.obd_est_spec is None:
            raise TypeError(
                "the one-body density matrix spec has not been specified")
        sc_size = self.model_spec.supercell_size
        return np.linspace(0.0, 0.5 * sc_size, self.obd_est_spec.num_pos)

    @property
    def itc_momenta(self) -> np.ndarray:
        if self.itc_est_spec is None:
            raise TypeError("no imaginary-time-correlation spec was "
                            "configured for this sampling")
        num_modes = self.itc_est_spec.num_modes
        sc_size = self.model_spec.supercell_size
        return np.arange(num_modes) * 2 * np.pi / sc_size

    @property
    def itc_lag_times(self) -> np.ndarray:
        """The imaginary-time lags
        ``tau_l = l * est_every * est_every_mult * dt``,
        ``l = 0..num_lags`` (one leading equal-time entry)."""
        if self.itc_est_spec is None:
            raise TypeError("no imaginary-time-correlation spec was "
                            "configured for this sampling")
        lags = np.arange(self.itc_est_spec.num_lags + 1)
        return (lags * self.est_every
                * self.itc_est_spec.est_every_mult * self.time_step)

    @property
    def pair_corr_bin_edges(self) -> np.ndarray:
        if self.pair_corr_est_spec is None:
            raise TypeError(
                "the pair-correlation spec has not been specified")
        num_bins = self.pair_corr_est_spec.num_bins
        return np.linspace(0, 0.5 * self.model_spec.supercell_size,
                           num_bins + 1)

    @property
    def _itc_buf_shape(self) -> t.Tuple[int, ...]:
        spec = self.itc_est_spec
        return (self.max_num_walkers, spec.num_lags, spec.num_modes, 2)

    def _pfw_steps(self, spec) -> int:
        # The reference treats None as "effectively infinite"
        # (``mrbp_qmc/dmc.py:116-122``).
        return spec.pfw_num_time_steps if spec.pfw_num_time_steps \
            else 99999999

    def _pure_aux_shapes(self) -> t.Dict[str, t.Tuple[int, ...]]:
        """Shapes of the persistent pure-estimator accumulators (the
        forward-walking aux arrays that may span blocks), in GLOBAL
        (unsharded) walker coordinates — the mesh path shards them
        over the walker axis like the state buffers."""
        max_w = self.max_num_walkers
        shapes = {}
        if self.density_est_spec is not None \
                and self.density_est_spec.as_pure_est:
            shapes["aux_density"] = (max_w,
                                     self.density_est_spec.num_bins)
        if self.ssf_est_spec is not None \
                and self.ssf_est_spec.as_pure_est:
            shapes["aux_ssf"] = (max_w, self.ssf_est_spec.num_modes, 3)
        if self.obd_est_spec is not None \
                and self.obd_est_spec.as_pure_est:
            shapes["aux_obd"] = (max_w, self.obd_est_spec.num_pos)
        if self.pair_corr_est_spec is not None \
                and self.pair_corr_est_spec.as_pure_est:
            shapes["aux_g2"] = (max_w,
                                self.pair_corr_est_spec.num_bins)
        if self.itc_est_spec is not None \
                and self.itc_est_spec.as_pure_est:
            shapes["aux_itc"] = (max_w,
                                 self.itc_est_spec.num_lags + 1,
                                 self.itc_est_spec.num_modes)
            shapes["aux_itc_cnt"] = (max_w,
                                     self.itc_est_spec.num_lags + 1)
        return shapes

    def pfw_window_blocks(self, num_time_steps_block: int) -> int:
        """Forward-walking window length in blocks.

        1 (the reference's only behavior — per-block windows) unless a
        pure estimator's ``pfw_num_time_steps`` exceeds one block, in
        which case the accumulators persist across ``pfw / nts`` blocks
        (the window must then be a multiple of the block length)."""
        window = 1
        for spec in (self.density_est_spec, self.ssf_est_spec,
                     self.obd_est_spec, self.pair_corr_est_spec,
                     self.itc_est_spec):
            if spec is None or not spec.as_pure_est \
                    or not spec.pfw_num_time_steps:
                continue
            pfw = int(spec.pfw_num_time_steps)
            if pfw > num_time_steps_block \
                    and pfw % num_time_steps_block == 0:
                # Non-multiple values keep the historical per-block
                # window (the in-block freeze simply never triggers) —
                # the exec layer clamps such specs with a warning.
                # NOTE: estimators with shorter (or unset) pfw share
                # the LONGEST window: they freeze at their own pfw and
                # keep ancestry-transporting to the window end (extra
                # projection — valid forward walking), contributing
                # one sample per shared window.
                window = max(window, pfw // num_time_steps_block)
        return window

    # -- state construction ---------------------------------------------------

    def build_state(self, sys_conf_set: np.ndarray,
                    ref_energy: t.Optional[float] = None,
                    dtype=None) -> State:
        """Build the initial ensemble from a configuration set.

        Truncates to ``target_num_walkers`` configurations, computes
        their fused energy+drift, sets unit weights, and seeds ``E_ref``
        with the weighted ensemble energy
        (``mrbp_qmc/dmc.py:268-328``).
        """
        sys_conf_set = np.asarray(sys_conf_set)
        nop = self.model_spec.boson_number
        if sys_conf_set.ndim == 3 and sys_conf_set.shape[-2] == 2:
            pos_set = sys_conf_set[:, mrbp.SysConfSlot.pos, :]
        elif sys_conf_set.ndim == 2 and sys_conf_set.shape[-1] == nop:
            pos_set = sys_conf_set
        else:
            raise ValueError("sys_conf_set does not match the model's "
                             "configuration layout")

        # Only take as many items as target_num_walkers (the most
        # recent ones, reference ``mrbp_qmc/dmc.py:290``).
        pos_set = pos_set[-self.target_num_walkers:]
        num = pos_set.shape[0]
        max_w = self.max_num_walkers
        num_shards = self.num_shards
        if dtype is None:
            dtype = pos_set.dtype if np.issubdtype(
                pos_set.dtype, np.floating) else np.float64

        # Distribute walkers so the valid entries are a prefix of every
        # shard's slice of the buffer.
        shard_size = max_w // num_shards
        per_shard = -(-num // num_shards)  # ceil
        pos = np.zeros((max_w, nop), dtype=dtype)
        valid = np.zeros(max_w, dtype=bool)
        shard_counts = np.zeros(num_shards, dtype=np.int32)
        for s in range(num_shards):
            chunk = pos_set[s * per_shard:(s + 1) * per_shard]
            pos[s * shard_size:s * shard_size + len(chunk)] = chunk
            valid[s * shard_size:s * shard_size + len(chunk)] = True
            shard_counts[s] = len(chunk)

        pos = jnp.asarray(pos)
        cfc = self._cast_params(pos.dtype)
        # One jitted dispatch (eager evaluation would issue every op of
        # the O(N^2) kernel as its own executable — painful when
        # compilation is a remote service).
        energies, drift, weights, e_sum, w_sum = self._prepare_fn(
            pos, jnp.asarray(valid), cfc)

        state_energy = float(e_sum)
        state_weight = float(w_sum)
        energy_mean = state_energy / state_weight
        if ref_energy is None:
            ref_energy = energy_mean

        f = partial(jnp.asarray, dtype=pos.dtype)
        return State(
            pos=pos, drift=drift, energies=energies, weights=weights,
            masks=jnp.asarray(~valid),
            energy=f(state_energy), weight=f(state_weight),
            num_walkers=jnp.asarray(shard_counts, dtype=jnp.int32),
            ref_energy=f(ref_energy), accum_energy=f(energy_mean),
            total_energy=f(0.0), total_weight=f(0.0),
            cmd_accum=(jnp.zeros(pos.shape[0], dtype=pos.dtype)
                       if self.cm_diffusion_est else None),
            itc_buf=(jnp.zeros(self._itc_buf_shape, dtype=pos.dtype)
                     if self.itc_est_spec is not None else None),
            itc_filled=(jnp.int32(0)
                        if self.itc_est_spec is not None else None))

    def _cast_params(self, dtype) -> mrbp.CFCParams:
        return jax.tree.map(lambda x: jnp.asarray(x, dtype=dtype),
                            self.cfc_params)

    @cached_property
    def _prepare_fn(self):
        """Jitted ensemble preparation (``prepare_state_data``,
        reference ``qmc_base/jastrow/dmc.py:1029-1174``)."""
        funcs = self.core_funcs

        @jax.jit
        def prepare(pos, valid, cfc):
            energies, drift = funcs.energy_and_drift(pos, cfc)
            weights = valid.astype(pos.dtype)
            energies = jnp.where(valid, energies, 0.0)
            drift = jnp.where(valid[:, None], drift, 0.0)
            return (energies, drift, weights,
                    (energies * weights).sum(), weights.sum())

        return prepare

    @cached_property
    def _rebalance_fn(self):
        """Jitted walker rebalancing: pack the valid walkers and deal
        them round-robin across the shard slices, preserving the
        per-shard valid-prefix invariant the comb relies on.

        The map ``rank -> (rank % S) * shard_size + rank // S`` is a
        bijection on ``[0, max_w)``, so one fixed-shape permutation
        rebalances any population.  Runs on the global (unsharded-view)
        state between blocks; XLA inserts the cross-shard collectives.
        """
        num_shards = self.num_shards
        max_w = self.max_num_walkers
        shard_size = max_w // num_shards
        P = jax.sharding.PartitionSpec
        mesh = self.mesh
        ax = self.mesh_axis

        def _replicated(x):
            if mesh is None:
                return x
            return jax.sharding.reshard(
                x, jax.sharding.NamedSharding(mesh, P()))

        def _sharded(x):
            if mesh is None:
                return x
            return jax.sharding.reshard(
                x, jax.sharding.NamedSharding(
                    mesh, P(*([ax] + [None] * (x.ndim - 1)))))

        def rebalance(state: State) -> State:
            # Gather the ensemble to a replicated view (a few MB per
            # chip at production scale, every K blocks); the permuted
            # result is constrained back onto the walker sharding.
            # NOTE: with the imaginary-time-correlation estimator the
            # per-walker ring buffer dominates this transient
            # (Wm x lags x modes x 2 — ~71 MB replicated per chip at
            # the production-example config), still comfortably inside
            # HBM at rebalance cadence but worth sizing when choosing
            # num_lags x num_modes on memory-tight multi-chip runs.
            state = jax.tree.map(_replicated, state)
            slots = jnp.arange(max_w)
            shard_of = slots // shard_size
            row_of = slots % shard_size
            valid = row_of < state.num_walkers[shard_of]
            # Stable pack: valid walkers first, preserving order.
            order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)
            dest = (slots % num_shards) * shard_size \
                + slots // num_shards
            n_total = valid.sum()
            s_idx = jnp.arange(num_shards)
            counts = (n_total // num_shards
                      + (s_idx < n_total % num_shards)).astype(jnp.int32)
            new_valid = row_of < counts[shard_of]

            def permute(buf):
                return jnp.zeros_like(buf).at[dest].set(buf[order])

            weights = jnp.where(new_valid, permute(state.weights), 0.0)
            energies = jnp.where(new_valid, permute(state.energies), 0.0)
            drift = jnp.where(new_valid[:, None], permute(state.drift),
                              0.0)
            cmd_accum = None
            if state.cmd_accum is not None:
                cmd_accum = _sharded(jnp.where(
                    new_valid, permute(state.cmd_accum), 0.0))
            itc_buf = None
            if state.itc_buf is not None:
                itc_buf = _sharded(jnp.where(
                    new_valid[:, None, None, None],
                    permute(state.itc_buf), 0.0))
            return state._replace(
                pos=_sharded(permute(state.pos)),
                drift=_sharded(drift), energies=_sharded(energies),
                weights=_sharded(weights), masks=_sharded(~new_valid),
                num_walkers=_sharded(counts), cmd_accum=cmd_accum,
                itc_buf=itc_buf)

        return jax.jit(rebalance)

    def rebalance(self, state: State) -> State:
        """Redistribute the valid walkers evenly across the shards
        (see :attr:`rebalance_every`)."""
        if self.mesh is None:
            return self._rebalance_fn(state)
        with jax.set_mesh(self.mesh):
            return self._rebalance_fn(state)

    def adapt_state_shards(self, state: State) -> State:
        """Re-layout a State saved under a DIFFERENT shard count.

        A state checkpointed by a sharded run (or a meshed fused
        sweep) stores per-shard walker prefixes and a
        ``(num_shards,)`` count vector; resuming it under a sampling
        with a different shard count (e.g. a meshed-sweep row resumed
        standalone, or a single-device checkpoint resumed onto a
        mesh) would otherwise broadcast-mismatch in the comb.  The
        valid walkers compact in slot order and redistribute into
        THIS sampling's per-shard prefixes, carrying every per-walker
        buffer (positions, drift, energies, weights, the CM
        accumulator and the ITC ring buffer) — values preserved, not
        recomputed, so the physics continues from the saved ensemble
        exactly (the RNG stream is per-shard, so trajectories after
        the re-layout are statistically, not bit-, identical to the
        uninterrupted run's).  No-op when the layouts already match.
        """
        src_counts = np.asarray(state.num_walkers,
                                dtype=np.int64).ravel()
        if src_counts.size == self.num_shards:
            return state
        max_w = state.max_num_walkers
        if max_w != self.max_num_walkers or \
                max_w % src_counts.size or max_w % self.num_shards:
            raise ValueError(
                f"cannot re-layout a {src_counts.size}-shard state of "
                f"{max_w} slots onto {self.num_shards} shards of "
                f"{self.max_num_walkers}")
        src_size = max_w // src_counts.size
        valid_idx = np.concatenate(
            [np.arange(s * src_size, s * src_size + c)
             for s, c in enumerate(src_counts)]).astype(np.int64)
        num = valid_idx.size
        num_shards = self.num_shards
        shard_size = max_w // num_shards
        per_shard = -(-num // num_shards)  # ceil, like build_state
        dest_idx = []
        counts = np.zeros(num_shards, dtype=np.int32)
        taken = 0
        for s in range(num_shards):
            chunk = min(per_shard, num - taken, shard_size)
            dest_idx.append(np.arange(s * shard_size,
                                      s * shard_size + chunk))
            counts[s] = chunk
            taken += chunk
        dest_idx = np.concatenate(dest_idx).astype(np.int64)
        valid_idx = valid_idx[:dest_idx.size]

        def relayout(buf):
            if buf is None:
                return None
            arr = np.asarray(buf)
            out = np.zeros_like(arr)
            out[dest_idx] = arr[valid_idx]
            return jnp.asarray(out)

        masks = np.ones(max_w, dtype=bool)
        masks[dest_idx] = False
        return state._replace(
            pos=relayout(state.pos), drift=relayout(state.drift),
            energies=relayout(state.energies),
            weights=relayout(state.weights),
            masks=jnp.asarray(masks),
            num_walkers=jnp.asarray(counts, dtype=jnp.int32),
            cmd_accum=relayout(state.cmd_accum),
            itc_buf=relayout(state.itc_buf))

    # -- the compiled step/block kernels ------------------------------------

    def make_step_fn(self, axis_name: t.Optional[str] = None,
                     measure: bool = True, transport_only: bool = False,
                     injected_noise: bool = False):
        """Build the single-time-step transition function.

        Returns ``step(state, key, scalars) -> (state', outputs)`` where
        ``scalars`` is a dict of traced runtime parameters.  With
        ``axis_name`` set, ensemble reductions become ``psum`` over that
        mesh axis (per-shard comb, global population control).  With
        ``transport_only`` (the non-measured steps of an
        ``est_every > 1`` cadence), pure-estimator accumulators are
        still gathered through the branching parents — ancestry
        transport must happen every step — but no estimator values are
        computed or emitted.  With ``injected_noise``, the ``key``
        argument is instead a dict ``{"comb_u": (Wm,) uniforms,
        "xi": (Wm, N) pre-scaled diffusion noise}`` — the
        bit-comparable replay mode (:meth:`replay_states`).
        """
        funcs = self.core_funcs
        density_spec = self.density_est_spec if measure else None
        ssf_spec = self.ssf_est_spec if measure else None
        obd_spec = self.obd_est_spec if measure else None
        g2_spec = self.pair_corr_est_spec if measure else None
        itc_spec = self.itc_est_spec if measure else None
        cadence = self.est_every
        use_density = density_spec is not None
        use_ssf = ssf_spec is not None
        use_obd = obd_spec is not None
        use_g2 = g2_spec is not None
        use_itc = itc_spec is not None
        density_pure = use_density and density_spec.as_pure_est
        ssf_pure = use_ssf and ssf_spec.as_pure_est
        obd_pure = use_obd and obd_spec.as_pure_est
        g2_pure = use_g2 and g2_spec.as_pure_est
        itc_pure = use_itc and itc_spec.as_pure_est
        obd_offsets = np.asarray(self.obd_pos_offsets) if use_obd else None
        use_cmd = self.cm_diffusion_est

        def _psum(x):
            return jax.lax.psum(x, axis_name) if axis_name else x

        def step(state: State, extra: dict, key, step_idx, scalars, cfc):
            dt = scalars["time_step"]
            sigma = scalars["sigma_spread"]
            nwc = scalars["nwc_factor"]
            target = scalars["target_num_walkers"]

            max_w = state.pos.shape[0]
            slots = jnp.arange(max_w)

            # 1) Branching comb on the previous step's weights.
            if injected_noise:
                k_diff = None
                parent, nw = branching_comb(state.weights,
                                            state.num_walkers,
                                            u=key["comb_u"])
            else:
                k_comb, k_diff = jax.random.split(key)
                parent, nw = branching_comb(state.weights,
                                            state.num_walkers, k_comb)
            valid = slots < nw

            # 2) Children: cloned (pre-diffusion) parents with parent
            #    energies and unit weights (jastrow/dmc.py:933-941).
            cpos = state.pos[parent]
            cdrift = state.drift[parent]
            cenergy = state.energies[parent]

            state_energy = _psum(jnp.where(valid, cenergy, 0.0).sum())
            state_weight = _psum(nw.astype(state.pos.dtype))

            # 3) Population-control update (qmc_base/dmc.py:764-771).
            total_energy = state.total_energy + state_energy
            total_weight = state.total_weight + state_weight
            accum_energy = total_energy / total_weight
            new_ref = accum_energy - nwc * jnp.log(
                jnp.maximum(state_weight, 1.0) / target) / dt

            # 4) Estimators on the post-branching ensemble.  Outputs are
            #    SHARD-LOCAL sums; the per-block runner reduces them over
            #    the mesh once per block (per-step collectives would pay
            #    nts times more collective latency; cf. SURVEY §5.8).
            est_out = {}
            new_extra = {}
            # Pure-estimator ancestry transport under a measurement
            # cadence ALSO rides a composed parent permutation (see
            # the ITC note below): transport-only steps compose the
            # (Wm,) int32 index instead of moving every aux array, and
            # the measured step applies ONE gather per aux through the
            # composition — bit-identical, ~cadence-fold less aux HBM
            # traffic.  The permutation resets at every measured step
            # (each block ends on one), so nothing crosses blocks.
            anc_perm = extra["anc_perm"][parent] \
                if "anc_perm" in extra else parent
            if transport_only:
                for name in ("aux_density", "aux_ssf", "aux_obd",
                             "aux_g2", "aux_itc", "aux_itc_cnt"):
                    if name in extra:
                        new_extra[name] = extra[name]
                if "anc_perm" in extra:
                    new_extra["anc_perm"] = anc_perm
            if use_itc:
                # The ITC ring buffer's transport composes the integer
                # parent permutation instead of gathering the whole
                # (Wm, lags, modes, 2) buffer every step — gathers
                # compose exactly (buf[p1][p2] == buf[p1[p2]]), so one
                # buffer gather per ITC-MEASURED step reproduces the
                # per-step transport bit-for-bit at ~1/(cadence*mult)
                # of the HBM traffic.  The permutation resets to the
                # identity at every measurement, and the block-length
                # divisibility checks guarantee each block ENDS on a
                # measured step, so nothing carries across blocks.
                itc_perm = extra["itc_perm"][parent]
                if transport_only:
                    new_extra["itc_perm"] = itc_perm
            if use_density and not transport_only:
                num_bins = density_spec.num_bins
                bin_size = (cfc.model_params.supercell_size / num_bins)
                # Factorized one-hot histogram (ops/histogram.py): a
                # batched matmul instead of a scatter-add or the full
                # (W, N, B) one-hot broadcast, with bit-identical
                # integer counts.
                hist = hist_ops.walker_histogram(cpos, bin_size,
                                                 num_bins)
                hist = jnp.where(valid[:, None], hist, 0.0)
                if density_pure:
                    pfw = self._pfw_steps(density_spec)
                    aux_prev = extra["aux_density"][anc_perm]
                    aux = jnp.where(step_idx < pfw, aux_prev + hist,
                                    aux_prev)
                    divisor = jnp.minimum(
                        (step_idx + 1) // cadence,
                        pfw // cadence).astype(cpos.dtype)
                    est_out["density"] = jnp.where(
                        valid[:, None], aux, 0.0).sum(axis=0) / divisor
                    new_extra["aux_density"] = aux
                else:
                    est_out["density"] = jnp.where(
                        valid[:, None], hist, 0.0).sum(axis=0)
            ssf_parts = None
            if use_ssf and not transport_only:
                parts = funcs.fourier_density_parts_harmonics(
                    ssf_spec.num_modes, cpos, cfc)
                ssf_parts = parts
                if ssf_pure:
                    pfw = self._pfw_steps(ssf_spec)
                    aux_prev = extra["aux_ssf"][anc_perm]
                    aux = jnp.where(step_idx < pfw, aux_prev + parts,
                                    aux_prev)
                    divisor = jnp.minimum(
                        (step_idx + 1) // cadence,
                        pfw // cadence).astype(cpos.dtype)
                    est_out["ssf"] = jnp.where(
                        valid[:, None, None], aux, 0.0).sum(axis=0) \
                        / divisor
                    new_extra["aux_ssf"] = aux
                else:
                    est_out["ssf"] = jnp.where(
                        valid[:, None, None], parts, 0.0).sum(axis=0)
            if use_obd and not transport_only:
                offsets = jnp.asarray(obd_offsets, dtype=cpos.dtype)
                # OBDM-specific cadence: the grid is evaluated only on
                # every ``est_every_mult``-th measured step (the grid
                # costs ``num_pos`` shifted pair passes, dwarfing the
                # rest of the step); ``lax.cond`` skips the compute
                # entirely on the other steps — ancestry transport of
                # the pure accumulator still advances here.
                obd_mult = obd_spec.est_every_mult
                cad_obd = cadence * obd_mult
                obd_now = (step_idx + 1) % cad_obd == 0
                if obd_pure:
                    pfw = self._pfw_steps(obd_spec)
                    aux_prev = extra["aux_obd"][anc_perm]
                    divisor = jnp.minimum(
                        (step_idx + 1) // cad_obd,
                        pfw // cad_obd).astype(cpos.dtype)

                    def _obd_measure(aux_p):
                        parts = funcs.one_body_density_grid(
                            offsets, cpos, cfc)
                        aux = jnp.where(step_idx < pfw, aux_p + parts,
                                        aux_p)
                        est = jnp.where(valid[:, None], aux,
                                        0.0).sum(axis=0) / divisor
                        return aux, est

                    if obd_mult == 1:
                        aux, est = _obd_measure(aux_prev)
                    else:
                        # The skip-branch zeros derive from a varying
                        # operand (0 * aux row) so both cond branches
                        # carry the same shard_map vartype.
                        aux, est = jax.lax.cond(
                            obd_now, _obd_measure,
                            lambda aux_p: (aux_p, 0.0 * aux_p[0]),
                            aux_prev)
                    est_out["obd"] = est
                    new_extra["aux_obd"] = aux
                else:
                    def _obd_mixed(_):
                        parts = funcs.one_body_density_grid(
                            offsets, cpos, cfc)
                        return jnp.where(valid[:, None], parts,
                                         0.0).sum(axis=0)

                    if obd_mult == 1:
                        est_out["obd"] = _obd_mixed(None)
                    else:
                        est_out["obd"] = jax.lax.cond(
                            obd_now, _obd_mixed,
                            lambda _: jnp.zeros((obd_spec.num_pos,),
                                                cpos.dtype)
                            + 0.0 * cpos[0, 0], None)

            if use_g2 and not transport_only:
                # Direct pair-correlation histogram with its own
                # (sparser) cadence, mirroring the OBDM pattern: the
                # O(N^2) binning pass runs only on every
                # ``est_every_mult``-th measured step via ``lax.cond``;
                # pure-estimator ancestry transport still advances.
                g2_mult = g2_spec.est_every_mult
                cad_g2 = cadence * g2_mult
                g2_now = (step_idx + 1) % cad_g2 == 0
                num_bins_g2 = g2_spec.num_bins
                if g2_pure:
                    pfw = self._pfw_steps(g2_spec)
                    aux_prev = extra["aux_g2"][anc_perm]
                    divisor = jnp.minimum(
                        (step_idx + 1) // cad_g2,
                        pfw // cad_g2).astype(cpos.dtype)

                    def _g2_measure(aux_p):
                        hist = funcs.pair_dist_histogram(
                            num_bins_g2, cpos, cfc)
                        aux = jnp.where(step_idx < pfw, aux_p + hist,
                                        aux_p)
                        est = jnp.where(valid[:, None], aux,
                                        0.0).sum(axis=0) / divisor
                        return aux, est

                    if g2_mult == 1:
                        aux, est = _g2_measure(aux_prev)
                    else:
                        aux, est = jax.lax.cond(
                            g2_now, _g2_measure,
                            lambda aux_p: (aux_p, 0.0 * aux_p[0]),
                            aux_prev)
                    est_out["g2"] = est
                    new_extra["aux_g2"] = aux
                else:
                    def _g2_mixed(_):
                        hist = funcs.pair_dist_histogram(
                            num_bins_g2, cpos, cfc)
                        return jnp.where(valid[:, None], hist,
                                         0.0).sum(axis=0)

                    if g2_mult == 1:
                        est_out["g2"] = _g2_mixed(None)
                    else:
                        est_out["g2"] = jax.lax.cond(
                            g2_now, _g2_mixed,
                            lambda _: jnp.zeros((num_bins_g2,),
                                                cpos.dtype)
                            + 0.0 * cpos[0, 0], None)

            if "anc_perm" in extra and not transport_only:
                # Measured step: the aux gathers above consumed the
                # composition; reset to the identity (derived from the
                # varying perm so the scan carry vartype is stable).
                new_extra["anc_perm"] = jnp.arange(
                    anc_perm.shape[0], dtype=anc_perm.dtype) \
                    + 0 * anc_perm

            # 4b) Imaginary-time correlation: the lag ring buffer rides
            #     the State, so it transports through the cloning table
            #     EVERY step (measured or not — it holds real data
            #     between measurements, unlike the window-scoped aux
            #     accumulators above); measured steps correlate the
            #     current rho_k against every lag row, then shift the
            #     new amplitudes in.  Burn-in blocks skip even the
            #     transport: the buffer is still its zero fill there
            #     (``itc_filled == 0``), so the gather would be a
            #     semantic no-op.
            new_itc_buf = state.itc_buf
            new_itc_filled = state.itc_filled
            if use_itc and not transport_only:
                    num_lags = itc_spec.num_lags
                    itc_mult = itc_spec.est_every_mult
                    # Own (sparser) cadence, OBDM-style: measuring and
                    # shifting only every mult-th measured step makes
                    # the lag unit ``est_every * mult * dt`` — deep
                    # tau at fixed buffer size and per-step transport.
                    itc_now = (step_idx + 1) % (cadence * itc_mult) == 0

                    cad_itc = cadence * itc_mult
                    if itc_pure:
                        pfw_itc = self._pfw_steps(itc_spec)
                        itc_divisor = jnp.minimum(
                            (step_idx + 1) // cad_itc,
                            pfw_itc // cad_itc).astype(cpos.dtype)

                    def _itc_measure(ops):
                        buf, filled, perm, aux_p, aux_cnt_p = ops
                        # ONE buffer gather through the composed
                        # parent permutation — bit-identical to the
                        # per-step gathers it replaces.
                        buf = buf[perm]
                        # (Wm, num_modes, 2) amplitudes of the
                        # post-branching ensemble.  When the ssf
                        # estimator already ran the Chebyshev-
                        # harmonics pass this step, slice ITS per-
                        # walker (re, im) slots instead of recomputing
                        # the whole (Wm, N) recurrence — the values
                        # are the same array, so lag 0 matching the
                        # ssf slot-0 sums holds by construction.
                        if ssf_parts is not None and \
                                ssf_spec.num_modes >= itc_spec.num_modes:
                            reim = ssf_parts[:, :itc_spec.num_modes,
                                             1:3]
                        else:
                            reim = funcs.fourier_density_reim_harmonics(
                                itc_spec.num_modes, cpos, cfc)
                        maskf = valid.astype(cpos.dtype)
                        # Same per-walker square + masked walker sum
                        # as the ssf estimator's slot 0, so the two
                        # are bit-identical when both are enabled.
                        sq = reim[..., 0] ** 2 + reim[..., 1] ** 2
                        nwf = nw.astype(cpos.dtype)
                        lag_ok = (jnp.arange(1, num_lags + 1)
                                  <= filled).astype(cpos.dtype)
                        if itc_pure:
                            # Forward walking: the per-walker lag
                            # products accumulate into an ancestry-
                            # transported aux (gathered through the
                            # SAME composed permutation as the ring
                            # buffer), alongside per-lag contribution
                            # counts; sampling divides by the number
                            # of contributions, exactly the pure-
                            # density discipline.
                            prod_w = itc_walker_lag_products(
                                buf, reim) * maskf[:, None, None]
                            sq_w = jnp.where(valid[:, None], sq, 0.0)
                            contrib = jnp.concatenate(
                                [sq_w[:, None], prod_w], axis=1)
                            cnt_row = jnp.concatenate(
                                [jnp.ones((1,), cpos.dtype), lag_ok])
                            aux = aux_p[perm]
                            aux_cnt = aux_cnt_p[perm]
                            grow = step_idx < pfw_itc
                            aux = jnp.where(grow, aux + contrib, aux)
                            aux_cnt = jnp.where(
                                grow, aux_cnt + maskf[:, None]
                                * cnt_row[None], aux_cnt)
                            sums = jnp.where(
                                valid[:, None, None], aux,
                                0.0).sum(axis=0) / itc_divisor
                            counts = jnp.where(
                                valid[:, None], aux_cnt,
                                0.0).sum(axis=0) / itc_divisor
                        else:
                            aux, aux_cnt = aux_p, aux_cnt_p
                            lag0 = jnp.where(valid[:, None], sq,
                                             0.0).sum(axis=0)
                            lag_prod = itc_lag_products(buf, reim,
                                                        maskf)
                            sums = jnp.concatenate(
                                [lag0[None], lag_prod], axis=0)
                            counts = jnp.concatenate([nwf[None],
                                                      nwf * lag_ok])
                        buf = jnp.concatenate(
                            [reim[:, None], buf[:, :-1]], axis=1)
                        filled = jnp.minimum(filled + 1,
                                             jnp.int32(num_lags))
                        # Reset to the identity (derived from the
                        # varying perm so both cond branches carry the
                        # same shard_map vartype).
                        iota = jnp.arange(perm.shape[0],
                                          dtype=perm.dtype) + 0 * perm
                        return buf, filled, sums, counts, iota, \
                            aux, aux_cnt

                    if itc_pure:
                        aux_ops = (extra["aux_itc"],
                                   extra["aux_itc_cnt"])
                    else:
                        # Placeholder scalars keep the cond operand
                        # tree uniform when the aux arrays are off
                        # (derived from a varying operand so the
                        # shard_map vartypes line up).
                        aux_ops = (0.0 * cpos[0, 0], 0.0 * cpos[0, 0])
                    ops = (new_itc_buf, state.itc_filled, itc_perm,
                           *aux_ops)
                    if itc_mult == 1:
                        # This (measuring) step function only runs on
                        # cadence-measured steps, so with mult == 1
                        # every invocation measures — no cond needed.
                        (new_itc_buf, new_itc_filled, est_out["itc"],
                         est_out["itc_nw"], new_extra["itc_perm"],
                         new_aux_itc, new_aux_itc_cnt) \
                            = _itc_measure(ops)
                    else:
                        # Skip-branch zeros derive from a varying
                        # operand so both cond branches carry the same
                        # shard_map vartype (cf. the OBDM cond).
                        def _itc_skip(ops):
                            buf, filled, perm, aux_p, aux_cnt_p = ops
                            zero = 0.0 * buf[0, 0, 0, 0]
                            return (buf, filled,
                                    jnp.zeros((num_lags + 1,
                                               itc_spec.num_modes),
                                              cpos.dtype) + zero,
                                    jnp.zeros((num_lags + 1,),
                                              cpos.dtype) + zero,
                                    perm, aux_p, aux_cnt_p)

                        (new_itc_buf, new_itc_filled, est_out["itc"],
                         est_out["itc_nw"], new_extra["itc_perm"],
                         new_aux_itc, new_aux_itc_cnt) = jax.lax.cond(
                            itc_now, _itc_measure, _itc_skip, ops)
                    if itc_pure:
                        new_extra["aux_itc"] = new_aux_itc
                        new_extra["aux_itc_cnt"] = new_aux_itc_cnt

            # 5) Diffuse children with the PREVIOUS E_ref
            #    (jastrow/dmc.py:742-827).
            if injected_noise:
                xi = key["xi"]
            else:
                xi = sigma * jax.random.normal(k_diff, cpos.shape,
                                               dtype=cpos.dtype)
            npos = mrbp.recast(cpos + 2.0 * cdrift * dt + xi, cfc)
            aux_cmd = state.cmd_accum
            if use_cmd:
                # Accumulate each walker's CM displacement (pre-recast,
                # so windings count) through the ancestry — every step,
                # including non-measured cadence steps and burn-in (the
                # accumulator rides the State so measurement windows
                # can span blocks; ``blocks()`` zeroes it at window
                # boundaries).
                cm_disp = (2.0 * cdrift * dt + xi).mean(axis=-1)
                aux_cmd = aux_cmd[parent] + cm_disp
                if measure and not transport_only:
                    est_out["cmd"] = jnp.stack([
                        _psum(jnp.where(valid, aux_cmd ** 2, 0.0).sum()),
                        _psum(jnp.where(valid, aux_cmd, 0.0).sum())])
            nenergy, ndrift = funcs.energy_and_drift(npos, cfc)
            if self.ref_compat:
                # Reference-exact branching weight: E_prev is the energy
                # the SLOT held on the previous step, not the parent's —
                # the reference's ``evolve_system`` reads
                # ``actual_state_energies[sys_idx]`` before the cloning
                # write updates it (``jastrow/dmc.py:846-847`` vs
                # ``:941``).  Both are valid O(dt) discretizations; the
                # default uses the parent energy.  See
                # ``reference_replay`` module docs.
                e_prev = extra["ref_eprev"]
                # Only live slots are written (the reference's masked
                # tail keeps whatever the slot held before —
                # ``jastrow/dmc.py:903-906`` writes nothing there), so
                # a slot that goes dead and later revives sees its
                # stale energy, exactly like the reference buffer.
                new_extra["ref_eprev"] = jnp.where(valid, cenergy,
                                                   e_prev)
            else:
                e_prev = cenergy
            nweight = jnp.exp(
                -dt * (0.5 * (nenergy + e_prev) - state.ref_energy))
            nweight = jnp.where(valid, nweight, 0.0)

            new_state = State(
                pos=npos, drift=ndrift, energies=nenergy, weights=nweight,
                masks=~valid,
                energy=state_energy, weight=state_weight,
                num_walkers=jnp.reshape(nw, state.num_walkers.shape)
                .astype(jnp.int32),
                ref_energy=new_ref, accum_energy=accum_energy,
                total_energy=total_energy, total_weight=total_weight,
                cmd_accum=aux_cmd, itc_buf=new_itc_buf,
                itc_filled=new_itc_filled)
            props = (state_energy, state_weight,
                     _psum(nw.astype(jnp.int32)), new_ref, accum_energy)
            return new_state, new_extra, props, est_out

        return step

    def make_run_block(self, measure: bool,
                       axis_name: t.Optional[str] = None,
                       extra_varying_axes: t.Tuple[str, ...] = ()):
        """The raw (unjitted, per-shard) block body: scan
        ``num_time_steps_block`` steps and reduce estimator sums over
        ``axis_name`` once per block.  Used by :meth:`_make_block_fn`
        (wrapped in jit / shard_map over this sampling's own mesh) and
        by :class:`~phd_qmclib_tpu.parallel.sweep.ParamSweep` (wrapped
        in a 2-D sweep x walkers shard_map)."""
        step = self.make_step_fn(axis_name=axis_name, measure=measure)
        density_spec = self.density_est_spec if measure else None
        ssf_spec = self.ssf_est_spec if measure else None
        obd_spec = self.obd_est_spec if measure else None
        g2_spec = self.pair_corr_est_spec if measure else None
        itc_spec = self.itc_est_spec if measure else None
        cadence = self.est_every if measure else 1
        step_transport = self.make_step_fn(
            axis_name=axis_name, measure=measure,
            transport_only=True) if cadence > 1 else None

        def run_block(state: State, block_key, scalars, cfc,
                      num_time_steps_block: int, aux_in=None,
                      step_offset=None):
            """``aux_in``/``step_offset`` carry the pure-estimator
            forward-walking window across blocks: the accumulators
            enter from the previous block (zeros at a window start)
            and the step indices continue from ``step_offset`` so the
            freeze/divisor logic sees the GLOBAL position within the
            window.  ``None`` = the reference's per-block windows."""
            for mspec, mname in ((obd_spec, "obd"), (g2_spec, "g2"),
                                 (itc_spec, "itc")):
                if mspec is not None and mspec.est_every_mult > 1 \
                        and num_time_steps_block % (
                            cadence * mspec.est_every_mult):
                    raise ValueError(
                        "num_time_steps_block must be divisible by "
                        f"est_every * {mname} est_every_mult")
            if axis_name is not None:
                # Decorrelate the per-shard random streams.
                block_key = jax.random.fold_in(
                    block_key, jax.lax.axis_index(axis_name))
            max_w = state.pos.shape[0]
            dtype = state.pos.dtype
            if aux_in is not None:
                extra0 = dict(aux_in)
            else:
                extra0 = {}
                if density_spec is not None \
                        and density_spec.as_pure_est:
                    extra0["aux_density"] = jnp.zeros(
                        (max_w, density_spec.num_bins), dtype=dtype)
                if ssf_spec is not None and ssf_spec.as_pure_est:
                    extra0["aux_ssf"] = jnp.zeros(
                        (max_w, ssf_spec.num_modes, 3), dtype=dtype)
                if obd_spec is not None and obd_spec.as_pure_est:
                    extra0["aux_obd"] = jnp.zeros(
                        (max_w, obd_spec.num_pos), dtype=dtype)
                if g2_spec is not None and g2_spec.as_pure_est:
                    extra0["aux_g2"] = jnp.zeros(
                        (max_w, g2_spec.num_bins), dtype=dtype)
                if itc_spec is not None and itc_spec.as_pure_est:
                    extra0["aux_itc"] = jnp.zeros(
                        (max_w, itc_spec.num_lags + 1,
                         itc_spec.num_modes), dtype=dtype)
                    extra0["aux_itc_cnt"] = jnp.zeros(
                        (max_w, itc_spec.num_lags + 1), dtype=dtype)
            aux_keys = tuple(extra0)
            varying = tuple(a for a in (axis_name, *extra_varying_axes)
                            if a is not None)
            if varying and extra0 and aux_in is None:
                # Locally-built zeros are replicated constants; mark
                # them varying over the mesh axes so the scan carry
                # types line up (the sweep wrapper adds its row axis
                # via ``extra_varying_axes``).  Accumulators passed in
                # through shard_map (aux_in) — and ``ref_eprev`` below,
                # a slice of the sharded state — are varying already
                # and must NOT be re-cast.
                extra0 = jax.tree.map(
                    lambda x: jax.lax.pcast(x, varying, to="varying"),
                    extra0)
            if self.ref_compat:
                # Slot-wise previous-step energies.  NOTE: at a block
                # boundary this re-seeds from the post-diffusion
                # energies (the slot history is exact within a block;
                # :meth:`replay_states` runs one uninterrupted scan and
                # is exact everywhere).
                extra0["ref_eprev"] = state.energies
            def _identity_perm():
                perm0 = jnp.arange(max_w, dtype=jnp.int32)
                if varying:
                    perm0 = jax.lax.pcast(perm0, varying, to="varying")
                return perm0

            if itc_spec is not None:
                # Composed-parent permutation for the ITC ring-buffer
                # transport (see the step fn): identity at every block
                # start — each block is guaranteed to END on an
                # ITC-measured step by the divisibility checks above,
                # so the permutation never carries across blocks.
                extra0["itc_perm"] = _identity_perm()
            if cadence > 1 and aux_keys:
                # Same composition for the pure-estimator aux arrays,
                # reset at every measured step (blocks end on one).
                extra0["anc_perm"] = _identity_perm()

            keys = jax.random.split(block_key, num_time_steps_block)
            steps = jnp.arange(num_time_steps_block)
            if step_offset is not None:
                steps = steps + step_offset

            if cadence == 1:
                def body(carry, inputs):
                    st, extra = carry
                    key, step_idx = inputs
                    new_state, new_extra, props, est = step(
                        st, extra, key, step_idx, scalars, cfc)
                    return (new_state, new_extra), (props, est)

                (final_state, final_extra), (props, est) = jax.lax.scan(
                    body, (state, extra0), (keys, steps))
            else:
                # Measurement cadence: chunks of ``cadence`` steps where
                # only the LAST step evaluates estimators; the others
                # advance the dynamics (and transport the pure
                # accumulators through the cloning table) without
                # computing estimator values.  Same key/step stream as
                # cadence 1, so the walker trajectories are identical.
                if num_time_steps_block % cadence:
                    raise ValueError(
                        "num_time_steps_block must be divisible by "
                        "est_every")
                num_chunks = num_time_steps_block // cadence
                ckeys = keys.reshape((num_chunks, cadence)
                                     + keys.shape[1:])
                csteps = steps.reshape(num_chunks, cadence)

                def plain_body(carry, inputs):
                    st, extra = carry
                    key, step_idx = inputs
                    new_state, new_extra, props, _ = step_transport(
                        st, extra, key, step_idx, scalars, cfc)
                    return (new_state, new_extra), props

                def chunk_body(carry, inputs):
                    keys_c, steps_c = inputs
                    carry, props_plain = jax.lax.scan(
                        plain_body, carry, (keys_c[:-1], steps_c[:-1]))
                    st, extra = carry
                    new_state, new_extra, props_last, est = step(
                        st, extra, keys_c[-1], steps_c[-1], scalars, cfc)
                    props = jax.tree.map(
                        lambda a, b: jnp.concatenate([a, b[None]]),
                        props_plain, props_last)
                    return (new_state, new_extra), (props, est)

                (final_state, final_extra), (props, est) = jax.lax.scan(
                    chunk_body, (state, extra0), (ckeys, csteps))
                # (chunks, cadence, ...) -> (nts, ...) per-step props.
                props = jax.tree.map(
                    lambda x: x.reshape((num_time_steps_block,)
                                        + x.shape[2:]), props)
            if "obd" in est and obd_spec.est_every_mult > 1:
                # Keep only the steps where the grid was actually
                # evaluated (one entry per OBDM-measured step; the
                # in-between cond branches emitted zeros).  Before the
                # psum: less collective volume.
                m = obd_spec.est_every_mult
                est["obd"] = est["obd"][m - 1::m]
            if "g2" in est and g2_spec.est_every_mult > 1:
                m = g2_spec.est_every_mult
                est["g2"] = est["g2"][m - 1::m]
            if "itc" in est and itc_spec.est_every_mult > 1:
                m = itc_spec.est_every_mult
                est["itc"] = est["itc"][m - 1::m]
                est["itc_nw"] = est["itc_nw"][m - 1::m]
            if axis_name is not None and est:
                # Shard-local estimator sums reduce over the mesh ONCE
                # per block (nts-fold less collective latency than
                # per-step).
                est = jax.tree.map(
                    lambda x: jax.lax.psum(x, axis_name), est)
            props_data = PropsData(*props)
            aux_out = {k: final_extra[k] for k in aux_keys}
            return final_state, aux_out, props_data, est

        return run_block

    def _make_block_fn(self, measure: bool):
        axis_name = self.mesh_axis if self.mesh is not None else None
        run_block = self.make_run_block(measure, axis_name=axis_name)

        if self.mesh is None:
            return jax.jit(run_block,
                           static_argnames=("num_time_steps_block",))

        # Multi-device: walker axis sharded over the mesh; ensemble
        # reductions are psums inside the step.
        P = jax.sharding.PartitionSpec
        ax = self.mesh_axis
        state_spec = State(
            pos=P(ax), drift=P(ax), energies=P(ax), weights=P(ax),
            masks=P(ax), energy=P(), weight=P(), num_walkers=P(ax),
            ref_energy=P(), accum_energy=P(), total_energy=P(),
            total_weight=P(),
            cmd_accum=P(ax) if self.cm_diffusion_est else None,
            itc_buf=P(ax) if self.itc_est_spec is not None else None,
            itc_filled=P() if self.itc_est_spec is not None else None)
        aux_spec = {name: P(ax)
                    for name in (self._pure_aux_shapes() if measure
                                 else {})}

        def sharded_block(state, block_key, scalars, cfc,
                          num_time_steps_block: int, aux_in=None,
                          step_offset=None):
            if aux_in is None:
                aux_in = {name: jnp.zeros(shape, dtype=state.pos.dtype)
                          for name, shape
                          in (self._pure_aux_shapes() if measure
                              else {}).items()}
            if step_offset is None:
                step_offset = jnp.int32(0)
            fn = jax.shard_map(
                lambda st, aux, k, off, sc, cf: run_block(
                    st, k, sc, cf, num_time_steps_block,
                    aux_in=aux, step_offset=off),
                mesh=self.mesh,
                in_specs=(state_spec, aux_spec, P(), P(), P(), P()),
                out_specs=(state_spec, aux_spec, P(), P()))
            return fn(state, aux_in, block_key, step_offset, scalars,
                      cfc)

        return jax.jit(sharded_block,
                       static_argnames=("num_time_steps_block",))

    @cached_property
    def _block_fn_measure(self):
        return _shared_block_fn(self, True)

    @cached_property
    def _block_fn_burn(self):
        return _shared_block_fn(self, False)

    def _scalars(self, dtype) -> dict:
        f = partial(jnp.asarray, dtype=dtype)
        return {
            "time_step": f(self.time_step),
            "sigma_spread": f(self.sigma_spread),
            "nwc_factor": f(self.num_walkers_control_factor),
            "target_num_walkers": f(self.target_num_walkers),
        }

    # -- public sampling APIs -------------------------------------------------

    def blocks(self, ini_state: State, num_time_steps_block: int,
               burn_in_blocks: int = 0,
               block_offset: int = 0,
               start_block_idx: int = 0,
               aux_init: t.Optional[dict] = None,
               rebalance_pending0: bool = False) \
            -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        The first ``burn_in_blocks`` blocks skip estimator evaluation
        (reference ``qmc_base/dmc.py:914-940``).

        Block keys derive from ``(rng_seed, block_offset + block_idx)``.
        A continuation run restarted from a saved state keeps the same
        seed but passes the number of blocks the original run already
        consumed as ``block_offset``, so its random stream picks up
        where the original left off instead of replaying it (the
        execution layer plumbs this automatically; see
        ``qmc_exec.dmc.Proc.block_offset``).

        Full-state resume (mid-run checkpoints): ``start_block_idx``
        starts the internal block counter at an arbitrary position so
        ALL phase arithmetic (random stream, pfw window position,
        CM-diffusion window cadence, rebalance cadence) continues
        exactly as if the generator had run from block 0;
        ``aux_init`` seeds the pure-estimator forward-walking
        accumulators when resuming inside a multi-block window, and
        ``rebalance_pending0`` re-arms a cadence rebalance that was
        deferred to a window boundary when the checkpoint was cut.
        """
        base_key = jax.random.PRNGKey(self.rng_seed)
        state = ini_state
        dtype = ini_state.pos.dtype
        if np.asarray(state.num_walkers).size != self.num_shards:
            # A state saved under a different shard layout (meshed
            # fused-sweep row resumed standalone, single-device
            # checkpoint resumed onto a mesh): redistribute the valid
            # walkers into this sampling's per-shard prefixes.
            state = self.adapt_state_shards(state)
        if self.cm_diffusion_est and state.cmd_accum is None:
            # A state built/loaded without the CM accumulator (e.g. a
            # checkpoint of a plain run restored into a cm_diffusion
            # sampling, or a loaded HDF5 state): open a fresh
            # measurement window.
            state = state._replace(cmd_accum=jnp.zeros(
                state.pos.shape[0], dtype=dtype))
        if self.itc_est_spec is not None and state.itc_buf is None:
            # Same situation for the imaginary-time-correlation ring
            # buffer: start an empty fill (the lag counts discount the
            # unfilled rows, so no bias — just the usual startup
            # transient).
            state = state._replace(
                itc_buf=jnp.zeros(self._itc_buf_shape, dtype=dtype),
                itc_filled=jnp.int32(0))
        if self.itc_est_spec is not None \
                and int(start_block_idx) < burn_in_blocks:
            # Burn blocks run the non-measuring step, which neither
            # transports the ring buffer through the branching comb
            # nor shifts it — a loaded continuation state carrying a
            # FILLED buffer would come out of the burn slot-misaligned
            # (walkers cloned/died under it) yet counted as valid by
            # the saturated fill counter.  Restart the fill whenever
            # this generator will actually run burn blocks; fresh
            # states hold zeros anyway, and mid-run resumes enter past
            # the burn (start_block_idx >= burn) and keep their fill.
            state = state._replace(
                itc_buf=jnp.zeros_like(state.itc_buf),
                itc_filled=jnp.zeros_like(state.itc_filled))
        cfc = self._cast_params(dtype)
        scalars = self._scalars(dtype)
        rebalance_every = self.rebalance_every \
            if self.num_shards > 1 else None
        cmd_window = self.cm_window_blocks
        # Forward-walking window bookkeeping: the pure-estimator
        # accumulators persist across blocks when a pfw window exceeds
        # one block, zeroed at every window start.
        pfw_window = self.pfw_window_blocks(num_time_steps_block)
        aux_shapes = self._pure_aux_shapes()

        def _fresh_aux():
            return {name: jnp.zeros(shape, dtype=dtype)
                    for name, shape in aux_shapes.items()}

        if pfw_window > 1:
            if aux_init is not None:
                # Names absent from the carry start fresh (a LIGHT
                # checkpoint drops the ITC aux pair; the zeroed
                # sums/counts stay an unbiased ratio by construction).
                aux = {name: (jnp.asarray(aux_init[name], dtype=dtype)
                              if name in aux_init
                              else jnp.zeros(shape, dtype=dtype))
                       for name, shape in aux_shapes.items()}
            else:
                aux = _fresh_aux()
        else:
            aux = None
        block_idx = int(start_block_idx)
        rebalance_pending = bool(rebalance_pending0)
        while True:
            if (rebalance_every and block_idx
                    and block_idx % rebalance_every == 0):
                rebalance_pending = True
            if rebalance_pending and (
                    block_idx <= burn_in_blocks
                    or (block_idx - burn_in_blocks) % pfw_window == 0):
                # Rebalancing permutes the walker buffers; with a
                # multi-block forward-walking window the aux
                # accumulators ride OUTSIDE the state, so a due
                # rebalance is held PENDING and executes at the next
                # window boundary (where the aux is freshly zeroed)
                # instead of being dropped.
                state = self.rebalance(state)
                rebalance_pending = False
            if self.cm_diffusion_est:
                # Open a fresh CM-diffusion window at the first
                # measured block and every ``cm_window_blocks``
                # measured blocks thereafter.
                measured_idx = block_idx - burn_in_blocks
                if measured_idx == 0 or (
                        cmd_window and measured_idx > 0
                        and measured_idx % cmd_window == 0):
                    state = state._replace(
                        cmd_accum=jnp.zeros_like(state.cmd_accum))
            block_key = jax.random.fold_in(base_key,
                                           int(block_offset) + block_idx)
            burning = block_idx < burn_in_blocks
            if burning:
                state, _, props, est = self._block_fn_burn(
                    state, block_key, scalars, cfc,
                    num_time_steps_block)
            elif pfw_window == 1:
                # Per-block windows (the default): the aux zeros stay
                # jit-internal constants — the historical zero-overhead
                # path.
                state, _, props, est = self._block_fn_measure(
                    state, block_key, scalars, cfc,
                    num_time_steps_block)
            else:
                win_pos = (block_idx - burn_in_blocks) % pfw_window
                if win_pos == 0:
                    aux = _fresh_aux()
                state, aux, props, est = self._block_fn_measure(
                    state, block_key, scalars, cfc,
                    num_time_steps_block, aux_in=aux,
                    step_offset=jnp.int32(win_pos
                                          * num_time_steps_block))
            density = est.get("density") if not burning else None
            ssf = est.get("ssf") if not burning else None
            obd = est.get("obd") if not burning else None
            cmd = est.get("cmd") if not burning else None
            g2 = est.get("g2") if not burning else None
            itc = est.get("itc") if not burning else None
            itc_nw = est.get("itc_nw") if not burning else None
            yield SamplingBlock(props, density, ssf, state, obd, cmd,
                                g2, itc, itc_nw,
                                aux_carry=(aux if (pfw_window > 1
                                                   and not burning)
                                           else None))
            block_idx += 1

    def states(self, ini_state: State) -> t.Iterator[State]:
        """Step-by-step state generator (reference
        ``qmc_base/dmc.py:663-787``); one device dispatch per step -
        use :meth:`blocks` for production."""
        for block in self.blocks(ini_state, num_time_steps_block=1):
            yield block.last_state

    def replay_states(self, ini_state: State, comb_u: np.ndarray,
                      diffusion_noise: np.ndarray) -> dict:
        """Run the DMC dynamics with *injected* noise — the
        bit-comparable reference-replay mode (SURVEY §5 RNG discipline;
        see :mod:`phd_qmclib_tpu.reference_replay`).

        ``comb_u``: raw branching-comb uniforms, ``(nts, Wm)`` (slot
        order; undrawn slots may hold anything — they cannot influence
        the comb outcome).  ``diffusion_noise``: pre-scaled Gaussian
        displacements ``~N(0, sigma)``, ``(nts, Wm, N)``.  Combine with
        ``ref_compat=True`` to reproduce the reference's trajectories
        exactly (the production step machinery is reused verbatim, so
        the match certifies the production sampler).

        Returns a dict of per-step arrays: ``num_walkers, energy,
        weight, ref_energy, accum_energy`` (the yielded ensemble
        scalars), ``pos, energies, weights`` (the post-diffusion
        ensemble) and ``parent`` (the branching table).
        """
        if self.mesh is not None:
            raise ValueError("replay_states is a single-device "
                             "verification mode")
        dtype = ini_state.pos.dtype
        comb_u = jnp.asarray(comb_u, dtype=dtype)
        xi = jnp.asarray(diffusion_noise, dtype=dtype)
        step = self.make_step_fn(measure=False, injected_noise=True)
        cfc = self._cast_params(dtype)
        scalars = self._scalars(dtype)
        extra0 = {}
        if self.ref_compat:
            extra0["ref_eprev"] = ini_state.energies

        @jax.jit
        def run(state, extra, comb_u, xi):
            def body(carry, inputs):
                st, ex = carry
                idx, cu, x = inputs
                parent, _ = branching_comb(st.weights, st.num_walkers,
                                           u=cu)
                new_state, new_extra, props, _ = step(
                    st, ex, {"comb_u": cu, "xi": x}, idx, scalars, cfc)
                energy, weight, nw, ref_e, accum_e = props
                out = {
                    "num_walkers": nw, "energy": energy,
                    "weight": weight, "ref_energy": ref_e,
                    "accum_energy": accum_e, "pos": new_state.pos,
                    "energies": new_state.energies,
                    "weights": new_state.weights, "parent": parent,
                }
                return (new_state, new_extra), out
            steps = jnp.arange(comb_u.shape[0])
            (final_state, _), out = jax.lax.scan(
                body, (state, extra), (steps, comb_u, xi))
            return final_state, out

        _, out = run(ini_state, extra0, comb_u, xi)
        return out

    def state_data_blocks(self, ini_state: State,
                          num_time_steps_block: int, thin: int = 1,
                          block_offset: int = 0):
        """Yield blocks that additionally record the walker ensembles
        (reference ``qmc_base/dmc.py:973-1070``).

        Yields ``(ensembles, block)`` where ``ensembles`` is a dict with
        ``pos (nts//thin, Wm, N)``, ``energies``, ``weights`` - every
        ``thin``-th step's post-diffusion ensemble - and ``block`` is
        the usual :class:`SamplingBlock`.
        """
        if num_time_steps_block % thin:
            raise ValueError(
                "num_time_steps_block must be divisible by thin")
        # As in the reference, no estimators are evaluated while
        # recording state data (``qmc_base/dmc.py:987-1068``).
        block_fn = self._block_fn_burn

        @jax.jit
        def collect(state, block_key, scalars, cfc):
            def body(carry, key):
                new_state, _, props, _ = block_fn(carry, key, scalars,
                                                  cfc, thin)
                return new_state, (
                    {"pos": new_state.pos,
                     "energies": new_state.energies,
                     "weights": new_state.weights}, props)

            keys = jax.random.split(block_key,
                                    num_time_steps_block // thin)
            final_state, (ens, props) = jax.lax.scan(body, state, keys)
            return final_state, ens, props

        base_key = jax.random.PRNGKey(self.rng_seed)
        state = ini_state
        dtype = ini_state.pos.dtype
        cfc = self._cast_params(dtype)
        scalars = self._scalars(dtype)
        block_idx = int(block_offset)
        while True:
            block_key = jax.random.fold_in(base_key, block_idx)
            state, ens, props = collect(state, block_key, scalars, cfc)
            props_flat = PropsData(
                *(x.reshape((-1,) + x.shape[2:]) for x in props))
            block = SamplingBlock(props_flat, None, None, state)
            yield ens, block
            block_idx += 1
