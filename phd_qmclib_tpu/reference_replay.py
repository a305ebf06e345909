"""Bit-comparable replay of the reference's sampling loops.

The reference draws every random number from numba's per-thread clone of
NumPy's legacy ``RandomState`` (MT19937): kernels call ``random.rand`` /
``random.normal`` after seeding with ``random.seed(rng_seed)``
(``/root/reference/src/phd_qmclib/qmc_base/utils.py:14-21``,
``qmc_base/vmc.py:596``, ``qmc_base/dmc.py:730``).  Numba documents its
``numpy.random`` implementation as producing *the same sequences as
NumPy for the same seed*, so a pure-NumPy ``RandomState`` replay of the
reference's exact per-step draw order reproduces the reference's
single-threaded trajectories bit-for-bit - without numba ever being
installed.

This module implements that replay for the serial
(``jit_parallel=False``) reference sampler variants:

* :func:`vmc_replay` - the Metropolis chain of
  ``qmc_base/vmc.py:556-648`` with the mrbp trial-move
  (``mrbp_qmc/vmc.py:205-235``): per step, ``nop`` uniform move draws in
  particle order, then one acceptance draw (always consumed).
* :func:`dmc_replay` - the DMC loop of ``qmc_base/dmc.py:678-787``: per
  step, one uniform per *processed* comb walker
  (``qmc_base/dmc.py:621-653``), then ``nop`` Gaussian diffusion draws
  per surviving walker in slot order
  (``qmc_base/jastrow/dmc.py:633-673, 829-951``).

Both record the raw draws so the JAX framework can be driven with the
*identical* noise (``samplers.vmc.Sampling.replay_chain``,
``samplers.dmc.Sampling.replay_states``) and compared trajectory-for-
trajectory at f64 round-off (``tests/test_reference_replay.py``).

Reference-fidelity notes:

* All model kernels evaluate with the reference's serial accumulation
  order (per-particle loops, ``j > i`` pair order), in float64.
* ``dmc_replay`` reproduces a genuine quirk of the reference: the
  branching weight ``exp(-dt*((E_next + E_prev)/2 - E_ref))`` reads
  ``E_prev`` from ``actual_state_energies[sys_idx]`` *before* the
  cloning write updates that slot
  (``qmc_base/jastrow/dmc.py:846-847`` read inside ``evolve_system``
  vs the later write at ``:941``), i.e. the energy of whatever walker
  occupied the slot on the *previous* step - not the parent's energy.
  Both are valid O(dt) discretizations of the short-time Green's
  function; the framework's production step uses the parent energy,
  and its replay mode has a ``ref_compat`` switch to reproduce the
  reference exactly.
"""
import typing as t
from math import copysign, cos, cosh, exp, fabs, log, pi, sin, sinh, \
    sqrt, tan, tanh

import numpy as np

__all__ = [
    "MRBPKernels",
    "VmcReplayResult",
    "DmcReplayResult",
    "vmc_replay",
    "dmc_replay",
]


# ---------------------------------------------------------------------------
# Serial float64 model kernels (reference accumulation order).
# ---------------------------------------------------------------------------

class MRBPKernels:
    """Serial float64 evaluators of the mrbp model functions.

    Parameter values come from the framework's :class:`~models.mrbp.Spec`
    derivation (itself verified against the reference's stored results,
    ``tests/qmc_exec/test_reference_interop.py``); the evaluation order
    matches the reference kernels (``mrbp_qmc/model.py:403-562``,
    ``qmc_base/jastrow/model.py:286-368, 777-856``).
    """

    def __init__(self, spec):
        cfc = spec.cfc_params
        mp, obf, tbf = cfc.model_params, cfc.obf_params, cfc.tbf_params
        self.nop = int(spec.boson_number)
        self.sc_size = float(mp.supercell_size)
        self.v0 = float(mp.lattice_depth)
        self.r = float(mp.lattice_ratio)
        self.v0d = float(mp.defect_magnitude)
        self.defects_sep = int(spec.defects_sep)
        self.well_width = float(mp.well_width)
        self.e0 = float(obf.param_e0)
        self.k1 = float(obf.param_k1)
        self.kp1 = float(obf.param_kp1)
        self.rm = float(tbf.tbf_contact_cutoff)
        self.k2 = float(tbf.param_k2)
        self.beta = float(tbf.param_beta)
        self.r_off = float(tbf.param_r_off)
        self.am = float(tbf.param_am)
        self.is_free = bool(spec.is_free)
        self.is_ideal = bool(spec.is_ideal)

    # -- scalar building blocks (mrbp_qmc/model.py:403-551) -----------------

    def one_body_func(self, z: float) -> float:
        z_cell = z % 1.0
        z_a = 1.0 / (1.0 + self.r)
        z_b = self.r / (1.0 + self.r)
        if z_a < z_cell:
            return cosh(self.kp1 * (z_cell - 1.0 + 0.5 * z_b))
        cf = sqrt(1.0 + self.v0 / self.e0
                  * sinh(0.5 * sqrt(self.v0 - self.e0) * z_b) ** 2.0)
        return cf * cos(self.k1 * (z_cell - 0.5 * z_a))

    def one_body_log_dz(self, z: float) -> float:
        z_cell = z % 1.0
        z_a = 1.0 / (1.0 + self.r)
        z_b = self.r / (1.0 + self.r)
        if z_a < z_cell:
            return self.kp1 * tanh(self.kp1 * (z_cell - 1.0 + 0.5 * z_b))
        return -self.k1 * tan(self.k1 * (z_cell - 0.5 * z_a))

    def one_body_log_dz2(self, z: float) -> float:
        z_cell = z % 1.0
        z_a = 1.0 / (1.0 + self.r)
        return self.v0 - self.e0 if z_a < z_cell else -self.e0

    def two_body_func(self, rz: float) -> float:
        if rz < fabs(self.rm):
            return self.am * cos(self.k2 * (rz - self.r_off))
        return sin(pi * rz / self.sc_size) ** self.beta

    def two_body_log_dz(self, rz: float) -> float:
        if rz < fabs(self.rm):
            return -self.k2 * tan(self.k2 * (rz - self.r_off))
        return (pi / self.sc_size) * self.beta \
            / tan(pi * rz / self.sc_size)

    def two_body_log_dz2(self, rz: float) -> float:
        if rz < fabs(self.rm):
            return -self.k2 * self.k2
        return (pi / self.sc_size) ** 2 * self.beta * (
            (self.beta - 1.0) / (tan(pi * rz / self.sc_size) ** 2) - 1.0)

    def potential(self, z: float) -> float:
        n_cell, z_cell = divmod(z, 1.0)
        if not (n_cell % self.defects_sep):
            return self.v0d if self.well_width < z_cell else 0.0
        return self.v0 if self.well_width < z_cell else 0.0

    def min_distance(self, z_i: float, z_j: float) -> float:
        sc_half = 0.5 * self.sc_size
        z_ij = z_i - z_j
        if fabs(z_ij) > sc_half:
            return -sc_half + (z_ij + sc_half) % self.sc_size
        return z_ij

    def recast(self, z: float) -> float:
        return z % self.sc_size

    # -- configuration-level kernels ----------------------------------------

    def wf_abs_log(self, pos: np.ndarray) -> float:
        """``log|Psi|`` with the reference's per-particle serial order
        (``qmc_base/jastrow/model.py:286-368``)."""
        total = 0.0
        if self.is_free and self.is_ideal:
            return total
        for i in range(self.nop):
            if not self.is_free:
                total += log(fabs(self.one_body_func(pos[i])))
            if not self.is_ideal:
                for j in range(i + 1, self.nop):
                    z_ij = self.min_distance(pos[i], pos[j])
                    total += log(fabs(self.two_body_func(fabs(z_ij))))
        return total

    def ith_energy_and_drift(self, i: int, pos: np.ndarray) \
            -> t.Tuple[float, float]:
        """Reference ``qmc_base/jastrow/model.py:777-856``."""
        if self.is_free and self.is_ideal:
            return 0.0, 0.0
        kin, pot, drift = 0.0, 0.0, 0.0
        if not self.is_free:
            z_i = pos[i]
            ldz2 = self.one_body_log_dz2(z_i)
            ldz = self.one_body_log_dz(z_i)
            kin += -ldz2 + ldz ** 2
            pot += self.potential(z_i)
            drift += ldz
        if not self.is_ideal:
            z_i = pos[i]
            for j in range(self.nop):
                if j == i:
                    continue
                z_ij = self.min_distance(z_i, pos[j])
                sgn = copysign(1.0, z_ij)
                ldz2 = self.two_body_log_dz2(fabs(z_ij))
                ldz = self.two_body_log_dz(fabs(z_ij)) * sgn
                kin += -ldz2 + ldz ** 2
                drift += ldz
        return kin - drift ** 2 + pot, drift

    def energy_and_drift(self, pos: np.ndarray) \
            -> t.Tuple[float, np.ndarray]:
        energy = 0.0
        drift = np.empty(self.nop)
        for i in range(self.nop):
            e_i, d_i = self.ith_energy_and_drift(i, pos)
            energy += e_i
            drift[i] = d_i
        return energy, drift


# ---------------------------------------------------------------------------
# VMC chain replay.
# ---------------------------------------------------------------------------

class VmcReplayResult(t.NamedTuple):
    """Recorded trajectory + raw draws of a reference VMC chain."""
    pos: np.ndarray        # (nts + 1, N) - chain positions incl. start
    wf_abs_log: np.ndarray  # (nts + 1,)
    accepted: np.ndarray   # (nts,) bool
    moves_u: np.ndarray    # (nts, N) raw uniforms of the move draws
    accept_u: np.ndarray   # (nts,) raw uniforms of the Metropolis draw


def vmc_replay(spec, move_spread: float, rng_seed: int,
               ini_pos: np.ndarray, num_steps: int,
               gaussian: bool = False) -> VmcReplayResult:
    """Replay the reference VMC chain (``qmc_base/vmc.py:556-648`` with
    the mrbp uniform-move ``mrbp_qmc/vmc.py:205-235``).

    Per step, draw order is: ``nop`` uniforms (one per particle, in
    particle order - ``jastrow/vmc.py:200-226``), then exactly one
    acceptance uniform (``rand()`` inside the Metropolis condition at
    ``qmc_base/vmc.py:636`` - evaluated unconditionally).

    With ``gaussian=True`` this replays the ``vmc_ndf`` variant
    instead (``qmc_base/vmc_ndf.py:43-59``,
    ``mrbp_qmc/vmc_ndf.py:38-45``): each move draw is
    ``normal(0, move_spread)`` (``move_spread`` = ``sigma`` =
    ``sqrt(time_step)``), recorded in ``moves_u`` as the PRE-SCALED
    displacement.
    """
    kern = MRBPKernels(spec)
    rs = np.random.RandomState(rng_seed)
    nop = kern.nop

    pos = np.array(ini_pos, dtype=np.float64).copy()
    assert pos.shape == (nop,)
    wf = kern.wf_abs_log(pos)

    out_pos = np.empty((num_steps + 1, nop))
    out_wf = np.empty(num_steps + 1)
    accepted = np.empty(num_steps, dtype=bool)
    moves_u = np.empty((num_steps, nop))
    accept_u = np.empty(num_steps)
    out_pos[0] = pos
    out_wf[0] = wf

    for s in range(num_steps):
        prop = np.empty(nop)
        for i in range(nop):
            if gaussian:
                disp = rs.normal(0.0, move_spread)
                moves_u[s, i] = disp
            else:
                u = rs.random_sample()
                moves_u[s, i] = u
                disp = (u - 0.5) * move_spread
            prop[i] = kern.recast(pos[i] + disp)
        wf_prop = kern.wf_abs_log(prop)
        u_acc = rs.random_sample()
        accept_u[s] = u_acc
        if wf_prop > 0.5 * log(u_acc) + wf:
            pos, wf = prop, wf_prop
            accepted[s] = True
        else:
            accepted[s] = False
        out_pos[s + 1] = pos
        out_wf[s + 1] = wf

    return VmcReplayResult(out_pos, out_wf, accepted, moves_u, accept_u)


# ---------------------------------------------------------------------------
# DMC ensemble replay.
# ---------------------------------------------------------------------------

class DmcReplayResult(t.NamedTuple):
    """Recorded trajectory + raw draws of a reference DMC run.

    Ensemble arrays are padded to ``(num_steps, max_num_walkers, ...)``;
    entries at slots ``>= num_walkers[s]`` are zero / undefined.
    """
    # Per-step yielded state (reference ``qmc_base/dmc.py:773-781``).
    num_walkers: np.ndarray    # (nts,) int
    energy: np.ndarray         # (nts,) ensemble energy sum
    weight: np.ndarray         # (nts,) ensemble weight sum
    ref_energy: np.ndarray     # (nts,)
    accum_energy: np.ndarray   # (nts,)
    # Post-branching (pre-diffusion) ensemble = the yielded confs.
    actual_energies: np.ndarray  # (nts, Wm)
    # Post-diffusion ensemble (becomes the next step's parents).
    next_pos: np.ndarray       # (nts, Wm, N)
    next_energies: np.ndarray  # (nts, Wm)
    next_weights: np.ndarray   # (nts, Wm)
    cloning_refs: np.ndarray   # (nts, Wm) int parent table
    # Raw draws, padded for injection into the framework replay.
    comb_u: np.ndarray         # (nts, Wm) uniforms (undrawn slots = 0)
    diffusion_noise: np.ndarray  # (nts, Wm, N) ~ N(0, sigma)


def dmc_replay(spec, time_step: float, rng_seed: int,
               ini_pos: np.ndarray, ini_drift: np.ndarray,
               ini_energies: np.ndarray, ini_weights: np.ndarray,
               ini_num_walkers: int, ini_ref_energy: float,
               max_num_walkers: int, target_num_walkers: int,
               nwc_factor: float, num_steps: int) -> DmcReplayResult:
    """Replay the reference DMC sampling loop
    (``qmc_base/dmc.py:678-787``) in the serial kernel variant.

    Per step: ``sync_branching_spec`` draws one uniform per processed
    walker (``qmc_base/dmc.py:621-653``), then ``evolve_state_inner``
    draws ``nop`` Gaussians ``normal(0, sigma)`` per surviving walker in
    slot order (``jastrow/dmc.py:633-673, 892-941``).
    """
    kern = MRBPKernels(spec)
    rs = np.random.RandomState(rng_seed)
    nop = kern.nop
    max_w = max_num_walkers
    sigma = sqrt(2.0 * time_step)
    dt = time_step

    # Triple buffers as in the reference generator
    # (``qmc_base/dmc.py:705-717``): prev/actual/next, all starting as
    # copies of the initial state.
    prev_pos = np.zeros((max_w, nop))
    prev_drift = np.zeros((max_w, nop))
    prev_energies = np.zeros(max_w)
    prev_weights = np.zeros(max_w)
    w0 = int(ini_num_walkers)
    prev_pos[:w0] = np.asarray(ini_pos, dtype=np.float64)[:w0]
    prev_drift[:w0] = np.asarray(ini_drift, dtype=np.float64)[:w0]
    prev_energies[:w0] = np.asarray(ini_energies, dtype=np.float64)[:w0]
    prev_weights[:w0] = np.asarray(ini_weights, dtype=np.float64)[:w0]

    actual_energies = prev_energies.copy()
    prev_num_walkers = w0
    ref_energy = float(ini_ref_energy)
    total_energy = 0.0
    total_weight = 0.0

    r = DmcReplayResult(
        num_walkers=np.empty(num_steps, dtype=np.int64),
        energy=np.empty(num_steps), weight=np.empty(num_steps),
        ref_energy=np.empty(num_steps), accum_energy=np.empty(num_steps),
        actual_energies=np.zeros((num_steps, max_w)),
        next_pos=np.zeros((num_steps, max_w, nop)),
        next_energies=np.zeros((num_steps, max_w)),
        next_weights=np.zeros((num_steps, max_w)),
        cloning_refs=np.zeros((num_steps, max_w), dtype=np.int64),
        comb_u=np.zeros((num_steps, max_w)),
        diffusion_noise=np.zeros((num_steps, max_w, nop)))

    for s in range(num_steps):
        # 1) sync_branching_spec (qmc_base/dmc.py:621-653), verbatim
        #    serial logic including the mid-loop cap break.
        cloning_refs = np.zeros(max_w, dtype=np.int64)
        final_num_walkers = 0
        for sys_idx in range(prev_num_walkers):
            if final_num_walkers >= max_w:
                break
            u = rs.random_sample()
            r.comb_u[s, sys_idx] = u
            clone_factor = int(prev_weights[sys_idx] + u)
            if not clone_factor:
                continue
            start = final_num_walkers
            final_num_walkers = min(max_w,
                                    final_num_walkers + clone_factor)
            cloning_refs[start:final_num_walkers] = sys_idx
        num_walkers = final_num_walkers

        # 2) evolve_state_inner (jastrow/dmc.py:846-951), serial order.
        next_pos = np.zeros((max_w, nop))
        next_drift = np.zeros((max_w, nop))
        next_energies = np.zeros(max_w)
        next_weights = np.zeros(max_w)
        new_actual_energies = actual_energies.copy()
        for sys_idx in range(num_walkers):
            parent = cloning_refs[sys_idx]
            # evolve_system (jastrow/dmc.py:742-827): diffuse the parent
            # config, then fused energy+drift of the diffused config.
            for i in range(nop):
                xi = rs.normal(0.0, sigma)
                r.diffusion_noise[s, sys_idx, i] = xi
                z_next = prev_pos[parent, i] \
                    + 2.0 * prev_drift[parent, i] * dt + xi
                next_pos[sys_idx, i] = kern.recast(z_next)
            energy_next, drift_next = kern.energy_and_drift(
                next_pos[sys_idx])
            next_drift[sys_idx] = drift_next
            next_energies[sys_idx] = energy_next
            # Reference quirk (see module docstring): E_prev is the
            # stale slot energy, read BEFORE the cloning write below.
            e_prev_slot = actual_energies[sys_idx]
            mean_energy = (energy_next + e_prev_slot) / 2.0
            next_weights[sys_idx] = exp(-dt * (mean_energy - ref_energy))
            # Cloning writes (jastrow/dmc.py:936-944).
            new_actual_energies[sys_idx] = prev_energies[parent]
        actual_energies = new_actual_energies

        # 3) Ensemble reductions + E_ref update (qmc_base/dmc.py:758-771).
        state_energy = actual_energies[:num_walkers].sum()
        state_weight = float(num_walkers)  # unit weights after cloning
        total_energy += state_energy
        total_weight += state_weight
        accum_energy = total_energy / total_weight
        ref_energy = accum_energy - nwc_factor * log(
            state_weight / target_num_walkers) / dt

        r.num_walkers[s] = num_walkers
        r.energy[s] = state_energy
        r.weight[s] = state_weight
        r.ref_energy[s] = ref_energy
        r.accum_energy[s] = accum_energy
        r.actual_energies[s] = actual_energies
        r.next_pos[s] = next_pos
        r.next_energies[s] = next_energies
        r.next_weights[s] = next_weights
        r.cloning_refs[s] = cloning_refs

        # 4) Buffer swap (qmc_base/dmc.py:781-785).
        prev_pos, prev_drift = next_pos, next_drift
        prev_energies, prev_weights = next_energies, next_weights
        prev_num_walkers = num_walkers

    return r
