"""Generic Bijl-Jastrow pair-product wavefunction kernels.

The trial wavefunction is ``psi(z) = prod_i f1(z_i) * prod_{i<j}
f2(|z_ij|)`` for model-supplied one-body (``f1``) and two-body (``f2``)
functions.  The reference implements these as numba scalar kernels with
explicit O(N^2) loops (``/root/reference/src/phd_qmclib/qmc_base/jastrow/
model.py:286-1004``); here every kernel is a pure, batched JAX function
over position arrays of shape ``(..., N)`` - the pairwise loops become
broadcasted ``(..., N, N)`` element-wise ops fused by XLA.

Naming note carried over from the reference: the ``*_log_dz`` callables
return the log-derivative ``f'/f`` while the ``*_log_dz2`` callables
return the *bare* second-derivative ratio ``f''/f`` (see e.g. the
one-body well branch returning ``-e0``, ``mrbp_qmc/model.py:450-464``).
With that convention the local energy identity used throughout is::

    E_L = sum_t (-f_t''/f_t + (f_t'/f_t)^2) - sum_i drift_i^2 + V
        = -(laplacian psi)/psi + V

Parameters travel in a ``CFCParams`` pytree of continuous values; static
structure (particle number, free/ideal flags, defect period) binds at
function-construction time so XLA sees compile-time constants - the JAX
analog of the reference's closure-compiled kernel factories
(``qmc_base/vmc.py:556-648``).
"""
import typing as t
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import histogram as _hist_ops
from ..ops.pbc import min_image, min_image_bounded, sign

__all__ = ["CFCParams", "build_core_funcs", "SysConfSlot"]

#: Element budget per pairwise tile: batches whose (B, N, N) pair block
#: would exceed this evaluate as a ``lax.map`` over walker tiles so the
#: temporaries stay bounded (67M elements = ~268 MB per f32 temporary).
#: Not yet measured on the GPU (ROADMAP A3).
PAIR_TILE_ELEMS = 4096 * 128 * 128


class SysConfSlot:
    """Slots of a packed ``(2, N)`` system configuration (reference
    ``qmc_base/jastrow/model.py:30-38``): used at the state/HDF5
    boundary; kernels operate on flat position arrays."""
    pos: int = 0
    drift: int = 1


class CFCParams(t.NamedTuple):
    """Continuous core-function parameters (a JAX pytree).

    Mirrors the reference ``CFCSpec`` NamedTuple-of-NamedTuples
    (``qmc_base/jastrow/model.py:87-92``); concrete models define the
    ``model_params`` / ``obf_params`` / ``tbf_params`` leaves.
    """
    model_params: t.Any
    obf_params: t.Any
    tbf_params: t.Any


def build_core_funcs(*,
                     one_body,
                     one_body_log_dz,
                     one_body_log_dz2,
                     two_body,
                     two_body_log_dz,
                     two_body_log_dz2,
                     potential,
                     is_free: bool,
                     is_ideal: bool,
                     boson_number: int,
                     two_body_pair_terms=None) -> SimpleNamespace:
    """Build the Jastrow kernel namespace for a concrete model.

    Every model callable has signature ``(x, cfc: CFCParams) -> value``
    and must be vectorized (jnp) over ``x``.  ``is_free`` / ``is_ideal``
    are static flags: the corresponding terms are dropped at trace time,
    matching the reference's runtime guards
    (``qmc_base/jastrow/model.py:315-329``).

    Returns a namespace with: ``log_psi``, ``energy``, ``drift``,
    ``energy_and_drift``, ``delta_log_psi_move``, ``one_body_density``,
    ``fourier_density``, ``fourier_density_parts``.  All functions accept
    positions of shape ``(..., N)`` and broadcast over leading axes.
    """
    nop = boson_number

    if two_body_pair_terms is None:
        def two_body_pair_terms(r, cfc, need_log=True,
                                need_derivs=True,
                                need_kin=False):  # noqa: F811
            ldz = two_body_log_dz(r, cfc) if need_derivs else None
            third = None
            if need_derivs:
                ldz2 = two_body_log_dz2(r, cfc)
                third = -ldz2 + ldz ** 2 if need_kin else ldz2
            return (jnp.log(jnp.abs(two_body(r, cfc)))
                    if need_log else None, ldz, third)

    def _supercell(cfc):
        return cfc.model_params.supercell_size

    def _tiled_over_walkers(fn, cost: int = 1):
        """Evaluate ``fn(pos, cfc)`` in walker tiles when the flat batch
        is large, bounding the O(N^2) temporary footprint.

        The tile size adapts to the particle number (budget
        ``PAIR_TILE_ELEMS`` elements per (tile, N, N) block, divided by
        ``cost`` for kernels whose per-pair temporaries are wider than
        one element) and snaps to the largest divisor of the batch at or
        below the budget, so any batch size tiles without padding.
        """

        def wrapper(pos, cfc):
            batch_shape = pos.shape[:-1]
            total = int(np.prod(batch_shape)) if batch_shape else 1
            budget = max(1, PAIR_TILE_ELEMS // (nop * nop * cost))
            if total <= budget:
                return fn(pos, cfc)
            tile = budget
            while total % tile:
                tile -= 1
            if tile <= 1:
                return fn(pos, cfc)
            flat = pos.reshape(total // tile, tile, pos.shape[-1])
            out = jax.lax.map(lambda p: fn(p, cfc), flat)
            return jax.tree.map(
                lambda x: x.reshape(batch_shape + x.shape[2:]), out)

        return wrapper

    def _pair_geometry(pos, cfc):
        """Minimum-image pair displacements, distances and the
        off-diagonal mask.

        Diagonal distances are replaced by a safe value (L/4) before the
        two-body functions see them, so masked-out entries never produce
        inf/NaN values or NaN gradients through ``jnp.where``.
        """
        sc = _supercell(cfc)
        d = pos[..., :, None] - pos[..., None, :]
        # Positions live in [0, L): differences are bounded by (-L, L),
        # so the cheap round-based minimum image applies.
        d = min_image_bounded(d, sc)
        off_diag = ~jnp.eye(nop, dtype=bool)
        r = jnp.where(off_diag, jnp.abs(d), 0.25 * sc)
        return d, r, off_diag

    # NOTE (perf): a half-pair formulation (N/2 rotations visiting each
    # unordered pair once) needs many small sequential ops that defeat
    # XLA fusion, while the full (N, N) pair block below compiles to one
    # fused pass.

    # -- log |psi| --------------------------------------------------------
    def log_psi(pos, cfc: CFCParams):
        """log|psi| for configurations ``pos`` of shape ``(..., N)``.

        Reference: ``qmc_base/jastrow/model.py:286-368``.
        """
        total = jnp.zeros(pos.shape[:-1], dtype=pos.dtype)
        if not is_free:
            obv = one_body(pos, cfc)
            total = total + jnp.log(jnp.abs(obv)).sum(axis=-1)
        if not is_ideal:
            _, r, off_diag = _pair_geometry(pos, cfc)
            log_tb, _, _ = two_body_pair_terms(r, cfc, need_log=True,
                                               need_derivs=False)
            total = total + 0.5 * jnp.where(off_diag, log_tb,
                                            0.0).sum(axis=(-1, -2))
        return total

    # -- drift ------------------------------------------------------------
    def drift(pos, cfc: CFCParams):
        """Drift force ``F_i = d(log|psi|)/dz_i``, shape ``(..., N)``.

        Reference: ``qmc_base/jastrow/model.py:463-566``.
        """
        out = jnp.zeros_like(pos)
        if not is_free:
            out = out + one_body_log_dz(pos, cfc)
        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            _, tb_ldz, _ = two_body_pair_terms(r, cfc, need_log=False,
                                               need_derivs=True)
            out = out + jnp.where(off_diag, tb_ldz * sign(d),
                                  0.0).sum(axis=-1)
        return out

    # -- fused local energy + drift ---------------------------------------
    def energy_and_drift(pos, cfc: CFCParams):
        """Fused local energy and drift - the DMC hot kernel.

        One pass over pairs computes the ``f'/f`` and ``f''/f``
        accumulators (reference ``qmc_base/jastrow/model.py:777-856``).
        Returns ``(energy (...,), drift (..., N))``.
        """
        batch_shape = pos.shape[:-1]
        kin = jnp.zeros(batch_shape, dtype=pos.dtype)
        pot = jnp.zeros(batch_shape, dtype=pos.dtype)
        drift_v = jnp.zeros_like(pos)

        if not is_free:
            ob_ldz = one_body_log_dz(pos, cfc)
            ob_ldz2 = one_body_log_dz2(pos, cfc)
            kin = kin + (-ob_ldz2 + ob_ldz ** 2).sum(axis=-1)
            pot = pot + potential(pos, cfc).sum(axis=-1)
            drift_v = drift_v + ob_ldz

        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            _, tb_ldz, tb_kin = two_body_pair_terms(
                r, cfc, need_log=False, need_derivs=True,
                need_kin=True)
            kin = kin + jnp.where(off_diag, tb_kin,
                                  0.0).sum(axis=(-1, -2))
            drift_pair = jnp.where(off_diag, tb_ldz * sign(d), 0.0)
            drift_v = drift_v + drift_pair.sum(axis=-1)

        energy_v = kin - (drift_v ** 2).sum(axis=-1) + pot
        return energy_v, drift_v

    def energy(pos, cfc: CFCParams):
        """Local energy ``E_L`` (reference
        ``qmc_base/jastrow/model.py:664-775``)."""
        return energy_and_drift(pos, cfc)[0]

    def log_psi_and_energy(pos, cfc: CFCParams):
        """Fused ``(log|psi|, E_L)`` - the VMC hot kernel.

        One pass over pairs computes the wavefunction log-sum and all
        derivative accumulators together (the reference evaluates them in
        separate numba kernels, ``qmc_base/jastrow/vmc.py:72-93,228-264``).
        """
        batch_shape = pos.shape[:-1]
        lp = jnp.zeros(batch_shape, dtype=pos.dtype)
        kin = jnp.zeros(batch_shape, dtype=pos.dtype)
        pot = jnp.zeros(batch_shape, dtype=pos.dtype)
        drift_v = jnp.zeros_like(pos)

        if not is_free:
            obv = one_body(pos, cfc)
            lp = lp + jnp.log(jnp.abs(obv)).sum(axis=-1)
            ob_ldz = one_body_log_dz(pos, cfc)
            ob_ldz2 = one_body_log_dz2(pos, cfc)
            kin = kin + (-ob_ldz2 + ob_ldz ** 2).sum(axis=-1)
            pot = pot + potential(pos, cfc).sum(axis=-1)
            drift_v = drift_v + ob_ldz

        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            log_tb, tb_ldz, tb_kin = two_body_pair_terms(
                r, cfc, need_log=True, need_derivs=True,
                need_kin=True)
            lp = lp + 0.5 * jnp.where(off_diag, log_tb,
                                      0.0).sum(axis=(-1, -2))
            kin = kin + jnp.where(off_diag, tb_kin,
                                  0.0).sum(axis=(-1, -2))
            drift_pair = jnp.where(off_diag, tb_ldz * sign(d), 0.0)
            drift_v = drift_v + drift_pair.sum(axis=-1)

        energy_v = kin - (drift_v ** 2).sum(axis=-1) + pot
        return lp, energy_v

    # -- single-particle move delta ---------------------------------------
    def delta_log_psi_move(k, z_k_delta, pos, cfc: CFCParams):
        """Change of ``log|psi|`` after displacing particle ``k`` by
        ``z_k_delta`` (O(N) update; reference
        ``qmc_base/jastrow/model.py:398-461``).  ``pos`` is a single
        configuration of shape ``(N,)``.
        """
        dtype = pos.dtype
        delta = jnp.zeros((), dtype=dtype)
        z_k = pos[k]
        z_k_upd = z_k + z_k_delta
        if not is_free:
            obv = one_body(z_k, cfc)
            obv_upd = one_body(z_k_upd, cfc)
            delta = delta + jnp.log(jnp.abs(obv_upd / obv))
        if not is_ideal:
            sc = _supercell(cfc)
            r_ki = jnp.abs(min_image(z_k - pos, sc))
            r_ki_upd = jnp.abs(min_image(z_k_upd - pos, sc))
            tbv = two_body(r_ki, cfc)
            tbv_upd = two_body(r_ki_upd, cfc)
            log_ratio = jnp.log(jnp.abs(tbv_upd / tbv))
            mask = jnp.arange(nop) != k
            delta = delta + jnp.where(mask, log_ratio, 0.0).sum()
        return delta

    def wf_abs(pos, cfc: CFCParams):
        """``|psi|`` (reference ``qmc_base/jastrow/model.py:370-396``)."""
        return jnp.exp(log_psi(pos, cfc))

    def delta_drift_move(i, k, z_k_delta, pos, cfc: CFCParams):
        """Change of the i-th drift component after displacing particle
        ``k`` by ``z_k_delta`` (O(N) update; reference
        ``qmc_base/jastrow/model.py:568-662``).  ``pos`` is a single
        configuration of shape ``(N,)``.
        """
        sc = _supercell(cfc)
        z_k = pos[k]
        z_k_upd = z_k + z_k_delta

        def other_particle():
            # i != k: only the (i, k) pair term changes; the drift seen
            # from i uses displacement z_k - z_i with a minus sign.
            if is_ideal:
                return jnp.zeros((), dtype=pos.dtype)
            z_i = pos[i]
            z_ki = min_image(z_k - z_i, sc)
            z_ki_upd = min_image(z_k_upd - z_i, sc)
            ldz = two_body_log_dz(jnp.abs(z_ki), cfc) * sign(z_ki)
            ldz_upd = two_body_log_dz(jnp.abs(z_ki_upd), cfc) \
                * sign(z_ki_upd)
            return -(ldz_upd - ldz)

        def moved_particle():
            delta = jnp.zeros((), dtype=pos.dtype)
            if not is_free:
                delta = delta + (one_body_log_dz(z_k_upd, cfc)
                                 - one_body_log_dz(z_k, cfc))
            if not is_ideal:
                z_kj = min_image(z_k - pos, sc)
                z_kj_upd = min_image(z_k_upd - pos, sc)
                ldz = two_body_log_dz(jnp.abs(z_kj), cfc) * sign(z_kj)
                ldz_upd = two_body_log_dz(jnp.abs(z_kj_upd), cfc) \
                    * sign(z_kj_upd)
                mask = jnp.arange(nop) != k
                delta = delta + jnp.where(mask, ldz_upd - ldz, 0.0).sum()
            return delta

        # i and k are static Python ints in typical use; support both.
        if isinstance(i, int) and isinstance(k, int):
            return moved_particle() if i == k else other_particle()
        return jax.lax.cond(jnp.asarray(i) == jnp.asarray(k),
                            moved_particle, other_particle)

    # -- one-body density matrix ------------------------------------------
    def one_body_density(sz, pos, cfc: CFCParams):
        """One-body density matrix estimator ``n1(sz)``: the average over
        particles of the wavefunction ratio with particle ``i`` displaced
        by ``sz`` (reference ``qmc_base/jastrow/model.py:858-965``).

        ``pos``: ``(..., N)``; ``sz``: scalar; returns ``(...)``.
        """
        log_ratio = jnp.zeros(pos.shape, dtype=pos.dtype)  # per particle i
        if not is_free:
            ob = one_body(pos, cfc)
            ob_sft = one_body(pos + sz, cfc)
            log_ratio = log_ratio + (jnp.log(ob_sft) - jnp.log(ob))
        if not is_ideal:
            sc = _supercell(cfc)
            d = min_image(pos[..., :, None] - pos[..., None, :], sc)
            d_sft = min_image((pos + sz)[..., :, None] - pos[..., None, :],
                              sc)
            tb = two_body(jnp.abs(d), cfc)
            tb_sft = two_body(jnp.abs(d_sft), cfc)
            off_diag = ~jnp.eye(nop, dtype=bool)
            pair_log = jnp.where(off_diag,
                                 jnp.log(tb_sft) - jnp.log(tb), 0.0)
            log_ratio = log_ratio + pair_log.sum(axis=-1)
        return jnp.exp(log_ratio).sum(axis=-1) / nop

    def one_body_density_grid(szs, pos, cfc: CFCParams):
        """OBDM ``n1`` at a grid of displacements: ``szs (M,)``,
        ``pos (..., N)`` -> ``(..., M)``.

        The reference defines the single-offset scalar kernel
        (``qmc_base/jastrow/model.py:858-965``) but leaves the sampler
        estimator machinery stubbed (``qmc_base/vmc.py:444-450``,
        ``mrbp_qmc/vmc.py:238-240``); this grid variant completes it.
        The unshifted per-particle log sums (one-body orbital plus the
        row sums of the pair matrix) are shared across every offset, so
        each extra grid point costs ONE pair-log pass over the shifted
        distances ``|z_ij + sz|`` instead of a full ratio evaluation.
        """
        out_shape = pos.shape[:-1] + (szs.shape[0],)
        if is_free and is_ideal:
            return jnp.ones(out_shape, dtype=pos.dtype)
        sc = _supercell(cfc)
        base = jnp.zeros(pos.shape, dtype=pos.dtype)
        d0 = off_diag = None
        if not is_free:
            base = base + jnp.log(jnp.abs(one_body(pos, cfc)))
        if not is_ideal:
            # Raw differences (bounded by (-L, L)); min-image applies
            # per offset AFTER the shift.
            d0 = pos[..., :, None] - pos[..., None, :]
            off_diag = ~jnp.eye(nop, dtype=bool)
            r = jnp.where(off_diag, jnp.abs(min_image_bounded(d0, sc)),
                          0.25 * sc)
            log_tb, _, _ = two_body_pair_terms(r, cfc, need_log=True,
                                               need_derivs=False)
            base = base + jnp.where(off_diag, log_tb, 0.0).sum(axis=-1)

        def at_offset(sz):
            num = jnp.zeros(pos.shape, dtype=pos.dtype)
            if not is_free:
                num = num + jnp.log(jnp.abs(one_body(pos + sz, cfc)))
            if not is_ideal:
                d_s = min_image(d0 + sz, sc)
                r_s = jnp.where(off_diag, jnp.abs(d_s), 0.25 * sc)
                log_tb_s, _, _ = two_body_pair_terms(
                    r_s, cfc, need_log=True, need_derivs=False)
                num = num + jnp.where(off_diag, log_tb_s,
                                      0.0).sum(axis=-1)
            return jnp.exp(num - base).sum(axis=-1) / nop

        szs_arr = jnp.asarray(szs)
        num_offsets = szs_arr.shape[0]
        # Each offset costs one (batch, N, N) shifted-pair pass; vmap
        # over ALL offsets at once materializes (M, batch, N, N)
        # temporaries — 8.6 GB at 16k walkers x N=64 x 32 offsets,
        # which kills compilation.  Chunk the offset axis under the
        # same element budget as the walker tiling.
        batch = 1
        for dim in pos.shape[:-1]:
            batch *= int(dim)
        per_offset = max(1, batch * nop * nop)
        chunk = max(1, min(num_offsets, PAIR_TILE_ELEMS // per_offset))
        if chunk >= num_offsets:
            return jax.vmap(at_offset, out_axes=-1)(szs_arr)
        pad = (-num_offsets) % chunk
        szs_pad = jnp.concatenate(
            [szs_arr, jnp.zeros((pad,), szs_arr.dtype)])
        groups = szs_pad.reshape(-1, chunk)
        out = jax.lax.map(
            lambda g: jax.vmap(at_offset, out_axes=-1)(g), groups)
        out = jnp.moveaxis(out, 0, -2).reshape(pos.shape[:-1] + (-1,))
        return out[..., :num_offsets]

    # -- Fourier density ---------------------------------------------------
    def fourier_density(kz, pos, cfc: CFCParams):
        """Fourier component of the density, ``rho_k = sum_i e^{i k z_i}``
        (reference ``qmc_base/jastrow/model.py:967-1004``).

        ``kz``: ``(M,)`` momenta; ``pos``: ``(..., N)``.  Returns complex
        ``(..., M)``.
        """
        phase = pos[..., :, None] * kz  # (..., N, M)
        return (jnp.cos(phase).sum(axis=-2)
                + 1j * jnp.sin(phase).sum(axis=-2))

    def fourier_density_parts(kz, pos, cfc: CFCParams):
        """``(|rho_k|^2, Re rho_k, Im rho_k)`` stacked on the last axis,
        shape ``(..., M, 3)`` - the three S(k) accumulator slots
        (reference ``qmc_base/vmc.py:62-74``)."""
        phase = pos[..., :, None] * kz
        re = jnp.cos(phase).sum(axis=-2)
        im = jnp.sin(phase).sum(axis=-2)
        return jnp.stack([re ** 2 + im ** 2, re, im], axis=-1)

    def _fourier_harmonics_scan(num_modes: int, pos, cfc: CFCParams,
                                mode_sums):
        """Shared Chebyshev-recurrence driver for the harmonic momenta
        ``k_j = j * 2 pi / L``, ``j = 0..num_modes-1``: evaluates
        ``mode_sums(cos(j theta), sin(j theta))`` per mode with ONE
        sincos on ``(..., N)`` plus two fmas per extra mode (see
        :func:`fourier_density_parts_harmonics` for the measurement
        notes).  ``mode_sums`` must reduce the particle axis and stack
        its outputs on a trailing axis."""
        theta = (2 * jnp.pi / _supercell(cfc)) * pos
        c1 = jnp.cos(theta)
        s1 = jnp.sin(theta)
        ones = jnp.ones_like(theta)
        zeros = jnp.zeros_like(theta)

        def body(carry, _):
            c_prev, c_prev2, s_prev, s_prev2 = carry
            c = 2 * c1 * c_prev - c_prev2
            s = 2 * c1 * s_prev - s_prev2
            return (c, c_prev, s, s_prev), mode_sums(c, s)

        parts0 = mode_sums(ones, zeros)
        if num_modes == 1:
            return parts0[..., None, :]
        parts1 = mode_sums(c1, s1)
        if num_modes == 2:
            return jnp.stack([parts0, parts1], axis=-2)
        _, rest = jax.lax.scan(body, (c1, ones, s1, zeros), None,
                               length=num_modes - 2, unroll=4)
        # scan stacks on axis 0: move modes next to the parts axis.
        rest = jnp.moveaxis(rest, 0, -2)
        return jnp.concatenate(
            [parts0[..., None, :], parts1[..., None, :], rest], axis=-2)

    def fourier_density_parts_harmonics(num_modes: int, pos,
                                        cfc: CFCParams):
        """S(k) parts for the harmonic momenta ``k_j = j * 2 pi / L``,
        ``j = 0..num_modes-1`` (the momenta every sampler uses,
        ``mrbp_qmc/vmc.py:129-143``).

        Uses the Chebyshev recurrence ``cos((j+1)t) = 2 cos t cos(jt) -
        cos((j-1)t)`` (same for sin): ONE sincos on ``(..., N)`` plus two
        fmas per extra mode, instead of a sincos on ``(..., N, M)`` -
        ~M-fold fewer transcendentals in the estimator hot path.
        The mode scan runs with ``unroll=4``: the pass re-reads
        ``(cos t, sin t)`` and the four carries each mode, and fusing
        4 modes per pass cuts that memory traffic.  Returns
        ``(..., num_modes, 3)``.
        """
        def mode_sums(c, s):
            re = c.sum(axis=-1)
            im = s.sum(axis=-1)
            return jnp.stack([re ** 2 + im ** 2, re, im], axis=-1)

        return _fourier_harmonics_scan(num_modes, pos, cfc, mode_sums)

    def fourier_density_reim_harmonics(num_modes: int, pos,
                                       cfc: CFCParams):
        """Per-configuration ``(Re rho_k, Im rho_k)`` for the harmonic
        momenta, shape ``(..., num_modes, 2)`` — the raw complex
        amplitude the imaginary-time correlation estimator tags each
        walker with (the S(k) kernel above folds these into the three
        accumulator slots; this variant keeps the amplitude itself so
        two-time products ``rho_k(t + tau) rho_k(t)^*`` can be formed
        along the branching ancestry).  Same Chebyshev recurrence and
        particle-sum order as the S(k) kernel, so its ``re``/``im``
        match that kernel's slots 1-2 exactly.  No reference analog
        (the reference has no imaginary-time correlation machinery).
        """
        def mode_sums(c, s):
            re = c.sum(axis=-1)
            im = s.sum(axis=-1)
            return jnp.stack([re, im], axis=-1)

        return _fourier_harmonics_scan(num_modes, pos, cfc, mode_sums)

    # -- pair-distance histogram (direct g2 estimator) ---------------------
    def pair_dist_histogram(num_bins: int, pos, cfc: CFCParams):
        """Per-walker histogram of unordered-pair minimum-image
        distances over ``num_bins`` uniform bins spanning ``[0, L/2]``
        — the direct pair-correlation estimator's per-configuration
        value.  ``pos``: ``(..., N)``; returns ``(..., num_bins)``
        exact counts (each unordered pair counted once), so after
        weighted averaging ``g2(r) = <counts(r)> * L / (N (N-1) dr)``
        (normalized to 1 for uncorrelated uniform positions).

        The reference has no direct pair-correlation estimator — g2 is
        only reachable there by Fourier-inverting the truncated S(k)
        (cf. ``analysis.pair_correlation_from_ssf``); this kernel gives
        the real-space histogram exactly, with no mode cutoff.  Counts
        use the factorized one-hot histogram (``ops/histogram.py``)
        over the ``(.., N, N)`` distance matrix: the N exact-zero
        diagonal entries land in bin 0 and are subtracted, and the
        double-counted unordered pairs are halved — both exact in
        float arithmetic (counts are small integers).
        """
        if nop < 2:
            return jnp.zeros(pos.shape[:-1] + (num_bins,),
                             dtype=pos.dtype)

        def one(p, cfc):
            sc = _supercell(cfc)
            d = p[..., :, None] - p[..., None, :]
            r = jnp.abs(min_image_bounded(d, sc))  # diagonal exactly 0
            bin_size = 0.5 * sc / num_bins
            hist = _hist_ops.walker_histogram(r, bin_size, num_bins)
            hist = hist.sum(axis=-2)  # over i -> (..., num_bins)
            diag = jnp.zeros((num_bins,), dtype=hist.dtype)
            diag = diag.at[0].set(nop)
            return 0.5 * (hist - diag)

        # The one-hot factors cost (q + r) extra columns per matrix
        # entry, so tile tighter than the plain pairwise budget by
        # exactly that width (r_split=32 is walker_histogram_mxu's
        # default coarse/fine split).
        r_cols = min(32, num_bins)
        q_cols = -(-num_bins // r_cols)
        return _tiled_over_walkers(one, cost=q_cols + r_cols)(pos, cfc)

    return SimpleNamespace(
        log_psi=_tiled_over_walkers(log_psi),
        log_psi_and_energy=_tiled_over_walkers(log_psi_and_energy),
        energy=_tiled_over_walkers(energy),
        drift=_tiled_over_walkers(drift),
        energy_and_drift=_tiled_over_walkers(energy_and_drift),
        wf_abs=wf_abs,
        delta_log_psi_move=delta_log_psi_move,
        delta_drift_move=delta_drift_move,
        one_body_density=one_body_density,
        one_body_density_grid=one_body_density_grid,
        fourier_density=fourier_density,
        fourier_density_parts=fourier_density_parts,
        fourier_density_parts_harmonics=fourier_density_parts_harmonics,
        fourier_density_reim_harmonics=fourier_density_reim_harmonics,
        pair_dist_histogram=pair_dist_histogram,
        is_free=is_free,
        is_ideal=is_ideal,
        boson_number=boson_number,
    )
