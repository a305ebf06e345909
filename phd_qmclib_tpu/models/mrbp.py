"""Multi-rod Bloch-phonon (mrbp) QMC model.

A 1D Bose gas with repulsive contact interactions in a multi-rod
(Kronig-Penney) optical lattice, with a Bijl-Jastrow trial wavefunction:

* one-body factor: the exact single-particle KP band-bottom orbital
  (piecewise cos in the wells / cosh in the barriers),
* two-body factor: the phonon-like pair function ``am*cos(k2(r-r_off))``
  inside a variational cutoff ``rm`` matched to ``sin(pi r/L)^beta``
  outside.

JAX re-design of the reference model
(``/root/reference/src/phd_qmclib/mrbp_qmc/model.py``): the spec is a
frozen host-side dataclass whose derived parameters (ideal-gas band
energy, two-body matching constants solved with ``brentq``) are computed
once on CPU; the kernels are pure batched JAX functions produced by
:func:`phd_qmclib_tpu.models.jastrow.build_core_funcs`.
"""
import functools
import math
import typing as t
from dataclasses import dataclass, field, replace
from enum import Enum
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import brentq

from .. import ideal
from ..ops import trig
from ..ops.pbc import recast_to_supercell
from . import jastrow
from .jastrow import CFCParams, SysConfSlot

__all__ = [
    "CFCParams",
    "ModelParams",
    "OBFParams",
    "Spec",
    "StaticSpec",
    "SysConfDistType",
    "SysConfSlot",
    "TBFParams",
    "cfc_params_device",
    "core_funcs",
    "tbf_params_device",
    "DIST_RAND",
    "DIST_REGULAR",
]


class SysConfDistType(Enum):
    """Initial-configuration arrangements (reference
    ``qmc_base/jastrow/model.py:41-45``)."""
    RANDOM = "random"
    REGULAR = "regular"


DIST_RAND = SysConfDistType.RANDOM
DIST_REGULAR = SysConfDistType.REGULAR


class ModelParams(t.NamedTuple):
    """Continuous model parameters (pytree leaf group).

    Mirrors the reference ``Params`` (``mrbp_qmc/model.py:40-54``) minus
    the static fields (``boson_number``, ``defects_sep``, ``is_free``,
    ``is_ideal``) which live in :class:`StaticSpec`.
    """
    lattice_depth: float
    lattice_ratio: float
    interaction_strength: float
    supercell_size: float
    tbf_contact_cutoff: float
    defect_magnitude: float
    well_width: float
    barrier_width: float


class OBFParams(t.NamedTuple):
    """One-body function parameters (``mrbp_qmc/model.py:57-65``)."""
    lattice_depth: float
    lattice_ratio: float
    well_width: float
    barrier_width: float
    param_e0: float
    param_k1: float
    param_kp1: float


class TBFParams(t.NamedTuple):
    """Two-body function parameters (``mrbp_qmc/model.py:68-75``)."""
    supercell_size: float
    tbf_contact_cutoff: float
    param_k2: float
    param_beta: float
    param_r_off: float
    param_am: float


class StaticSpec(t.NamedTuple):
    """Compile-time model structure: baked into the traced kernels."""
    boson_number: int
    defects_sep: int
    is_free: bool
    is_ideal: bool


@dataclass(frozen=True)
class Spec:
    """The parameters of the Bloch-Phonon QMC model.

    Field-for-field equivalent of the reference attrs spec
    (``mrbp_qmc/model.py:134-196``), including the defect handling in the
    post-init stage and the domain validators.
    """
    #: The lattice depth of the potential.
    lattice_depth: float
    #: The ratio of the barriers width between the wells width.
    lattice_ratio: float
    #: The magnitude of the interaction strength between two bosons.
    interaction_strength: float
    #: The number of bosons.
    boson_number: int
    #: The size of the QMC simulation box.
    supercell_size: float
    #: The variational parameter of the two-body functions.
    tbf_contact_cutoff: float
    #: Number of defects, evenly spaced.
    num_defects: t.Optional[int] = None
    #: Magnitude for all the defects.
    defect_magnitude: t.Optional[float] = None
    #: Variational TRIAL-ORBITAL lattice depth: the one-body Bloch
    #: orbital solves the KP band problem at THIS depth while the
    #: Hamiltonian keeps ``lattice_depth`` — a second variational
    #: parameter beyond the reference, whose optimizer caps at the
    #: single ``rm`` knob (``mrbp_qmc/model.py:902-942``).  The
    #: kernels already read every orbital quantity from ``OBFParams``
    #: and the potential from ``ModelParams``, so the split is exact
    #: (variational principle intact for any positive value).
    #: ``None`` (default) ties the orbital to the physical depth.
    obf_lattice_depth: t.Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "lattice_depth", float(self.lattice_depth))
        object.__setattr__(self, "lattice_ratio", float(self.lattice_ratio))
        object.__setattr__(self, "interaction_strength",
                           float(self.interaction_strength))
        object.__setattr__(self, "boson_number", int(self.boson_number))
        object.__setattr__(self, "supercell_size",
                           float(self.supercell_size))
        object.__setattr__(self, "tbf_contact_cutoff",
                           float(self.tbf_contact_cutoff))

        if not abs(self.tbf_contact_cutoff) <= abs(self.supercell_size / 2):
            raise ValueError("tbf_contact_cutoff (rm) lies outside its allowed range")

        if self.obf_lattice_depth is not None:
            v0b = float(self.obf_lattice_depth)
            object.__setattr__(self, "obf_lattice_depth", v0b)
            if self.is_free:
                raise ValueError(
                    "obf_lattice_depth needs a finite lattice (the "
                    "free-gas trial orbital is flat)")
            if v0b <= 0:
                raise ValueError("obf_lattice_depth must be positive")

        # Defect handling: reference ``mrbp_qmc/model.py:174-196``.
        lattice_depth = self.lattice_depth
        num_defects = self.num_defects
        defect_magnitude = self.defect_magnitude
        if defect_magnitude is None and num_defects is None:
            object.__setattr__(self, "defect_magnitude", lattice_depth)
            object.__setattr__(self, "num_defects", 0)
        else:
            if num_defects is None:
                num_defects = 0
                defect_magnitude = lattice_depth
            else:
                num_defects = int(num_defects)
                defect_magnitude = (float(defect_magnitude)
                                    if num_defects and
                                    defect_magnitude is not None
                                    else lattice_depth)
            if num_defects < 0:
                raise ValueError("num_defects must be zero or positive")
            num_sites = int(math.ceil(self.supercell_size))
            if num_defects and (num_sites % num_defects):
                raise ValueError(
                    f"num_defects ({num_defects:d}) does not divide the "
                    f"lattice into equal defect spacings")
            if defect_magnitude > lattice_depth:
                raise ValueError("defect_magnitude must not exceed "
                                 "lattice_depth")
            object.__setattr__(self, "defect_magnitude", defect_magnitude)
            object.__setattr__(self, "num_defects", num_defects)

    # -- derived geometry ---------------------------------------------------

    @property
    def boundaries(self) -> t.Tuple[float, float]:
        return 0.0, 1.0 * self.supercell_size

    @property
    def well_width(self) -> float:
        r = self.lattice_ratio
        return 1 / (1 + r)

    @property
    def barrier_width(self) -> float:
        r = self.lattice_ratio
        return r / (1 + r)

    @property
    def is_free(self) -> bool:
        """Free system: vanishing lattice (``mrbp_qmc/model.py:217-227``)."""
        return self.lattice_depth <= 1e-10 or self.lattice_ratio <= 1e-10

    @property
    def is_ideal(self) -> bool:
        """Ideal system: vanishing interaction
        (``mrbp_qmc/model.py:229-235``)."""
        return self.interaction_strength <= 1e-10

    @property
    def defects_sep(self) -> int:
        num_sites = int(math.ceil(self.supercell_size))
        num_defects = self.num_defects
        return 1 if not num_defects else int(num_sites // num_defects)

    @property
    def sys_conf_shape(self) -> t.Tuple[int, int]:
        """Shape of a packed (pos, drift) configuration buffer."""
        return 2, self.boson_number

    def get_sys_conf_buffer(self) -> np.ndarray:
        return np.zeros(self.sys_conf_shape, dtype=np.float64)

    def init_get_sys_conf(self, dist_type=DIST_RAND, offset=None,
                          rng: t.Optional[np.random.Generator] = None) \
            -> np.ndarray:
        """Initial particle configuration, random or regular.

        Reference: ``mrbp_qmc/model.py:248-273`` (adds an optional
        explicit ``rng`` for reproducibility).
        """
        nop = self.boson_number
        sc_size = self.supercell_size
        z_min, _ = self.boundaries
        sys_conf = self.get_sys_conf_buffer()
        offset = offset or 0.0

        if dist_type is DIST_RAND:
            rng = rng if rng is not None else np.random.default_rng()
            spread = sc_size * rng.random(nop)
        elif dist_type is DIST_REGULAR:
            spread = np.linspace(0, sc_size, nop, endpoint=False)
        else:
            raise ValueError(f"unrecognized '{dist_type}' dist_type")

        sys_conf[SysConfSlot.pos, :] = z_min + (offset + spread) % sc_size
        return sys_conf

    # -- derived parameters ---------------------------------------------------

    @property
    def static_spec(self) -> StaticSpec:
        return StaticSpec(self.boson_number, self.defects_sep,
                          self.is_free, self.is_ideal)

    @property
    def params(self) -> ModelParams:
        return ModelParams(self.lattice_depth,
                           self.lattice_ratio,
                           self.interaction_strength,
                           self.supercell_size,
                           self.tbf_contact_cutoff,
                           self.defect_magnitude,
                           self.well_width,
                           self.barrier_width)

    @cached_property
    def obf_params(self) -> OBFParams:
        """One-body orbital parameters: solves the ideal KP band problem
        (``mrbp_qmc/model.py:297-315``) — at the variational
        ``obf_lattice_depth`` when one is set (the Hamiltonian's
        potential stays at ``lattice_depth``; see the field doc)."""
        v0 = (self.obf_lattice_depth
              if self.obf_lattice_depth is not None
              else self.lattice_depth)
        r = self.lattice_ratio
        if self.is_free:
            e0 = 0.0
            k1, kp1 = 0.0, 0.0
        else:
            e0 = float(ideal.eigen_energy(v0, r))
            k1, kp1 = math.sqrt(e0), math.sqrt(v0 - e0)
        return OBFParams(v0,
                         self.lattice_ratio,
                         self.well_width,
                         self.barrier_width,
                         param_e0=e0,
                         param_k1=k1,
                         param_kp1=kp1)

    @cached_property
    def tbf_params(self) -> TBFParams:
        """Two-body function parameters.

        Maps the interaction strength to the Lieb-Liniger gamma, solves
        the transcendental local-energy matching condition at the cutoff
        ``rm`` with ``brentq``, and derives ``k2, beta, r_off, am``.
        Reference: ``mrbp_qmc/model.py:317-393``.
        """
        gn = self.interaction_strength
        nop = self.boson_number
        sc_size = self.supercell_size
        rm = self.tbf_contact_cutoff

        if not abs(rm) <= abs(sc_size / 2):
            raise ValueError("tbf_contact_cutoff (rm) lies outside its allowed range")

        if gn == 0:
            return TBFParams(sc_size, rm, param_k2=0.0, param_beta=0.0,
                             param_r_off=0.5 * sc_size, param_am=1.0)

        # Interaction energy -> Lieb gamma.
        lgm = 0.5 * (sc_size / nop) ** 2 * gn
        # Following equations use rm in simulation-box units.
        rm = rm / sc_size
        # One-dimensional scattering length (the factor 2 keeps
        # consistency with Lieb-Liniger theory).
        a1d = 2.0 / (lgm * nop)

        tan, sin, cos, pi = math.tan, math.sin, math.cos, math.pi

        def _nonlinear_equation(k2rm: float) -> float:
            if k2rm == 0:
                beta_rm = tan(pi * rm) / pi
            else:
                beta_rm = (k2rm / pi * (rm - k2rm * a1d * tan(k2rm))
                           * tan(pi * rm)
                           / (k2rm * a1d + rm * tan(k2rm)))
            # Equality of the local energy at ``rm``.
            return ((k2rm * sin(pi * rm)) ** 2
                    + (pi * beta_rm * cos(pi * rm)) ** 2
                    - pi ** 2 * beta_rm * rm)

        k2rm: float = brentq(_nonlinear_equation, 0, pi / 2)

        beta_rm = (k2rm / pi * (rm - k2rm * a1d * tan(k2rm)) * tan(pi * rm)
                   / (k2rm * a1d + rm * tan(k2rm)))

        k2 = k2rm / rm
        k2r_off = math.atan(1 / (k2 * a1d))
        beta = beta_rm / rm
        r_off = k2r_off / k2
        am = sin(pi * rm) ** beta / cos(k2rm - k2r_off)

        # Momentum and length returned in lattice-period units.
        return TBFParams(sc_size,
                         self.tbf_contact_cutoff,
                         param_k2=k2 / sc_size,
                         param_beta=beta,
                         param_r_off=r_off * sc_size,
                         param_am=am)

    @property
    def cfc_params(self) -> CFCParams:
        return CFCParams(self.params, self.obf_params, self.tbf_params)

    # Alias kept for reference-API familiarity.
    cfc_spec = cfc_params

    def evolve(self, **changes) -> "Spec":
        """A new spec with the given fields replaced (attrs.evolve
        analog used by the wavefunction optimizer,
        ``mrbp_qmc/model.py:852-861``)."""
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# Differentiable two-body parameter solve.  The host-side
# ``Spec.tbf_params`` goes through ``scipy.optimize.brentq``, which blocks
# gradients; this traceable version solves the same matching condition with
# ``lax.custom_root`` (implicit differentiation), making ``rm -> TBFParams``
# - and therefore the whole correlated-sampling variance functional -
# differentiable.  The reference has no analog (its optimizer is the
# derivative-free ``differential_evolution``, ``mrbp_qmc/model.py:927-942``).
# ---------------------------------------------------------------------------

def _tbf_matching_residual(k2rm, rm_frac, a1d):
    """Local-energy matching condition at the cutoff, in box units.

    Same transcendental equation as ``Spec.tbf_params``'s
    ``_nonlinear_equation`` (reference ``mrbp_qmc/model.py:345-369``),
    written with jnp ops so it traces and differentiates.
    """
    pi = jnp.pi
    tan_k = jnp.tan(k2rm)
    beta_rm = (k2rm / pi * (rm_frac - k2rm * a1d * tan_k)
               * jnp.tan(pi * rm_frac)
               / (k2rm * a1d + rm_frac * tan_k))
    return ((k2rm * jnp.sin(pi * rm_frac)) ** 2
            + (pi * beta_rm * jnp.cos(pi * rm_frac)) ** 2
            - pi ** 2 * beta_rm * rm_frac)


def tbf_params_device(rm, interaction_strength, boson_number,
                      supercell_size) -> TBFParams:
    """Traceable, differentiable ``rm -> TBFParams``.

    Bisection (fixed iteration count, so it vmaps and jits) solves the
    matching condition on ``(0, pi/2)`` exactly like the host ``brentq``
    path; ``lax.custom_root`` supplies the implicit-function-theorem
    gradient, so ``jax.grad`` through the returned pytree is exact.
    Matches ``Spec.tbf_params`` to solver tolerance (tested in
    ``tests/models/test_tbf_device.py``).  Requires
    ``interaction_strength > 0`` (the free-gas branch is not traceable).
    """
    from jax import lax

    dtype = jnp.result_type(rm, jnp.float32)
    rm = jnp.asarray(rm, dtype)
    gn = jnp.asarray(interaction_strength, dtype)
    sc_size = jnp.asarray(supercell_size, dtype)
    nop = boson_number

    pi = jnp.pi
    lgm = 0.5 * (sc_size / nop) ** 2 * gn
    rm_frac = rm / sc_size
    a1d = 2.0 / (lgm * nop)

    def residual(k2rm):
        return _tbf_matching_residual(k2rm, rm_frac, a1d)

    eps = jnp.asarray(1e-9 if dtype == jnp.float64 else 1e-5, dtype)

    def solve(f, x0):
        lo = eps
        hi = pi / 2 - eps
        f_lo = f(lo)
        num_iters = 100 if dtype == jnp.float64 else 40

        def body(_, carry):
            lo, hi, f_lo = carry
            mid = 0.5 * (lo + hi)
            f_mid = f(mid)
            same = jnp.sign(f_mid) == jnp.sign(f_lo)
            return (jnp.where(same, mid, lo),
                    jnp.where(same, hi, mid),
                    jnp.where(same, f_mid, f_lo))

        lo, hi, _ = lax.fori_loop(0, num_iters, body, (lo, hi, f_lo))
        return 0.5 * (lo + hi)

    def tangent_solve(g, y):
        # Scalar linear solve: g is linear, so g(x) = g(1)*x.
        return y / g(jnp.asarray(1.0, dtype))

    k2rm = lax.custom_root(residual, jnp.asarray(pi / 4, dtype),
                           solve, tangent_solve)

    tan_k = jnp.tan(k2rm)
    beta_rm = (k2rm / pi * (rm_frac - k2rm * a1d * tan_k)
               * jnp.tan(pi * rm_frac)
               / (k2rm * a1d + rm_frac * tan_k))
    k2 = k2rm / rm_frac
    k2r_off = jnp.arctan(1.0 / (k2 * a1d))
    beta = beta_rm / rm_frac
    r_off = k2r_off / k2
    am = jnp.sin(pi * rm_frac) ** beta / jnp.cos(k2rm - k2r_off)

    return TBFParams(sc_size, rm,
                     param_k2=k2 / sc_size,
                     param_beta=beta,
                     param_r_off=r_off * sc_size,
                     param_am=am)


def _kp_band_residual(ez, v0, rr_frac, inv_1pr):
    """KP band-bottom dispersion relation ``f(E; k = 0) = 0`` in jnp
    ops (the general ``0 < E < v0`` branch of
    :func:`phd_qmclib_tpu.ideal.energy_relation`), traceable and
    differentiable in both ``ez`` and ``v0``."""
    root_e = jnp.sqrt(ez)
    root_d = jnp.sqrt(v0 - ez)
    return ((v0 - 2.0 * ez) / (2.0 * root_e * root_d)
            * jnp.sinh(rr_frac * root_d) * jnp.sin(root_e * inv_1pr)
            + jnp.cosh(rr_frac * root_d) * jnp.cos(root_e * inv_1pr)
            - 1.0)


def obf_params_device(obf_lattice_depth, spec: "Spec") -> OBFParams:
    """Traceable, differentiable ``v0_orbital -> OBFParams``.

    The KP band bottom ``e0(v0)`` solves by fixed-count bisection on
    ``(0, min(v0, (1+r)^2 pi^2))`` exactly like the host ``brentq``
    path (:func:`phd_qmclib_tpu.ideal.eigen_energy`);
    ``lax.custom_root`` supplies the implicit-function-theorem
    gradient, so the variance functional differentiates through the
    variational TRIAL-ORBITAL depth (second optimizer knob — the
    reference caps at ``rm``, ``mrbp_qmc/model.py:902-942``).
    Requires a non-free lattice.
    """
    from jax import lax

    dtype = jnp.result_type(obf_lattice_depth, jnp.float32)
    v0 = jnp.asarray(obf_lattice_depth, dtype)
    r = spec.lattice_ratio
    rr_frac = jnp.asarray(r / (1.0 + r), dtype)
    inv_1pr = jnp.asarray(1.0 / (1.0 + r), dtype)

    def residual(ez):
        return _kp_band_residual(ez, v0, rr_frac, inv_1pr)

    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-6, dtype)
    upper = jnp.minimum(v0, (1.0 + r) ** 2 * jnp.pi ** 2)

    def solve(f, x0):
        lo = eps * upper
        hi = (1.0 - eps) * upper
        f_lo = f(lo)
        num_iters = 100 if dtype == jnp.float64 else 40

        def body(_, carry):
            lo, hi, f_lo = carry
            mid = 0.5 * (lo + hi)
            f_mid = f(mid)
            same = jnp.sign(f_mid) == jnp.sign(f_lo)
            return (jnp.where(same, mid, lo),
                    jnp.where(same, hi, mid),
                    jnp.where(same, f_mid, f_lo))

        lo, hi, _ = lax.fori_loop(0, num_iters, body, (lo, hi, f_lo))
        return 0.5 * (lo + hi)

    def tangent_solve(g, y):
        return y / g(jnp.asarray(1.0, dtype))

    e0 = lax.custom_root(residual, 0.5 * upper, solve, tangent_solve)
    return OBFParams(v0,
                     jnp.asarray(r, dtype),
                     jnp.asarray(spec.well_width, dtype),
                     jnp.asarray(spec.barrier_width, dtype),
                     param_e0=e0,
                     param_k1=jnp.sqrt(e0),
                     param_kp1=jnp.sqrt(v0 - e0))


def cfc_params_device(rm, spec: "Spec",
                      obf_lattice_depth=None) -> CFCParams:
    """Traceable ``CFCParams`` with the variational cutoff ``rm`` (and
    optionally the trial-orbital depth) live.

    One-body parameters come from the host spec unless a traced
    ``obf_lattice_depth`` is given (then :func:`obf_params_device`
    re-solves the band problem on device); the two-body parameters are
    always re-solved on device so gradients flow (used by
    :class:`phd_qmclib_tpu.wf_opt.GradCSWFOptimizer`).
    """
    dtype = jnp.result_type(rm, jnp.float32)
    model_params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype), spec.params)
    model_params = model_params._replace(
        tbf_contact_cutoff=jnp.asarray(rm, dtype))
    if obf_lattice_depth is None:
        obf = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, dtype), spec.obf_params)
    else:
        obf = obf_params_device(obf_lattice_depth, spec)
        obf = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, dtype), obf)
    tbf = tbf_params_device(rm, spec.interaction_strength,
                            spec.boson_number, spec.supercell_size)
    return CFCParams(model_params, obf, tbf)


# ---------------------------------------------------------------------------
# Analytic kernel functions.  All are vectorized over ``z``/``rz`` and take
# the full CFCParams pytree (reference scalar versions:
# ``mrbp_qmc/model.py:403-562``).
# ---------------------------------------------------------------------------

def _cell_geometry(z, cfc: CFCParams):
    obf = cfc.obf_params
    z_cell = jnp.mod(z, 1.0)
    z_a = obf.well_width
    z_b = obf.barrier_width
    return z_cell, z_a, z_b


def _one_body(z, cfc: CFCParams):
    """Piecewise KP band-bottom orbital (``mrbp_qmc/model.py:403-425``)."""
    obf = cfc.obf_params
    v0, e0 = obf.lattice_depth, obf.param_e0
    k1, kp1 = obf.param_k1, obf.param_kp1
    z_cell, z_a, z_b = _cell_geometry(z, cfc)
    barrier = jnp.cosh(kp1 * (z_cell - 1.0 + 0.5 * z_b))
    cf = jnp.sqrt(1 + v0 / e0 * jnp.sinh(0.5 * jnp.sqrt(v0 - e0) * z_b) ** 2)
    well = cf * jnp.cos(k1 * (z_cell - 0.5 * z_a))
    return jnp.where(z_a < z_cell, barrier, well)


def _one_body_log_dz(z, cfc: CFCParams):
    """``f1'/f1`` (``mrbp_qmc/model.py:428-447``)."""
    obf = cfc.obf_params
    k1, kp1 = obf.param_k1, obf.param_kp1
    z_cell, z_a, z_b = _cell_geometry(z, cfc)
    barrier = kp1 * jnp.tanh(kp1 * (z_cell - 1.0 + 0.5 * z_b))
    well = -k1 * jnp.tan(k1 * (z_cell - 0.5 * z_a))
    return jnp.where(z_a < z_cell, barrier, well)


def _one_body_log_dz2(z, cfc: CFCParams):
    """``f1''/f1``: ``v0 - e0`` in barriers, ``-e0`` in wells
    (``mrbp_qmc/model.py:450-464``)."""
    obf = cfc.obf_params
    v0, e0 = obf.lattice_depth, obf.param_e0
    z_cell, z_a, _ = _cell_geometry(z, cfc)
    return jnp.where(z_a < z_cell, v0 - e0, -e0)


def _two_body(rz, cfc: CFCParams):
    """Phonon-like pair function (``mrbp_qmc/model.py:467-486``)."""
    tbf = cfc.tbf_params
    sc_size, rm = tbf.supercell_size, tbf.tbf_contact_cutoff
    k2, beta = tbf.param_k2, tbf.param_beta
    r_off, am = tbf.param_r_off, tbf.param_am
    in_cutoff = rz < jnp.abs(rm)
    # Guard the unselected branch argument (safe-where): keeps values and
    # gradients finite where the branch is masked out.
    rz_out = jnp.where(in_cutoff, jnp.abs(rm), rz)
    inside = am * jnp.cos(k2 * (rz - r_off))
    outside = jnp.sin(jnp.pi * rz_out / sc_size) ** beta
    return jnp.where(in_cutoff, inside, outside)


def _two_body_log_dz(rz, cfc: CFCParams):
    """``f2'/f2`` (``mrbp_qmc/model.py:489-507``)."""
    tbf = cfc.tbf_params
    sc_size, rm = tbf.supercell_size, tbf.tbf_contact_cutoff
    k2, beta, r_off = tbf.param_k2, tbf.param_beta, tbf.param_r_off
    in_cutoff = rz < jnp.abs(rm)
    rz_out = jnp.where(in_cutoff, jnp.abs(rm), rz)
    inside = -k2 * jnp.tan(k2 * (rz - r_off))
    outside = (jnp.pi / sc_size) * beta / jnp.tan(jnp.pi * rz_out / sc_size)
    return jnp.where(in_cutoff, inside, outside)


def _two_body_log_dz2(rz, cfc: CFCParams):
    """``f2''/f2`` (``mrbp_qmc/model.py:510-529``)."""
    tbf = cfc.tbf_params
    sc_size, rm = tbf.supercell_size, tbf.tbf_contact_cutoff
    k2, beta = tbf.param_k2, tbf.param_beta
    in_cutoff = rz < jnp.abs(rm)
    rz_out = jnp.where(in_cutoff, jnp.abs(rm), rz)
    inside = -k2 * k2 * jnp.ones_like(rz)
    tan_term = jnp.tan(jnp.pi * rz_out / sc_size)
    outside = ((jnp.pi / sc_size) ** 2 * beta
               * ((beta - 1) / tan_term ** 2 - 1))
    return jnp.where(in_cutoff, inside, outside)


# Reduced-range trig polynomials (see ops/trig.py for the coefficient
# provenance and accuracy measurements).
_sincos_poly32 = trig.sincos_poly32
_tancot_poly32 = trig.tancot_poly32


def _two_body_pair_terms(rz, cfc: CFCParams, need_log: bool = True,
                         need_derivs: bool = True,
                         need_kin: bool = False):
    """Fused ``(log|f2|, f2'/f2, f2''/f2)`` with ONE sincos per pair.

    With ``need_kin`` the third slot returns the per-pair kinetic term
    ``-f2''/f2 + (f2'/f2)^2`` directly instead of ``f2''/f2``, via the
    branch-uniform identity (both branches are trig)::

        inside : k2^2 (1 + tan^2)   = -(-k2^2) + (k2 tan)^2
        outside: (pi/L)^2 b (1+cot^2) = -((pi/L)^2 b((b-1)cot^2-1))
                                        + ((pi/L) b cot)^2

    i.e. ``kin = C (1 + v^2)`` with one branch-selected constant -
    three fewer arithmetic ops per pair than assembling
    ``-ldz2 + ldz^2`` from the separate pieces in the O(N^2) hot loop.

    Both branches of the phonon pair function are trigonometric:
    ``f2 = am*cos(k2(r - r_off))`` inside the cutoff and
    ``sin(pi r/L)^beta`` outside.  Evaluating sin/cos of the *selected*
    argument yields every needed quantity::

        inside : ldz = -k2 s/c,           ldz2 = -k2^2,
                 log f2 = log|am| + log|c|
        outside: ldz = (pi/L) beta c/s,   ldz2 = (pi/L)^2 beta
                 ((beta-1)(c/s)^2 - 1),   log f2 = beta log(s)

    versus two tan's, one cos and one pow for the separate reference
    kernels (``mrbp_qmc/model.py:467-529``) - a ~2-3x cut of the
    transcendental work that dominates the O(N^2) DMC/VMC hot loop.
    The outside branch is singularity-free for minimum-image distances
    (``theta = pi r/L`` stays in ``(0, pi/2]``); unselected branches are
    neutralized for value and gradient safety.
    """
    tbf = cfc.tbf_params
    sc_size, rm = tbf.supercell_size, tbf.tbf_contact_cutoff
    k2, beta = tbf.param_k2, tbf.param_beta
    r_off, am = tbf.param_r_off, tbf.param_am

    in_cut = rz < jnp.abs(rm)
    # Branch-constant fma: arg = a*r + b with (a, b) selected once,
    # instead of selecting between two fully-computed arguments (one
    # multiply per pair fewer).  Rounding differs from k2*(r - r_off)
    # by <= 1 ulp; all oracle/golden/replay tests hold.
    arg_a = jnp.where(in_cut, k2, jnp.pi / sc_size)
    arg_b = jnp.where(in_cut, -k2 * r_off, 0.0)
    arg = arg_a * rz + arg_b
    one = jnp.ones_like(rz)
    pref = jnp.pi / sc_size

    ldz = ldz2 = log_f2 = None
    if need_derivs and not need_log:
        # Forward-only fast path (the DMC hot loop).  The argument
        # domain never leaves (-pi/2, pi/2] (inside: |k2(r - r_off)| <
        # k2 rm < pi/2; outside: pi r/L with r in [rm, L/2]).  Only the
        # RATIO of the trig factors is needed here, so on f32 a
        # rational tan = xP(x^2)/Q(x^2) replaces the sincos pair at
        # two-thirds the polynomial op count (see _tancot_poly32), and
        # a single divide serves BOTH branches (inside wants tan =
        # xP/Q, outside wants cot = Q/(xP); select numerator/
        # denominator before dividing).  f64 (tests, analysis) keeps
        # the exact library sin/cos.
        if rz.dtype == jnp.float32:
            s, c = _tancot_poly32(arg)  # (xP, Q): tan = s/c exactly
        else:
            s, c = jnp.sin(arg), jnp.cos(arg)
        num = jnp.where(in_cut, s, c)
        den = jnp.where(in_cut, c, s)
        v = num / den  # tan(arg) inside the cutoff, cot(arg) outside
        ldz = jnp.where(in_cut, -k2, pref * beta) * v
        if need_kin:
            kin_c = jnp.where(in_cut, k2 * k2 * one,
                              pref ** 2 * beta * one)
            return None, ldz, kin_c * (1.0 + v * v)
        ldz2 = jnp.where(in_cut, -k2 * k2 * one,
                         pref ** 2 * beta * ((beta - 1) * v * v - 1))
        return None, ldz, ldz2

    if rz.dtype == jnp.float32:
        s, c = _sincos_poly32(arg)
    else:
        s, c = jnp.sin(arg), jnp.cos(arg)

    # Branch-local safe views (guard values AND gradients of the
    # unselected branch).
    s_o = jnp.where(in_cut, one, s)
    c_o = jnp.where(in_cut, one, c)
    s_i = jnp.where(in_cut, s, jnp.zeros_like(rz))
    c_i = jnp.where(in_cut, c, one)

    ldz2 = None
    if need_derivs:
        # One divide serves both branches here too.
        num = jnp.where(in_cut, s_i, c_o)
        den = jnp.where(in_cut, c_i, s_o)
        v = num / den
        ldz = jnp.where(in_cut, -k2, pref * beta) * v
        if need_kin:
            kin_c = jnp.where(in_cut, k2 * k2 * one,
                              pref ** 2 * beta * one)
            ldz2 = kin_c * (1.0 + v * v)
        else:
            ldz2 = jnp.where(in_cut, -k2 * k2 * one,
                             pref ** 2 * beta * ((beta - 1) * v * v - 1))
    if need_log:
        # ONE log per pair: log|f2| = p * log(x) with the base and the
        # exponent branch-selected (inside: x = |am| cos, p = 1;
        # outside: x = sin, p = beta).  Both bases are positive on the
        # guaranteed argument domain.
        x = jnp.where(in_cut, jnp.abs(am) * c_i, s_o)
        p = jnp.where(in_cut, one, beta)
        log_f2 = p * jnp.log(x)
    return log_f2, ldz, ldz2


def _make_potential(defects_sep: int):
    def _potential(z, cfc: CFCParams):
        """External KP potential with periodic defects
        (``mrbp_qmc/model.py:532-551``)."""
        mp = cfc.model_params
        v0 = mp.lattice_depth
        v0d = mp.defect_magnitude
        z_a = mp.well_width
        n_cell = jnp.floor(z)
        z_cell = z - n_cell
        in_barrier = z_a < z_cell
        if defects_sep == 1:
            # Every site is a "defect" (regular lattice has v0d == v0).
            barrier_v = v0d * jnp.ones_like(z)
        else:
            on_defect = jnp.mod(n_cell, defects_sep) == 0
            barrier_v = jnp.where(on_defect, v0d, v0)
        return jnp.where(in_barrier, barrier_v, jnp.zeros_like(z))

    return _potential


def core_funcs(spec_or_static) -> "jastrow.SimpleNamespace":
    """Build the mrbp kernel namespace for a spec (or a StaticSpec).

    The returned functions take ``(pos, cfc_params)`` with ``pos`` of
    shape ``(..., N)`` and the continuous parameters as a pytree, so a
    wavefunction optimizer can vary ``rm`` without retracing.
    """
    static = (spec_or_static.static_spec
              if isinstance(spec_or_static, Spec) else spec_or_static)
    return _core_funcs_cached(static)


@functools.lru_cache(maxsize=64)
def _core_funcs_cached(static: "StaticSpec") -> "jastrow.SimpleNamespace":
    """One kernel namespace per compile-time structure.

    The namespace (and with it every ``jax.jit`` cache inside it) is
    shared by all specs with the same static structure: continuous
    parameters travel as traced pytree arguments, so two ``Spec``s that
    differ only in depths/couplings/rm reuse the same traces and
    compiled executables.  This removes per-``Proc`` retracing in
    parameter sweeps and repeated driver construction.
    """
    funcs = jastrow.build_core_funcs(
        one_body=_one_body,
        one_body_log_dz=_one_body_log_dz,
        one_body_log_dz2=_one_body_log_dz2,
        two_body=_two_body,
        two_body_log_dz=_two_body_log_dz,
        two_body_log_dz2=_two_body_log_dz2,
        two_body_pair_terms=_two_body_pair_terms,
        potential=_make_potential(static.defects_sep),
        is_free=static.is_free,
        is_ideal=static.is_ideal,
        boson_number=static.boson_number,
    )
    funcs.static_spec = static
    return funcs


@dataclass(frozen=True)
class PhysicalFuncs:
    """Batch evaluation of the main physical properties for a model spec.

    The reference wraps its scalar kernels in ``guvectorize`` batch
    dispatchers (``qmc_base/jastrow/model.py:1007-1122``); the JAX
    kernels are natively batched, so this class just binds a spec's
    parameters and jits.  Inputs may be single configurations ``(N,)``,
    packed ``(2, N)`` buffers, or batches with leading axes.
    """
    spec: Spec

    @classmethod
    def from_model_spec(cls, model_spec: Spec) -> "PhysicalFuncs":
        return cls(model_spec)

    @cached_property
    def _funcs(self):
        return core_funcs(self.spec)

    @cached_property
    def _cfc(self):
        return self.spec.cfc_params

    def _pos(self, sys_conf):
        sys_conf = jnp.asarray(sys_conf)
        nop = self.spec.boson_number
        if sys_conf.ndim >= 2 and sys_conf.shape[-2] == 2 \
                and sys_conf.shape[-1] == nop:
            return sys_conf[..., SysConfSlot.pos, :]
        return sys_conf

    def wf_abs_log(self, sys_conf):
        return self._funcs.log_psi(self._pos(sys_conf), self._cfc)

    def energy(self, sys_conf):
        return self._funcs.energy(self._pos(sys_conf), self._cfc)

    def drift(self, sys_conf):
        return self._funcs.drift(self._pos(sys_conf), self._cfc)

    def one_body_density(self, sz, sys_conf):
        return self._funcs.one_body_density(sz, self._pos(sys_conf),
                                            self._cfc)

    def fourier_density(self, kz_set, sys_conf):
        return self._funcs.fourier_density(jnp.asarray(kz_set),
                                           self._pos(sys_conf), self._cfc)


def recast(z, cfc: CFCParams):
    """Wrap positions into the supercell ``[0, L)``
    (``mrbp_qmc/vmc.py:187-203``)."""
    sc_size = cfc.model_params.supercell_size
    return recast_to_supercell(z, 0.0, sc_size)
