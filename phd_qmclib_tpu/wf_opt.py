"""Trial-wavefunction optimization by correlated-sampling variance
minimization.

Re-design of the reference optimizer (``/root/reference/src/phd_qmclib/
qmc_base/jastrow/model.py:1125-1211`` and ``mrbp_qmc/model.py:817-942``):
a fixed set of configurations sampled from the initial trial wavefunction
is reweighted by ``exp(2 (ln psi_new - ln psi_ini))`` for each candidate
variational parameter, and the weighted variance of the local energy is
minimized with ``scipy.optimize.differential_evolution``.

The reference evaluates configurations through a ``dask.bag`` thread/
process pool (``mrbp_qmc/model.py:886-925``); here the whole
configuration set evaluates in ONE fused, batched device call, and -
because the variational parameter travels in the params pytree - the
kernel compiles exactly once for the entire optimization.
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import differential_evolution, minimize

from .models import mrbp
from .qmc_exec.logging import exec_logger

__all__ = ["CSWFOptimizer", "GradCSWFOptimizer", "WFOptProc"]


def weighed_variance(weights_log_set: np.ndarray,
                     energy_set: np.ndarray) -> float:
    """Weighted variance of the local energy
    (``qmc_base/jastrow/model.py:1146-1164``)."""
    rel_weights = np.exp(weights_log_set - weights_log_set.max())
    weight_sum = rel_weights.sum()
    ref_energy = (rel_weights * energy_set).sum() / weight_sum
    e_diff = rel_weights * (energy_set - ref_energy) ** 2
    return float(e_diff.sum() / weight_sum)


@dataclass(frozen=True)
class CSWFOptimizer:
    """Correlated-sampling optimizer of ``tbf_contact_cutoff``
    (``mrbp_qmc/model.py:817-942``)."""

    #: The spec of the model.
    spec: mrbp.Spec
    #: The system configurations used for the minimization process.
    sys_conf_set: np.ndarray
    #: The initial wavefunction values (to calculate the weights).
    ini_wf_abs_log_set: np.ndarray
    #: Reference energy (unused by the variance functional, kept for
    #: API parity with the reference).
    ref_energy: t.Optional[float] = None
    #: Display log messages.
    verbose: bool = False
    #: Jointly optimize the TRIAL-ORBITAL lattice depth
    #: (``Spec.obf_lattice_depth``) alongside ``rm`` — a second
    #: variational knob the reference does not have (its optimizer
    #: caps at one parameter, ``mrbp_qmc/model.py:902-942``).  Needs a
    #: non-free lattice.
    opt_obf_lattice_depth: bool = False

    def __post_init__(self):
        sys_conf_set = np.asarray(self.sys_conf_set)
        nop = self.spec.boson_number
        if sys_conf_set.ndim == 3 and sys_conf_set.shape[-2] == 2:
            sys_conf_set = sys_conf_set[:, mrbp.SysConfSlot.pos, :]
        if sys_conf_set.shape[-1] != nop:
            raise ValueError("sys_conf_set does not match the model's "
                             "configuration layout")
        object.__setattr__(self, "sys_conf_set", sys_conf_set)
        object.__setattr__(self, "ini_wf_abs_log_set",
                           np.asarray(self.ini_wf_abs_log_set))

    @cached_property
    def _eval_fn(self):
        """Jitted batched ``(log_psi, E_L)`` over the config set.

        Compiled once: the variational parameter flows through the
        params pytree (the JAX analog of the reference's dask-pooled
        ``_threaded_func``, ``mrbp_qmc/model.py:863-900``).
        """
        funcs = mrbp.core_funcs(self.spec)
        return jax.jit(funcs.log_psi_and_energy)

    @cached_property
    def _pos_set(self):
        return jnp.asarray(self.sys_conf_set)

    def update_spec(self, tbf_contact_cutoff: float,
                    obf_lattice_depth: t.Optional[float] = None) \
            -> mrbp.Spec:
        """The model spec with updated variational parameter(s)."""
        changes = {"tbf_contact_cutoff": float(tbf_contact_cutoff)}
        if obf_lattice_depth is not None:
            changes["obf_lattice_depth"] = float(obf_lattice_depth)
        return self.spec.evolve(**changes)

    def wf_abs_log_and_energy_set(self, cfc_params: mrbp.CFCParams):
        """Evaluate wavefunction and energy for all configurations."""
        pos = self._pos_set
        cfc = jax.tree.map(lambda x: jnp.asarray(x, dtype=pos.dtype),
                           cfc_params)
        lp, e = self._eval_fn(pos, cfc)
        return np.asarray(lp, dtype=np.float64), \
            np.asarray(e, dtype=np.float64)

    def principal_function(self, params) -> float:
        """The weighted variance as a function of the variational
        parameter vector (``qmc_base/jastrow/model.py:1186-1206``) —
        ``[rm]`` or ``[rm, obf_lattice_depth]``."""
        params = np.atleast_1d(np.asarray(params, dtype=np.float64))
        v0b = float(params[1]) if params.size > 1 else None
        upd_spec = self.update_spec(float(params[0]), v0b)
        wf_abs_log_set, energies_set = \
            self.wf_abs_log_and_energy_set(upd_spec.cfc_params)
        weights_log_set = 2 * (wf_abs_log_set - self.ini_wf_abs_log_set)
        return weighed_variance(weights_log_set, energies_set)

    @property
    def principal_function_bounds(self):
        """Variational-parameter bounds
        (``mrbp_qmc/model.py:902-911``); with the joint-orbital mode a
        second row bounds the trial depth to ``(v0/8, 4 v0)`` around
        the physical one."""
        sc_size = self.spec.supercell_size
        bounds = [(5e-2, (0.5 - 5e-3) * sc_size)]
        if self.opt_obf_lattice_depth:
            if self.spec.is_free:
                raise ValueError(
                    "opt_obf_lattice_depth needs a finite lattice "
                    "(the free-gas trial orbital is flat)")
            v0 = self.spec.lattice_depth
            bounds.append((v0 / 8.0, 4.0 * v0))
        return bounds

    def exec(self) -> mrbp.Spec:
        """Run the variance minimization; returns the spec evolved with
        the optimal variational parameter(s)."""
        opt_params = differential_evolution(
            self.principal_function,
            bounds=self.principal_function_bounds,
            disp=self.verbose, seed=1)
        opt_rm = float(opt_params.x[0])
        opt_v0b = float(opt_params.x[1]) \
            if self.opt_obf_lattice_depth else None
        if self.verbose:
            extra = (f", orbital v0 = {opt_v0b:.6G}"
                     if opt_v0b is not None else "")
            exec_logger.info(f"optimal rm = {opt_rm:.6G}{extra} "
                             f"(variance {opt_params.fun:.6G})")
        return self.update_spec(opt_rm, opt_v0b)


@dataclass(frozen=True)
class GradCSWFOptimizer(CSWFOptimizer):
    """Gradient-based correlated-sampling optimizer.

    Goes beyond the reference (derivative-free
    ``differential_evolution``, ``mrbp_qmc/model.py:927-942``) by
    differentiating the variance functional **through the two-body
    parameter solve**: :func:`mrbp.tbf_params_device` wraps the
    transcendental matching condition in ``lax.custom_root``, so
    ``d(variance)/d(rm)`` is exact (implicit function theorem), not a
    finite difference.

    Strategy: one vmapped device call evaluates the variance on a
    ``num_grid`` grid over the bounds (global view, replaces DE's
    population), then L-BFGS-B with the analytic gradient polishes the
    best grid point.  Typical cost: 1 grid dispatch + ~10
    value-and-grad dispatches, vs ~1000+ DE evaluations.
    """

    #: Grid resolution of the global scan stage.
    num_grid: int = 64

    @cached_property
    def _variance_fn(self):
        """Jitted ``params -> weighted variance`` (traceable end to
        end; ``params`` is ``[rm]`` or ``[rm, orbital v0]`` — the
        orbital depth differentiates through the ``lax.custom_root``
        band solve, :func:`mrbp.obf_params_device`)."""
        funcs = mrbp.core_funcs(self.spec)
        pos = self._pos_set
        ini_lp = jnp.asarray(self.ini_wf_abs_log_set, dtype=pos.dtype)
        joint = self.opt_obf_lattice_depth

        def variance(params):
            # Accept a bare rm scalar (1-D legacy callers) or the
            # parameter vector.
            params = jnp.atleast_1d(params)
            cfc = mrbp.cfc_params_device(
                params[0], self.spec,
                obf_lattice_depth=params[1] if joint else None)
            cfc = jax.tree.map(lambda x: jnp.asarray(x, pos.dtype), cfc)
            lp, energy = funcs.log_psi_and_energy(pos, cfc)
            wlog = 2.0 * (lp - ini_lp)
            rel_w = jnp.exp(wlog - wlog.max())
            w_sum = rel_w.sum()
            e_ref = (rel_w * energy).sum() / w_sum
            return (rel_w * (energy - e_ref) ** 2).sum() / w_sum

        return variance

    @cached_property
    def _grid_fn(self):
        return jax.jit(jax.vmap(self._variance_fn))

    @cached_property
    def _value_and_grad_fn(self):
        return jax.jit(jax.value_and_grad(self._variance_fn))

    def exec(self) -> mrbp.Spec:
        """Grid scan + gradient polish; returns the evolved spec."""
        if self.spec.interaction_strength <= 0:
            # The device solve needs gn > 0; the free gas has no
            # two-body parameter to optimize anyway.
            return super().exec()
        bounds = self.principal_function_bounds
        dtype = self._pos_set.dtype
        if len(bounds) == 1:
            (lo, hi), = bounds
            grid = jnp.linspace(lo, hi, self.num_grid,
                                dtype=dtype)[:, None]
        else:
            # Joint (rm, orbital v0): a 2-D grid in ONE vmapped
            # dispatch replaces DE's population for the global view.
            # The rm axis keeps the FULL 1-D resolution — its bounds
            # span half the box, and a coarse rm grid can drop the
            # polish into a worse basin than the 1-D path finds
            # (observed on chip at N=128); the orbital-depth axis is
            # smooth and unimodal around the physical depth, so 16
            # points suffice.
            axes = [jnp.linspace(*bounds[0], self.num_grid,
                                 dtype=dtype),
                    jnp.linspace(*bounds[1], 16, dtype=dtype)]
            grid = jnp.stack([g.ravel() for g in
                              jnp.meshgrid(*axes, indexing="ij")],
                             axis=-1)
        values = np.asarray(self._grid_fn(grid), dtype=np.float64)
        best = int(np.nanargmin(values))
        x0 = np.asarray(grid[best], dtype=np.float64)
        if self.verbose:
            exec_logger.info(f"grid stage: x0 = {x0} "
                             f"(variance {values[best]:.6G})")

        vg = self._value_and_grad_fn

        def fun_and_jac(x):
            v, g = vg(jnp.asarray(x, dtype))
            return float(v), np.asarray(g, dtype=np.float64)

        res = minimize(fun_and_jac, x0, jac=True,
                       method="L-BFGS-B", bounds=bounds)
        opt_rm = float(res.x[0])
        opt_v0b = float(res.x[1]) if len(bounds) > 1 else None
        if self.verbose:
            extra = (f", orbital v0 = {opt_v0b:.6G}"
                     if opt_v0b is not None else "")
            exec_logger.info(f"optimal rm = {opt_rm:.6G}{extra} "
                             f"(variance {res.fun:.6G}, "
                             f"{res.nfev} grad evals)")
        return self.update_spec(opt_rm, opt_v0b)


@dataclass(frozen=True)
class WFOptProc:
    """Wavefunction-optimization procedure
    (``mrbp_qmc/wf_opt/wf_opt.py:13-67``): feeds the last
    ``num_sys_confs`` configurations of a VMC sampling into the
    correlated-sampling optimizer."""

    #: Number of configurations from the sampling to use.
    num_sys_confs: int = 128
    #: The energy of reference to minimize the variance.
    ref_energy: t.Optional[float] = None
    verbose: bool = False
    #: ``"de"`` = differential evolution (reference behavior),
    #: ``"grad"`` = grid scan + implicit-differentiation L-BFGS polish.
    method: str = "de"
    #: Jointly optimize the trial-orbital lattice depth alongside
    #: ``rm`` (see :class:`CSWFOptimizer`); the reference caps at one
    #: parameter.
    opt_obf_lattice_depth: bool = False

    def exec(self, model_spec: mrbp.Spec, sys_conf_set: np.ndarray,
             ini_wf_abs_log_set: np.ndarray) -> mrbp.Spec:
        num = self.num_sys_confs
        sys_conf_set = np.asarray(sys_conf_set)[-num:]
        ini_wf_abs_log_set = np.asarray(ini_wf_abs_log_set)[-num:]
        if self.method not in ("de", "grad"):
            raise ValueError(f"unknown wf-opt method {self.method!r}")
        cls = GradCSWFOptimizer if self.method == "grad" else CSWFOptimizer
        optimizer = cls(model_spec, sys_conf_set,
                        ini_wf_abs_log_set,
                        self.ref_energy, self.verbose,
                        opt_obf_lattice_depth=self.opt_obf_lattice_depth)
        return optimizer.exec()
