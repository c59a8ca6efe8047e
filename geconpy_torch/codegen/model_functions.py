"""Builds the packed torch functions for one model.

Mirrors ``geconpy_tpu/codegen/model_functions.py:115``
(``build_model_functions``, ``ModelFunctions``): the single seam between the
symbolic world (sympy primitives, from the port's copy of the
front-end) and the numeric world.  The functions and
their static index metadata are the same as the JAX bundle's; every function
takes a leading batch dimension (see :mod:`geconpy_torch.codegen.lower`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import sympy as sp

from ..models.timing import natural_sort_key
from ..symbolic import TimeAwareSymbol
from ..ops.bijectors import VectorBijector, make_bijector
from .lower import CompiledFunction, lower_to_torch

__all__ = ["ModelFunctions", "build_model_functions"]


@dataclass
class ModelFunctions:
    """Packed torch functions + static metadata for one model."""

    # orderings (host-side, fixed at build)
    variables: list          # TimeAwareSymbol at time t, canonical order
    shocks: list
    free_params: list[sp.Symbol]
    deterministic_params: list[sp.Symbol]
    calibrated_params: list[sp.Symbol]

    # f_params: free (..., p) -> (..., free ++ deterministic)
    f_params: CompiledFunction
    # f_resid(y_m1, y, y_p1, eps, x_ss, theta_full) -> (..., n)
    f_resid: CompiledFunction
    # f_ss_resid(x_ss, theta_full) -> (..., n)
    f_ss_resid: CompiledFunction
    # f_calib_resid(x_ss, theta_full) -> (..., n_calib)
    f_calib_resid: CompiledFunction | None

    # analytic steady state
    known_idx: np.ndarray
    unknown_idx: np.ndarray
    f_ss_known: CompiledFunction | None       # theta_full -> values at known_idx
    eq_unknown_idx: np.ndarray

    # unconstrained reparameterization for [unknown ss vars ++ calibrated]
    bijector: VectorBijector

    # nonzero entries of the stacked [A|B|C|D] Jacobian + scatter indices
    f_lin_nz: CompiledFunction | None = None
    lin_rows: np.ndarray | None = None
    lin_cols: np.ndarray | None = None

    @property
    def n_variables(self) -> int:
        """Number of model variables."""
        return len(self.variables)

    @property
    def n_shocks(self) -> int:
        """Number of exogenous shocks."""
        return len(self.shocks)

    @property
    def n_params(self) -> int:
        """Length of theta_full = free + deterministic + calibrated."""
        return (len(self.free_params) + len(self.deterministic_params)
                + len(self.calibrated_params))

    @property
    def param_names(self) -> list[str]:
        """theta_full order: free, deterministic, calibrated."""
        return [p.name for p in (*self.free_params, *self.deterministic_params,
                                 *self.calibrated_params)]

    @property
    def variable_names(self) -> list[str]:
        """Base variable names in system order."""
        return [v.base_name for v in self.variables]

    @property
    def shock_names(self) -> list[str]:
        """Base shock names in system order."""
        return [s.base_name for s in self.shocks]

    @property
    def has_full_analytic_ss(self) -> bool:
        """True when the GCN steady-state block pins every variable (no Newton)."""
        return len(self.unknown_idx) == 0

    @property
    def n_unknowns(self) -> int:
        """Numeric steady-state unknowns (variables + calibrated params)."""
        return len(self.unknown_idx) + len(self.calibrated_params)


def build_model_functions(primitives) -> ModelFunctions:
    """Lower ``ModelPrimitives`` to the per-model torch function bundle."""
    variables = list(primitives.variables)
    shocks = list(primitives.shocks)
    n = len(variables)

    free_params = sorted(primitives.param_dict.keys(),
                         key=lambda s: natural_sort_key(s.name))
    det_params = sorted(primitives.deterministic_dict.keys(),
                        key=lambda s: natural_sort_key(s.name))
    calib_params = sorted(primitives.calib_dict.keys(),
                          key=lambda s: natural_sort_key(s.name))
    theta_symbols = free_params + det_params + calib_params

    det_exprs = [primitives.deterministic_dict[p] for p in det_params]
    f_params = lower_to_torch(
        [sp.sympify(p) for p in free_params] + [sp.sympify(e) for e in det_exprs],
        [("free", free_params)],
        name="f_params",
        docstring="free parameters -> (free ++ deterministic) parameter vector",
    )

    lags = [v.set_t(-1) for v in variables]
    now = [v.set_t(0) for v in variables]
    leads = [v.set_t(1) for v in variables]
    ss_syms = [v.to_ss() for v in variables]
    resid_groups = [("y_m1", lags), ("y", now), ("y_p1", leads),
                    ("eps", shocks), ("x_ss", ss_syms),
                    ("theta", theta_symbols)]
    f_resid = lower_to_torch(
        primitives.equations, resid_groups, name="f_resid",
        docstring="dynamic residuals F(y_{t-1}, y_t, y_{t+1}, eps_t; x_ss, theta)",
    )

    ss_equations = primitives.steady_state_system
    f_ss_resid = lower_to_torch(
        ss_equations, [("x_ss", ss_syms), ("theta", theta_symbols)],
        name="f_ss_resid", docstring="steady-state residuals F(x_ss; theta)",
    )

    f_calib_resid = None
    if calib_params:
        f_calib_resid = lower_to_torch(
            [primitives.calib_dict[p] for p in calib_params],
            [("x_ss", ss_syms), ("theta", theta_symbols)],
            name="f_calib_resid",
            docstring="calibrating-equation residuals at the steady state",
        )

    # nonzero entries of [A | B | C | D], differentiated symbolically
    col_syms = list(lags) + list(now) + list(leads) + list(shocks)
    lin_rows: list[int] = []
    lin_cols: list[int] = []
    lin_exprs: list[sp.Expr] = []
    for i, eq in enumerate(primitives.equations):
        eq = sp.sympify(eq)
        free_syms = eq.free_symbols
        for j, s in enumerate(col_syms):
            if s not in free_syms:
                continue
            d = sp.diff(eq, s)
            if d == 0:
                continue
            lin_rows.append(i)
            lin_cols.append(j)
            lin_exprs.append(d)
    f_lin_nz = lower_to_torch(
        lin_exprs, resid_groups, name="f_lin_nz",
        docstring="nonzero entries of the stacked [A|B|C|D] Jacobian",
    )

    ss_dict = primitives.ss_solution_dict
    known_mask = np.zeros(n, dtype=bool)
    known_exprs: list[sp.Expr] = []
    for i, v in enumerate(variables):
        key = v.to_ss()
        if key in ss_dict:
            known_mask[i] = True
            known_exprs.append(ss_dict[key])
    known_idx = np.flatnonzero(known_mask)
    unknown_idx = np.flatnonzero(~known_mask)

    f_ss_known = None
    if len(known_idx):
        f_ss_known = lower_to_torch(
            known_exprs, [("theta", theta_symbols)], name="f_ss_known",
            docstring="analytic steady-state values (known subset) from parameters",
        )

    unknown_names = {variables[i].base_name for i in unknown_idx}
    calib_set = set(calib_params)
    eq_has_unknown = np.zeros(len(ss_equations), dtype=bool)
    for j, eq in enumerate(ss_equations):
        if eq.free_symbols & calib_set:
            eq_has_unknown[j] = True
            continue
        for atom in eq.atoms(TimeAwareSymbol):
            if atom.base_name in unknown_names:
                eq_has_unknown[j] = True
                break
    eq_unknown_idx = np.flatnonzero(eq_has_unknown)

    assumption_dicts = [dict(variables[i].assumptions0) for i in unknown_idx]
    assumption_dicts += [dict(p.assumptions0) for p in calib_params]
    bijector = make_bijector(assumption_dicts)

    return ModelFunctions(
        variables=variables,
        shocks=shocks,
        free_params=free_params,
        deterministic_params=det_params,
        calibrated_params=calib_params,
        f_params=f_params,
        f_resid=f_resid,
        f_ss_resid=f_ss_resid,
        f_calib_resid=f_calib_resid,
        known_idx=known_idx,
        unknown_idx=unknown_idx,
        f_ss_known=f_ss_known,
        eq_unknown_idx=eq_unknown_idx,
        bijector=bijector,
        f_lin_nz=f_lin_nz,
        lin_rows=np.asarray(lin_rows, dtype=np.int32),
        lin_cols=np.asarray(lin_cols, dtype=np.int32),
    )
