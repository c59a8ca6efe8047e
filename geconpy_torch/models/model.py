"""The compiled model object.

Mirrors ``geconpy_tpu/models/model.py`` (``Model``, ``model_from_gcn``),
as a subset: ``functions``, ``ss_solver`` (analytic or numeric, batched),
``steady_state`` (:221-270) and ``parameters`` (:212), ``linearizer``,
``static_reduction``, ``default_theta``, ``default_loglin`` and
``param_names``.  No pandas: ``linearize_model``, ``solve_model`` and the
other labelled host-side reports of the reference are not ported.
``steady_state`` runs on the GPU unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import logging
from functools import cached_property

import torch

from ..codegen.model_functions import ModelFunctions, build_model_functions
from ..symbolic import SteadyStateResults, SymbolDictionary
from .perturbation import make_linearizer
from .primitives import load_gcn, load_gcn_file
from .steady_state import make_fixed_value_solver, make_steady_state_solver

_log = logging.getLogger(__name__)

__all__ = ["Model", "model_from_gcn"]


class Model:
    """A compiled DSGE model (torch numeric layer over shared primitives)."""

    def __init__(self, primitives):
        self.primitives = primitives
        self._solvers: dict = {}

    @cached_property
    def functions(self) -> ModelFunctions:
        return build_model_functions(self.primitives)

    @cached_property
    def ss_solver(self):
        return make_steady_state_solver(self.functions)

    @property
    def default_loglin(self) -> bool:
        """Linear models (GCN ``options { linear = TRUE; }``) are already in
        deviations; log-linearization scaling is skipped for them."""
        return not self.primitives.is_linear

    def linearizer(self, loglin_variables="auto"):
        """Cached ``(x_ss, theta_full) -> LinearizationResult``."""
        if loglin_variables == "auto":
            loglin_variables = self.default_loglin
        key = ("linearizer", loglin_variables
               if isinstance(loglin_variables, bool)
               else tuple(sorted(loglin_variables)))
        if key not in self._solvers:
            self._solvers[key] = make_linearizer(self.functions,
                                                 loglin_variables)
        return self._solvers[key]

    @property
    def param_names(self) -> list[str]:
        """Free parameter names, the order of ``default_theta``."""
        return [p.name for p in self.functions.free_params]

    @cached_property
    def static_reduction(self):
        """Structural static/dynamic split for the reduced policy solve."""
        from ..ops.static_reduction import plan_static_reduction

        return plan_static_reduction(self.primitives.equations,
                                     self.functions.variables)

    def default_theta(self, **updates) -> torch.Tensor:
        """Free-parameter vector from GCN calibration, with overrides."""
        values = {p.name: float(v) for p, v in self.primitives.param_dict.items()}
        unknown = set(updates) - set(values)
        if unknown:
            raise KeyError(f"unknown parameter(s): {sorted(unknown)}; "
                           f"free parameters are {sorted(values)}")
        values.update({k: float(v) for k, v in updates.items()})
        return torch.tensor([values[p.name] for p in self.functions.free_params],
                            dtype=torch.float64)

    def parameters(self, **updates) -> SymbolDictionary:
        """Full parameter dictionary (free + deterministic), with overrides."""
        theta = self.default_theta(**updates)
        full = self.functions.f_params(theta).tolist()
        syms = (list(self.functions.free_params)
                + list(self.functions.deterministic_params))
        return SymbolDictionary(dict(zip(syms, full)))

    def steady_state(self, verbose: bool = True,
                     fixed_values: dict[str, float] | None = None,
                     method: str = "hybrid", *,
                     device: str | torch.device = "cuda",
                     **updates) -> SteadyStateResults:
        """Solve the steady state at the GCN calibration (with ``updates``).

        ``fixed_values`` pins chosen variables: the rest of the system is
        solved and the FULL residual validated, so an inconsistent pin
        fails.  ``method`` selects the root finder (``"hybrid"``, the
        default, ``"newton"``, ``"newton_nm"``, ``"chord"``, ``"lm"``,
        ``"dogleg"``, ``"gauss_newton"``; with ``fixed_values`` it is always
        the hybrid).  The solve runs in float64 on ``device``; the result
        holds every variable's steady state and the calibrated parameters,
        with ``success`` and ``resid_norm``.
        """
        theta = self.default_theta(**updates).to(device)
        if fixed_values:
            names = sorted(fixed_values)
            key = ("fixed_ss", tuple(names))
            if key not in self._solvers:
                self._solvers[key] = make_fixed_value_solver(self.functions,
                                                             names)
            vals = torch.tensor([float(fixed_values[k]) for k in names],
                                dtype=theta.dtype, device=theta.device)
            sol = self._solvers[key](theta, vals)
        elif method != "hybrid":
            key = ("ss_method", method)
            if key not in self._solvers:
                self._solvers[key] = make_steady_state_solver(
                    self.functions, method=method)
            sol = self._solvers[key](theta)
        else:
            sol = self.ss_solver(theta)
        success = bool(sol.success)
        if verbose:
            if success:
                _log.info("Steady state found (resid norm %.3e, %d iterations)",
                          float(sol.resid_norm), int(sol.n_iter))
            else:
                _log.warning("Steady state FAILED (resid norm %.3e)",
                             float(sol.resid_norm))
        values = sol.x_ss.tolist()
        result = SteadyStateResults(
            {v.to_ss(): values[i] for i, v in enumerate(self.functions.variables)},
            success=success, resid_norm=float(sol.resid_norm))
        mf = self.functions
        if mf.calibrated_params:
            theta_full = sol.theta_full.tolist()
            offset = len(mf.free_params) + len(mf.deterministic_params)
            for i, p in enumerate(mf.calibrated_params):
                result[p] = theta_full[offset + i]
        return result

    def __repr__(self):
        mf = self.functions
        return (f"Model(variables={mf.n_variables}, shocks={mf.n_shocks}, "
                f"free_params={len(mf.free_params)}, "
                f"calibrated={len(mf.calibrated_params)})")


def model_from_gcn(source_or_path, **kwargs) -> Model:
    """Build a Model from GCN source text or a ``.gcn`` file path."""
    text = str(source_or_path)
    if "\n" not in text and text.endswith(".gcn"):
        primitives = load_gcn_file(text, **kwargs)
    else:
        primitives = load_gcn(text, **kwargs)
    return Model(primitives)
