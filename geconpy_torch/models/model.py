"""The compiled model object and its first-order solution.

Mirrors ``geconpy_tpu/models/model.py``: ``PolicySolution`` (:45-102) with
its conveniences, and ``Model`` (:105-474) up to the diagnostics:
``functions``, ``ss_solver``, ``linearizer``, the properties
(``variables``, ``shocks``, ``param_names``, ``n_variables``,
``n_shocks``, ``static_reduction``, ``lead_var_idx``, ``gensys_solver``,
``is_backward_looking``, ``variable_timing``), ``default_theta``,
``parameters`` (:212), ``steady_state`` (:221), ``linearize_model``
(:273), ``solve_model`` (:290) with its four solvers, its auto-selection
and its gensys fallback, and ``check_bk_condition`` (:442); and
``model_from_gcn`` (:496).  No pandas: where the reference returns a
DataFrame the port returns tensors with name lists (``linearize_model``,
``PolicySolution.T``/``R``) or numpy arrays (``check_bk_condition``).
``summary`` returns the P/Q/R/S tables of
``stats/perturbation_diagnostics.py``; ``solve_model_second_order``
(:400) returns the first-order solution with the second-order blocks
(``models/second_order.py``); ``build_report`` (:476) and ``_repr_html_``
(:485) render through ``utils/reporting.py``.  ``steady_state``,
``linearize_model``, ``solve_model`` and ``check_bk_condition`` run on the
GPU unless they are given ``device="cpu"``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import cached_property
from typing import Literal

import numpy as np
import torch

from ..codegen.model_functions import ModelFunctions, build_model_functions
from ..ops.gensys_np import interpret_eu, solve_policy_gensys
from ..symbolic import SteadyStateResults, SymbolDictionary
from .perturbation import make_linearizer, solve_policy_backward, spectral_radius
from .primitives import load_gcn, load_gcn_file
from .steady_state import make_fixed_value_solver, make_steady_state_solver
from .timing import classify_variables_by_timing, structural_incidence

_log = logging.getLogger(__name__)

__all__ = ["Model", "PolicySolution", "model_from_gcn"]

VALID_SOLVERS = ("cycle_reduction", "gensys", "gensys_host", "backward")

@dataclass
class PolicySolution:
    """First-order solution  ŷ_t = T ŷ_{t-1} + R ε_t  with diagnostics.

    ``T`` (n, n) and ``R`` (n, n_shocks) are float64 tensors on the solve's
    device; ``variables`` names their rows (and T's columns), ``shocks``
    R's columns."""

    T: torch.Tensor
    R: torch.Tensor
    variables: list[str]
    shocks: list[str]
    success: bool
    solver: str
    deterministic_norm: float
    stochastic_norm: float
    spectral_radius: float
    eu: tuple[int, int] | None = None
    steady_state: SteadyStateResults | None = None
    loglin_scale: torch.Tensor | None = None

    # ------------------------------------------------------- conveniences
    def impulse_responses(self, periods: int = 40, **kwargs):
        """Per-shock IRFs (see analysis.simulate.impulse_response_function)."""
        from ..analysis.simulate import impulse_response_function

        return impulse_response_function(self, periods=periods, **kwargs)

    def simulate(self, periods: int = 40, n_simulations: int = 100, **kwargs):
        """Stochastic simulations from the linear solution
        (analysis.simulate.simulate)."""
        from ..analysis.simulate import simulate

        return simulate(self, periods=periods, n_simulations=n_simulations,
                        **kwargs)

    def stationary_covariance(self, **kwargs):
        """Stationary covariance of the solved model (Lyapunov fixed point)."""
        from ..stats.covariance import stationary_covariance_matrix

        return stationary_covariance_matrix(self, **kwargs)

    def autocorrelation(self, n_lags: int = 10, **kwargs):
        """Autocorrelation matrices Gamma_k for k = 0..n_lags-1."""
        from ..stats.covariance import autocovariance_matrix

        return autocovariance_matrix(self, n_lags=n_lags, **kwargs)

    def summary(self):
        """gEcon's P/Q/R/S policy tables
        (stats.perturbation_diagnostics.summarize_perturbation_solution)."""
        from ..stats.perturbation_diagnostics import (
            summarize_perturbation_solution)

        return summarize_perturbation_solution(self)

    def __repr__(self):
        status = "ok" if self.success else "FAILED"
        msg = (f"PolicySolution({self.solver}, {status}, "
               f"det_norm={self.deterministic_norm:.2e}, "
               f"stoch_norm={self.stochastic_norm:.2e}, "
               f"rho={self.spectral_radius:.4f}")
        if self.eu is not None:
            msg += f", eu={self.eu}"
        return msg + ")"


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
    def variables(self) -> list[str]:
        """Variable names in model (declaration) order."""
        return self.functions.variable_names

    @property
    def shocks(self) -> list[str]:
        """Shock names in declaration order."""
        return self.functions.shock_names

    @property
    def param_names(self) -> list[str]:
        """Free parameter names, the order of ``default_theta``."""
        return [p.name for p in self.functions.free_params]

    @property
    def n_variables(self) -> int:
        """Number of model variables (static shape of the solved system)."""
        return self.functions.n_variables

    @property
    def n_shocks(self) -> int:
        """Number of exogenous shocks."""
        return self.functions.n_shocks

    @cached_property
    def static_reduction(self):
        """Structural static/dynamic split for the reduced policy solve."""
        from ..ops.static_reduction import plan_static_reduction

        return plan_static_reduction(self.primitives.equations,
                                     self.functions.variables)

    @cached_property
    def lead_var_idx(self) -> np.ndarray:
        """Indices of variables appearing at t+1 (structural)."""
        inc = structural_incidence(self.primitives.equations,
                                   self.functions.variables)
        return np.flatnonzero(inc["lead"].any(axis=0))

    @cached_property
    def gensys_solver(self):
        """Batched device gensys (disk split) for this model's layout."""
        from ..ops.gensys_jax import make_gensys_solver

        return make_gensys_solver(self.n_variables, self.lead_var_idx,
                                  self.n_shocks)

    @cached_property
    def is_backward_looking(self) -> bool:
        """True when no equation references t+1 (structural fact)."""
        inc = structural_incidence(self.primitives.equations,
                                   self.functions.variables)
        return not inc["lead"].any()

    @cached_property
    def variable_timing(self) -> dict[str, list[str]]:
        classified = classify_variables_by_timing(
            self.primitives.equations, self.functions.variables)
        return {k: [v.base_name for v in vs] for k, vs in classified.items()}

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
        result = self._ss_results(sol)
        if verbose:
            if result.success:
                _log.info("Steady state found (resid norm %.3e, %d iterations)",
                          float(sol.resid_norm), int(sol.n_iter))
            else:
                _log.warning("Steady state FAILED (resid norm %.3e)",
                             float(sol.resid_norm))
        mf = self.functions
        if mf.calibrated_params:
            theta_full = sol.theta_full.tolist()
            offset = len(mf.free_params) + len(mf.deterministic_params)
            for i, p in enumerate(mf.calibrated_params):
                result[p] = theta_full[offset + i]
        return result

    # ---------------------------------------------------------- linearization
    def _solve_ss(self, device, updates):
        theta = self.default_theta(**updates).to(device)
        with torch.no_grad():
            return self.ss_solver(theta)

    def _ss_results(self, sol) -> SteadyStateResults:
        values = sol.x_ss.tolist()
        return SteadyStateResults(
            {v.to_ss(): values[i]
             for i, v in enumerate(self.functions.variables)},
            success=bool(sol.success), resid_norm=float(sol.resid_norm))

    def linearize_model(self, loglin_variables="auto",
                        steady_state: SteadyStateResults | None = None, *,
                        device: str | torch.device = "cuda",
                        **updates) -> dict:
        """A/B/C/D of  A ŷ_{t-1} + B ŷ_t + C ŷ_{t+1} + D ε_t = 0  at the
        steady state, as float64 tensors on ``device``, with the names:
        ``{"A", "B", "C", "D", "variables", "shocks"}``.  The reference's
        ``steady_state`` argument is accepted and, as there, unused."""
        sol = self._solve_ss(device, updates)
        with torch.no_grad():
            lin = self.linearizer(loglin_variables)(sol.x_ss, sol.theta_full)
        return {"A": lin.A, "B": lin.B, "C": lin.C, "D": lin.D,
                "variables": list(self.variables),
                "shocks": list(self.shocks)}

    # ------------------------------------------------------------------ solve
    def solve_model(
        self,
        solver: Literal["cycle_reduction", "gensys", "gensys_host",
                        "backward"] | None = None,
        loglin_variables="auto",
        tol: float = 1e-12,
        maxiter: int = 100,
        on_failure: Literal["error", "ignore"] = "error",
        verbose: bool = True,
        *,
        device: str | torch.device = "cuda",
        **updates,
    ) -> PolicySolution:
        """Steady state -> linearize -> first-order policy  T, R, in
        float64 on ``device``.

        ``solver=None`` auto-selects: the direct backward solve for purely
        backward-looking models, otherwise cycle reduction with a gensys
        fallback (cycle reduction needs a nonsingular reduced B pencil).
        ``"cycle_reduction"`` is the adaptive solve on the static
        reduction (``tol``, ``maxiter``), ``"gensys"`` the device disk
        split, ``"gensys_host"`` scipy's ordered QZ on the host (T and R
        then go to ``device``), ``"backward"`` T = -B⁻¹A, R = -B⁻¹D.
        """
        auto = solver is None
        if solver is None:
            solver = "backward" if self.is_backward_looking else "cycle_reduction"
        if solver not in VALID_SOLVERS:
            raise ValueError(f"solver must be one of {VALID_SOLVERS}, got {solver!r}")
        if solver == "backward" and not self.is_backward_looking:
            raise ValueError("backward solver requested but the model has "
                             "forward-looking (t+1) terms")

        linearize = self.linearizer(loglin_variables)
        sol = self._solve_ss(device, updates)
        if not bool(sol.success) and on_failure == "error":
            raise RuntimeError(
                f"steady state failed (residual norm {float(sol.resid_norm):.3e})")
        with torch.no_grad():
            lin = linearize(sol.x_ss, sol.theta_full)
            A, B, C, D = lin.A, lin.B, lin.C, lin.D
            T, R, success, eu, solver = self._policy(
                solver, auto, A, B, C, D, tol, maxiter, verbose)
            det_norm = float((A + B @ T + C @ T @ T).abs().max())
            stoch_norm = float(((B + C @ T) @ R + D).abs().max())
            rho = float(spectral_radius(T))
        success = bool(success) and bool(sol.success)

        if not success and on_failure == "error":
            msg = f"policy solution failed (solver={solver}"
            if eu is not None:
                msg += f", {interpret_eu(eu)}"
            raise RuntimeError(msg + ")")
        if verbose and success:
            _log.info("Solved with %s: det norm %.2e, stoch norm %.2e",
                      solver, det_norm, stoch_norm)
        return PolicySolution(
            T=T, R=R, variables=list(self.variables),
            shocks=list(self.shocks), success=success, solver=solver,
            deterministic_norm=det_norm, stochastic_norm=stoch_norm,
            spectral_radius=rho, eu=eu, steady_state=self._ss_results(sol),
            loglin_scale=lin.loglin_scale)

    def _policy(self, solver, auto, A, B, C, D, tol, maxiter, verbose):
        """(T, R, success, eu, solver) of one solver (``model.py:323-364``)."""
        eu = None
        if solver == "gensys":
            res = self.gensys_solver(A, B, C, D)
            T, R = res.T, res.R
            eu = (1 if bool(res.existence) else 0,
                  1 if bool(res.uniqueness) else -1)
            success = bool(res.success)
            if verbose:
                _log.info(interpret_eu(eu))
        elif solver == "gensys_host":
            T_np, R_np, eu = solve_policy_gensys(
                *(X.cpu().numpy() for X in (A, B, C, D)))
            success = eu[0] == 1 and eu[1] == 1 and np.all(np.isfinite(T_np))
            T = torch.as_tensor(T_np, dtype=A.dtype, device=A.device)
            R = torch.as_tensor(R_np, dtype=A.dtype, device=A.device)
            if verbose:
                _log.info(interpret_eu(eu))
        elif solver == "backward":
            T, R, ok = solve_policy_backward(A, B, D)
            success = bool(ok)
        else:
            from ..ops.static_reduction import solve_policy_reduced

            T, R, ok, _n_iter, _resid = solve_policy_reduced(
                A, B, C, D, self.static_reduction, tol=tol, maxiter=maxiter)
            success = bool(ok)
            if auto and not success:
                # cycle reduction needs a nonsingular reduced B; fall back
                # to the generalized-Schur (disk-split) solver
                res = self.gensys_solver(A, B, C, D)
                if bool(res.success):
                    solver = "gensys"
                    T, R = res.T, res.R
                    eu = (1, 1)
                    success = True
                    if verbose:
                        _log.info("cycle reduction failed; gensys fallback "
                                  "succeeded")
        return T, R, success, eu, solver

    def second_order_solver(self, loglin_variables="auto"):
        """Cached batched ``solve2(x_ss, theta_full, T, R, Q)`` of
        ``models/second_order.py``, one per log-linearization, as the
        reference caches it (``model.py:427-431``)."""
        if loglin_variables == "auto":
            loglin_variables = self.default_loglin
        key = ("second_order", loglin_variables
               if isinstance(loglin_variables, bool)
               else tuple(sorted(loglin_variables)))
        if key not in self._solvers:
            from .second_order import make_second_order_solver

            self._solvers[key] = make_second_order_solver(self.functions,
                                                          loglin_variables)
        return self._solvers[key]

    def solve_model_second_order(
        self,
        loglin_variables="auto",
        shock_std=None,
        shock_cov=None,
        solution: PolicySolution | None = None,
        verbose: bool = False,
        *,
        device: str | torch.device = "cuda",
        **updates,
    ):
        """Second-order perturbation (``models/second_order.py``).

        Returns ``(PolicySolution, SecondOrderResult)``: the first-order
        T and R and the quadratic blocks G_xx, G_xu, G_uu with the
        uncertainty correction g_ss, computed from the shock covariance
        (``shock_std`` or ``shock_cov``, std 0.01 per shock by default).
        Without a ``solution`` the first-order solve runs on ``device``;
        with one, everything runs on its device.  A solve that does not
        converge logs a warning and returns ``success=False``.
        """
        from ..stats.covariance import build_shock_cov
        from .second_order import SecondOrderResult

        if solution is None:
            solution = self.solve_model(loglin_variables=loglin_variables,
                                        verbose=verbose, device=device,
                                        **updates)
        T, R = solution.T, solution.R
        sol_ss = self._solve_ss(T.device, updates)
        Q = build_shock_cov(self.n_shocks, shock_std, shock_cov,
                            dtype=T.dtype, device=T.device)
        with torch.no_grad():
            res2 = self.second_order_solver(loglin_variables)(
                sol_ss.x_ss.reshape(1, -1), sol_ss.theta_full.reshape(1, -1),
                T[None], R[None], Q[None])
        res2 = SecondOrderResult(*(x[0] for x in res2))
        if not bool(res2.success):
            _log.warning("second-order solve did not converge cleanly")
        return solution, res2

    # ------------------------------------------------------------- diagnostics
    def check_bk_condition(self, verbose: bool = True, *,
                           device: str | torch.device = "cuda",
                           **updates) -> dict:
        """Blanchard-Kahn eigenvalue table (a host QZ diagnostic).

        The linearization runs on ``device``; the generalized eigenvalues
        of the gensys pencil come from scipy's ``ordqz`` on the host, as in
        the reference.  Returns ``{"real", "imag", "modulus"}`` (numpy
        arrays sorted by modulus) and ``bk_satisfied``, ``n_unstable``,
        ``n_forward`` (the reference's DataFrame columns and attrs).
        """
        from scipy.linalg import ordqz

        from ..ops.gensys_np import gensys_setup

        lin = self.linearize_model(device=device, **updates)
        A, B, C, D = (lin[k].cpu().numpy() for k in "ABCD")
        g0, g1, _, _, pi, lead_idx = gensys_setup(A, B, C, D)
        AA, BB, alpha, beta, _, _ = ordqz(g0, g1, output="complex")
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = np.where(np.abs(alpha) > 1e-13, beta / alpha, np.inf)
        moduli = np.abs(lam)
        n_unstable = int(np.sum(moduli > 1.0 + 1e-9))
        n_forward = len(lead_idx)
        satisfied = n_unstable == n_forward
        if verbose:
            _log.info("BK condition: %d unstable roots, %d forward-looking "
                      "variables -> %s", n_unstable, n_forward,
                      "satisfied" if satisfied else "VIOLATED")
        order = np.argsort(moduli)
        return {"real": np.real(lam)[order], "imag": np.imag(lam)[order],
                "modulus": moduli[order], "bk_satisfied": satisfied,
                "n_unstable": n_unstable, "n_forward": n_forward}

    def build_report(self) -> str:
        """Human-readable summary of the compiled model
        (role parity with gEconpy/model/build.py:748)."""
        from ..utils.reporting import build_report

        report = build_report(self)
        print(report)
        return report

    def _repr_html_(self) -> str:
        from ..utils.reporting import model_to_html

        return model_to_html(self)

    def __repr__(self):
        mf = self.functions
        return (f"Model(variables={mf.n_variables}, shocks={mf.n_shocks}, "
                f"free_params={len(mf.free_params)}, "
                f"calibrated={len(mf.calibrated_params)})")


def model_from_gcn(source_or_path, verbose: bool = True, **kwargs) -> Model:
    """Build a Model from GCN source text or a ``.gcn`` file path;
    ``verbose`` logs the model's size, as the reference does."""
    text = str(source_or_path)
    if "\n" not in text and text.endswith(".gcn"):
        primitives = load_gcn_file(text, **kwargs)
    else:
        primitives = load_gcn(text, **kwargs)
    model = Model(primitives)
    if verbose:
        _log.info("Model compiled: %d equations, %d variables, %d shocks, "
                  "%d free parameters",
                  len(primitives.equations), model.n_variables,
                  model.n_shocks, len(model.param_names))
    return model
