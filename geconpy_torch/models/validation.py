"""Steady-state validation helpers.

Mirrors ``geconpy_tpu/models/validation.py``
(``evaluate_steady_state_residuals`` :23, ``check_steady_state`` :52):
evaluate the full steady-state residual vector for a candidate steady
state and report the offending equations when it fails.  Host-side
convenience over the model's compiled residual functions; the steady
state, when it is not given, is solved on ``device``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.tolerances import success_tol

_log = logging.getLogger(__name__)

__all__ = ["evaluate_steady_state_residuals", "check_steady_state"]

_FLOAT_ZERO = 1e-8


def evaluate_steady_state_residuals(model, steady_state, **parameter_updates
                                    ) -> np.ndarray:
    """Residuals of every model equation (plus calibrating equations) at a
    candidate steady state, float64 on the host.

    ``steady_state`` maps steady-state symbols (or their string names,
    e.g. ``"C_ss"``) to values: typically a
    :class:`~geconpy_torch.symbolic.containers.SteadyStateResults`.
    """
    mf = model.functions

    def lookup(sym):
        if sym in steady_state:
            return float(steady_state[sym])
        return float(steady_state[str(sym)])

    theta = model.default_theta(**parameter_updates)
    theta_full = mf.f_params(theta)
    if mf.calibrated_params:
        calib = torch.tensor([lookup(p) for p in mf.calibrated_params],
                             dtype=torch.float64)
        theta_full = torch.cat([theta_full, calib])
    x_ss = torch.tensor([lookup(v.to_ss()) for v in mf.variables],
                        dtype=torch.float64)
    with torch.no_grad():
        resid = mf.f_ss_resid(x_ss, theta_full)
        if mf.calibrated_params:
            resid = torch.cat([resid, mf.f_calib_resid(x_ss, theta_full)])
    return resid.numpy()


def check_steady_state(model, steady_state=None,
                       steady_state_kwargs: dict | None = None,
                       tol: float | None = None, *,
                       device: str | torch.device = "cuda",
                       **parameter_updates) -> bool:
    """Verify a steady state satisfies every model equation.

    Solves the steady state first (on ``device``) when ``steady_state`` is
    not given.  On failure, logs each equation whose residual exceeds
    ``tol`` (default ``success_tol`` of the residuals' dtype, 1e-8 in
    float64) with the residual's value.  Returns ``True`` when all
    residuals are within tolerance.
    """
    if steady_state is None:
        steady_state = model.steady_state(
            verbose=False, **(steady_state_kwargs or {}), device=device,
            **parameter_updates)

    resid = evaluate_steady_state_residuals(model, steady_state,
                                            **parameter_updates)
    if tol is None:
        tol = success_tol(resid.dtype, _FLOAT_ZERO)
    bad = np.abs(resid) > tol
    if not bad.any():
        _log.info("Steady state successfully found! (max |resid| %.3e)",
                  float(np.max(np.abs(resid))) if resid.size else 0.0)
        return True

    _log.warning("Steady state NOT successful. Equations with non-zero "
                 "residuals:")
    prim = model.primitives
    equations = list(prim.equations) + [
        prim.calib_dict[p] for p in model.functions.calibrated_params]
    for i in np.flatnonzero(bad):
        eq = equations[i] if i < len(equations) else f"calibrating eq {i}"
        _log.warning("  %s", eq)
        _log.warning("  residual: %0.6g", float(resid[i]))
    return False
