"""Maximum-likelihood estimation (the Dynare default-mode workflow).

Mirrors ``geconpy_tpu/stats/ml.py`` (``MLResult`` :25, ``fit_ml`` :45):
maximize the Kalman log-likelihood alone (no prior term in the objective,
but the search runs in the priors' unconstrained space, so bounds and
positivity hold), then invert the Hessian at the mode for asymptotic
standard errors.  The optimizer and the central-difference Hessian are
:mod:`~geconpy_torch.stats.model_comparison`'s; the reference takes the
exact ``jax.hessian`` where it can, so the standard errors differ from its
by the rounding of the differences.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .model_comparison import find_map, neg_hessian_fn
from .statespace import _value_and_grad

__all__ = ["MLResult", "fit_ml"]


class MLResult(NamedTuple):
    params: dict               # MLE point estimates (constrained)
    std_errors: dict           # inverse-Hessian (delta-method) SEs
    loglik: float              # log-likelihood at the MLE
    aic: float
    bic: float
    success: bool
    unconstrained: np.ndarray  # the mode in unconstrained space

    def summary(self) -> dict:
        """Point estimates with asymptotic (inverse-Hessian) standard
        errors: ``"names"`` and the reference's columns ``estimate``,
        ``std_error`` and ``t_stat``, one array each (the reference returns
        a ``pandas.DataFrame``)."""
        names = list(self.params)
        est = np.asarray([self.params[n] for n in names])
        se = np.asarray([self.std_errors[n] for n in names])
        return {"names": names, "estimate": est, "std_error": se,
                "t_stat": est / se}


def _gated_loglik(ss_mod, data: np.ndarray):
    """The batched value+grad of the flag-gated log-likelihood: a draw
    whose log posterior is not finite (e.g. a solver failure) is ``-inf``,
    so the optimizer rejects it."""
    extras_fn = ss_mod.build_logpost_extras(data)

    def loglik(U: torch.Tensor) -> torch.Tensor:
        ex = extras_fn(U)
        # gate like the posterior does, but on the likelihood alone
        return torch.where(torch.isfinite(ex.logpost), ex.loglik,
                           torch.full_like(ex.loglik, -torch.inf))

    return _value_and_grad(loglik)


def _standard_errors(ss_mod, value_and_grad, u_hat: torch.Tensor):
    """(constrained standard errors, the negative log-likelihood Hessian)
    at ``u_hat``: ``sqrt(diag(J H^{-1} Jᵀ))`` with J the transform
    Jacobian, on the host in float64."""
    H = neg_hessian_fn(value_and_grad)(u_hat).cpu().numpy()
    cov_u = np.linalg.inv(H + 1e-12 * np.eye(H.shape[0]))
    J_c = torch.autograd.functional.jacobian(ss_mod.constrain,
                                             u_hat).cpu().numpy()
    cov_theta = J_c @ cov_u @ J_c.T
    return np.sqrt(np.clip(np.diag(cov_theta), 0, np.inf)), H


def fit_ml(ss_mod, data: np.ndarray, u0=None, adam_steps: int = 500,
           newton_steps: int = 8, learning_rate: float = 0.02) -> MLResult:
    """MLE of the state-space's estimated parameters, on its device in
    float64.

    The objective is the flag-gated log-likelihood (a draw whose log
    posterior is not finite, e.g. a solver failure, is ``-inf`` and
    rejected by the optimizer); SEs are ``sqrt(diag(H^{-1}))`` of the
    negative log-likelihood Hessian at the mode, mapped to constrained
    space through the transform Jacobian.  ``aic``/``bic`` use the number
    of rows of ``data`` with at least one observed entry.
    """
    value_and_grad = _gated_loglik(ss_mod, data)
    if u0 is None:
        u0 = ss_mod.initial_position()
    u0 = torch.as_tensor(u0, dtype=torch.float64, device=ss_mod._device())
    u_hat = find_map(value_and_grad, u0, adam_steps=adam_steps,
                     newton_steps=newton_steps, learning_rate=learning_rate)
    se, _ = _standard_errors(ss_mod, value_and_grad, u_hat)

    theta_hat = ss_mod.constrain(u_hat).cpu().numpy()
    ll = float(value_and_grad(u_hat[None])[0][0])
    k = len(theta_hat)
    T_obs = int(np.isfinite(np.asarray(data)).any(axis=1).sum())
    names = ss_mod.param_labels
    return MLResult(
        params=dict(zip(names, theta_hat.tolist())),
        std_errors=dict(zip(names, se.tolist())),
        loglik=ll,
        aic=2 * k - 2 * ll,
        bic=k * np.log(max(T_obs, 1)) - 2 * ll,
        success=bool(np.isfinite(ll) and np.isfinite(se).all()),
        unconstrained=u_hat.cpu().numpy(),
    )
