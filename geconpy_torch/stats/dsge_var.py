"""DSGE-VAR (Del Negro & Schorfheide 2004): VARs with priors from the model.

Mirrors ``geconpy_tpu/stats/dsge_var.py``: ``_multigammaln`` (:35),
``niw_log_marginal`` (:43), ``dsge_var_moments`` (:78), ``_stack_var_data``
(:119), ``dsge_var_marginal_likelihood`` (:131) and
``dsge_var_lambda_profile`` (:158).  The DSGE's population moments
generate ``lambda * T`` dummy observations for a VAR(p) in the
observables; the posterior is matrix-normal-inverse-Wishart in closed
form, and the marginal likelihood as a function of lambda measures how
much the data want to deviate from the model's cross-equation
restrictions:

- lambda -> infinity: the VAR collapses onto the DSGE-implied VAR(p)
  approximation;
- small lambda: an (almost) unrestricted VAR.
- the profile ``log p(Y | theta, lambda)`` peaking at large lambda is
  evidence the DSGE restrictions fit; a peak at small lambda flags
  misspecification.

The linear algebra (slogdet, solves, the multivariate log-gamma) and the
DSGE-implied moments (the doubling Lyapunov solve) run on the state
space's device in float64.  The reference's profile frame becomes a
:class:`DSGEVARProfile` (lambdas, log_ml, lambda_min); the profile solves
the model once, where the reference solves it again at every lambda (the
same solution).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .covariance import autocovariance

__all__ = ["DSGEVARProfile", "dsge_var_moments",
           "dsge_var_marginal_likelihood", "dsge_var_lambda_profile",
           "niw_log_marginal"]


class DSGEVARProfile(NamedTuple):
    lambdas: np.ndarray        # the proper lambdas of the grid, in order
    log_ml: np.ndarray         # ln p(Y | theta, lambda) at each
    lambda_min: float          # (k + n - 1) / T_eff, the properness bound


def _multigammaln(a, d: int):
    a = torch.as_tensor(a, dtype=torch.float64)
    j = torch.arange(1, d + 1, dtype=a.dtype, device=a.device)
    return (d * (d - 1) / 4.0) * math.log(math.pi) \
        + torch.sum(torch.lgamma(a - (j - 1) / 2.0))


def niw_log_marginal(Gxx, Gxy, Gyy, XtX, XtY, YtY, T: int, lam: float):
    """Log marginal likelihood of T VAR observations under the
    dummy-observation prior (lam * T artificial observations with second
    moments Gxx/Gxy/Gyy).

    Matrix-normal-inverse-Wishart conjugacy:
    ``ln p(Y) = -nT/2 ln pi + n/2 (ln|P0| - ln|P1|)
    + nu0/2 ln|S0| - nu1/2 ln|S1| + ln Gamma_n(nu1/2) - ln Gamma_n(nu0/2)``
    with P0 = lam T Gxx, S0 = lam T (Gyy - Gyx Gxx^{-1} Gxy),
    nu0 = lam T - k, P1 = P0 + X'X, nu1 = nu0 + T.

    Requires ``lam * T > k + n - 1`` for a proper prior.
    """
    n = Gyy.shape[0]
    k = Gxx.shape[0]
    lt = lam * T
    nu0 = lt - k
    nu1 = nu0 + T

    P0 = lt * Gxx
    S0 = lt * (Gyy - Gxy.mT @ torch.linalg.solve(Gxx, Gxy))
    P1 = P0 + XtX
    A = lt * Gxy + XtY                       # P1 @ Phi1
    S1 = lt * Gyy + YtY - A.mT @ torch.linalg.solve(P1, A)

    _, ld_P0 = torch.linalg.slogdet(P0)
    _, ld_P1 = torch.linalg.slogdet(P1)
    _, ld_S0 = torch.linalg.slogdet(S0)
    _, ld_S1 = torch.linalg.slogdet(S1)
    return (-0.5 * n * T * math.log(math.pi)
            + 0.5 * n * (ld_P0 - ld_P1)
            + 0.5 * nu0 * ld_S0 - 0.5 * nu1 * ld_S1
            + _multigammaln(torch.as_tensor(nu1 / 2.0, device=Gxx.device), n)
            - _multigammaln(torch.as_tensor(nu0 / 2.0, device=Gxx.device), n))


def dsge_var_moments(sol: dict, p: int):
    """DSGE-implied VAR(p) second-moment matrices for the observables.

    ``sol`` is one draw's solution dict from ``DSGEStateSpace.
    build_solution_fn(full_state=True)``: T_aug/R_aug/Q/Z/H/d.  Regressor
    order: ``[y_{t-1}, ..., y_{t-p}, 1]``.  Returns (Gxx, Gxy, Gyy) of
    *non-central* moments (means included, intercept row/col appended).
    """
    T, R = sol["T_aug"], sol["R_aug"]
    Q, Z, H, d = sol["Q"], sol["Z"], sol["H"], sol["d"]
    n = Z.shape[0]

    gam = autocovariance(T, R, Q, n_lags=p + 1)          # (p+1, nx, nx)
    A = Z @ gam @ Z.mT                                   # Z T^h Sig Z'
    A = torch.cat([(A[0] + H)[None], A[1:]])             # ME enters lag 0
    mu = d
    mm = torch.outer(mu, mu)

    # Gxx: (n p + 1) square; block (i, j) = E[y_{t-i} y_{t-j}']
    def block(i, j):
        dlag = j - i
        return (A[dlag] if dlag >= 0 else A[-dlag].mT) + mm

    k = n * p + 1
    Gxx = A.new_zeros((k, k))
    for i in range(1, p + 1):
        for j in range(1, p + 1):
            Gxx[(i - 1) * n:i * n, (j - 1) * n:j * n] = block(i, j)
        Gxx[(i - 1) * n:i * n, -1] = mu
        Gxx[-1, (i - 1) * n:i * n] = mu
    Gxx[-1, -1] = 1.0

    # Gxy: rows i = E[y_{t-i} y_t'] = A(i)' + mm; intercept row = mu'
    Gxy = torch.cat([A[i].mT + mm for i in range(1, p + 1)] + [mu[None, :]],
                    dim=0)
    Gyy = A[0] + mm
    return Gxx, Gxy, Gyy


def _stack_var_data(data: np.ndarray, p: int):
    y = np.asarray(data, dtype=float)
    if np.isnan(y).any():
        raise ValueError("DSGE-VAR requires fully observed data")
    T_all, n = y.shape
    Y = y[p:]
    X = np.concatenate(
        [y[p - i:T_all - i] for i in range(1, p + 1)]
        + [np.ones((T_all - p, 1))], axis=1)
    return X, Y


def _solved_moments(ss_mod, p: int, u):
    if u is None:
        u = ss_mod.initial_position()
    u = torch.as_tensor(u, dtype=torch.float64, device=ss_mod._device())
    with torch.no_grad():
        sol = ss_mod.build_solution_fn(full_state=True)(u)
        if not bool(sol["ss_success"] & sol["solver_success"]):
            raise RuntimeError(
                "DSGE solution failed at the supplied parameters")
        return dsge_var_moments(sol, p)


def _log_ml(moments, X, Y, lam: float):
    Gxx, Gxy, Gyy = moments
    T_eff = Y.shape[0]

    def put(a):
        return torch.as_tensor(a, dtype=Gxx.dtype, device=Gxx.device)

    return float(niw_log_marginal(Gxx, Gxy, Gyy, put(X.T @ X), put(X.T @ Y),
                                  put(Y.T @ Y), T=T_eff, lam=float(lam)))


def dsge_var_marginal_likelihood(ss_mod, data: np.ndarray, lam: float,
                                 p: int = 4, u=None) -> float:
    """``ln p(Y | theta, lambda)`` for the VAR(p) with the DSGE prior.

    ``u``: unconstrained parameter vector (defaults to the prior
    mean/initial calibration, ``ss_mod.initial_position()``).
    """
    X, Y = _stack_var_data(data, p)
    T_eff, n = Y.shape
    k = X.shape[1]
    if lam * T_eff <= k + n - 1:
        raise ValueError(
            f"lambda too small for a proper prior: need lambda * {T_eff} > "
            f"{k + n - 1}, got {lam * T_eff:.1f}")
    return _log_ml(_solved_moments(ss_mod, p, u), X, Y, lam)


def dsge_var_lambda_profile(ss_mod, data: np.ndarray, p: int = 4,
                            lambdas=None, u=None) -> DSGEVARProfile:
    """The DS misspecification profile: log marginal likelihood over a
    lambda grid (plus the minimum proper lambda).  The argmax is the
    data-preferred weight on the DSGE restrictions."""
    X, Y = _stack_var_data(data, p)
    T_eff, n = Y.shape
    k = X.shape[1]
    lam_min = (k + n - 1) / T_eff
    if lambdas is None:
        lambdas = np.unique(np.round(
            np.concatenate([np.linspace(1.05 * lam_min, 1.0, 6),
                            np.array([1.5, 2.0, 5.0, 10.0, 100.0])]), 4))
    proper = [float(lam) for lam in lambdas if lam * T_eff > k + n - 1]
    moments = _solved_moments(ss_mod, p, u) if proper else None
    return DSGEVARProfile(
        lambdas=np.asarray(proper),
        log_ml=np.asarray([_log_ml(moments, X, Y, lam) for lam in proper]),
        lambda_min=lam_min)
