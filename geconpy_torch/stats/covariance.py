"""Unconditional moments of a solved model, on the device.

Mirrors ``geconpy_tpu/stats/covariance.py``: ``build_shock_cov`` (:31),
``build_Q_matrix`` (:43, on the host in numpy, as there),
``stationary_covariance`` (:81, the Lyapunov doubling of
:mod:`~geconpy_torch.ops.lyapunov`), ``autocovariance`` (:89),
``autocorrelation`` (:102), ``fevd`` (:109) and the labelled
``stationary_covariance_matrix`` (:137), ``autocovariance_matrix`` (:148)
and ``autocorrelation_matrix`` (:163), which return tensors with the
variable names (:class:`LabeledMoments`) where the reference returns
DataFrames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis.simulate import _cholesky_nan
from ..ops.lyapunov import solve_discrete_lyapunov
from ..ops.precision import highest_precision

__all__ = [
    "build_shock_cov",
    "build_Q_matrix",
    "stationary_covariance",
    "autocovariance",
    "autocorrelation",
    "fevd",
    "stationary_covariance_matrix",
    "autocovariance_matrix",
    "autocorrelation_matrix",
    "LabeledMoments",
]


class LabeledMoments(NamedTuple):
    values: torch.Tensor     # (n, n) or (n_lags, n, n)
    variables: list[str]


def build_shock_cov(n_shocks: int, shock_std=None, shock_cov=None,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """The shock covariance Q from standard deviations (0.01 each by
    default) or a full covariance."""
    if shock_cov is not None:
        return torch.as_tensor(shock_cov, dtype=dtype, device=device)
    if shock_std is None:
        stds = torch.full((n_shocks,), 0.01, dtype=dtype, device=device)
    else:
        stds = torch.broadcast_to(
            torch.as_tensor(shock_std, dtype=dtype, device=device),
            (n_shocks,))
    return torch.diag(stds ** 2)


def build_Q_matrix(model_shocks, shock_std_dict=None, shock_cov_matrix=None,
                   shock_std=None) -> np.ndarray:
    """Reconcile the user-facing shock-variance options into one Q matrix
    (numpy, on the host).

    ``model_shocks`` is a list of shock names (or symbols with
    ``base_name``); at most one of ``shock_std_dict`` /
    ``shock_cov_matrix`` / ``shock_std`` may be given.  Shocks that
    ``shock_std_dict`` leaves out get zero variance; with no option at
    all, Q = I.
    """
    names = [getattr(s, "base_name", str(s)) for s in model_shocks]
    k = len(names)
    given = [x is not None for x in (shock_std_dict, shock_cov_matrix, shock_std)]
    if sum(given) > 1:
        raise ValueError("specify at most one of shock_std_dict, "
                         "shock_cov_matrix, shock_std")
    if shock_cov_matrix is not None:
        Q = np.asarray(shock_cov_matrix, dtype=float)
        if Q.shape != (k, k):
            raise ValueError(f"shock_cov_matrix must be ({k}, {k}), "
                             f"got {Q.shape}")
        return Q
    if shock_std_dict is not None:
        unknown = set(shock_std_dict) - set(names)
        if unknown:
            raise ValueError(f"shock_std_dict names not in the model: "
                             f"{sorted(unknown)}")
        stds = np.zeros(k)
        for name, sd in shock_std_dict.items():
            stds[names.index(name)] = float(sd)
        return np.diag(stds**2)
    if shock_std is not None:
        stds = np.broadcast_to(np.asarray(shock_std, dtype=float), (k,))
        return np.diag(stds**2)
    return np.eye(k)


def _tensors(T, R, Q):
    T = torch.as_tensor(T)
    return (T, torch.as_tensor(R, dtype=T.dtype, device=T.device),
            torch.as_tensor(Q, dtype=T.dtype, device=T.device))


@highest_precision()
def stationary_covariance(T, R, Q) -> torch.Tensor:
    """Sigma solving  Sigma = T Sigma Tᵀ + R Q Rᵀ  (doubling, on T's
    device)."""
    T, R, Q = _tensors(T, R, Q)
    return solve_discrete_lyapunov(T, R @ Q @ R.mT)


@highest_precision()
def autocovariance(T, R, Q, n_lags: int = 10) -> torch.Tensor:
    """Gamma_k = T^k Sigma for k = 0..n_lags-1: (..., n_lags, n, n) for T
    (..., n, n)."""
    T, R, Q = _tensors(T, R, Q)
    G = stationary_covariance(T, R, Q)
    gammas = []
    for _ in range(n_lags):
        gammas.append(G)
        G = T @ G
    return torch.stack(gammas, dim=-3)


def autocorrelation(T, R, Q, n_lags: int = 10) -> torch.Tensor:
    """Gamma_k normalized by the stationary standard deviations."""
    gammas = autocovariance(T, R, Q, n_lags)
    sd = torch.sqrt(torch.clamp(torch.diagonal(gammas[..., 0, :, :], dim1=-2,
                                               dim2=-1), min=1e-300))
    return gammas / (sd[..., None, :, None] * sd[..., None, None, :])


@highest_precision()
def fevd(T, R, Q, horizon: int = 40) -> torch.Tensor:
    """Forecast-error variance decomposition: the share of each variable's
    h-step-ahead forecast-error variance due to each orthogonalized shock
    (Cholesky of Q), (..., horizon, n_variables, n_shocks), rows summing
    to 1."""
    T, R, Q = _tensors(T, R, Q)
    impact = R @ _cholesky_nan(Q)          # (n, k) orthogonalized impacts
    n = T.shape[-1]
    Phi = torch.eye(n, dtype=T.dtype, device=T.device)
    acc = impact.new_zeros(impact.shape)
    shares = []
    for _ in range(horizon):
        acc = acc + (Phi @ impact) ** 2
        shares.append(acc)
        Phi = T @ Phi
    shares = torch.stack(shares, dim=-3)
    total = shares.sum(dim=-1, keepdim=True)
    return shares / torch.clamp(total, min=1e-300)


# ---- labelled wrappers -------------------------------------------------------

def _solution_Q(solution, shock_std, shock_cov):
    T, R = solution.T, solution.R
    return T, R, build_shock_cov(R.shape[-1], shock_std, shock_cov,
                                 dtype=T.dtype, device=T.device)


def stationary_covariance_matrix(solution, shock_std=None, shock_cov=None
                                 ) -> LabeledMoments:
    """Stationary covariance (n, n) of a solved model, with the variable
    names."""
    Sigma = stationary_covariance(*_solution_Q(solution, shock_std, shock_cov))
    return LabeledMoments(Sigma, list(solution.variables))


def autocovariance_matrix(solution, n_lags: int = 10, shock_std=None,
                          shock_cov=None, correlation: bool = True
                          ) -> LabeledMoments:
    """Autocorrelation (or, with ``correlation=False``, autocovariance)
    matrices Gamma_k, k = 0..n_lags-1, as (n_lags, n, n) with the variable
    names."""
    fn = autocorrelation if correlation else autocovariance
    values = fn(*_solution_Q(solution, shock_std, shock_cov), n_lags)
    return LabeledMoments(values, list(solution.variables))


def autocorrelation_matrix(solution, n_lags: int = 10, shock_std=None,
                           shock_cov=None) -> LabeledMoments:
    """Autocorrelation matrices Gamma_k / (sd sdᵀ), k = 0..n_lags-1."""
    return autocovariance_matrix(solution, n_lags=n_lags, shock_std=shock_std,
                                 shock_cov=shock_cov, correlation=True)
