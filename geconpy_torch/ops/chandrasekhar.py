"""Chandrasekhar recursions: the exact Kalman likelihood at O(n² k) a step,
batched.

Mirrors ``geconpy_tpu/ops/chandrasekhar.py`` (``chandrasekhar_loglik``,
:30-93).  For a time-invariant system started at its stationary
covariance (P₁ = T P₁ Tᵀ + R Q Rᵀ, the DSGE likelihood's start) the
increment of the predictive covariance has rank <= k: P_{t+1} − P_t =
W_t M_t W_tᵀ with W (n x k), M (k x k) (Morf-Sidhu-Kailath; Herbst 2015).
Propagating (F, G, K, W, M) in place of P replaces the n x n x n products
of a step with n x n x k ones.  Exact, fully observed data only; a draw
whose innovation covariance is not positive definite gets -inf.
"""

from __future__ import annotations

import torch

from .kalman import _LOG2PI, _chol_nan
from .lyapunov import solve_discrete_lyapunov
from .precision import highest_precision

__all__ = ["chandrasekhar_loglik"]


def _logdet(chol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


@highest_precision()
def chandrasekhar_loglik(y, T, R, Q, Z, H, d=None, x0=None, P0=None):
    """Exact log-likelihood by the Chandrasekhar recursions.

    ``y`` (periods, k) shared and fully observed; T (..., n, n),
    R (..., n, m), Q (..., m, m), Z (..., k, n), H (..., k, k), d (..., k).
    ``P0`` defaults to the stationary covariance (Lyapunov doubling, with
    its adjoint), which the recursion's start requires.  Differentiable by
    autograd through the recursion.
    """
    dtype = T.dtype
    y = y.to(dtype)
    k = Z.shape[-2]
    if d is None:
        d = T.new_zeros(T.shape[:-2] + (k,))
    if x0 is None:
        x0 = T.new_zeros(T.shape[:-1])
    if P0 is None:
        P0 = solve_discrete_lyapunov(T, R @ Q @ R.mT)
    # stationary start: the predicted P₁ = T P0 Tᵀ + RQR equals P0
    F = Z @ P0 @ Z.mT + H
    G = T @ P0 @ Z.mT
    chol = _chol_nan(F)
    K = torch.cholesky_solve(G.mT, chol).mT
    W, M = K, -F
    x = (T @ x0[..., None])[..., 0]
    ll = T.new_zeros(torch.broadcast_shapes(T.shape[:-2], Z.shape[:-2]))
    for t in range(y.shape[-2]):
        v = y[..., t, :] - (Z @ x[..., None])[..., 0] - d
        w = torch.cholesky_solve(v[..., None], chol)[..., 0]
        ll = ll - 0.5 * (k * _LOG2PI + _logdet(chol) + (v * w).sum(-1))
        x = (T @ x[..., None])[..., 0] + (K @ v[..., None])[..., 0]
        ZW = Z @ W
        MZWt = M @ ZW.mT
        F = F + ZW @ MZWt
        F = 0.5 * (F + F.mT)
        G = G + T @ (W @ MZWt)
        # the reference factors F again at the next step's start: the same
        # input gives the same factor, so it is factored once
        chol_next = _chol_nan(F)
        K_next = torch.cholesky_solve(G.mT, chol_next).mT
        # M_{t+1} = M_t − M_t (ZW)ᵀ F_{t+1}⁻¹ (ZW) M_t
        M = M - MZWt @ torch.cholesky_solve(ZW @ M, chol_next)
        M = 0.5 * (M + M.mT)
        W = T @ W - K @ ZW
        K, chol = K_next, chol_next
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))
