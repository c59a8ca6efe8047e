"""Parallel-in-time Kalman filter by an associative scan, batched.

Mirrors ``geconpy_tpu/ops/parallel_kalman.py``: ``_Element`` (:42),
``_combine`` (:50), ``_masked_obs`` (:84), ``parallel_kalman_filter``
(:96-203) and ``parallel_kalman_loglik`` (:205).  Filtering is
associative (Särkkä & García-Fernández 2021): each period carries the
element (A, b, C, eta, J) of p(x_t | x_{t-1}, y_t) = N(A x_{t-1} + b, C)
and its information-form message (eta, J), and the prefix combination of
the elements gives the filtered moments, so the 200-period recursion
becomes a scan of depth O(log periods) whose every level is one batched
set of n x n solves and products over the periods.  The one-step-ahead
predictions and the log-likelihood then follow elementwise in t.  Missing
data use the sequential filter's masking.

torch has no associative scan: :func:`_associative_scan` writes
``jax.lax.associative_scan``'s own schedule by hand (combine adjacent
pairs, recurse on the reduced sequence, combine the results with the
even elements, interleave), so each prefix is combined in the
reference's order.  Elements carry the periods on their first dimension,
before the batch dimensions.  The three solves with M = I + C_i J_j and
the two with Mᵀ of a combination share one LU factorisation; a singular
M gives NaN, never an exception.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kalman import _LOG2PI, KalmanFilterResult, _chol_nan
from .lyapunov import solve_discrete_lyapunov
from .precision import highest_precision

__all__ = ["parallel_kalman_filter", "parallel_kalman_loglik"]


class _Element(NamedTuple):
    A: torch.Tensor      # (periods, ..., n, n)
    b: torch.Tensor      # (periods, ..., n)
    C: torch.Tensor      # (periods, ..., n, n)
    eta: torch.Tensor    # (periods, ..., n)
    J: torch.Tensor      # (periods, ..., n, n)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.mT)


def _combine(left: _Element, right: _Element) -> _Element:
    """The associative combination of filtering elements, batched over the
    periods and the draws."""
    A_i, b_i, C_i, eta_i, J_i = left
    A_j, b_j, C_j, eta_j, J_j = right
    n = A_i.shape[-1]
    M = torch.eye(n, dtype=A_i.dtype, device=A_i.device) + C_i @ J_j
    LU, piv, info = torch.linalg.lu_factor_ex(M)
    bad = (info != 0)[..., None, None]

    def solve(X, adjoint=False):
        out = torch.linalg.lu_solve(LU, piv, X, adjoint=adjoint)
        return torch.where(bad, torch.full_like(out, torch.nan), out)

    MinvA_i = solve(A_i)
    Minv_bCeta = solve((b_i + _mv(C_i, eta_j))[..., None])[..., 0]
    MinvC_i = solve(C_i)
    A = A_j @ MinvA_i
    b = _mv(A_j, Minv_bCeta) + b_j
    C = _sym(A_j @ MinvC_i @ A_j.mT + C_j)
    # I + J_j C_i = Mᵀ (C and J symmetric)
    Linv_rhs = solve((eta_j - _mv(J_j, b_i))[..., None], adjoint=True)[..., 0]
    LinvJA = solve(J_j @ A_i, adjoint=True)
    A_iT = A_i.mT
    eta = _mv(A_iT, Linv_rhs) + eta_i
    J = _sym(A_iT @ LinvJA + J_i)
    return _Element(A, b, C, eta, J)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 0; ``even`` has as many entries as
    ``odd`` or one more."""
    pairs = torch.stack([even[:odd.shape[0]], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[odd.shape[0]:]], dim=0)


def _associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive prefix combination along dim 0 in
    ``jax.lax.associative_scan``'s order."""
    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = fn(type(elems)(*(e[0:-1:2] for e in elems)),
                 type(elems)(*(e[1::2] for e in elems)))
    odd = _associative_scan(fn, reduced)
    rest = type(elems)(*(e[2::2] for e in elems))
    if num % 2 == 0:
        head = type(elems)(*(o[:-1] for o in odd))
    else:
        head = odd
    even = fn(head, rest) if rest[0].shape[0] else rest
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return type(elems)(*(_interleave(e, o) for e, o in zip(even, odd)))


def _masked_obs(y, Z, H, d, n_batch: int):
    """The masked observation model of every period (NaN = missing), with
    the periods first: y_eff (periods, 1.., k), Z_eff (periods, ..., k, n),
    H_eff (periods, ..., k, k), d_eff (periods, ..., k), maskf."""
    periods, k = y.shape
    mask = torch.isfinite(y)
    maskf = mask.to(Z.dtype).reshape((periods,) + (1,) * n_batch + (k,))
    y_eff = torch.where(mask, y, torch.zeros_like(y)) \
        .reshape(maskf.shape)
    Z_eff = Z * maskf[..., :, None]
    H_eff = H * (maskf[..., :, None] * maskf[..., None, :]) \
        + torch.diag_embed(1.0 - maskf)
    return y_eff, Z_eff, H_eff, d * maskf, maskf


@highest_precision()
def parallel_kalman_filter(y, T, R, Q, Z, H, d=None, x0=None, P0=None
                           ) -> KalmanFilterResult:
    """Associative-scan Kalman filter with the inputs and results of
    :func:`~geconpy_torch.ops.kalman.kalman_filter`: ``y`` (periods, k)
    shared, NaN = missing; T (..., n, n), R (..., n, m), Q (..., m, m),
    Z (..., k, n), H (..., k, k), d (..., k); ``P0`` defaults to the
    unconditional covariance.  Differentiable by autograd through the
    scan."""
    dtype = T.dtype
    y = y.to(dtype)
    n, k = T.shape[-1], Z.shape[-2]
    batch = torch.broadcast_shapes(T.shape[:-2], R.shape[:-2], Q.shape[:-2],
                                   Z.shape[:-2], H.shape[:-2])
    eye = torch.eye(n, dtype=dtype, device=T.device)
    if d is None:
        d = T.new_zeros(batch + (k,))
    if x0 is None:
        x0 = T.new_zeros(batch + (n,))
    if P0 is None:
        P0 = solve_discrete_lyapunov(T, R @ Q @ R.mT)
    Qt = R @ Q @ R.mT
    # a jitter on the process noise, which is singular with fewer shocks
    # than states, for the conditioning of the C_i J_j chains
    jitter = 1e-12 * (torch.diagonal(Qt, dim1=-2, dim2=-1).sum(-1) / n + 1.0)
    Qt = Qt + jitter[..., None, None] * eye

    y_eff, Z_t, H_t, d_t, maskf = _masked_obs(y, Z, H, d, len(batch))
    y_c = y_eff - d_t           # the intercept folded into the data

    # the generic elements, every period at once
    S = Z_t @ Qt @ Z_t.mT + H_t
    chol = _chol_nan(S)
    SinvZ = torch.cholesky_solve(Z_t, chol)
    K = Qt @ SinvZ.mT
    IKZ = eye - K @ Z_t
    A = IKZ @ T
    b = _mv(K, y_c)
    C = _sym(IKZ @ Qt)
    eta = (T.mT @ Z_t.mT @ torch.cholesky_solve(y_c[..., None], chol))[..., 0]
    J = _sym(T.mT @ Z_t.mT @ SinvZ @ T)

    # the first element: the update of the prior's prediction
    m1_pred = _mv(T, x0)
    P1_pred = T @ P0 @ T.mT + Qt
    Z1, H1, y1 = Z_t[0], H_t[0], y_c[0]
    S1 = Z1 @ P1_pred @ Z1.mT + H1
    chol1 = _chol_nan(S1)
    K1 = P1_pred @ Z1.mT @ torch.cholesky_solve(
        torch.eye(k, dtype=dtype, device=T.device).expand(S1.shape), chol1)
    b1 = m1_pred + _mv(K1, y1 - _mv(Z1, m1_pred))
    C1 = _sym(P1_pred - K1 @ Z1 @ P1_pred)

    def first(X, X0):
        X, X0 = torch.broadcast_tensors(X, X0[None])
        return torch.cat([X0[:1], X[1:]], dim=0)

    zero_nn = torch.zeros(batch + (n, n), dtype=dtype, device=T.device)
    zero_n = torch.zeros(batch + (n,), dtype=dtype, device=T.device)
    elems = _Element(first(A, zero_nn), first(b, b1), first(C, C1),
                     first(eta, zero_n), first(J, zero_nn))
    prefix = _associative_scan(_combine, elems)
    filtered_mean, filtered_cov = prefix.b, prefix.C

    # one-step-ahead predictions, elementwise in t
    x0b = x0.expand(batch + (n,))
    P0b = P0.to(dtype).expand(batch + (n, n))
    prev_mean = torch.cat([x0b[None], filtered_mean[:-1]], dim=0)
    prev_cov = torch.cat([P0b[None], filtered_cov[:-1]], dim=0)
    pred_mean = _mv(T, prev_mean)
    pred_cov = T @ prev_cov @ T.mT + Qt

    # the log-likelihood from the innovations
    v = y_c - _mv(Z_t, pred_mean)
    S = Z_t @ pred_cov @ Z_t.mT + H_t
    chol = _chol_nan(S)
    w = torch.cholesky_solve(v[..., None], chol)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    ll_t = -0.5 * (maskf.sum(-1) * _LOG2PI + logdet + (v * w).sum(-1))
    ll_t = ll_t.expand((y.shape[0],) + batch).movedim(0, -1)
    return KalmanFilterResult(
        ll_t.sum(-1), ll_t, filtered_mean.movedim(0, -2),
        filtered_cov.movedim(0, -3), pred_mean.movedim(0, -2),
        pred_cov.movedim(0, -3))


def parallel_kalman_loglik(y, T, R, Q, Z, H, d=None, x0=None, P0=None):
    """Total log-likelihood of :func:`parallel_kalman_filter`; -inf on
    non-finite (rejected) draws."""
    ll = parallel_kalman_filter(y, T, R, Q, Z, H, d, x0, P0).loglik
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))
