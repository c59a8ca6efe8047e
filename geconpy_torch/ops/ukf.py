"""Unscented Kalman filters for the pruned second-order state space,
batched over leading (draw) dimensions.

Mirrors ``geconpy_tpu/ops/ukf.py``: ``_sigma_weights`` (:63),
``_ukf_forward`` (:73), ``ukf_loglik`` (:224), ``ukf_smoother`` (:239),
``CLUKFResult`` and the marginalized filter ``cl_ukf_loglik`` (:275-391).

- Sigma points over the augmented (state, shock) vector, laid out
  [centre, +dx, -dx, +de, -de] (the square root of the block-diagonal
  covariance is chol(P) (+) chol(Q)); the update re-draws its points at
  the predicted density, with the PSD floor ``100 eps max(diag, 1)``
  committed into P_pred.
- Missing observations (NaN) get unit variance and a zero innovation.
- Failure is a flag: a Cholesky factor that fails is NaN
  (``cholesky_ex``), the step's log-likelihood is then non-finite, the
  filter freezes that draw's state and ``success`` is False for it.
- The reference's per-draw closures ``transition(x, eps)`` and
  ``observe(x)`` become batched functions: ``transition(x (..., S, n),
  eps (..., S, q)) -> (..., S, n)`` and ``observe(x (..., S, n)) ->
  (..., S, k)``, S the sigma points; ``nonlinear(z_n (..., S, n_nl), eps
  (..., S, q)) -> (..., S, nz)`` for :func:`cl_ukf_loglik`.
- ``y`` (periods, k) is shared by every draw, or (..., periods, k).
  Results carry the time axis after the batch dimensions.
- ``remat=True`` (the reference's ``jax.checkpoint`` of the scan body) runs
  each step under ``torch.utils.checkpoint.checkpoint(use_reentrant=
  False)``: the backward pass recomputes the step instead of storing its
  intermediates.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .cycle_reduction import _solve_nan
from .kalman import _chol_nan
from .precision import highest_precision

__all__ = ["UKFResult", "UKFSmootherResult", "CLUKFResult",
           "ukf_loglik", "ukf_smoother", "cl_ukf_loglik"]

_LOG2PI = 1.8378770664093453


class UKFResult(NamedTuple):
    loglik: torch.Tensor          # (...,) total log-likelihood
    loglik_t: torch.Tensor        # (..., periods)
    filtered_mean: torch.Tensor   # (..., periods, n)
    filtered_cov: torch.Tensor    # (..., periods, n, n)
    success: torch.Tensor         # (...,) bool


class UKFSmootherResult(NamedTuple):
    smoothed_mean: torch.Tensor   # (..., periods, n)
    smoothed_cov: torch.Tensor    # (..., periods, n, n)
    filtered_mean: torch.Tensor
    filtered_cov: torch.Tensor
    loglik: torch.Tensor
    success: torch.Tensor


class CLUKFResult(NamedTuple):
    loglik: torch.Tensor
    loglik_t: torch.Tensor
    filtered_mean: torch.Tensor
    filtered_cov: torch.Tensor
    success: torch.Tensor


def _sigma_weights(L: int, alpha: float, beta: float, kappa: float, like):
    """(wm, wc, gamma) of the scaled unscented transform over L dims."""
    lam = alpha * alpha * (L + kappa) - L
    c = L + lam
    wm = torch.full((2 * L + 1,), 1.0 / (2.0 * c), dtype=like.dtype,
                    device=like.device)
    wm[0] = lam / c
    wc = wm.clone()
    wc[0] = lam / c + (1.0 - alpha * alpha + beta)
    return wm, wc, math.sqrt(c)


def _max_diag(P: torch.Tensor) -> torch.Tensor:
    """max(max |diag P|, 1) per draw, shaped to scale an identity."""
    d = torch.diagonal(P, dim1=-2, dim2=-1).abs().amax(dim=-1)
    return torch.clamp(d, min=1.0)[..., None, None]


def _weighted_cov(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Σ_s w[s] a[..., s, :]ᵀ b[..., s, :]."""
    return (a * w[:, None]).mT @ b


def _masked(y_t: torch.Tensor, H: torch.Tensor):
    """(y_eff, maskf, H_eff) of a period: missing rows zeroed and given
    unit variance."""
    mask = torch.isfinite(y_t)
    maskf = mask.to(H.dtype)
    y_eff = torch.where(mask, y_t, torch.zeros_like(y_t))
    H_eff = H * (maskf[..., :, None] * maskf[..., None, :]) \
        + torch.diag_embed(1.0 - maskf)
    return y_eff, maskf, H_eff


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b for a vector b (..., k)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _run_steps(step, carry, y: torch.Tensor, remat: bool):
    """Run ``step(*carry, y_t) -> (carry..., outputs...)`` over the periods
    of ``y`` (the time axis second to last), checkpointed when ``remat``:
    returns the final carry and, per output, the list of its periods."""
    n_carry = len(carry)
    outs = []
    for t in range(y.shape[-2]):
        y_t = y[..., t, :]
        res = checkpoint(step, *carry, y_t, use_reentrant=False) if remat \
            else step(*carry, y_t)
        carry = res[:n_carry]
        outs.append(res[n_carry:])
    return carry, list(zip(*outs))


@highest_precision()
def _ukf_forward(y, transition: Callable, observe: Callable, Q, H, x0, P0,
                 alpha: float = 1.0, beta: float = 2.0, kappa: float = 0.0,
                 jitter: float = 0.0, remat: bool = False):
    """Unscented filter forward pass (shared by :func:`ukf_loglik` and
    :func:`ukf_smoother`); returns (UKFResult, (x_pred, P_pred, cross))
    with the per-period predictions and the cross-covariances
    Cov(x_{t-1}^filt, x_t^pred) for the RTS pass."""
    x0 = torch.as_tensor(x0)
    dtype, device = x0.dtype, x0.device
    y = torch.as_tensor(y, dtype=dtype, device=device)
    Q, H, P0 = (torch.as_tensor(M, dtype=dtype, device=device)
                for M in (Q, H, P0))
    n = x0.shape[-1]
    q = Q.shape[-1]
    batch = torch.broadcast_shapes(x0.shape[:-1], P0.shape[:-2],
                                   Q.shape[:-2], H.shape[:-2],
                                   y.shape[:-2])
    L = n + q
    wm, wc, gamma = _sigma_weights(L, alpha, beta, kappa, x0)
    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_q = torch.eye(q, dtype=dtype, device=device)
    eps100 = 100.0 * float(torch.finfo(dtype).eps)
    chol_Q = _chol_nan(Q + eye_q * (jitter + eps100 * _max_diag(Q)))
    de = (gamma * chol_Q.mT).expand(batch + (q, q))
    zeros_e = x0.new_zeros(batch + (1 + 2 * n, q))
    es = torch.cat([zeros_e, de, -de], dim=-2)            # (..., 2L+1, q)
    cu = gamma ** 2
    lam_u = cu - n
    wmu = torch.full((2 * n + 1,), 1.0 / (2.0 * cu), dtype=dtype,
                     device=device)
    wmu[0] = lam_u / cu
    wcu = wmu.clone()
    wcu[0] = lam_u / cu + (1.0 - alpha * alpha + beta)

    def step(x, P, y_t):
        Ps = 0.5 * (P + P.mT)
        chol_P = _chol_nan(Ps + eye_n * (jitter + eps100 * _max_diag(Ps)))
        dx = gamma * chol_P.mT                            # rows = points
        xr = x.unsqueeze(-2)
        xs = torch.cat([xr, xr + dx, xr - dx,
                        xr.expand(batch + (2 * q, n))], dim=-2)
        xp = transition(xs, es)                           # (..., 2L+1, n)
        x_pred = wm @ xp
        dxp = xp - x_pred.unsqueeze(-2)
        P_pred = _weighted_cov(wc, dxp, dxp)
        P_pred = 0.5 * (P_pred + P_pred.mT)
        P_pred = P_pred + eye_n * (jitter + eps100 * _max_diag(P_pred))
        chol_Pp = _chol_nan(P_pred)
        dxu = gamma * chol_Pp.mT
        xpr = x_pred.unsqueeze(-2)
        xu = torch.cat([xpr, xpr + dxu, xpr - dxu], dim=-2)
        yp = observe(xu)                                  # (..., 2n+1, k)
        y_eff, maskf, H_eff = _masked(y_t, H)
        yp_eff = yp * maskf.unsqueeze(-2)
        y_hat = wmu @ yp_eff
        dy = yp_eff - y_hat.unsqueeze(-2)
        S = _weighted_cov(wcu, dy, dy) + H_eff
        Pxy = _weighted_cov(wcu, xu - xpr, dy)
        v = y_eff - y_hat
        chol_S = _chol_nan(S)
        w = _cho_solve(chol_S, v)
        K = torch.cholesky_solve(Pxy.mT, chol_S).mT
        x_filt = x_pred + (K @ v[..., None])[..., 0]
        P_filt = P_pred - K @ S @ K.mT
        P_filt = 0.5 * (P_filt + P_filt.mT)
        logdet = 2.0 * torch.log(torch.diagonal(chol_S, dim1=-2,
                                                dim2=-1)).sum(-1)
        ll_t = -0.5 * (maskf.sum(-1) * _LOG2PI + logdet + (v * w).sum(-1))
        ok = torch.isfinite(ll_t) & torch.isfinite(x_filt).all(dim=-1)
        x_next = torch.where(ok[..., None], x_filt, x)
        P_next = torch.where(ok[..., None, None], P_filt, P)
        cross = _weighted_cov(wc, xs - xr, dxp)
        return x_next, P_next, ll_t, x_filt, P_filt, x_pred, P_pred, \
            cross, ok

    carry = (x0.expand(batch + (n,)), P0.expand(batch + (n, n)))
    _, cols = _run_steps(step, carry, y.expand(batch + y.shape[-2:]), remat)
    # the time axis right after the batch dimensions
    ll_t, means, covs, preds, pred_covs, crosses, oks = (
        torch.stack(c, dim=len(batch)) for c in cols)
    res = UKFResult(ll_t.sum(-1), ll_t, means, covs, oks.all(dim=-1))
    return res, (preds, pred_covs, crosses)


def ukf_loglik(y, transition: Callable, observe: Callable, Q, H, x0, P0,
               alpha: float = 1.0, beta: float = 2.0, kappa: float = 0.0,
               jitter: float = 0.0, remat: bool = False) -> UKFResult:
    """Unscented filter log-likelihood of ``y`` (NaN = missing) for the
    state space x' = transition(x, eps), eps ~ N(0, Q), y = observe(x) +
    N(0, H), from x0 ~ N(x0, P0); batched over leading dimensions (see the
    module docstring for the functions' shapes).  ``jitter`` adds to the
    automatic PSD floor of each factorization; ``remat`` recomputes each
    step in the backward pass.  ``success`` is False for a draw where a
    factorization failed or a value went non-finite."""
    res, _ = _ukf_forward(y, transition, observe, Q, H, x0, P0, alpha,
                          beta, kappa, jitter, remat)
    return res


@highest_precision()
def ukf_smoother(y, transition: Callable, observe: Callable, Q, H, x0, P0,
                 alpha: float = 1.0, beta: float = 2.0, kappa: float = 0.0,
                 jitter: float = 0.0) -> UKFSmootherResult:
    """Unscented RTS smoother: E[x_t | y_{1:T}] with the sigma-point
    cross-covariance C_t = Cov(x_t^filt, x_{t+1}^pred), G_t = C_t
    P_pred(t+1)⁻¹ (same conventions as :func:`ukf_loglik`)."""
    res, (preds, pred_covs, crosses) = _ukf_forward(
        y, transition, observe, Q, H, x0, P0, alpha, beta, kappa, jitter)
    means, covs = res.filtered_mean, res.filtered_cov
    x_s, P_s = means[..., -1, :], covs[..., -1, :, :]
    xs_out, Ps_out = [x_s], [P_s]
    for t in range(means.shape[-2] - 2, -1, -1):
        x_f, P_f = means[..., t, :], covs[..., t, :, :]
        x_p, P_p = preds[..., t + 1, :], pred_covs[..., t + 1, :, :]
        G = _solve_nan(P_p.mT, crosses[..., t + 1, :, :].mT).mT
        x_s = x_f + (G @ (x_s - x_p)[..., None])[..., 0]
        P_s = P_f + G @ (P_s - P_p) @ G.mT
        P_s = 0.5 * (P_s + P_s.mT)
        xs_out.append(x_s)
        Ps_out.append(P_s)
    sm = torch.stack(xs_out[::-1], dim=-2)
    sc = torch.stack(Ps_out[::-1], dim=-3)
    ok = res.success & torch.isfinite(sm).all(dim=(-2, -1))
    return UKFSmootherResult(sm, sc, means, covs, res.loglik, ok)


@highest_precision()
def cl_ukf_loglik(y, A, nonlinear: Callable, Z, H, d, Q, x0, P0, n_nl: int,
                  alpha: float = 1.0, beta: float = 2.0, kappa: float = 0.0,
                  jitter: float = 0.0, remat: bool = False) -> CLUKFResult:
    """Marginalized (Rao-Blackwellized) unscented filter for

        z' = A z + b(z[:n_nl], eps),    y = Z z + d + eta:

    sigma points over (z[:n_nl], eps) only, the conditional remainder
    propagated exactly through A, and an exact masked Kalman update in
    Joseph form.  Batched over leading dimensions; ``d`` may be None."""
    x0 = torch.as_tensor(x0)
    dtype, device = x0.dtype, x0.device
    y = torch.as_tensor(y, dtype=dtype, device=device)
    A, Z, H, Q, P0 = (torch.as_tensor(M, dtype=dtype, device=device)
                      for M in (A, Z, H, Q, P0))
    d = Z.new_zeros(Z.shape[:-1]) if d is None \
        else torch.as_tensor(d, dtype=dtype, device=device)
    nz = x0.shape[-1]
    q = Q.shape[-1]
    batch = torch.broadcast_shapes(x0.shape[:-1], P0.shape[:-2],
                                   A.shape[:-2], Z.shape[:-2], Q.shape[:-2],
                                   H.shape[:-2], y.shape[:-2])
    L = n_nl + q
    wm, wc, gamma = _sigma_weights(L, alpha, beta, kappa, x0)
    eps100 = 100.0 * float(torch.finfo(dtype).eps)
    eye_nl = torch.eye(n_nl, dtype=dtype, device=device)
    eye_nz = torch.eye(nz, dtype=dtype, device=device)
    eye_q = torch.eye(q, dtype=dtype, device=device)
    chol_Q = _chol_nan(Q + eye_q * (jitter + eps100 * _max_diag(Q)))
    de = (gamma * chol_Q.mT).expand(batch + (q, q))
    es = torch.cat([x0.new_zeros(batch + (1 + 2 * n_nl, q)), de, -de],
                   dim=-2)
    zeros_head = x0.new_zeros(batch + (1, n_nl))
    zeros_tail = x0.new_zeros(batch + (2 * q, n_nl))

    def step(x, P, y_t):
        P = 0.5 * (P + P.mT)
        P_nn = P[..., :n_nl, :n_nl]
        chol_nn = _chol_nan(P_nn + eye_nl * (jitter + eps100
                                             * _max_diag(P_nn)))
        # conditional slope of the full state on the nonlinear block
        G = torch.cholesky_solve(P[..., :n_nl, :], chol_nn).mT  # (nz, n_nl)
        dn = gamma * chol_nn.mT
        deltas = torch.cat([zeros_head, dn, -dn, zeros_tail], dim=-2)
        zs = x.unsqueeze(-2) + deltas @ G.mT              # (..., 2L+1, nz)
        fs = zs @ A.mT + nonlinear(zs[..., :n_nl], es)
        x_pred = wm @ fs
        df = fs - x_pred.unsqueeze(-2)
        Sig_c = P - G @ P_nn @ G.mT
        P_pred = _weighted_cov(wc, df, df) + A @ Sig_c @ A.mT
        P_pred = 0.5 * (P_pred + P_pred.mT)
        P_pred = P_pred + eye_nz * (jitter + eps100 * _max_diag(P_pred))
        y_eff, maskf, H_eff = _masked(y_t, H)
        Z_eff = Z * maskf[..., :, None]
        v = y_eff - (Z_eff @ x_pred[..., None])[..., 0] - d * maskf
        PZt = P_pred @ Z_eff.mT
        S = Z_eff @ PZt + H_eff
        chol_S = _chol_nan(S)
        w = _cho_solve(chol_S, v)
        K = torch.cholesky_solve(PZt.mT, chol_S).mT
        x_filt = x_pred + (K @ v[..., None])[..., 0]
        IKZ = eye_nz - K @ Z_eff
        P_filt = IKZ @ P_pred @ IKZ.mT + K @ H_eff @ K.mT   # Joseph form
        P_filt = 0.5 * (P_filt + P_filt.mT)
        logdet = 2.0 * torch.log(torch.diagonal(chol_S, dim1=-2,
                                                dim2=-1)).sum(-1)
        ll_t = -0.5 * (maskf.sum(-1) * _LOG2PI + logdet + (v * w).sum(-1))
        ok = torch.isfinite(ll_t) & torch.isfinite(x_filt).all(dim=-1)
        x_next = torch.where(ok[..., None], x_filt, x)
        P_next = torch.where(ok[..., None, None], P_filt, P)
        return x_next, P_next, ll_t, x_filt, P_filt, ok

    carry = (x0.expand(batch + (nz,)), P0.expand(batch + (nz, nz)))
    _, cols = _run_steps(step, carry, y.expand(batch + y.shape[-2:]), remat)
    ll_t, means, covs, oks = (torch.stack(c, dim=len(batch)) for c in cols)
    return CLUKFResult(ll_t.sum(-1), ll_t, means, covs, oks.all(dim=-1))
