"""The Kalman filters, settles and smoothers of the likelihood, batched.

Mirrors ``geconpy_tpu/ops/kalman.py``: ``KalmanFilterResult`` (:55),
``KalmanSmootherResult`` (:65), the masked filter step (:69-108, here
:func:`_masked_filter_step`), ``kalman_filter`` (:111) and
``kalman_loglik`` (:154), ``_spd_inverse`` and ``_spd_inverse_logdet``
(:161-184), the pivoted Gauss-Jordan inverse ``_gj_inverse`` (:187),
``_dare_step`` (:220), ``dare_residual_settled`` (:232), the SDA settle
``_sda_settle`` (:252-366), ``_stein_adjoint`` (:369), the implicit DARE
adjoint ``_implicit_dare_P`` (:393-425), the Hewer settle
``_make_hewer_stage`` (:428) and ``_hewer_settle`` (:452), the SDA + Hewer
settle ``_auto_settle`` (:513-562), ``stationary_kalman_loglik`` (:565,
every ``settle_method``), ``stationary_loglik_from_P`` (:643), the exact
filter step ``_filter_step`` (:71, fully observed),
``steady_state_kalman_loglik`` (:679) and ``steady_state_filter_parts``
(:752), whose head runs the masked step where the data miss values, and
the smoothers ``disturbance_smoother`` (:807-873, with
``DisturbanceSmootherResult``, :800) and ``kalman_smoother`` (:876-910).
The steady-state functions are the sweep's ``settle="xla"``, the
independent oracle of the settle kernels (they factor F by Cholesky where
the kernels eliminate by Gauss-Jordan) and the differentiable
``filter_type="steady_state"`` likelihood.  Every function takes leading
batch dimensions (the reference's ``vmap``); the observations ``y``
(periods, k) are shared by the batch.

The reference's ``while_loop``s stop each draw on its own criterion under
``vmap``.  Here a finished draw is frozen by a per-draw mask and the loop
runs while any draw is unfinished, so the ``settled`` flags equal the
reference's and a NaN in one rejected draw stops or poisons no other.
The settles are primal only (the callers detach T, RQR, Z, H); gradients
re-attach at the fixed point through :class:`_ImplicitDareP`.  The
reference's reversed ``lax.scan``s of the smoothers are loops over the
periods from the last.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cycle_reduction import _solve_nan
from .lyapunov import _doubling, amax_abs, solve_discrete_lyapunov
from .precision import highest_precision
from .tolerances import success_tol

__all__ = ["DisturbanceSmootherResult", "KalmanFilterResult",
           "KalmanSmootherResult", "dare_residual_settled",
           "disturbance_smoother", "kalman_filter", "kalman_loglik",
           "kalman_smoother", "stationary_kalman_loglik",
           "stationary_loglik_from_P", "steady_state_filter_parts",
           "steady_state_kalman_loglik"]

# Hewer stage schedule (``kalman.py:32-45``): _N_HEWER unconditional
# stages, then adaptive stages (capped by ``n_settle`` in total) until
# successive iterates agree to _HEWER_RTOL_EPS machine epsilons, or plateau
# at a small update
_N_HEWER = 4
_HEWER_RTOL_EPS = 5.0

_LOG2PI = 1.8378770664093453

#: doubling cap of the Stein adjoint (the reference's)
_STEIN_ITERS = 30


def _spd_inverse_logdet(S: torch.Tensor):
    """(S⁻¹, log det S) by unpivoted Gauss-Jordan (SPD diagonal pivots are
    safe); a non-PD S gives a NaN log det, which the callers reject.
    Differentiable (plain tensor ops)."""
    k = S.shape[-1]
    A = torch.cat([S, torch.eye(k, dtype=S.dtype, device=S.device)
                   .expand(S.shape)], dim=-1)
    logdet = S.new_zeros(S.shape[:-2])
    rows = torch.arange(k, device=S.device)
    for i in range(k):
        d = A[..., i, i]
        logdet = logdet + torch.log(d)
        piv = A[..., i, :] / d[..., None]
        A = A - A[..., :, i:i + 1] * piv[..., None, :]
        A = torch.where((rows == i)[:, None], piv[..., None, :], A)
    return A[..., k:], logdet


def _spd_inverse(S: torch.Tensor) -> torch.Tensor:
    return _spd_inverse_logdet(S)[0]


def _first_argmax(score: torch.Tensor) -> torch.Tensor:
    """Index of the largest entry along the last dim, the first of equal
    ones, and the first NaN where the row holds one: ``jnp.argmax``'s rule,
    which ``torch.argmax`` does not promise on every device."""
    n = score.shape[-1]
    nan = torch.isnan(score)
    top = torch.where(nan, torch.full_like(score, -torch.inf), score) \
        .amax(dim=-1, keepdim=True)
    hit = torch.where(nan.any(dim=-1, keepdim=True), nan, score == top)
    idx = torch.arange(n, device=score.device)
    return torch.where(hit, idx, n).amin(dim=-1)


def _gj_inverse(W: torch.Tensor) -> torch.Tensor:
    """Inverse of a small general matrix by Gauss-Jordan elimination with
    partial pivoting, without row swaps (``kalman.py:187``): the pivot row
    is picked by a one-hot mask among the rows not used yet (ties to the
    first row), each step is one outer-product update, and the rows end in
    pivot order, so the inverse is Lᵀ R of the final [L | R].  A singular
    input gives inf or NaN, which the callers' flags reject."""
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    A = torch.cat([W, eye.expand(W.shape)], dim=-1)
    used = torch.zeros(W.shape[:-1], dtype=torch.bool, device=W.device)
    rows = torch.arange(n, device=W.device)
    for i in range(n):
        col = A[..., :, i]
        score = torch.where(used, -torch.ones_like(col), col.abs())
        onehot = (rows == _first_argmax(score)[..., None]).to(W.dtype)
        pivrow = (onehot[..., :, None] * A).sum(dim=-2)
        pivrow = pivrow / pivrow[..., i:i + 1]
        # rows r != p: A[r] -= A[r, i] * pivrow; row p becomes pivrow
        A = A - (col - onehot)[..., :, None] * pivrow[..., None, :]
        used = used | (onehot > 0.5)
    return A[..., :n].mT @ A[..., n:]


def _dare_step(P, T, RQR, Z, H):
    """One predictive Riccati step  P⁺ = T (P − P Zᵀ S⁻¹ Z P) Tᵀ + RQR,
    S = Z P Zᵀ + H, symmetrised."""
    PZt = P @ Z.mT
    S = Z @ PZt + H
    K = PZt @ _spd_inverse(S)
    P_upd = P - K @ PZt.mT
    P_next = T @ P_upd @ T.mT + RQR
    return 0.5 * (P_next + P_next.mT)


@highest_precision()
def dare_residual_settled(T, RQR, Z, H, P) -> torch.Tensor:
    """Per draw: one Riccati step moves P by at most sqrt(eps)·max|P| of
    P's dtype, and stays finite.  Gates the fixed-length DARE kernel."""
    delta = amax_abs(_dare_step(P, T, RQR, Z, H) - P)
    rtol = float(torch.finfo(P.dtype).eps) ** 0.5
    return torch.isfinite(delta) & (delta <= rtol * amax_abs(P))


@highest_precision()
def _sda_settle(T, RQR, Z, H, P_open=None, maxiter: int = 28):
    """DARE settle by the structure-preserving doubling algorithm on the
    shifted equation in Y = P − RQR (``kalman.py:252-366``), which stays
    well posed at H = 0; primal only.  Returns (P, certified): P is the
    doubling transform applied at Y₀ = P_open − RQR, the exact
    2^k-step Riccati iterate from the open-loop unconditional covariance
    ``P_open`` (computed when not given), and ``certified`` is
    :func:`dare_residual_settled` of it.  A draw stops once its from-zero
    iterate and the start-dependent correction are both at a few machine
    epsilons of the scale, or go non-finite."""
    dtype = T.dtype
    eps = float(torch.finfo(dtype).eps)
    n = T.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=T.device)
    if P_open is None:
        P_open = _doubling(T, RQR, 1e-14, 40)
    Y0 = P_open - RQR
    Y0 = 0.5 * (Y0 + Y0.mT)
    y0n = amax_abs(Y0)

    Ht = H + Z @ RQR @ Z.mT
    Hti = _spd_inverse(Ht)
    ZtHti = Z.mT @ Hti
    Ahat = T @ (eye - RQR @ (ZtHti @ Z))
    Qt = Ahat @ RQR @ T.mT
    A, G, Hk = Ahat.mT, ZtHti @ Z, 0.5 * (Qt + Qt.mT)

    rtol = _HEWER_RTOL_EPS * eps
    floor_scale = amax_abs(RQR)
    done = torch.zeros(T.shape[:-2], dtype=torch.bool, device=T.device)
    for _ in range(maxiter):
        if bool(done.all()):
            break
        Wi = _gj_inverse(eye + G @ Hk)
        WA = Wi @ A
        A1 = A @ WA
        WiG = Wi @ G
        G1 = G + A @ WiG @ A.mT
        H1 = Hk + (A.mT @ Hk) @ WA
        G1 = 0.5 * (G1 + G1.mT)
        H1 = 0.5 * (H1 + H1.mT)
        delta = amax_abs(H1 - Hk)
        scale = torch.maximum(amax_abs(H1), floor_scale)
        # stop when the from-zero trajectory has stabilised and the
        # start-dependent correction is below the same floor
        a1n = amax_abs(A1)
        finite = torch.isfinite(delta) & torch.isfinite(a1n)
        now_done = ((delta <= rtol * scale)
                    & (a1n * a1n * (n * y0n) <= rtol * scale)) | ~finite
        live = ~done[..., None, None]
        A = torch.where(live, A1, A)
        G = torch.where(live, G1, G)
        Hk = torch.where(live, H1, Hk)
        done = done | now_done
    corr = (A.mT @ (Y0 @ _gj_inverse(eye + G @ Y0))) @ A
    P = RQR + Hk + 0.5 * (corr + corr.mT)
    P = 0.5 * (P + P.mT)
    return P, dare_residual_settled(T, RQR, Z, H, P)


@highest_precision()
def _stein_adjoint(A_cl, G, iters: int = _STEIN_ITERS):
    """W = Σ_k (A_clᵀ)^k G A_cl^k by Smith doubling with a per-draw exit:
    the adjoint of the DARE's Fréchet derivative dP⁺ = A_cl dP A_clᵀ."""
    eps = float(torch.finfo(G.dtype).eps)
    W, A_k = G, A_cl
    done = torch.zeros(G.shape[:-2], dtype=torch.bool, device=G.device)
    for _ in range(iters):
        if bool(done.all()):
            break
        delta = A_k.mT @ W @ A_k
        W_new = W + delta
        dmax = amax_abs(delta)
        small = dmax <= eps * amax_abs(W_new)
        live = ~done[..., None, None]
        W = torch.where(live, W_new, W)
        A_k = torch.where(live, A_k @ A_k, A_k)
        done = done | small | ~torch.isfinite(dmax)
    return W


class _ImplicitDareP(torch.autograd.Function):
    """Identity on the converged DARE solution P whose backward is the
    implicit fixed-point adjoint (``kalman.py:393-425``): one Stein doubling
    solve with the closed loop A_cl = T − Kp Z, then the VJP of one
    ``_dare_step`` at P held fixed."""

    @staticmethod
    def forward(ctx, T, RQR, Z, H, P):
        ctx.save_for_backward(T, RQR, Z, H, P)
        return P.clone()

    @staticmethod
    def backward(ctx, P_bar):
        T, RQR, Z, H, P = ctx.saved_tensors
        with highest_precision():
            PZt = P @ Z.mT
            S = Z @ PZt + H
            Kp = T @ (PZt @ _spd_inverse(S))        # predictive gain
            A_cl = T - Kp @ Z
            w = _stein_adjoint(A_cl, 0.5 * (P_bar + P_bar.mT))
            with torch.enable_grad():
                leaves = [X.detach().requires_grad_(True)
                          for X in (T, RQR, Z, H)]
                step = _dare_step(P, *leaves)
                grads = torch.autograd.grad(step, leaves, w)
        return (*grads, None)


def _make_hewer_stage(Ts, RQRs, Zs, Hs):
    """One Hewer/Kleinman stage (closed-loop Lyapunov solve by doubling),
    falling back to one exact Riccati step where that solve blew up."""

    def hewer_stage(P):
        PZt = P @ Zs.mT
        S_h = Zs @ PZt + Hs
        Kp = Ts @ (PZt @ _spd_inverse(S_h))
        A_cl = Ts - Kp @ Zs
        Qc = RQRs + Kp @ Hs @ Kp.mT
        P_new = _doubling(A_cl, 0.5 * (Qc + Qc.mT), 1e-14, 30)
        # keeping the previous iterate would freeze P and read as converged
        ok = torch.isfinite(P_new).all(dim=(-2, -1))[..., None, None]
        return torch.where(ok, 0.5 * (P_new + P_new.mT),
                           _dare_step(P, Ts, RQRs, Zs, Hs))

    return hewer_stage


def _adaptive_stages(stage, P, cap: int, stop, min_stages: int = 0):
    """Apply ``stage`` to each draw's P up to ``cap`` times; a draw stops
    once it has settled or its update went non-finite (not settled).
    Settled: the update is within _HEWER_RTOL_EPS machine epsilons of
    max|P|, or has stopped contracting (at least half the previous one)
    while within sqrt(eps) of it; the first ``min_stages`` stages settle
    no draw.  ``stop`` (per draw) marks draws that need no stage and count
    as settled.  A per-draw freeze mask and one host read a stage stand
    for the reference's ``while_loop`` under ``vmap``.
    Returns (P, settled)."""
    eps = float(torch.finfo(P.dtype).eps)
    rtol_hard, rtol_soft = _HEWER_RTOL_EPS * eps, eps ** 0.5
    prev_delta = torch.full(stop.shape, float("inf"), dtype=P.dtype,
                            device=P.device)
    settled, stop = stop.clone(), stop.clone()
    for it in range(cap):
        if bool(stop.all()):
            break
        P_new = stage(P)
        delta = amax_abs(P_new - P)
        scale = amax_abs(P_new)
        plateau = (delta >= 0.5 * prev_delta) & (delta <= rtol_soft * scale)
        finite = torch.isfinite(delta)
        now_settled = (it >= min_stages) & finite \
            & ((delta <= rtol_hard * scale) | plateau)
        live = ~stop
        P = torch.where(live[..., None, None], P_new, P)
        prev_delta = torch.where(live, delta, prev_delta)
        settled = torch.where(live, now_settled, settled)
        stop = stop | (live & (now_settled | ~finite))
    return P, settled


@highest_precision()
def _hewer_settle(Ts, RQRs, Zs, Hs, n_settle: int):
    """Hewer settle to the DARE fixed point (primal only): the open-loop
    unconditional covariance, _N_HEWER unconditional stages, then adaptive
    stages (``n_settle`` in total, at least one adaptive) until the update
    is a few machine epsilons of |P|, or has stopped contracting while
    already below sqrt(eps)·|P|.  Returns (P, settled)."""
    P = _doubling(Ts, RQRs, 1e-14, 40)
    hewer_stage = _make_hewer_stage(Ts, RQRs, Zs, Hs)
    for _ in range(_N_HEWER):
        P = hewer_stage(P)
    no_stop = torch.zeros(Ts.shape[:-2], dtype=torch.bool, device=Ts.device)
    return _adaptive_stages(hewer_stage, P, max(1, int(n_settle) - _N_HEWER),
                            no_stop)


@highest_precision()
def _auto_settle(Ts, RQRs, Zs, Hs, n_settle: int):
    """The SDA settle, then Hewer stages for the draws its certificate
    rejects (``kalman.py:513-562``): one loop whose stop flags start at the
    certificate, so a fully certified batch runs no stage.  An uncertified
    draw restarts from the open-loop unconditional covariance, never from
    the SDA iterate; its first _N_HEWER stages cannot stop it, and the cap
    is ``max(_N_HEWER + 1, n_settle)`` stages.  Returns (P, settled)."""
    P_open = _doubling(Ts, RQRs, 1e-14, 40)
    P_sda, cert = _sda_settle(Ts, RQRs, Zs, Hs, P_open)
    P = torch.where(cert[..., None, None], P_sda, P_open)
    return _adaptive_stages(_make_hewer_stage(Ts, RQRs, Zs, Hs), P,
                            max(_N_HEWER + 1, int(n_settle)), cert,
                            min_stages=_N_HEWER)


@highest_precision()
def stationary_loglik_from_P(y, T, RQR, Z, H, d, x0, P):
    """Constant-gain log-likelihood given a (primal) DARE fixed point P,
    from the predicted state ``x0`` (..., n) (None: zero); gradients
    re-attach through :class:`_ImplicitDareP`.

    ``y`` (periods, k) is shared; T, RQR (..., n, n), Z (..., k, n),
    H (..., k, k), d (..., k).  The scan's backward pass is
    plain autograd over the 200-step recursion, as the reference's is XLA
    autodiff of its ``lax.scan``.
    """
    k = Z.shape[-2]
    P = _ImplicitDareP.apply(T, RQR, Z, H, P)
    PZt = P @ Z.mT
    S = Z @ PZt + H
    Sinv, logdet = _spd_inverse_logdet(S)
    K = PZt @ Sinv
    TK = T @ K
    M = T - TK @ Z
    const = -0.5 * (k * _LOG2PI + logdet)
    # y - d for every period at once, and its gain term TK (y_t - d)
    yd = y.to(T.dtype) - d[..., None, :]  # (..., periods, k)
    gain = yd @ TK.mT  # (..., periods, n)
    x = T.new_zeros(T.shape[:-1]) if x0 is None else x0.to(T.dtype)
    vs = []
    for t in range(y.shape[0]):
        vs.append(yd[..., t, :] - (Z @ x[..., None])[..., 0])
        x = (M @ x[..., None])[..., 0] + gain[..., t, :]
    v = torch.stack(vs, dim=-2)  # (..., periods, k)
    quad = (v * (v @ Sinv.mT)).sum(dim=(-2, -1))
    ll = y.shape[0] * const - 0.5 * quad
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))


@highest_precision()
def stationary_kalman_loglik(y, T, R, Q, Z, H, d=None, x0=None,
                             n_settle: int = 32,
                             settle_method: str = "hewer"):
    """Stationary (constant gain from t = 0) Kalman log-likelihood, from
    the predicted state ``x0`` (..., n) (None: zero).

    The predictive covariance is pinned at the DARE fixed point, reached by
    a primal settle on detached (T, RQR, Z, H): ``settle_method="hewer"``
    (the default; ``n_settle`` caps its stages), ``"sda"`` (the doubling
    alone, uncertified draws rejected) or ``"auto"`` (the doubling, then
    Hewer stages for the draws it does not certify).  Draws whose settle
    did not converge get -inf.
    """
    if settle_method not in ("auto", "sda", "hewer"):
        raise ValueError(f"settle_method must be 'auto', 'sda' or 'hewer', "
                         f"got {settle_method!r}")
    if d is None:
        d = T.new_zeros(T.shape[:-2] + Z.shape[-2:-1])
    RQR = R @ Q @ R.mT
    primal = tuple(X.detach() for X in (T, RQR, Z, H))
    if settle_method == "auto":
        P, settled = _auto_settle(*primal, n_settle)
    elif settle_method == "sda":
        P, settled = _sda_settle(*primal)
    else:
        P, settled = _hewer_settle(*primal, n_settle)
    ll = stationary_loglik_from_P(y, T, RQR, Z, H, d, x0, P)
    return torch.where(settled, ll, torch.full_like(ll, -torch.inf))


def _chol_nan(F: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each draw's F; NaN (never an exception) for
    a draw whose F is not positive definite, so it poisons only itself."""
    L, info = torch.linalg.cholesky_ex(F)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, torch.nan))


def _filter_step(T, RQR, Z, d, H, x_prev, P_prev, y_t):
    """One exact predict + update on a fully observed ``y_t`` (k,):
    returns (x_filt, P_filt, ll_t), the Joseph-form covariance symmetrised."""
    x_pred = (T @ x_prev[..., None])[..., 0]
    P_pred = T @ P_prev @ T.mT + RQR
    v = y_t - (Z @ x_pred[..., None])[..., 0] - d
    PZt = P_pred @ Z.mT
    F = Z @ PZt + H
    chol_F = _chol_nan(F)
    w = torch.cholesky_solve(v[..., None], chol_F)[..., 0]
    K = torch.cholesky_solve(PZt.mT, chol_F).mT
    x_filt = x_pred + (K @ v[..., None])[..., 0]
    IKZ = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device) - K @ Z
    P_filt = IKZ @ P_pred @ IKZ.mT + K @ H @ K.mT
    P_filt = 0.5 * (P_filt + P_filt.mT)
    logdet = 2.0 * torch.log(torch.diagonal(chol_F, dim1=-2, dim2=-1)).sum(-1)
    ll_t = -0.5 * (Z.shape[-2] * _LOG2PI + logdet + (v * w).sum(-1))
    return x_filt, P_filt, ll_t


class KalmanFilterResult(NamedTuple):
    loglik: torch.Tensor            # (...,) total log-likelihood
    loglik_t: torch.Tensor          # (..., periods) per-period contributions
    filtered_mean: torch.Tensor     # (..., periods, n) E[x_t | y_{1:t}]
    filtered_cov: torch.Tensor      # (..., periods, n, n)
    predicted_mean: torch.Tensor    # (..., periods, n) E[x_t | y_{1:t-1}]
    predicted_cov: torch.Tensor     # (..., periods, n, n)


def _masked_filter_step(T, RQR, Z, d, H, x_prev, P_prev, y_t):
    """One exact predict + update where ``y_t`` (k,) may hold NaN
    (``kalman.py:69-108``): a missing row of Z and d is zeroed, F gets a
    unit diagonal there, and only observed rows count in the constant.
    Returns (x_filt, P_filt, ll_t, x_pred, P_pred), the Joseph-form
    covariance symmetrised."""
    x_pred = (T @ x_prev[..., None])[..., 0]
    P_pred = T @ P_prev @ T.mT + RQR
    mask = torch.isfinite(y_t)
    maskf = mask.to(x_pred.dtype)
    y_eff = torch.where(mask, y_t, torch.zeros_like(y_t))
    Z_eff = Z * maskf[..., :, None]
    d_eff = d * maskf
    v = y_eff - (Z_eff @ x_pred[..., None])[..., 0] - d_eff
    PZt = P_pred @ Z_eff.mT
    # unit variance on missing rows keeps F positive definite
    H_eff = H * (maskf[..., :, None] * maskf[..., None, :]) \
        + torch.diag_embed(1.0 - maskf)
    F = Z_eff @ PZt + H_eff
    chol_F = _chol_nan(F)
    w = torch.cholesky_solve(v[..., None], chol_F)[..., 0]
    K = torch.cholesky_solve(PZt.mT, chol_F).mT
    x_filt = x_pred + (K @ v[..., None])[..., 0]
    IKZ = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device) - K @ Z_eff
    P_filt = IKZ @ P_pred @ IKZ.mT + K @ H_eff @ K.mT
    P_filt = 0.5 * (P_filt + P_filt.mT)
    logdet = 2.0 * torch.log(torch.diagonal(chol_F, dim1=-2, dim2=-1)).sum(-1)
    ll_t = -0.5 * (maskf.sum(-1) * _LOG2PI + logdet + (v * w).sum(-1))
    return x_filt, P_filt, ll_t, x_pred, P_pred


def _filter_steps(y, T, R, Q, Z, H, d, x0, P0):
    """The masked steps over ``y``, one (x_filt, P_filt, ll_t, x_pred,
    P_pred) a period, from the reference's defaults: d and x0 zero, P0
    the unconditional covariance
    (:func:`~geconpy_torch.ops.lyapunov.solve_discrete_lyapunov` of T and
    R Q Rᵀ)."""
    y = y.to(T.dtype)
    RQR = R @ Q @ R.mT
    if d is None:
        d = T.new_zeros(T.shape[:-2] + Z.shape[-2:-1])
    x = T.new_zeros(T.shape[:-1]) if x0 is None else x0
    P = solve_discrete_lyapunov(T, RQR) if P0 is None else P0
    for t in range(y.shape[-2]):
        step = _masked_filter_step(T, RQR, Z, d, H, x, P, y[..., t, :])
        x, P = step[:2]
        yield step


@highest_precision()
def kalman_filter(y, T, R, Q, Z, H, d=None, x0=None, P0=None
                  ) -> KalmanFilterResult:
    """The sequential Kalman filter over ``y`` (..., periods, k), NaN =
    missing; T (..., n, n), R (..., n, m), Q (..., m, m), Z (..., k, n),
    H (..., k, k), d (..., k).  ``d`` and ``x0`` default to zeros, ``P0``
    to the unconditional covariance.  Differentiable by autograd through
    the recursion (the reference differentiates its ``lax.scan``), and
    through the Lyapunov adjoint where P0 is the default.  A draw whose F
    is not positive definite gets NaN, never an exception."""
    x_f, P_f, ll_t, x_p, P_p = zip(*_filter_steps(y, T, R, Q, Z, H, d, x0,
                                                   P0))
    ll_t = torch.stack(ll_t, dim=-1)
    return KalmanFilterResult(
        ll_t.sum(-1), ll_t, torch.stack(x_f, dim=-2),
        torch.stack(P_f, dim=-3), torch.stack(x_p, dim=-2),
        torch.stack(P_p, dim=-3))


@highest_precision()
def kalman_loglik_t(y, T, R, Q, Z, H, d=None, x0=None, P0=None
                    ) -> torch.Tensor:
    """``kalman_filter(...).loglik_t`` (..., periods) without stacking the
    states and covariances."""
    return torch.stack([step[2] for step in _filter_steps(
        y, T, R, Q, Z, H, d, x0, P0)], dim=-1)


def kalman_loglik(y, T, R, Q, Z, H, d=None, x0=None, P0=None):
    """Log-likelihood only; a non-finite result is -inf, so that batched
    samplers reject the draw."""
    ll = kalman_loglik_t(y, T, R, Q, Z, H, d, x0, P0).sum(-1)
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))


def _settle_exact(y_head, T, R, Q, Z, H, d, x0=None, P0=None):
    """The exact filter over ``y_head`` from the state ``x0`` (None: zero)
    and the covariance ``P0`` (None: the unconditional one, differentiable
    through its Lyapunov adjoint): (ll_head, x_filt, P_filt, RQR, d).
    ``x0`` and ``P0`` are the filtered moments before the first period,
    which the first step predicts from.  Where ``y_head`` misses
    values it runs the masked step, as the reference's head always does;
    on fully observed data the plain step, which gives the same numbers
    with fewer operations."""
    masked = bool(torch.isnan(y_head).any())
    if d is None:
        d = T.new_zeros(T.shape[:-2] + Z.shape[-2:-1])
    RQR = R @ Q @ R.mT
    P = solve_discrete_lyapunov(T, RQR) if P0 is None else P0.to(T.dtype)
    x = T.new_zeros(T.shape[:-1]) if x0 is None else x0.to(T.dtype)
    ll = T.new_zeros(T.shape[:-2])
    for t in range(y_head.shape[0]):
        y_t = y_head[t].to(T.dtype)
        if masked:
            x, P, ll_t = _masked_filter_step(T, RQR, Z, d, H, x, P, y_t)[:3]
        else:
            x, P, ll_t = _filter_step(T, RQR, Z, d, H, x, P, y_t)
        ll = ll + ll_t
    return ll, x, P, RQR, d


def _frozen_gain(T, RQR, Z, H, P_filt):
    """(M, TK, Finv, const) of the constant-gain tail at the settled
    covariance."""
    k = Z.shape[-2]
    P_pred = T @ P_filt @ T.mT + RQR
    F = Z @ P_pred @ Z.mT + H
    chol_F = _chol_nan(F)
    K = torch.cholesky_solve((P_pred @ Z.mT).mT, chol_F).mT
    Finv = torch.cholesky_solve(
        torch.eye(k, dtype=T.dtype, device=T.device).expand(F.shape), chol_F)
    logdet = 2.0 * torch.log(torch.diagonal(chol_F, dim1=-2, dim2=-1)).sum(-1)
    TK = T @ K
    return T - TK @ Z, TK, Finv, -0.5 * (k * _LOG2PI + logdet)


@highest_precision()
def steady_state_filter_parts(y_head, T, R, Q, Z, H, d=None, x0=None,
                              P0=None):
    """Settle phase + frozen-gain quantities for the constant-gain tail:
    the exact filter over ``y_head`` (n_settle, k), shared and fully
    observed, then (ll_head, x_pred0, M, TK, Finv, const) per draw, the
    inputs of :func:`~geconpy_torch.ops.batched_filter.filter_tail`.

    T (..., n, n), R (..., n, m), Q (..., m, m), Z (..., k, n),
    H (..., k, k), d (..., k); ``x0`` (..., n) and ``P0`` (..., n, n) start
    the filter (None: zero and the unconditional covariance).  Plain
    batched PyTorch: the sweep's ``settle="xla"`` and the oracle of the
    settle kernel.
    """
    ll_head, x_filt, P_filt, RQR, _d = _settle_exact(y_head, T, R, Q, Z, H, d,
                                                     x0, P0)
    M, TK, Finv, const = _frozen_gain(T, RQR, Z, H, P_filt)
    return ll_head, (T @ x_filt[..., None])[..., 0], M, TK, Finv, const


@highest_precision()
def steady_state_kalman_loglik(y, T, R, Q, Z, H, d=None, x0=None, P0=None,
                               n_settle: int = 48):
    """Constant-gain (steady-state) Kalman log-likelihood, batched.

    ``n_settle`` exact steps (at most the sample) while the covariance
    settles, then the gain, F^{-1} and log det F are frozen and each
    remaining period costs one n x n matrix-vector product.  ``y``
    (periods, k) is shared and fully observed.  ``x0`` and ``P0`` start
    the filter, as in :func:`steady_state_filter_parts`.  A non-finite
    total is -inf.  The oracle of the fused settle + tail kernel.
    """
    n_settle = min(int(n_settle), y.shape[0])
    ll, x_filt, P_filt, RQR, d = _settle_exact(y[:n_settle], T, R, Q, Z, H, d,
                                               x0, P0)
    if n_settle < y.shape[0]:
        M, TK, Finv, const = _frozen_gain(T, RQR, Z, H, P_filt)
        x = (T @ x_filt[..., None])[..., 0]
        for t in range(n_settle, y.shape[0]):
            yd = y[t].to(T.dtype) - d
            v = yd - (Z @ x[..., None])[..., 0]
            ll = ll + const - 0.5 * (v * (Finv @ v[..., None])[..., 0]).sum(-1)
            x = (M @ x[..., None])[..., 0] + (TK @ yd[..., None])[..., 0]
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))


class KalmanSmootherResult(NamedTuple):
    smoothed_mean: torch.Tensor     # (..., periods, n) E[x_t | y_{1:T}]
    smoothed_cov: torch.Tensor      # (..., periods, n, n)


class DisturbanceSmootherResult(NamedTuple):
    shocks: torch.Tensor            # (..., periods, n_shocks) smoothed e_t
    obs_noise: torch.Tensor         # (..., periods, k) smoothed u_t
    smoothed_mean: torch.Tensor     # (..., periods, n) E[x_t | y_{1:T}]


@highest_precision()
def disturbance_smoother(y, T, R, Q, Z, H, d=None, x0=None, P0=None
                         ) -> DisturbanceSmootherResult:
    """Durbin-Koopman disturbance smoother (``kalman.py:807-873``): the
    filter forward, then the backward recursion r_{t-1} = Zᵀ F⁻¹ v_t +
    Lᵀ r_t, with the smoothed shocks e_t = Q Rᵀ r_{t-1}, measurement
    errors u_t = H (F⁻¹ v_t − K_predᵀ r_t) on the observed rows, and
    states x_t = x_{t|t-1} + P_{t|t-1} r_{t-1}.  They satisfy
    x_t = T x_{t-1} + R e_t and, where observed, y_t = Z x_t + d + u_t.
    NaN = missing, masked as in :func:`kalman_filter`."""
    res = kalman_filter(y, T, R, Q, Z, H, d, x0, P0)
    y = y.to(T.dtype)
    if d is None:
        d = T.new_zeros(T.shape[:-2] + Z.shape[-2:-1])
    QRt = Q @ R.mT
    r = T.new_zeros(T.shape[:-1])
    eps, noise, states = [], [], []
    for t in reversed(range(y.shape[-2])):
        y_t = y[..., t, :]
        x_pred = res.predicted_mean[..., t, :]
        P_pred = res.predicted_cov[..., t, :, :]
        mask = torch.isfinite(y_t)
        maskf = mask.to(T.dtype)
        y_eff = torch.where(mask, y_t, torch.zeros_like(y_t))
        Z_eff = Z * maskf[..., :, None]
        d_eff = d * maskf
        H_eff = H * (maskf[..., :, None] * maskf[..., None, :]) \
            + torch.diag_embed(1.0 - maskf)
        v = y_eff - (Z_eff @ x_pred[..., None])[..., 0] - d_eff
        F = Z_eff @ P_pred @ Z_eff.mT + H_eff
        Finv = _spd_inverse(F)
        Fv = (Finv @ v[..., None])[..., 0]
        K_pred = T @ P_pred @ Z_eff.mT @ Finv
        L = T - K_pred @ Z_eff
        # r_{t-1} = Zᵀ F⁻¹ v_t + Lᵀ r_t; e_t is DK's eta_{t-1}, so it reads
        # r_{t-1}, while the measurement error reads the carry r_t
        r_prev = (Z_eff.mT @ Fv[..., None])[..., 0] \
            + (L.mT @ r[..., None])[..., 0]
        eps.append((QRt @ r_prev[..., None])[..., 0])
        noise.append((H_eff @ (Fv - (K_pred.mT @ r[..., None])[..., 0])
                      [..., None])[..., 0] * maskf)
        states.append(x_pred + (P_pred @ r_prev[..., None])[..., 0])
        r = r_prev
    return DisturbanceSmootherResult(*(torch.stack(xs[::-1], dim=-2)
                                       for xs in (eps, noise, states)))


@highest_precision()
def kalman_smoother(y, T, R, Q, Z, H, d=None, x0=None, P0=None
                    ) -> KalmanSmootherResult:
    """Rauch-Tung-Striebel smoother over :func:`kalman_filter`'s output
    (``kalman.py:876-910``): J = P_filt Tᵀ (P_pred + ridge)⁻¹, the ridge
    ``success_tol(dtype, 1e-9, 100)`` x (tr P_pred / n), because P_pred
    is rank-deficient with fewer shocks than states; a singular draw gives
    NaN.  NaN = missing."""
    res = kalman_filter(y, T, R, Q, Z, H, d, x0, P0)
    n = T.shape[-1]
    eye = torch.eye(n, dtype=T.dtype, device=T.device)
    rel = success_tol(T.dtype, base=1e-9, eps_multiple=100.0)
    x_s = res.filtered_mean[..., -1, :]
    P_s = res.filtered_cov[..., -1, :, :]
    means, covs = [x_s], [P_s]
    for t in reversed(range(res.filtered_mean.shape[-2] - 1)):
        x_f = res.filtered_mean[..., t, :]
        P_f = res.filtered_cov[..., t, :, :]
        x_pn = res.predicted_mean[..., t + 1, :]
        P_pn = res.predicted_cov[..., t + 1, :, :]
        ridge = rel * (torch.diagonal(P_pn, dim1=-2, dim2=-1).sum(-1) / n
                       + 1e-30)
        P_reg = P_pn + ridge[..., None, None] * eye
        J = _solve_nan(P_reg.mT, (P_f @ T.mT).mT).mT
        x_s = x_f + (J @ (x_s - x_pn)[..., None])[..., 0]
        P_s = P_f + J @ (P_s - P_pn) @ J.mT
        P_s = 0.5 * (P_s + P_s.mT)
        means.append(x_s)
        covs.append(P_s)
    return KalmanSmootherResult(torch.stack(means[::-1], dim=-2),
                                torch.stack(covs[::-1], dim=-3))
