"""Cyclostationary (periodic constant-gain) Kalman log-likelihood, batched.

Mirrors ``geconpy_tpu/ops/cyclo_kalman.py``: ``detect_mask_period`` (:45,
host numpy, unchanged), ``_phase_matrices`` (:68), ``_masked_dare_step``
(:83), ``_cycle_map`` (:94), ``_cycle_closed_loop`` (:104),
``_stein_cycle`` (:130, here the stationary filter's ``_stein_adjoint``
with its cap of 40), the implicit periodic-DARE adjoint
``_implicit_cyclic_dare_P`` (:151-178, here :class:`_ImplicitCyclicDareP`)
and ``cyclostationary_kalman_loglik`` (:181-362).

Mixed-frequency data miss values with a period p (a quarterly series in a
monthly panel is observed every third row).  Under such a mask the
Riccati recursion converges to a cycle of p predictive covariances (the
periodic DARE), and the filter with one gain frozen per phase is exact on
it.  The settle runs primal only: the open-loop unconditional phase-0
covariance (or RQR where T^p has none), ``n_settle`` exact cycles, four
cyclic Hewer stages (the closed-loop covariance over one cycle solved by
doubling, falling back to one exact cycle where that blows up), then up
to 12 adaptive stages until the update is at the dtype's noise floor.
Draws that do not settle, or go non-finite, get -inf.  Gradients
re-attach at the phase-0 fixed point through one Stein solve with the
cycle's monodromy and the VJP of one cycle.

Every function takes leading batch dimensions (the reference's ``vmap``);
the adaptive loop freezes each finished draw with a mask, one host read a
stage.  Where the reference's ``jnp.linalg.cholesky`` and ``solve`` give
NaN on a bad draw, the port's ``_chol_nan`` and ``_solve_nan`` do too,
never an exception.
"""

from __future__ import annotations

import numpy as np
import torch

from .cycle_reduction import _solve_nan
from .kalman import _LOG2PI, _adaptive_stages, _chol_nan, _stein_adjoint
from .lyapunov import _doubling
from .precision import highest_precision

__all__ = ["detect_mask_period", "cyclostationary_kalman_loglik"]

#: unconditional cyclic Hewer stages, the adaptive stages after them, and
#: the Stein doublings of the adjoint (the reference's)
_N_HEWER, _EXTRA_CAP, _STEIN_ITERS = 4, 12, 40


def detect_mask_period(mask: np.ndarray, max_period: int = 24) -> int | None:
    """Smallest period ``p <= max_period`` such that the (periods, k) bool
    mask is exactly ``mask[t] == pattern[t % p]``, or None if the
    missingness is not periodic.  A candidate must complete two full
    cycles (``p <= periods // 2``): any mask trivially repeats at periods
    longer than half the sample."""
    mask = np.asarray(mask, dtype=bool)
    periods = mask.shape[0]
    for p in range(1, min(max_period, periods // 2) + 1):
        pattern = mask[:p]
        reps = -(-periods // p)
        tiled = np.tile(pattern, (reps, 1))[:periods]
        if np.array_equal(tiled, mask):
            return p
    return None


def _phase_matrices(Z, H, pattern):
    """(m (p, k), Z_stack (..., p, k, n), H_stack (..., p, k, k)): per
    phase, missing rows of Z zeroed and a unit diagonal of H there, so the
    innovation covariance stays positive definite and a missing row adds
    nothing to the log-likelihood."""
    m = torch.as_tensor(np.asarray(pattern, dtype=bool), device=Z.device) \
        .to(Z.dtype)
    Z_j = Z[..., None, :, :] * m[:, :, None]
    H_j = H[..., None, :, :] * (m[:, :, None] * m[:, None, :]) \
        + torch.diag_embed(1.0 - m)
    return m, Z_j, H_j


def _masked_dare_step(P, T, RQR, Z_j, H_j):
    """One predictive Riccati step under phase-j masking."""
    PZt = P @ Z_j.mT
    S = Z_j @ PZt + H_j
    chol_S = _chol_nan(S)
    K = torch.cholesky_solve(PZt.mT, chol_S).mT
    P_upd = P - K @ PZt.mT
    P_next = T @ P_upd @ T.mT + RQR
    return 0.5 * (P_next + P_next.mT)


def _cycle_map(P0, T, RQR, Z_stack, H_stack):
    """F(P₀) = f_{p-1}(... f_0(P₀)): one full cycle of masked steps."""
    P = P0
    for j in range(Z_stack.shape[-3]):
        P = _masked_dare_step(P, T, RQR, Z_stack[..., j, :, :],
                              H_stack[..., j, :, :])
    return P


def _cycle_closed_loop(P0, T, RQR, Z_stack, H_stack):
    """Monodromy A_cyc = A_{p-1} ... A_0 and the noise G_cyc accumulated
    over one cycle of the closed-loop propagation P_{j+1} = A_j P_j A_jᵀ +
    Q_j, with the gains of the cycle started at P₀."""
    n = T.shape[-1]
    P = P0
    A_cyc = torch.eye(n, dtype=T.dtype, device=T.device).expand(P0.shape)
    G_cyc = torch.zeros_like(P0)
    for j in range(Z_stack.shape[-3]):
        Z_j, H_j = Z_stack[..., j, :, :], H_stack[..., j, :, :]
        PZt = P @ Z_j.mT
        S = Z_j @ PZt + H_j
        Kp = T @ _solve_nan(S, PZt.mT).mT
        A_j = T - Kp @ Z_j
        Q_j = RQR + Kp @ H_j @ Kp.mT
        A_cyc = A_j @ A_cyc
        G_cyc = A_j @ G_cyc @ A_j.mT + Q_j
        P_next = A_j @ P @ A_j.mT + Q_j
        P = 0.5 * (P_next + P_next.mT)
    return A_cyc, 0.5 * (G_cyc + G_cyc.mT)


class _ImplicitCyclicDareP(torch.autograd.Function):
    """Identity on the converged phase-0 periodic-DARE solution whose
    backward is the implicit fixed-point adjoint of the one-cycle map
    (``cyclo_kalman.py:151-178``): w = (I − F_Pᵀ)⁻¹ P̄ by Stein doubling
    with the monodromy, then the VJP of one cycle at P held fixed."""

    @staticmethod
    def forward(ctx, T, RQR, Z_stack, H_stack, P):
        ctx.save_for_backward(T, RQR, Z_stack, H_stack, P)
        return P.clone()

    @staticmethod
    def backward(ctx, P_bar):
        T, RQR, Z_stack, H_stack, P = ctx.saved_tensors
        with highest_precision():
            A_cyc, _ = _cycle_closed_loop(P, T, RQR, Z_stack, H_stack)
            w = _stein_adjoint(A_cyc, 0.5 * (P_bar + P_bar.mT), _STEIN_ITERS)
            with torch.enable_grad():
                leaves = [X.detach().requires_grad_(True)
                          for X in (T, RQR, Z_stack, H_stack)]
                step = _cycle_map(P, *leaves)
                grads = torch.autograd.grad(step, leaves, w)
        return (*grads, None)


def _cyclic_settle(Ts, RQRs, Zs, Hs, n_settle: int):
    """Primal settle to the phase-0 periodic fixed point: (P, settled)."""
    n = Ts.shape[-1]
    p = Zs.shape[-3]
    # the open-loop unconditional phase-0 covariance: monodromy T^p and the
    # noise of one cycle, solved by doubling; the cyclic analogue of the
    # stationary settle's K = 0 start, from which every gain is stabilising
    A_ol = torch.eye(n, dtype=Ts.dtype, device=Ts.device).expand(Ts.shape)
    G_ol = torch.zeros_like(Ts)
    for _ in range(p):
        A_ol = Ts @ A_ol
        G_ol = Ts @ G_ol @ Ts.mT + RQRs
    P_try = _doubling(A_ol, 0.5 * (G_ol + G_ol.mT), 1e-14, 40)
    # an unstable but detectable T has none: start at RQR, which the exact
    # cycles below stabilise
    ok = torch.isfinite(P_try).all(dim=(-2, -1))[..., None, None]
    P = torch.where(ok, 0.5 * (P_try + P_try.mT), RQRs)
    for _ in range(max(int(n_settle), 1)):
        P = _cycle_map(P, Ts, RQRs, Zs, Hs)

    def hewer(P):
        A_cyc, G_cyc = _cycle_closed_loop(P, Ts, RQRs, Zs, Hs)
        P_new = _doubling(A_cyc, G_cyc, 1e-14, 40)
        ok = torch.isfinite(P_new).all(dim=(-2, -1))
        P_new = 0.5 * (P_new + P_new.mT)
        if bool(ok.all()):
            return P_new
        # a failed stage falls back to one exact cycle (same fixed point,
        # honest progress): keeping the previous iterate would read as a
        # zero update, a false convergence
        return torch.where(ok[..., None, None], P_new,
                           _cycle_map(P, Ts, RQRs, Zs, Hs))

    for _ in range(_N_HEWER):
        P = hewer(P)
    return _adaptive_stages(hewer, P, _EXTRA_CAP, torch.zeros(
        Ts.shape[:-2], dtype=torch.bool, device=Ts.device))


@highest_precision()
def cyclostationary_kalman_loglik(y, T, R, Q, Z, H, d=None, x0=None,
                                  mask_pattern=None, n_settle: int = 16):
    """Kalman log-likelihood under a periodic missingness pattern.

    ``y`` (periods, k) is shared, NaN where missing (the pattern decides
    what is observed); T (..., n, n), R (..., n, m), Q (..., m, m),
    Z (..., k, n), H (..., k, k), d (..., k); ``x0`` (..., n) is the
    predicted state of the first period (None: zero).  ``mask_pattern`` (p, k)
    bool: series i is observed at t when ``mask_pattern[t % p, i]``;
    p = 1 with every series observed is the stationary filter.  Use
    :func:`detect_mask_period` on ``np.isfinite(data)`` to find it.
    ``n_settle`` exact cycles precede the cyclic Hewer polish.  The
    frozen-gain recursion indexes each phase's M, TK, S⁻¹ and constant by
    ``t mod p``; its backward pass is autograd over the periods, and the
    fixed point's is the implicit adjoint, whatever ``n_settle``.
    """
    dtype = T.dtype
    k = Z.shape[-2]
    periods = y.shape[0]
    if d is None:
        d = T.new_zeros(T.shape[:-2] + (k,))
    if mask_pattern is None:
        mask_pattern = np.ones((1, k), dtype=bool)
    pattern = np.asarray(mask_pattern, dtype=bool)
    p = pattern.shape[0]
    RQR = R @ Q @ R.mT
    m, Z_stack, H_stack = _phase_matrices(Z, H, pattern)
    # Z_stack and H_stack broadcast over the batch for the settle
    batch = torch.broadcast_shapes(T.shape[:-2], Z.shape[:-2], H.shape[:-2],
                                   RQR.shape[:-2])
    primal = (T.detach().expand(batch + T.shape[-2:]),
              RQR.detach().expand(batch + RQR.shape[-2:]),
              Z_stack.detach().expand(batch + Z_stack.shape[-3:]),
              H_stack.detach().expand(batch + H_stack.shape[-3:]))
    P, settled = _cyclic_settle(*primal, n_settle)
    P = _ImplicitCyclicDareP.apply(T, RQR, Z_stack, H_stack, P)

    # the differentiable per-phase frozen-gain quantities from P
    eye_k = torch.eye(k, dtype=dtype, device=T.device)
    Ms, TKs, Sinvs, consts = [], [], [], []
    for j in range(p):
        Z_j, H_j = Z_stack[..., j, :, :], H_stack[..., j, :, :]
        PZt = P @ Z_j.mT
        S = Z_j @ PZt + H_j
        chol_S = _chol_nan(S)
        K = torch.cholesky_solve(PZt.mT, chol_S).mT
        Sinvs.append(torch.cholesky_solve(eye_k.expand(S.shape), chol_S))
        TK = T @ K
        TKs.append(TK)
        Ms.append(T - TK @ Z_j)
        logdet = 2.0 * torch.log(torch.diagonal(chol_S, dim1=-2,
                                                dim2=-1)).sum(-1)
        consts.append(-0.5 * (m[j].sum() * _LOG2PI + logdet))
        P = _masked_dare_step(P, T, RQR, Z_j, H_j)

    # the frozen-gain recursion, phase-indexed
    phase = np.arange(periods) % p
    observed = torch.as_tensor(pattern[phase], device=T.device)
    y_eff = torch.where(observed, y.to(dtype), torch.zeros((), dtype=dtype,
                                                           device=T.device))
    yd = y_eff - d[..., None, :] * m[torch.as_tensor(phase, device=T.device)]
    gains = [(yd[..., j::p, :] @ TKs[j].mT) for j in range(p)]
    x = T.new_zeros(torch.broadcast_shapes(batch, yd.shape[:-2])
                    + T.shape[-1:])
    if x0 is not None:
        x = x + x0.to(dtype)
    xs = []
    for t in range(periods):
        j = phase[t]
        xs.append(x)
        x = (Ms[j] @ x[..., None])[..., 0] + gains[j][..., t // p, :]
    x_pred = torch.stack(xs, dim=-2)
    ll = T.new_zeros(x.shape[:-1])
    for j in range(p):
        v = yd[..., j::p, :] - x_pred[..., j::p, :] @ Z_stack[..., j, :, :].mT
        quad = (v * (v @ Sinvs[j].mT)).sum(dim=(-2, -1))
        ll = ll + v.shape[-2] * consts[j] - 0.5 * quad
    return torch.where(settled & torch.isfinite(ll), ll,
                       torch.full_like(ll, -torch.inf))
