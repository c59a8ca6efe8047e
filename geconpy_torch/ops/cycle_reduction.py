"""The adaptive cycle-reduction policy solve and its implicit adjoint,
batched.

Mirrors ``geconpy_tpu/ops/cycle_reduction.py``: ``CycleReductionResult``
(:40), ``_cycle_reduction_raw`` (:49-90), ``_policy_residual_norm`` (:93),
the implicit VJP ``_cr_fwd``/``_cr_bwd`` (:98-180) over
``solve_adjoint_sylvester`` (:109), ``cycle_reduction`` (:182),
``selection_matrix`` (:201) and ``solve_policy_cycle_reduction`` (:210).
This is the XLA policy of the single-draw log posterior
(``policy="xla"``); the batched sweep's fixed-length policy is the CUDA
kernel of :mod:`~geconpy_torch.ops.batched_cycle_reduction`.

The reference runs the iteration per draw in a ``while_loop`` under
``vmap``.  Here every matrix carries a leading batch dimension, a draw
that converged or went non-finite is frozen by a per-draw mask, and the
loop runs while any draw is live, so each draw takes exactly the
iterations it takes alone.  Each iteration reads one flag back to the host
(``done.all()``).  The LU solves are ``torch.linalg.solve_ex`` (LAPACK's
pivoted LU, as ``jnp.linalg.solve``); a singular matrix gives NaN in its
own draw, never an exception.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import gj_eliminate, gj_solve
from .lyapunov import amax_abs
from .precision import highest_precision
from .tolerances import success_tol

__all__ = ["CycleReductionResult", "cycle_reduction", "selection_matrix",
           "solve_adjoint_sylvester", "solve_policy_cycle_reduction"]

#: doubling cap of the Sylvester adjoint (2^30 summed terms, the reference's)
SYLVESTER_ITERS = 30


class CycleReductionResult(NamedTuple):
    T: torch.Tensor
    success: torch.Tensor
    n_iter: torch.Tensor
    resid_norm: torch.Tensor


def _solve_nan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A⁻¹ B by pivoted LU, batched; NaN in a draw whose A is singular."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where((info == 0)[..., None, None], X,
                       torch.full_like(X, torch.nan))


@highest_precision()
def _cycle_reduction_raw(A, B, C, tol: float, maxiter: int):
    """The iteration on plain tensors: (T, n_iter, best_crit) per draw.

    A draw stops once its tails' crit = max|A0| + max|A2| falls below
    ``max(tol, 10 eps)`` or goes non-finite, or at ``maxiter``; best_crit
    keeps the least crit of the draw's finite steps.  It separates the two
    ways a draw can reach a non-finite step: a divergent run (no stable
    solvent; best_crit stays O(1)) from a breakdown after the tails shrank
    (T is fine)."""
    n = A.shape[-1]
    tol = max(tol, 10 * float(torch.finfo(A.dtype).eps))
    batch = A.shape[:-2]
    A0, A1, A2, Ahat = A, B, C, B
    n_iter = torch.zeros(batch, dtype=torch.int64, device=A.device)
    best_crit = torch.full(batch, torch.inf, dtype=A.dtype, device=A.device)
    done = torch.zeros(batch, dtype=torch.bool, device=A.device)
    for _ in range(maxiter):
        if bool(done.all()):
            break
        # one LU factorization for both right-hand sides
        Q = _solve_nan(A1, torch.cat([A0, A2], dim=-1))
        Q0, Q2 = Q[..., :n], Q[..., n:]
        A1_new = A1 - A0 @ Q2 - A2 @ Q0
        Ahat_new = Ahat - A2 @ Q0
        A0_new = -A0 @ Q0
        A2_new = -A2 @ Q2
        crit = amax_abs(A0_new) + amax_abs(A2_new)
        finite = torch.isfinite(crit)
        live = ~done
        lm = live[..., None, None]
        A0 = torch.where(lm, A0_new, A0)
        A1 = torch.where(lm, A1_new, A1)
        A2 = torch.where(lm, A2_new, A2)
        Ahat = torch.where(lm, Ahat_new, Ahat)
        n_iter = n_iter + live.to(n_iter.dtype)
        best_crit = torch.where(live & finite,
                                torch.minimum(best_crit, crit), best_crit)
        done = done | (finite & (crit < tol)) | ~finite
    T = -_solve_nan(Ahat, A)
    return T, n_iter, best_crit


@highest_precision()
def _policy_residual_norm(A, B, C, T):
    return amax_abs(A + B @ T + C @ T @ T)


@highest_precision()
def solve_adjoint_sylvester(M, C, T, G):
    """Solve  Mᵀ W + Cᵀ W Tᵀ = G  for W by Smith doubling, batched.

    Rewritten as the fixed point W = G₀ − S W Tᵀ with S = M⁻ᵀ Cᵀ and
    G₀ = M⁻ᵀ G, whose Neumann series Σ_k (−S)^k G₀ (Tᵀ)^k converges when
    ρ(S)·ρ(T) < 1; squaring the operators doubles the number of summed
    terms per iteration.  Each draw stops once its correction
    is below eps·max|W| or goes non-finite; finished draws are frozen, so
    ``SYLVESTER_ITERS`` bounds every draw's doublings.  Runs only
    inside backward passes, on plain (gradient-free) tensors.
    """
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    # one explicit inverse (pivoted Gauss-Jordan) for both right-hand sides
    Mt_inv = gj_eliminate(M.mT, eye)[0]
    S = -(Mt_inv @ C.mT)
    W = Mt_inv @ G
    T_k = T.mT
    eps = float(torch.finfo(W.dtype).eps)
    done = torch.zeros(M.shape[:-2], dtype=torch.bool, device=M.device)
    for _ in range(SYLVESTER_ITERS):
        if bool(done.all()):
            break
        # the correction and the operator squaring share one left factor
        both = S @ torch.cat([W @ T_k, S], dim=-1)
        delta, S_next = both[..., :n], both[..., n:]
        W_new = W + delta
        dmax = amax_abs(delta)
        small = dmax <= eps * amax_abs(W_new)
        live = ~done[..., None, None]
        W = torch.where(live, W_new, W)
        S = torch.where(live, S_next, S)
        T_k = torch.where(live, T_k @ T_k, T_k)
        done = done | small | ~torch.isfinite(dmax)
    return W


class _CycleReductionT(torch.autograd.Function):
    """(T, n_iter, best_crit) of :func:`_cycle_reduction_raw`; the backward
    is the implicit adjoint (``cycle_reduction.py:153-176``): with
    M = B + C T, solve Mᵀ W + Cᵀ W Tᵀ = T̄, then Ā = −W, B̄ = −W Tᵀ,
    C̄ = −W (Tᵀ)².  n_iter and best_crit carry no gradient."""

    @staticmethod
    def forward(ctx, A, B, C, tol, maxiter):
        T, n_iter, best_crit = _cycle_reduction_raw(A, B, C, tol, maxiter)
        ctx.save_for_backward(B, C, T)
        ctx.mark_non_differentiable(n_iter, best_crit)
        return T, n_iter, best_crit

    @staticmethod
    def backward(ctx, T_bar, _n_iter_bar, _crit_bar):
        B, C, T = ctx.saved_tensors
        with highest_precision():
            W = solve_adjoint_sylvester(B + C @ T, C, T, T_bar)
            WTt = W @ T.mT
            return -W, -WTt, -WTt @ T.mT, None, None


def cycle_reduction(A, B, C, tol: float = 1e-12, maxiter: int = 100
                    ) -> CycleReductionResult:
    """Solve ``A + B T + C T² = 0`` for the minimal solvent, batched.

    Differentiable (implicit adjoint).  ``success`` needs best_crit and the
    residual max|A + B T + C T²| finite and below
    ``success_tol(dtype, max(tol·1e3, 1e-6))``: a divergent run (no stable
    solvent) or a failed residual is a False flag."""
    T, n_iter, best_crit = _CycleReductionT.apply(A, B, C, tol, maxiter)
    thresh = success_tol(A.dtype, max(tol * 1e3, 1e-6))
    resid = _policy_residual_norm(A.detach(), B.detach(), C.detach(),
                                  T.detach())
    success = (best_crit < thresh) & torch.isfinite(resid) & (resid < thresh)
    return CycleReductionResult(T, success, n_iter, resid)


@highest_precision()
def selection_matrix(B, C, T, D):
    """Shock-impact matrix R = −(B + C T)⁻¹ D, differentiable through the
    implicit linear-solve adjoint of :func:`~geconpy_torch.ops.linalg.gj_solve`."""
    return -gj_solve(B + C @ T, D)


def solve_policy_cycle_reduction(A, B, C, D, tol: float = 1e-12,
                                 maxiter: int = 100,
                                 stability_tol: float = 1e-6):
    """Full policy solve: (T, R, success, n_iter, resid_norm); ``success``
    also needs a stable solvent (ρ(T) < 1 + stability_tol) and a finite R."""
    from ..models.perturbation import spectral_radius

    res = cycle_reduction(A, B, C, tol=tol, maxiter=maxiter)
    R = selection_matrix(B, C, res.T, D)
    rho = spectral_radius(res.T.detach())
    stable = torch.isfinite(rho) & (rho < 1.0 + stability_tol)
    success = res.success & stable & torch.isfinite(R).all(dim=(-2, -1))
    return res.T, R, success, res.n_iter, res.resid_norm
