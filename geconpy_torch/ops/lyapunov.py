"""Discrete Lyapunov solve by Smith doubling, batched, with its adjoint.

Mirrors ``geconpy_tpu/ops/lyapunov.py``: ``_doubling`` (:27), which solves
P = T P Tᵀ + Q by  P_{k+1} = P_k + A_k P_k A_kᵀ,  A_{k+1} = A_k², and
``solve_discrete_lyapunov`` (:49) with its VJP (``_lyap_bwd``, :64-70).
The reference runs the doubling per draw in a ``while_loop`` under
``vmap``, so each draw stops on its own criterion; here a finished draw is
frozen by a per-draw mask and the loop runs while any draw is unfinished,
so every draw takes exactly the reference's number of doublings and a NaN
in one draw stops or poisons no other.  Each doubling reads one flag back
to the host (``done.all()``).
"""

from __future__ import annotations

import torch

from .precision import highest_precision

__all__ = ["_doubling", "amax_abs", "solve_discrete_lyapunov"]


def amax_abs(M: torch.Tensor) -> torch.Tensor:
    """max |M| over each draw's own matrix (the last two dims)."""
    return torch.amax(M.abs(), dim=(-2, -1))


def _doubling(T: torch.Tensor, Q: torch.Tensor, tol: float, maxiter: int
              ) -> torch.Tensor:
    """Symmetrised P = T P Tᵀ + Q for stable T; a draw stops once its
    update max|ΔP| falls below ``max(tol, 10 eps)`` or goes non-finite."""
    # the tolerance cannot beat the dtype's machine epsilon
    tol = max(tol, 10 * float(torch.finfo(T.dtype).eps))
    A, P = T, Q
    done = torch.zeros(T.shape[:-2], dtype=torch.bool, device=T.device)
    for _ in range(maxiter):
        if bool(done.all()):
            break
        P_new = P + A @ P @ A.mT
        A_new = A @ A
        delta = amax_abs(P_new - P)
        live = ~done[..., None, None]
        P = torch.where(live, P_new, P)
        A = torch.where(live, A_new, A)
        done = done | (delta < tol) | ~torch.isfinite(delta)
    # enforce symmetry lost to roundoff
    return 0.5 * (P + P.mT)


class _Lyapunov(torch.autograd.Function):
    """P solving P = T P Tᵀ + Q; the backward solves the adjoint equation
    W = Tᵀ W T + P̄ by the same doubling, then Q̄ = W and
    T̄ = (W + Wᵀ) T P (``lyapunov.py:64-70``)."""

    @staticmethod
    def forward(ctx, T, Q, tol, maxiter):
        with highest_precision():
            P = _doubling(T, Q, tol, maxiter)
        ctx.save_for_backward(T, P)
        ctx.tol, ctx.maxiter = tol, maxiter
        return P

    @staticmethod
    def backward(ctx, P_bar):
        T, P = ctx.saved_tensors
        with highest_precision():
            W = _doubling(T.mT, P_bar, ctx.tol, ctx.maxiter)
            T_bar = (W + W.mT) @ T @ P
        return T_bar, W, None, None


def solve_discrete_lyapunov(T: torch.Tensor, Q: torch.Tensor,
                            tol: float = 1e-12, maxiter: int = 60
                            ) -> torch.Tensor:
    """Solve ``P = T P Tᵀ + Q`` for stable T, batched over the leading
    dimensions; differentiable in T and Q."""
    return _Lyapunov.apply(T, Q, tol, maxiter)
