"""Discrete Lyapunov solve by Smith doubling, batched.

Mirrors ``geconpy_tpu/ops/lyapunov.py``: ``_doubling`` (:27), which solves
P = T P Tᵀ + Q by  P_{k+1} = P_k + A_k P_k A_kᵀ,  A_{k+1} = A_k².  The
reference runs it per draw in a ``while_loop`` under ``vmap``, so each draw
stops on its own criterion; here a finished draw is frozen by a per-draw
mask and the loop runs while any draw is unfinished, so every draw takes
exactly the reference's number of doublings and a NaN in one draw stops or
poisons no other.
"""

from __future__ import annotations

import torch

__all__ = ["_doubling", "amax_abs"]


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
