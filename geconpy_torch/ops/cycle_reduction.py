"""Pieces of the cycle-reduction policy solve that the batched value+grad
path uses, batched.

Mirrors ``geconpy_tpu/ops/cycle_reduction.py`` as a subset:
``solve_adjoint_sylvester`` (:109), the Smith-doubling adjoint of the
policy's implicit function, and ``selection_matrix`` (:201).  The XLA
cycle reduction itself (``cycle_reduction``, ``solve_policy_cycle_reduction``)
is not ported: the port's policy is the CUDA kernel of
:mod:`~geconpy_torch.ops.batched_cycle_reduction` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from .linalg import gj_eliminate, gj_solve
from .lyapunov import amax_abs
from .precision import highest_precision

__all__ = ["selection_matrix", "solve_adjoint_sylvester"]

#: doubling cap of the Sylvester adjoint (2^30 summed terms, the reference's)
SYLVESTER_ITERS = 30


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


@highest_precision()
def selection_matrix(B, C, T, D):
    """Shock-impact matrix R = −(B + C T)⁻¹ D, differentiable through the
    implicit linear-solve adjoint of :func:`~geconpy_torch.ops.linalg.gj_solve`."""
    return -gj_solve(B + C @ T, D)
