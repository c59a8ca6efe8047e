"""Block-tridiagonal linear solve (block Thomas algorithm), batched.

Mirrors ``geconpy_tpu/ops/block_tridiag.py::solve_block_tridiagonal``
(:22), which replaces the reference gEconpy's scipy.sparse LU over the
stacked perfect-foresight Jacobian: the stacked-time system is
block-tridiagonal by construction, so an O(T n^3) forward elimination and
back substitution beat a generic sparse LU.  The reference's two
``lax.scan``\\ s become two Python loops over the periods, each step one
batched kernel call over the leading dimensions (the reference test
``vmap``\\ s the solve); no host read.  Differentiable by autograd.
"""

from __future__ import annotations

import torch

from .precision import highest_precision

__all__ = ["solve_block_tridiagonal"]


@highest_precision()
def solve_block_tridiagonal(A, B, C, d):
    """Solve the block-tridiagonal system

        A[t] x[t-1] + B[t] x[t] + C[t] x[t+1] = d[t],   t = 0..T-1

    with A[0] and C[T-1] ignored (no x[-1] / x[T] terms).

    Shapes: A, B, C are (..., T, n, n); d is (..., T, n).  Returns x of
    shape (..., T, n).  A singular pivot block gives NaN in its system,
    never an exception (``jnp.linalg.solve``'s non-finite result).
    """
    T, n = B.shape[-3], B.shape[-1]
    batch = B.shape[:-3]

    # forward elimination:
    #   W[t] = (B[t] - A[t] W[t-1])^{-1} C[t]
    #   g[t] = (B[t] - A[t] W[t-1])^{-1} (d[t] - A[t] g[t-1])
    W_prev = B.new_zeros(batch + (n, n))
    g_prev = B.new_zeros(batch + (n,))
    Ws, gs = [], []
    for t in range(T):
        A_t = A[..., t, :, :]
        M = B[..., t, :, :] - A_t @ W_prev
        # one LU, two right-hand sides
        rhs = torch.cat([C[..., t, :, :],
                         (d[..., t, :] - (A_t @ g_prev.unsqueeze(-1))
                          .squeeze(-1)).unsqueeze(-1)], dim=-1)
        sol, info = torch.linalg.solve_ex(M, rhs)
        sol = torch.where((info == 0)[..., None, None], sol,
                          torch.full_like(sol, torch.nan))
        W_prev, g_prev = sol[..., :n], sol[..., n]
        Ws.append(W_prev)
        gs.append(g_prev)

    # back substitution: x[T-1] = g[T-1]; x[t] = g[t] - W[t] x[t+1]
    x_next = B.new_zeros(batch + (n,))
    xs = [None] * T
    for t in range(T - 1, -1, -1):
        x_next = gs[t] - (Ws[t] @ x_next.unsqueeze(-1)).squeeze(-1)
        xs[t] = x_next
    return torch.stack(xs, dim=-2)
