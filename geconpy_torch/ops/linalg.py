"""Batched small-matrix Gauss-Jordan solves.

Mirrors ``geconpy_tpu/ops/linalg.py``: ``gj_solve`` (:47) and
``gj_inverse`` (:75), over any leading batch dimensions.  The elimination
:func:`gj_eliminate` is partially pivoted with ``jnp.argmax``'s rule (the
first maximal |entry| among rows >= k, ``linalg.py:31-33``; NaN counts as
largest), and is also the plain schedule of the CUDA kernels' Gauss-Jordan
helper (``csrc/small_linalg.cuh``).  Singular inputs give inf/NaN that the
callers' success flags catch, never an exception.

:func:`gj_solve` differentiates as ``jax.lax.custom_linear_solve`` does
(``linalg.py:63-72``): the backward pass is one more elimination with Mᵀ,
never the elimination's own derivative.
"""

from __future__ import annotations

import torch

__all__ = ["gj_eliminate", "gj_eliminate_panels", "gj_solve", "gj_inverse"]


def gj_eliminate(A: torch.Tensor, RHS: torch.Tensor):
    """Partially pivoted Gauss-Jordan, batched:
    (..., n, n), (..., n, m) -> (A^{-1} RHS, min|pivot|, log|det A|).

    Step k picks the first maximal |aug[i, k]| over rows i >= k, swaps rows
    k and p, divides the pivot row by the pivot and eliminates it from every
    other row over all columns — the schedule of ``_gj_solve``
    (``pallas_cycle_reduction.py:90``) and of ``csrc/small_linalg.cuh``.
    """
    aug = torch.cat([A, RHS], dim=-1)
    n = A.shape[-1]
    batch = aug.shape[:-2]
    rows = torch.arange(n, device=A.device)
    minpiv = torch.full(batch, float("inf"), dtype=A.dtype, device=A.device)
    logdet = torch.zeros(batch, dtype=A.dtype, device=A.device)
    for k in range(n):
        colk = aug[..., :, k]
        mag = torch.where(rows >= k, colk.abs(), torch.full_like(colk, -1.0))
        p = torch.argmax(mag, dim=-1)
        pmask = rows == p[..., None]
        row_p = torch.take_along_dim(aug, p[..., None, None], dim=-2)[..., 0, :]
        row_k = aug[..., k, :]
        # swap rows k and p (identical writes when p == k)
        swapped = torch.where(pmask[..., None], row_k[..., None, :], aug)
        swapped[..., k, :] = row_p
        piv = row_p[..., k]
        r = row_p / piv[..., None]
        # column k after the swap: entry p picks up the old aug[k, k]
        col = torch.where(pmask, colk[..., k:k + 1], colk)
        col = torch.where(rows == k, torch.zeros_like(col), col)
        aug = swapped - col[..., :, None] * r[..., None, :]
        aug[..., k, :] = r
        minpiv = torch.minimum(minpiv, piv.abs())
        logdet = logdet + torch.log(piv.abs())
    return aug[..., n:], minpiv, logdet


def gj_eliminate_panels(A: torch.Tensor, RHS: torch.Tensor, panel: int,
                        pivots: list | None = None):
    """:func:`gj_eliminate`'s pivots in panels of ``panel`` columns, the
    schedule of the cluster-tier K1/K4 (``csrc/cycle_reduction_tiers.cu``):
    (..., n, n), (..., n, m) -> (A^{-1} RHS, min|pivot|).

    Rows are never moved: logical positions follow the swaps (``lpos``,
    and ``plog``, the physical row at each position), and each step pivots
    on the first maximal |entry| of its column in logical order (NaN
    largest), as ``_gj_solve`` does.  A panel's ``b`` columns are
    eliminated step by step on their own (r = row_P * (1 / pivot), the
    other rows x - c r), which fixes the pivots P_t, their reciprocals and
    the multiplier columns c_t (column t of the panel when its step
    starts).  The pivot rows of the whole system then give r_t = ((x_P_t -
    c_0[P_t] r_0) - ... - c_{t-1}[P_t] r_{t-1}) / pivot_t, in that order;
    every other row becomes x - C r (one product of depth b), and row P_t
    r_t - c_{t+1}[P_t] r_{t+1} - ..., in that order.  ``panel = 1`` is
    :func:`gj_eliminate`'s sequence of operations, but for 1 / pivot.
    ``pivots``, if given, receives each step's physical pivot rows.
    """
    aug = torch.cat([A, RHS], dim=-1)
    n = A.shape[-1]
    batch = aug.shape[:-2]
    rows = torch.arange(n, device=A.device)
    plog = rows.expand(batch + (n,)).clone()
    lpos = plog.clone()
    minpiv = torch.full(batch, float("inf"), dtype=A.dtype, device=A.device)

    def at(X, i):   # X[..., i[...], :] for a row index per draw
        return torch.take_along_dim(X, i[..., None, None], dim=-2)[..., 0, :]

    for k0 in range(0, n, panel):
        bb = min(panel, n - k0)
        pn = aug[..., k0:k0 + bb].clone()
        P, pinv = [], []
        for j in range(bb):
            k = k0 + j
            col = pn[..., j]
            mag = torch.where(lpos >= k, col.abs(), torch.full_like(col, -1.0))
            bl = torch.argmax(torch.take_along_dim(mag, plog, dim=-1), dim=-1)
            Pj = torch.take_along_dim(plog, bl[..., None], dim=-1)[..., 0]
            Rk = plog[..., k].clone()
            plog.scatter_(-1, bl[..., None], Rk[..., None])
            plog[..., k] = Pj
            lpos.scatter_(-1, Pj[..., None], torch.full_like(Pj[..., None], k))
            lpos.scatter_(-1, Rk[..., None], bl[..., None])
            pv = torch.take_along_dim(col, Pj[..., None], dim=-1)[..., 0]
            pi = 1.0 / pv
            minpiv = torch.minimum(minpiv, pv.abs())
            if j + 1 < bb:
                r = at(pn[..., j + 1:], Pj) * pi[..., None]
                upd = pn[..., j + 1:] - pn[..., j:j + 1] * r[..., None, :]
                is_p = (rows == Pj[..., None])[..., None]
                pn[..., j + 1:] = torch.where(is_p, r[..., None, :], upd)
            P.append(Pj)
            pinv.append(pi)
        if pivots is not None:
            pivots.extend(P)
        cP = [at(pn, Pt) for Pt in P]      # cP[t][..., s] = c_s[P_t]
        r = []
        for t in range(bb):
            v = at(aug, P[t])
            for s in range(t):
                v = v - cP[t][..., s, None] * r[s]
            r.append(v * pinv[t][..., None])
        new = aug - pn @ torch.stack(r, dim=-2)
        for t in range(bb):
            v = r[t]
            for s in range(t + 1, bb):
                v = v - cP[t][..., s, None] * r[s]
            is_p = (rows == P[t][..., None])[..., None]
            new = torch.where(is_p, v[..., None, :], new)
        aug = new
    sol = torch.take_along_dim(aug[..., n:], plog[..., None], dim=-2)
    return sol, minpiv


class _GJSolve(torch.autograd.Function):
    """X = M^{-1} B with the implicit linear-solve adjoint:
    B̄ = M^{-T} X̄ (one more elimination), M̄ = -B̄ Xᵀ."""

    @staticmethod
    def forward(ctx, M, B):
        X = gj_eliminate(M, B)[0]
        ctx.save_for_backward(M, X)
        return X

    @staticmethod
    def backward(ctx, X_bar):
        M, X = ctx.saved_tensors
        B_bar = gj_eliminate(M.transpose(-1, -2), X_bar)[0]
        M_bar = -B_bar @ X.transpose(-1, -2)
        return M_bar, B_bar


def gj_solve(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``M X = B`` by pivoted Gauss-Jordan; (..., n, n), (..., n, k).
    Differentiable in both arguments (see :class:`_GJSolve`)."""
    return _GJSolve.apply(M, B)


def gj_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a general (..., n, n) matrix by pivoted Gauss-Jordan."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    return gj_solve(M, eye)
