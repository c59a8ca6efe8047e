"""Static-variable elimination before the policy solve, batched.

Mirrors ``geconpy_tpu/ops/static_reduction.py``: ``plan_static_reduction``
(:42), ``reduce_pencil`` (:95), ``expand_reduced_policy`` (:121) for the
sweep, for the value+grad path ``policy_from_reduced`` (:147),
``finalize_reduced_policy`` (:165) and the implicit policy adjoint
``_implicit_policy_T`` (:54-78), and the XLA policy of the single-draw log
posterior ``solve_policy_reduced`` (:191).  A
variable that appears neither lagged nor led contributes zero columns to A
and C, so a complete-QR row transform of B's static columns splits the
system into rows that back out the statics and a pure quadratic pencil in
the dynamic variables, on which cycle reduction runs.  All matrices carry a
leading batch dimension.  The QR is Householder reflections written out in
batched tensor ops (LAPACK's conventions); the triangular solves are
``torch.linalg`` calls, as the reference leaves both to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.timing import structural_incidence
from .precision import highest_precision

__all__ = ["StaticReduction", "ReducedPencil", "plan_static_reduction",
           "reduce_pencil", "expand_reduced_policy", "policy_from_reduced",
           "finalize_reduced_policy", "solve_policy_reduced"]


class StaticReduction(NamedTuple):
    static_idx: np.ndarray     # variable indices with no lag and no lead
    dynamic_idx: np.ndarray


def plan_static_reduction(equations, variables) -> StaticReduction:
    """Classify variables by structural incidence (host-side, build time)."""
    inc = structural_incidence(equations, variables)
    has_lag = inc["lag"].any(axis=0)
    has_lead = inc["lead"].any(axis=0)
    static = np.flatnonzero(~has_lag & ~has_lead)
    dynamic = np.flatnonzero(has_lag | has_lead)
    return StaticReduction(static, dynamic)


class ReducedPencil(NamedTuple):
    """Row-transformed pencil split into static (1) and dynamic (2) rows."""
    A2: torch.Tensor     # (..., n_d, n_d) pure dynamic quadratic pencil
    B2: torch.Tensor
    C2: torch.Tensor
    A1: torch.Tensor     # (..., n_s, n_d) rows that back out the statics
    B1: torch.Tensor
    C1: torch.Tensor
    R_s: torch.Tensor    # (..., n_s, n_s) upper-triangular static block
    D2: torch.Tensor     # (..., n_d, m) transformed shock loadings
    D1: torch.Tensor     # (..., n_s, m)


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _householder_qt(Bs: torch.Tensor, X: torch.Tensor):
    """Q^T X and R for the complete QR Bs = Q R, batched over the leading
    dims, by Householder reflections with LAPACK's conventions (``dlarfg``:
    beta = -sign(alpha) ||x||, v[0] = 1, tau = (beta - alpha) / beta, and
    H = I where the column below the diagonal is already zero), so Q and R
    are LAPACK's ``geqrf``/``orgqr`` ones up to rounding.  Written out in
    batched tensor ops because the batched ``torch.linalg.qr`` of CUDA
    launches kernels per matrix (92% of the sweep's time at batch 4096 on
    the H100)."""
    R = Bs.clone()
    Y = X.clone()
    p = R.shape[-1]
    for j in range(p):
        alpha = R[..., j, j]
        xnorm = torch.linalg.vector_norm(R[..., j + 1:, j], dim=-1)
        nz = xnorm != 0
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        safe = torch.where(nz, alpha - beta, torch.ones_like(alpha))
        tau = torch.where(nz, (beta - alpha) / torch.where(nz, beta, 1.0), 0.0)
        v = torch.cat([torch.ones_like(alpha)[..., None],
                       R[..., j + 1:, j] / safe[..., None]], dim=-1)
        for M in (R, Y):
            sub = M[..., j:, :]
            w = (v[..., None, :] @ sub)                      # (..., 1, cols)
            M[..., j:, :] = sub - tau[..., None, None] * v[..., :, None] * w
    return Y, torch.triu(R[..., :p, :])


@highest_precision()
def reduce_pencil(A, B, C, D, plan: StaticReduction) -> ReducedPencil:
    """Complete-QR row transform eliminating the static columns."""
    s_idx = _idx(plan.static_idx, A.device)
    d_idx = _idx(plan.dynamic_idx, A.device)
    n_s = len(plan.static_idx)
    n_d = len(plan.dynamic_idx)
    X = torch.cat([A[..., d_idx], B[..., d_idx], C[..., d_idx], D], dim=-1)
    Y, R_s = _householder_qt(B[..., s_idx], X)
    A_d, B_d, C_d, D_t = torch.split(Y, [n_d, n_d, n_d, D.shape[-1]], dim=-1)
    return ReducedPencil(A_d[..., n_s:, :], B_d[..., n_s:, :],
                         C_d[..., n_s:, :], A_d[..., :n_s, :],
                         B_d[..., :n_s, :], C_d[..., :n_s, :], R_s,
                         D_t[..., n_s:, :], D_t[..., :n_s, :])


def _scatter_policy(T_d, T_s, plan: StaticReduction, n: int):
    s_idx = _idx(plan.static_idx, T_d.device)
    d_idx = _idx(plan.dynamic_idx, T_d.device)
    T = T_d.new_zeros(T_d.shape[:-2] + (n, n))
    T[..., d_idx[:, None], d_idx] = T_d
    T[..., s_idx[:, None], d_idx] = T_s
    return T


@highest_precision()
def policy_from_reduced(T_d, red: ReducedPencil, plan: StaticReduction,
                        n: int):
    """Back out the statics and scatter T_d into the original variable
    order (``static_reduction.py:147``); static columns are zero."""
    M = red.B1 + red.C1 @ T_d
    T_s = -torch.linalg.solve_triangular(red.R_s, red.A1 + M @ T_d,
                                         upper=True)
    return _scatter_policy(T_d, T_s, plan, n)


class _ImplicitPolicyT(torch.autograd.Function):
    """Identity on ``T_primal`` whose backward is the full-system implicit
    adjoint of A + B T + C T² = 0 (``static_reduction.py:54-78``): with
    M = B + C T, solve Mᵀ W + Cᵀ W Tᵀ = T̄, then Ā = −W, B̄ = −W Tᵀ,
    C̄ = −W Tᵀ Tᵀ.  The reduced primal (QR transform, cycle-reduction
    kernel) is never differentiated."""

    @staticmethod
    def forward(ctx, A, B, C, T_primal):
        ctx.save_for_backward(B, C, T_primal)
        return T_primal.clone()

    @staticmethod
    def backward(ctx, T_bar):
        from .cycle_reduction import solve_adjoint_sylvester

        B, C, T = ctx.saved_tensors
        with highest_precision():
            W = solve_adjoint_sylvester(B + C @ T, C, T, T_bar)
            WTt = W @ T.mT
            return -W, -WTt, -WTt @ T.mT, None


@highest_precision()
def finalize_reduced_policy(A, B, C, D, T, T_d, cr_success,
                            tol: float = 1e-12):
    """Gradient re-attachment, selection matrix and success flag
    (``static_reduction.py:165``): T through the implicit adjoint, R through
    the differentiable selection solve; success needs the solver's flag,
    ρ(T_d) < 1 + 1e-6 and max|A + B T + C T²| below
    ``success_tol(dtype, max(tol·1e3, 1e-6))``.  ``dtype`` is T_d's: the
    kernel's working type, which is A's in the reference (where every array
    shares one dtype) and bounds how exact a T from the kernel can be."""
    from ..models.perturbation import spectral_radius
    from .cycle_reduction import selection_matrix
    from .tolerances import success_tol

    As, Bs, Cs = (X.detach() for X in (A, B, C))
    T = _ImplicitPolicyT.apply(A, B, C, T)
    R = selection_matrix(B, C, T, D)
    rho = spectral_radius(T_d.detach().to(A.dtype))
    stable = torch.isfinite(rho) & (rho < 1.0 + 1e-6)
    Tsg = T.detach()
    resid = torch.amax((As + Bs @ Tsg + Cs @ Tsg @ Tsg).abs(), dim=(-2, -1))
    success = cr_success & stable & torch.isfinite(resid) & (
        resid < success_tol(T_d.dtype, max(tol * 1e3, 1e-6))) \
        & torch.isfinite(R).all(dim=(-2, -1))
    return T, R, success, resid


@highest_precision()
def expand_reduced_policy(T_d, R_d, red: ReducedPencil,
                          plan: StaticReduction, n: int):
    """Scatter (T_d, R_d) from the dynamic core back to the full system,
    backing out the static rows of the policy and selection matrices."""
    s_idx = _idx(plan.static_idx, T_d.device)
    d_idx = _idx(plan.dynamic_idx, T_d.device)
    M1 = red.B1 + red.C1 @ T_d
    T_s = -torch.linalg.solve_triangular(red.R_s, red.A1 + M1 @ T_d,
                                         upper=True)
    R_s_rows = -torch.linalg.solve_triangular(red.R_s, M1 @ R_d + red.D1,
                                              upper=True)
    T = _scatter_policy(T_d, T_s, plan, n)
    R = T_d.new_zeros(T_d.shape[:-2] + (n, R_d.shape[-1]))
    R[..., d_idx, :] = R_d
    R[..., s_idx, :] = R_s_rows
    return T, R


@highest_precision()
def solve_policy_reduced(A, B, C, D, plan: StaticReduction,
                         tol: float = 1e-12, maxiter: int = 100):
    """Policy solve with the static block eliminated, batched:
    (T, R, success, n_iter, resid_norm) in the original variable order, as
    :func:`~geconpy_torch.ops.cycle_reduction.solve_policy_cycle_reduction`
    on the full system gives them.  The QR reduction and the adaptive cycle
    reduction run on detached pencils (primal only); gradients re-attach at
    the full-system level through :func:`finalize_reduced_policy`."""
    from .cycle_reduction import cycle_reduction, solve_policy_cycle_reduction

    if len(plan.static_idx) == 0:
        return solve_policy_cycle_reduction(A, B, C, D, tol=tol,
                                            maxiter=maxiter)
    n = A.shape[-1]
    As, Bs, Cs, Ds = (X.detach() for X in (A, B, C, D))
    red = reduce_pencil(As, Bs, Cs, Ds, plan)
    cr = cycle_reduction(red.A2, red.B2, red.C2, tol=tol, maxiter=maxiter)
    T = policy_from_reduced(cr.T, red, plan, n)
    T, R, success, resid = finalize_reduced_policy(
        A, B, C, D, T, cr.T, cr.success, tol=tol)
    return T, R, success, cr.n_iter, resid
