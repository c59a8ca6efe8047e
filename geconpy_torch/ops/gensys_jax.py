"""gensys (Sims 2002) on the device, batched, with no QZ.

Mirrors ``geconpy_tpu/ops/gensys_jax.py`` (the name is kept so that the
counterpart is easy to find; the code is torch): ``GensysJaxResult``
(:56), ``_orth_complete`` (:65), ``gensys_jax`` (:74) and
``make_gensys_solver`` (:165).  gensys needs no triangular QZ factors, only

  1. the stable/unstable partition of the pencil (a right deflating
     subspace Z and a compatible left basis Q), which the inverse-free disk
     split of :mod:`~geconpy_torch.ops.qz_disk` gives, and
  2. SVD-based existence and uniqueness tests on the unstable block's
     loadings of the expectational errors,

both of which work on a block (non-triangular) ordered decomposition.  The
number of expectational errors (the lead variables) is structural and fixed
when the solver is built, so every shape is static; the split radius is
fixed (``div=1.01``), and a draw with a root in [1, div) flags
``success=False`` instead of being mis-solved.  Failures (a wrong split
dimension, rank-deficient loadings, no solution, a singular system) are
flags, never exceptions: the solves are ``torch.linalg.solve_ex`` (NaN in a
singular draw) and a draw with a non-finite input is solved on zeros and
returned as NaN with every flag false, because torch's SVD raises on a
non-finite matrix where JAX's returns NaN.  ``_RANK_TOL`` and the 1e-7
existence and uniqueness tolerances are the reference's.

Every function takes optional leading batch dimensions (the reference
``vmap``s them), and a draw gives the same bits alone as in a batch.  The bases ``V``, ``Q`` and ``Z`` come from an SVD and a
complete QR, so they are unique only up to signs and rotations; T, R,
``split_dim`` and the flags do not depend on them.  Neither torch nor JAX
differentiates a complete QR of a tall matrix, so this solve is primal
only; :func:`attach_policy_gradient` re-attaches T and R to the pencil.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cycle_reduction import _solve_nan
from .precision import highest_precision
from .qz_disk import disk_function_split, flat_batch

__all__ = ["gensys_jax", "make_gensys_solver", "GensysJaxResult",
           "attach_policy_gradient"]

_RANK_TOL = 1e-9


class GensysJaxResult(NamedTuple):
    T: torch.Tensor            # (..., n, n) transition (original variables)
    R: torch.Tensor            # (..., n, n_shocks) impact
    existence: torch.Tensor    # (...,) bool
    uniqueness: torch.Tensor   # (...,) bool
    success: torch.Tensor      # existence & uniqueness & finite
    split_dim: torch.Tensor    # (...,) detected stable-subspace dimension


def _orth_complete(V: torch.Tensor) -> torch.Tensor:
    """Full orthonormal basis [V | V_perp] from an orthonormal block V."""
    Q, _ = torch.linalg.qr(V, mode="complete")
    # the QR of an orthonormal matrix is itself up to column signs; use Q
    return Q


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(M, ord="fro")


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


@flat_batch
@highest_precision()
def gensys_jax(g0, g1, psi, pi, n_orig: int, n_leads: int,
               div: float = 1.01, n_iter: int = 30) -> GensysJaxResult:
    """Solve  g0 y_t = g1 y_{t-1} + psi z_t + pi eta_t, batched.

    ``n_orig`` is the original variable count (T and R are returned
    restricted to it); ``n_leads`` the number of auxiliary lead states and
    expectational errors (static).
    """
    m = g0.shape[-1]
    batch = g0.shape[:-2]
    ns = m - n_leads           # the stable dimension under determinacy
    ku = n_leads
    n_shocks = psi.shape[-1]

    finite_in = torch.isfinite(g0).all(dim=(-2, -1)) \
        & torch.isfinite(g1).all(dim=(-2, -1)) \
        & torch.isfinite(psi).all(dim=(-2, -1)) \
        & torch.isfinite(pi).all(dim=(-2, -1))
    g0, g1, psi, pi = (torch.where(finite_in[..., None, None], X,
                                   torch.zeros_like(X))
                       for X in (g0, g1, psi, pi))

    # ---- spectral split of the transition pencil (g1, g0): stable inside
    split = disk_function_split(g1, g0, k_stable=ns, radius=div,
                                n_iter=n_iter)
    V = split.V_stable                                    # (..., m, ns)
    Zfull = _orth_complete(V)                             # (..., m, m)

    # left basis: U1 spans [g0 V, g1 V]
    W = torch.cat([g0 @ V, g1 @ V], dim=-1)               # (..., m, 2 ns)
    Uw = torch.linalg.svd(W, full_matrices=False)[0]
    U1 = Uw[..., :, :ns]
    Qfull = _orth_complete(U1)                            # (..., m, m)

    qh = Qfull.mT
    a = qh @ g0 @ Zfull                                   # block upper-tri
    b = qh @ g1 @ Zfull
    q1 = qh[..., :ns, :]
    q2 = qh[..., ns:, :]

    # ---- existence / uniqueness via SVDs of the eta loadings
    if ku:
        etawt = q2 @ pi                                   # (..., ku, ku)
        ueta, deta, vetah = torch.linalg.svd(etawt, full_matrices=False)
        floor = _RANK_TOL * torch.clamp(deta[..., :1], min=1.0)
        rank_full = deta[..., -1] > floor[..., 0]
        inv_deta = torch.where(deta > floor,
                               1.0 / torch.clamp(deta, min=1e-300),
                               torch.zeros_like(deta))
        veta = vetah.mT
        # existence: the unstable shock loadings lie in span(ueta)
        zwt = q2 @ psi
        resid_exist = zwt - ueta @ (ueta.mT @ zwt)
        existence = _fro(resid_exist) < 1e-7 * (1.0 + _fro(zwt))
        # uniqueness: no loose expectational errors in the stable block
        etawt1 = q1 @ pi
        loose = etawt1 @ (_eye(ku, g0) - veta @ veta.mT)
        uniqueness = rank_full & (
            _fro(loose) < 1e-7 * (1.0 + _fro(etawt1)))

        ueta1, deta1, veta1h = torch.linalg.svd(etawt1, full_matrices=False)
        inner = (ueta * inv_deta[..., None, :]) @ vetah \
            @ veta1h.mT @ (deta1[..., :, None] * ueta1.mT)
        tmat = torch.cat([_eye(ns, g0).expand(batch + (ns, ns)),
                          -inner.mT], dim=-1)
    else:
        existence = torch.ones(batch, dtype=torch.bool, device=g0.device)
        uniqueness = torch.ones_like(existence)
        tmat = _eye(ns, g0).expand(batch + (ns, ns))

    # ---- assemble the solution (block form; no triangularity needed)
    lower = torch.cat([g0.new_zeros(batch + (ku, ns)),
                       _eye(ku, g0).expand(batch + (ku, ku))], dim=-1)
    G0 = torch.cat([tmat @ a, lower], dim=-2)
    G1_raw = torch.cat([tmat @ b, g0.new_zeros(batch + (ku, m))], dim=-2)
    impact_raw = torch.cat([tmat @ (qh @ psi),
                            g0.new_zeros(batch + (ku, n_shocks))], dim=-2)
    # one pivoted LU of G0 for both right-hand sides
    X = _solve_nan(G0, torch.cat([G1_raw, impact_raw], dim=-1))
    G1 = Zfull @ X[..., :m] @ Zfull.mT
    impact = Zfull @ X[..., m:]

    T = G1[..., :n_orig, :n_orig]
    R = impact[..., :n_orig, :]
    T = torch.where(finite_in[..., None, None], T,
                    torch.full_like(T, torch.nan))
    R = torch.where(finite_in[..., None, None], R,
                    torch.full_like(R, torch.nan))

    finite = torch.isfinite(T).all(dim=(-2, -1)) \
        & torch.isfinite(R).all(dim=(-2, -1))
    # fold the spectral split's count into the eu codes: too many stable
    # roots is indeterminacy (sunspots), too few means no stable solution
    existence = existence & finite_in & (split.n_inside >= ns)
    uniqueness = uniqueness & finite_in & (split.n_inside <= ns)
    success = split.converged & existence & uniqueness & finite
    return GensysJaxResult(T, R, existence, uniqueness, success,
                           split.n_inside)


def make_gensys_solver(n_vars: int, lead_idx: np.ndarray, n_shocks: int,
                       div: float = 1.01):
    """Build ``solve(A, B, C, D) -> GensysJaxResult`` over leading batch
    dimensions.

    ``lead_idx`` (structural, from the symbolic C-column incidence) fixes
    the augmented system's layout when the solver is built, the role of
    the host ``gensys_setup``: state s_t = [y_t ; w_t] with
    w_t = E_t y_{t+1} on the lead columns, and expectational rows
    y_{j,t} = w_{j,t-1} + eta_{j,t}.
    """
    lead_idx = np.asarray(lead_idx, dtype=np.int64)
    k = len(lead_idx)
    m = n_vars + k
    # constant blocks of g0, g1 and pi
    expect_np = np.zeros((k, n_vars))
    expect_np[np.arange(k), lead_idx] = 1.0
    pi_np = np.zeros((m, k))
    pi_np[n_vars + np.arange(k), np.arange(k)] = 1.0
    consts: dict = {}

    def _const(A: torch.Tensor):
        key = (A.dtype, A.device)
        if key not in consts:
            as_t = lambda x: torch.as_tensor(  # noqa: E731
                x, dtype=A.dtype, device=A.device)
            consts[key] = (torch.as_tensor(lead_idx, device=A.device),
                           as_t(expect_np), as_t(pi_np))
        return consts[key]

    def solve(A, B, C, D) -> GensysJaxResult:
        lead, expect, pi = _const(A)
        batch = A.shape[:-2]
        ex = lambda X: X.expand(batch + X.shape)  # noqa: E731
        g0 = torch.cat([
            torch.cat([-B, -C[..., lead]], dim=-1),
            ex(torch.cat([expect, expect.new_zeros((k, k))], dim=-1))],
            dim=-2)
        g1 = torch.cat([
            torch.cat([A, A.new_zeros(batch + (n_vars, k))], dim=-1),
            ex(torch.cat([expect.new_zeros((k, n_vars)),
                          torch.eye(k, dtype=A.dtype, device=A.device)],
                         dim=-1))], dim=-2)
        psi = torch.cat([D, D.new_zeros(batch + (k, D.shape[-1]))], dim=-2)
        return gensys_jax(g0, g1, psi, ex(pi), n_orig=n_vars, n_leads=k,
                          div=div)

    return solve


@highest_precision()
def attach_policy_gradient(A, B, C, D, T, R):
    """T and R of a primal-only solve, with their values unchanged and
    gradients to (A, B, C, D): T through the implicit adjoint of
    A + B T + C T² = 0 (the one cycle reduction uses), R through the
    differentiable selection -(B + C T)⁻¹ D.  Without autograd on the
    pencil they come back as they are."""
    if not any(X.requires_grad for X in (A, B, C, D)):
        return T, R
    from .cycle_reduction import selection_matrix
    from .static_reduction import _ImplicitPolicyT

    T_g = _ImplicitPolicyT.apply(A, B, C, T.detach())
    R_g = selection_matrix(B, C, T_g, D)
    # the selection's value may differ from R in the last bits: keep R's
    return T_g, R.detach() + (R_g - R_g.detach())
