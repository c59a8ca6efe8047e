"""Restarted GMRES, batched over draws: JAX's ``solve_method="batched"``.

Torch has no counterpart of ``jax.scipy.sparse.linalg.gmres``, and the
Newton-Krylov steps of :mod:`.newton` and of the perfect-foresight solver
depend on its exact iterates (an inexact Newton step with a forcing term
of 1e-4 is the GMRES iterate, not the solution).  So this is JAX's
algorithm as jax 0.9.0 has it (``jax/_src/scipy/sparse/linalg.py``):

- ``gmres`` (:591): ``atol = max(tol·‖b‖, atol)``; ``restart`` capped at
  the system's size; ``maxiter`` restarts, 10 × size by default; the
  preconditioned residual ``M(b − A x)`` decides.  (``ptol``, :681-685,
  only serves the ``"incremental"`` method.)
- ``_gmres_solve`` (:558): restart while ``k < maxiter`` and the
  preconditioned residual norm exceeds ``atol``;
- ``_gmres_batched`` (:515): ``restart`` Arnoldi steps
  (``_kth_arnoldi_iteration``, :391: ``v = M(A(V[:, k]))``, classical
  Gram-Schmidt against every column of V — ``_iterative_classical_gram_
  schmidt``, :322, whose second pass never runs with ``max_iterations=2``
  — and a breakdown when the new vector's norm falls to ``eps ‖v‖``), with
  H started as ``eye(restart, restart + 1)``, then one least-squares
  solve ``_lstsq(Hᵀ, β e₁)`` (:508: the normal equations by Cholesky);
- ``_safe_normalize`` (:290): a norm at or below ``thresh`` (``eps`` by
  default) counts as 0 and gives the zero vector.

``A`` and ``M`` map (B, N) to (B, N), each row on its own; ``b`` is
(B, N).  Each draw gets its own Krylov basis: the reference ``vmap``\\ s
its ``while_loop``\\ s, so a draw whose restarts are done (or whose Arnoldi
process broke down) is frozen by a mask while the others go on.  The
Arnoldi steps always run ``restart`` times (a frozen draw's matvecs are
discarded) and read nothing back; each restart reads one flag to the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from .precision import highest_precision

__all__ = ["gmres"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """(x / ‖x‖, ‖x‖) per row, or (0, 0) where ‖x‖ <= thresh."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    safe = torch.where(use, norm, torch.ones_like(norm))
    return (torch.where(use[..., None], x / safe[..., None],
                        torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(aᵀa)⁻¹ aᵀb by Cholesky, batched; NaN where aᵀa is not positive
    definite (``jsp_linalg.solve(..., assume_a='pos')``)."""
    a2 = a.mT @ a
    b2 = (a.mT @ b.unsqueeze(-1))
    L, info = torch.linalg.cholesky_ex(a2)
    y = torch.cholesky_solve(b2, L).squeeze(-1)
    return torch.where((info == 0)[..., None], y, torch.full_like(y, torch.nan))


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart: int):
    """One restart of every draw: (x, unit residual, residual norm)."""
    Bn, N = b.shape
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    V = b.new_zeros(Bn, N, restart + 1)
    V[..., 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dtype,
                  device=b.device).expand(Bn, restart, restart + 1).clone()
    active = torch.ones(Bn, dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(A(V[..., k]))
        _, v_norm_0 = _safe_normalize(v)
        # classical Gram-Schmidt against all columns (one pass)
        h = (V.mT @ v.unsqueeze(-1)).squeeze(-1)             # (B, restart+1)
        v = v - (V @ h.unsqueeze(-1)).squeeze(-1)
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h = h.clone()
        h[..., k + 1] = v_norm_1
        act = active[..., None]
        V[..., k + 1] = torch.where(act, unit_v, V[..., k + 1])
        H[..., k, :] = torch.where(act, h, H[..., k, :])
        active = active & (v_norm_1 != 0)
    beta = b.new_zeros(Bn, restart + 1)
    beta[..., 0] = residual_norm
    y = _lstsq(H.mT, beta)
    x = x0 + (V[..., :-1] @ y.unsqueeze(-1)).squeeze(-1)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


@highest_precision()
def gmres(A: Callable, b: torch.Tensor, *, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter: int | None = None,
          M: Callable | None = None) -> torch.Tensor:
    """Solve ``A x = b`` per draw by restarted GMRES from x = 0 (JAX's
    ``"batched"`` method, left preconditioner ``M``).  ``b`` (B, N);
    returns x (B, N).  Like JAX's it returns the last iterate whether or
    not it met the tolerance."""
    if M is None:
        def M(x):
            return x
    N = b.shape[-1]
    if maxiter is None:
        maxiter = 10 * N
    restart = min(restart, N)
    b_norm = _norm(b)
    atol_b = torch.clamp(tol * b_norm, min=atol)

    x = torch.zeros_like(b)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    live = residual_norm > atol_b
    for _ in range(maxiter):
        if not bool(live.any()):
            break
        x_n, ur_n, rn_n = _gmres_restart(A, M, b, x, unit_residual,
                                         residual_norm, restart)
        lv = live[..., None]
        x = torch.where(lv, x_n, x)
        unit_residual = torch.where(lv, ur_n, unit_residual)
        residual_norm = torch.where(live, rn_n, residual_norm)
        live = live & (residual_norm > atol_b)
    return x
