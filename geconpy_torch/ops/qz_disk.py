"""Inverse-free spectral divide-and-conquer for matrix pencils, batched.

Mirrors ``geconpy_tpu/ops/qz_disk.py``: ``DiskSplitResult`` (:39),
``_disk_projector`` (:50), ``count_eigs_inside`` (:83) and
``disk_function_split`` (:106).  The stable/unstable split that gensys
needs comes from the inverse-free disk-function iteration of Bai, Demmel &
Gu (Numer. Math. 76, 1997): for a pencil (A, B) with generalized
eigenvalues lambda (det(A - lambda B) = 0), one step of

    qr([[B_j], [-A_j]]) = Q [[R],[0]],   Q = [[Q11, Q12], [Q21, Q22]]
    A_{j+1} = Q12ᵀ A_j,   B_{j+1} = Q22ᵀ B_j

squares every eigenvalue.  After the reference's 30 fixed steps the
eigenvalues inside the disk have gone to 0 and those outside to infinity,
and P_inside = (A_inf + B_inf)⁻¹ B_inf projects onto the right deflating
subspace for |lambda| < radius; an SVD gives its basis and dimension.

Every function takes the pencil with optional leading batch dimensions
(the reference ``vmap``s them): the QRs, solves and SVDs are batched torch
calls, so a batch runs every step together, and a draw gives the same
bits alone as in any batch (:func:`flat_batch`).  The normalisation, the
thresholds (0.5 for the count, the 0.2-0.8 dead band) and the ``1e-300``
floor are the reference's.  The solve is ``torch.linalg.solve_ex``: a
singular A_inf + B_inf gives ``finite=False`` in its own draw, never an
exception.  The basis ``V_stable`` is unique only up to signs and
rotations inside a cluster of singular values, so it may differ from the
reference's; the subspace, ``sv`` and ``n_inside`` do not.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .cycle_reduction import _solve_nan
from .precision import highest_precision

__all__ = ["disk_function_split", "DiskSplitResult", "count_eigs_inside"]


class DiskSplitResult(NamedTuple):
    V_stable: torch.Tensor    # (..., n, k) orthonormal basis of the right
    #                           deflating subspace for |lambda| < radius
    sv: torch.Tensor          # (..., n) singular values of the projector,
    #                           descending: ~1 on the subspace, ~0 off it
    n_inside: torch.Tensor    # (...,) detected subspace dimension
    converged: torch.Tensor   # (...,) bool


def flat_batch(fn):
    """Run ``fn`` on its tensor arguments with their leading dimensions
    flattened into one batch dimension (a single pencil becomes a batch of
    one) and give every tensor it returns those dimensions back.  CPU
    matmuls with a transposed operand round differently in 2-D than
    batched, but the same for any batch size: so a draw's result does not
    depend on the batch it runs in."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        batch = args[0].shape[:-2]
        flat = [a.reshape((-1,) + a.shape[-2:])
                if isinstance(a, torch.Tensor) else a for a in args]
        out = fn(*flat, **kwargs)
        back = lambda t: t.reshape(batch + t.shape[1:])  # noqa: E731
        if isinstance(out, torch.Tensor):
            return back(out)
        parts = [back(t) for t in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return wrapper


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(M, ord="fro")


def _disk_projector(A: torch.Tensor, B: torch.Tensor, radius: float,
                    n_iter: int):
    """Run the inverse-free iteration; return (P_inside, finite flag), with
    P_inside zeroed in a draw where it is not finite."""
    n = A.shape[-1]
    A_j = A / radius
    B_j = B
    for _ in range(n_iter):
        # normalize to keep magnitudes bounded (an equivalence transform)
        s = torch.clamp(torch.maximum(_fro(A_j), _fro(B_j)), min=1e-300)
        A_n = A_j / s[..., None, None]
        B_n = B_j / s[..., None, None]
        stacked = torch.cat([B_n, -A_n], dim=-2)               # (..., 2n, n)
        Q, _ = torch.linalg.qr(stacked, mode="complete")       # (..., 2n, 2n)
        Q12 = Q[..., :n, n:]
        Q22 = Q[..., n:, n:]
        A_j = Q12.mT @ A_n
        B_j = Q22.mT @ B_n
    # the projector onto the inside deflating subspace: (A_inf + B_inf)⁻¹ B_inf
    P_in = _solve_nan(A_j + B_j, B_j)
    finite = torch.isfinite(P_in).all(dim=(-2, -1))
    return torch.where(finite[..., None, None], P_in,
                       torch.zeros_like(P_in)), finite


@flat_batch
@highest_precision()
def count_eigs_inside(A: torch.Tensor, B: torch.Tensor, radius: float = 1.0,
                      n_iter: int = 30):
    """Number of generalized eigenvalues of the pencil (A, B) with
    |lambda| < ``radius``, per draw, on the pencil's device.

    Infinite eigenvalues (singular B directions) land outside every disk,
    so ``n - n_inside`` counts unstable-plus-infinite roots, the
    Blanchard-Kahn count.  Returns ``(n_inside, ok)``, where ``ok`` flags a
    clean 0/1 singular-value gap of the projector: a draw with a root on
    the split circle reports ``ok=False`` rather than an arbitrary count.
    """
    P_in, finite = _disk_projector(A, B, radius, n_iter)
    sv = torch.linalg.svdvals(P_in)
    n_inside = (sv > 0.5).sum(dim=-1)
    # oblique-projector singular values cluster at >= 1 and ~0; anything in
    # the dead band means the iteration did not separate the spectra
    gap_ok = ~((sv > 0.2) & (sv < 0.8)).any(dim=-1)
    return n_inside, finite & gap_ok


@flat_batch
@highest_precision()
def disk_function_split(A: torch.Tensor, B: torch.Tensor, k_stable: int,
                        radius: float = 1.0, n_iter: int = 30
                        ) -> DiskSplitResult:
    """Right deflating subspace of the pencil (A, B) for |lambda| < radius.

    ``k_stable`` is the expected subspace dimension (static; for a
    determinate DSGE model the number of non-explosive roots).  The
    detected dimension is returned, so callers can flag indeterminacy or
    nonexistence when it differs.
    """
    n = A.shape[-1]
    P_safe, finite = _disk_projector(A, B, radius, n_iter)

    # orthonormal basis of range(P_in): the top singular vectors
    U, sv, _ = torch.linalg.svd(P_safe)
    V_stable = U[..., :, :k_stable]

    # detected dimension: the singular values of a projector are ~1 / ~0
    n_inside = (sv > 0.5).sum(dim=-1)
    gap_ok = torch.ones_like(finite)
    if k_stable > 0:
        gap_ok = gap_ok & (sv[..., k_stable - 1] > 0.5)
    if k_stable < n:
        gap_ok = gap_ok & (sv[..., k_stable] < 0.5)
    converged = finite & gap_ok & (n_inside == k_stable)
    return DiskSplitResult(V_stable, sv, n_inside, converged)
