"""Differentiable eigenvalues of a real (nonsymmetric) matrix.

Mirrors ``geconpy_tpu/ops/eig.py`` (``eig_vals``), where the factorization
is a host callback with an analytic VJP.  Here it is a
``torch.autograd.Function`` whose forward and backward factorize on the
host, as the reference's do (LAPACK's ``geev`` through
``torch.linalg.eig``), whatever M's device: a diagnostics path (BK
eigenvalue tables, parameter sensitivity), not the estimation loop.  The
BK companion matrix it serves has repeated zero roots, where the
eigenvector matrix V is near singular, and the gradient uses V⁻¹: through
the card's ``torch.linalg.eig`` it came out orders of magnitude off the
host's.  The gradient is exact for simple eigenvalues:

    dλ_k = y_kᵀ dM x_k          (x_k right eigvec, y_kᵀ the k-th row of V⁻¹)

so the VJP with real cotangents (re_bar, im_bar) is

    M_bar = Re( (V diag(re_bar − i·im_bar) V⁻¹)ᵀ ).

Eigenvalues are sorted by modulus (ascending, stable), as in the
reference.  The two members of a conjugate pair have equal moduli, so
their order follows the factorization's; compare them sorted by (modulus,
imaginary part).
"""

from __future__ import annotations

import torch

__all__ = ["eig_vals"]


def _eig_sorted(M: torch.Tensor):
    """Eigenvalues and right eigenvectors of M, on the host, sorted by
    modulus."""
    lam, V = torch.linalg.eig(M.detach().to("cpu", torch.float64))
    order = torch.argsort(lam.abs(), stable=True)
    return lam[order], V[:, order]


class _EigVals(torch.autograd.Function):

    @staticmethod
    def forward(ctx, M):
        lam, V = _eig_sorted(M)
        ctx.save_for_backward(V)
        ctx.dtype, ctx.device = M.dtype, M.device
        return (lam.real.to(M.dtype).to(M.device),
                lam.imag.to(M.dtype).to(M.device))

    @staticmethod
    def backward(ctx, re_bar, im_bar):
        (V,) = ctx.saved_tensors
        c = re_bar.to("cpu", torch.float64) - 1j * im_bar.to("cpu",
                                                            torch.float64)
        M_bar = (V @ torch.diag(c) @ torch.linalg.inv(V)).mT
        return M_bar.real.to(ctx.dtype).to(ctx.device).contiguous()


def eig_vals(M: torch.Tensor):
    """Eigenvalues of a real square matrix, sorted by modulus (ascending).

    Returns ``(re, im)`` in M's dtype, on its device (factorized on the
    host).  Differentiable (exact analytic VJP for simple eigenvalues).
    """
    return _EigVals.apply(M)
