"""Shared minimum-distance optimizer: Adam to the basin, Gauss-Newton to
machine precision, and the exact Jacobian both estimators' standard
errors use.

Mirrors ``geconpy_tpu/stats/_optim.py::adam_gauss_newton`` (:22), used by
the IRF-matching and moment-matching estimators.  ``residuals_fn(z) ->
(r, ok)`` returns the weighted residual vector and a solver-success flag;
failures gate the loss to +inf, so Adam's gradients are zeroed there and
Gauss-Newton steps into failure regions are rejected.

``residuals_fn`` must accept a batch ``z (B, dim) -> (r (B, m), ok (B,))``
as well as one point, each row depending on its own ``z`` only (the
port's solution pipelines are: every draw carries its own freeze mask).
:func:`jacobian` uses that: the reference's ``jax.jacrev`` is a ``vmap``
of one VJP per output row, and the port's adjoints (the cycle-reduction
Sylvester, the Lyapunov doubling, the implicit steady state) read a
convergence flag back to the host inside their backward, which neither
``torch.func.jacrev`` nor ``autograd.grad(is_grads_batched=True)`` can
trace.  So the primal is batched instead: ``m`` copies of ``z`` go through
one forward pass, and one backward pass of the sum of the diagonal
``r_i(z_i)`` gives row ``i`` of J on copy ``i`` — the same VJPs with the
same unit cotangents, in two calls instead of ``m`` backward passes.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.precision import highest_precision

__all__ = ["adam_gauss_newton", "jacobian"]


def jacobian(fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor,
             n_out: int) -> torch.Tensor:
    """Exact reverse-mode ∂fn/∂z, (n_out, dim), of a row-separable
    ``fn: (B, dim) -> (B, n_out)`` at the point ``z (dim,)``.

    ``n_out`` copies of ``z`` are one batch; row ``i`` of J is the gradient
    of output ``i`` on copy ``i``.  A unit cotangent per row, as
    ``jax.jacrev``: no differences anywhere.
    """
    Z = z.detach().expand(n_out, z.shape[-1]).clone().requires_grad_(True)
    with torch.enable_grad():
        out = fn(Z)
        if not out.requires_grad:
            return torch.zeros_like(Z)
        (J,) = torch.autograd.grad(torch.diagonal(out).sum(), Z,
                                   allow_unused=True)
    return torch.zeros_like(Z) if J is None else J


def adam_gauss_newton(residuals_fn, z0, adam_steps: int = 400,
                      newton_steps: int = 6, learning_rate: float = 0.02
                      ) -> torch.Tensor:
    """Adam on Σ r² (``adam_steps``, gradients zeroed where not finite),
    then ``newton_steps`` Gauss-Newton steps on the exact Jacobian, each
    taken only if the loss does not rise.  Each Adam step is one forward
    and one backward pass at a batch of one; each Gauss-Newton step two
    forward passes and one :func:`jacobian`."""
    z = torch.as_tensor(z0).detach().clone()

    def loss(r, ok):
        return torch.where(ok, torch.sum(r * r, dim=-1),
                           torch.full_like(ok, torch.inf, dtype=r.dtype))

    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for i in range(adam_steps):
        zz = z.detach().requires_grad_(True)
        with torch.enable_grad():
            f = loss(*residuals_fn(zz))
            g = (torch.autograd.grad(f, zz, allow_unused=True)[0]
                 if f.requires_grad else None)
        g = torch.zeros_like(z) if g is None else g
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** (i + 1))
        vhat = v / (1 - 0.999 ** (i + 1))
        z = z - learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)

    with highest_precision():
        eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
        for _ in range(newton_steps):
            with torch.no_grad():
                r, _ = residuals_fn(z)
            J = jacobian(lambda Z: residuals_fn(Z)[0], z, r.shape[-1])
            H = J.mT @ J + 1e-12 * eye
            # a singular H gives a non-finite step (rejected), as in JAX
            step, info = torch.linalg.solve_ex(H, J.mT @ r)
            step = torch.where(info != 0, torch.full_like(step, torch.nan),
                               step)
            z_new = z - step
            with torch.no_grad():
                f_new = loss(*residuals_fn(z_new))
            better = torch.isfinite(f_new) & (f_new <= torch.sum(r * r))
            z = torch.where(better, z_new, z)
    return z
