"""Implicit-function differentiation of a batched root solve.

Mirrors ``geconpy_tpu/ops/implicit.py::implicit_root`` (:27-67) as a
``torch.autograd.Function``.  At the solution f(x*, θ) = 0,

    dx*/dθ = -(∂f/∂x)⁻¹ ∂f/∂θ,

so the backward pass solves one linear system per draw with the Jacobian at
x* and pulls the result back through f's θ-dependence; the solver's
iterations are never differentiated.  First order only.
"""

from __future__ import annotations

from typing import Callable

import torch

from .newton import batched_jacobian
from .precision import highest_precision

__all__ = ["implicit_root"]


class _ImplicitRoot(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, solver, single, box, x0, *theta):
        with torch.no_grad():
            x_star, aux = solver(x0, theta[0] if single else theta)
        if x_star is x0:
            x_star = x_star.clone()
        box.append(aux)
        ctx.f, ctx.single = f, single
        ctx.save_for_backward(x_star, *theta)
        return x_star

    @staticmethod
    @highest_precision()
    def backward(ctx, x_bar):
        x_star, *theta = ctx.saved_tensors
        f, single = ctx.f, ctx.single
        J = batched_jacobian(f, x_star, (theta[0] if single else tuple(theta),))
        # Jᵀ w = x̄ per draw; a singular J gives NaN in its own draw
        w, info = torch.linalg.solve_ex(J.mT, x_bar[..., None])
        w = torch.where((info == 0)[..., None, None], w,
                        torch.full_like(w, torch.nan))[..., 0]
        wanted = [i for i, t in enumerate(theta) if ctx.needs_input_grad[5 + i]]
        grads = [None] * len(theta)
        if wanted:
            with torch.enable_grad():
                th = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(theta)]
                out = f(x_star.detach(), th[0] if single else tuple(th))
                # θ̄ = -(∂f/∂θ)ᵀ w
                got = torch.autograd.grad(out, [th[i] for i in wanted],
                                          grad_outputs=-w, allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = torch.zeros_like(theta[i]) if g is None else g
        # x0's gradient is zero: a converged solve does not depend on it
        x0_bar = torch.zeros_like(x_star) if ctx.needs_input_grad[4] else None
        return (None, None, None, None, x0_bar, *grads)


def implicit_root(f: Callable, solver: Callable):
    """Wrap ``solver`` so its solution differentiates implicitly.

    ``f(x (B, m), theta) -> (B, m)``, square per draw, also callable on one
    draw's shapes (its Jacobian is ``vmap(jacfwd(f))``); ``theta`` is one
    tensor or a tuple of tensors, each with the leading batch dimension.
    ``solver(x0, theta) -> (x_star, aux)`` runs the iteration without
    recording a graph; ``aux`` (flags, norms, counters) is passed through
    with no gradient.  Returns ``solve(x0, theta) -> (x_star, aux)``,
    differentiable in ``theta``, with a zero gradient for ``x0``.
    """

    def solve(x0: torch.Tensor, theta):
        single = isinstance(theta, torch.Tensor)
        thetas = (theta,) if single else tuple(theta)
        box: list = []
        x_star = _ImplicitRoot.apply(f, solver, single, box, x0, *thetas)
        return x_star, box[0]

    return solve
