"""Posterior mode search over a batched value+gradient.

Mirrors ``geconpy_tpu/stats/model_comparison.py``: ``find_map`` (:98),
Adam to the basin then Newton, and of ``neg_hessian_fn`` (:37) its
central-difference branch (``fd_hessian``, :80-88).  The reference takes
that branch on the stationary filter too: forward mode through the DARE
adjoint's ``stop_gradient`` is rejected or zeroed (its docstring,
:41-71), so the exact forward-over-reverse Hessian is not ported.  The
Laplace and harmonic-mean evidence estimators of that module are not
ported yet.

Both functions take a batched ``value_and_grad(U (B, dim)) -> (logpost
(B,), grad (B, dim))`` (``DSGEStateSpace.build_batched_logpost_and_grad``)
and run in the start point's dtype and on its device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.precision import highest_precision

__all__ = ["find_map", "neg_hessian_fn"]

ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def neg_hessian_fn(value_and_grad: ValueAndGrad):
    """``u -> Hessian of -logpost`` by central differences of the exact
    gradient: the 2 x dim shifted draws go in ONE batched call, steps
    ``eps^(1/3) max(1, |u_i|)``, and the result is symmetrised."""

    def fd_hessian(u: torch.Tensor) -> torch.Tensor:
        eps = torch.finfo(u.dtype).eps
        h = eps ** (1.0 / 3.0) * torch.clamp(torch.abs(u), min=1.0)
        E = torch.eye(u.shape[0], dtype=u.dtype, device=u.device) * h[:, None]
        _, g = value_and_grad(torch.cat([u + E, u - E]))
        g_plus, g_minus = -g[:u.shape[0]], -g[u.shape[0]:]
        H = (g_plus - g_minus) / (2.0 * h[:, None])
        return 0.5 * (H + H.T)

    return fd_hessian


def find_map(value_and_grad: ValueAndGrad, u0: torch.Tensor,
             adam_steps: int = 500, newton_steps: int = 5,
             learning_rate: float = 0.02) -> torch.Tensor:
    """Posterior mode in unconstrained space: Adam to the basin, Newton to
    machine precision.  Newton steps that are non-finite or do not improve
    the log posterior (an indefinite Hessian far from the mode) are
    rejected.  Each Adam step is one value+grad call at a batch of one;
    each Newton step two, and one of 2 x dim draws for the Hessian."""
    u0 = torch.as_tensor(u0)

    def neg(u):
        vals, grads = value_and_grad(u[None])
        return -vals[0], -grads[0]

    neg_hess = neg_hessian_fn(value_and_grad)

    u = u0.clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    for i in range(adam_steps):
        _, g = neg(u)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** (i + 1))
        vhat = v / (1 - 0.999 ** (i + 1))
        u = u - learning_rate * mhat / (torch.sqrt(vhat) + 1e-8)

    with highest_precision():
        for _ in range(newton_steps):
            f, g = neg(u)
            H = neg_hess(u)
            # a singular H gives a non-finite step (rejected), as in JAX,
            # not an exception
            delta, info = torch.linalg.solve_ex(H, g)
            delta = torch.where(info != 0, torch.full_like(delta, torch.nan),
                                delta)
            u_new = u - delta
            f_new, _ = neg(u_new)
            better = (torch.isfinite(f_new) & (f_new <= f)
                      & torch.all(torch.isfinite(u_new)))
            u = torch.where(better, u_new, u)
    return u
