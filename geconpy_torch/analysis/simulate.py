"""Stochastic simulation and impulse responses, batched on the device.

Mirrors ``geconpy_tpu/analysis/simulate.py``: ``simulate_linear`` (:22),
``simulate`` (:50), ``impulse_response`` (:92) and
``impulse_response_function`` (:117).  The linear recursion
x_t = T x_{t-1} + R eps_t is one loop over the periods of a batched
product: every path of a batch, and every shock of an impulse response,
steps together.  The reference's labelled pandas results become tensors
with name lists (:class:`ImpulseResponses`, :class:`Simulations`), and its
JAX key an explicit ``torch.Generator`` on the solution's device.  The
second-order ``simulate_second_order`` (:161) and
``impulse_response_second_order`` (:211) run the pruned system of
:mod:`~geconpy_torch.models.second_order`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.precision import highest_precision

__all__ = ["simulate_linear", "impulse_response", "simulate",
           "impulse_response_function", "simulate_second_order",
           "impulse_response_second_order", "ImpulseResponses",
           "Simulations"]


class ImpulseResponses(NamedTuple):
    values: torch.Tensor      # (n_shocks, periods, n_variables)
    shocks: list[str]
    variables: list[str]


class Simulations(NamedTuple):
    values: torch.Tensor      # (n_simulations, periods, n_variables)
    variables: list[str]


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


@highest_precision()
def simulate_linear(T, R, shocks, x0=None) -> torch.Tensor:
    """Run  x_t = T x_{t-1} + R eps_t  over a shock path, on T's device.

    ``shocks`` is (periods, n_shocks) or (batch, periods, n_shocks); the
    result is (periods, n) or (batch, periods, n).  ``x0`` (n) or
    (batch, n) is x_{-1}, zero by default.
    """
    T = torch.as_tensor(T)
    R = _like(R, T)
    shocks = _like(shocks, T)
    n = T.shape[-1]
    batch = shocks.shape[:-2]
    x = T.new_zeros(batch + (n,)) if x0 is None \
        else _like(x0, T).expand(batch + (n,))
    # every period's shock term in one product
    impulse = shocks @ R.mT                          # (..., periods, n)
    out = torch.empty_like(impulse)
    Tt = T.mT
    for t in range(shocks.shape[-2]):
        x = x @ Tt + impulse[..., t, :]
        out[..., t, :] = x
    return out


def _shock_chol(n_shocks, names, shock_cov, shock_std, like):
    """Cholesky factor of the simulation's shock covariance: diagonal from
    ``shock_std`` (scalar, or a dict by name, 0.01 by default) unless a
    full ``shock_cov`` is given (``simulate.py:64-74``)."""
    if shock_cov is None:
        if shock_std is None:
            stds = [0.01] * n_shocks
        elif isinstance(shock_std, dict):
            stds = [float(shock_std.get(s, 0.01)) for s in names]
        else:
            stds = [float(shock_std)] * n_shocks
        return torch.diag(_like(stds, like))
    return _cholesky_nan(_like(shock_cov, like))


def _cholesky_nan(Q: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where Q is not positive definite (where
    ``jnp.linalg.cholesky`` gives NaN), never an exception."""
    L, info = torch.linalg.cholesky_ex(Q)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, torch.nan))


def simulate(solution, periods: int = 40, n_simulations: int = 100,
             shock_cov=None, shock_std: float | dict | None = None,
             generator: torch.Generator | None = None,
             seed: int = 0) -> Simulations:
    """Monte-Carlo simulation of a solved model (a ``PolicySolution``).

    The standard normal draws (n_simulations, periods, n_shocks) come from
    ``generator``, which must be on the solution's device; without one, a
    generator there seeded with ``seed`` is used.  Returns the paths
    (n_simulations, periods, n) with the variable names.
    """
    T, R = solution.T, solution.R
    chol = _shock_chol(R.shape[-1], solution.shocks, shock_cov, shock_std, T)
    if generator is None:
        generator = torch.Generator(device=T.device).manual_seed(int(seed))
    draws = torch.randn((n_simulations, periods, R.shape[-1]),
                        generator=generator, dtype=T.dtype, device=T.device)
    paths = simulate_linear(T, R, draws @ chol.mT)
    return Simulations(paths, list(solution.variables))


def impulse_response(T, R, periods: int = 40, shock_size=1.0,
                     shock_trajectory=None) -> torch.Tensor:
    """IRFs for every shock: (n_shocks, periods, n_variables).

    ``shock_size`` is a scalar or (n_shocks,); or pass an explicit
    ``shock_trajectory`` (periods, n_shocks), applied jointly, for one
    path (periods, n_variables).
    """
    T = torch.as_tensor(T)
    R = _like(R, T)
    if shock_trajectory is not None:
        return simulate_linear(T, R, shock_trajectory)
    k = R.shape[-1]
    sizes = torch.broadcast_to(_like(shock_size, T), (k,))
    eps = T.new_zeros((k, periods, k))
    eps[:, 0, :] = torch.diag(sizes)
    return simulate_linear(T, R, eps)


def impulse_response_function(solution, periods: int = 40,
                              shock_size: float | dict = 1.0,
                              orthogonalize: bool = False,
                              shock_cov=None) -> ImpulseResponses:
    """IRFs of a solved model with the shock and variable names.

    ``shock_size`` is a scalar or a dict by shock name (1.0 for a shock it
    leaves out).  With ``orthogonalize=True`` and a ``shock_cov``, the
    impulses are the Cholesky columns (one-standard-deviation
    orthogonalized shocks).
    """
    T, R = solution.T, solution.R
    names = list(solution.shocks)
    if orthogonalize:
        if shock_cov is None:
            raise ValueError("orthogonalize=True requires shock_cov")
        chol = _cholesky_nan(_like(shock_cov, T))
        eps = T.new_zeros((len(names), periods, len(names)))
        eps[:, 0, :] = chol.mT
        values = simulate_linear(T, R, eps)
    else:
        if isinstance(shock_size, dict):
            sizes = [float(shock_size.get(s, 1.0)) for s in names]
        else:
            sizes = shock_size
        values = impulse_response(T, R, periods, sizes)
    return ImpulseResponses(values, names, list(solution.variables))


def simulate_second_order(solution, second_order, periods: int = 40,
                          n_simulations: int = 100,
                          shock_std: float | dict | None = None,
                          shock_cov=None,
                          generator: torch.Generator | None = None,
                          seed: int = 0) -> Simulations:
    """Monte-Carlo simulation of the pruned second-order solution
    (``simulate.py:161``): ``second_order`` is the ``SecondOrderResult`` of
    ``Model.solve_model_second_order``.  The shock rules and the draws are
    :func:`simulate`'s; the paths (n_simulations, periods, n) are in hat
    coordinates with the uncertainty correction, so their means sit at
    the stochastic steady state."""
    from ..models.second_order import simulate_pruned

    T, R = solution.T, solution.R
    chol = _shock_chol(R.shape[-1], solution.shocks, shock_cov, shock_std, T)
    if generator is None:
        generator = torch.Generator(device=T.device).manual_seed(int(seed))
    draws = torch.randn((n_simulations, periods, R.shape[-1]),
                        generator=generator, dtype=T.dtype, device=T.device)
    paths = simulate_pruned(T, R, second_order, draws @ chol.mT)
    return Simulations(paths, list(solution.variables))


def impulse_response_second_order(solution, second_order, periods: int = 40,
                                  shock_size: float | dict = 1.0
                                  ) -> ImpulseResponses:
    """Second-order IRFs of every shock (``simulate.py:211``): the pruned
    path with the impulse less the path without it, sign- and
    size-dependent.  ``shock_size`` is a scalar or a dict by shock name
    (1.0 for a shock it leaves out); values (n_shocks, periods, n)."""
    from ..models.second_order import irf_second_order

    T, R = solution.T, solution.R
    names = list(solution.shocks)
    if isinstance(shock_size, dict):
        sizes = [float(shock_size.get(s, 1.0)) for s in names]
    else:
        sizes = [float(shock_size)] * len(names)
    values = irf_second_order(T, R, second_order,
                              torch.diag(_like(sizes, T)), periods)
    return ImpulseResponses(values, names, list(solution.variables))
