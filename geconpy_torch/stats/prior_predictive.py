"""Prior predictive sweeps: IRFs, FEVD and moments over prior draws.

Mirrors ``geconpy_tpu/stats/prior_predictive.py``
(``prior_predictive_sweep`` :24): for every prior draw, solve the model
and compute its IRFs, FEVD and stationary standard deviations, batched
over the draws on the state space's device (the reference ``vmap``s a
per-draw function, optionally sharded over a mesh; here ``mesh`` splits
the batched solve over its devices).  The prior draws come from a
``torch.Generator``, parameter by parameter (the reference splits a JAX
key).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lyapunov import solve_discrete_lyapunov
from ..ops.precision import highest_precision
from .covariance import fevd as _fevd
from .posterior import Bands, ShareTable, _bands, _irf_paths
from .statespace import DSGEStateSpace

__all__ = ["PriorPredictive", "prior_predictive_sweep"]


class PriorPredictive(NamedTuple):
    """What :func:`prior_predictive_sweep` returns (the reference's dict):
    bands and means over the draws whose model solved."""

    irf: Bands                      # dims (shock, variable, time)
    fevd: ShareTable                # mean FEVD shares at the horizon
    std: Bands                      # stationary sds, dims (variable,)
    success_rate: float             # share of solvable draws


@torch.no_grad()
def _sweep_core(ss_mod: DSGEStateSpace, U: torch.Tensor, periods: int,
                fevd_horizon: int, quantiles, mesh=None) -> PriorPredictive:
    """The sweep over the unconstrained draws ``U`` (N, n_estimated), the
    solve split over ``mesh`` when one is given."""
    mf = ss_mod.model.functions
    if mesh is None:
        sol = ss_mod.build_solution_fn()(U)
    else:
        from ..parallel.mesh import sharded_prior_sweep

        sol = sharded_prior_sweep(
            ss_mod._built_on_mesh(mesh, lambda ss: ss.build_solution_fn()),
            U, mesh, mesh.axis_name)
    T, R, Q = sol["T"], sol["R"], sol["Q"]
    ok = sol["ss_success"] & sol["solver_success"] & sol["stable"]
    with highest_precision():
        irfs = _irf_paths(T, R, Q, periods)      # (N, shocks, n, periods)
        shares = _fevd(T, R, Q, fevd_horizon)[..., -1, :, :]
        T_safe = torch.where(ok[:, None, None], T, torch.zeros_like(T))
        Sigma = solve_discrete_lyapunov(T_safe, R @ Q @ R.mT)
    stds = torch.sqrt(torch.clamp(torch.diagonal(Sigma, dim1=-2, dim2=-1),
                                  min=0.0))
    variables, shocks = list(mf.variable_names), list(mf.shock_names)
    return PriorPredictive(
        _bands(irfs[ok], quantiles, ("shock", "variable", "time"),
               (shocks, variables, range(periods))),
        ShareTable(shares[ok].mean(dim=0), variables, shocks),
        _bands(stds[ok], quantiles, ("variable",), (variables,)),
        float(ok.double().mean()))


def prior_predictive_sweep(
    ss_mod: DSGEStateSpace,
    n_draws: int = 1000,
    periods: int = 40,
    fevd_horizon: int = 20,
    seed: int = 0,
    mesh=None,
    quantiles=(0.05, 0.5, 0.95),
) -> PriorPredictive:
    """Sweep the priors: per-draw solve -> IRFs, FEVD, stationary sd.

    The draws come from each estimated parameter's prior in turn, from a
    ``torch.Generator`` on the state space's device seeded with ``seed``,
    mapped to the unconstrained space.  Returns the IRF
    bands over the solvable draws, their mean FEVD shares at
    ``fevd_horizon``, the bands of their stationary standard deviations
    and the share of solvable draws.  ``mesh`` (whose first device is the
    state space's) splits the solve over its devices.
    """
    generator = torch.Generator(device=ss_mod._device()).manual_seed(seed)
    return _sweep_core(ss_mod, _prior_draws(ss_mod, n_draws, generator),
                       periods, fevd_horizon, quantiles, mesh)


def _prior_draws(ss_mod: DSGEStateSpace, n_draws: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_draws, n_estimated) unconstrained prior draws, parameter by
    parameter from ``generator`` (on the state space's device)."""
    ss_mod._check_generator(generator)
    return torch.stack([p.prior.to_unconstrained(p.prior.sample(
        generator, (n_draws,))) for p in ss_mod.estimated], dim=1)
