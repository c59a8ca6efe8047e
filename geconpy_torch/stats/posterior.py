"""Posterior analysis over MCMC draws: smoothed states, the historical shock
decomposition, and the mixed-frequency data grid.

Mirrors a subset of ``geconpy_tpu/stats/posterior.py``: ``_flat_draws``
(:37), ``posterior_smoothed_states`` (:129-153),
``historical_shock_decomposition`` (:156-220) and
``prepare_mixed_frequency_data`` (:342-363, arrays only).  The reference
``vmap``s a per-draw solve and smoother over the draws; here the solution
and the smoother run once, batched over the draws.  Where the reference
returns a DataFrame, these return tensors with name lists (the port
imports no pandas); quantiles are ``torch.quantile``'s linear
interpolation, ``np.quantile``'s default.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.kalman import disturbance_smoother, kalman_smoother
from .estimation import PosteriorResult
from .statespace import DSGEStateSpace

__all__ = ["SmoothedStateBands", "ShockDecomposition",
           "posterior_smoothed_states", "historical_shock_decomposition",
           "prepare_mixed_frequency_data"]


class SmoothedStateBands(NamedTuple):
    """What :func:`posterior_smoothed_states` returns (the reference's
    frame indexed by (time, variable), one column per statistic)."""

    mean: torch.Tensor              # (periods, n_variables)
    quantiles: torch.Tensor         # (len(levels), periods, n_variables)
    levels: tuple                   # the quantile levels
    variable_names: list[str]


class ShockDecomposition(NamedTuple):
    """What :func:`historical_shock_decomposition` returns: the mean over
    draws of each shock's contribution, of the initial condition's and of
    the smoothed states (the reference's frame indexed by (time, variable),
    one column per shock, then ``initial`` and ``smoothed``)."""

    contributions: torch.Tensor     # (n_shocks, periods, n_variables)
    initial: torch.Tensor           # (periods, n_variables)
    smoothed: torch.Tensor          # (periods, n_variables)
    shock_names: list[str]
    variable_names: list[str]


def _flat_draws(ss_mod: DSGEStateSpace, result: PosteriorResult,
                max_draws: int | None, seed: int = 0) -> torch.Tensor:
    """The unconstrained draws pooled over chains (at most ``max_draws``,
    picked without replacement by numpy's generator from ``seed``, as the
    reference does), as float64 on the state space's device."""
    u = np.asarray(result.unconstrained)
    u = u.reshape(-1, u.shape[-1])
    if max_draws is not None and len(u) > max_draws:
        idx = np.random.default_rng(seed).choice(len(u), max_draws,
                                                 replace=False)
        u = u[idx]
    return torch.as_tensor(u, dtype=torch.float64, device=ss_mod._device())


def _solve_draws(ss_mod, result, data, max_draws):
    sol = ss_mod.build_solution_fn(full_state=True)(
        _flat_draws(ss_mod, result, max_draws))
    y = torch.as_tensor(np.asarray(data, dtype=np.float64),
                        device=ss_mod._device())
    return sol, y


@torch.no_grad()
def posterior_smoothed_states(ss_mod: DSGEStateSpace, result: PosteriorResult,
                              data: np.ndarray, max_draws: int | None = 200,
                              quantiles=(0.05, 0.5, 0.95)
                              ) -> SmoothedStateBands:
    """Smoothed state paths over posterior draws (the RTS smoother, batched
    over the draws): their mean and quantiles at each period."""
    sol, y = _solve_draws(ss_mod, result, data, max_draws)
    n = ss_mod.model.functions.n_variables
    sm = kalman_smoother(y, sol["T_aug"], sol["R_aug"], sol["Q"], sol["Z"],
                         sol["H"], d=sol["d"])
    paths = sm.smoothed_mean[..., :n]          # (draws, periods, n)
    q = torch.as_tensor(quantiles, dtype=paths.dtype, device=paths.device)
    return SmoothedStateBands(paths.mean(dim=0), torch.quantile(paths, q,
                                                               dim=0),
                              tuple(quantiles),
                              list(ss_mod.model.functions.variable_names))


@torch.no_grad()
def historical_shock_decomposition(ss_mod: DSGEStateSpace,
                                   result: PosteriorResult,
                                   data: np.ndarray,
                                   max_draws: int | None = 200
                                   ) -> ShockDecomposition:
    """Historical decomposition: per draw, the disturbance smoother's
    shocks e_t (with x_t = T x_{t-1} + R e_t exactly) are replayed through
    the transition one shock at a time from a zero state; the initial
    condition is what the shocks leave of the smoothed states, so the
    parts sum to them exactly.  Averaged over draws."""
    sol, y = _solve_draws(ss_mod, result, data, max_draws)
    mf = ss_mod.model.functions
    n = mf.n_variables
    T, R = sol["T_aug"], sol["R_aug"]
    dsm = disturbance_smoother(y, T, R, sol["Q"], sol["Z"], sol["H"],
                               d=sol["d"])
    eps, x_s = dsm.shocks, dsm.smoothed_mean    # (D, t, k), (D, t, n_aug)
    # every shock's replay at once: row j of x (D, k, n_aug) is the state
    # driven by shock j alone, through column j of R
    x = torch.zeros(T.shape[:-2] + (R.shape[-1], T.shape[-1]),
                    dtype=T.dtype, device=T.device)
    paths = []
    for t in range(eps.shape[-2]):
        x = x @ T.mT + eps[..., t, :, None] * R.mT
        paths.append(x)
    contribs = torch.stack(paths, dim=-2)       # (D, k, t, n_aug)
    initial = x_s - contribs.sum(dim=-3)
    return ShockDecomposition(contribs[..., :n].mean(dim=0),
                              initial[..., :n].mean(dim=0),
                              x_s[..., :n].mean(dim=0),
                              list(mf.shock_names), list(mf.variable_names))


def prepare_mixed_frequency_data(low_freq: np.ndarray, period: int,
                                 offset: int | None = None,
                                 n_high_freq: int | None = None
                                 ) -> np.ndarray:
    """Expand low-frequency observations (n_low,) or (n_low, k) to a
    NaN-padded high-frequency grid: each value at sub-period ``offset``
    (default ``period - 1``, the end of its period) of its period, NaN
    elsewhere, ``n_high_freq`` rows (default ``n_low * period``); pair it
    with an ``aggregate`` observation equation and the stationary filter.
    """
    arr = np.asarray(low_freq, dtype=float)
    if arr.ndim == 1:
        arr = arr[:, None]
    n_low, k = arr.shape
    offset = period - 1 if offset is None else offset
    total = n_high_freq if n_high_freq is not None else n_low * period
    out = np.full((total, k), np.nan)
    rows = offset + period * np.arange(n_low)
    rows = rows[rows < total]
    out[rows] = arr[:len(rows)]
    return out
