"""Posterior analysis over MCMC draws: IRF, autocorrelation, FEVD and
predictive bands, solver diagnostics, smoothed states, the historical
shock decomposition, and the mixed-frequency data grid.

Mirrors ``geconpy_tpu/stats/posterior.py``: ``_flat_draws`` (:37),
``posterior_irfs`` (:46), ``posterior_autocorrelation`` (:88),
``posterior_fevd`` (:112), ``posterior_smoothed_states`` (:129),
``historical_shock_decomposition`` (:156), ``posterior_predictive``
(:223), ``posterior_girfs`` (:271, on the second-order solution of
:mod:`.nonlinear`), ``posterior_diagnostics`` (:317) and
``prepare_mixed_frequency_data`` (:342, arrays only).  The reference
``vmap``s a per-draw solve and scan over the draws; here the solution, the
scans and the smoother run once, batched over the draws.  Where the
reference returns a DataFrame, these return tensors with name lists (the
port imports no pandas); quantiles are ``torch.quantile``'s linear
interpolation, ``np.quantile``'s default.  Random draws come from a
``torch.Generator`` on the state space's device, where the reference
splits a JAX key.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis.simulate import _cholesky_nan
from ..ops.kalman import disturbance_smoother, kalman_smoother
from ..ops.precision import highest_precision
from .covariance import autocorrelation as _acf
from .covariance import fevd as _fevd
from .estimation import PosteriorResult
from .statespace import DSGEStateSpace

__all__ = ["Bands", "ShareTable", "PosteriorDiagnostics", "SmoothedStateBands",
           "ShockDecomposition", "posterior_irfs",
           "posterior_autocorrelation", "posterior_fevd",
           "posterior_smoothed_states", "posterior_diagnostics",
           "posterior_predictive", "posterior_girfs",
           "historical_shock_decomposition", "prepare_mixed_frequency_data"]


class Bands(NamedTuple):
    """The mean and quantiles over draws of a labelled array: the
    reference's frame whose index levels are ``dims`` (with ``labels``) and
    whose columns are ``mean`` and ``q<level>`` for each level."""

    mean: torch.Tensor              # one axis per dim
    quantiles: torch.Tensor         # (len(levels),) + mean.shape
    levels: tuple                   # the quantile levels
    dims: tuple                     # the axis names, e.g. ("shock", ...)
    labels: tuple                   # per axis: its names, or a range


class ShareTable(NamedTuple):
    """A (variable x shock) table, the reference's frame with the variable
    names as its index and the shock names as its columns."""

    values: torch.Tensor            # (n_variables, n_shocks)
    variable_names: list[str]
    shock_names: list[str]


class PosteriorDiagnostics(NamedTuple):
    """Per-draw solver diagnostics: the reference's frame, one column each."""

    ss_success: torch.Tensor
    solver_success: torch.Tensor
    stable: torch.Tensor
    deterministic_norm: torch.Tensor
    stochastic_norm: torch.Tensor
    spectral_radius: torch.Tensor


def _quantiles(x: torch.Tensor, levels) -> torch.Tensor:
    """``np.quantile(x, levels, axis=0)`` (linear interpolation, NaN
    propagating): (len(levels),) + x.shape[1:].  ``torch.quantile`` takes
    at most 2**24 elements a call, so the columns go in chunks."""
    q = torch.as_tensor(levels, dtype=x.dtype, device=x.device)
    flat = x.reshape(x.shape[0], -1)
    step = max(1, (1 << 24) // max(1, flat.shape[0]) - 1)
    parts = [torch.quantile(flat[:, i:i + step], q, dim=0)
             for i in range(0, flat.shape[1], step)]
    return torch.cat(parts, dim=1).reshape((len(q),) + x.shape[1:])


def _bands(x: torch.Tensor, levels, dims, labels) -> Bands:
    """Bands over the leading (draw) axis of ``x``."""
    return Bands(x.mean(dim=0), _quantiles(x, levels), tuple(levels),
                 tuple(dims), tuple(labels))


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


def _solve(ss_mod, result, max_draws, full_state: bool = False) -> dict:
    """The solution of every retained draw, batched over the draws."""
    return ss_mod.build_solution_fn(full_state=full_state)(
        _flat_draws(ss_mod, result, max_draws))


def _irf_paths(T, R, Q, periods: int) -> torch.Tensor:
    """One-standard-deviation impulse responses of every shock, batched:
    (..., n_shocks, n_variables, periods), the first period the impact."""
    sd = torch.sqrt(torch.diagonal(Q, dim1=-2, dim2=-1))
    x = (R * sd[..., None, :]).mT            # row j: the impact of shock j
    paths = []
    for _ in range(periods):
        paths.append(x)
        x = x @ T.mT
    return torch.stack(paths, dim=-1)


@torch.no_grad()
def posterior_irfs(ss_mod: DSGEStateSpace, result: PosteriorResult,
                   periods: int = 40, max_draws: int | None = 500,
                   quantiles=(0.05, 0.5, 0.95)) -> Bands:
    """IRF posterior bands over the draws: one-standard-deviation impulses
    of every shock, ``dims`` (shock, variable, time)."""
    mf = ss_mod.model.functions
    sol = _solve(ss_mod, result, max_draws)
    with highest_precision():
        irfs = _irf_paths(sol["T"], sol["R"], sol["Q"], periods)
    return _bands(irfs, quantiles, ("shock", "variable", "time"),
                  (list(mf.shock_names), list(mf.variable_names),
                   range(periods)))


@torch.no_grad()
def posterior_autocorrelation(ss_mod: DSGEStateSpace, result: PosteriorResult,
                              n_lags: int = 10, max_draws: int | None = 500,
                              quantiles=(0.05, 0.5, 0.95)) -> Bands:
    """Posterior ACF bands per variable (the diagonal of the
    autocorrelation matrices), ``dims`` (lag, variable)."""
    mf = ss_mod.model.functions
    sol = _solve(ss_mod, result, max_draws)
    acf = _acf(sol["T"], sol["R"], sol["Q"], n_lags)
    return _bands(torch.diagonal(acf, dim1=-2, dim2=-1), quantiles,
                  ("lag", "variable"), (range(n_lags),
                                        list(mf.variable_names)))


@torch.no_grad()
def posterior_fevd(ss_mod: DSGEStateSpace, result: PosteriorResult,
                   horizon: int = 40, max_draws: int | None = 500
                   ) -> ShareTable:
    """Posterior-mean forecast-error variance decomposition at
    ``horizon``."""
    mf = ss_mod.model.functions
    sol = _solve(ss_mod, result, max_draws)
    shares = _fevd(sol["T"], sol["R"], sol["Q"], horizon)[..., -1, :, :]
    return ShareTable(shares.mean(dim=0), list(mf.variable_names),
                      list(mf.shock_names))


@torch.no_grad()
def posterior_diagnostics(ss_mod: DSGEStateSpace, result: PosteriorResult,
                          max_draws: int | None = 1000
                          ) -> PosteriorDiagnostics:
    """Per-draw solver diagnostics over the posterior: the success flags,
    the residual norms and the spectral radius of each draw."""
    sol = _solve(ss_mod, result, max_draws)
    return PosteriorDiagnostics(*(sol[k] for k in PosteriorDiagnostics._fields))


@highest_precision()
def _predictive_paths(sol: dict, eps_std: torch.Tensor,
                      eta_std: torch.Tensor) -> torch.Tensor:
    """Observables simulated from a zero state, batched over the draws:
    ``eps_std`` (D, periods, n_shocks) and ``eta_std`` (D, periods, k)
    standard normals become the shocks ``eps_std Lᵀ`` (L the Cholesky
    factor of Q) and the measurement errors ``eta_std sqrt(diag H)``;
    returns (D, periods, k)."""
    T, R, Q, Z, H, d = (sol[k] for k in ("T_aug", "R_aug", "Q", "Z", "H",
                                          "d"))
    eps = eps_std @ _cholesky_nan(Q).mT
    eta = eta_std * torch.sqrt(torch.diagonal(H, dim1=-2,
                                              dim2=-1))[..., None, :]
    x = T.new_zeros(T.shape[:-1])
    ys = []
    for t in range(eps.shape[-2]):
        x = (T @ x[..., None])[..., 0] + (R @ eps[..., t, :, None])[..., 0]
        ys.append((Z @ x[..., None])[..., 0] + d + eta[..., t, :])
    return torch.stack(ys, dim=-2)


@torch.no_grad()
def posterior_predictive(ss_mod: DSGEStateSpace, result: PosteriorResult,
                         generator: torch.Generator, periods: int = 100,
                         max_draws: int | None = 200,
                         quantiles=(0.05, 0.5, 0.95)) -> Bands:
    """Posterior predictive datasets: one simulated sample of the
    observables per retained draw, with fresh shocks and measurement
    errors from ``generator`` (on the state space's device: all the
    shocks' standard normals, then all the measurement errors'), as
    quantile bands, ``dims`` (variable, time).  Compare them with the
    estimation data for predictive checks."""
    ss_mod._check_generator(generator)
    sol = _solve(ss_mod, result, max_draws)
    n_draws, n_shocks = sol["Q"].shape[0], sol["Q"].shape[-1]
    k = len(ss_mod.observed_states)
    kw = dict(generator=generator, dtype=sol["T"].dtype,
              device=sol["T"].device)
    eps_std = torch.randn((n_draws, periods, n_shocks), **kw)
    eta_std = torch.randn((n_draws, periods, k), **kw)
    ys = _predictive_paths(sol, eps_std, eta_std)
    return _bands(ys.mT, quantiles, ("variable", "time"),
                  (list(ss_mod.observed_states), range(periods)))


def _girf_paths(sol: dict, j: int, shock_size: float | None,
                normals: torch.Tensor) -> torch.Tensor:
    """Each draw's generalized IRF of shock ``j`` (D, periods, n) on the
    standard normals ``normals`` (D, n_mc, periods, n_shocks); the impulse
    is ``shock_size`` or one standard deviation of the shock."""
    from ..models.second_order import SecondOrderResult, _girf_from_normals

    Q = sol["Q"]
    res2 = SecondOrderResult(sol["G_xx"], sol["G_xu"], sol["G_uu"],
                             sol["g_ss"], sol["so_success"])
    size = torch.sqrt(Q[..., j, j]) if shock_size is None \
        else torch.full_like(Q[..., j, j], float(shock_size))
    vec = Q.new_zeros(Q.shape[:-1])
    vec[..., j] = size
    return _girf_from_normals(sol["T"], sol["R"], res2, vec, Q, normals)


@torch.no_grad()
def posterior_girfs(ss_mod: DSGEStateSpace, result: PosteriorResult,
                    shock: str, generator: torch.Generator | None = None,
                    shock_size: float | None = None, periods: int = 40,
                    n_mc: int = 128, max_draws: int | None = 100,
                    quantiles=(0.05, 0.5, 0.95)) -> Bands:
    """Second-order generalized IRF posterior bands: one batched
    second-order solve over the retained draws, then each draw's
    Koop-Pesaran-Potter GIRF of ``shock`` over ``n_mc`` shock paths
    (``models/second_order.py::generalized_irf``), ``dims`` (variable,
    time).  ``shock_size`` defaults to one standard deviation of the shock
    at each draw.  The standard normals (draws, n_mc, periods, n_shocks)
    come from ``generator`` (on the state space's device; without one, a
    generator there seeded with 0)."""
    from .nonlinear import _solution_fn

    mf = ss_mod.model.functions
    j = mf.shock_names.index(shock)
    device = ss_mod._device()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ss_mod._check_generator(generator)
    sol = _solution_fn(ss_mod)(_flat_draws(ss_mod, result, max_draws))
    normals = torch.randn((sol["T"].shape[0], n_mc, periods, mf.n_shocks),
                          generator=generator, dtype=sol["T"].dtype,
                          device=device)
    girfs = _girf_paths(sol, j, shock_size, normals)
    return _bands(girfs.mT, quantiles, ("variable", "time"),
                  (list(mf.variable_names), range(periods)))


def _solve_draws(ss_mod, result, data, max_draws):
    """The full-state solution of every retained draw and the data on the
    state space's device."""
    sol = _solve(ss_mod, result, max_draws, full_state=True)
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
