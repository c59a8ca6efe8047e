"""Out-of-sample forecasting: posterior fan charts and conditional paths.

Mirrors ``geconpy_tpu/stats/forecast.py``: ``_quantile_frame`` (:35, here
:func:`~geconpy_torch.stats.posterior._bands`), ``posterior_forecast``
(:47), ``_conditional_core`` (:111) and ``conditional_forecast`` (:164).
Per posterior draw, one Kalman filter pass to the end of the sample, then
recursions over the forecast horizon; the reference ``vmap``s them over
the draws, here they run once, batched over the draws.  The filter keeps
only its last state and covariance (the reference stacks every period's).

- :func:`posterior_forecast`: unconditional fan charts (parameter,
  terminal-state, future-shock and measurement-error uncertainty) as
  quantile bands per observable.
- :func:`conditional_forecast`: Waggoner-Zha hard conditioning, the
  Q-weighted least-norm structural-shock paths that make chosen
  observables follow chosen paths, with the implied forecasts of every
  observable and the implied shocks.

Random draws come from a ``torch.Generator`` on the state space's device
(the reference splits a JAX key made from ``seed``).  The terminal
covariance's square root comes from ``torch.linalg.eigh``, whose
eigenvector signs may differ from JAX's: the factor L0 is the reference's
only up to those signs, L0 L0ᵀ = P_T is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.simulate import _cholesky_nan
from ..ops.kalman import _filter_steps
from ..ops.precision import highest_precision
from .posterior import Bands, _bands, _solve
from .statespace import DSGEStateSpace

__all__ = ["posterior_forecast", "conditional_forecast"]


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product M x."""
    return (M @ x[..., None])[..., 0]


@highest_precision()
def _terminal_state(ss_mod: DSGEStateSpace, sol: dict, data):
    """The filtered mean (D, n) and covariance (D, n, n) at the last period
    of ``data``, from the full-state solution of D draws."""
    y = torch.as_tensor(np.asarray(data, dtype=np.float64),
                        device=ss_mod._device())
    for x, P, *_ in _filter_steps(y, sol["T_aug"], sol["R_aug"], sol["Q"],
                                  sol["Z"], sol["H"], sol["d"], None, None):
        pass
    return x, P


def _forecast_frame(paths: torch.Tensor, names, horizon: int, quantiles
                    ) -> Bands:
    """(draws, horizon, k) -> bands with ``dims`` (variable, time 1..H)."""
    return _bands(paths.mT, quantiles, ("variable", "time"),
                  (list(names), range(1, horizon + 1)))


@highest_precision()
def _forecast_paths(sol: dict, x0, eps_std, eta_std,
                    include_measurement_error: bool) -> torch.Tensor:
    """Observable paths from the starting states ``x0`` (D, P, n) under the
    standard normals ``eps_std`` (D, P, H, n_shocks) and ``eta_std`` (D, P,
    H, k): the shocks are L_Q eps (L_Q the Cholesky factor of Q + 1e-30 I)
    and the measurement errors sqrt(diag H) eta.  Returns (D, P, H, k)."""
    T, R, Q, Z, H, d = (sol[k][:, None] for k in ("T_aug", "R_aug", "Q", "Z",
                                                   "H", "d"))
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    Lq = _cholesky_nan(Q + 1e-30 * eye)
    sd_me = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                   min=0.0))
    x, ys = x0, []
    for h in range(eps_std.shape[-2]):
        x = _mv(T, x) + _mv(R, _mv(Lq, eps_std[..., h, :]))
        y = _mv(Z, x) + d
        if include_measurement_error:
            y = y + sd_me * eta_std[..., h, :]
        ys.append(y)
    return torch.stack(ys, dim=-2)


@torch.no_grad()
def posterior_forecast(
    ss_mod: DSGEStateSpace,
    result,
    data: np.ndarray,
    horizon: int = 12,
    max_draws: int | None = 500,
    n_paths_per_draw: int = 4,
    include_measurement_error: bool = True,
    quantiles=(0.05, 0.16, 0.5, 0.84, 0.95),
    seed: int = 0,
) -> Bands:
    """Fan-chart forecast of the observables after the end of ``data``.

    Per posterior draw: filter the sample to the terminal state
    distribution N(x_T|T, P_T|T), then simulate ``n_paths_per_draw``
    forward paths with terminal-state, structural-shock and (optionally)
    measurement-error uncertainty.  The standard normals come from a
    ``torch.Generator`` on the state space's device seeded with ``seed``:
    every path's starting state, then every path's shocks,
    then every path's measurement errors.  Returns the mean and quantile
    bands, ``dims`` (variable, time 1..horizon).
    """
    generator = torch.Generator(device=ss_mod._device()).manual_seed(seed)
    sol = _solve(ss_mod, result, max_draws, full_state=True)
    xT, PT = _terminal_state(ss_mod, sol, data)
    with highest_precision():
        # the PSD square root of the terminal covariance (a filtered
        # covariance can be numerically semidefinite: eigh is robust where
        # cholesky is not)
        w, V = torch.linalg.eigh(PT)
        L0 = V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]
    n_draws, n = xT.shape
    n_shocks, k = sol["Q"].shape[-1], sol["Z"].shape[-2]
    kw = dict(generator=generator, dtype=xT.dtype, device=xT.device)
    z0 = torch.randn((n_draws, n_paths_per_draw, n), **kw)
    eps = torch.randn((n_draws, n_paths_per_draw, horizon, n_shocks), **kw)
    eta = torch.randn((n_draws, n_paths_per_draw, horizon, k), **kw)
    x0 = xT[:, None] + _mv(L0[:, None], z0)
    paths = _forecast_paths(sol, x0, eps, eta, include_measurement_error)
    return _forecast_frame(paths.reshape(-1, horizon, k),
                           ss_mod.observed_states, horizon, quantiles)


@highest_precision()
def _conditional_core(T, R, Q, Z, d, xT, target, mask, horizon: int):
    """Q-weighted least-norm shocks hitting the masked targets exactly,
    batched over the leading dimensions of the system.

    target/mask: (horizon, k_obs) with mask True where conditioned.
    Returns (ys, eps, baseline): the observable paths (..., H, k), the
    implied structural shocks (..., H, n_shocks) and the paths without
    shocks (..., H, k).
    """
    k_obs, n_shocks = Z.shape[-2], Q.shape[-1]
    x, baseline = xT, []
    for _ in range(horizon):
        x = _mv(T, x)
        baseline.append(_mv(Z, x) + d)
    baseline = torch.stack(baseline, dim=-2)

    # Psi_j = Z T^j R  (impact of a time-s shock on time-(s+j) observables)
    P, Psi = R, []
    for _ in range(horizon):
        Psi.append(Z @ P)
        P = T @ P
    Psi = torch.stack(Psi, dim=-3)                      # (..., H, k, m)

    # stacked constraint matrix over (condition rows) x (shock path):
    # M[(h, i), (s, j)] = Psi[h-s][i, j] for s <= h
    hh = torch.arange(horizon, device=T.device)
    lag = hh[:, None] - hh[None, :]                     # (H, H)
    Psi_lag = torch.where((lag >= 0)[:, :, None, None],
                          Psi[..., torch.clamp(lag, min=0), :, :],
                          torch.zeros((), dtype=T.dtype, device=T.device))
    batch = Psi.shape[:-3]
    M_full = Psi_lag.transpose(-3, -2).reshape(
        batch + (horizon * k_obs, horizon * n_shocks))

    m = mask.reshape(-1)
    r = torch.where(m, (target - baseline).reshape(batch + (-1,)),
                    torch.zeros((), dtype=T.dtype, device=T.device))
    Msel = torch.where(m[:, None], M_full,
                       torch.zeros((), dtype=T.dtype, device=T.device))

    # minimize sum_s eps_s' Q^{-1} eps_s  s.t.  Msel eps = r (masked rows);
    # the free rows' zero Gram rows get a unit ridge, which leaves the
    # masked rows' solution untouched
    eye_h = torch.eye(horizon, dtype=Q.dtype, device=Q.device)
    Qblk = (eye_h[:, None, :, None] * Q[..., None, :, None, :]).reshape(
        Q.shape[:-2] + (horizon * n_shocks, horizon * n_shocks))
    G = Msel @ Qblk @ Msel.mT
    ridge = torch.where(m, 0.0, 1.0).to(G.dtype)
    lam = torch.linalg.solve(G + torch.diag(ridge), r)
    eps = _mv(Qblk @ Msel.mT, lam).reshape(batch + (horizon, n_shocks))

    x, ys = xT, []
    for h in range(horizon):
        x = _mv(T, x) + _mv(R, eps[..., h, :])
        ys.append(_mv(Z, x) + d)
    return torch.stack(ys, dim=-2), eps, baseline


@torch.no_grad()
def conditional_forecast(
    ss_mod: DSGEStateSpace,
    result,
    data: np.ndarray,
    conditions: dict[str, np.ndarray],
    horizon: int = 12,
    max_draws: int | None = 200,
    quantiles=(0.05, 0.5, 0.95),
) -> tuple[Bands, Bands]:
    """Forecast with some observables constrained to given future paths.

    ``conditions`` maps observable names to arrays of future values
    (length <= horizon; ``NaN`` entries are unconstrained).  For each
    posterior draw, the Q-weighted least-norm structural-shock paths that
    reproduce the constrained entries exactly (hard conditioning à la
    Waggoner-Zha 1999) are computed in closed form, and every observable
    is propagated under those shocks from the filtered terminal state.
    Measurement error is excluded: conditions bind the model-implied
    observables.

    Returns ``(forecast, shocks)``: bands with ``dims`` (variable, time)
    and (shock, time).
    """
    obs_names = list(ss_mod.observed_states)
    mf = ss_mod.model.functions
    target = np.zeros((horizon, len(obs_names)))
    mask = np.zeros((horizon, len(obs_names)), dtype=bool)
    for name, path in conditions.items():
        if name not in obs_names:
            raise KeyError(f"{name!r} is not an observed state "
                           f"(observed: {obs_names})")
        j = obs_names.index(name)
        path = np.asarray(path, dtype=float).ravel()
        if len(path) > horizon:
            raise ValueError(f"condition on {name!r} longer than horizon")
        fin = np.isfinite(path)
        target[:len(path), j] = np.where(fin, path, 0.0)
        mask[:len(path), j] = fin
    if not mask.any():
        raise ValueError("conditions contain no finite entries")

    sol = _solve(ss_mod, result, max_draws, full_state=True)
    xT, _ = _terminal_state(ss_mod, sol, data)
    dev = xT.device
    ys, eps, _ = _conditional_core(
        sol["T_aug"], sol["R_aug"], sol["Q"], sol["Z"], sol["d"], xT,
        torch.as_tensor(target, dtype=xT.dtype, device=dev),
        torch.as_tensor(mask, device=dev), horizon)
    return (_forecast_frame(ys, obs_names, horizon, quantiles),
            _forecast_frame(eps, mf.shock_names, horizon, quantiles))
