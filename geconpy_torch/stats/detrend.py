"""Detrending utilities for empirical data preparation.

A copy of ``geconpy_tpu/stats/detrend.py`` with only the package name
changed: numpy code, run on the host in the reference as well (data
preparation before a likelihood sees the data).

- :func:`hp_filter` — the two-sided Hodrick-Prescott filter, solved
  exactly via the pentadiagonal normal equations (one banded solve).
- :func:`one_sided_hp_filter` — Stock-Watson one-sided HP: the HP trend
  re-derived as the Kalman filter of a local-linear-trend state space,
  using only past data at each t (no look-ahead — the version that is
  legitimate inside forecasting/estimation pipelines).
- :func:`hamilton_filter` — Hamilton (2018) regression filter: the
  h-step-ahead OLS projection residual on p lags.

All accept (T,) series or (T, k) panels and return (trend, cycle).
"""

from __future__ import annotations

import numpy as np

__all__ = ["hp_filter", "one_sided_hp_filter", "hamilton_filter"]


def _as2d(y):
    y = np.asarray(y, dtype=float)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    if np.isnan(y).any():
        raise ValueError("detrending requires fully observed data")
    return y, squeeze


def hp_filter(y, lam: float = 1600.0):
    """Two-sided HP filter: min sum (y-tau)^2 + lam * sum (d^2 tau)^2.

    Exact solution of (I + lam D'D) tau = y with D the second-difference
    operator — a pentadiagonal system, solved densely here (T x T; fine
    for macro sample sizes).
    """
    y, squeeze = _as2d(y)
    T = y.shape[0]
    if T < 3:
        raise ValueError("need at least 3 observations")
    D = np.zeros((T - 2, T))
    for i in range(T - 2):
        D[i, i:i + 3] = (1.0, -2.0, 1.0)
    A = np.eye(T) + lam * (D.T @ D)
    trend = np.linalg.solve(A, y)
    cycle = y - trend
    if squeeze:
        return trend[:, 0], cycle[:, 0]
    return trend, cycle


def one_sided_hp_filter(y, lam: float = 1600.0):
    """Stock-Watson one-sided HP: Kalman-filtered local linear trend.

    The two-sided HP trend is the smoothed state of the LLT model
    ``y_t = tau_t + eps_t``, ``tau_t = tau_{t-1} + beta_{t-1}``,
    ``beta_t = beta_{t-1} + eta_t`` with Var(eps)/Var(eta) = lam; using
    the *filtered* (one-sided) state instead removes the look-ahead.
    """
    y, squeeze = _as2d(y)
    T, k = y.shape
    q = 1.0 / lam
    F = np.array([[2.0, -1.0], [1.0, 0.0]])     # state: (tau_t, tau_{t-1})
    Q = np.array([[q, 0.0], [0.0, 0.0]])
    Zv = np.array([1.0, 0.0])

    trend = np.empty_like(y)
    for j in range(k):
        x = np.array([2.0 * y[0, j] - y[1, j], 3.0 * y[0, j] - 2.0 * y[1, j]])
        P = np.full((2, 2), 1e5)
        for t in range(T):
            # predict
            x = F @ x
            P = F @ P @ F.T + Q
            # update
            f = Zv @ P @ Zv + 1.0
            kg = (P @ Zv) / f
            v = y[t, j] - Zv @ x
            x = x + kg * v
            P = P - np.outer(kg, Zv @ P)
            trend[t, j] = x[0]
    cycle = y - trend
    if squeeze:
        return trend[:, 0], cycle[:, 0]
    return trend, cycle


def hamilton_filter(y, h: int = 8, p: int = 4):
    """Hamilton (2018) "Why you should never use the HP filter" filter:
    regress y_{t+h} on (1, y_t, ..., y_{t-p+1}); the fitted value is the
    trend, the residual the cycle.  The first ``h + p - 1`` periods have
    no cycle value (returned as NaN).
    """
    y, squeeze = _as2d(y)
    T, k = y.shape
    if T <= h + p:
        raise ValueError(f"need more than h + p = {h + p} observations")
    trend = np.full_like(y, np.nan)
    cycle = np.full_like(y, np.nan)
    rows = np.arange(p - 1, T - h)
    for j in range(k):
        Xj = np.column_stack([np.ones(len(rows))]
                             + [y[rows - i, j] for i in range(p)])
        yj = y[rows + h, j]
        beta, *_ = np.linalg.lstsq(Xj, yj, rcond=None)
        fit = Xj @ beta
        trend[rows + h, j] = fit
        cycle[rows + h, j] = yj - fit
    if squeeze:
        return trend[:, 0], cycle[:, 0]
    return trend, cycle
