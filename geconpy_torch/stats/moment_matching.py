"""Method-of-moments estimation (GMM on analytic state-space moments).

Mirrors ``geconpy_tpu/stats/moment_matching.py``: ``MomentMatchResult``
(:31), ``_moment_labels`` (:41), ``model_moments`` (:55),
``_sample_moment_series`` (:72), ``_newey_west`` (:90) and
``fit_moment_matching`` (:103).  The model moments are analytic functions
of the state-space solution (``DSGEStateSpace.build_solution_fn(
full_state=True)``, the doubling Lyapunov solve and matrix powers), so the
objective is differentiable end to end and the estimator is Adam +
Gauss-Newton on exact gradients (:mod:`._optim`).  Standard errors are the
GMM sandwich with a Newey-West long-run variance of the sample moment
conditions; its two Jacobians (the moments' and ``constrain``'s) are the
exact reverse-mode :func:`._optim.jacobian`.

Where the reference returns a pandas frame of model and sample moments,
the port returns a (n_moments, 2) tensor, columns ``("model", "sample")``,
with the (kind, which, lag) label of each row in ``moment_labels``.
The sample side (the moment series and Newey-West) is numpy on the host,
as in the reference; the model side runs on the state space's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._optim import adam_gauss_newton, jacobian
from .covariance import autocovariance

__all__ = ["MomentMatchResult", "fit_moment_matching", "model_moments"]


class MomentMatchResult(NamedTuple):
    params: dict               # point estimates (constrained)
    std_errors: dict           # GMM sandwich SEs
    loss: float                # weighted distance at the optimum
    moments: torch.Tensor      # (n_moments, 2): model, sample
    success: bool
    n_moments: int
    moment_labels: list        # (kind, which, lag) of each row of moments


def _moment_labels(obs_names, lags):
    labels = [("mean", v, 0) for v in obs_names]
    n = len(obs_names)
    for i in range(n):
        for jj in range(i, n):
            labels.append(("cov", f"{obs_names[i]},{obs_names[jj]}", 0))
    for lag in lags:
        for i in range(n):
            for jj in range(n):
                labels.append(
                    ("autocov", f"{obs_names[i]},{obs_names[jj]}", lag))
    return labels


def model_moments(sol: dict, lags: tuple[int, ...]) -> torch.Tensor:
    """Stacked analytic moments [means, vech(cov), autocovs(lags)] of the
    observables implied by a solution dict (full_state=True), over the
    solution's leading batch dimensions."""
    T, R = sol["T_aug"], sol["R_aug"]
    Q, Z, H, d = sol["Q"], sol["Z"], sol["H"], sol["d"]
    n = Z.shape[-2]
    max_lag = max(lags) if lags else 0
    gam = autocovariance(T, R, Q, n_lags=max_lag + 1)
    Zh = Z.unsqueeze(-3)
    A = Zh @ gam @ Zh.mT                          # (..., lags, n, n)
    iu = torch.triu_indices(n, n, device=Z.device)
    batch = d.shape[:-1]
    parts = [d, (A[..., 0, :, :] + H)[..., iu[0], iu[1]]]
    for lag in lags:
        parts.append(A[..., lag, :, :].reshape(batch + (n * n,)))
    return torch.cat(parts, dim=-1)


def _sample_moment_series(y: np.ndarray, lags: tuple[int, ...]):
    """Per-period moment-condition series h_t (T_eff, n_mom) whose time
    average is the stacked sample moment vector."""
    Tn, n = y.shape
    max_lag = max(lags) if lags else 0
    ybar = y.mean(axis=0)
    yc = y - ybar
    T_eff = Tn - max_lag
    cols = [y[max_lag:]]                                     # means
    iu = np.triu_indices(n)
    prods = yc[max_lag:, :, None] * yc[max_lag:, None, :]    # (T_eff, n, n)
    cols.append(prods[:, iu[0], iu[1]])
    for lag in lags:
        lagged = yc[max_lag:, :, None] * yc[max_lag - lag:Tn - lag, None, :]
        cols.append(lagged.reshape(T_eff, -1))
    return np.concatenate(cols, axis=1)


def _newey_west(h: np.ndarray, n_lags: int | None = None):
    T_eff, _ = h.shape
    hc = h - h.mean(axis=0)
    if n_lags is None:
        n_lags = int(np.floor(4 * (T_eff / 100.0) ** (2.0 / 9.0)))
    S = hc.T @ hc / T_eff
    for lag in range(1, n_lags + 1):
        w = 1.0 - lag / (n_lags + 1.0)
        G = hc[lag:].T @ hc[:-lag] / T_eff
        S = S + w * (G + G.T)
    return S


def fit_moment_matching(
    ss_mod,
    data: np.ndarray,
    lags: tuple[int, ...] = (1,),
    weights: np.ndarray | str = "diag",
    u0=None,
    adam_steps: int = 400,
    newton_steps: int = 6,
    learning_rate: float = 0.02,
) -> MomentMatchResult:
    """Estimate the configured parameters by matching observable moments.

    Matched moments: means, the upper triangle of the contemporaneous
    covariance, and full autocovariance matrices at each lag in ``lags``.
    ``weights``: "diag" (default — inverse Newey-West variances of each
    sample moment, a diagonal approximation to optimal GMM), "identity",
    or an explicit (n_mom,) vector / (n_mom, n_mom) matrix.

    Parameters are the state-space's estimated set (GCN priors define the
    unconstrained search space via their transforms); the prior densities
    are NOT part of the objective — this is frequentist GMM.  The search
    runs in float64 on the state space's device.
    """
    y = np.asarray(data, dtype=float)
    if np.isnan(y).any():
        raise ValueError("moment matching requires fully observed data")
    lags = tuple(int(l) for l in lags)
    if any(l <= 0 for l in lags):
        raise ValueError("lags must be positive (lag 0 is always matched)")
    obs_names = list(ss_mod.observed_states)
    dev = ss_mod._device()

    h = _sample_moment_series(y, lags)
    m_data = h.mean(axis=0)
    n_mom = len(m_data)
    S = _newey_west(h)

    if isinstance(weights, str):
        if weights == "identity":
            W_sqrt = np.ones(n_mom)
        elif weights == "diag":
            W_sqrt = 1.0 / np.sqrt(np.clip(np.diag(S), 1e-30, np.inf))
        else:
            raise ValueError("weights must be 'diag', 'identity' or an array")
        W = np.diag(W_sqrt**2)
        sqrtW = torch.as_tensor(W_sqrt, device=dev)

        def apply_sqrtW(r):
            return sqrtW * r
    else:
        W = np.asarray(weights, dtype=float)
        if W.ndim == 1:
            W = np.diag(W)
        LwT = torch.as_tensor(np.linalg.cholesky(W).T, device=dev)

        def apply_sqrtW(r):
            return (LwT @ r.unsqueeze(-1)).squeeze(-1)

    solve_draw = ss_mod.build_solution_fn(full_state=True)
    m_data_t = torch.as_tensor(m_data, device=dev)

    def moments(u):
        return model_moments(solve_draw(u), lags)

    def residuals(u):
        sol = solve_draw(u)
        ok = sol["ss_success"] & sol["solver_success"] & sol["stable"]
        return apply_sqrtW(model_moments(sol, lags) - m_data_t), ok

    u = torch.as_tensor(ss_mod.initial_position() if u0 is None else u0,
                        dtype=torch.float64, device=dev)
    u = adam_gauss_newton(residuals, u, adam_steps=adam_steps,
                          newton_steps=newton_steps,
                          learning_rate=learning_rate)
    with torch.no_grad():
        r, ok = residuals(u)
        m_model = moments(u)
    final_loss = float(torch.sum(r * r))

    # GMM sandwich: G = d m / d theta (constrained); with Wd = W used in
    # the objective, Var = (G'WG)^{-1} G'W S W G (G'WG)^{-1} / T_eff
    theta_hat = ss_mod.constrain(u).cpu().numpy()

    # chain rule into constrained space: G_theta = G_u @ (d theta/d u)^{-1}
    # (constrain is elementwise, so its Jacobian is diagonal)
    G_u = jacobian(moments, u, n_mom).cpu().numpy()
    J_c = jacobian(ss_mod.constrain, u, u.shape[0]).cpu().numpy()
    G = G_u @ np.linalg.inv(J_c)
    T_eff = h.shape[0]
    GW = G.T @ W
    bread = np.linalg.inv(GW @ G + 1e-12 * np.eye(G.shape[1]))
    cov = bread @ (GW @ S @ GW.T) @ bread / T_eff
    se = np.sqrt(np.clip(np.diag(cov), 0, np.inf))

    names = ss_mod.param_labels
    return MomentMatchResult(
        params=dict(zip(names, theta_hat.tolist())),
        std_errors=dict(zip(names, se.tolist())),
        loss=final_loss,
        moments=torch.stack([m_model.detach(), m_data_t], dim=-1),
        success=bool(ok),
        n_moments=n_mom,
        moment_labels=_moment_labels(obs_names, lags),
    )
