"""Impulse-response matching estimation (minimum-distance).

Mirrors ``geconpy_tpu/stats/irf_matching.py``: ``IRFMatchResult`` (:33),
``build_irf_fn`` (:42) and ``fit_irf_matching`` (:75).
Christiano-Eichenbaum-Evans style: choose structural parameters so the
model's IRFs match given target responses (typically from an identified
SVAR) under a weighted quadratic distance.  The map ``theta -> steady
state -> linearization -> policy solve -> IRF stack`` is differentiable
(the implicit adjoints of the steady state and of cycle reduction), so the
distance is minimized by Adam to the basin and Gauss-Newton on the exact
Jacobian (:mod:`._optim`).  Where the reference solves the model once per
targeted shock, the port solves it once per parameter point and
propagates every shock's impulse together.

The reference takes its target as ``{shock: DataFrame}`` (columns the
variables, index the horizons, NaN entries skipped); the port takes
``{shock: IRFTarget}`` with the same three pieces, and returns ``fitted``
as a (n_rows, 2) tensor, columns ``("model", "target")``, with the
(shock, variable, horizon) of each row in ``fitted_labels``.  Everything
runs in float64 on ``device`` (``"cuda"`` unless the caller asks for the
CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cycle_reduction import cycle_reduction, selection_matrix
from ..ops.precision import highest_precision
from ._optim import adam_gauss_newton, jacobian

__all__ = ["IRFMatchResult", "IRFTarget", "build_irf_fn", "fit_irf_matching"]


class IRFTarget(NamedTuple):
    """One shock's target (or weights): ``values`` (len(horizons),
    len(variables)), NaN entries skipped; ``horizons`` default to
    0..len(values)-1 (0 = impact)."""

    values: np.ndarray
    variables: list
    horizons: list | None = None

    def rows(self) -> np.ndarray:
        return np.asarray(range(len(self.values)) if self.horizons is None
                          else self.horizons, dtype=int)


class IRFMatchResult(NamedTuple):
    params: dict               # point estimates (constrained space)
    std_errors: dict           # Gauss-Newton delta-method SEs
    loss: float                # weighted SSE at the optimum
    fitted: torch.Tensor       # (n_rows, 2): model, target
    success: bool              # solver flags clean at the optimum
    n_obs: int                 # number of matched IRF entries
    fitted_labels: list        # (shock, variable, horizon) of each row


def _irf_fn(model, shock_periods: dict, shock_size: float = 1.0):
    """``theta_free (..., p) -> {shock: (irf (..., periods, n_vars), ok)}``
    for several shocks, on one solve of the model: each shock's path and
    flag are those :func:`build_irf_fn` gives it alone (the reference
    solves the model again for every shock; the paths differ by rounding
    in the stacked product)."""
    mf = model.functions
    for shock in shock_periods:
        if shock not in mf.shock_names:
            raise KeyError(f"unknown shock {shock!r}; shocks: "
                           f"{mf.shock_names}")
    js = [mf.shock_names.index(s) for s in shock_periods]
    horizon = max(shock_periods.values())
    linearize = model.linearizer(loglin_variables=False)
    ss_solver = model.ss_solver

    @highest_precision()
    def irfs(theta_free):
        sol = ss_solver(torch.as_tensor(theta_free))
        lin = linearize(sol.x_ss, sol.theta_full)
        cr = cycle_reduction(lin.A, lin.B, lin.C)
        R = selection_matrix(lin.B, lin.C, cr.T, lin.D)
        X = shock_size * R[..., :, js]
        path = []
        for _ in range(horizon):
            path.append(X)
            X = cr.T @ X
        path = torch.stack(path, dim=-3)            # (..., horizon, n, k)
        out = {}
        for c, (shock, periods) in enumerate(shock_periods.items()):
            p_s = path[..., :periods, :, c]
            out[shock] = (p_s, sol.success & cr.success
                          & torch.isfinite(p_s).all(dim=(-2, -1)))
        return out

    return irfs


def build_irf_fn(model, shock: str, periods: int = 40,
                 shock_size: float = 1.0):
    """``theta_free (..., p) -> (irf (..., periods, n_vars), ok (...))``
    for one shock.

    IRFs are level deviations from the steady state (linear solution,
    ``loglin=False``) to a ``shock_size`` impulse at t = 0; row h is the
    response at horizon h (impact row included).  Differentiable in
    ``theta_free``; runs on its device.
    """
    fn = _irf_fn(model, {shock: periods}, shock_size)

    def irf(theta_free):
        return fn(theta_free)[shock]

    return irf


def fit_irf_matching(
    model,
    target: dict,
    estimated: list[str],
    weights: dict | None = None,
    shock_size: float = 1.0,
    x0: dict | None = None,
    adam_steps: int = 400,
    newton_steps: int = 6,
    learning_rate: float = 0.02,
    *,
    device: str | torch.device = "cuda",
) -> IRFMatchResult:
    """Estimate ``estimated`` parameters by matching the target IRFs.

    ``target``: ``{shock_name: IRFTarget}``; NaN entries are skipped.
    ``weights`` mirrors the target (an ``IRFTarget`` over the same
    variables, or an array of the target's shape; defaults to 1); with
    inverse-variance weights the reported standard errors are the
    classical minimum-distance delta-method ones,
    ``sqrt(diag((J'WJ)^{-1}))``.

    Parameters with a ``positive`` assumption in the GCN are optimized in
    log space; others in levels.  Solver failures during the search are
    rejected (Adam gradients are zeroed, Newton steps not taken).
    """
    mf = model.functions
    names = [p.name for p in mf.free_params]
    for e in estimated:
        if e not in names:
            raise KeyError(f"{e!r} is not a free parameter ({names})")
    dev = torch.device(device)
    idx = torch.as_tensor([names.index(e) for e in estimated], device=dev)
    positive = torch.as_tensor([
        bool(mf.free_params[names.index(e)].assumptions0.get("positive"))
        for e in estimated], device=dev)

    theta0_full = model.default_theta(**(x0 or {})).to(dev)
    z0 = torch.where(positive, torch.log(theta0_full[idx]), theta0_full[idx])

    def to_theta(z):
        vals = torch.where(positive, torch.exp(z), z)
        theta = theta0_full.expand(z.shape[:-1] + theta0_full.shape).clone()
        theta[..., idx] = vals
        return theta

    # flatten the target into index arrays once (host side)
    irf_all = _irf_fn(model, {s: int(max(tg.rows())) + 1
                              for s, tg in target.items()}, shock_size)
    pieces = []
    for s, tg in target.items():
        wt = None if weights is None else weights.get(s)
        values = np.asarray(tg.values, dtype=float)
        for c, var in enumerate(tg.variables):
            if var not in mf.variable_names:
                raise KeyError(f"{var!r} is not a model variable")
            v = mf.variable_names.index(var)
            col = values[:, c]
            fin = np.isfinite(col)
            hs = tg.rows()[fin]
            if wt is None:
                w = np.ones(fin.sum())
            elif isinstance(wt, IRFTarget):
                w = np.asarray(wt.values, dtype=float)[
                    :, list(wt.variables).index(var)][fin]
            else:
                w = np.asarray(wt, dtype=float)[:, c][fin]
            pieces.append((s, v, torch.as_tensor(hs, device=dev),
                           torch.as_tensor(col[fin], device=dev),
                           torch.sqrt(torch.as_tensor(w, device=dev))))
    if not pieces:
        raise ValueError("target contains no finite entries")
    n_obs = int(sum(len(p[3]) for p in pieces))

    def residuals(z):
        out = irf_all(to_theta(z))
        rs = [sw * (out[s][0][..., hs, v] - tgt)
              for s, v, hs, tgt, sw in pieces]
        ok = torch.stack([o for _, o in out.values()], dim=-1).all(dim=-1)
        return torch.cat(rs, dim=-1), ok

    z = adam_gauss_newton(residuals, z0, adam_steps=adam_steps,
                          newton_steps=newton_steps,
                          learning_rate=learning_rate)
    with torch.no_grad():
        r, ok = residuals(z)
    final_loss = float(torch.sum(r * r))

    # delta-method SEs in constrained space: d theta/d z = theta (log) or 1
    J = jacobian(lambda Z: residuals(Z)[0], z, n_obs).cpu().numpy()
    cov_z = np.linalg.inv(J.T @ J + 1e-12 * np.eye(len(estimated)))
    theta_z = to_theta(z)
    theta_hat = theta_z[idx].cpu().numpy()
    scale = np.where(positive.cpu().numpy(), theta_hat, 1.0)
    se = np.sqrt(np.clip(np.diag(cov_z), 0, np.inf)) * scale

    rows, labels = [], []
    with torch.no_grad():
        paths = irf_all(theta_z)
        for s, tg in target.items():
            path = paths[s][0]
            values = torch.as_tensor(np.array(tg.values, dtype=float),
                                     device=dev)
            hs = tg.rows()
            for c, var in enumerate(tg.variables):
                v = mf.variable_names.index(var)
                rows.append(torch.stack([path[torch.as_tensor(hs, device=dev),
                                              v], values[:, c]], dim=-1))
                labels.extend((s, var, int(h)) for h in hs)

    return IRFMatchResult(
        params=dict(zip(estimated, theta_hat.tolist())),
        std_errors=dict(zip(estimated, se.tolist())),
        loss=final_loss,
        fitted=torch.cat(rows, dim=0),
        success=bool(ok),
        n_obs=n_obs,
        fitted_labels=labels,
    )
