"""Deterministic (perfect-foresight) nonlinear trajectory solver.

Mirrors ``geconpy_tpu/analysis/perfect_foresight.py``:
``PerfectForesightResult`` (:39), ``_stacked_solver`` (:46, with its
``"direct"`` and ``"krylov"`` directions) and ``solve_perfect_foresight``
(:166).  The stacked-time system F(y_{t-1}, y_t, y_{t+1}, eps_t) = 0 for
t = 1..T (boundary y_0, y_{T+1} fixed at the initial and terminal steady
states) is solved by a damped Newton iteration in which

- the T per-period residuals come from ONE call of the lowered model
  function over the periods, and the three Jacobian blocks from one
  ``torch.func.vmap(torch.func.jacfwd(f_resid, argnums=(0, 1, 2)))``, as
  ``models/perturbation.py`` linearizes;
- each Newton step solves the block-tridiagonal system with the block
  Thomas solve (:mod:`~geconpy_torch.ops.block_tridiag`), or
  (``direction="krylov"``) runs restarted GMRES
  (:mod:`~geconpy_torch.ops.gmres`) whose matvec is one
  ``torch.func.jvp`` of the stacked residual, preconditioned by the block
  solve on the terminal steady state's constant blocks;
- the backtracking tries 10 half-steps in one call of the residual and
  keeps the first that lowers the residual's max-norm, as the reference's
  scan does.

The reference's ``lax.while_loop`` is a Python loop with one host read an
iteration.  Everything runs in float64 on ``device`` (``"cuda"`` unless
the caller asks for the CPU); the trajectory is a (T + 2, n) tensor with
the variable names and the periods -1..T beside it (no pandas).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.block_tridiag import solve_block_tridiagonal
from ..ops.gmres import gmres
from ..ops.precision import highest_precision
from ..ops.tolerances import success_tol

__all__ = ["solve_perfect_foresight", "PerfectForesightResult"]


class PerfectForesightResult(NamedTuple):
    trajectory: torch.Tensor     # (T+2, n) incl. boundary rows
    success: bool
    n_iter: int
    resid_norm: float
    variables: list              # column names of trajectory
    time: list                   # row labels of trajectory: -1..T


def _stacked_solver(mf, periods: int, tol: float, maxiter: int,
                    max_backtracks: int = 10, direction: str = "direct"):
    f = mf.f_resid
    jac = torch.func.jacfwd(f, argnums=(0, 1, 2))
    jac_blocks = torch.func.vmap(jac)
    n = mf.n_variables

    def stacked_args(Y, y0, yT1, eps_path, theta_path):
        """f's six arguments per period, over Y's leading dimensions."""
        lead = Y.shape[:-2]
        y_prev = torch.cat([y0.expand(lead + (1, n)), Y[..., :-1, :]], dim=-2)
        y_next = torch.cat([Y[..., 1:, :], yT1.expand(lead + (1, n))], dim=-2)
        return (y_prev, Y, y_next, eps_path.expand(lead + eps_path.shape),
                yT1.expand(Y.shape), theta_path.expand(lead + theta_path.shape))

    def residuals(Y, y0, yT1, eps_path, theta_path):
        """Y: (..., T, n) unknowns.  Residual r[t] = F(y_{t-1}, y_t,
        y_{t+1}); SS-symbol references resolve to the terminal steady
        state."""
        return f(*stacked_args(Y, y0, yT1, eps_path, theta_path))

    @highest_precision()
    def solve(Y0, y0, yT1, eps_path, theta_path):
        # dtype-aware convergence: the caller's tol is the float64 target
        tol_eff = success_tol(Y0.dtype, base=tol)
        alphas = 0.5 ** torch.arange(max_backtracks, dtype=Y0.dtype,
                                     device=Y0.device)

        def norm(r):
            return torch.amax(r.abs(), dim=(-2, -1))

        def direct_direction(Y, r):
            A, B, C = jac_blocks(*stacked_args(Y, y0, yT1, eps_path,
                                               theta_path))
            # A[0] couples to fixed y0 (not an unknown): zero it; same C[T-1]
            A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
            C = torch.cat([C[:-1], torch.zeros_like(C[:1])])
            return solve_block_tridiagonal(A, B, C, -r)

        def krylov_direction(Y, r):
            # matrix-free GMRES on the stacked system, preconditioned by the
            # block solve on the CONSTANT terminal-steady-state blocks
            zero_e = Y.new_zeros(eps_path.shape[-1])
            A_ss, B_ss, C_ss = jac(yT1, yT1, yT1, zero_e, yT1, theta_path[-1])
            shape = (Y.shape[0], n, n)
            first = torch.arange(Y.shape[0], device=Y.device)[:, None, None]
            A_b = torch.where(first == 0, 0.0, A_ss.expand(shape))
            B_b = B_ss.expand(shape)
            C_b = torch.where(first == Y.shape[0] - 1, 0.0,
                              C_ss.expand(shape))

            def matvec(v):
                tangent = torch.func.jvp(
                    lambda Y_: residuals(Y_, y0, yT1, eps_path, theta_path),
                    (Y,), (v.reshape(Y.shape),))[1]
                return tangent.reshape(1, -1)

            def precond(v):
                return solve_block_tridiagonal(
                    A_b, B_b, C_b, v.reshape(Y.shape)).reshape(1, -1)

            dy = gmres(matvec, -r.reshape(1, -1), M=precond, tol=1e-8,
                       atol=0.0, restart=20, maxiter=4)
            return dy.reshape(Y.shape)

        Y = Y0
        r = residuals(Y, y0, yT1, eps_path, theta_path)
        it = 0
        done = bool(norm(r) < tol_eff)
        while not done and it < maxiter:
            dY = (krylov_direction(Y, r) if direction == "krylov"
                  else direct_direction(Y, r))
            bad = ~torch.isfinite(dY).all()
            dY = torch.where(bad, torch.zeros_like(dY), dY)
            m0 = norm(r)
            Y_try = Y + alphas[:, None, None] * dY
            r_try = residuals(Y_try, y0, yT1, eps_path, theta_path)
            ok = torch.isfinite(r_try).all(dim=(-2, -1)) & (norm(r_try) < m0)
            idx = torch.arange(max_backtracks, device=Y.device)
            first = torch.where(ok, idx, max_backtracks).amin()
            accepted = first < max_backtracks
            pick = first.clamp(max=max_backtracks - 1)
            Y = torch.where(accepted, Y_try[pick], Y)
            r = torch.where(accepted, r_try[pick], r)
            it += 1
            done = bool((norm(r) < tol_eff) | ~accepted | bad)
        final_norm = norm(r)
        success = bool(torch.isfinite(final_norm) & (final_norm < tol_eff))
        return Y, success, it, float(final_norm)

    return solve


def _shock_path(mf, shocks, periods: int) -> np.ndarray:
    """(periods, n_shocks) realized shocks from ``{name: path}``, each path
    padded with zeros or cut to ``periods``."""
    eps_path = np.zeros((periods, mf.n_shocks))
    if shocks:
        for name, path in shocks.items():
            if name not in mf.shock_names:
                raise KeyError(f"unknown shock {name!r}; shocks are "
                               f"{mf.shock_names}")
            j = mf.shock_names.index(name)
            path = np.asarray(path, dtype=float).ravel()
            m = min(len(path), periods)
            eps_path[:m, j] = path[:m]
    return eps_path


def solve_perfect_foresight(
    model,
    periods: int = 100,
    shocks: dict[str, np.ndarray] | None = None,
    initial_params: dict | None = None,
    terminal_params: dict | None = None,
    param_paths: dict[str, np.ndarray] | None = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    initial_guess: str = "terminal",   # "terminal" | "linear" | "initial"
    direction: str = "direct",         # "direct" | "krylov"
    *,
    device: str | torch.device = "cuda",
) -> PerfectForesightResult:
    """Solve the nonlinear deterministic trajectory.

    - Temporary shocks: ``shocks={"epsilon_A": array}`` (padded/truncated to
      ``periods``); the economy starts and ends at the same steady state.
    - Permanent change: pass ``terminal_params`` differing from
      ``initial_params`` — boundaries use the two steady states and the
      terminal parameterization governs dynamics (announced-at-t0 change).
    - Time-varying parameters: ``param_paths={"name": array}`` overrides a
      free parameter along the transition (padded with its terminal value);
      the terminal steady state must be consistent with the path's end.
    - ``direction="krylov"`` computes each Newton step with matrix-free
      GMRES (one jvp per inner iteration) instead of the block-tridiagonal
      direct factorization — O(T n restart) memory, for horizons where the
      (T, n, n) factor blocks no longer fit.
    """
    mf = model.functions
    dev = torch.device(device)

    theta0 = model.default_theta(**(initial_params or {})).to(dev)
    theta1 = model.default_theta(**{**(initial_params or {}),
                                    **(terminal_params or {})}).to(dev)
    with torch.no_grad():
        ss0 = model.ss_solver(theta0)
        ss1 = model.ss_solver(theta1)
    if not (bool(ss0.success) and bool(ss1.success)):
        raise RuntimeError("boundary steady state(s) failed to solve")

    eps_path = _shock_path(mf, shocks, periods)

    theta_path = ss1.theta_full.expand(periods, -1).clone()
    if param_paths:
        free_names = [p_.name for p_ in mf.free_params]
        # theta_full layout: free ++ deterministic ++ calibrated; recompute
        # the free+deterministic block per period through f_params
        free_block = np.tile(model.default_theta(
            **{**(initial_params or {}), **(terminal_params or {})}
        ).numpy()[None, :], (periods, 1))
        for name, path in param_paths.items():
            if name not in free_names:
                raise KeyError(f"unknown parameter {name!r} in param_paths")
            j = free_names.index(name)
            path = np.asarray(path, dtype=float).ravel()
            m = min(len(path), periods)
            free_block[:m, j] = path[:m]
            if m < periods:
                free_block[m:, j] = path[-1] if len(path) else free_block[m:, j]
        fd = mf.f_params(torch.as_tensor(free_block, device=dev))
        theta_path[:, :fd.shape[1]] = fd

    x0_ss, xT_ss = ss0.x_ss, ss1.x_ss
    if initial_guess == "terminal":
        Y0 = xT_ss.expand(periods, -1).clone()
    elif initial_guess == "initial":
        Y0 = x0_ss.expand(periods, -1).clone()
    else:  # linear interpolation between the two steady states
        w = torch.linspace(0.0, 1.0, periods, dtype=x0_ss.dtype,
                           device=dev)[:, None]
        Y0 = (1 - w) * x0_ss[None, :] + w * xT_ss[None, :]

    solve = _stacked_solver(mf, periods, tol, maxiter, direction=direction)
    with torch.no_grad():
        Y, success, n_iter, resid_norm = solve(
            Y0, x0_ss, xT_ss, torch.as_tensor(eps_path, device=dev),
            theta_path)

    rows = torch.cat([x0_ss[None], Y, xT_ss[None]])
    return PerfectForesightResult(rows, success, n_iter, resid_norm,
                                  list(mf.variable_names),
                                  list(range(-1, periods + 1)))
