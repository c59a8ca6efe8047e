"""Likelihood of the pruned second-order solution, batched over draws.

Mirrors ``geconpy_tpu/stats/nonlinear.py``: ``quadratic_drive_covariance``
(:55), ``build_second_order_solution_fn`` (:75),
``build_logpost_second_order`` (:184), ``filter_data_second_order`` (:244)
and ``build_pf_loglik_second_order`` (:285).

The filter state is z = [y1 (n), y2 (n), w_1 ... w_L (n each)]:

    y1' = T y1 + R eps
    y2' = T y2 + 1/2 G_xx(y1, y1) + G_xu(y1, eps) + 1/2 G_uu(eps, eps)
               + 1/2 g_ss
    w_1' = y1 + y2,  w_{j+1}' = w_j      (the observation equations' lags)

observed through the first-order design Z over [y1 + y2, w_1, ..., w_L].
It starts at the pruned system's stationary law: y1 ~ N(0, Σ1), y2 with
mean mu2 (``second_order_mean``) and the covariance of the quadratic
drive's Lyapunov equation.  The solution comes from
``DSGEStateSpace._solution_pieces(full_state=True)``, batched over the
draws; where the reference returns per-draw closures, the port's
``transition``, ``observe`` and ``nonlinear`` (:func:`pruned_transition`,
:func:`pruned_observe`, :func:`pruned_nonlinear`) are batched functions of
the solution dict and (B, S, nz) tensors.  A failed draw gets -inf (a
flag), never an exception; the gate is the first-order ``build_logpost``'s
plus the second-order solve's success.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.second_order import SecondOrderResult, _second_order_correction
from ..ops.cycle_reduction import _solve_nan
from ..ops.kalman import _chol_nan
from ..ops.lyapunov import solve_discrete_lyapunov
from ..ops.particle_filter import _particle_filter
from ..ops.precision import highest_precision
from ..ops.ukf import cl_ukf_loglik, ukf_loglik, ukf_smoother

__all__ = ["build_second_order_solution_fn", "build_logpost_second_order",
           "build_pf_loglik_second_order", "filter_data_second_order",
           "quadratic_drive_covariance", "SecondOrderFilteredStates",
           "pruned_transition", "pruned_observe", "pruned_nonlinear"]


class SecondOrderFilteredStates(NamedTuple):
    """What :func:`filter_data_second_order` returns (the reference's
    DataFrame of total paths with ``attrs`` loglik, y1 and y2)."""

    paths: torch.Tensor             # (periods, n_variables) y1 + y2
    y1: torch.Tensor                # (periods, n_variables)
    y2: torch.Tensor                # (periods, n_variables)
    variable_names: list[str]
    loglik: torch.Tensor            # () the UKF log-likelihood


def quadratic_drive_covariance(G_xx, G_xu, G_uu, Sigma1, Q) -> torch.Tensor:
    """Exact covariance (..., n, n) of the pruned quadratic drive
    1/2 G_xx (y1 (x) y1) + G_xu (y1 (x) eps) + 1/2 G_uu (eps (x) eps) for
    y1 ~ N(0, Σ1), eps ~ N(0, Q) independent (Isserlis' theorem):
    1/2 tr(A_i Σ1 A_j Σ1) + Σ G_xu[i] G_xu[j] Σ1 Q + 1/2 tr(C_i Q C_j Q)."""
    AS = G_xx @ Sigma1.unsqueeze(-3)                    # (..., n, n, n)
    cov_A = 0.5 * AS.flatten(-2) @ AS.mT.flatten(-2).mT
    M = Sigma1.unsqueeze(-3) @ G_xu @ Q.mT.unsqueeze(-3)
    cov_B = G_xu.flatten(-2) @ M.flatten(-2).mT
    CQ = G_uu @ Q.unsqueeze(-3)
    cov_C = 0.5 * CQ.flatten(-2) @ CQ.mT.flatten(-2).mT
    return cov_A + cov_B + cov_C


def _so_result(sol: dict) -> SecondOrderResult:
    return SecondOrderResult(sol["G_xx"], sol["G_xu"], sol["G_uu"],
                             sol["g_ss"], sol["so_success"])


def pruned_transition(sol: dict, z: torch.Tensor, eps: torch.Tensor
                      ) -> torch.Tensor:
    """The pruned system's step for the states z (B, S, nz) and shocks eps
    (B, S, q) of every draw of the solution dict ``sol``."""
    n = sol["T"].shape[-1]
    Tt = sol["T"].mT
    y1, y2 = z[..., :n], z[..., n:2 * n]
    pieces = [y1 @ Tt + eps @ sol["R"].mT,
              y2 @ Tt + _second_order_correction(_so_result(sol), y1, eps)]
    if z.shape[-1] > 2 * n:
        pieces += [y1 + y2, z[..., 2 * n:z.shape[-1] - n]]
    return torch.cat(pieces, dim=-1)


def pruned_observe(sol: dict, z: torch.Tensor) -> torch.Tensor:
    """Z [y1 + y2, w_1, ..., w_L] + d for the states z (B, S, nz)."""
    n = sol["T"].shape[-1]
    stack = torch.cat([z[..., :n] + z[..., n:2 * n], z[..., 2 * n:]], dim=-1)
    return stack @ sol["Z"].mT + sol["d"].unsqueeze(-2)


def pruned_nonlinear(sol: dict, y1: torch.Tensor, eps: torch.Tensor
                     ) -> torch.Tensor:
    """The nonlinear part b(y1, eps) = [R eps, quadratic drive, 0] of the
    conditionally linear split z' = A_cl z + b (for ``cl_ukf_loglik``)."""
    nz = sol["A_cl"].shape[-1]
    n = y1.shape[-1]
    quad = _second_order_correction(_so_result(sol), y1, eps)
    return torch.cat([eps @ sol["R"].mT, quad,
                      y1.new_zeros(y1.shape[:-1] + (nz - 2 * n,))], dim=-1)


def _block_diag(blocks: list[torch.Tensor]) -> torch.Tensor:
    """Batched block-diagonal matrix of square blocks (..., m_i, m_i)."""
    sizes = [b.shape[-1] for b in blocks]
    rows = []
    for i, b in enumerate(blocks):
        row = [b if j == i else b.new_zeros(b.shape[:-1] + (m,))
               for j, m in enumerate(sizes)]
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def _solution_fn(ss) -> Callable[[torch.Tensor], dict]:
    """The batched ``U (B, dim) -> dict`` of
    :func:`build_second_order_solution_fn`."""
    model = ss.model
    n = model.functions.n_variables
    L = ss._obs_max_lag
    solve2 = model.second_order_solver(ss.loglin_variables)
    pre_policy, policy, post_policy = ss._solution_pieces(full_state=True)

    @highest_precision()
    def solve_draw(U: torch.Tensor) -> dict:
        ss._check_device(U, "u")
        pre = pre_policy(U.to(torch.float64))
        T, R, solver_ok = policy(pre)
        sol = post_policy(pre, T, R, solver_ok)
        Q = sol["Q"]
        so = solve2(sol["x_ss"], sol["theta_full"], T, R, Q)
        # stationary start of the pruned system (guarded against unstable T)
        T_safe = torch.where(sol["stable"][..., None, None], T,
                             torch.zeros_like(T))
        Sigma1 = solve_discrete_lyapunov(T_safe, R @ Q @ R.mT)
        drive = 0.5 * (so.G_xx * Sigma1.unsqueeze(-3)).sum(dim=(-2, -1)) \
            + 0.5 * (so.G_uu * Q.unsqueeze(-3)).sum(dim=(-2, -1)) \
            + 0.5 * so.g_ss
        eye = torch.eye(n, dtype=T.dtype, device=T.device)
        mu2 = _solve_nan(eye - T_safe, drive[..., None])[..., 0]
        cov_q = quadratic_drive_covariance(so.G_xx, so.G_xu, so.G_uu,
                                           Sigma1, Q)
        Sigma2 = solve_discrete_lyapunov(T_safe, cov_q)
        x0 = torch.cat([torch.zeros_like(mu2)] + [mu2] * (1 + L), dim=-1)
        P0 = _block_diag([Sigma1, Sigma2] + [Sigma1 + Sigma2] * L)
        # the conditionally linear split z' = A_cl z + b(y1, eps)
        blocks = _block_diag([T, T] + [torch.zeros_like(T)] * L)
        if L:
            nz = (2 + L) * n
            shift = T.new_zeros(T.shape[:-2] + (nz, nz))
            shift[..., 2 * n:3 * n, :n] = eye
            shift[..., 2 * n:3 * n, n:2 * n] = eye
            for j in range(L - 1):
                shift[..., (3 + j) * n:(4 + j) * n,
                      (2 + j) * n:(3 + j) * n] = eye
            blocks = blocks + shift
        Z = sol["Z"]
        Z_cl = torch.cat([Z[..., :n], Z[..., :n], Z[..., n:]], dim=-1)
        sol.update(G_xx=so.G_xx, G_xu=so.G_xu, G_uu=so.G_uu, g_ss=so.g_ss,
                   so_success=so.success, x0=x0, P0=P0, mu2=mu2,
                   Sigma1=Sigma1, A_cl=blocks, Z_cl=Z_cl)
        return sol

    return solve_draw


def build_second_order_solution_fn(ss) -> Callable[[torch.Tensor], dict]:
    """``u -> dict`` of the pruned second-order state space: the
    full-state first-order solution dict plus G_xx, G_xu, G_uu, g_ss,
    so_success, the filter's start (x0, P0), mu2, Sigma1 and the
    conditionally linear split (A_cl, Z_cl).  ``u`` is (dim,) or (B, dim)
    on the state space's device; float64 algebra."""
    from .statespace import _one_or_many

    return _one_or_many(_solution_fn(ss))


def _data(ss, data) -> torch.Tensor:
    y = np.asarray(data, dtype=np.float64)
    if y.ndim != 2 or y.shape[1] != len(ss.observed_states):
        raise ValueError(
            f"data must be (periods, {len(ss.observed_states)}), got "
            f"{y.shape}")
    return torch.as_tensor(y, device=ss._device())


def _gate(sol: dict, loglik: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """ss, policy, stability and second-order success, and the flag
    ``ok`` of the filter."""
    return sol["ss_success"] & sol["solver_success"] & sol["stable"] \
        & sol["so_success"] & ok & torch.isfinite(loglik)


def build_logpost_second_order(ss, data, ukf_alpha: float = 1.0,
                               ukf_beta: float = 2.0, ukf_kappa: float = 0.0,
                               jitter: float = 0.0,
                               method: str = "marginalized",
                               remat: bool = True
                               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Differentiable second-order log posterior by the unscented filter,
    ``u (dim,) or (B, dim) -> () or (B,)`` in u's dtype (float64 algebra).

    ``method="marginalized"`` (the default) is the Rao-Blackwellized
    filter (``cl_ukf_loglik``: sigma points over (y1, eps) only, an exact
    Kalman update), ``"full"`` the generic augmented-state UKF.
    ``remat=True`` recomputes each filter step in the backward pass.  Any
    failure (steady state, policy, stability, second-order solve, filter)
    gives -inf."""
    y = _data(ss, data)
    if method not in ("marginalized", "full"):
        raise ValueError(f"method must be 'marginalized' or 'full', "
                         f"got {method!r}")
    solve_draw = _solution_fn(ss)
    n_nl = ss.model.functions.n_variables
    kw = dict(alpha=ukf_alpha, beta=ukf_beta, kappa=ukf_kappa, jitter=jitter,
              remat=remat)
    from .statespace import _one_or_many

    @_one_or_many
    @highest_precision()
    def logpost(U: torch.Tensor) -> torch.Tensor:
        sol = solve_draw(U)
        if method == "marginalized":
            res = cl_ukf_loglik(
                y, sol["A_cl"], lambda y1, e: pruned_nonlinear(sol, y1, e),
                sol["Z_cl"], sol["H"], sol["d"], sol["Q"], sol["x0"],
                sol["P0"], n_nl, **kw)
        else:
            res = ukf_loglik(
                y, lambda z, e: pruned_transition(sol, z, e),
                lambda z: pruned_observe(sol, z), sol["Q"], sol["H"],
                sol["x0"], sol["P0"], **kw)
        ok = _gate(sol, res.loglik, res.success) \
            & torch.isfinite(sol["logprior"])
        out = torch.where(ok, res.loglik + sol["logprior"],
                          torch.full_like(res.loglik, -math.inf))
        return out.to(U.dtype)

    return logpost


@torch.no_grad()
def filter_data_second_order(ss, data, params: dict | None = None,
                             smoother: bool = False
                             ) -> SecondOrderFilteredStates:
    """Unscented-filter (or smooth) ``data`` through the pruned system at
    one parameter point (``params`` by name; the rest at their initial
    value or prior mean).  Returns the total hat-coordinate paths y1 + y2,
    their parts, the variable names and the UKF log-likelihood, on the
    state space's device."""
    if params is None:
        u = ss.initial_position()
    else:
        vals = []
        for p_ in ss.estimated:
            if p_.name in params:
                vals.append(float(params[p_.name]))
            else:
                v = p_.initial if p_.initial is not None else p_.prior.mean()
                vals.append(float(v))
        u = ss.unconstrain(np.asarray(vals))
    sol = {k: v[0] for k, v in _solution_fn(ss)(u[None]).items()}
    y = _data(ss, data)
    res = ukf_smoother(y, lambda z, e: pruned_transition(sol, z, e),
                       lambda z: pruned_observe(sol, z), sol["Q"], sol["H"],
                       sol["x0"], sol["P0"])
    n = ss.model.functions.n_variables
    means = res.smoothed_mean if smoother else res.filtered_mean
    y1, y2 = means[:, :n], means[:, n:2 * n]
    return SecondOrderFilteredStates(y1 + y2, y1, y2,
                                     list(ss.model.functions.variable_names),
                                     res.loglik)


def build_pf_loglik_second_order(ss, data, n_particles: int = 4096,
                                 ess_threshold: float = 0.5) -> Callable:
    """``(u, generator) -> (loglik, success)``: the particle filter's
    unbiased marginal likelihood of the pruned second-order system, for
    ``u`` (dim,) or (B, dim), every draw with its own ``n_particles``
    cloud.  ``generator`` (on the state space's device) draws the start
    cloud's standard normals (B, N, nz), then each period's resampling
    offsets (B) and shock normals (B, N, q).  Not differentiable.
    ``loglik.from_draws(U, init_std, draws)`` runs the same filter on given
    standard normals and the callable ``draws(t) -> (u (B,), eps_std (B,
    N, q))``."""
    y = _data(ss, data)
    solve_draw = _solution_fn(ss)

    @torch.no_grad()
    def run(U: torch.Tensor, init_std: torch.Tensor, draws: Callable):
        sol = solve_draw(U)
        nz = sol["x0"].shape[-1]
        eye = torch.eye(nz, dtype=sol["P0"].dtype, device=sol["P0"].device)
        chol = _chol_nan(sol["P0"] + eye * 1e-12)
        init = sol["x0"].unsqueeze(-2) + init_std @ chol.mT
        res = _particle_filter(y, init,
                               lambda z, e: pruned_transition(sol, z, e),
                               lambda z: pruned_observe(sol, z), sol["Q"],
                               sol["H"], ess_threshold, draws)
        ok = sol["ss_success"] & sol["solver_success"] & sol["stable"] \
            & sol["so_success"] & res.success
        return res.loglik, ok

    def loglik(u: torch.Tensor, generator: torch.Generator):
        ss._check_generator(generator)
        U = u if u.ndim == 2 else u[None]
        B = U.shape[0]
        q = len(ss.model.functions.shock_names)
        nz = (2 + ss._obs_max_lag) * ss.model.functions.n_variables
        kw = dict(generator=generator, dtype=torch.float64, device=U.device)
        init_std = torch.randn((B, n_particles, nz), **kw)

        def draws(_t):
            u_t = torch.rand((B,), **kw)
            return u_t, torch.randn((B, n_particles, q), **kw)

        ll, ok = run(U, init_std, draws)
        return (ll, ok) if u.ndim == 2 else (ll[0], ok[0])

    loglik.from_draws = run
    return loglik
