"""Perturbation-solution diagnostics and prior solvability sweeps.

Mirrors ``geconpy_tpu/stats/perturbation_diagnostics.py``:
``_make_per_draw`` (:37), ``solvability_check`` (:70),
``prior_solvability_check`` (:115), ``make_bk_count_fn`` (:143),
``bk_condition_sweep`` (:183), ``summarize_perturbation_solution`` (:221),
``spectral_radius_sensitivity`` (:243), ``_bk_pencil`` (:265),
``_bk_companion`` (:287), ``eigenvalue_sensitivity`` (:301) and
``check_bk_condition`` (:346).  Each draw's whole pipeline (steady state
-> linearization -> cycle reduction -> norms, or -> the Sims pencil -> the
disk-split count of its roots) runs once, batched over the draws, on the
chosen device (the reference ``vmap``s it).  Where the reference returns a
DataFrame, these return tensors with name lists.  The sweeps' ``mesh``
(a :class:`~geconpy_torch.parallel.Mesh`) splits the draws over its
devices (:func:`~geconpy_torch.parallel.sharded_prior_sweep`, padded to a
multiple of the mesh size); the draws are made on, and the results
returned to, the mesh's first device, in place of ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dists import resolve_priors
from ..models.perturbation import gecon_matrices, spectral_radius
from ..ops.cycle_reduction import cycle_reduction, selection_matrix
from ..ops.lyapunov import amax_abs
from ..ops.precision import highest_precision
from ..ops.tolerances import success_tol
from .sampling import (sample_from_priors, sample_from_priors_qmc,
                       sample_uniform_from_priors)

__all__ = ["check_bk_condition", "solvability_check", "prior_solvability_check",
           "bk_condition_sweep", "make_bk_count_fn",
           "summarize_perturbation_solution", "eigenvalue_sensitivity",
           "spectral_radius_sensitivity", "SolvabilityTable", "BKSweep",
           "PolicyTables", "RadiusSensitivity", "EigenvalueSensitivity"]

_STAGES = ["steady_state", "linearization", "policy_solve", "stability",
           "residual_norms"]

class SolvabilityTable(NamedTuple):
    """What :func:`solvability_check` returns, one entry per draw: the
    reference's frame, its columns as fields."""

    param_names: list[str]
    draws: torch.Tensor             # (n_draws, len(param_names)) the sweep
    steady_state: torch.Tensor      # bool, per stage ...
    linearization: torch.Tensor
    policy_solve: torch.Tensor
    stability: torch.Tensor
    residual_norms: torch.Tensor
    success: torch.Tensor           # bool: every stage passed
    failure_stage: list[str]        # the first stage that failed, or "none"
    spectral_radius: torch.Tensor
    deterministic_norm: torch.Tensor
    stochastic_norm: torch.Tensor


class BKSweep(NamedTuple):
    """What :func:`bk_condition_sweep` returns, one entry per draw."""

    param_names: list[str]
    draws: torch.Tensor             # (n_draws, len(param_names)) the sweep
    n_unstable: torch.Tensor        # int64
    n_forward: torch.Tensor         # int64
    bk_satisfied: torch.Tensor      # bool
    ok: torch.Tensor                # bool: a clean count


class PolicyTables(NamedTuple):
    """gEcon's P/Q/R/S blocks: states_t = P states_{t-1} + Q eps_t,
    jumps_t = R states_{t-1} + S eps_t."""

    P: torch.Tensor                 # (states, states)
    Q: torch.Tensor                 # (states, shocks)
    R: torch.Tensor                 # (jumps, states)
    S: torch.Tensor                 # (jumps, shocks)
    states: list[str]
    jumps: list[str]
    shocks: list[str]


class RadiusSensitivity(NamedTuple):
    """d(spectral radius of T)/d(parameter), per free parameter."""

    d_rho_d_param: torch.Tensor     # (n_params,)
    param_names: list[str]


class EigenvalueSensitivity(NamedTuple):
    """d(Re λ)/dθ, d(Im λ)/dθ and d|λ|/dθ for every eigenvalue of the
    Sims-augmented BK pencil (the reference's frame indexed by (eigenvalue,
    part), one column per free parameter), with the eigenvalues."""

    real: torch.Tensor              # (m, n_params)
    imag: torch.Tensor              # (m, n_params)
    modulus: torch.Tensor           # (m, n_params)
    eigenvalues: torch.Tensor       # (m,) complex, sorted by modulus
    moduli: torch.Tensor            # (m,)
    param_names: list[str]


def _sweep(per_draw, thetas: torch.Tensor, mesh):
    """``per_draw(thetas)``, split over ``mesh`` when one is given."""
    if mesh is None:
        return per_draw(thetas)
    from ..parallel.mesh import sharded_prior_sweep

    return sharded_prior_sweep(per_draw, thetas, mesh, mesh.axis_name)


def _sweep_device(mesh, device):
    return device if mesh is None else mesh.devices[0]


def _sweep_thetas(model, param_draws: dict, device):
    """(names, the swept values (N, len(names)), the full free-parameter
    vectors (N, P)) on ``device``: the unswept parameters stay at their
    calibration."""
    names = list(param_draws)
    free_names = [p.name for p in model.functions.free_params]
    unknown = set(names) - set(free_names)
    if unknown:
        raise ValueError(f"unknown parameters in draws: {sorted(unknown)}")
    device = torch.device(device)
    values = torch.stack([torch.as_tensor(v, dtype=torch.float64).reshape(-1)
                          .to(device) for v in param_draws.values()], dim=1)
    thetas = model.default_theta().to(device).expand(
        values.shape[0], len(free_names)).clone()
    for i, name in enumerate(names):
        thetas[:, free_names.index(name)] = values[:, i]
    return names, values, thetas


def _make_per_draw(model, loglin_variables=True, norm_tol: float = 1e-6):
    """``thetas (N, P) -> dict``: every stage's flag, the spectral radius
    and the residual norms of each draw."""
    linearize = model.linearizer(loglin_variables)
    ss_solver = model.ss_solver

    @torch.no_grad()
    @highest_precision()
    def per_draw(theta):
        sol = ss_solver(theta)
        lin = linearize(sol.x_ss, sol.theta_full)
        A, B, C, D = lin.A, lin.B, lin.C, lin.D
        lin_ok = torch.isfinite(A).all(dim=(-2, -1)) \
            & torch.isfinite(B).all(dim=(-2, -1)) \
            & torch.isfinite(C).all(dim=(-2, -1)) \
            & torch.isfinite(D).all(dim=(-2, -1))
        cr = cycle_reduction(A, B, C)
        R = selection_matrix(B, C, cr.T, D)
        rho = spectral_radius(cr.T)
        stable = torch.isfinite(rho) & (rho < 1.0 + 1e-6)
        det_norm = amax_abs(A + B @ cr.T + C @ cr.T @ cr.T)
        stoch_norm = amax_abs((B + C @ cr.T) @ R + D)
        tol = success_tol(theta.dtype, norm_tol)
        norms_ok = torch.isfinite(det_norm) & (det_norm < tol) \
            & torch.isfinite(stoch_norm) & (stoch_norm < tol)
        return {
            "steady_state": sol.success,
            "linearization": lin_ok,
            "policy_solve": cr.success,
            "stability": stable,
            "residual_norms": norms_ok,
            "spectral_radius": rho,
            "deterministic_norm": det_norm,
            "stochastic_norm": stoch_norm,
        }

    return per_draw


def solvability_check(model, param_draws: dict, loglin_variables=True,
                      mesh=None, *, device: str | torch.device = "cuda"
                      ) -> SolvabilityTable:
    """Run the solve pipeline for every draw; attribute failures to stages.

    ``param_draws`` maps parameter names to 1-D arrays (or tensors) of
    equal length; unspecified parameters stay at calibration.  Runs on
    ``device``; returns the draws, per-stage success flags, the first
    stage that failed and the norms, one entry per draw.  ``mesh`` splits
    the draws over its devices.
    """
    names, values, thetas = _sweep_thetas(model, param_draws,
                                          _sweep_device(mesh, device))
    out = _sweep(_make_per_draw(model, loglin_variables), thetas, mesh)
    flags = torch.stack([out[s] for s in _STAGES], dim=1)
    success = flags.all(dim=1)
    # the first stage that failed
    first_fail = torch.where(success, -1, torch.argmin(flags.to(torch.uint8),
                                                       dim=1))
    return SolvabilityTable(
        names, values, *(out[s] for s in _STAGES), success,
        ["none" if i < 0 else _STAGES[i] for i in first_fail.tolist()],
        out["spectral_radius"], out["deterministic_norm"],
        out["stochastic_norm"])


def prior_solvability_check(model, n_samples: int = 1000, how: str = "mc",
                            seed: int = 0, mesh=None,
                            param_subset: list[str] | None = None, *,
                            device: str | torch.device = "cuda"
                            ) -> SolvabilityTable:
    """Sweep the GCN priors and report where the model is solvable.

    ``how``: ``'mc'`` (prior draws from a ``torch.Generator`` on
    ``device``), ``'qmc'`` (Sobol through the prior inverse CDF),
    ``'uniform'``/``'lhs'``/``'sobol'``/``'halton'`` (space-filling over
    prior HDI boxes); every one is seeded with ``seed``.  ``mesh``
    splits the draws over its devices.
    """
    device = _sweep_device(mesh, device)
    param_priors, _ = resolve_priors(model.primitives.priors,
                                     model.primitives.shock_priors)
    free_names = {p.name for p in model.functions.free_params}
    priors = {k: v for k, v in param_priors.items() if k in free_names}
    if param_subset:
        priors = {k: v for k, v in priors.items() if k in param_subset}
    if not priors:
        raise ValueError("model has no priors on free parameters to sweep")

    if how == "mc":
        draws = sample_from_priors(priors, n_samples, seed, device)
    elif how == "qmc":
        draws = sample_from_priors_qmc(priors, n_samples, seed=seed)
    else:
        draws = sample_uniform_from_priors(priors, n_samples, method=how,
                                           seed=seed)
    return solvability_check(model, draws, mesh=mesh, device=device)


def _bk_pencil(A, B, C, lead_idx):
    """Sims-augmented pencil (g0, g1), batched over the leading dimensions:
    the BK roots are the generalized eigenvalues ``g1 x = lambda g0 x``
    (infinite roots from singular g0 directions); differentiable."""
    n = A.shape[-1]
    k = len(lead_idx)
    m = n + k
    lead = torch.as_tensor(np.asarray(lead_idx), dtype=torch.int64,
                           device=A.device)
    tail = torch.arange(n, m, device=A.device)
    g0 = A.new_zeros(A.shape[:-2] + (m, m))
    g0[..., :n, :n] = -B
    g0[..., :n, n:] = -C[..., :, lead]
    g0[..., tail, lead] = 1.0
    g1 = A.new_zeros(A.shape[:-2] + (m, m))
    g1[..., :n, :n] = A
    g1[..., tail, tail] = 1.0
    return g0, g1


def _bk_companion(A, B, C, lead_idx, eps: float = 1e-7):
    """Sims-augmented transition matrix M = (−Γ0 + εI)⁻¹ Γ1, whose
    eigenvalues are the BK generalized eigenvalues (infinite roots become
    O(1/ε), still counted as unstable); differentiable.  ε = 1e-7 keeps the
    perturbation of the finite roots and their eig error below ~1e-5 in
    float64."""
    g0, g1 = _bk_pencil(A, B, C, lead_idx)
    G0 = g0 + eps * torch.eye(g0.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(G0, g1)


def make_bk_count_fn(model, loglin_variables=True,
                     radius: float = 1.0 + 1e-6, n_iter: int = 30):
    """``thetas (N, P) -> BK count dict``, batched over the draws, with no
    host round trip a draw.

    Per draw: steady state -> linearize -> Sims-augmented pencil ->
    repeated disk split (:func:`~geconpy_torch.ops.qz_disk.count_eigs_inside`)
    counting |lambda| > ``radius`` roots (infinite ones included) against
    the number of forward-looking variables.
    """
    from ..ops.qz_disk import count_eigs_inside

    linearize = model.linearizer(loglin_variables)
    ss_solver = model.ss_solver
    lead_idx = model.lead_var_idx
    n_forward = len(lead_idx)

    @torch.no_grad()
    @highest_precision()
    def per_draw(theta):
        sol = ss_solver(theta)
        lin = linearize(sol.x_ss, sol.theta_full)
        g0, g1 = _bk_pencil(lin.A, lin.B, lin.C, lead_idx)
        n_inside, count_ok = count_eigs_inside(g1, g0, radius=radius,
                                               n_iter=n_iter)
        n_unstable = g0.shape[-1] - n_inside
        lin_ok = torch.isfinite(g0).all(dim=(-2, -1)) \
            & torch.isfinite(g1).all(dim=(-2, -1))
        ok = sol.success & lin_ok & count_ok
        return {
            "n_unstable": n_unstable,
            "n_forward": torch.full_like(n_unstable, n_forward),
            "bk_satisfied": ok & (n_unstable == n_forward),
            "ok": ok,
        }

    return per_draw


def bk_condition_sweep(model, param_draws: dict, loglin_variables=True,
                       mesh=None, *, device: str | torch.device = "cuda"
                       ) -> BKSweep:
    """Per-draw Blanchard-Kahn counts over a parameter sweep, batched on
    ``device``.

    ``param_draws`` maps parameter names to equal-length 1-D arrays
    (unspecified parameters stay at calibration).  Returns, per draw,
    ``n_unstable``, ``n_forward``, ``bk_satisfied`` and an ``ok`` flag
    (False when the steady state failed or a root sits on the unit circle,
    where the count is ill-defined).  Each draw runs 30 complete QRs of
    its pencil.  ``mesh`` splits the draws over its devices.
    """
    names, values, thetas = _sweep_thetas(model, param_draws,
                                          _sweep_device(mesh, device))
    out = _sweep(make_bk_count_fn(model, loglin_variables), thetas, mesh)
    return BKSweep(names, values, out["n_unstable"], out["n_forward"],
                   out["bk_satisfied"], out["ok"])


def summarize_perturbation_solution(solution) -> PolicyTables:
    """gEcon-style P/Q/R/S tables of a ``PolicySolution`` (float64 on its
    device), with the state, jump and shock names."""
    P, Q, R_out, S, state_idx, jump_idx = gecon_matrices(
        solution.T, solution.R, solution.variables)
    names = list(solution.variables)
    dev = solution.T.device
    return PolicyTables(
        *(torch.as_tensor(x, dtype=torch.float64, device=dev)
          for x in (P, Q, R_out, S)),
        [names[i] for i in state_idx], [names[i] for i in jump_idx],
        list(solution.shocks))


def spectral_radius_sensitivity(model, *,
                                device: str | torch.device = "cuda",
                                **updates) -> RadiusSensitivity:
    """d(spectral radius of T)/d(parameter) through the solver adjoints,
    on ``device``: a whole-system stability gradient of the Gelfand proxy
    ||T^32||_F^(1/32)."""
    linearize = model.linearizer(True)

    def rho_of_theta(theta):
        sol = model.ss_solver(theta)
        lin = linearize(sol.x_ss, sol.theta_full)
        cr = cycle_reduction(lin.A, lin.B, lin.C)
        M = cr.T
        for _ in range(5):
            M = M @ M
        return torch.linalg.matrix_norm(M, ord="fro") ** (1.0 / 32.0)

    theta = model.default_theta(**updates).to(device).requires_grad_(True)
    with torch.enable_grad(), highest_precision():
        (grad,) = torch.autograd.grad(rho_of_theta(theta), theta)
    return RadiusSensitivity(grad, [p.name for p in model.functions.free_params])


def eigenvalue_sensitivity(model, *, device: str | torch.device = "cuda",
                           **updates) -> EigenvalueSensitivity:
    """Per-eigenvalue sensitivity table: d(Re λ)/dθ, d(Im λ)/dθ and
    d|λ|/dθ for every eigenvalue of the Sims-augmented BK pencil, exact
    through the differentiable eigenvalues of
    :func:`~geconpy_torch.ops.eig.eig_vals` (one backward pass per real
    and imaginary part, on ``device``)."""
    from ..ops.eig import eig_vals

    linearize = model.linearizer(True)
    lead_idx = model.lead_var_idx

    def lam_parts(theta):
        sol = model.ss_solver(theta)
        lin = linearize(sol.x_ss, sol.theta_full)
        M = _bk_companion(lin.A, lin.B, lin.C, lead_idx)
        re, im = eig_vals(M)
        return torch.stack([re, im])

    theta = model.default_theta(**updates).to(device)
    with highest_precision():
        parts = lam_parts(theta).detach()
        jac = torch.autograd.functional.jacobian(lam_parts, theta)  # (2, m, P)
    re, im = parts[0], parts[1]
    mod = torch.hypot(re, im)
    # chain rule for the modulus, guarding |λ| = 0
    denom = torch.where(mod > 0, mod, torch.ones_like(mod))
    dmod = (re[:, None] * jac[0] + im[:, None] * jac[1]) / denom[:, None]
    return EigenvalueSensitivity(
        jac[0], jac[1], dmod, torch.complex(re, im), mod,
        [p.name for p in model.functions.free_params])


def check_bk_condition(model, verbose: bool = True, *,
                       device: str | torch.device = "cuda", **updates):
    """Standalone facade over :meth:`Model.check_bk_condition`."""
    return model.check_bk_condition(verbose=verbose, device=device, **updates)
