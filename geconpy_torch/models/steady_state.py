"""Steady-state solving for one model, batched over parameter draws.

Mirrors ``geconpy_tpu/models/steady_state.py``: ``SteadyStateSolution``,
``make_steady_state_solver`` (:39-168: the analytic subset evaluated
directly, the remaining unknowns and calibrated parameters solved by a
root finder in the unconstrained space of the GCN's sign assumptions, the
gradient by the implicit function theorem) and ``make_fixed_value_solver``
(:171-283, user-pinned values).  Every function takes ``theta_free`` of
shape (p,) or (..., p); the iterations run over the flattened batch with a
per-draw freeze mask (:mod:`geconpy_torch.ops.newton`), in the caller's
dtype and on its device.  Failures are flags, never exceptions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..codegen.model_functions import ModelFunctions
from ..ops.bijectors import make_bijector
from ..ops.implicit import implicit_root
from ..ops.newton import (RootResult, levenberg_marquardt_solve,
                          newton_solve, root)
from ..ops.tolerances import success_tol

__all__ = ["SteadyStateSolution", "make_steady_state_solver",
           "make_fixed_value_solver", "SS_METHODS"]

#: the ``method`` choices of :func:`make_steady_state_solver`
SS_METHODS = ("hybrid", "newton", "lm", "newton_nm", "chord", "dogleg",
              "gauss_newton")


class SteadyStateSolution(NamedTuple):
    """Batched steady-state result (leading dims = the batch)."""

    x_ss: torch.Tensor          # (..., n_variables)
    theta_full: torch.Tensor    # (..., P) free ++ deterministic ++ calibrated
    success: torch.Tensor       # (...,) bool
    resid_norm: torch.Tensor    # (...,) inf-norm over ALL model equations
    n_iter: torch.Tensor        # (...,) int64 root-finder iterations


class _Index:
    """Static indices, copied to each device once (a host-to-device copy
    inside the iterations would wait for the queue)."""

    def __init__(self, idx):
        self._idx = torch.as_tensor(np.asarray(idx, dtype=np.int64))
        self._cache: dict = {}

    def on(self, like: torch.Tensor) -> torch.Tensor:
        dev = like.device
        if dev not in self._cache:
            self._cache[dev] = self._idx.to(dev)
        return self._cache[dev]


class _Assembly:
    """x_ss from value blocks at static variable indices, without in-place
    writes (so it runs under ``vmap``/``jacfwd``): the blocks are
    concatenated and permuted into variable order."""

    def __init__(self, n: int, blocks: list[np.ndarray]):
        order = np.concatenate([np.asarray(b, dtype=np.int64) for b in blocks])
        assert sorted(order.tolist()) == list(range(n))
        self._perm = _Index(np.argsort(order))

    def __call__(self, *values: torch.Tensor) -> torch.Tensor:
        return torch.cat(values, dim=-1)[..., self._perm.on(values[0])]


def _flat(theta_free: torch.Tensor):
    """(N, p) view of the draws and a function restoring the batch shape."""
    batch = theta_free.shape[:-1]

    def restore(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(batch + t.shape[1:])

    # an explicit draw count: a model with no free parameter has p = 0
    n_draws = math.prod(batch)
    return theta_free.reshape(n_draws, theta_free.shape[-1]), restore


def _hybrid(f, u0, args, tol: float, maxiter: int):
    """Newton on every draw, then Levenberg-Marquardt (``2 * maxiter``)
    from the same start on the draws where Newton failed only.

    The reference runs LM on every draw and keeps its answer where Newton
    failed (``steady_state.py:128-147``).  Its ``n_feval`` is the only
    field that depends on the skipped runs, and it is not part of the
    solution, so ``x``, ``success``, ``norm`` and ``n_iter`` are the
    reference's while every draw that converges saves the LM run.  Returns
    (result, count of draws sent to LM as a tensor).
    """
    res = newton_solve(f, u0, args, tol=tol, maxiter=maxiter)
    failed = ~res.success
    if not bool(failed.any()):
        return res, failed.sum()
    idx = failed.nonzero()[:, 0]
    sub_args = tuple(_select(a, idx) for a in args)
    lm = levenberg_marquardt_solve(f, u0[idx], sub_args, tol=tol,
                                   maxiter=2 * maxiter)

    def put(a, b):
        return a.index_put((idx,), b)

    return RootResult(put(res.x, lm.x), put(res.success, lm.success),
                      put(res.norm, lm.norm), put(res.n_iter, lm.n_iter),
                      put(res.n_feval, lm.n_feval)), failed.sum()


def _select(a, idx):
    if isinstance(a, (tuple, list)):
        return type(a)(_select(t, idx) for t in a)
    return a[idx]


def make_steady_state_solver(
    mf: ModelFunctions,
    method: str = "hybrid",
    tol: float = 1e-8,
    maxiter: int = 500,
    default_guess: float = 0.8,
) -> Callable[..., SteadyStateSolution]:
    """Build ``solve(theta_free (..., p), x0=None) -> SteadyStateSolution``.

    ``x0`` optionally overrides the initial guess of the unknown block, in
    the constrained space, shape ``(n_unknown + n_calibrated,)`` or with
    the draws' batch shape in front.  ``method`` is one of
    :data:`SS_METHODS`; ``"hybrid"`` (Newton, then LM where Newton failed)
    runs LM only on the failed draws (see :func:`_hybrid`), and the count
    of those draws of the last call is ``solve.lm_draws`` (a tensor).
    ``solve.residual(u, theta_fd)`` is the system the root finder solves.
    Success is the root finder's and a residual below
    ``success_tol(dtype, max(100 * tol, 1e-6))`` over *all* equations
    (the analytic path: ``max(tol, 1e-6)``).
    """
    if method not in SS_METHODS:
        raise ValueError(f"unknown steady-state method {method!r}; "
                         f"choose one of {SS_METHODS}")
    n = mf.n_variables
    n_unknown_vars = len(mf.unknown_idx)
    n_calib = len(mf.calibrated_params)
    n_u = n_unknown_vars + n_calib
    if len(mf.eq_unknown_idx) != n_unknown_vars:
        raise ValueError(
            f"steady-state system is not square after substituting the analytic "
            f"solution: {len(mf.eq_unknown_idx)} equations contain unknowns but "
            f"{n_unknown_vars} variables are unsolved. Check the STEADY_STATE block.")
    assemble = _Assembly(n, [mf.known_idx, mf.unknown_idx])
    eq_idx = _Index(mf.eq_unknown_idx)

    def assemble_x(theta_full, unknown_vals):
        known = (mf.f_ss_known(theta_full) if len(mf.known_idx)
                 else theta_full[..., :0])
        return assemble(known, unknown_vals)

    def full_residual_norm(x, theta_full):
        r = mf.f_ss_resid(x, theta_full)
        if mf.f_calib_resid is not None:
            r = torch.cat([r, mf.f_calib_resid(x, theta_full)], dim=-1)
        return torch.amax(r.abs(), dim=-1)

    if n_u == 0:
        def solve_analytic(theta_free: torch.Tensor, x0=None
                           ) -> SteadyStateSolution:
            theta_full = mf.f_params(theta_free)
            x = assemble_x(theta_full, theta_full[..., :0])
            norm = full_residual_norm(x, theta_full)
            success = torch.isfinite(norm) & (
                norm < success_tol(theta_full.dtype, max(tol, 1e-6)))
            return SteadyStateSolution(
                x, theta_full, success, norm,
                torch.zeros(norm.shape, dtype=torch.int64,
                            device=norm.device))

        return solve_analytic

    bijector = mf.bijector

    def split(theta_fd, u):
        vals = bijector.forward(u)
        theta_full = (torch.cat([theta_fd, vals[..., n_unknown_vars:]], -1)
                      if n_calib else theta_fd)
        return assemble_x(theta_full, vals[..., :n_unknown_vars]), theta_full

    def unknown_residual(u, theta_fd):
        x, theta_full = split(theta_fd, u)
        r = mf.f_ss_resid(x, theta_full)[..., eq_idx.on(x)]
        if mf.f_calib_resid is not None:
            r = torch.cat([r, mf.f_calib_resid(x, theta_full)], dim=-1)
        return r

    def run_solver(u0, theta_fd):
        args = (theta_fd,)
        if method == "hybrid":
            res, solve_numeric.lm_draws = _hybrid(unknown_residual, u0, args,
                                                  tol, maxiter)
        else:
            res = root(unknown_residual, u0, args, method=method, tol=tol,
                       maxiter=maxiter)
        return res.x, (res.success, res.n_iter)

    implicit_solve = implicit_root(unknown_residual, run_solver)

    def solve_numeric(theta_free: torch.Tensor, x0=None) -> SteadyStateSolution:
        flat, restore = _flat(theta_free)
        theta_fd = mf.f_params(flat)
        dtype = theta_fd.dtype
        if x0 is None:
            x0_c = theta_fd.new_full((n_u,), default_guess)
        else:
            x0_c = torch.as_tensor(x0, dtype=dtype, device=theta_fd.device)
        x0_c = x0_c.reshape(-1, n_u).expand(theta_fd.shape[0], n_u)
        u0 = bijector.inverse(x0_c).contiguous()
        u_star, (root_ok, n_iter) = implicit_solve(u0, theta_fd)
        x, theta_full = split(theta_fd, u_star)
        norm = full_residual_norm(x, theta_full)
        success = root_ok & torch.isfinite(norm) & (
            norm < success_tol(dtype, max(tol * 100, 1e-6)))
        return SteadyStateSolution(restore(x), restore(theta_full),
                                   restore(success), restore(norm),
                                   restore(n_iter))

    solve_numeric.lm_draws = None
    solve_numeric.residual = unknown_residual
    return solve_numeric


def make_fixed_value_solver(mf: ModelFunctions, fixed_names: list[str],
                            method: str = "hybrid", tol: float = 1e-8,
                            maxiter: int = 500, default_guess: float = 0.8):
    """Steady-state solver with user-pinned values.

    Variables named in ``fixed_names`` are held at caller-supplied values,
    the remaining unknowns are solved (Newton, then LM where it failed,
    whatever ``method``, as in the reference), and success validates the
    FULL system, so an inconsistent pin is a failure.  The equations kept
    are those whose Jacobian, probed on the host at build time at the
    reference's points (``linspace(0.7, 1.3, n)``, ``linspace(0.4, 0.6,
    P)``), involves an unknown.  No gradient flows through this solver.

    Returns ``solve(theta_free (..., p), fixed_values (..., len(fixed_names)))``.
    """
    n = mf.n_variables
    names = mf.variable_names
    unknown_fixed = set(fixed_names) - set(names)
    if unknown_fixed:
        raise KeyError(f"fixed_values name(s) not in model: {sorted(unknown_fixed)}")
    fixed_idx = np.asarray([names.index(f) for f in fixed_names], dtype=np.int64)
    known_set = set(mf.known_idx.tolist()) | set(fixed_idx.tolist())
    unknown_idx = np.asarray([i for i in range(n) if i not in known_set],
                             dtype=np.int64)
    n_calib = len(mf.calibrated_params)

    probe_x = torch.linspace(0.7, 1.3, n, dtype=torch.float64)
    probe_theta = torch.linspace(0.4, 0.6, mf.n_params, dtype=torch.float64)
    J = torch.func.jacfwd(mf.f_ss_resid)(probe_x, probe_theta).numpy()
    incidence = np.abs(J) > 1e-14
    eq_has_unknown = (incidence[:, unknown_idx].any(axis=1) if len(unknown_idx)
                      else np.zeros(incidence.shape[0], dtype=bool))
    eq_sel = np.flatnonzero(eq_has_unknown)
    n_u = len(unknown_idx) + n_calib
    if len(eq_sel) < len(unknown_idx):
        raise ValueError(
            f"fixing {fixed_names} leaves {len(unknown_idx)} unknowns but only "
            f"{len(eq_sel)} equations contain them")
    # keep the system square: the first len(unknown_idx) such equations
    eq_sel_idx = _Index(eq_sel[:len(unknown_idx)])

    # known_idx and fixed_idx may overlap (a pin on an analytic variable):
    # the pin wins, as the reference's later scatter does
    known_only = np.asarray([i for i in mf.known_idx if i not in set(fixed_idx)],
                            dtype=np.int64)
    known_pos = _Index([list(mf.known_idx).index(i) for i in known_only])
    assemble = _Assembly(n, [known_only, fixed_idx, unknown_idx])
    assumption_dicts = [dict(mf.variables[i].assumptions0) for i in unknown_idx]
    assumption_dicts += [dict(p.assumptions0) for p in mf.calibrated_params]
    bijector = make_bijector(assumption_dicts)

    def assemble_full(theta_fd, fixed_vals, u):
        vals = bijector.forward(u)
        theta_full = (torch.cat([theta_fd, vals[..., len(unknown_idx):]], -1)
                      if n_calib else theta_fd)
        known = (mf.f_ss_known(theta_full)[..., known_pos.on(theta_full)]
                 if len(known_only) else theta_full[..., :0])
        x = assemble(known, fixed_vals, vals[..., :len(unknown_idx)])
        return x, theta_full

    def resid(u, args):
        theta_fd, fixed_vals = args
        x, theta_full = assemble_full(theta_fd, fixed_vals, u)
        r = mf.f_ss_resid(x, theta_full)[..., eq_sel_idx.on(x)]
        if mf.f_calib_resid is not None:
            r = torch.cat([r, mf.f_calib_resid(x, theta_full)], dim=-1)
        return r

    def solve(theta_free, fixed_values) -> SteadyStateSolution:
        flat, restore = _flat(theta_free)
        theta_fd = mf.f_params(flat)
        dtype = theta_fd.dtype
        fixed_vals = torch.as_tensor(fixed_values, dtype=dtype,
                                     device=theta_fd.device).reshape(
            -1, len(fixed_idx)).expand(theta_fd.shape[0], len(fixed_idx))
        u0 = bijector.inverse(theta_fd.new_full((theta_fd.shape[0], n_u),
                                                default_guess))
        res, _ = _hybrid(resid, u0, ((theta_fd, fixed_vals),), tol, maxiter)
        x, theta_full = assemble_full(theta_fd, fixed_vals, res.x)
        # the FULL system, with the equations the pins resolved:
        # inconsistent pins fail here
        r_full = mf.f_ss_resid(x, theta_full)
        if mf.f_calib_resid is not None:
            r_full = torch.cat([r_full, mf.f_calib_resid(x, theta_full)], -1)
        norm = torch.amax(r_full.abs(), dim=-1)
        success = res.success & torch.isfinite(norm) & (
            norm < success_tol(dtype, max(tol * 100, 1e-6)))
        return SteadyStateSolution(restore(x), restore(theta_full),
                                   restore(success), restore(norm),
                                   restore(res.n_iter))

    return solve
