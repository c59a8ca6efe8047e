"""Occasionally-binding constraints: piecewise-linear (OccBin) solutions.

Mirrors ``geconpy_tpu/analysis/occbin.py``: ``OccbinResult`` (:49),
``_lower_condition`` (:58, here through
:func:`~geconpy_torch.codegen.lower.lower_to_torch`), ``_permutation``
(:92), ``_occbin_core`` (:104), ``solve_occbin`` (:175) and ``occbin_irf``
(:297).  Guerrieri & Iacoviello (2015): TWO GCN models over the same
variables and shocks —

- the *reference* regime (constraint slack), which must satisfy
  Blanchard-Kahn and is linearized at its own steady state;
- the *alternative* regime (constraint binding), identical except for the
  equation(s) the constraint replaces (e.g. ``i[] = i_lb;`` instead of the
  Taylor rule), linearized at the SAME reference steady state (its
  residual there is the regime's constant term).

Regime switching is governed by two inequality strings in GCN expression
syntax evaluated on the simulated path (e.g. ``bind="inot[] < i_lb"``,
``relax="inot[] > i_lb"``).

Algorithm: guess the regime sequence over the horizon; a backward pass of
one linear solve a period builds the time-varying policy
``y_t = P_t y_{t-1} + k_t + R_t eps_t`` (terminal condition: the reference
regime's constant policy from cycle reduction); a forward pass simulates;
the conditions re-classify every period; the guess-verify loop iterates to
a fixed point of the regime sequence.  The reference's scans and
``while_loop`` are Python loops here, with one host read a guess-verify
round.  Everything runs in float64 on ``device`` (``"cuda"`` unless the
caller asks for the CPU); paths are tensors with the variable names beside
them, and ``occbin_irf`` returns a dict keyed by shock size where the
reference returns a frame indexed by (size, time).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cycle_reduction import cycle_reduction
from ..ops.precision import highest_precision
from .perfect_foresight import _shock_path

__all__ = ["solve_occbin", "occbin_irf", "OccbinResult", "OccbinIRF"]

_OPS = ["<=", ">=", "<", ">"]


class OccbinResult(NamedTuple):
    trajectory: torch.Tensor   # (periods, n) levels, rows = time 1..H
    regime: np.ndarray         # (periods,) 0 = reference, 1 = alternative
    success: bool
    n_iter: int
    variables: list            # column names of trajectory


class OccbinIRF(NamedTuple):
    deviation: torch.Tensor    # (periods, n) from the reference steady state
    regime: np.ndarray         # (periods,) 0 = reference, 1 = alternative
    variables: list            # column names of deviation


def _lower_condition(cond: str, mf):
    """``"lhs < rhs"`` -> g(y_levels, x_ss, theta_full) with the convention
    g > 0 <=> condition true."""
    from ..codegen.lower import lower_to_torch
    from ..lang.parser import parse_expression
    from ..lang.sympify import ast_to_sympy

    for op in _OPS:
        if op in cond:
            lhs_s, rhs_s = cond.split(op, 1)
            break
    else:
        raise ValueError(
            f"condition {cond!r} must contain one of {_OPS}")
    lhs = ast_to_sympy(parse_expression(lhs_s))
    rhs = ast_to_sympy(parse_expression(rhs_s))
    g = (rhs - lhs) if op in ("<", "<=") else (lhs - rhs)

    now = [v.set_t(0) for v in mf.variables]
    ss_syms = [v.to_ss() for v in mf.variables]
    theta_syms = (mf.free_params + mf.deterministic_params
                  + mf.calibrated_params)
    allowed = set(now) | set(ss_syms) | set(theta_syms)
    unknown = {s for s in g.free_symbols if s not in allowed}
    if unknown:
        raise ValueError(
            f"condition {cond!r} references unknown symbols "
            f"{sorted(str(s) for s in unknown)} (use current-period "
            f"variables v[], v[ss] references, and parameters)")
    return lower_to_torch([g], [("y", now), ("x_ss", ss_syms),
                                ("theta", theta_syms)],
                          name="occbin_condition")


def _permutation(names_from: list[str], names_to: list[str],
                 what: str) -> np.ndarray:
    if set(names_from) != set(names_to):
        only_a = sorted(set(names_from) - set(names_to))
        only_b = sorted(set(names_to) - set(names_from))
        raise ValueError(
            f"occbin regimes must share {what}; only in alternative: "
            f"{only_a}, only in reference: {only_b}")
    return np.asarray([names_from.index(n) for n in names_to])


@highest_precision()
def _occbin_core(y0, eps_path, A, B, C, D, c, T0, x_ss, theta_r,
                 bind_fn, relax_fn, maxiter: int):
    """A/B/C: (2, n, n) stacked regime pencils (cols in reference order);
    D: (2, n, k); c: (2, n) regime constants.  Returns (ys, mask, n_iter,
    converged)."""
    H = eps_path.shape[0]
    n = T0.shape[0]

    def backward(mask):
        sel = mask.to(T0.dtype)[:, None, None]
        A_s = A[0] + sel * (A[1] - A[0])
        B_s = B[0] + sel * (B[1] - B[0])
        C_s = C[0] + sel * (C[1] - C[0])
        D_s = D[0] + sel * (D[1] - D[0])
        c_s = c[0] + sel[:, :, 0] * (c[1] - c[0])
        P_next, k_next = T0, T0.new_zeros(n)
        P, k, R = [None] * H, [None] * H, [None] * H
        for t in range(H - 1, -1, -1):
            M = B_s[t] + C_s[t] @ P_next
            rhs = torch.cat([A_s[t], (C_s[t] @ k_next + c_s[t])[:, None],
                             D_s[t]], dim=1)
            sol = torch.linalg.solve_ex(M, rhs)[0]
            P_next, k_next = -sol[:, :n], -sol[:, n]
            P[t], k[t], R[t] = P_next, k_next, -sol[:, n + 1:]
        return P, k, R

    def forward(seq):
        P, k, R = seq
        y, ys = y0, []
        for t in range(H):
            y = P[t] @ y + k[t] + R[t] @ eps_path[t]
            ys.append(y)
        return torch.stack(ys)

    def classify(mask, ys):
        levels = x_ss[None, :] + ys
        xs = x_ss.expand(levels.shape)
        th = theta_r.expand(levels.shape[:-1] + theta_r.shape)
        gb = bind_fn(levels, xs, th)[:, 0]
        gr = relax_fn(levels, xs, th)[:, 0]
        return torch.where(mask, ~(gr > 0), gb > 0)

    mask0 = torch.zeros(H, dtype=torch.bool, device=T0.device)
    ys = forward(backward(mask0))
    mask, it, done = classify(mask0, ys), 1, False
    # mask is the NEXT guess; loop until it stops changing
    while not done and it < maxiter:
        ys = forward(backward(mask))
        new_mask = classify(mask, ys)
        fixed = torch.all(new_mask == mask)
        finite = torch.all(torch.isfinite(ys))
        mask, it, done = new_mask, it + 1, bool(fixed | ~finite)
    ys = forward(backward(mask))
    settled = torch.all(classify(mask, ys) == mask)
    finite = torch.all(torch.isfinite(ys))
    return ys, mask, it, bool(settled & finite)


def solve_occbin(
    model_ref,
    model_alt,
    bind: str,
    relax: str,
    periods: int = 100,
    shocks: dict[str, np.ndarray] | None = None,
    initial_state: dict[str, float] | None = None,
    maxiter: int = 100,
    *,
    device: str | torch.device = "cuda",
    **updates,
) -> OccbinResult:
    """Piecewise-linear path under an occasionally-binding constraint.

    ``shocks`` maps shock names to realized paths.  As in the OccBin
    toolkit, shocks are unanticipated (MIT) surprises — agents expect zero
    future shocks each period — while the *regime sequence* implied by the
    realized path is anticipated (perfect foresight over regimes enters
    the time-varying backward recursion).  ``initial_state`` sets period-0
    state deviations from the reference steady state.  ``updates`` override
    parameters by name in whichever regime model defines them.  Level
    (not log) linearization is used for both regimes so the switching
    conditions evaluate on level paths.

    ``success`` is False when the regime-sequence fixed point is not
    reached within ``maxiter`` guess-verify rounds (raise ``periods`` if
    the binding spell hits the horizon) or the path is non-finite.

    .. note:: if the binding regime pins a variable to a constant (e.g.
       ``i[] = i_lb;``), build the alternative model with
       ``model_from_gcn(..., simplify_constants_flag=False)`` so the
       variable is not eliminated by the constant-folding pass.
    """
    mf_r, mf_a = model_ref.functions, model_alt.functions
    ref_names = mf_r.variable_names
    n = mf_r.n_variables
    dev = torch.device(device)

    vperm = _permutation(mf_a.variable_names, ref_names, "variables")
    sperm = _permutation(mf_a.shock_names, mf_r.shock_names, "shocks")

    upd_r = {k_: v for k_, v in updates.items()
             if k_ in model_ref.param_names}
    upd_a = {k_: v for k_, v in updates.items()
             if k_ in model_alt.param_names}
    unknown = set(updates) - set(upd_r) - set(upd_a)
    if unknown:
        raise KeyError(f"unknown parameter(s) {sorted(unknown)}")

    with torch.no_grad():
        ss = model_ref.ss_solver(model_ref.default_theta(**upd_r).to(dev))
        if not bool(ss.success):
            raise RuntimeError("reference-regime steady state failed to solve")
        x_ss, theta_r = ss.x_ss, ss.theta_full

        # the alternative regime has no steady state of its own: evaluate at
        # the reference SS.  Alternative-model calibrated params are
        # unsupported.
        if mf_a.calibrated_params:
            raise ValueError("alternative-regime model may not use "
                             "calibrated (`->`) parameters")
        theta_a = mf_a.f_params(model_alt.default_theta(**upd_a).to(dev))

        lin_r = model_ref.linearizer(False)(x_ss, theta_r)
        vcol = torch.as_tensor(vperm, device=dev)
        x_ss_alt = x_ss[vcol]
        lin_a = model_alt.linearizer(False)(x_ss_alt, theta_a)
        # alt matrices have columns in ALT variable order; re-express in ref
        # order
        A1, B1, C1 = lin_a.A[:, vcol], lin_a.B[:, vcol], lin_a.C[:, vcol]
        D1 = lin_a.D[:, torch.as_tensor(sperm, device=dev)]
        eps0 = x_ss.new_zeros(mf_r.n_shocks)
        c1 = mf_a.f_resid(x_ss_alt, x_ss_alt, x_ss_alt, eps0, x_ss_alt,
                          theta_a)

        cr = cycle_reduction(lin_r.A, lin_r.B, lin_r.C)
        if not bool(cr.success):
            raise RuntimeError("reference-regime policy solve failed "
                               "(Blanchard-Kahn must hold in the slack "
                               "regime)")

        bind_fn = _lower_condition(bind, mf_r)
        relax_fn = _lower_condition(relax, mf_r)

        eps_path = _shock_path(mf_r, shocks, periods)
        y0 = np.zeros(n)
        if initial_state:
            for name, val in initial_state.items():
                if name not in ref_names:
                    raise KeyError(
                        f"unknown variable {name!r} in initial_state")
                y0[ref_names.index(name)] = float(val)

        ys, mask, it, ok = _occbin_core(
            torch.as_tensor(y0, dtype=x_ss.dtype, device=dev),
            torch.as_tensor(eps_path, dtype=x_ss.dtype, device=dev),
            torch.stack([lin_r.A, A1]), torch.stack([lin_r.B, B1]),
            torch.stack([lin_r.C, C1]), torch.stack([lin_r.D, D1]),
            torch.stack([torch.zeros_like(c1), c1]), cr.T, x_ss, theta_r,
            bind_fn.fn, relax_fn.fn, maxiter)

    return OccbinResult(x_ss[None, :] + ys,
                        mask.cpu().numpy().astype(np.int8), ok, it,
                        list(ref_names))


def occbin_irf(
    model_ref,
    model_alt,
    bind: str,
    relax: str,
    shock: str,
    sizes=(1.0, -1.0),
    periods: int = 60,
    maxiter: int = 100,
    *,
    device: str | torch.device = "cuda",
    **updates,
) -> dict:
    """Piecewise-linear IRFs: one OccBin path per shock size.

    The classic asymmetry diagnostic — e.g. at the ZLB a contractionary
    shock is amplified while an expansionary one is not, so +1/-1 sd
    responses are no longer mirror images.  Returns ``{size: OccbinIRF}``:
    the path in *deviations from the reference steady state* (comparable
    across sizes) and its regime sequence, for each ``float(size)``.
    """
    out = {}
    x_ss = None
    for size in sizes:
        res = solve_occbin(
            model_ref, model_alt, bind, relax, periods=periods,
            shocks={shock: np.array([float(size)])}, maxiter=maxiter,
            device=device, **updates)
        if not res.success:
            raise RuntimeError(
                f"occbin regime fixed point not reached for size {size}")
        if x_ss is None:
            theta = model_ref.default_theta(
                **{k: v for k, v in updates.items()
                   if k in model_ref.param_names})
            with torch.no_grad():
                x_ss = model_ref.ss_solver(theta.to(device)).x_ss
        out[float(size)] = OccbinIRF(res.trajectory - x_ss[None, :],
                                     res.regime, res.variables)
    return out
