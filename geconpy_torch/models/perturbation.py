"""First-order (log-)linearization around the steady state, batched.

Mirrors ``geconpy_tpu/models/perturbation.py``: ``make_loglin_mask`` (:44),
``make_linearizer`` (:65: the symbolic ``f_lin_nz`` scatter path, and the
runtime Jacobian of ``f_resid`` when there is no symbolic one, :84-91),
``solve_policy_backward`` (:129), ``spectral_radius`` (:143) and
``gecon_matrices`` (:166, on the host in numpy).

Convention:  A ŷ_{t-1} + B ŷ_t + C ŷ_{t+1} + D ε_t = 0, where ŷ is the log
deviation for log-linearized variables (positive steady state) and the level
deviation otherwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..codegen.model_functions import ModelFunctions
from ..ops.precision import highest_precision

__all__ = ["make_linearizer", "make_loglin_mask", "LinearizationResult",
           "solve_policy_backward", "spectral_radius", "gecon_matrices"]

_ZERO_TOL = 1e-8


class LinearizationResult(NamedTuple):
    A: torch.Tensor              # (..., n, n)
    B: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor              # (..., n, n_shocks)
    loglin_scale: torch.Tensor   # (..., n) column scale actually applied


def make_loglin_mask(mf: ModelFunctions,
                     loglin_variables: list[str] | bool = True) -> np.ndarray:
    """Static per-variable log-linearization request mask (True: log
    deviations for every variable; False: levels; a list selects by name)."""
    n = mf.n_variables
    if loglin_variables is True:
        return np.ones(n, dtype=bool)
    if loglin_variables is False:
        return np.zeros(n, dtype=bool)
    requested = set(loglin_variables)
    unknown = requested - set(mf.variable_names)
    if unknown:
        raise ValueError(f"loglin_variables not in model: {sorted(unknown)}")
    return np.array([v in requested for v in mf.variable_names])


def make_linearizer(
    mf: ModelFunctions,
    loglin_variables: list[str] | bool = True,
) -> Callable[[torch.Tensor, torch.Tensor], LinearizationResult]:
    """Build ``linearize(x_ss (..., n), theta_full (..., P))``.

    The nonzero [A|B|C|D] entries come from the symbolic ``f_lin_nz`` and
    are scattered at static indices.  Without it (``f_lin_nz`` None or
    empty) A, B, C and D are ``torch.func.jacfwd`` of ``f_resid`` in its
    first four arguments, vmapped over the draws; the steady-state
    references (argument 4) are constants of the linearization.  Variables
    whose steady state is near zero or negative fall back to level
    deviations (scale 1), per draw.
    """
    loglin_mask = torch.as_tensor(make_loglin_mask(mf, loglin_variables))
    n = mf.n_variables
    k = mf.n_shocks
    use_symbolic = mf.f_lin_nz is not None and len(mf.lin_rows)
    if use_symbolic:
        flat = torch.as_tensor(mf.lin_rows.astype(np.int64) * (3 * n + k)
                               + mf.lin_cols.astype(np.int64))
    else:
        jac = torch.func.vmap(torch.func.jacfwd(mf.f_resid,
                                                argnums=(0, 1, 2, 3)))

    def linearize(x_ss: torch.Tensor, theta_full: torch.Tensor
                  ) -> LinearizationResult:
        batch = x_ss.shape[:-1]
        eps0 = x_ss.new_zeros(batch + (k,))
        if use_symbolic:
            vals = mf.f_lin_nz(x_ss, x_ss, x_ss, eps0, x_ss, theta_full)
            big = x_ss.new_zeros(batch + (n * (3 * n + k),))
            big[..., flat.to(x_ss.device)] = vals
            big = big.reshape(batch + (n, 3 * n + k))
            A = big[..., :n]
            B = big[..., n:2 * n]
            C = big[..., 2 * n:3 * n]
            D = big[..., 3 * n:]
        else:
            xs = x_ss.reshape(-1, n)
            A, B, C, D = (J.reshape(batch + J.shape[1:]) for J in jac(
                xs, xs, xs, eps0.reshape(-1, k), xs,
                theta_full.reshape(-1, theta_full.shape[-1])))
        mask = loglin_mask.to(x_ss.device)
        scale = torch.where(mask & (x_ss > _ZERO_TOL), x_ss,
                            torch.ones_like(x_ss))
        s = scale.unsqueeze(-2)
        return LinearizationResult(A * s, B * s, C * s, D, scale)

    return linearize


@highest_precision()
def solve_policy_backward(A: torch.Tensor, B: torch.Tensor, D: torch.Tensor):
    """Policy of a purely backward-looking model (no t+1 terms), batched
    over leading dimensions: T = -B⁻¹A, R = -B⁻¹D, and ``success`` when both
    are finite.  One pivoted LU of B for both right-hand sides
    (``torch.linalg.solve_ex``): a singular B gives NaN and
    ``success=False`` in its own draw, never an exception, as
    ``jnp.linalg.solve`` does."""
    from ..ops.cycle_reduction import _solve_nan

    n = A.shape[-1]
    X = -_solve_nan(B, torch.cat([A, D], dim=-1))
    T, R = X[..., :n], X[..., n:]
    success = torch.isfinite(T).all(dim=(-2, -1)) \
        & torch.isfinite(R).all(dim=(-2, -1))
    return T, R, success


@highest_precision()
def spectral_radius(T: torch.Tensor, n_squarings: int = 10) -> torch.Tensor:
    """Largest |eigenvalue| of each ``T[..., :, :]`` via the Gelfand formula
    ρ(T) = lim_k ||T^k||^{1/k}, by repeated squaring with log-rescaling
    (k = 2^n_squarings); batched ``torch.matmul``."""
    norm0 = torch.linalg.matrix_norm(T, ord="fro")
    M = T / torch.clamp(norm0, min=1e-300)[..., None, None]
    logc = torch.log(torch.clamp(norm0, min=1e-300))
    for _ in range(n_squarings):
        M2 = M @ M
        nrm = torch.linalg.matrix_norm(M2, ord="fro")
        logc = 2.0 * logc + torch.log(torch.clamp(nrm, min=1e-300))
        M = M2 / torch.clamp(nrm, min=1e-300)[..., None, None]
    return torch.exp(logc / (2.0 ** n_squarings))


def gecon_matrices(T, R, variables, equations_incidence=None):
    """Split the solution into gEcon's P/Q/R/S blocks, on the host.

    gEcon reports the policy partitioned by state (appears with a lag) vs
    jump variables:  states_t = P states_{t-1} + Q eps_t;
    jumps_t = R' states_{t-1} + S eps_t.  Returns (P, Q, R_out, S,
    state_idx, jump_idx) as numpy arrays; ``T`` and ``R`` may be tensors on
    any device."""
    Tn = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) \
        else np.asarray(T)
    Rn = R.detach().cpu().numpy() if isinstance(R, torch.Tensor) \
        else np.asarray(R)
    n = Tn.shape[0]
    state_idx = np.flatnonzero(np.abs(Tn).max(axis=0) > 1e-10)
    jump_idx = np.setdiff1d(np.arange(n), state_idx)
    P = Tn[np.ix_(state_idx, state_idx)]
    Q = Rn[state_idx, :]
    R_out = Tn[np.ix_(jump_idx, state_idx)]
    S = Rn[jump_idx, :]
    return P, Q, R_out, S, state_idx, jump_idx
