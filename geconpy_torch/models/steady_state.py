"""Steady-state solving for one model, batched.

Mirrors ``geconpy_tpu/models/steady_state.py:39``
(``make_steady_state_solver``), fully analytic path only (``:87-97``): the
GCN steady-state block pins every variable and there are no calibrated
parameters, as for the bundled ``sw2007`` and ``rbc_estimation`` models.
The numeric Newton/LM path raises ``NotImplementedError`` (ROADMAP Queue 1
item 3).  Failures are flags, never exceptions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..codegen.model_functions import ModelFunctions
from ..ops.tolerances import success_tol

__all__ = ["SteadyStateSolution", "make_steady_state_solver"]


class SteadyStateSolution(NamedTuple):
    """Batched steady-state result (leading dims = the batch)."""

    x_ss: torch.Tensor          # (..., n_variables)
    theta_full: torch.Tensor    # (..., P) free ++ deterministic ++ calibrated
    success: torch.Tensor       # (...,) bool
    resid_norm: torch.Tensor    # (...,) inf-norm over ALL model equations


def make_steady_state_solver(mf: ModelFunctions
                             ) -> Callable[[torch.Tensor], SteadyStateSolution]:
    """Build ``solve(theta_free (..., p)) -> SteadyStateSolution``; success
    is a residual below ``success_tol(dtype, 1e-6)``, the reference's
    threshold at its default ``tol``."""
    if mf.n_unknowns:
        raise NotImplementedError(
            f"numeric steady state ({mf.n_unknowns} unknowns) is not ported "
            "yet: ROADMAP Queue 1 item 3 (Newton/LM steady state)")
    known_idx = torch.as_tensor(mf.known_idx, dtype=torch.int64)
    n = mf.n_variables

    def solve_analytic(theta_free: torch.Tensor) -> SteadyStateSolution:
        theta_full = mf.f_params(theta_free)
        x = theta_full.new_zeros(theta_full.shape[:-1] + (n,))
        if len(mf.known_idx):
            x[..., known_idx.to(x.device)] = mf.f_ss_known(theta_full)
        norm = torch.amax(torch.abs(mf.f_ss_resid(x, theta_full)), dim=-1)
        success = torch.isfinite(norm) & (
            norm < success_tol(theta_full.dtype, 1e-6))
        return SteadyStateSolution(x, theta_full, success, norm)

    return solve_analytic
