"""Local identification diagnostics (Iskrev 2010).

Mirrors ``geconpy_tpu/stats/identification.py``: ``IdentificationResult``
(:42) and ``iskrev_identification`` (:59).  With the whole
parameters-to-moments pipeline differentiable — steady state, policy solve
(implicit adjoints), Lyapunov, observable autocovariances — Iskrev's
moment-Jacobian rank test is one exact reverse-mode Jacobian:

    m(theta) = [ d; vech Gamma_y(0); vec Gamma_y(1); ...; vec Gamma_y(q) ]
    J = dm / dtheta        (constrained parameter space)

rank(J) < n_params  ==>  theta is locally NON-identified from first and
second moments of the observables; the right null space names the
unidentifiable parameter directions, and per-parameter collinearity
indices (Iskrev's rho_i: how well column i is spanned by the others) show
which parameters are *weakly* identified even at full rank.

J comes from :func:`._optim.jacobian` (one batched forward and backward
pass) on the state space's device; the chain rule to constrained space,
the SVD rank, the null space and the collinearity run on the host in
numpy, as in the reference.  ``summary()`` returns the collinearity and
the null-space membership as arrays beside the names (no pandas).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.lyapunov import solve_discrete_lyapunov
from ..ops.precision import highest_precision
from ._optim import jacobian

__all__ = ["IdentificationResult", "iskrev_identification"]


class IdentificationResult(NamedTuple):
    jacobian: np.ndarray        # (n_moments, n_params) dm/dtheta
    singular_values: np.ndarray
    rank: int
    identified: bool            # rank == n_params
    nullspace: np.ndarray       # (n_params, n_deficient) unidentified dirs
    collinearity: np.ndarray    # (n_params,) R of col_i on span(others)
    param_names: list[str]
    moment_labels: list[str]

    def summary(self) -> dict:
        """``{"param": names, "collinearity": (n,), "in_nullspace": (n,)}``
        (the reference's frame, by column)."""
        in_null = (np.abs(self.nullspace).sum(axis=1) > 1e-6
                   if self.nullspace.size
                   else np.zeros(len(self.param_names), dtype=bool))
        return {"param": list(self.param_names),
                "collinearity": self.collinearity,
                "in_nullspace": in_null}


def iskrev_identification(ss, params: dict | None = None, n_lags: int = 5,
                          rank_tol: float | None = None
                          ) -> IdentificationResult:
    """Iskrev's local identification test at one parameter point.

    Parameters
    ----------
    ss
        a configured :class:`DSGEStateSpace` (the Jacobian runs on its
        device).
    params
        constrained parameter values (defaults to prior means / GCN
        initial values, as in ``filter_data``).
    n_lags
        autocovariance lags included in the moment vector (Iskrev's q;
        first + second moments of the observables).
    rank_tol
        singular-value cutoff relative to the largest (default:
        ``max(J.shape) * eps * 100``).
    """
    solve = ss.build_solution_fn()
    k = len(ss.observed_states)
    tril = np.tril_indices(k)
    tril_t = [torch.as_tensor(t) for t in tril]

    @highest_precision()
    def moments(U: torch.Tensor) -> torch.Tensor:
        sol = solve(U)
        T, R, Q = sol["T_aug"], sol["R_aug"], sol["Q"]
        Z, H, d = sol["Z"], sol["H"], sol["d"]
        Sig = solve_discrete_lyapunov(T, R @ Q @ R.mT)
        G0 = Z @ Sig @ Z.mT + H
        batch = d.shape[:-1]
        parts = [d, G0[..., tril_t[0], tril_t[1]]]
        cur = Sig
        for _ in range(n_lags):
            cur = T @ cur
            parts.append((Z @ cur @ Z.mT).reshape(batch + (k * k,)))
        return torch.cat(parts, dim=-1)

    if params is None:
        u0 = ss.initial_position()
    else:
        vals = []
        for p_ in ss.estimated:
            if p_.name in params:
                vals.append(float(params[p_.name]))
            else:
                v = p_.initial if p_.initial is not None else p_.prior.mean()
                vals.append(float(v))
        u0 = ss.unconstrain(np.asarray(vals))

    n_mom = k + len(tril[0]) + n_lags * k * k
    J_u = jacobian(moments, u0, n_mom).cpu().numpy()

    # chain rule to constrained space: dm/dx_i = dm/du_i / (dx_i/du_i)
    dxdu = []
    for i, p_ in enumerate(ss.estimated):
        _, logjac = p_.prior.from_unconstrained(u0[i].cpu())
        dxdu.append(float(torch.exp(logjac)))
    J = J_u / np.asarray(dxdu)[None, :]

    sv = np.linalg.svd(J, compute_uv=False)
    if rank_tol is None:
        rank_tol = max(J.shape) * np.finfo(J.dtype).eps * 100
    rank = int(np.sum(sv > rank_tol * sv[0]))
    n_params = J.shape[1]
    _, _, Vt = np.linalg.svd(J)
    nullspace = Vt[rank:].T if rank < n_params else np.zeros((n_params, 0))

    # collinearity: for each column, cosine of its angle to the span of the
    # others (1.0 => perfectly explained by other parameters)
    coll = np.zeros(n_params)
    for i in range(n_params):
        ci = J[:, i]
        others = np.delete(J, i, axis=1)
        qo, _ = np.linalg.qr(others)
        proj = qo @ (qo.T @ ci)
        denom = np.linalg.norm(ci)
        coll[i] = np.linalg.norm(proj) / denom if denom > 0 else 1.0

    labels = (["d_" + s for s in ss.observed_states]
              + [f"G0_{i}_{j}" for i, j in zip(*tril)]
              + [f"G{l}_{i}_{j}" for l in range(1, n_lags + 1)
                 for i in range(k) for j in range(k)])
    return IdentificationResult(J, sv, rank, rank == n_params, nullspace,
                                coll, ss.param_labels, labels)
