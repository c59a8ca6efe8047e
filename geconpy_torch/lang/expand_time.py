"""Deep lag/lead expansion.

Copied from ``geconpy_tpu/lang/expand_time.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/transform/expand_time_indices.py``
(DeepTimeIndexCollector:28, DeepTimeIndexReplacer:46): rewrites references
like ``x[-3]`` or ``x[2]`` into chains of auxiliary first-order variables so
the final system only involves t-1, t, t+1.

For a variable ``x`` with maximum lag L > 1, auxiliaries ``x__lag1 ...
x__lag{L-1}`` are introduced with identities

    x__lag1[] = x[-1];  x__lag2[] = x__lag1[-1];  ...

and ``x[-k]`` (k >= 2) is replaced by ``x__lag{k-1}[-1]``.  Leads are
symmetric with ``x__lead{k}[] = x__lead{k-1}[1]`` and ``x[k]`` (k >= 2)
replaced by ``x__lead{k-1}[1]``.
"""

from __future__ import annotations

import sympy as sp

from ..symbolic import TimeAwareSymbol

__all__ = ["expand_deep_time_indices"]


def _aux_lag(base: str, k: int) -> str:
    return f"{base}__lag{k}"


def _aux_lead(base: str, k: int) -> str:
    return f"{base}__lead{k}"


def expand_deep_time_indices(
    equations: list[sp.Expr],
) -> tuple[list[sp.Expr], list[sp.Expr], list[TimeAwareSymbol]]:
    """Rewrite deep lags/leads in sympy equations.

    Returns ``(rewritten_equations, auxiliary_identities, auxiliary_variables)``
    where auxiliary identities are residual expressions (== 0).
    """
    max_lag: dict[str, int] = {}
    max_lead: dict[str, int] = {}
    assumptions: dict[str, dict] = {}
    for eq in equations:
        for atom in eq.atoms(TimeAwareSymbol):
            if atom.time_index == "ss":
                continue
            assumptions.setdefault(atom.base_name, dict(atom.assumptions0))
            if atom.time_index < -1:
                max_lag[atom.base_name] = max(max_lag.get(atom.base_name, 0), -atom.time_index)
            elif atom.time_index > 1:
                max_lead[atom.base_name] = max(max_lead.get(atom.base_name, 0), atom.time_index)

    if not max_lag and not max_lead:
        return list(equations), [], []

    def var(name: str, t, base: str) -> TimeAwareSymbol:
        return TimeAwareSymbol(name, t, **assumptions.get(base, {}))

    aux_identities: list[sp.Expr] = []
    aux_variables: list[TimeAwareSymbol] = []
    replacements: dict[TimeAwareSymbol, TimeAwareSymbol] = {}

    for base, L in sorted(max_lag.items()):
        # x__lag1_t = x_{t-1}; x__lagk_t = x__lag{k-1}_{t-1}
        for k in range(1, L):
            aux_now = var(_aux_lag(base, k), 0, base)
            prev = var(base, -1, base) if k == 1 else var(_aux_lag(base, k - 1), -1, base)
            aux_identities.append(aux_now - prev)
            aux_variables.append(aux_now)
        for eq in equations:
            for atom in eq.atoms(TimeAwareSymbol):
                if atom.base_name == base and isinstance(atom.time_index, int) \
                        and atom.time_index < -1:
                    k = -atom.time_index
                    replacements[atom] = var(_aux_lag(base, k - 1), -1, base)

    for base, L in sorted(max_lead.items()):
        for k in range(1, L):
            aux_now = var(_aux_lead(base, k), 0, base)
            nxt = var(base, 1, base) if k == 1 else var(_aux_lead(base, k - 1), 1, base)
            aux_identities.append(aux_now - nxt)
            aux_variables.append(aux_now)
        for eq in equations:
            for atom in eq.atoms(TimeAwareSymbol):
                if atom.base_name == base and isinstance(atom.time_index, int) \
                        and atom.time_index > 1:
                    k = atom.time_index
                    replacements[atom] = var(_aux_lead(base, k - 1), 1, base)

    rewritten = [eq.xreplace(replacements) for eq in equations]
    return rewritten, aux_identities, aux_variables
