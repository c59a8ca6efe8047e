"""Variable timing classification.

Copied from ``geconpy_tpu/models/timing.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/model/timing.py`` (natural_sort_key:10,
classify_variables_by_timing:43, make_all_variable_time_combinations:96).
"""

from __future__ import annotations

import re

import sympy as sp

from ..symbolic import TimeAwareSymbol

__all__ = [
    "natural_sort_key",
    "make_all_variable_time_combinations",
    "classify_variables_by_timing",
    "structural_incidence",
]

_NUM_RE = re.compile(r"(\d+)")


def natural_sort_key(name: str):
    """Sort 'x2' before 'x10'."""
    return [int(part) if part.isdigit() else part.lower()
            for part in _NUM_RE.split(name)]


def make_all_variable_time_combinations(
    variables: list[TimeAwareSymbol],
) -> tuple[list[TimeAwareSymbol], list[TimeAwareSymbol], list[TimeAwareSymbol]]:
    """(lags, now, leads) symbol lists aligned with ``variables``."""
    lags = [v.set_t(-1) for v in variables]
    now = [v.set_t(0) for v in variables]
    leads = [v.set_t(1) for v in variables]
    return lags, now, leads


def structural_incidence(
    equations: list[sp.Expr], variables: list[TimeAwareSymbol]
):
    """Boolean incidence of each variable's lag/now/lead in each equation.

    Returns dict with 'lag', 'now', 'lead' -> (n_eq, n_var) bool lists.
    These are *structural* (symbolic) facts, fixed at model-build time, so all
    downstream device computations get static shapes.
    """
    import numpy as np

    n_eq, n_var = len(equations), len(variables)
    lag = np.zeros((n_eq, n_var), dtype=bool)
    now = np.zeros((n_eq, n_var), dtype=bool)
    lead = np.zeros((n_eq, n_var), dtype=bool)
    index = {v.base_name: j for j, v in enumerate(variables)}
    for i, eq in enumerate(equations):
        for atom in eq.atoms(TimeAwareSymbol):
            j = index.get(atom.base_name)
            if j is None:
                continue
            if atom.time_index == -1:
                lag[i, j] = True
            elif atom.time_index == 0:
                now[i, j] = True
            elif atom.time_index == 1:
                lead[i, j] = True
    return {"lag": lag, "now": now, "lead": lead}


def classify_variables_by_timing(
    equations: list[sp.Expr], variables: list[TimeAwareSymbol]
) -> dict[str, list[TimeAwareSymbol]]:
    """Partition variables into static / predetermined / mixed / forward.

    - static: appears only at time t
    - predetermined: appears lagged but never led
    - forward: appears led but never lagged
    - mixed: appears both lagged and led
    """
    inc = structural_incidence(equations, variables)
    has_lag = inc["lag"].any(axis=0)
    has_lead = inc["lead"].any(axis=0)
    out: dict[str, list[TimeAwareSymbol]] = {
        "static": [], "predetermined": [], "mixed": [], "forward": []
    }
    for j, v in enumerate(variables):
        if has_lag[j] and has_lead[j]:
            out["mixed"].append(v)
        elif has_lag[j]:
            out["predetermined"].append(v)
        elif has_lead[j]:
            out["forward"].append(v)
        else:
            out["static"].append(v)
    return out
