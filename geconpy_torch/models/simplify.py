"""Model-level symbolic simplifications.

Copied from ``geconpy_tpu/models/simplify.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/model/simplification.py`` (simplify_tryreduce:38,
simplify_constants:117).
"""

from __future__ import annotations

import warnings

import sympy as sp

from ..symbolic import TimeAwareSymbol, expand_subs_for_all_times

__all__ = ["simplify_tryreduce", "simplify_constants"]


def _all_time_combos(var: TimeAwareSymbol) -> list[TimeAwareSymbol]:
    return [var.set_t(t) for t in (-1, 0, 1, "ss")]


def _reduce_variable_list(equations, variables):
    remaining = {
        atom.set_t(0)
        for eq in equations
        for atom in eq.atoms(TimeAwareSymbol)
        if atom.set_t(0) in set(variables)
    }
    reduced = sorted(remaining, key=lambda v: v.name)
    eliminated = sorted(set(variables) - remaining, key=lambda v: v.name)
    return reduced, eliminated


def _warn_not_square(what: str, n_eq: int, n_var: int) -> bool:
    if n_eq != n_var:
        warnings.warn(
            f"{what} skipped: system is not square ({n_eq} equations, {n_var} variables)",
            stacklevel=3,
        )
        return True
    return False


def simplify_tryreduce(
    try_reduce_vars: list[TimeAwareSymbol],
    equations: list[sp.Expr],
    variables: list[TimeAwareSymbol],
) -> tuple[list[sp.Expr], list[TimeAwareSymbol], list[TimeAwareSymbol]]:
    """Drop equations for user-marked variables that are 'self-contained'.

    A variable is safe to remove if it appears in exactly one equation: no
    other equation depends on it, so that equation can be deleted while
    keeping the system square.
    """
    if _warn_not_square("tryreduce simplification", len(equations), len(variables)):
        return equations, variables, []

    col_of: dict[TimeAwareSymbol, int] = {}
    for j, var in enumerate(variables):
        for sym in _all_time_combos(var):
            col_of[sym] = j

    appearance_count = [0] * len(variables)
    for eq in equations:
        cols = {col_of[a] for a in eq.atoms(TimeAwareSymbol) if a in col_of}
        for c in cols:
            appearance_count[c] += 1

    reduce_names = {v.base_name for v in try_reduce_vars}
    to_remove = {
        variables[j]
        for j, count in enumerate(appearance_count)
        if count == 1 and variables[j].base_name in reduce_names
    }
    if not to_remove:
        return equations, variables, []

    removable_syms = {s for v in to_remove for s in _all_time_combos(v)}
    reduced_equations = [
        eq for eq in equations
        if not (eq.atoms(TimeAwareSymbol) & removable_syms)
    ]
    reduced_vars, eliminated = _reduce_variable_list(reduced_equations, variables)
    return reduced_equations, reduced_vars, eliminated


def simplify_constants(
    equations: list[sp.Expr],
    variables: list[TimeAwareSymbol],
) -> tuple[list[sp.Expr], list[TimeAwareSymbol], list[TimeAwareSymbol]]:
    """Fold singleton variables pinned to a constant (``P[] = 1``, ``B[] = 0``)."""
    if _warn_not_square("constant-variable removal", len(equations), len(variables)):
        return equations, variables, []

    sub_dict: dict = {}
    for eq in equations:
        if len(eq.atoms()) <= 3:  # shape: var - const
            vars_in_eq = [a for a in eq.atoms(TimeAwareSymbol)]
            if len(vars_in_eq) != 1:
                continue
            var = vars_in_eq[0]
            sols = sp.solve(eq, var, dict=True)
            if sols:
                sub_dict.update(expand_subs_for_all_times(sols[0]))

    if not sub_dict:
        return equations, variables, []

    reduced_equations = [eq.subs(sub_dict) for eq in equations]
    reduced_equations = [eq for eq in reduced_equations if eq != 0]
    reduced_vars, eliminated = _reduce_variable_list(reduced_equations, variables)
    return reduced_equations, reduced_vars, eliminated
