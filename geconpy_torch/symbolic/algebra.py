"""Time-shift algebra over sympy expressions with TimeAwareSymbols.

Copied from ``geconpy_tpu/symbolic/algebra.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with the reference's ``gEconpy/utilities.py`` (step_equation_*
at :67/:76, diff_through_time at :85, eq_to_ss at :42,
flatten_substitution_dict at :265).  The math is standard infinite-horizon
Lagrangian differentiation; the implementation here is written fresh.
"""

from __future__ import annotations

import sympy as sp

from .time_symbol import TimeAwareSymbol

__all__ = [
    "step_equation_forward",
    "step_equation_backward",
    "eq_to_ss",
    "diff_through_time",
    "flatten_substitution_dict",
    "expand_subs_for_all_times",
    "substitute_all_equations",
]


def _shift(expr: sp.Expr, direction: int) -> sp.Expr:
    """Shift every TimeAwareSymbol in ``expr`` by ``direction`` periods.

    Uses a single simultaneous substitution (sympy's ``xreplace``) so chained
    replacements cannot collide (e.g. C_t -> C_tp1 while C_tp1 -> C_tp2).
    """
    atoms = expr.atoms(TimeAwareSymbol) if isinstance(expr, sp.Basic) else set()
    if not atoms:
        return expr
    mapping = {}
    for a in atoms:
        if a.time_index == "ss":
            continue
        mapping[a] = a.set_t(a.time_index + direction)
    return expr.xreplace(mapping)


def step_equation_forward(expr: sp.Expr) -> sp.Expr:
    """t -> t+1 for every time-indexed symbol (steady-state symbols fixed)."""
    return _shift(expr, +1)


def step_equation_backward(expr: sp.Expr) -> sp.Expr:
    """t -> t-1 for every time-indexed symbol."""
    return _shift(expr, -1)


def eq_to_ss(expr: sp.Expr) -> sp.Expr:
    """Map every time-indexed symbol to its steady-state symbol."""
    atoms = expr.atoms(TimeAwareSymbol) if isinstance(expr, sp.Basic) else set()
    if not atoms:
        return expr
    return expr.xreplace({a: a.to_ss() for a in atoms})


def diff_through_time(expr: sp.Expr, dx: TimeAwareSymbol, discount: sp.Expr = sp.S.One) -> sp.Expr:
    """Total derivative of an infinite-horizon objective w.r.t. ``dx``.

    For a per-period Lagrangian term L_t, the infinite sum
    sum_k beta^k L_{t+k} has derivative w.r.t. x at time ``dx.time_index``

        d/dx [ L_t + beta L_{t+1} + beta^2 L_{t+2} + ... ]
        = sum_{k=0}^{K} (prod of stepped discounts) * dL_{t+k}/dx

    Only finitely many terms contribute: stepping the equation forward only
    raises time indices, so once the earliest occurrence of ``dx``'s base
    symbol has moved past ``dx.time_index`` no further derivative is nonzero.
    """
    times = {a.time_index for a in expr.atoms(TimeAwareSymbol)
             if a.base_name == dx.base_name and a.time_index != "ss"}
    if not times:
        return sp.S.Zero

    n_steps = max(0, dx.time_index - min(times))
    total = sp.S.Zero
    current = expr
    current_discount = sp.S.One
    for _ in range(n_steps + 1):
        total = total + current_discount * sp.diff(current, dx)
        current = step_equation_forward(current)
        current_discount = current_discount * discount
        discount = step_equation_forward(discount)
    return total


def flatten_substitution_dict(sub_dict: dict) -> dict:
    """Resolve inter-key references so every value is reference-free.

    Given e.g. ``{w_ss: f(r_ss), r_ss: g(beta)}`` returns
    ``{w_ss: f(g(beta)), r_ss: g(beta)}``.  Cycles raise ValueError.
    """
    keys = set(sub_dict.keys())
    resolved: dict = {}

    def resolve(key, stack):
        if key in resolved:
            return resolved[key]
        if key in stack:
            raise ValueError(f"Cyclic substitution involving {key}")
        val = sub_dict[key]
        if isinstance(val, sp.Basic):
            deps = val.free_symbols & keys
            if deps:
                stack = stack | {key}
                val = val.xreplace({d: resolve(d, stack) for d in deps})
        resolved[key] = val
        return val

    for k in sub_dict:
        resolve(k, frozenset())
    return resolved


def expand_subs_for_all_times(sub_dict: dict) -> dict:
    """Expand each TimeAwareSymbol key to t-1, t, t+1 and ss variants."""
    out = {}
    for lhs, rhs in sub_dict.items():
        if not isinstance(lhs, TimeAwareSymbol):
            out[lhs] = rhs
            continue
        for t in (-1, 0, 1, "ss"):
            shift = (t - lhs.time_index) if isinstance(t, int) and isinstance(lhs.time_index, int) else None
            key = lhs.set_t(t)
            if t == "ss":
                val = eq_to_ss(rhs) if isinstance(rhs, sp.Basic) else rhs
            elif shift is not None and isinstance(rhs, sp.Basic):
                val = _shift(rhs, shift)
            else:
                val = rhs
            out[key] = val
    return out


def substitute_all_equations(eqs, sub_dict: dict):
    """Apply a substitution dict to a list or dict of expressions."""
    if isinstance(eqs, dict):
        return {
            k: (v.subs(sub_dict) if isinstance(v, sp.Basic) else v)
            for k, v in eqs.items()
        }
    return [eq.subs(sub_dict) if isinstance(eq, sp.Basic) else eq for eq in eqs]
