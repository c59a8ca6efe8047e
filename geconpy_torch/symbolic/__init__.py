"""``symbolic`` package exports.

Copied from ``geconpy_tpu/symbolic/__init__.py`` so that the port needs nothing of
the JAX package; only package names in text differ.
"""

from .time_symbol import TimeAwareSymbol, DEFAULT_ASSUMPTIONS, merge_assumptions, safe_name
from .containers import SymbolDictionary, SteadyStateResults
from .algebra import (
    step_equation_forward,
    step_equation_backward,
    eq_to_ss,
    diff_through_time,
    flatten_substitution_dict,
    expand_subs_for_all_times,
    substitute_all_equations,
)

__all__ = [
    "TimeAwareSymbol",
    "DEFAULT_ASSUMPTIONS",
    "merge_assumptions",
    "safe_name",
    "SymbolDictionary",
    "SteadyStateResults",
    "step_equation_forward",
    "step_equation_backward",
    "eq_to_ss",
    "diff_through_time",
    "flatten_substitution_dict",
    "expand_subs_for_all_times",
    "substitute_all_equations",
]
