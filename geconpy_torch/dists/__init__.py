"""Torch priors (mirrors ``geconpy_tpu/dists``).

``CompositeDistribution``, ``ast_to_distribution`` and ``resolve_priors``
come from ``from_ast.py``, the port's copy of the reference's, whose
``from .core import ...`` builds these torch classes.
"""

from .core import (
    DIST_REGISTRY,
    Beta,
    Distribution,
    Exponential,
    Gamma,
    HalfNormal,
    InverseGamma,
    LogNormal,
    Normal,
    PartialCorrelation,
    StudentT,
    Truncated,
    TruncatedNormal,
    Uniform,
    get_distribution_class,
    maxent,
)
from .from_ast import CompositeDistribution, ast_to_distribution, resolve_priors

__all__ = [
    "Beta", "CompositeDistribution", "DIST_REGISTRY", "Distribution", "Exponential", "Gamma",
    "HalfNormal", "InverseGamma", "LogNormal", "Normal", "PartialCorrelation",
    "StudentT", "Truncated", "TruncatedNormal",
    "Uniform", "ast_to_distribution", "get_distribution_class", "maxent",
    "resolve_priors",
]
