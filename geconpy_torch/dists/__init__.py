"""Torch priors (mirrors ``geconpy_tpu/dists``).

``CompositeDistribution``, ``ast_to_distribution`` and ``resolve_priors``
are the reference's own ``dists/from_ast.py``, loaded through
:func:`geconpy_torch._frontend.frontend` so that they build these classes.
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
    StudentT,
    Truncated,
    TruncatedNormal,
    Uniform,
    get_distribution_class,
    maxent,
)

__all__ = [
    "Beta", "DIST_REGISTRY", "Distribution", "Exponential", "Gamma",
    "HalfNormal", "InverseGamma", "LogNormal", "Normal",
    "StudentT", "Truncated", "TruncatedNormal",
    "Uniform", "get_distribution_class", "maxent",
]
