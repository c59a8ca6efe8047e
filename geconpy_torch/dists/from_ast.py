"""GCN distribution AST -> Distribution objects.

Copied from ``geconpy_tpu/dists/from_ast.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/transform/to_distribution.py`` and
``gEconpy/classes/distributions.py`` (CompositeDistribution:7): prior
statements like ``rho ~ Beta(alpha=2, beta=5) = 0.95`` and wrapped forms
``theta ~ maxent(Gamma(), lower=1, upper=10, mass=0.99)`` become
:class:`~geconpy_torch.dists.core.Distribution` instances; shock statements
like ``eps[] ~ Normal(mu=0, sigma=sigma_eps)`` whose scale references a
hyper-parameter become :class:`CompositeDistribution` links.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..lang import ast_nodes as A
from ..lang.errors import GCNSemanticError, suggest
from .core import (
    DIST_REGISTRY,
    Distribution,
    Truncated,
    get_distribution_class,
    maxent,
)

__all__ = ["CompositeDistribution", "ast_to_distribution", "resolve_priors"]

_ALIAS_KW = {
    "sd": "sigma",
    "scale": "sigma",
    "loc": "mu",
    "mean": "mu",
    "a": "alpha",
    "b": "beta",
    "lam": "lam",
    "rate": "lam",
    "low": "lower",
    "high": "upper",
    "lower": "lower",
    "upper": "upper",
}

_FIELD_REMAP = {
    "Uniform": {"lower": "lower_", "upper": "upper_"},
    "TruncatedNormal": {"lower": "lower_", "upper": "upper_"},
}


@dataclass(frozen=True)
class CompositeDistribution:
    """A shock law whose parameter is itself a model hyper-parameter.

    E.g. ``eps ~ Normal(mu=0, sigma=sigma_eps)`` with ``sigma_eps`` carrying
    its own prior: the shock's standard deviation enters the state-space Q
    matrix through the parameter vector rather than a fixed number.
    """

    dist_name: str
    fixed_kwargs: dict
    param_kwargs: dict  # kw name -> hyper-parameter name

    @property
    def sigma_param(self) -> str | None:
        """The hyper-parameter controlling the scale, if any."""
        for kw in ("sigma", "sd", "scale"):
            if kw in self.param_kwargs:
                return self.param_kwargs[kw]
        return None

    def concretize(self, param_values: dict) -> Distribution:
        """Resolve the hyper-parameter link into a concrete distribution."""
        kwargs = dict(self.fixed_kwargs)
        for kw, pname in self.param_kwargs.items():
            kwargs[kw] = float(param_values[pname])
        cls = get_distribution_class(self.dist_name)
        remap = _FIELD_REMAP.get(cls.name, {})
        kwargs = {remap.get(k, k): v for k, v in kwargs.items()}
        return cls(**kwargs)


def _normalize_kw(name: str) -> str:
    return _ALIAS_KW.get(name.lower(), name.lower())


def _arg_value(value):
    """AST argument -> float, parameter name, or nested distribution marker."""
    if isinstance(value, A.Number):
        return float(value.value)
    if isinstance(value, A.UnaryOp) and isinstance(value.operand, A.Number):
        return -float(value.operand.value) if value.op == "-" else float(value.operand.value)
    if isinstance(value, A.Parameter):
        return value.name
    if isinstance(value, A.GCNDistribution):
        return value
    raise GCNSemanticError(
        "E013", f"distribution arguments must be numbers, parameter names or "
        f"nested distributions, got {value!r}")


def ast_to_distribution(dist_ast: A.GCNDistribution
                        ) -> Distribution | CompositeDistribution:
    """Convert one parsed distribution statement."""
    name = dist_ast.dist_name

    # wrapper forms ---------------------------------------------------------
    if name.lower() == "maxent":
        inner = None
        kw: dict = {}
        for arg in dist_ast.args:
            val = _arg_value(arg.value)
            if arg.name is None:
                if not isinstance(val, A.GCNDistribution):
                    raise GCNSemanticError(
                        "E013", "maxent(...) takes a distribution as its first argument")
                inner = val
            else:
                kw[_normalize_kw(arg.name)] = val
        if inner is None:
            raise GCNSemanticError("E013", "maxent(...) missing inner distribution")
        base = ast_to_distribution(inner)
        if isinstance(base, CompositeDistribution):
            raise GCNSemanticError(
                "E013", "maxent(...) cannot wrap a distribution with "
                "hyper-parameter arguments")
        return maxent(base, lower=float(kw.get("lower", 0.0)),
                      upper=float(kw.get("upper", 1.0)),
                      mass=float(kw.get("mass", 0.99)))

    if name.lower() == "truncated":
        inner = None
        kw = {}
        for arg in dist_ast.args:
            val = _arg_value(arg.value)
            if arg.name is None and isinstance(val, A.GCNDistribution):
                inner = val
            elif arg.name is not None:
                kw[_normalize_kw(arg.name)] = val
        if inner is None:
            raise GCNSemanticError("E013", "Truncated(...) missing inner distribution")
        base = ast_to_distribution(inner)
        if isinstance(base, CompositeDistribution):
            raise GCNSemanticError("E013", "Truncated(...) cannot wrap a "
                                   "hyper-parameterized distribution")
        return Truncated(base, lower=kw.get("lower"), upper=kw.get("upper"))

    # plain distributions -------------------------------------------------------
    try:
        cls = get_distribution_class(name)
    except KeyError:
        raise GCNSemanticError(
            "E012", f"unknown distribution {name!r}", dist_ast.loc,
            suggestions=suggest(name.lower(), DIST_REGISTRY)) from None

    fixed: dict = {}
    param_refs: dict = {}
    for arg in dist_ast.args:
        if arg.name is None:
            raise GCNSemanticError(
                "E013", f"{name}(...) arguments must be keyword form", arg.loc)
        kw_name = _normalize_kw(arg.name)
        val = _arg_value(arg.value)
        if isinstance(val, str):
            param_refs[kw_name] = val
        elif isinstance(val, float):
            fixed[kw_name] = val
        else:
            raise GCNSemanticError(
                "E013", f"nested distribution not allowed as {arg.name}=", arg.loc)

    if param_refs:
        return CompositeDistribution(cls.name, fixed, param_refs)

    remap = _FIELD_REMAP.get(cls.name, {})
    fixed = {remap.get(k, k): v for k, v in fixed.items()}
    # moment parameterization convenience: Beta/Gamma/InverseGamma(mu=, sigma=)
    if {"mu", "sigma"} <= set(fixed) and hasattr(cls, "from_moments") \
            and cls.name in ("Beta", "Gamma", "InverseGamma"):
        return cls.from_moments(fixed["mu"], fixed["sigma"])
    try:
        return cls(**fixed)
    except TypeError as err:
        raise GCNSemanticError(
            "E013", f"invalid arguments for {cls.name}: {err}", dist_ast.loc
        ) from None


def resolve_priors(priors: dict, shock_priors: dict):
    """Convert the primitives' AST prior dicts into distribution objects.

    Returns (param_priors, shock_dists) where param_priors maps parameter
    name -> Distribution and shock_dists maps shock base name ->
    Distribution | CompositeDistribution.
    """
    param_priors = {name: ast_to_distribution(ast) for name, ast in priors.items()}
    shock_dists = {name: ast_to_distribution(ast) for name, ast in shock_priors.items()}
    return param_priors, shock_dists
