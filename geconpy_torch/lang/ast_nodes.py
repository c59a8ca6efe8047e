"""AST node definitions for the GCN language.

Copied from ``geconpy_tpu/lang/ast_nodes.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/ast/nodes.py`` (TimeIndex:9 .. GCNModel:432)
plus the visitor machinery (``parser/ast/visitor.py``).  Frozen dataclasses
carrying :class:`~geconpy_torch.lang.errors.ParseLocation` for diagnostics.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Iterator, Union

from .errors import ParseLocation

__all__ = [
    "Expr", "Number", "Parameter", "Variable", "BinaryOp", "UnaryOp",
    "FunctionCall", "Expectation", "GCNEquation", "GCNDistribution",
    "DistributionArg", "GCNVariableList", "GCNComponent", "GCNBlock",
    "GCNModel", "walk", "transform", "collect", "SS_INDEX",
]

SS_INDEX = "ss"


@dataclass(frozen=True)
class Node:
    loc: ParseLocation | None = field(default=None, kw_only=True, compare=False)


@dataclass(frozen=True)
class Expr(Node):
    pass


@dataclass(frozen=True)
class Number(Expr):
    value: float


@dataclass(frozen=True)
class Parameter(Expr):
    name: str


@dataclass(frozen=True)
class Variable(Expr):
    """``name[idx]`` with idx an int or 'ss' (empty brackets = 0)."""

    name: str
    time_index: Union[int, str] = 0


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / ^
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # -
    operand: Expr


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str
    args: tuple[Expr, ...]


@dataclass(frozen=True)
class Expectation(Expr):
    """``E[][expr]`` — expectation conditional on time-t information."""

    operand: Expr


@dataclass(frozen=True)
class GCNEquation(Node):
    lhs: Expr
    rhs: Expr
    multiplier: str | None = None        # ': lambda[]' suffix
    calibrating_parameter: str | None = None  # '-> alpha' suffix
    tags: tuple[str, ...] = ()           # @exclude / @minimize / @maximize


@dataclass(frozen=True)
class DistributionArg(Node):
    name: str | None       # None for positional (wrapped dists: maxent(Beta(), ...))
    value: Any             # Number | Parameter | GCNDistribution | Expr


@dataclass(frozen=True)
class GCNDistribution(Node):
    """``target ~ Dist(kw=...) = initial`` prior/shock-distribution statement."""

    target: str                          # parameter name or shock name
    target_time_index: Union[int, str, None]  # None => parameter target
    dist_name: str
    args: tuple[DistributionArg, ...]
    initial_value: float | None = None


@dataclass(frozen=True)
class GCNVariableList(Node):
    variables: tuple[Variable, ...]


@dataclass(frozen=True)
class GCNComponent(Node):
    name: str  # definitions/controls/objective/constraints/identities/shocks/calibration
    equations: tuple[GCNEquation, ...] = ()
    variables: tuple[Variable, ...] = ()
    distributions: tuple[GCNDistribution, ...] = ()


@dataclass(frozen=True)
class GCNBlock(Node):
    name: str
    components: tuple[GCNComponent, ...] = ()

    def get(self, component_name: str) -> GCNComponent | None:
        for c in self.components:
            if c.name == component_name:
                return c
        return None


@dataclass(frozen=True)
class GCNModel(Node):
    blocks: tuple[GCNBlock, ...] = ()
    options: dict[str, Any] = field(default_factory=dict)
    tryreduce: tuple[Variable, ...] = ()
    assumptions: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def get_block(self, name: str) -> GCNBlock | None:
        for b in self.blocks:
            if b.name == name:
                return b
        return None


# --- traversal ---------------------------------------------------------------

_CHILD_FIELDS = {
    BinaryOp: ("left", "right"),
    UnaryOp: ("operand",),
    FunctionCall: ("args",),
    Expectation: ("operand",),
}


def walk(node: Expr) -> Iterator[Expr]:
    """Depth-first pre-order over an expression tree."""
    yield node
    fields = _CHILD_FIELDS.get(type(node), ())
    for f in fields:
        child = getattr(node, f)
        if isinstance(child, tuple):
            for c in child:
                yield from walk(c)
        else:
            yield from walk(child)


def collect(node: Expr, node_type) -> list:
    """All sub-nodes of a given type."""
    return [n for n in walk(node) if isinstance(n, node_type)]


def transform(node: Expr, fn) -> Expr:
    """Bottom-up rewrite: ``fn`` is applied to every node after its children."""
    t = type(node)
    fields = _CHILD_FIELDS.get(t, ())
    if fields:
        updates = {}
        for f in fields:
            child = getattr(node, f)
            if isinstance(child, tuple):
                updates[f] = tuple(transform(c, fn) for c in child)
            else:
                updates[f] = transform(child, fn)
        node = replace(node, **updates)
    return fn(node)
