"""AST -> sympy conversion.

Copied from ``geconpy_tpu/lang/sympify.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/transform/to_sympy.py``
(ASTToSympyConverter:51).  Variables become
:class:`~geconpy_torch.symbolic.TimeAwareSymbol`; parameters become plain
sympy Symbols; assumptions from the GCN ``assumptions`` block are applied to
both.
"""

from __future__ import annotations

import sympy as sp

from ..symbolic import TimeAwareSymbol, merge_assumptions
from . import ast_nodes as A
from .errors import GCNSemanticError, suggest

__all__ = ["SympyConverter", "ast_to_sympy", "equation_to_sympy"]

_FUNCTIONS = {
    "log": sp.log,
    "ln": sp.log,
    "exp": sp.exp,
    "sqrt": sp.sqrt,
    "abs": sp.Abs,
    "sign": sp.sign,
    "sin": sp.sin,
    "cos": sp.cos,
    "tan": sp.tan,
    "sinh": sp.sinh,
    "cosh": sp.cosh,
    "tanh": sp.tanh,
    "atan": sp.atan,
    "asin": sp.asin,
    "acos": sp.acos,
    "max": sp.Max,
    "min": sp.Min,
    "erf": sp.erf,
}


class SympyConverter:
    """Converts GCN AST expressions to sympy with an assumptions registry.

    ``assumptions`` maps base names (variables or parameters) to sympy
    assumption dicts, e.g. ``{"K": {"positive": True}}``.
    """

    def __init__(self, assumptions: dict[str, dict] | None = None):
        self.assumptions = assumptions or {}

    def variable(self, name: str, time_index) -> TimeAwareSymbol:
        """GCN variable reference -> TimeAwareSymbol with assumptions."""
        assume = merge_assumptions(self.assumptions.get(name))
        return TimeAwareSymbol(name, time_index, **assume)

    def parameter(self, name: str) -> sp.Symbol:
        """GCN parameter reference -> plain sympy Symbol with assumptions."""
        assume = merge_assumptions(self.assumptions.get(name))
        return sp.Symbol(name, **assume)

    def convert(self, node: A.Expr) -> sp.Expr:
        """Recursively convert an expression AST node to sympy."""
        if isinstance(node, A.Number):
            val = node.value
            return sp.Integer(int(val)) if float(val).is_integer() else sp.Float(val)
        if isinstance(node, A.Variable):
            idx = node.time_index if node.time_index is not None else 0
            return self.variable(node.name, idx)
        if isinstance(node, A.Parameter):
            return self.parameter(node.name)
        if isinstance(node, A.UnaryOp):
            return -self.convert(node.operand)
        if isinstance(node, A.BinaryOp):
            left = self.convert(node.left)
            right = self.convert(node.right)
            if node.op == "+":
                return left + right
            if node.op == "-":
                return left - right
            if node.op == "*":
                return left * right
            if node.op == "/":
                return left / right
            if node.op == "^":
                return left**right
            raise ValueError(f"unknown operator {node.op!r}")
        if isinstance(node, A.Expectation):
            # Under rational expectations with a first-order solution the
            # expectation operator is the identity on the t+1 system; timing
            # information is carried by the symbols themselves.
            return self.convert(node.operand)
        if isinstance(node, A.FunctionCall):
            fn = _FUNCTIONS.get(node.name.lower())
            if fn is None:
                raise GCNSemanticError(
                    "E017", f"unknown function {node.name!r}", node.loc,
                    suggestions=suggest(node.name.lower(), _FUNCTIONS))
            return fn(*[self.convert(a) for a in node.args])
        raise TypeError(f"cannot convert AST node of type {type(node).__name__}")

    def equation(self, eq: A.GCNEquation) -> sp.Eq:
        """Equation AST -> sympy Eq via :meth:`convert` on both sides."""
        return sp.Eq(self.convert(eq.lhs), self.convert(eq.rhs))

    def residual(self, eq: A.GCNEquation) -> sp.Expr:
        """lhs - rhs as an expression (the residual convention used model-wide)."""
        return self.convert(eq.lhs) - self.convert(eq.rhs)


def ast_to_sympy(node: A.Expr, assumptions: dict[str, dict] | None = None) -> sp.Expr:
    """Expression AST -> sympy with TimeAwareSymbols and GCN assumptions."""
    return SympyConverter(assumptions).convert(node)


def equation_to_sympy(eq: A.GCNEquation, assumptions: dict[str, dict] | None = None) -> sp.Eq:
    """Equation AST -> sympy Eq (lhs == rhs)."""
    return SympyConverter(assumptions).equation(eq)
