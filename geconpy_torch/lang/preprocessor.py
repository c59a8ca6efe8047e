"""Parsing facade with lazy validation and sympy conversion.

Copied from ``geconpy_tpu/lang/preprocessor.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/preprocessor.py`` (ParseResult:12,
preprocess:98, quick_parse:165) and the notebook HTML rendering of a GCN
file (``parser/html.py`` print_gcn_file:150).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import sympy as sp

from . import ast_nodes as A
from .parser import parse_gcn
from .sympify import SympyConverter
from .validate import full_validation

__all__ = ["ParseResult", "preprocess", "preprocess_file", "quick_parse",
           "print_gcn_html"]


@dataclass
class ParseResult:
    """Parsed GCN source with lazily-computed derived views."""

    source: str
    ast: A.GCNModel
    filename: str | None = None
    _validated: bool = field(default=False, repr=False)

    def validate(self) -> "ParseResult":
        """Run full semantic validation once (raises GCNError on failure)."""
        if not self._validated:
            full_validation(self.ast)
            self._validated = True
        return self

    @cached_property
    def equations(self) -> dict[str, list[sp.Eq]]:
        """Block name -> sympy equations (all components, unprocessed)."""
        from ..models.primitives import _assumptions_registry

        converter = SympyConverter(_assumptions_registry(self.ast))
        out: dict[str, list[sp.Eq]] = {}
        for block in self.ast.blocks:
            eqs = []
            for comp in block.components:
                for eq in comp.equations:
                    eqs.append(sp.Eq(converter.convert(eq.lhs),
                                     converter.convert(eq.rhs)))
            out[block.name] = eqs
        return out

    @cached_property
    def block_names(self) -> list[str]:
        return [b.name for b in self.ast.blocks]

    def to_model(self, **kwargs):
        """Build the full Model from this parse (models.model_from_gcn)."""
        from ..models.model import model_from_gcn

        return model_from_gcn(self.source, **kwargs)

    def _repr_html_(self) -> str:
        return print_gcn_html(self)


def preprocess(source: str, filename: str | None = None,
               validate: bool = True) -> ParseResult:
    """Parse (and optionally validate) GCN source without building a model."""
    result = ParseResult(source, parse_gcn(source, filename), filename)
    if validate:
        result.validate()
    return result


def preprocess_file(path, validate: bool = True) -> ParseResult:
    """Read + parse (+ validate) a .gcn file into a lazy ParseResult."""
    import pathlib

    p = pathlib.Path(path)
    return preprocess(p.read_text(), filename=p.name, validate=validate)


def quick_parse(source: str) -> A.GCNModel:
    """Parse only — no validation, no conversion (fast feedback loops)."""
    return parse_gcn(source)


def print_gcn_html(result: ParseResult) -> str:
    """Collapsible LaTeX HTML rendering of a parsed GCN file."""
    parts = ["<div class='gcn-file'>"]
    for name, eqs in result.equations.items():
        parts.append(f"<details open><summary><b>{name}</b></summary>")
        for eq in eqs:
            parts.append(f"<p>\\[{sp.latex(eq)}\\]</p>")
        parts.append("</details>")
    parts.append("</div>")
    return "\n".join(parts)
