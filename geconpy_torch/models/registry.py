"""Block-type dispatch registry.

Copied from ``geconpy_tpu/models/registry.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/model/block/registry.py`` (_REGISTRY:9,
register_block:12, dispatch_block:36): specialized block classes (closed-form
FOCs for common functional forms) register a ``detect`` predicate; the first
match wins, with simpler forms registered before more general ones.
"""

from __future__ import annotations

from typing import Callable, Type

from ..lang import ast_nodes as A
from ..lang.sympify import SympyConverter
from .block import Block

__all__ = ["register_block", "dispatch_block", "registered_block_types"]

_REGISTRY: list[tuple[Callable[[Block], bool], Type[Block]]] = []


def register_block(detect: Callable[[Block], bool], cls: Type[Block]) -> None:
    """Register a specialized Block subclass with its detection predicate."""
    _REGISTRY.append((detect, cls))


def registered_block_types() -> list[Type[Block]]:
    return [cls for _, cls in _REGISTRY]


def dispatch_block(ast_block: A.GCNBlock, converter: SympyConverter) -> Block:
    """Build the most specialized Block subclass whose ``detect`` matches."""
    base = Block.from_ast(ast_block, converter)
    for detect, cls in _REGISTRY:
        try:
            if detect(base):
                specialized = cls.from_ast(ast_block, converter)
                return specialized
        except Exception:
            continue
    return base
