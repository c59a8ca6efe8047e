"""``lang`` package exports.

Copied from ``geconpy_tpu/lang/__init__.py`` so that the port needs nothing of
the JAX package; only package names in text differ.
"""

from . import ast_nodes
from .errors import (
    ERROR_CATALOG,
    ErrorCollector,
    GCNErrorCollection,
    GCNSemanticError,
    GCNSyntaxError,
    ParseLocation,
    format_error,
    suggest,
)
from .expand_time import expand_deep_time_indices
from .lexer import Token, TokenKind, tokenize
from .parser import parse_expression, parse_gcn
from .preprocessor import (
    ParseResult,
    preprocess,
    preprocess_file,
    print_gcn_html,
    quick_parse,
)
from .printer import print_block, print_equation, print_expression, print_model
from .sympify import SympyConverter, ast_to_sympy, equation_to_sympy
from .validate import full_validation, validate_block, validate_model

__all__ = [
    "ast_nodes",
    "ERROR_CATALOG",
    "ErrorCollector",
    "GCNErrorCollection",
    "GCNSemanticError",
    "GCNSyntaxError",
    "ParseLocation",
    "format_error",
    "suggest",
    "expand_deep_time_indices",
    "Token",
    "TokenKind",
    "tokenize",
    "parse_expression",
    "parse_gcn",
    "ParseResult",
    "preprocess",
    "preprocess_file",
    "print_gcn_html",
    "quick_parse",
    "print_block",
    "print_equation",
    "print_expression",
    "print_model",
    "SympyConverter",
    "ast_to_sympy",
    "equation_to_sympy",
    "full_validation",
    "validate_block",
    "validate_model",
]
