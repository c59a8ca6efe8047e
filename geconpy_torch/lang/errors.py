"""GCN parse/semantic error system.

Copied from ``geconpy_tpu/lang/errors.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with the reference's ``gEconpy/parser/errors.py`` (ParseLocation
at :93, GCNParseError at :185), ``error_catalog.py`` (coded-error catalog),
``formatting.py`` (caret-annotated terminal rendering) and ``suggestions.py``
(fuzzy did-you-mean).  Implementation written fresh: a compact rustc-style
diagnostic system.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field

__all__ = [
    "ParseLocation",
    "GCNSyntaxError",
    "GCNSemanticError",
    "GCNErrorCollection",
    "ErrorCollector",
    "ERROR_CATALOG",
    "suggest",
    "format_error",
]


@dataclass(frozen=True)
class ParseLocation:
    """Source position of a token or node: 1-based line, 0-based column."""

    line: int
    column: int
    end_column: int | None = None
    source_line: str = ""
    filename: str | None = None

    def caret_line(self) -> str:
        """Spaces + carets underlining this location's source span."""
        end = self.end_column if self.end_column is not None else self.column + 1
        width = max(1, end - self.column)
        return " " * self.column + "^" * width


@dataclass(frozen=True)
class ErrorInfo:
    code: str
    title: str
    explanation: str
    fix: str = ""


# Rustc-style catalog.  E0xx = lexical/grammar, E1xx = semantic/model-level.
_CATALOG_ENTRIES = [
    ErrorInfo("E001", "unexpected character",
              "The lexer found a character that is not part of the GCN language.",
              "Remove or replace the character."),
    ErrorInfo("E002", "unterminated block",
              "A '{' was opened but never closed before end of file.",
              "Add the missing '}' and terminating ';'."),
    ErrorInfo("E003", "missing semicolon",
              "Every statement and block must end with ';'.",
              "Add ';' at the end of the statement."),
    ErrorInfo("E004", "expected expression",
              "An arithmetic expression was expected here.",
              "Check for a dangling operator or empty right-hand side."),
    ErrorInfo("E005", "missing equals sign",
              "An equation requires '=' between its left- and right-hand sides.",
              "Insert '=' between the two expressions."),
    ErrorInfo("E006", "missing left-hand side",
              "An equation starts with '=' but has no left-hand side.",
              "Write an expression before the '='."),
    ErrorInfo("E007", "missing right-hand side",
              "An equation ends after '=' with no right-hand side.",
              "Write an expression after the '='."),
    ErrorInfo("E008", "invalid time index",
              "Variable time indices must be integers or 'ss', e.g. x[-1], x[1], x[ss].",
              "Fix the index inside the square brackets."),
    ErrorInfo("E009", "expected block keyword",
              "Top-level content must be 'block NAME { ... };' or a special block "
              "(options / tryreduce / assumptions).",
              "Wrap the content in a block."),
    ErrorInfo("E010", "unknown component",
              "Model blocks may only contain: definitions, controls, objective, "
              "constraints, identities, shocks, calibration.",
              "Rename or remove the component."),
    ErrorInfo("E011", "missing tilde in distribution",
              "A prior declaration requires '~' between the parameter and the distribution.",
              "Write 'param ~ Distribution(...)'."),
    ErrorInfo("E012", "unknown distribution",
              "The distribution name is not recognized.",
              "Check the spelling; see geconpy_torch.dists for supported names."),
    ErrorInfo("E013", "malformed distribution argument",
              "Distribution arguments must be 'name = value' pairs.",
              "Use keyword arguments, e.g. Beta(alpha=2, beta=5)."),
    ErrorInfo("E014", "empty objective",
              "The objective component must contain exactly one equation.",
              "Add the Bellman/objective equation."),
    ErrorInfo("E015", "invalid Lagrange multiplier",
              "The ': name[]' suffix must name a time-t variable.",
              "Write ': lambda[]' after the constraint."),
    ErrorInfo("E016", "invalid calibrating assignment",
              "Calibrating equations use 'expr = expr -> param;'.",
              "Check the '->' target is a parameter name."),
    ErrorInfo("E017", "unexpected token",
              "The parser found a token that does not fit the grammar here.", ""),
    ErrorInfo("E018", "invalid options entry",
              "Options entries are 'key words = value;'.", ""),
    ErrorInfo("E019", "duplicate block name",
              "Two model blocks share the same name.",
              "Rename one of the blocks."),
    ErrorInfo("E020", "invalid tag",
              "Equation tags are '@exclude', '@minimize' or '@maximize'.", ""),
    ErrorInfo("E101", "undefined variable",
              "A variable is used but never defined by any block's controls, "
              "objective, constraints, identities or shocks.",
              "Define the variable or fix the spelling."),
    ErrorInfo("E102", "undefined parameter",
              "A parameter appears in equations but has no calibration entry.",
              "Add it to a calibration component or remove it."),
    ErrorInfo("E103", "orphan parameter",
              "A parameter is calibrated but never used in any equation.",
              "Remove the calibration entry or use the parameter."),
    ErrorInfo("E104", "duplicate parameter",
              "A parameter is calibrated in more than one block.",
              "Keep a single calibration entry."),
    ErrorInfo("E105", "control not in problem",
              "A control variable does not appear in the block's objective or constraints.",
              "Remove it from controls or use it in the problem."),
    ErrorInfo("E106", "optimization problem incomplete",
              "A block declares controls but no objective or constraints.",
              "Add an objective/constraints, or remove the controls."),
    ErrorInfo("E107", "steady-state block restriction",
              "The STEADY_STATE block may only contain definitions and identities.", ""),
    ErrorInfo("E108", "invalid assumption",
              "Unknown assumption category in the assumptions block.",
              "Use sympy assumption names, e.g. positive / negative / real."),
    ErrorInfo("E109", "duplicate variable in list",
              "The same variable appears twice in this list.", ""),
    ErrorInfo("E110", "shock with time index",
              "Shocks are declared at time t: 'epsilon[]'.", ""),
    ErrorInfo("E111", "objective must define a variable",
              "The left-hand side of the objective must be a single new variable.", ""),
    ErrorInfo("E112", "reduction target not a variable",
              "tryreduce entries must be model variables.", ""),
]

ERROR_CATALOG: dict[str, ErrorInfo] = {e.code: e for e in _CATALOG_ENTRIES}


def suggest(name: str, candidates, n: int = 3) -> list[str]:
    """Fuzzy did-you-mean suggestions."""
    return difflib.get_close_matches(name, list(candidates), n=n, cutoff=0.6)


def format_error(code: str, message: str, loc: ParseLocation | None,
                 suggestions: list[str] | None = None, color: bool = False) -> str:
    """rustc-style error rendering: code + title, caret-annotated source
    line, did-you-mean suggestions, and the catalog fix hint."""
    info = ERROR_CATALOG.get(code)
    title = info.title if info else "error"
    red, bold, reset = ("\x1b[31m", "\x1b[1m", "\x1b[0m") if color else ("", "", "")
    lines = [f"{red}{bold}error[{code}]{reset}{bold}: {title}{reset}"]
    if loc is not None:
        where = f"{loc.filename or '<gcn>'}:{loc.line}:{loc.column + 1}"
        lines.append(f"  --> {where}")
        if loc.source_line:
            lines.append(f"   |")
            lines.append(f"{loc.line:>3}| {loc.source_line}")
            lines.append(f"   | {loc.caret_line()}")
    if message:
        lines.append(f"   = {message}")
    if suggestions:
        lines.append(f"   = help: did you mean {', '.join(repr(s) for s in suggestions)}?")
    if info and info.fix:
        lines.append(f"   = fix: {info.fix}")
    return "\n".join(lines)


class GCNError(Exception):
    """Base for all GCN diagnostics."""

    def __init__(self, code: str, message: str, loc: ParseLocation | None = None,
                 suggestions: list[str] | None = None):
        self.code = code
        self.message = message
        self.loc = loc
        self.suggestions = suggestions or []
        super().__init__(format_error(code, message, loc, self.suggestions))


class GCNSyntaxError(GCNError):
    pass


class GCNSemanticError(GCNError):
    pass


class GCNErrorCollection(Exception):
    """Multiple diagnostics raised together."""

    def __init__(self, errors: list[GCNError]):
        self.errors = errors
        super().__init__(
            f"{len(errors)} error(s):\n\n" + "\n\n".join(str(e) for e in errors)
        )


@dataclass
class ErrorCollector:
    """Accumulates diagnostics during validation; raises at the end."""

    errors: list[GCNError] = field(default_factory=list)

    def add(self, error: GCNError) -> None:
        """Record a diagnostic."""
        self.errors.append(error)

    def semantic(self, code: str, message: str, loc: ParseLocation | None = None,
                 suggestions: list[str] | None = None) -> None:
        """Record a coded semantic error at ``loc``."""
        self.add(GCNSemanticError(code, message, loc, suggestions))

    @property
    def has_errors(self) -> bool:
        """True when any diagnostic has been recorded."""
        return bool(self.errors)

    def raise_if_errors(self) -> None:
        """Raise the single error, or a GCNErrorCollection of all of them."""
        if len(self.errors) == 1:
            raise self.errors[0]
        if self.errors:
            raise GCNErrorCollection(self.errors)
