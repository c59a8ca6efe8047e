"""Time-indexed sympy symbols for DSGE model equations.

Copied from ``geconpy_tpu/symbolic/time_symbol.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with the reference's ``gEconpy/classes/time_aware_symbol.py``
(TimeAwareSymbol at :19): a sympy ``Symbol`` that carries a discrete time
index (an ``int`` or the sentinel ``"ss"`` for steady state) alongside its
base name.  The rendered symbol name is injective in ``(base_name,
time_index)`` so sympy's symbol cache and hashing behave correctly without
overriding ``__hash__``.
"""

from __future__ import annotations

import re

import sympy as sp

__all__ = ["TimeAwareSymbol", "DEFAULT_ASSUMPTIONS", "merge_assumptions", "safe_name"]

#: Assumptions applied to model variables unless a GCN ``assumptions`` block
#: overrides them.  Real-valued is the only default; positivity is opt-in.
DEFAULT_ASSUMPTIONS = {"real": True}

_SUFFIX_RE = re.compile(r"^(?P<base>.+?)_(?P<suffix>t(?:[pm]\d+)?|ss)$")

# Python keywords and builtins that cannot be used verbatim as identifiers in
# generated code.
_RESERVED = {
    "lambda", "and", "or", "not", "if", "else", "for", "while", "def",
    "class", "return", "import", "from", "in", "is", "None", "True", "False",
}


def safe_name(name: str) -> str:
    """Make a GCN identifier safe for use in generated Python source."""
    if name in _RESERVED:
        return name + "__kw"
    return name


def merge_assumptions(assumptions: dict | None, defaults: dict | None = None) -> dict:
    """Overlay user assumptions on the defaults (user wins)."""
    out = dict(DEFAULT_ASSUMPTIONS if defaults is None else defaults)
    if assumptions:
        out.update(assumptions)
    return out


def _render_name(base_name: str, time_index: int | str) -> str:
    if time_index == "ss":
        return f"{base_name}_ss"
    if not isinstance(time_index, int):
        raise ValueError(f"time_index must be an int or 'ss', got {time_index!r}")
    if time_index == 0:
        return f"{base_name}_t"
    if time_index > 0:
        return f"{base_name}_tp{time_index}"
    return f"{base_name}_tm{-time_index}"


def _parse_rendered(name: str) -> tuple[str, int | str] | None:
    """Invert :func:`_render_name`; return None if name doesn't match."""
    m = _SUFFIX_RE.match(name)
    if m is None:
        return None
    base, suffix = m.group("base"), m.group("suffix")
    if suffix == "ss":
        return base, "ss"
    if suffix == "t":
        return base, 0
    sign = 1 if suffix[1] == "p" else -1
    return base, sign * int(suffix[2:])


class TimeAwareSymbol(sp.Symbol):
    """A sympy Symbol with a time index.

    ``TimeAwareSymbol("C", 0)`` renders as ``C_t``, index ``-1`` as ``C_tm1``,
    ``+1`` as ``C_tp1`` and ``"ss"`` as ``C_ss``.  The rendered name encodes
    the time index, so symbols with different indices are distinct sympy
    atoms; ``base_name`` and ``time_index`` are recoverable attributes.
    """

    __slots__ = ("base_name", "time_index")

    def __new__(cls, name: str, time_index: int | str | None = None, **assumptions):
        if time_index is None:
            # sympy internals sometimes reconstruct via ``self.func(name)``
            # with the rendered name; recover the parts.
            parsed = _parse_rendered(name)
            if parsed is None:
                raise ValueError(
                    f"TimeAwareSymbol requires a time_index (got bare name {name!r})"
                )
            name, time_index = parsed
        rendered = _render_name(name, time_index)
        obj = super().__new__(cls, rendered, **assumptions)
        obj.base_name = name
        obj.time_index = time_index
        return obj

    def __getnewargs_ex__(self):
        return (self.base_name, self.time_index), self.assumptions0

    # -- time algebra ------------------------------------------------------
    @property
    def safe_name(self) -> str:
        """Identifier-safe rendering (C_t, C_tm1, C_tp1, C_ss)."""
        return safe_name(self.name)

    def set_t(self, t: int | str) -> "TimeAwareSymbol":
        """Same base symbol at time index ``t`` (int or "ss")."""
        return TimeAwareSymbol(self.base_name, t, **self.assumptions0)

    def step_forward(self) -> "TimeAwareSymbol":
        """t -> t+1 (steady-state symbols are fixed points)."""
        if self.time_index == "ss":
            return self
        return self.set_t(self.time_index + 1)

    def step_backward(self) -> "TimeAwareSymbol":
        """t -> t-1 (steady-state symbols are fixed points)."""
        if self.time_index == "ss":
            return self
        return self.set_t(self.time_index - 1)

    def to_ss(self) -> "TimeAwareSymbol":
        """The symbol's steady-state counterpart (time index "ss")."""
        return self.set_t("ss")

    def exit_ss(self) -> "TimeAwareSymbol":
        """Steady-state symbol back to time t."""
        return self.set_t(0)

    def _latex(self, printer=None):
        base = self.base_name.replace("_", r"\_")
        if self.time_index == "ss":
            return rf"{base}_{{ss}}"
        if self.time_index == 0:
            return rf"{base}_{{t}}"
        if self.time_index > 0:
            return rf"{base}_{{t+{self.time_index}}}"
        return rf"{base}_{{t{self.time_index}}}"
