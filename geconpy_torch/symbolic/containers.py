"""Symbol-keyed dictionaries used throughout the framework.

Copied from ``geconpy_tpu/symbolic/containers.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with the reference's ``gEconpy/classes/containers.py``
(SymbolDictionary at :109, SteadyStateResults at :362): a dict that can be
keyed either by sympy symbols or by their string names and converts between
the two representations in bulk, preserving assumptions.
"""

from __future__ import annotations

import sympy as sp

from .time_symbol import TimeAwareSymbol

__all__ = ["SymbolDictionary", "SteadyStateResults"]


def _to_symbol_key(key, assumptions_registry):
    if isinstance(key, sp.Symbol):
        return key
    if not isinstance(key, str):
        raise KeyError(f"SymbolDictionary keys must be str or sympy Symbol, got {type(key)}")
    assumptions = assumptions_registry.get(key, {})
    # Detect time-aware rendered names (C_t, C_tm1, C_ss, ...)
    from .time_symbol import _parse_rendered

    parsed = _parse_rendered(key)
    if parsed is not None:
        return TimeAwareSymbol(parsed[0], parsed[1], **assumptions)
    return sp.Symbol(key, **assumptions)


class SymbolDictionary(dict):
    """Dict keyed by sympy symbols or their string names.

    Bulk conversions return new dictionaries:

    - :meth:`to_sympy` / :meth:`to_string` — switch key representation,
      remembering symbol assumptions across round trips.
    - :meth:`to_ss` / :meth:`step_forward` / :meth:`step_backward` — apply
      time algebra to every :class:`TimeAwareSymbol` key.
    - :meth:`sort_keys` — natural-sorted copy.
    - :meth:`values_to_float` — cast values to Python floats.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._assumptions: dict[str, dict] = {}
        for key in self:
            if isinstance(key, sp.Symbol):
                self._assumptions[key.name] = dict(key.assumptions0)

    # -- internal ----------------------------------------------------------
    def _copy_with(self, items) -> "SymbolDictionary":
        new = SymbolDictionary(items)
        new._assumptions = dict(self._assumptions)
        return new

    def copy(self) -> "SymbolDictionary":
        return self._copy_with(dict(self))

    def __or__(self, other):
        merged = dict(self) | dict(other)
        out = self._copy_with(merged)
        if isinstance(other, SymbolDictionary):
            out._assumptions.update(other._assumptions)
        return out

    # -- mixed-representation lookup -----------------------------------------
    def __getitem__(self, key):
        try:
            return super().__getitem__(key)
        except KeyError:
            alt = self._alternate_key(key)
            if alt is not None:
                return super().__getitem__(alt)
            raise

    def __contains__(self, key):
        if super().__contains__(key):
            return True
        alt = self._alternate_key(key)
        return alt is not None and super().__contains__(alt)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def _alternate_key(self, key):
        """The same key in the other representation, if present."""
        if isinstance(key, sp.Symbol):
            name = key.name
            return name if super().__contains__(name) else None
        if isinstance(key, str):
            for k in self:
                if isinstance(k, sp.Symbol) and k.name == key:
                    return k
        return None

    # -- key-space conversions ----------------------------------------------
    def is_sympy(self) -> bool:
        """True when every key is a sympy Symbol (vs plain string keys)."""
        return all(isinstance(k, sp.Symbol) for k in self)

    def to_sympy(self) -> "SymbolDictionary":
        """Convert string keys to sympy symbols, restoring stored assumptions."""
        items = {}
        for k, v in self.items():
            items[_to_symbol_key(k, self._assumptions)] = v
        out = self._copy_with(items)
        for k in items:
            out._assumptions[k.name] = dict(k.assumptions0)
        return out

    def to_string(self) -> "SymbolDictionary":
        """Convert symbol keys to their string names, remembering assumptions."""
        items = {}
        for k, v in self.items():
            if isinstance(k, sp.Symbol):
                self._assumptions.setdefault(k.name, dict(k.assumptions0))
                items[k.name] = v
            else:
                items[k] = v
        return self._copy_with(items)

    # -- time algebra --------------------------------------------------------
    def _map_keys(self, fn) -> "SymbolDictionary":
        items = {}
        for k, v in self.items():
            if isinstance(k, TimeAwareSymbol):
                items[fn(k)] = v
            else:
                items[k] = v
        return self._copy_with(items)

    def to_ss(self) -> "SymbolDictionary":
        """Shift every TimeAwareSymbol key to its steady-state form."""
        return self._map_keys(lambda k: k.to_ss())

    def step_forward(self) -> "SymbolDictionary":
        """Shift every TimeAwareSymbol key one period forward (t -> t+1)."""
        return self._map_keys(lambda k: k.step_forward())

    def step_backward(self) -> "SymbolDictionary":
        """Shift every TimeAwareSymbol key one period back (t -> t-1)."""
        return self._map_keys(lambda k: k.step_backward())

    # -- misc ---------------------------------------------------------------
    def sort_keys(self) -> "SymbolDictionary":
        """Return a copy with keys in natural sort order (x2 before x10)."""
        from ..models.timing import natural_sort_key

        def keyname(k):
            return natural_sort_key(k.name if isinstance(k, sp.Symbol) else str(k))

        return self._copy_with({k: self[k] for k in sorted(self, key=keyname)})

    def values_to_float(self) -> "SymbolDictionary":
        """Coerce every value to a python float (post numeric solve)."""
        return self._copy_with({k: float(v) for k, v in self.items()})

    def __reduce__(self):
        return (_rebuild_symbol_dictionary, (dict(self), self._assumptions))


def _rebuild_symbol_dictionary(items, assumptions):
    out = SymbolDictionary(items)
    out._assumptions = assumptions
    return out


class SteadyStateResults(SymbolDictionary):
    """Steady-state solution with a success flag and residual norm."""

    def __init__(self, *args, success: bool = True, resid_norm: float | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.success = success
        self.resid_norm = resid_norm

    def __repr__(self):
        status = "converged" if self.success else "FAILED"
        body = ", ".join(
            f"{k.name if isinstance(k, sp.Symbol) else k}={float(v):.6g}"
            for k, v in self.items()
        )
        return f"SteadyStateResults({status}; {body})"

    def __reduce__(self):
        return (
            _rebuild_ss_results,
            (dict(self), self._assumptions, self.success, self.resid_norm),
        )


def _rebuild_ss_results(items, assumptions, success, resid_norm):
    out = SteadyStateResults(items, success=success, resid_norm=resid_norm)
    out._assumptions = assumptions
    return out
