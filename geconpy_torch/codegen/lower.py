"""sympy -> PyTorch lowering.

Mirrors ``geconpy_tpu/codegen/lower.py`` (``lower_to_jax``,
``CompiledFunction``): source-code generation of functions over packed
input arrays, with sympy common-subexpression elimination.

Differences from the JAX lowering, for eager PyTorch:

- Every generated function reads symbol ``i`` of a group as ``g[..., i]``
  and stacks its outputs on ``dim=-1``, so it takes any leading batch
  dimensions: the batched sweep calls it once on ``(B, n)`` inputs where
  JAX used ``vmap``.
- torch functions take tensors, not Python numbers, so every numeric
  subexpression (``log(2)``, ``sqrt(3)``, ...) is folded to a float before
  printing, and outputs that are constants are broadcast to the batch shape.
- The printer is sympy's ``NumPyPrinter`` with module ``torch``; it does not
  depend on ``sympy.printing.pytorch``, whose presence varies by version.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import sympy as sp
import torch
from sympy.printing.numpy import NumPyPrinter, _known_functions_numpy
from sympy.printing.pycode import _print_known_const, _print_known_func

__all__ = ["lower_to_torch", "CompiledFunction"]

_TORCH_FUNCTIONS = {k: "torch." + v for k, v in _known_functions_numpy.items()}
_TORCH_CONSTANTS = {"Exp1": "math.e", "Pi": "math.pi", "NaN": "math.nan",
                    "Infinity": "math.inf"}


class _Printer(NumPyPrinter):
    """NumPyPrinter targeting ``torch``, with float-safe rationals.

    Routes the gamma/error-function family to ``torch.special`` by name
    (as the JAX printer routes it to ``jax.scipy.special``): sympy installs
    ``_print_erf = math.erf``-style printers as class attributes, so each
    one is shadowed by name.  Min/Max/Piecewise/relations go through small
    helpers that accept Python numbers beside tensors.
    """

    _module = "torch"
    _kf = _TORCH_FUNCTIONS
    _kc = _TORCH_CONSTANTS

    def _special(target):
        def _print(self, expr):
            args = ", ".join(self._print(a) for a in expr.args)
            return f"torch.special.{target}({args})"
        return _print

    _print_erf = _special("erf")
    _print_erfc = _special("erfc")
    _print_erfinv = _special("erfinv")
    _print_loggamma = _special("gammaln")
    _print_polygamma = _special("polygamma")
    _print_digamma = _special("digamma")
    del _special

    def _print_gamma(self, expr):
        # torch has no gamma; the GCN models use it on positive arguments
        return f"torch.exp(torch.special.gammaln({self._print(expr.args[0])}))"

    def _print_Rational(self, expr):
        return f"({expr.p}/{expr.q})"

    def _print_Float(self, expr):
        return repr(float(expr))

    def _print_Symbol(self, expr):
        return _mangle(expr)

    def _print_Min(self, expr):
        return "_min(" + ", ".join(self._print(a) for a in expr.args) + ")"

    def _print_Max(self, expr):
        return "_max(" + ", ".join(self._print(a) for a in expr.args) + ")"

    def _print_Relational(self, expr):
        op = {"==": "==", "!=": "!=", "<": "<", "<=": "<=", ">": ">",
              ">=": ">="}[expr.rel_op]
        return f"({self._print(expr.lhs)} {op} {self._print(expr.rhs)})"

    def _print_Piecewise(self, expr):
        out = "math.nan"
        for value, cond in reversed(expr.args):
            if cond == sp.true:
                out = self._print(value)
            else:
                out = f"_where({self._print(cond)}, {self._print(value)}, {out})"
        return out


for _name in _TORCH_FUNCTIONS:
    setattr(_Printer, f"_print_{_name}", _print_known_func)
for _name in _TORCH_CONSTANTS:
    setattr(_Printer, f"_print_{_name}", _print_known_const)


def _mangle(symbol: sp.Symbol) -> str:
    """Unique, keyword-safe local identifier for a sympy symbol."""
    name = symbol.name
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else f"_u{ord(ch):x}_")
    text = "".join(out)
    if not (text[0].isalpha() or text[0] == "_"):
        text = "_" + text
    return "s_" + text


def _fold_numbers(expr: sp.Basic) -> sp.Basic:
    """Replace every numeric non-literal subexpression by its float value."""
    if expr.is_number and not expr.is_Number:
        return sp.Float(sp.N(expr, 17))
    if expr.is_Atom or not expr.args:
        return expr
    args = tuple(_fold_numbers(a) for a in expr.args)
    return expr.func(*args) if args != expr.args else expr


# ---- helpers visible to generated code
def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _min(*xs):
    ref = next(x for x in xs if isinstance(x, torch.Tensor))
    return functools.reduce(torch.minimum, [_as(x, ref) for x in xs])


def _max(*xs):
    ref = next(x for x in xs if isinstance(x, torch.Tensor))
    return functools.reduce(torch.maximum, [_as(x, ref) for x in xs])


def _where(cond, a, b):
    ref = next(x for x in (a, b, cond) if isinstance(x, torch.Tensor))
    if ref.dtype == torch.bool:
        ref = torch.as_tensor(0.0, dtype=torch.get_default_dtype(),
                              device=ref.device)
    return torch.where(torch.as_tensor(cond, device=ref.device),
                       _as(a, ref), _as(b, ref))


def _stack(outs, like):
    """Stack outputs on a new last dim, constants broadcast to the batch."""
    outs = [_as(o, like) for o in outs]
    shape = torch.broadcast_shapes(like.shape[:-1], *(o.shape for o in outs))
    return torch.stack([o.expand(shape) for o in outs], dim=-1)


@dataclass
class CompiledFunction:
    """A generated torch function plus its provenance."""

    fn: Callable
    source: str
    group_names: tuple[str, ...]
    output_shape: tuple[int, ...]

    def __call__(self, *args):
        """Evaluate the function (args follow ``group_names``)."""
        return self.fn(*args)


def lower_to_torch(
    outputs: Sequence[sp.Expr] | sp.Matrix,
    groups: Sequence[tuple[str, Sequence[sp.Symbol]]],
    name: str = "lowered_fn",
    docstring: str | None = None,
) -> CompiledFunction:
    """Generate a torch function computing ``outputs`` from packed inputs.

    ``groups`` are ordered ``(group_name, symbols)`` pairs; the generated
    function takes one tensor per group, of shape ``(..., len(symbols))``,
    and returns ``(..., n_out)`` (or ``(..., r, c)`` for a ``sp.Matrix``),
    where ``...`` is the inputs' common batch shape.  Inputs share one
    dtype and device.
    """
    if isinstance(outputs, sp.Matrix):
        out_shape: tuple[int, ...] = tuple(outputs.shape)
        flat_outputs = list(outputs)
    else:
        flat_outputs = list(outputs)
        out_shape = (len(flat_outputs),)

    flat_outputs = [_fold_numbers(sp.sympify(o)) for o in flat_outputs]

    group_names = tuple(g for g, _ in groups)
    if not group_names:
        raise ValueError("lower_to_torch needs at least one input group")
    lines = [f"def {name}({', '.join(group_names)}):"]
    if docstring:
        lines.append(f'    """{docstring}"""')

    needed: set[sp.Symbol] = set()
    for expr in flat_outputs:
        needed |= expr.free_symbols

    slot_of: dict[sp.Symbol, str] = {}
    for g_name, symbols in groups:
        for i, s in enumerate(symbols):
            slot_of[s] = f"{g_name}[..., {i}]"
            if s in needed:
                lines.append(f"    {_mangle(s)} = {g_name}[..., {i}]")

    missing = needed - set(slot_of)
    if missing:
        raise ValueError(
            f"expressions reference symbols not present in any input group: "
            f"{sorted(str(m) for m in missing)}")

    printer = _Printer()
    replacements, reduced = sp.cse(flat_outputs,
                                   symbols=sp.numbered_symbols("_cse"),
                                   order="none", list=True)
    for lhs, rhs in replacements:
        lines.append(f"    {_mangle(lhs)} = {printer.doprint(rhs)}")
    printed = [printer.doprint(e) for e in reduced]

    like = group_names[0]
    if not printed:
        body = f"{like}.new_zeros({like}.shape[:-1] + (0,))"
    else:
        body = f"_stack([{', '.join(printed)}], {like})"
        if len(out_shape) == 2:
            body += f".reshape({like}.shape[:-1] + {out_shape})"
    lines.append(f"    return {body}")
    source = "\n".join(lines)

    namespace = {"torch": torch, "math": math, "functools": functools,
                 "_stack": _stack, "_min": _min, "_max": _max,
                 "_where": _where}
    exec(compile(source, f"<geconpy_torch:{name}>", "exec"), namespace)

    return CompiledFunction(
        fn=namespace[name],
        source=source,
        group_names=group_names,
        output_shape=out_shape,
    )
