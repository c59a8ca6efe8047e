"""Dynare .mod file export.

Copied from ``geconpy_tpu/analysis/dynare.py`` (``DynarePrinter`` :20,
``make_mod_file`` :47) so that the port needs nothing of the JAX package;
only package names in text differ, and ``make_mod_file`` takes the
keyword-only ``device`` of the steady-state solve it may run (the GPU
unless ``device="cpu"``).  Role parity with ``gEconpy/dynare_convert.py``
(DynareCodePrinter:20, make_mod_file:243): serialize a compiled model to a
runnable Dynare model file (var/varexo/parameters/model/
steady_state_model (or initval)/shocks/stoch_simul blocks) for
cross-validation against Dynare.
"""

from __future__ import annotations

import sympy as sp
from sympy.printing.str import StrPrinter

from ..models.model import Model
from ..symbolic import TimeAwareSymbol

__all__ = ["make_mod_file", "DynarePrinter"]


class DynarePrinter(StrPrinter):
    """sympy -> Dynare expression syntax: x(-1)/x/x(+1), '^' powers."""

    def _print_TimeAwareSymbol(self, expr):
        name = expr.base_name
        t = expr.time_index
        if t == "ss":
            return f"STEADY_STATE({name})"
        if t == 0:
            return name
        return f"{name}({t:+d})"

    def _print_Symbol(self, expr):
        if isinstance(expr, TimeAwareSymbol):
            return self._print_TimeAwareSymbol(expr)
        return expr.name

    def _print_Pow(self, expr, rational=False):
        base = self.parenthesize(expr.base, 75)
        exponent = self.parenthesize(expr.exp, 75)
        return f"{base}^{exponent}"

    def _print_Float(self, expr):
        return repr(float(expr))


def make_mod_file(model: Model, shock_std: float | dict = 0.01,
                  periods: int = 0, order: int = 1,
                  use_steady_state_model: bool = True, *,
                  device: str = "cuda") -> str:
    """Serialize ``model`` as Dynare .mod source; a steady state it needs
    is solved on ``device``."""
    printer = DynarePrinter()
    prims = model.primitives
    mf = model.functions

    var_names = mf.variable_names
    shock_names = mf.shock_names
    params = model.parameters().to_string()
    calib = {}
    if mf.calibrated_params:
        ss_result = model.steady_state(verbose=False, device=device)
        for p in mf.calibrated_params:
            calib[p.name] = float(ss_result[p])

    lines: list[str] = []
    lines.append("// generated by geconpy_torch")
    lines.append("")
    lines.append(f"var {', '.join(var_names)};")
    lines.append(f"varexo {', '.join(shock_names)};")
    all_params = list(params) + list(calib)
    lines.append(f"parameters {', '.join(all_params)};")
    lines.append("")
    for name, value in {**params, **calib}.items():
        lines.append(f"{name} = {value!r};")
    lines.append("")
    lines.append("model;")
    for eq in prims.equations:
        lines.append(f"    {printer.doprint(eq)} = 0;")
    lines.append("end;")
    lines.append("")

    ss_dict = prims.ss_solution_dict
    have_full_ss = mf.has_full_analytic_ss and len(ss_dict)
    if use_steady_state_model and have_full_ss:
        lines.append("steady_state_model;")
        # CSE over the analytic expressions, as the reference does
        # (dynare_convert.py write_steady_state:202)
        keys = [v.to_ss() for v in mf.variables if v.to_ss() in ss_dict]
        exprs = [ss_dict[k] for k in keys]
        replacements, reduced = sp.cse(exprs, symbols=sp.numbered_symbols("tmp_"))
        for lhs, rhs in replacements:
            lines.append(f"    {lhs} = {printer.doprint(rhs)};")
        for key, expr in zip(keys, reduced):
            lines.append(f"    {key.base_name} = {printer.doprint(expr)};")
        lines.append("end;")
    else:
        ss = model.steady_state(verbose=False, device=device).to_string()
        lines.append("initval;")
        for name in var_names:
            lines.append(f"    {name} = {ss[name + '_ss']!r};")
        lines.append("end;")
        lines.append("")
        lines.append("steady;")
    lines.append("")
    lines.append("shocks;")
    for s in shock_names:
        if isinstance(shock_std, dict):
            std = shock_std.get(s, 0.01)
        else:
            std = shock_std
        lines.append(f"    var {s}; stderr {std!r};")
    lines.append("end;")
    lines.append("")
    opts = f"order={order}, irf=40"
    if periods:
        opts += f", periods={periods}"
    lines.append(f"stoch_simul({opts});")
    return "\n".join(lines) + "\n"
