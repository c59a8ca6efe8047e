"""Human-readable model reports and notebook rendering.

Copied from ``geconpy_tpu/utils/reporting.py`` so that the port needs
nothing of the JAX package: ``build_report`` (:16), ``print_steady_state``
(:68), ``block_to_html`` (:84), ``model_to_html`` (:119) and
``print_gcn_file`` (:129) are sympy and strings, and only package names in
text differ.  Role parity with the reference's build report
(``gEconpy/model/build.py:748``), ``print_steady_state``
(``model/steady_state.py:359``) and the HTML/LaTeX pretty-printing
(``parser/html.py``, ``model/block/basic.py:754``).
"""

from __future__ import annotations

import sympy as sp

__all__ = ["build_report", "print_steady_state", "model_to_html",
           "block_to_html", "print_gcn_file"]


def build_report(model) -> str:
    """Summary of what was compiled: counts, reductions, SS status."""
    prims = model.primitives
    mf = model.functions
    lines = ["Model Building Complete.", ""]
    n_eq, n_var = len(prims.equations), len(prims.variables)
    lines.append(f"Found:")
    lines.append(f"    {n_eq} equations")
    lines.append(f"    {n_var} variables")
    timing = model.variable_timing
    lines.append(f"        {len(timing['static'])} static, "
                 f"{len(timing['predetermined'])} predetermined, "
                 f"{len(timing['mixed'])} mixed, "
                 f"{len(timing['forward'])} forward-looking")
    lines.append(f"    {mf.n_shocks} stochastic shock"
                 f"{'s' if mf.n_shocks != 1 else ''}")
    priors = set(prims.priors) | set(prims.shock_priors)
    lines.append(f"        {len(prims.shock_priors)} shock law(s) declared")
    lines.append(f"    {len(mf.free_params)} free parameters "
                 f"({len(priors & {p.name for p in mf.free_params})} with priors)")
    if mf.deterministic_params:
        lines.append(f"    {len(mf.deterministic_params)} deterministic "
                     f"parameter relation(s)")
    if mf.calibrated_params:
        lines.append(f"    {len(mf.calibrated_params)} parameter(s) to "
                     f"calibrate jointly with the steady state: "
                     f"{[p.name for p in mf.calibrated_params]}")
    if prims.eliminated_variables:
        lines.append(f"    {len(prims.eliminated_variables)} variable(s) "
                     f"removed by tryreduce: "
                     f"{[v.base_name for v in prims.eliminated_variables]}")
    if prims.singletons:
        lines.append(f"    {len(prims.singletons)} constant variable(s) "
                     f"folded: {[v.base_name for v in prims.singletons]}")
    if mf.has_full_analytic_ss:
        lines.append("Steady state: fully analytic (closed form).")
    elif len(mf.known_idx):
        lines.append(f"Steady state: {len(mf.known_idx)} of {n_var} values "
                     f"analytic; {len(mf.unknown_idx)} solved numerically.")
    else:
        lines.append("Steady state: fully numeric (jitted Newton/LM).")
    lines.append("Model appears well defined (square system)."
                 if n_eq == n_var else
                 f"WARNING: system is not square ({n_eq} eq, {n_var} var).")
    return "\n".join(lines)


def print_steady_state(ss_results) -> str:
    """Formatted steady-state table."""
    lines = []
    status = "converged" if ss_results.success else "FAILED"
    norm = ss_results.resid_norm
    lines.append(f"Steady state {status}"
                 + (f" (residual norm {norm:.3e})" if norm is not None else ""))
    as_str = ss_results.to_string()
    width = max(len(k) for k in as_str)
    for name in sorted(as_str):
        lines.append(f"  {name:<{width}}  {as_str[name]: .6f}")
    text = "\n".join(lines)
    print(text)
    return text


def block_to_html(block) -> str:
    """Collapsible LaTeX rendering of one block (notebook display)."""
    parts = [f"<details open><summary><b>Block: {block.name}</b></summary>"]

    def section(title, items):
        if not items:
            return
        parts.append(f"<details><summary>{title}</summary>")
        for item in items:
            parts.append(f"<p>\\[{item}\\]</p>")
        parts.append("</details>")

    if block.definitions:
        section("Definitions",
                [sp.latex(sp.Eq(d.lhs, d.rhs)) for d in block.definitions])
    if block.controls:
        section("Controls", [", ".join(sp.latex(c) for c in block.controls)])
    if block.objective is not None:
        section("Objective",
                [sp.latex(sp.Eq(block.objective.lhs, block.objective.rhs))])
    if block.constraints:
        section("Constraints",
                [sp.latex(sp.Eq(c.lhs, c.rhs)) for c in block.constraints])
    if block.identities:
        section("Identities",
                [sp.latex(sp.Eq(i.lhs, i.rhs)) for i in block.identities])
    if block.shocks:
        section("Shocks", [", ".join(sp.latex(s) for s in block.shocks)])
    if block.param_values:
        section("Calibration",
                [f"{sp.latex(k)} = {v}" for k, v in block.param_values.items()])
    if block._solved and block.system_equations:
        section("System equations (after FOC derivation)",
                [sp.latex(sp.Eq(eq, 0)) for eq in block.system_equations])
    parts.append("</details>")
    return "\n".join(parts)


def model_to_html(model) -> str:
    """Collapsible HTML (LaTeX equations per block) for notebook display."""
    parts = [f"<h3>DSGE model: {model.n_variables} variables, "
             f"{model.n_shocks} shocks</h3>"]
    for block in model.primitives.blocks.values():
        parts.append(block_to_html(block))
    return "\n".join(parts)


def print_gcn_file(source_or_path) -> str:
    """Render a GCN file as collapsible LaTeX HTML (notebook display).

    Role parity with ``gEconpy/parser/html.py:150``: parses the file (no
    numeric compilation) and renders each block's definitions, controls,
    objective, constraints, identities, shocks and calibration.  Displays
    inline when IPython is available; always returns the HTML string.
    """
    import os

    from ..models.primitives import load_gcn, load_gcn_file

    if os.path.exists(str(source_or_path)) or str(source_or_path).endswith(".gcn"):
        primitives = load_gcn_file(source_or_path)
    else:
        primitives = load_gcn(source_or_path)
    parts = []
    for block in primitives.blocks.values():
        parts.append(block_to_html(block))
    html = "\n".join(parts)
    try:
        from IPython.display import HTML, display

        display(HTML(html))
    except Exception:
        pass
    return html
