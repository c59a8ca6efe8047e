"""Semantic validation of a parsed GCN model.

Copied from ``geconpy_tpu/lang/validate.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/ast/validation.py`` (validate_block:21,
validate_model:99, undefined-symbol detection :204/:256, full_validation:305).
All diagnostics are accumulated into an :class:`ErrorCollector` so the user
sees every problem at once.
"""

from __future__ import annotations

from . import ast_nodes as A
from .errors import ErrorCollector, suggest

__all__ = ["validate_block", "validate_model", "full_validation"]

_VALID_ASSUMPTIONS = (
    "positive", "negative", "nonnegative", "nonpositive", "real",
    "nonzero", "integer", "rational", "finite", "imaginary", "complex",
)

_SS_ALLOWED_COMPONENTS = {"definitions", "identities"}


def _iter_equations(block: A.GCNBlock):
    for comp in block.components:
        for eq in comp.equations:
            yield comp.name, eq


def _expr_variables(expr: A.Expr) -> list[A.Variable]:
    return A.collect(expr, A.Variable)


def _expr_parameters(expr: A.Expr) -> list[A.Parameter]:
    return A.collect(expr, A.Parameter)


def validate_block(block: A.GCNBlock, collector: ErrorCollector) -> None:
    """Per-block semantic checks (components, controls, objective shape)."""
    seen_components: set[str] = set()
    for comp in block.components:
        if comp.name in seen_components:
            collector.semantic(
                "E010", f"component {comp.name!r} appears twice in block {block.name!r}",
                comp.loc)
        seen_components.add(comp.name)

    if block.name.upper() == "STEADY_STATE":
        for comp in block.components:
            if comp.name not in _SS_ALLOWED_COMPONENTS:
                collector.semantic(
                    "E107",
                    f"STEADY_STATE block may not contain a {comp.name!r} component",
                    comp.loc)
        for comp_name, eq in _iter_equations(block):
            for var in _expr_variables(eq.lhs) + _expr_variables(eq.rhs):
                if var.time_index != "ss":
                    collector.semantic(
                        "E107",
                        f"variable {var.name!r} in STEADY_STATE must use [ss] indexing",
                        var.loc)
        return

    objective = block.get("objective")
    controls = block.get("controls")
    constraints = block.get("constraints")

    if objective is not None and len(objective.equations) != 1:
        collector.semantic(
            "E014",
            f"block {block.name!r}: objective must contain exactly one equation "
            f"(found {len(objective.equations)})",
            objective.loc)

    if objective is not None and objective.equations:
        lhs = objective.equations[0].lhs
        if not isinstance(lhs, A.Variable):
            collector.semantic(
                "E111",
                f"block {block.name!r}: objective left-hand side must be a single variable",
                objective.equations[0].loc)

    if controls is not None and controls.variables:
        if objective is None and constraints is None:
            collector.semantic(
                "E106",
                f"block {block.name!r} declares controls but has no objective or constraints",
                controls.loc)
        else:
            problem_vars = set()
            if objective is not None:
                for eq in objective.equations:
                    problem_vars |= {v.name for v in _expr_variables(eq.rhs)}
            if constraints is not None:
                for eq in constraints.equations:
                    problem_vars |= {v.name for v in _expr_variables(eq.lhs)}
                    problem_vars |= {v.name for v in _expr_variables(eq.rhs)}
            # definitions substitute into the problem, so their referenced
            # variables count as appearing in it
            definitions = block.get("definitions")
            if definitions is not None:
                def_lhs = {eq.lhs.name for eq in definitions.equations
                           if isinstance(eq.lhs, A.Variable)}
                for eq in definitions.equations:
                    if isinstance(eq.lhs, A.Variable) and eq.lhs.name in def_lhs:
                        problem_vars |= {v.name for v in _expr_variables(eq.rhs)}
            for control in controls.variables:
                if control.name not in problem_vars:
                    collector.semantic(
                        "E105",
                        f"control variable {control.name!r} does not appear in "
                        f"block {block.name!r}'s objective or constraints",
                        control.loc,
                        suggestions=suggest(control.name, problem_vars))

    shocks = block.get("shocks")
    if shocks is not None:
        for var in shocks.variables:
            if var.time_index not in (0, None):
                collector.semantic(
                    "E110", f"shock {var.name!r} must be declared at time t: "
                    f"'{var.name}[]'", var.loc)

    for comp in block.components:
        seen: set[str] = set()
        for var in comp.variables:
            if var.name in seen:
                collector.semantic(
                    "E109", f"{var.name!r} appears twice in {comp.name!r} of "
                    f"block {block.name!r}", var.loc)
            seen.add(var.name)


def validate_model(model: A.GCNModel, collector: ErrorCollector) -> None:
    """Model-level semantic checks (undefined symbols, duplicates, timing)."""
    # classify names: anything written with [brackets] anywhere is a variable;
    # bare names in expressions are parameters.
    variable_names: set[str] = set()
    defined_params: set[str] = set()

    for block in model.blocks:
        for comp in block.components:
            for var in comp.variables:
                if var.time_index is not None:
                    variable_names.add(var.name)
            for eq in comp.equations:
                for v in _expr_variables(eq.lhs) + _expr_variables(eq.rhs):
                    variable_names.add(v.name)
                if eq.multiplier:
                    variable_names.add(eq.multiplier)
                if comp.name == "calibration":
                    if isinstance(eq.lhs, A.Parameter) and eq.calibrating_parameter is None:
                        defined_params.add(eq.lhs.name)
                    if eq.calibrating_parameter is not None:
                        defined_params.add(eq.calibrating_parameter)
            for dist in comp.distributions:
                if dist.target_time_index is None:
                    defined_params.add(dist.target)

    # duplicate parameter calibration across blocks
    seen_param_blocks: dict[str, str] = {}
    for block in model.blocks:
        cal = block.get("calibration")
        if cal is None:
            continue
        local: set[str] = set()
        for eq in cal.equations:
            name = None
            if eq.calibrating_parameter is not None:
                name = eq.calibrating_parameter
            elif isinstance(eq.lhs, A.Parameter):
                name = eq.lhs.name
            if name is None:
                continue
            local.add(name)
        for dist in cal.distributions:
            if dist.target_time_index is None:
                local.add(dist.target)
        for name in local:
            if name in seen_param_blocks:
                collector.semantic(
                    "E104",
                    f"parameter {name!r} is calibrated in both "
                    f"{seen_param_blocks[name]!r} and {block.name!r}",
                    cal.loc)
            else:
                seen_param_blocks[name] = block.name

    # assumptions reference known sympy assumption categories
    for group, names in model.assumptions.items():
        if group not in _VALID_ASSUMPTIONS:
            collector.semantic(
                "E108", f"unknown assumption category {group!r}", None,
                suggestions=suggest(group, _VALID_ASSUMPTIONS))

    # tryreduce entries must be model variables
    for var in model.tryreduce:
        if var.name not in variable_names:
            collector.semantic(
                "E112", f"tryreduce target {var.name!r} is not a model variable",
                var.loc, suggestions=suggest(var.name, variable_names))


def full_validation(model: A.GCNModel) -> None:
    """Run every block- and model-level check; raise a collection on failure."""
    collector = ErrorCollector()
    for block in model.blocks:
        validate_block(block, collector)
    validate_model(model, collector)
    collector.raise_if_errors()
