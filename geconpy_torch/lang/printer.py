"""AST -> GCN source round-trip printer.

Copied from ``geconpy_tpu/lang/printer.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/ast/printer.py`` (print_expression:27,
print_model:231).
"""

from __future__ import annotations

from . import ast_nodes as A

__all__ = ["print_expression", "print_equation", "print_block", "print_model"]

_PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2, "^": 3}


def _paren(child: A.Expr, parent_prec: int, right_side: bool = False) -> str:
    text = print_expression(child)
    if isinstance(child, A.BinaryOp):
        child_prec = _PRECEDENCE[child.op]
        if child_prec < parent_prec or (child_prec == parent_prec and right_side):
            return f"({text})"
    elif isinstance(child, A.UnaryOp) and parent_prec >= 2:
        return f"({text})"
    return text


def _render_index(idx) -> str:
    if idx is None or idx == 0:
        return "[]"
    return f"[{idx}]"


def print_expression(node: A.Expr) -> str:
    """Render an expression AST back to GCN source text."""
    if isinstance(node, A.Number):
        v = node.value
        return str(int(v)) if float(v).is_integer() else repr(v)
    if isinstance(node, A.Parameter):
        return node.name
    if isinstance(node, A.Variable):
        return node.name + _render_index(node.time_index)
    if isinstance(node, A.UnaryOp):
        inner = print_expression(node.operand)
        if isinstance(node.operand, A.BinaryOp):
            inner = f"({inner})"
        return f"-{inner}"
    if isinstance(node, A.BinaryOp):
        prec = _PRECEDENCE[node.op]
        if node.op == "^":
            # right-associative: the LEFT child needs parens at equal precedence
            left = _paren(node.left, prec, right_side=True)
            right = _paren(node.right, prec)
        else:
            left = _paren(node.left, prec)
            right = _paren(node.right, prec, right_side=node.op in ("-", "/"))
        return f"{left} {node.op} {right}"
    if isinstance(node, A.FunctionCall):
        return f"{node.name}({', '.join(print_expression(a) for a in node.args)})"
    if isinstance(node, A.Expectation):
        return f"E[][{print_expression(node.operand)}]"
    raise TypeError(f"cannot print node of type {type(node).__name__}")


def print_equation(eq: A.GCNEquation) -> str:
    """Render an equation AST (with tags/multiplier/calibration) to GCN text."""
    parts = []
    for tag in eq.tags:
        parts.append(f"@{tag} ")
    parts.append(print_expression(eq.lhs))
    parts.append(" = ")
    parts.append(print_expression(eq.rhs))
    if eq.multiplier:
        parts.append(f" : {eq.multiplier}[]")
    if eq.calibrating_parameter:
        parts.append(f" -> {eq.calibrating_parameter}")
    parts.append(";")
    return "".join(parts)


def _print_distribution(d: A.GCNDistribution) -> str:
    def render_arg(arg: A.DistributionArg) -> str:
        if isinstance(arg.value, A.GCNDistribution):
            val = _print_dist_expr(arg.value)
        else:
            val = print_expression(arg.value)
        return f"{arg.name} = {val}" if arg.name else val

    def _print_dist_expr(d: A.GCNDistribution) -> str:
        return f"{d.dist_name}({', '.join(render_arg(a) for a in d.args)})"

    target = d.target + ("" if d.target_time_index is None else _render_index(d.target_time_index))
    text = f"{target} ~ {_print_dist_expr(d)}"
    if d.initial_value is not None:
        init = d.initial_value
        text += f" = {int(init) if float(init).is_integer() else init}"
    return text + ";"


def print_component(comp: A.GCNComponent, indent: str = "    ") -> str:
    lines = [f"{indent}{comp.name}", f"{indent}{{"]
    inner = indent * 2
    if comp.variables:
        lines.append(inner + ", ".join(v.name + _render_index(v.time_index)
                                       for v in comp.variables) + ";")
    for eq in comp.equations:
        lines.append(inner + print_equation(eq))
    for d in comp.distributions:
        lines.append(inner + _print_distribution(d))
    lines.append(f"{indent}}};")
    return "\n".join(lines)


def print_block(block: A.GCNBlock) -> str:
    """Render one model block back to GCN source text."""
    lines = [f"block {block.name}", "{"]
    for comp in block.components:
        lines.append(print_component(comp))
    lines.append("};")
    return "\n".join(lines)


def print_model(model: A.GCNModel) -> str:
    """Round-trip a whole parsed model back to GCN source text."""
    parts: list[str] = []
    if model.options:
        lines = ["options", "{"]
        for k, v in model.options.items():
            if isinstance(v, bool):
                val = "TRUE" if v else "FALSE"
            else:
                val = str(v)
            lines.append(f"    {k} = {val};")
        lines.append("};")
        parts.append("\n".join(lines))
    if model.tryreduce:
        names = ", ".join(v.name + _render_index(v.time_index) for v in model.tryreduce)
        parts.append("tryreduce\n{\n    " + names + ";\n};")
    if model.assumptions:
        lines = ["assumptions", "{"]
        for group, names in model.assumptions.items():
            lines.append(f"    {group}")
            lines.append("    {")
            lines.append("        " + ", ".join(names) + ";")
            lines.append("    };")
        lines.append("};")
        parts.append("\n".join(lines))
    for block in model.blocks:
        parts.append(print_block(block))
    return "\n\n".join(parts) + "\n"
