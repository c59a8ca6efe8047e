"""Assembles parsed GCN blocks into model primitives.

Copied from ``geconpy_tpu/models/primitives.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/parser/loader.py`` (ModelPrimitives:23,
ast_model_to_primitives:370, load_gcn_file:466) and the simplification /
validation stages of ``gEconpy/model/build.py`` (_compile_gcn:332,
check_for_orphan_params:96, check_for_extra_params:126).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal

import sympy as sp

from ..lang import ast_nodes as A
from ..lang.errors import ErrorCollector, GCNSemanticError, suggest
from ..lang.expand_time import expand_deep_time_indices
from ..lang.parser import parse_gcn
from ..lang.sympify import SympyConverter
from ..lang.validate import full_validation
from ..symbolic import (
    SymbolDictionary,
    TimeAwareSymbol,
    eq_to_ss,
    flatten_substitution_dict,
)
from .block import Block
from .simplify import simplify_constants, simplify_tryreduce
from .timing import natural_sort_key

__all__ = ["ModelPrimitives", "load_gcn", "load_gcn_file", "system_to_steady_state",
           "propagate_steady_state_through_identities"]


@dataclass
class ModelPrimitives:
    """Everything the numeric layers need, produced once at build time."""

    equations: list[sp.Expr]                      # residuals (== 0), t-1/t/t+1 only
    variables: list[TimeAwareSymbol]              # at time t, natural-sorted
    shocks: list[TimeAwareSymbol]                 # at time t
    param_dict: SymbolDictionary                  # free parameter -> float
    deterministic_dict: SymbolDictionary          # parameter -> sympy expr in free params
    calib_dict: SymbolDictionary                  # calibrated parameter -> calibrating eq (resid)
    priors: dict[str, A.GCNDistribution]          # parameter name -> prior AST
    shock_priors: dict[str, A.GCNDistribution]    # shock base name -> prior AST
    ss_solution_dict: SymbolDictionary            # var_ss -> sympy expr (analytic SS)
    options: dict[str, Any] = field(default_factory=dict)
    tryreduce: list[TimeAwareSymbol] = field(default_factory=list)
    assumptions: dict[str, dict] = field(default_factory=dict)
    blocks: dict[str, Block] = field(default_factory=dict)
    eliminated_variables: list[TimeAwareSymbol] = field(default_factory=list)
    singletons: list[TimeAwareSymbol] = field(default_factory=list)

    @property
    def steady_state_system(self) -> list[sp.Expr]:
        """Residual system at the steady state (t -> ss substitution, shocks -> 0)."""
        return system_to_steady_state(self.equations, self.shocks)

    @property
    def is_linear(self) -> bool:
        """True when the GCN declared ``options { linear = TRUE; }``."""
        return bool(self.options.get("linear", False))


def _assumptions_registry(model_ast: A.GCNModel) -> dict[str, dict]:
    registry: dict[str, dict] = {}
    for group, names in model_ast.assumptions.items():
        for name in names:
            registry.setdefault(name, {})[group] = True
    return registry


def _extract_ss_block(model_ast: A.GCNModel, converter: SympyConverter) -> SymbolDictionary:
    """Analytic steady-state expressions from the STEADY_STATE block.

    Definitions and identities form a DAG over _ss symbols; the flattened dict
    maps each var_ss to an expression in parameters only.
    """
    ss_block = None
    for blk in model_ast.blocks:
        if blk.name.upper() == "STEADY_STATE":
            ss_block = blk
            break
    if ss_block is None:
        return SymbolDictionary()

    raw: dict = {}
    for comp in ss_block.components:
        for eq in comp.equations:
            lhs = converter.convert(eq.lhs)
            if isinstance(lhs, TimeAwareSymbol) and lhs.time_index == "ss":
                raw[lhs] = converter.convert(eq.rhs)
            elif isinstance(lhs, sp.Symbol) and not isinstance(lhs, TimeAwareSymbol):
                # scalar temporary from a `definitions` component (reference:
                # gEconpy/parser/loader.py:299-331 topo-flattens these away)
                raw[lhs] = converter.convert(eq.rhs)
            else:
                raise GCNSemanticError(
                    "E107",
                    f"STEADY_STATE entries must assign to var[ss] or define a "
                    f"scalar temporary: {eq.lhs}")
    flat = flatten_substitution_dict(raw)
    return SymbolDictionary(
        {k: v for k, v in flat.items()
         if isinstance(k, TimeAwareSymbol) and k.time_index == "ss"})


def system_to_steady_state(
    equations: list[sp.Expr], shocks: list[TimeAwareSymbol]
) -> list[sp.Expr]:
    """Substitute t -> ss for all variables and 0 for all shocks.

    Role parity with ``gEconpy/model/steady_state.py:39``.
    """
    shock_names = {s.base_name for s in shocks}
    out = []
    for eq in equations:
        subs: dict = {}
        for atom in eq.atoms(TimeAwareSymbol):
            if atom.base_name in shock_names:
                subs[atom] = sp.S.Zero
            else:
                subs[atom] = atom.to_ss()
        out.append(eq.xreplace(subs))
    return out


def propagate_steady_state_through_identities(
    ss_system: list[sp.Expr],
    ss_solution_dict: SymbolDictionary,
    max_size: int = 100,
) -> SymbolDictionary:
    """Extend a partial analytic steady state by solving single-unknown
    equations.

    Role parity with ``gEconpy/model/steady_state.py:459``: repeatedly scan
    the steady-state system for equations whose only unknown (after
    substituting everything already known) is a single _ss symbol, solve it
    with sympy, and add the result — but only when the solution stays simple
    (operation count below ``max_size``), to avoid exploding expressions.
    """
    known = dict(ss_solution_dict)
    progress = True
    while progress:
        progress = False
        for eq in ss_system:
            eq_sub = eq.xreplace(known)
            unknowns = [a for a in eq_sub.atoms(TimeAwareSymbol) if a.time_index == "ss"]
            if len(unknowns) != 1:
                continue
            target = unknowns[0]
            try:
                sols = sp.solve(eq_sub, target, dict=True)
            except Exception:
                continue
            if len(sols) != 1 or target not in sols[0]:
                continue
            expr = sols[0][target]
            if sp.count_ops(expr) > max_size:
                continue
            if expr.atoms(TimeAwareSymbol):
                continue
            known[target] = expr
            progress = True
    out = SymbolDictionary(known)
    return out


def _validate_parameters(
    equations: list[sp.Expr],
    calibrating_equations: list[sp.Expr],
    deterministic_dict: dict,
    param_dict: dict,
    calib_params: list[sp.Symbol],
    ss_solution_dict: SymbolDictionary,
    shock_priors: dict | None = None,
    on_unused: Literal["error", "warn", "ignore"] = "error",
) -> None:
    collector = ErrorCollector()
    used: set[str] = set()
    for eq in list(equations) + list(calibrating_equations) + list(ss_solution_dict.values()):
        if isinstance(eq, sp.Basic):
            used |= {a.name for a in eq.free_symbols if not isinstance(a, TimeAwareSymbol)}
    for expr in deterministic_dict.values():
        if isinstance(expr, sp.Basic):
            used |= {a.name for a in expr.free_symbols if not isinstance(a, TimeAwareSymbol)}
    # hyper-parameters referenced inside shock distributions count as used
    # (e.g. eps[] ~ Normal(mu=0, sigma=sigma_A))
    for dist_ast in (shock_priors or {}).values():
        for arg in dist_ast.args:
            if isinstance(arg.value, A.Parameter):
                used.add(arg.value.name)

    defined = {p.name for p in param_dict}
    defined |= {p.name for p in deterministic_dict}
    defined |= {p.name for p in calib_params}

    extra = used - defined
    for name in sorted(extra):
        collector.semantic("E102", f"parameter {name!r} is used but never calibrated",
                           suggestions=suggest(name, defined))
    collector.raise_if_errors()

    if on_unused == "ignore":
        return
    orphans = {p.name for p in param_dict} - used
    if orphans:
        import warnings

        msg = f"calibrated parameter(s) never used in the model: {sorted(orphans)}"
        if on_unused == "error":
            raise GCNSemanticError("E103", msg)
        warnings.warn(msg, stacklevel=2)


def load_gcn(
    source: str,
    filename: str | None = None,
    simplify_blocks: bool = True,
    simplify_tryreduce_flag: bool = True,
    simplify_constants_flag: bool = True,
    on_unused_parameters: Literal["error", "warn", "ignore"] = "error",
) -> ModelPrimitives:
    """Parse + validate + solve blocks + simplify: GCN source -> primitives."""
    model_ast = parse_gcn(source, filename)
    full_validation(model_ast)

    assumptions = _assumptions_registry(model_ast)
    converter = SympyConverter(assumptions)

    ss_solution_dict = _extract_ss_block(model_ast, converter)

    blocks: dict[str, Block] = {}
    from . import special_blocks  # noqa: F401  (registers specialized types)
    from .registry import dispatch_block

    for ast_block in model_ast.blocks:
        if ast_block.name.upper() == "STEADY_STATE":
            continue
        block = dispatch_block(ast_block, converter)
        block.solve_optimization(try_simplify=simplify_blocks)
        blocks[block.name] = block

    equations: list[sp.Expr] = []
    shocks: list[TimeAwareSymbol] = []
    param_dict = SymbolDictionary()
    param_equations: dict = {}
    calibrating_equations: list = []
    calib_params: list[sp.Symbol] = []
    priors: dict[str, A.GCNDistribution] = {}
    shock_priors: dict[str, A.GCNDistribution] = {}

    for block in blocks.values():
        equations.extend(block.system_equations)
        shocks.extend(block.shocks)
        param_dict.update(block.param_values)
        for beq in block.param_equations:
            param_equations[beq.lhs] = beq.rhs
        for beq in block.calibrating_equations:
            calibrating_equations.append(beq)
            calib_params.append(beq.calibrating_parameter)
        priors.update(block.priors)
        shock_priors.update(block.shock_priors)

    # validate prior declarations eagerly: an unknown distribution name
    # (E012) or malformed argument (E013) should fail at build with a
    # did-you-mean, not at estimation setup (reference role:
    # parser/grammar/statements.py:362-398)
    from ..dists.from_ast import ast_to_distribution

    _prior_collector = ErrorCollector()
    for _ast in list(priors.values()) + list(shock_priors.values()):
        try:
            ast_to_distribution(_ast)
        except GCNSemanticError as e:
            _prior_collector.add(e)
    _prior_collector.raise_if_errors()

    # deterministic parameter relations may chain; flatten them
    deterministic_dict = SymbolDictionary(flatten_substitution_dict(param_equations))

    # deep lags/leads -> auxiliary chains
    equations, aux_identities, _aux_vars = expand_deep_time_indices(equations)
    equations.extend(aux_identities)

    shock_names = {s.base_name for s in shocks}
    variables = sorted(
        {
            a.set_t(0)
            for eq in equations
            for a in eq.atoms(TimeAwareSymbol)
            if a.base_name not in shock_names and a.time_index != "ss"
        },
        key=lambda v: natural_sort_key(v.base_name),
    )

    tryreduce_syms = [converter.variable(v.name, 0) for v in model_ast.tryreduce]
    eliminated: list[TimeAwareSymbol] = []
    singletons: list[TimeAwareSymbol] = []
    if simplify_tryreduce_flag and tryreduce_syms:
        equations, variables, eliminated = simplify_tryreduce(
            tryreduce_syms, equations, variables)
    if simplify_constants_flag:
        equations, variables, singletons = simplify_constants(equations, variables)

    # drop analytic SS entries for eliminated variables
    gone = {v.base_name for v in eliminated + singletons}
    ss_solution_dict = SymbolDictionary(
        {k: v for k, v in ss_solution_dict.items() if k.base_name not in gone})

    calib_resid = SymbolDictionary()
    for beq in calibrating_equations:
        resid = eq_to_ss(beq.lhs - beq.rhs)
        calib_resid[beq.calibrating_parameter] = resid

    _validate_parameters(
        equations, list(calib_resid.values()), deterministic_dict, param_dict,
        calib_params, ss_solution_dict, shock_priors, on_unused_parameters)

    if len(equations) != len(variables):
        raise GCNSemanticError(
            "E101",
            f"model system is not square: {len(equations)} equations for "
            f"{len(variables)} variables "
            f"({[v.base_name for v in variables]})")

    return ModelPrimitives(
        equations=equations,
        variables=variables,
        shocks=sorted(set(shocks), key=lambda s: natural_sort_key(s.base_name)),
        param_dict=param_dict,
        deterministic_dict=deterministic_dict,
        calib_dict=calib_resid,
        priors=priors,
        shock_priors=shock_priors,
        ss_solution_dict=ss_solution_dict,
        options=dict(model_ast.options),
        tryreduce=tryreduce_syms,
        assumptions=assumptions,
        blocks=blocks,
        eliminated_variables=eliminated,
        singletons=singletons,
    )


def load_gcn_file(path, **kwargs) -> ModelPrimitives:
    """Parse + validate a .gcn file and build its ModelPrimitives bundle."""
    import pathlib

    p = pathlib.Path(path)
    return load_gcn(p.read_text(), filename=p.name, **kwargs)
