"""Agent optimization blocks and first-order-condition derivation.

Copied from ``geconpy_tpu/models/block.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/model/block/basic.py`` (Block:71,
_build_lagrangian:519, _get_discount_factor:553, solve_optimization:644,
simplify_system_equations:603).  A block holds one agent's optimization
problem; ``solve_optimization`` assembles the infinite-horizon Lagrangian and
derives FOCs per control via
:func:`~geconpy_torch.symbolic.diff_through_time`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import sympy as sp

from ..lang import ast_nodes as A
from ..lang.errors import GCNSemanticError
from ..lang.sympify import SympyConverter
from ..symbolic import (
    TimeAwareSymbol,
    diff_through_time,
    expand_subs_for_all_times,
    flatten_substitution_dict,
)

__all__ = ["Block", "BlockEquation"]


@dataclass
class BlockEquation:
    """A model equation with its metadata."""

    lhs: sp.Expr
    rhs: sp.Expr
    multiplier: TimeAwareSymbol | None = None
    calibrating_parameter: sp.Symbol | None = None
    tags: tuple[str, ...] = ()

    @property
    def residual(self) -> sp.Expr:
        """lhs - rhs of the equation."""
        return self.lhs - self.rhs

    @property
    def excluded(self) -> bool:
        """True when tagged ``@exclude`` (skipped by the FOC engine)."""
        return "exclude" in self.tags

    @property
    def minimize(self) -> bool:
        """True when tagged ``@minimize`` (objective sign-flipped)."""
        return "minimize" in self.tags


@dataclass
class Block:
    """One agent's optimization problem, parsed from a GCN block."""

    name: str
    definitions: list[BlockEquation] = field(default_factory=list)
    controls: list[TimeAwareSymbol] = field(default_factory=list)
    objective: BlockEquation | None = None
    constraints: list[BlockEquation] = field(default_factory=list)
    identities: list[BlockEquation] = field(default_factory=list)
    shocks: list[TimeAwareSymbol] = field(default_factory=list)
    param_values: dict = field(default_factory=dict)          # Symbol -> float
    param_equations: list[BlockEquation] = field(default_factory=list)   # deterministic relations
    calibrating_equations: list[BlockEquation] = field(default_factory=list)
    priors: dict = field(default_factory=dict)                # name -> GCNDistribution AST
    shock_priors: dict = field(default_factory=dict)          # shock name -> GCNDistribution AST

    # populated by solve_optimization
    system_equations: list[sp.Expr] = field(default_factory=list)
    multipliers: list[TimeAwareSymbol] = field(default_factory=list)
    eliminated_multipliers: list[TimeAwareSymbol] = field(default_factory=list)
    _solved: bool = False

    # ------------------------------------------------------------------ build
    @classmethod
    def from_ast(cls, ast_block: A.GCNBlock, converter: SympyConverter) -> "Block":
        """Build a Block from a parsed GCN AST block (sympy conversion + flags)."""
        block = cls(name=ast_block.name)

        def convert_equation(eq: A.GCNEquation) -> BlockEquation:
            mult = None
            if eq.multiplier:
                mult = converter.variable(eq.multiplier, 0)
            calib = None
            if eq.calibrating_parameter:
                calib = converter.parameter(eq.calibrating_parameter)
            return BlockEquation(
                converter.convert(eq.lhs), converter.convert(eq.rhs),
                mult, calib, eq.tags,
            )

        for comp in ast_block.components:
            if comp.name == "definitions":
                block.definitions = [convert_equation(e) for e in comp.equations]
            elif comp.name == "controls":
                block.controls = [
                    converter.variable(v.name, v.time_index or 0) for v in comp.variables
                ]
            elif comp.name == "objective":
                if comp.equations:
                    block.objective = convert_equation(comp.equations[0])
            elif comp.name == "constraints":
                block.constraints = [convert_equation(e) for e in comp.equations]
            elif comp.name == "identities":
                block.identities = [convert_equation(e) for e in comp.equations]
            elif comp.name == "shocks":
                block.shocks = [
                    converter.variable(v.name, 0) for v in comp.variables
                ]
                for dist in comp.distributions:
                    block.shocks.append(converter.variable(dist.target, 0))
                    block.shock_priors[dist.target] = dist
            elif comp.name == "calibration":
                block._load_calibration(comp, converter)
        return block

    def _load_calibration(self, comp: A.GCNComponent, converter: SympyConverter) -> None:
        for eq in comp.equations:
            beq = BlockEquation(
                converter.convert(eq.lhs), converter.convert(eq.rhs),
                None,
                converter.parameter(eq.calibrating_parameter)
                if eq.calibrating_parameter else None,
                eq.tags,
            )
            if beq.calibrating_parameter is not None:
                # e.g.  K[ss] / Y[ss] = 10 -> alpha
                self.calibrating_equations.append(beq)
            elif isinstance(beq.lhs, sp.Symbol) and not isinstance(beq.lhs, TimeAwareSymbol):
                if beq.rhs.free_symbols:
                    # deterministic parameter relation, e.g.  b = a / 2
                    self.param_equations.append(beq)
                else:
                    self.param_values[beq.lhs] = float(beq.rhs)
            else:
                raise GCNSemanticError(
                    "E016",
                    f"calibration entry in block {self.name!r} must assign a parameter "
                    f"or use '-> param': {sp.Eq(beq.lhs, beq.rhs)}",
                )
        for dist in comp.distributions:
            self.priors[dist.target] = dist
            if dist.initial_value is not None:
                self.param_values[converter.parameter(dist.target)] = dist.initial_value

    # --------------------------------------------------------------- lagrangian
    def _definition_subs(self) -> dict:
        """Flattened time-t definition substitutions (defs may reference defs)."""
        raw = {d.lhs: d.rhs for d in self.definitions}
        return flatten_substitution_dict(raw)

    def _build_lagrangian(self, sub_dict: dict) -> tuple[sp.Expr, list[TimeAwareSymbol]]:
        assert self.objective is not None
        obj_rhs = self.objective.rhs.subs(sub_dict)
        if self.objective.minimize:
            obj_rhs = -obj_rhs

        all_time_subs = expand_subs_for_all_times(sub_dict)
        lagrangian = obj_rhs
        multipliers: list[TimeAwareSymbol] = []
        gen_count = 0
        for con in self.constraints:
            lm = con.multiplier
            if lm is None:
                gen_count += 1
                lm = TimeAwareSymbol(f"lambda__{self.name}_{gen_count}", 0, real=True)
            multipliers.append(lm)
            lagrangian = lagrangian - lm * (
                con.lhs.subs(all_time_subs) - con.rhs.subs(all_time_subs)
            )
        return lagrangian, multipliers

    def _get_discount_factor(self) -> sp.Expr:
        """Extract the Bellman discount factor from ``U[] = u[] + b*E[][U[1]]``.

        Static problems (no t+1 objective terms) have discount factor 1.
        """
        assert self.objective is not None
        obj = self.objective
        atoms = [a for a in (obj.lhs - obj.rhs).atoms(TimeAwareSymbol)]
        if all(a.time_index in (0, -1, "ss") for a in atoms):
            return sp.S.One

        current_value = obj.lhs
        if not isinstance(current_value, TimeAwareSymbol):
            raise GCNSemanticError(
                "E111", f"block {self.name!r}: objective LHS must be a variable")
        continuation = current_value.set_t(current_value.time_index + 1)
        terms = sp.Add.make_args(sp.expand(obj.rhs))
        matches = [t for t in terms if t.has(continuation)]
        if not matches:
            raise GCNSemanticError(
                "E014",
                f"block {self.name!r}: could not find continuation value "
                f"{continuation} in objective {sp.Eq(obj.lhs, obj.rhs)}")
        return sp.Add(*matches).subs({continuation: sp.S.One})

    def _compute_foc(self, control: TimeAwareSymbol, lagrangian: sp.Expr,
                     discount: sp.Expr) -> sp.Expr:
        """FOC for one control.  Specialized subclasses override this with
        closed forms (Cobb-Douglas/CES) to avoid chain-rule blowup."""
        return diff_through_time(lagrangian, control, discount)

    # ------------------------------------------------------------------- solve
    def solve_optimization(self, try_simplify: bool = True) -> None:
        """Derive the block's contribution to the model system.

        System equations = identities + non-excluded constraints + the
        objective-defining equation + one FOC per control, all with the
        block's definitions substituted in.
        """
        if self._solved:
            return
        sub_dict = self._definition_subs()
        all_time_subs = expand_subs_for_all_times(sub_dict)
        system: list[sp.Expr] = []

        for eq in self.identities:
            system.append(eq.residual.subs(all_time_subs))
        for eq in self.constraints:
            if not eq.excluded:
                system.append(eq.residual.subs(all_time_subs))

        if self.objective is not None:
            system.append(self.objective.residual.subs(sub_dict))

        if self.controls and self.objective is not None:
            discount = self._get_discount_factor()
            lagrangian, multipliers = self._build_lagrangian(sub_dict)
            self.multipliers = multipliers
            for control in self.controls:
                foc = self._compute_foc(control, lagrangian, discount)
                system.append(sp.powsimp(foc))
        elif self.controls:
            raise GCNSemanticError(
                "E106",
                f"block {self.name!r} declares controls but no objective")

        self.system_equations = system
        if try_simplify:
            self._eliminate_trivial_multipliers()
        self._solved = True

    def _eliminate_trivial_multipliers(self) -> None:
        """Substitute away auto-generated multipliers defined by trivial
        identities ``lm = ±x`` (the pattern left by constraints whose FOC pins
        the generated multiplier to an existing variable)."""
        system = list(self.system_equations)
        generated = {
            m for m in self.multipliers
            if m is not None and m.base_name.startswith("lambda__")
        }
        eliminated: list[TimeAwareSymbol] = []
        for lm in sorted(generated, key=lambda s: s.name):
            for eq in system:
                if lm not in eq.atoms(TimeAwareSymbol):
                    continue
                # trivial shape: at most 3 atoms (x = y or x = -y)
                if len(eq.atoms()) <= 3:
                    sols = sp.solve(eq, lm, dict=True)
                    if not sols:
                        continue
                    subs = expand_subs_for_all_times(sols[0])
                    eliminated.extend(subs.keys())
                    system = [e.subs(subs) for e in system]
                    break
        system = [e for e in system if e != 0]
        system = [sp.powsimp(e) for e in system]
        self.system_equations = system
        self.eliminated_multipliers = eliminated

    # ------------------------------------------------------------------- info
    @property
    def variables(self) -> list[TimeAwareSymbol]:
        """All time-indexed symbols appearing in the solved system (at time t),
        excluding shocks."""
        shock_names = {s.base_name for s in self.shocks}
        seen: dict[str, TimeAwareSymbol] = {}
        for eq in self.system_equations:
            for atom in eq.atoms(TimeAwareSymbol):
                if atom.base_name not in shock_names and atom.time_index != "ss":
                    seen.setdefault(atom.base_name, atom.set_t(0))
        return [seen[k] for k in sorted(seen)]

    @property
    def parameters(self) -> list[sp.Symbol]:
        """Every non-variable symbol appearing in the block's equations."""
        out: set[sp.Symbol] = set()
        for eq in self.system_equations:
            for atom in eq.free_symbols:
                if not isinstance(atom, TimeAwareSymbol):
                    out.add(atom)
        return sorted(out, key=lambda s: s.name)

    def _repr_html_(self) -> str:
        from ..utils.reporting import block_to_html

        return block_to_html(self)

    def __repr__(self):
        n_eq = len(self.system_equations) if self._solved else "unsolved"
        return (f"Block({self.name!r}, controls={[c.base_name for c in self.controls]}, "
                f"system_equations={n_eq})")
