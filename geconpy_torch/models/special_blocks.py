"""Specialized blocks with closed-form FOCs.

Copied from ``geconpy_tpu/models/special_blocks.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Role parity with ``gEconpy/model/block/cobb_douglas.py`` (CobbDouglasBlock:127,
_decompose_monomial:9) and ``ces.py`` (CESBlock:186): when a block's
optimization problem has a recognized functional form, the first-order
conditions are emitted in closed form instead of running sympy
differentiation through the Lagrangian — the chain-rule expansion on
Cobb-Douglas/CES constraints dominates symbolic build time on larger models
(SURVEY.md §7 hard part 6).

The closed forms are mathematically identical to the generic path's output
(asserted by the equivalence tests), so detection failures can always fall
back to :class:`~geconpy_torch.models.block.Block`.
"""

from __future__ import annotations

import sympy as sp

from ..symbolic import TimeAwareSymbol, diff_through_time
from .block import Block
from .registry import register_block

__all__ = ["CobbDouglasBlock", "CESBlock", "decompose_monomial",
           "decompose_ces"]


def decompose_monomial(expr: sp.Expr):
    """If ``expr == coeff * prod(base_i ** exp_i)`` with TimeAwareSymbol
    bases, return (coeff, {symbol: exponent}); else None.

    The coefficient may contain parameters and other variables not appearing
    as powers (they fold into ``coeff``)."""
    expr = sp.powsimp(expr)
    factors = sp.Mul.make_args(expr)
    coeff = sp.S.One
    powers: dict[TimeAwareSymbol, sp.Expr] = {}
    for f in factors:
        base, exp = f.as_base_exp()
        if isinstance(base, TimeAwareSymbol):
            if base in powers:
                powers[base] = powers[base] + exp
            else:
                powers[base] = exp
        elif f.atoms(TimeAwareSymbol):
            return None  # variable inside a non-power factor
        else:
            coeff = coeff * f
    if not powers:
        return None
    return coeff, powers


def decompose_ces(expr: sp.Expr):
    """If ``expr == scale * (sum_i w_i * x_i**p)**(q/p)`` return
    (scale, outer_exponent, [(w_i, x_i, p)]); else None."""
    expr = sp.powsimp(expr)
    factors = sp.Mul.make_args(expr)
    scale = sp.S.One
    core = None
    for f in factors:
        if f.atoms(TimeAwareSymbol):
            if core is not None:
                return None
            core = f
        else:
            scale = scale * f
    if core is None:
        return None
    base, outer_exp = core.as_base_exp()
    if not isinstance(base, sp.Add):
        return None
    terms = []
    inner_p = None
    for term in sp.Add.make_args(base):
        m = decompose_monomial(term)
        if m is None:
            return None
        w, powers = m
        if len(powers) != 1:
            return None
        (x, p), = powers.items()
        if inner_p is None:
            inner_p = p
        elif sp.simplify(inner_p - p) != 0:
            return None
        terms.append((w, x))
    if inner_p is None:
        return None
    return scale, outer_exp, inner_p, terms


class CobbDouglasBlock(Block):
    """Block whose single constraint is a monomial (Cobb-Douglas) in the
    controls, e.g. the firm problem ``Y = A K^alpha L^(1-alpha) : mc``.

    For control x with exponent a the constraint derivative is the closed
    form ``a * rhs / x`` — no sympy ``diff``/chain rule."""

    @staticmethod
    def detect(block: Block) -> bool:
        """Pattern-match a monomial (Cobb-Douglas) production constraint."""
        if block.objective is None or len(block.constraints) != 1:
            return False
        con = block.constraints[0]
        if not isinstance(con.lhs, TimeAwareSymbol):
            return False
        decomp = decompose_monomial(con.rhs)
        if decomp is None:
            return False
        _, powers = decomp
        control_names = {c.base_name for c in block.controls}
        power_names = {s.base_name for s in powers}
        # every control must appear as a pure power (the coefficient may hold
        # non-control variables like technology)
        return control_names <= power_names

    def _compute_foc(self, control, lagrangian, discount):
        con = self.constraints[0]
        obj = self.objective
        sub = self._definition_subs()
        obj_rhs = obj.rhs.subs(sub)
        if obj.minimize:
            obj_rhs = -obj_rhs
        lm = con.multiplier or self.multipliers[0]
        _, powers = decompose_monomial(con.rhs)

        # d(objective)/d(control) summed through time (objective is linear in
        # the controls for cost/profit problems, so this diff is trivial)
        d_obj = diff_through_time(obj_rhs, control, discount)

        # constraint contribution: -lm * (d lhs/dx - d rhs/dx), closed form
        exponent = sp.S.Zero
        for sym, e in powers.items():
            if sym.base_name == control.base_name and sym.time_index == control.time_index:
                exponent = e
                break
        d_con_rhs = exponent * con.rhs / control if exponent != 0 else sp.S.Zero
        d_con_lhs = sp.S.One if (isinstance(con.lhs, TimeAwareSymbol)
                                 and con.lhs == control) else sp.S.Zero
        foc = d_obj - lm * (d_con_lhs - d_con_rhs)
        return sp.powsimp(foc)


class CESBlock(Block):
    """Block whose single constraint is a CES aggregator
    ``Y = scale * (w1 x1^p + w2 x2^p + ...)^(q/p)``."""

    @staticmethod
    def detect(block: Block) -> bool:
        """Pattern-match a CES aggregator constraint."""
        if block.objective is None or len(block.constraints) != 1:
            return False
        con = block.constraints[0]
        if not isinstance(con.lhs, TimeAwareSymbol):
            return False
        decomp = decompose_ces(con.rhs)
        if decomp is None:
            return False
        _, _, _, terms = decomp
        control_names = {c.base_name for c in block.controls}
        term_names = {x.base_name for _, x in terms}
        return control_names <= term_names

    def _compute_foc(self, control, lagrangian, discount):
        con = self.constraints[0]
        obj = self.objective
        sub = self._definition_subs()
        obj_rhs = obj.rhs.subs(sub)
        if obj.minimize:
            obj_rhs = -obj_rhs
        lm = con.multiplier or self.multipliers[0]
        scale, outer_exp, inner_p, terms = decompose_ces(con.rhs)

        d_obj = diff_through_time(obj_rhs, control, discount)

        inner_sum = sp.Add(*[w * x**inner_p for w, x in terms])
        d_con_rhs = sp.S.Zero
        for w, x in terms:
            if x.base_name == control.base_name and x.time_index == control.time_index:
                # d/dx [scale * S^q] = scale * q * S^(q-1) * w * p * x^(p-1)
                d_con_rhs = (scale * outer_exp * inner_sum ** (outer_exp - 1)
                             * w * inner_p * x ** (inner_p - 1))
                break
        d_con_lhs = sp.S.One if con.lhs == control else sp.S.Zero
        foc = d_obj - lm * (d_con_lhs - d_con_rhs)
        return sp.powsimp(foc)


# simpler forms first: Cobb-Douglas before CES (mirrors the reference's
# registry ordering, gEconpy/model/block/registry.py)
register_block(CobbDouglasBlock.detect, CobbDouglasBlock)
register_block(CESBlock.detect, CESBlock)
