"""Recursive-descent parser for the GCN model language.

Copied from ``geconpy_tpu/lang/parser.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

Replaces the reference's pyparsing grammar
(``gEconpy/parser/grammar/{tokens,expressions,statements,components,blocks,
special_blocks,gcn_file}.py``) with a hand-written single-pass parser: no
backtracking, exact locations, deliberate error productions for the common
mistakes (missing '=', missing ';', missing lhs/rhs, bad time indices).

Grammar (informal):

    file        := (special_block | model_block)*
    special     := 'options' '{' option* '};'
                 | 'tryreduce' '{' var_list ';' '};'
                 | 'assumptions' '{' (IDENT '{' name_list ';' '};')* '};'
    model_block := 'block' IDENT '{' component* '};'
    component   := NAME '{' statement* '};'
    statement   := distribution | equation | var_list
    equation    := ('@' TAG)* expr '=' expr (':' variable)? ('->' IDENT)? ';'
    expr        := standard arithmetic with right-assoc '^'/'**',
                   variables 'name[idx]' (idx in {int, ss, empty}),
                   expectations 'E[][expr]', function calls.
"""

from __future__ import annotations

from typing import Any

from . import ast_nodes as A
from .errors import GCNSyntaxError, suggest
from .lexer import Token, TokenKind as T, tokenize

__all__ = ["parse_gcn", "parse_expression", "COMPONENT_NAMES", "SPECIAL_BLOCKS"]

COMPONENT_NAMES = (
    "definitions", "controls", "objective", "constraints",
    "identities", "shocks", "calibration",
)
SPECIAL_BLOCKS = ("options", "tryreduce", "assumptions")
VALID_TAGS = ("exclude", "minimize", "maximize")


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0

    # -- token helpers -----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek(self, offset: int = 1) -> Token:
        idx = min(self.pos + offset, len(self.tokens) - 1)
        return self.tokens[idx]

    def advance(self) -> Token:
        tok = self.cur
        if tok.kind is not T.EOF:
            self.pos += 1
        return tok

    def check(self, kind: T, text: str | None = None) -> bool:
        return self.cur.kind is kind and (text is None or self.cur.text == text)

    def match(self, kind: T, text: str | None = None) -> Token | None:
        if self.check(kind, text):
            return self.advance()
        return None

    def expect(self, kind: T, code: str = "E017", what: str | None = None) -> Token:
        if self.cur.kind is kind:
            return self.advance()
        expected = what or kind.name.lower()
        raise GCNSyntaxError(
            code, f"expected {expected}, found {self.cur.text!r}" if self.cur.text
            else f"expected {expected}, found end of file",
            self.cur.loc,
        )

    def expect_semi(self) -> None:
        if not self.match(T.SEMI):
            raise GCNSyntaxError("E003", f"expected ';' before {self.cur.text!r}"
                                 if self.cur.text else "expected ';' before end of file",
                                 self.cur.loc)

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> A.Expr:
        return self._additive()

    def _additive(self) -> A.Expr:
        left = self._multiplicative()
        while self.cur.kind in (T.PLUS, T.MINUS):
            op = self.advance()
            right = self._multiplicative()
            left = A.BinaryOp("+" if op.kind is T.PLUS else "-", left, right, loc=op.loc)
        return left

    def _multiplicative(self) -> A.Expr:
        left = self._unary()
        while self.cur.kind in (T.STAR, T.SLASH):
            op = self.advance()
            right = self._unary()
            left = A.BinaryOp("*" if op.kind is T.STAR else "/", left, right, loc=op.loc)
        return left

    def _unary(self) -> A.Expr:
        if self.check(T.MINUS):
            tok = self.advance()
            return A.UnaryOp("-", self._unary(), loc=tok.loc)
        if self.check(T.PLUS):
            self.advance()
            return self._unary()
        return self._power()

    def _power(self) -> A.Expr:
        base = self._atom()
        if self.check(T.CARET):
            tok = self.advance()
            # right-associative; exponent may carry unary minus
            exponent = self._unary_power_operand()
            return A.BinaryOp("^", base, exponent, loc=tok.loc)
        return base

    def _unary_power_operand(self) -> A.Expr:
        if self.check(T.MINUS):
            tok = self.advance()
            return A.UnaryOp("-", self._unary_power_operand(), loc=tok.loc)
        return self._power()

    def _atom(self) -> A.Expr:
        tok = self.cur
        if tok.kind is T.NUMBER:
            self.advance()
            return A.Number(float(tok.text), loc=tok.loc)
        if tok.kind is T.LPAREN:
            self.advance()
            inner = self.parse_expr()
            self.expect(T.RPAREN, what="')'")
            return inner
        if tok.kind is T.IDENT:
            # expectation operator: E[][expr]
            if tok.text == "E" and self.peek().kind is T.LBRACKET:
                return self._expectation()
            self.advance()
            if self.check(T.LBRACKET):
                return self._finish_variable(tok)
            if self.check(T.LPAREN):
                return self._finish_call(tok)
            return A.Parameter(tok.text, loc=tok.loc)
        raise GCNSyntaxError(
            "E004", f"expected an expression, found {tok.text!r}" if tok.text
            else "expected an expression, found end of input", tok.loc)

    def _expectation(self) -> A.Expr:
        e_tok = self.expect(T.IDENT)
        self.expect(T.LBRACKET, what="'['")
        # information-set index inside the first bracket is accepted & ignored
        while not self.check(T.RBRACKET):
            if self.cur.kind is T.EOF:
                raise GCNSyntaxError("E017", "unterminated expectation 'E[...'", e_tok.loc)
            self.advance()
        self.expect(T.RBRACKET, what="']'")
        self.expect(T.LBRACKET, what="'[' (expectation operand)")
        operand = self.parse_expr()
        self.expect(T.RBRACKET, what="']'")
        return A.Expectation(operand, loc=e_tok.loc)

    def _finish_variable(self, name_tok: Token) -> A.Variable:
        self.expect(T.LBRACKET, what="'['")
        idx: int | str
        if self.check(T.RBRACKET):
            idx = 0
        elif self.check(T.IDENT, "ss"):
            self.advance()
            idx = "ss"
        else:
            sign = -1 if self.match(T.MINUS) else 1
            num = self.cur
            if num.kind is not T.NUMBER or "." in num.text or "e" in num.text.lower():
                raise GCNSyntaxError(
                    "E008", f"invalid time index {num.text!r} for variable {name_tok.text!r}",
                    num.loc)
            self.advance()
            idx = sign * int(num.text)
        self.expect(T.RBRACKET, code="E008", what="']'")
        return A.Variable(name_tok.text, idx, loc=name_tok.loc)

    def _finish_call(self, name_tok: Token) -> A.FunctionCall:
        self.expect(T.LPAREN, what="'('")
        args: list[A.Expr] = []
        if not self.check(T.RPAREN):
            args.append(self.parse_expr())
            while self.match(T.COMMA):
                args.append(self.parse_expr())
        self.expect(T.RPAREN, what="')'")
        return A.FunctionCall(name_tok.text, tuple(args), loc=name_tok.loc)

    # -- statements ------------------------------------------------------------
    def _statement_has(self, kind: T, stop=(T.SEMI, T.RBRACE, T.EOF)) -> bool:
        """Scan ahead (at paren depth 0) for a token kind before the statement ends."""
        depth = 0
        i = self.pos
        while i < len(self.tokens):
            k = self.tokens[i].kind
            if k in (T.LPAREN, T.LBRACKET):
                depth += 1
            elif k in (T.RPAREN, T.RBRACKET):
                depth -= 1
            elif depth == 0:
                if k is kind:
                    return True
                if k in stop:
                    return False
            i += 1
        return False

    def parse_statement(self, component: str | None = None) -> Any:
        if self._statement_has(T.TILDE):
            return self._distribution_statement()
        if self.check(T.AT) or self._statement_has(T.EQUALS):
            return self._equation_statement()
        if component in ("definitions", "objective", "constraints",
                         "identities", "calibration"):
            # these components hold equations; a statement without '=' is a
            # missing-equals error, not a variable list
            start = self.cur
            self.parse_expr()
            raise GCNSyntaxError(
                "E005", f"expected '=' in equation, found {self.cur.text!r}"
                if self.cur.text else "expected '=' in equation", self.cur.loc or start.loc)
        return self._variable_list_statement()

    def _equation_statement(self) -> A.GCNEquation:
        tags: list[str] = []
        while self.match(T.AT):
            tag_tok = self.expect(T.IDENT, code="E020", what="tag name")
            if tag_tok.text not in VALID_TAGS:
                raise GCNSyntaxError("E020", f"unknown tag '@{tag_tok.text}'", tag_tok.loc,
                                     suggestions=suggest(tag_tok.text, VALID_TAGS))
            tags.append(tag_tok.text)
        start = self.cur
        if self.check(T.EQUALS):
            raise GCNSyntaxError("E006", "equation has no left-hand side", start.loc)
        lhs = self.parse_expr()
        eq_tok = self.cur
        if not self.match(T.EQUALS):
            raise GCNSyntaxError("E005", f"expected '=' in equation, found {eq_tok.text!r}",
                                 eq_tok.loc)
        if self.cur.kind in (T.SEMI, T.RBRACE, T.EOF):
            raise GCNSyntaxError("E007", "equation has no right-hand side", self.cur.loc)
        rhs = self.parse_expr()
        multiplier = None
        calibrating = None
        if self.match(T.COLON):
            mult_tok = self.expect(T.IDENT, code="E015", what="multiplier name")
            var = self._finish_variable(mult_tok)
            if var.time_index != 0:
                raise GCNSyntaxError("E015", "Lagrange multipliers are declared at time t "
                                     f"('{var.name}[]')", mult_tok.loc)
            multiplier = var.name
        if self.match(T.ARROW):
            cal_tok = self.expect(T.IDENT, code="E016", what="calibrating parameter name")
            if self.check(T.LBRACKET):
                raise GCNSyntaxError("E016", "calibrating target must be a parameter, "
                                     "not a variable", cal_tok.loc)
            calibrating = cal_tok.text
        self.expect_semi()
        return A.GCNEquation(lhs, rhs, multiplier, calibrating, tuple(tags), loc=start.loc)

    def _distribution_statement(self) -> A.GCNDistribution:
        target_tok = self.expect(T.IDENT, what="parameter or shock name")
        target_idx: int | str | None = None
        if self.check(T.LBRACKET):
            var = self._finish_variable(target_tok)
            target_idx = var.time_index
        tilde = self.cur
        if not self.match(T.TILDE):
            raise GCNSyntaxError("E011", f"expected '~', found {tilde.text!r}", tilde.loc)
        dist = self._distribution_expr()
        initial = None
        if self.match(T.EQUALS):
            sign = -1.0 if self.match(T.MINUS) else 1.0
            num = self.expect(T.NUMBER, code="E013", what="initial value")
            initial = sign * float(num.text)
        self.expect_semi()
        return A.GCNDistribution(
            target_tok.text, target_idx, dist.dist_name, dist.args, initial,
            loc=target_tok.loc,
        )

    def _distribution_expr(self) -> A.GCNDistribution:
        name_tok = self.expect(T.IDENT, code="E012", what="distribution name")
        self.expect(T.LPAREN, code="E013", what="'('")
        args: list[A.DistributionArg] = []
        while not self.check(T.RPAREN):
            if (self.cur.kind is T.IDENT and self.peek().kind is T.EQUALS):
                key = self.advance()
                self.advance()  # '='
                value = self._dist_arg_value()
                args.append(A.DistributionArg(key.text, value, loc=key.loc))
            else:
                value = self._dist_arg_value()
                args.append(A.DistributionArg(None, value, loc=name_tok.loc))
            if not self.match(T.COMMA):
                break
        self.expect(T.RPAREN, code="E013", what="')'")
        return A.GCNDistribution(name_tok.text, None, name_tok.text, tuple(args),
                                 loc=name_tok.loc)

    def _dist_arg_value(self) -> Any:
        # nested distribution (wrapper forms like maxent(Beta(), ...))
        if self.cur.kind is T.IDENT and self.peek().kind is T.LPAREN:
            return self._distribution_expr()
        return self.parse_expr()

    def _variable_list_statement(self) -> A.GCNVariableList:
        start = self.cur
        variables: list[A.Variable] = []
        while True:
            name_tok = self.expect(T.IDENT, what="variable name")
            if self.check(T.LBRACKET):
                variables.append(self._finish_variable(name_tok))
            else:
                # bare name (allowed in assumptions groups for parameters)
                variables.append(A.Variable(name_tok.text, None, loc=name_tok.loc))  # type: ignore[arg-type]
            if not self.match(T.COMMA):
                break
        self.expect_semi()
        return A.GCNVariableList(tuple(variables), loc=start.loc)

    # -- blocks -----------------------------------------------------------------
    def parse_component(self) -> A.GCNComponent:
        name_tok = self.expect(T.IDENT, what="component name")
        name = name_tok.text.lower()
        if name not in COMPONENT_NAMES:
            raise GCNSyntaxError("E010", f"unknown component {name_tok.text!r}", name_tok.loc,
                                 suggestions=suggest(name, COMPONENT_NAMES))
        self.expect(T.LBRACE, code="E002", what="'{'")
        equations: list[A.GCNEquation] = []
        variables: list[A.Variable] = []
        distributions: list[A.GCNDistribution] = []
        while not self.check(T.RBRACE):
            if self.cur.kind is T.EOF:
                raise GCNSyntaxError("E002", f"unterminated component {name!r}", name_tok.loc)
            stmt = self.parse_statement(name)
            if isinstance(stmt, A.GCNEquation):
                equations.append(stmt)
            elif isinstance(stmt, A.GCNDistribution):
                distributions.append(stmt)
            else:
                variables.extend(stmt.variables)
        self.expect(T.RBRACE, what="'}'")
        self.expect_semi()
        return A.GCNComponent(name, tuple(equations), tuple(variables),
                              tuple(distributions), loc=name_tok.loc)

    def parse_model_block(self) -> A.GCNBlock:
        kw = self.expect(T.IDENT, code="E009", what="'block'")
        if kw.text != "block":
            raise GCNSyntaxError("E009", f"expected 'block', found {kw.text!r}", kw.loc)
        name_tok = self.expect(T.IDENT, what="block name")
        self.expect(T.LBRACE, code="E002", what="'{'")
        components: list[A.GCNComponent] = []
        while not self.check(T.RBRACE):
            if self.cur.kind is T.EOF:
                raise GCNSyntaxError("E002", f"unterminated block {name_tok.text!r}",
                                     name_tok.loc)
            components.append(self.parse_component())
        self.expect(T.RBRACE, what="'}'")
        self.expect_semi()
        return A.GCNBlock(name_tok.text, tuple(components), loc=name_tok.loc)

    # -- special blocks ------------------------------------------------------------
    def parse_options(self) -> dict[str, Any]:
        self.expect(T.LBRACE, code="E002", what="'{'")
        options: dict[str, Any] = {}
        while not self.check(T.RBRACE):
            words = []
            while self.cur.kind is T.IDENT and not self.check(T.IDENT, "TRUE") \
                    and not self.check(T.IDENT, "FALSE"):
                nxt = self.peek()
                words.append(self.advance().text)
                if nxt.kind is T.EQUALS:
                    break
            if not words:
                raise GCNSyntaxError("E018", f"invalid options entry near {self.cur.text!r}",
                                     self.cur.loc)
            key = " ".join(words)
            if not self.match(T.EQUALS):
                raise GCNSyntaxError("E018", f"expected '=' in options entry {key!r}",
                                     self.cur.loc)
            options[key] = self._option_value()
            self.expect_semi()
        self.expect(T.RBRACE, what="'}'")
        self.expect_semi()
        return options

    def _option_value(self) -> Any:
        tok = self.advance()
        if tok.kind is T.NUMBER:
            return float(tok.text)
        if tok.kind is T.MINUS and self.cur.kind is T.NUMBER:
            return -float(self.advance().text)
        if tok.kind is T.IDENT:
            upper = tok.text.upper()
            if upper == "TRUE":
                return True
            if upper == "FALSE":
                return False
            return tok.text
        raise GCNSyntaxError("E018", f"invalid options value {tok.text!r}", tok.loc)

    def parse_tryreduce(self) -> tuple[A.Variable, ...]:
        self.expect(T.LBRACE, code="E002", what="'{'")
        variables: list[A.Variable] = []
        while not self.check(T.RBRACE):
            stmt = self._variable_list_statement()
            variables.extend(stmt.variables)
        self.expect(T.RBRACE, what="'}'")
        self.expect_semi()
        return tuple(variables)

    def parse_assumptions(self) -> dict[str, tuple[str, ...]]:
        self.expect(T.LBRACE, code="E002", what="'{'")
        groups: dict[str, tuple[str, ...]] = {}
        while not self.check(T.RBRACE):
            group_tok = self.expect(T.IDENT, code="E108", what="assumption name")
            self.expect(T.LBRACE, code="E002", what="'{'")
            names: list[str] = []
            while not self.check(T.RBRACE):
                stmt = self._variable_list_statement()
                names.extend(v.name for v in stmt.variables)
            self.expect(T.RBRACE, what="'}'")
            self.expect_semi()
            existing = groups.get(group_tok.text, ())
            groups[group_tok.text] = existing + tuple(names)
        self.expect(T.RBRACE, what="'}'")
        self.expect_semi()
        return groups

    # -- file -------------------------------------------------------------------
    def parse_file(self) -> A.GCNModel:
        blocks: list[A.GCNBlock] = []
        options: dict[str, Any] = {}
        tryreduce: tuple[A.Variable, ...] = ()
        assumptions: dict[str, tuple[str, ...]] = {}
        seen_names: set[str] = set()
        while self.cur.kind is not T.EOF:
            tok = self.cur
            if tok.kind is not T.IDENT:
                raise GCNSyntaxError("E009", f"expected a block, found {tok.text!r}", tok.loc)
            if tok.text == "options":
                self.advance()
                options.update(self.parse_options())
            elif tok.text == "tryreduce":
                self.advance()
                tryreduce = tryreduce + self.parse_tryreduce()
            elif tok.text == "assumptions":
                self.advance()
                for k, v in self.parse_assumptions().items():
                    assumptions[k] = assumptions.get(k, ()) + v
            elif tok.text == "block":
                blk = self.parse_model_block()
                if blk.name in seen_names:
                    raise GCNSyntaxError("E019", f"duplicate block name {blk.name!r}", blk.loc)
                seen_names.add(blk.name)
                blocks.append(blk)
            else:
                raise GCNSyntaxError(
                    "E009", f"expected 'block' or a special block, found {tok.text!r}",
                    tok.loc, suggestions=suggest(tok.text, ("block",) + SPECIAL_BLOCKS))
        return A.GCNModel(tuple(blocks), options, tryreduce, assumptions)


def parse_gcn(source: str, filename: str | None = None) -> A.GCNModel:
    """Parse GCN source text into an AST."""
    tokens = tokenize(source, filename)
    return _Parser(tokens).parse_file()


def parse_expression(source: str) -> A.Expr:
    """Parse a standalone GCN arithmetic expression (used by observation
    equations and tests)."""
    tokens = tokenize(source)
    parser = _Parser(tokens)
    expr = parser.parse_expr()
    if parser.cur.kind is not T.EOF:
        raise GCNSyntaxError("E017", f"unexpected trailing token {parser.cur.text!r}",
                             parser.cur.loc)
    return expr
