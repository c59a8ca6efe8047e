"""Tokenizer for the GCN model language.

Copied from ``geconpy_tpu/lang/lexer.py`` so that the port needs nothing of
the JAX package; only package names in text differ.

The reference uses pyparsing terminals (``gEconpy/parser/grammar/tokens.py``);
this is a fresh single-pass lexer with exact source locations for rustc-style
diagnostics and no backtracking.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto

from .errors import GCNSyntaxError, ParseLocation

__all__ = ["TokenKind", "Token", "tokenize"]


class TokenKind(Enum):
    IDENT = auto()
    NUMBER = auto()
    PLUS = auto()
    MINUS = auto()
    STAR = auto()
    SLASH = auto()
    CARET = auto()          # ^ and ** both lex to CARET (right-assoc power)
    EQUALS = auto()
    TILDE = auto()
    COLON = auto()
    SEMI = auto()
    COMMA = auto()
    LPAREN = auto()
    RPAREN = auto()
    LBRACE = auto()
    RBRACE = auto()
    LBRACKET = auto()
    RBRACKET = auto()
    ARROW = auto()          # ->
    AT = auto()             # @ (equation tags)
    QUESTION = auto()       # reserved
    EOF = auto()


_SINGLE = {
    "+": TokenKind.PLUS,
    "*": TokenKind.STAR,
    "/": TokenKind.SLASH,
    "^": TokenKind.CARET,
    "=": TokenKind.EQUALS,
    "~": TokenKind.TILDE,
    ":": TokenKind.COLON,
    ";": TokenKind.SEMI,
    ",": TokenKind.COMMA,
    "(": TokenKind.LPAREN,
    ")": TokenKind.RPAREN,
    "{": TokenKind.LBRACE,
    "}": TokenKind.RBRACE,
    "[": TokenKind.LBRACKET,
    "]": TokenKind.RBRACKET,
    "@": TokenKind.AT,
    "?": TokenKind.QUESTION,
}


@dataclass(frozen=True)
class Token:
    kind: TokenKind
    text: str
    loc: ParseLocation

    def __repr__(self):
        return f"Token({self.kind.name}, {self.text!r}, {self.loc.line}:{self.loc.column})"


def tokenize(source: str, filename: str | None = None) -> list[Token]:
    """GCN source -> token list (raises GCNParseError with caret context)."""
    tokens: list[Token] = []
    lines = source.splitlines()
    i = 0
    line = 1
    col = 0
    n = len(source)

    def current_line_text() -> str:
        return lines[line - 1] if 0 < line <= len(lines) else ""

    def loc(start_col: int, end_col: int | None = None) -> ParseLocation:
        return ParseLocation(line, start_col, end_col, current_line_text(), filename)

    while i < n:
        ch = source[i]
        if ch == "\n":
            i += 1
            line += 1
            col = 0
            continue
        if ch in " \t\r":
            i += 1
            col += 1
            continue
        if ch == "#":
            while i < n and source[i] != "\n":
                i += 1
                col += 1
            continue
        if ch.isalpha() or ch == "_":
            start, start_col = i, col
            while i < n and (source[i].isalnum() or source[i] == "_"):
                i += 1
                col += 1
            tokens.append(Token(TokenKind.IDENT, source[start:i], loc(start_col, col)))
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and source[i + 1].isdigit()):
            start, start_col = i, col
            seen_dot = False
            seen_exp = False
            while i < n:
                c = source[i]
                if c.isdigit():
                    i += 1
                    col += 1
                elif c == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    i += 1
                    col += 1
                elif c in "eE" and not seen_exp and i + 1 < n and (
                    source[i + 1].isdigit()
                    or (source[i + 1] in "+-" and i + 2 < n and source[i + 2].isdigit())
                ):
                    seen_exp = True
                    i += 1
                    col += 1
                    if source[i] in "+-":
                        i += 1
                        col += 1
                else:
                    break
            tokens.append(Token(TokenKind.NUMBER, source[start:i], loc(start_col, col)))
            continue
        if ch == "-":
            if i + 1 < n and source[i + 1] == ">":
                tokens.append(Token(TokenKind.ARROW, "->", loc(col, col + 2)))
                i += 2
                col += 2
            else:
                tokens.append(Token(TokenKind.MINUS, "-", loc(col, col + 1)))
                i += 1
                col += 1
            continue
        if ch == "*" and i + 1 < n and source[i + 1] == "*":
            tokens.append(Token(TokenKind.CARET, "**", loc(col, col + 2)))
            i += 2
            col += 2
            continue
        kind = _SINGLE.get(ch)
        if kind is not None:
            tokens.append(Token(kind, ch, loc(col, col + 1)))
            i += 1
            col += 1
            continue
        raise GCNSyntaxError("E001", f"unexpected character {ch!r}", loc(col, col + 1))

    tokens.append(Token(TokenKind.EOF, "", ParseLocation(line, col, col, current_line_text(), filename)))
    return tokens
