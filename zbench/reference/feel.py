"""The part of FEEL that the reference knows, for the conditions on an
exclusive gateway's outgoing flows: an instance variable compared with an
integer literal (``<``, ``<=``, ``>``, ``>=``, ``=``, ``!=``), joined by
``and`` and ``or`` (``and`` binds tighter) and grouped by parentheses. A
leading ``=`` marks the text as an expression, as in Zeebe's models. Any
other text is refused when the model is read, so a condition the reference
cannot evaluate never reaches a run."""

from __future__ import annotations

import operator
import re
from dataclasses import dataclass

COMPARISONS = {"<": operator.lt, "<=": operator.le, ">": operator.gt, ">=": operator.ge,
               "=": operator.eq, "!=": operator.ne}
KEYWORDS = frozenset({"and", "or", "not", "true", "false", "null"})

_TOKEN = re.compile(r"\s*(?:(?P<int>-?\d+)(?![\w.])|(?P<name>[A-Za-z_]\w*)"
                    r"|(?P<op><=|>=|!=|<|>|=)|(?P<paren>[()]))")


@dataclass(frozen=True)
class Compare:
    variable: str
    op: str
    literal: int

    def holds(self, variables: dict) -> bool:
        if self.variable not in variables:
            raise ValueError(f"the condition reads {self.variable}, which the instance "
                             f"does not have")
        return COMPARISONS[self.op](variables[self.variable], self.literal)


@dataclass(frozen=True)
class Junction:
    op: str  # "and", "or"
    parts: tuple

    def holds(self, variables: dict) -> bool:
        results = (p.holds(variables) for p in self.parts)
        return all(results) if self.op == "and" else any(results)


def _tokens(text: str) -> list[tuple[str, str]]:
    out, at, text = [], 0, text.rstrip()
    while at < len(text):
        m = _TOKEN.match(text, at)
        if m is None:
            raise ValueError(f"cannot read {text[at:].strip()!r}")
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
        at = m.end()
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]) -> None:
        self.tokens, self.at = tokens, 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.at] if self.at < len(self.tokens) else None

    def take(self) -> tuple[str, str]:
        token = self.peek()
        if token is None:
            raise ValueError("the expression ends too early")
        self.at += 1
        return token

    def junction(self, op: str, part):
        parts = [part()]
        while self.peek() == ("name", op):
            self.take()
            parts.append(part())
        return parts[0] if len(parts) == 1 else Junction(op, tuple(parts))

    def disjunction(self):
        return self.junction("or", self.conjunction)

    def conjunction(self):
        return self.junction("and", self.atom)

    def atom(self):
        kind, text = self.take()
        if (kind, text) == ("paren", "("):
            inner = self.disjunction()
            if self.take() != ("paren", ")"):
                raise ValueError("a parenthesis is not closed")
            return inner
        if kind != "name" or text in KEYWORDS:
            raise ValueError(f"expected a variable, found {text!r}")
        op_kind, op = self.take()
        if op_kind != "op":
            raise ValueError(f"expected a comparison after {text}, found {op!r}")
        literal_kind, literal = self.take()
        if literal_kind != "int":
            raise ValueError(f"{text} {op} is compared with {literal!r}, not an integer")
        return Compare(text, op, int(literal))


def parse(text: str):
    """The condition ``text`` (with or without its leading ``=``), as an
    object whose ``holds(variables)`` evaluates it; ValueError where the
    text is outside the subset."""
    body = text.strip()
    body = body[1:] if body.startswith("=") else body
    parser = _Parser(_tokens(body))
    if parser.peek() is None:
        raise ValueError("the condition is empty")
    condition = parser.disjunction()
    if parser.peek() is not None:
        raise ValueError(f"unexpected {parser.peek()[1]!r}")
    return condition
