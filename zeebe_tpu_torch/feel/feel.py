"""FEEL-lite: the expression language for conditions, io-mappings, and timers.

Reference: expression-language/src/main/java/io/camunda/zeebe/el/
(FeelExpressionLanguage.java:36 — parse at deploy, evaluate against variable
context); the reference delegates to the external camunda FEEL Scala engine,
so this module is a from-scratch interpreter of the FEEL subset Zeebe
workloads use (S-FEEL + common extensions):

- literals: numbers, strings, booleans, null, lists, contexts
- variable references with dotted paths (``order.customer.name``)
- arithmetic ``+ - * /``, unary minus, comparison ``= != < <= > >=``
- boolean ``and`` / ``or`` / ``not(x)``, parentheses
- ``if <c> then <a> else <b>``
- ``x in [a..b]`` ranges and ``in`` list membership
- list filters ``xs[item > 2]`` (context entries in scope for contexts),
  1-based indexing with singleton semantics, ``for x in xs return …`` with
  ``partial``, and ``some/every x in xs satisfies …`` with ternary logic
- the camunda-feel builtin library surface: string/list/numeric/context/
  temporal functions (substring, replace/matches/split over XPath-flag
  regexes, sort, flatten, partition, round half up/down, decimal,
  context put/merge, …) plus string(), number(), contains(), starts with(),
  ends with(), upper case(), lower case(), count(), sum(), min(), max(),
  floor(), ceiling(), abs(), modulo(), not(), is defined(), string length(),
  append(), list contains(), now() (from an injected clock)
- temporal types (zeebe_tpu_torch.feel.temporal): @"…" literals, date(), time(),
  date and time(), duration(), years and months duration(), now()/today(),
  day of week()/day of year()/month of year()/week of year(), calendar
  arithmetic and comparisons, component properties (d.year, t.hour, …)

Expressions come in two forms (reference semantics): a plain attribute value is
a *static* string; a value starting with ``=`` is a FEEL expression. Parsing
happens once at deploy time (``parse``); evaluation takes a dict context.

The parsed AST is also the input for the device compiler
(zeebe_tpu_torch.ops.condition_table) which lowers numeric/boolean condition
expressions to a vectorized stack VM for in-kernel gateway decisions.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

from zeebe_tpu_torch.feel import temporal as _temporal
from zeebe_tpu_torch.feel.temporal import (
    Duration,
    FeelDate,
    FeelDateTime,
    FeelTime,
    TemporalParseError,
    YearMonthDuration,
)

# ---------------------------------------------------------------------------
# AST


@dataclasses.dataclass(frozen=True, slots=True)
class Lit:
    value: Any


@dataclasses.dataclass(frozen=True, slots=True)
class Var:
    path: tuple[str, ...]


@dataclasses.dataclass(frozen=True, slots=True)
class Unary:
    op: str
    operand: Any


@dataclasses.dataclass(frozen=True, slots=True)
class Bin:
    op: str
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True, slots=True)
class If:
    cond: Any
    then: Any
    orelse: Any


@dataclasses.dataclass(frozen=True, slots=True)
class Call:
    name: str
    args: tuple


@dataclasses.dataclass(frozen=True, slots=True)
class ListLit:
    items: tuple


@dataclasses.dataclass(frozen=True, slots=True)
class ContextLit:
    entries: tuple  # of (name, expr)


@dataclasses.dataclass(frozen=True, slots=True)
class Range:
    lo: Any
    hi: Any
    lo_closed: bool
    hi_closed: bool


@dataclasses.dataclass(frozen=True, slots=True)
class In:
    needle: Any
    haystack: Any


@dataclasses.dataclass(frozen=True, slots=True)
class For:
    """``for x in xs[, y in ys…] return expr`` — cartesian iteration with
    ``partial`` bound to the results so far (camunda-feel extension)."""

    iterators: tuple  # of (name, source_expr, hi_expr | None) — hi = range
    body: Any


@dataclasses.dataclass(frozen=True, slots=True)
class Quant:
    """``some|every x in xs[, …] satisfies cond`` with ternary logic."""

    kind: str  # "some" | "every"
    iterators: tuple
    cond: Any


@dataclasses.dataclass(frozen=True, slots=True)
class RangeVal:
    """A first-class FEEL range value ([a..b] etc.) — the operand type of
    the spec's interval-algebra builtins (before/after/meets/overlaps/…,
    DMN 1.3 §10.3.2.3.2; reference: camunda-feel ValRange)."""

    lo: Any
    hi: Any
    lo_closed: bool
    hi_closed: bool


def _contains_range(v: Any) -> bool:
    t = type(v)
    if t is RangeVal:
        return True
    if t is list:
        return any(_contains_range(x) for x in v)
    if t is dict:
        return any(_contains_range(x) for x in v.values())
    return False


class FeelError(Exception):
    pass


class FeelParseError(FeelError):
    pass


class FeelEvalError(FeelError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<op><=|>=|!=|\.\.|[=<>+\-*/(),\[\]{}.:@])
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)

# multi-word builtin names (FEEL allows spaces in function names);
# fused longest-match-first over consecutive name tokens
_MULTIWORD = {
    ("years", "and", "months", "duration"): "years and months duration",
    ("date", "and", "time"): "date and time",
    ("day", "of", "week"): "day of week",
    ("day", "of", "year"): "day of year",
    ("month", "of", "year"): "month of year",
    ("week", "of", "year"): "week of year",
    ("time", "offset"): "time offset",
    ("starts", "with"): "starts with",
    ("ends", "with"): "ends with",
    ("upper", "case"): "upper case",
    ("lower", "case"): "lower case",
    ("is", "defined"): "is defined",
    ("string", "length"): "string length",
    ("list", "contains"): "list contains",
    ("substring", "before"): "substring before",
    ("substring", "after"): "substring after",
    ("string", "join"): "string join",
    ("insert", "before"): "insert before",
    ("index", "of"): "index of",
    ("distinct", "values"): "distinct values",
    ("duplicate", "values"): "duplicate values",
    ("round", "up"): "round up",
    ("round", "down"): "round down",
    ("round", "half", "up"): "round half up",
    ("round", "half", "down"): "round half down",
    ("get", "value"): "get value",
    ("get", "entries"): "get entries",
    ("context", "put"): "context put",
    ("context", "merge"): "context merge",
    ("list", "replace"): "list replace",
    ("get", "or", "else"): "get or else",
    ("met", "by"): "met by",
    ("overlaps", "before"): "overlaps before",
    ("overlaps", "after"): "overlaps after",
    ("started", "by"): "started by",
    ("finished", "by"): "finished by",
}
_MULTIWORD_MAX = max(len(k) for k in _MULTIWORD)

_KEYWORDS = {"if", "then", "else", "and", "or", "true", "false", "null", "in", "not"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise FeelParseError(f"unexpected character {src[pos]!r} at {pos} in {src!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        tokens.append((kind, text))
    # fuse multi-word names, longest match first — but ONLY in call position
    # (followed by "(") or property position (preceded by "."): variables
    # named date/time must keep working in conjunctions like `date and time`
    fused: list[tuple[str, str]] = []
    i = 0
    while i < len(tokens):
        matched = False
        if tokens[i][0] == "name":
            after_dot = bool(fused) and fused[-1][1] == "."
            for width in range(_MULTIWORD_MAX, 1, -1):
                if i + width > len(tokens):
                    continue
                window = tokens[i : i + width]
                if not all(t[0] == "name" for t in window):
                    continue
                key = tuple(t[1] for t in window)
                if key not in _MULTIWORD:
                    continue
                before_call = (i + width < len(tokens)
                               and tokens[i + width][1] == "(")
                if not (after_dot or before_call):
                    continue
                fused.append(("name", _MULTIWORD[key]))
                i += width
                matched = True
                break
        if not matched:
            fused.append(tokens[i])
            i += 1
    return fused


# ---------------------------------------------------------------------------
# Parser (precedence climbing)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]], src: str) -> None:
        self.tokens = tokens
        self.pos = 0
        self.src = src

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise FeelParseError(f"unexpected end of expression: {self.src!r}")
        self.pos += 1
        return tok

    def expect(self, text: str) -> None:
        tok = self.next()
        if tok[1] != text:
            raise FeelParseError(f"expected {text!r}, got {tok[1]!r} in {self.src!r}")

    def at(self, text: str) -> bool:
        tok = self.peek()
        return tok is not None and tok[1] == text

    def parse(self) -> Any:
        node = self.expr()
        if self.peek() is not None:
            raise FeelParseError(f"trailing input at {self.peek()[1]!r} in {self.src!r}")
        return node

    def expr(self) -> Any:
        if self.at("if"):
            self.next()
            cond = self.expr()
            self.expect("then")
            then = self.expr()
            self.expect("else")
            orelse = self.expr()
            return If(cond, then, orelse)
        if self.at("for"):
            self.next()
            iterators = self.iterators("return")
            return For(iterators, self.expr())
        if self.at("some") or self.at("every"):
            kind = self.next()[1]
            iterators = self.iterators("satisfies")
            return Quant(kind, iterators, self.expr())
        return self.or_expr()

    def iterators(self, terminator: str) -> tuple:
        """``x in <src>[..hi][, y in …] <terminator>`` iterator clauses."""
        out = []
        while True:
            kind, name = self.next()
            if kind != "name":
                raise FeelParseError(f"expected iterator name in {self.src!r}")
            self.expect("in")
            src = self.add_expr()
            hi = None
            if self.at(".."):
                self.next()
                hi = self.add_expr()
            out.append((name, src, hi))
            if self.at(","):
                self.next()
                continue
            self.expect(terminator)
            return tuple(out)

    def or_expr(self) -> Any:
        node = self.and_expr()
        while self.at("or"):
            self.next()
            node = Bin("or", node, self.and_expr())
        return node

    def and_expr(self) -> Any:
        node = self.cmp_expr()
        while self.at("and"):
            self.next()
            node = Bin("and", node, self.cmp_expr())
        return node

    def cmp_expr(self) -> Any:
        node = self.add_expr()
        tok = self.peek()
        if tok is not None and tok[1] in ("=", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            return Bin(op, node, self.add_expr())
        if tok is not None and tok[1] == "in":
            self.next()
            return In(node, self.in_target())
        return node

    def in_target(self) -> Any:
        # only the leading-']' open-low form (]a..b]) needs special casing —
        # [a..b], [a..b), (a..b], (a..b) all parse as first-class range
        # literals in primary now (one grammar, one evaluation path)
        if self.at("]"):
            self.next()
            lo = self.expr()
            self.expect("..")
            hi = self.expr()
            closing = self.next()[1]
            if closing not in ("]", ")"):
                raise FeelParseError(f"bad range close {closing!r} in {self.src!r}")
            return Range(lo, hi, False, closing == "]")
        return self.add_expr()

    def add_expr(self) -> Any:
        node = self.mul_expr()
        while True:
            tok = self.peek()
            if tok is not None and tok[1] in ("+", "-"):
                op = self.next()[1]
                node = Bin(op, node, self.mul_expr())
            else:
                return node

    def mul_expr(self) -> Any:
        node = self.unary_expr()
        while True:
            tok = self.peek()
            if tok is not None and tok[1] in ("*", "/"):
                op = self.next()[1]
                node = Bin(op, node, self.unary_expr())
            else:
                return node

    def unary_expr(self) -> Any:
        if self.at("-"):
            self.next()
            return Unary("-", self.unary_expr())
        return self.postfix_expr()

    def postfix_expr(self) -> Any:
        node = self.primary()
        while True:
            if self.at("."):
                # path access fuses into Var where possible
                self.next()
                kind, text = self.next()
                if kind != "name":
                    raise FeelParseError(f"expected name after '.' in {self.src!r}")
                if isinstance(node, Var):
                    node = Var(node.path + (text,))
                else:
                    node = Bin("access", node, Lit(text))
            elif self.at("["):
                self.next()
                index = self.expr()
                self.expect("]")
                node = Bin("index", node, index)
            else:
                return node

    def primary(self) -> Any:
        kind, text = self.next()
        if kind == "number":
            value = float(text) if "." in text else int(text)
            return Lit(value)
        if kind == "string":
            return Lit(_unescape(text[1:-1]))
        if text == "@":
            kind2, text2 = self.next()
            if kind2 != "string":
                raise FeelParseError(f"expected string after '@' in {self.src!r}")
            try:
                return Lit(_temporal.parse_temporal_literal(_unescape(text2[1:-1])))
            except TemporalParseError as exc:
                raise FeelParseError(f"bad temporal literal in {self.src!r}: {exc}")
        if text == "]":
            # open-low range literal ]a..b] / ]a..b) — same value as (a..b]
            lo = self.expr()
            self.expect("..")
            hi = self.expr()
            closing = self.next()[1]
            if closing not in ("]", ")"):
                raise FeelParseError(f"bad range close {closing!r} in {self.src!r}")
            return Range(lo, hi, False, closing == "]")
        if text == "(":
            node = self.expr()
            if self.at(".."):
                # open-low range literal (a..b] / (a..b)
                self.next()
                hi = self.expr()
                closing = self.next()[1]
                if closing not in ("]", ")"):
                    raise FeelParseError(f"bad range close {closing!r} in {self.src!r}")
                return Range(node, hi, False, closing == "]")
            self.expect(")")
            return node
        if text == "[":
            items = []
            if not self.at("]"):
                items.append(self.expr())
                if self.at(".."):
                    # range literal [a..b] / [a..b) as a first-class value
                    self.next()
                    hi = self.expr()
                    closing = self.next()[1]
                    if closing not in ("]", ")"):
                        raise FeelParseError(f"bad range close {closing!r} in {self.src!r}")
                    return Range(items[0], hi, True, closing == "]")
                while self.at(","):
                    self.next()
                    items.append(self.expr())
            self.expect("]")
            return ListLit(tuple(items))
        if text == "{":
            entries = []
            if not self.at("}"):
                entries.append(self.context_entry())
                while self.at(","):
                    self.next()
                    entries.append(self.context_entry())
            self.expect("}")
            return ContextLit(tuple(entries))
        if kind == "name" or text in ("not",):
            if text == "true":
                return Lit(True)
            if text == "false":
                return Lit(False)
            if text == "null":
                return Lit(None)
            if text in _KEYWORDS and text != "not":
                raise FeelParseError(f"unexpected keyword {text!r} in {self.src!r}")
            if self.at("("):
                self.next()
                args = []
                if not self.at(")"):
                    args.append(self.expr())
                    while self.at(","):
                        self.next()
                        args.append(self.expr())
                self.expect(")")
                return Call(text, tuple(args))
            return Var((text,))
        raise FeelParseError(f"unexpected token {text!r} in {self.src!r}")

    def context_entry(self) -> tuple[str, Any]:
        kind, text = self.next()
        if kind == "string":
            name = _unescape(text[1:-1])
        elif kind == "name":
            name = text
        else:
            raise FeelParseError(f"bad context key {text!r} in {self.src!r}")
        self.expect(":")
        return (name, self.expr())


def _unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\\\", "\\").replace("\\n", "\n").replace("\\t", "\t")


# ---------------------------------------------------------------------------
# Evaluator


def _num(v: Any) -> float | int:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise FeelEvalError(f"expected number, got {type(v).__name__}")
    return v


def _range_contains(r: "RangeVal", p: Any) -> Any:
    if p is None or r.lo is None or r.hi is None:
        return None
    try:
        ok_lo = p >= r.lo if r.lo_closed else p > r.lo
        ok_hi = p <= r.hi if r.hi_closed else p < r.hi
    except TypeError:
        return None  # type-mismatched membership is null, not a crash
    return ok_lo and ok_hi


def _iv_before(a, b):
    """DMN 1.3 §10.3.2.3.2 interval algebra, point/range polymorphic."""
    if isinstance(a, RangeVal) and isinstance(b, RangeVal):
        return a.hi < b.lo or (a.hi == b.lo and (not a.hi_closed or not b.lo_closed))
    if isinstance(a, RangeVal):
        return a.hi < b or (a.hi == b and not a.hi_closed)
    if isinstance(b, RangeVal):
        return a < b.lo or (a == b.lo and not b.lo_closed)
    return a < b


def _iv_meets(a, b):
    _iv_ranges(a, b, "meets")
    return a.hi_closed and b.lo_closed and a.hi == b.lo


def _iv_overlaps(a, b):
    _iv_ranges(a, b, "overlaps")
    left = a.hi > b.lo or (a.hi == b.lo and a.hi_closed and b.lo_closed)
    right = a.lo < b.hi or (a.lo == b.hi and a.lo_closed and b.hi_closed)
    return left and right


def _iv_overlaps_before(a, b):
    _iv_ranges(a, b, "overlaps before")
    starts_first = a.lo < b.lo or (a.lo == b.lo and a.lo_closed and not b.lo_closed)
    reaches = a.hi > b.lo or (a.hi == b.lo and a.hi_closed and b.lo_closed)
    ends_first = a.hi < b.hi or (a.hi == b.hi and (not a.hi_closed or b.hi_closed))
    return starts_first and reaches and ends_first


def _iv_finishes(a, b):
    _iv_range(b, "finishes")
    if not isinstance(a, RangeVal):
        return b.hi_closed and a == b.hi
    return (a.hi == b.hi and a.hi_closed == b.hi_closed
            and (a.lo > b.lo or (a.lo == b.lo and (not a.lo_closed or b.lo_closed))))


def _iv_includes(a, b):
    _iv_range(a, "includes")
    if not isinstance(b, RangeVal):
        return _range_contains(a, b)  # null point stays null (ternary logic)
    lo_ok = b.lo > a.lo or (b.lo == a.lo and (a.lo_closed or not b.lo_closed))
    hi_ok = b.hi < a.hi or (b.hi == a.hi and (a.hi_closed or not b.hi_closed))
    return lo_ok and hi_ok


def _iv_starts(a, b):
    _iv_range(b, "starts")
    if not isinstance(a, RangeVal):
        return b.lo_closed and a == b.lo
    return (a.lo == b.lo and a.lo_closed == b.lo_closed
            and (a.hi < b.hi or (a.hi == b.hi and (not a.hi_closed or b.hi_closed))))


def _iv_coincides(a, b):
    if isinstance(a, RangeVal) and isinstance(b, RangeVal):
        return (a.lo == b.lo and a.hi == b.hi
                and a.lo_closed == b.lo_closed and a.hi_closed == b.hi_closed)
    if isinstance(a, RangeVal) or isinstance(b, RangeVal):
        raise FeelEvalError("coincides() needs two points or two ranges")
    return a == b


def _iv_range(x, fn):
    if not isinstance(x, RangeVal):
        raise FeelEvalError(f"{fn}() expects a range operand")


def _iv_ranges(a, b, fn):
    if not isinstance(a, RangeVal) or not isinstance(b, RangeVal):
        raise FeelEvalError(f"{fn}() expects two range operands")


def _feel_number(v):
    """number(): null on an unparseable string (spec: conversion failure
    yields null, not an error)."""
    if isinstance(v, str):
        try:
            return float(v) if "." in v or "e" in v.lower() else int(v)
        except ValueError:
            return None
    return _num(v)


_BUILTINS: dict[str, Callable[..., Any]] = {
    # interval algebra over points and ranges (DMN 1.3 §10.3.2.3.2)
    "before": _iv_before,
    "after": lambda a, b: _iv_before(b, a),
    "meets": _iv_meets,
    "met by": lambda a, b: _iv_meets(b, a),
    "overlaps": _iv_overlaps,
    "overlaps before": _iv_overlaps_before,
    "overlaps after": lambda a, b: _iv_overlaps_before(b, a),
    "finishes": _iv_finishes,
    "finished by": lambda a, b: _iv_finishes(b, a),
    "includes": _iv_includes,
    "during": lambda a, b: _iv_includes(b, a),
    "starts": _iv_starts,
    "started by": lambda a, b: _iv_starts(b, a),
    "coincides": _iv_coincides,
    "last": lambda xs: xs[-1] if isinstance(xs, list) and xs else None,
    "get or else": lambda v, default: default if v is None else v,
    "context": lambda entries: {
        e["key"]: e.get("value") for e in entries
        if isinstance(e, dict) and "key" in e
    } if isinstance(entries, list) else None,
    "list replace": lambda xs, pos, new: (
        [new if i == int(pos) - 1 else x for i, x in enumerate(xs)]
        if isinstance(xs, list) and isinstance(pos, (int, float))
        and not isinstance(pos, bool) and float(pos).is_integer()
        and 1 <= int(pos) <= len(xs) else None
    ),
    "string": lambda v: "null" if v is None else (str(v).lower() if isinstance(v, bool) else str(v)),
    "number": _feel_number,
    "contains": lambda s, sub: isinstance(s, str) and sub in s,
    "starts with": lambda s, p: isinstance(s, str) and s.startswith(p),
    "ends with": lambda s, p: isinstance(s, str) and s.endswith(p),
    "upper case": lambda s: s.upper(),
    "lower case": lambda s: s.lower(),
    "string length": lambda s: len(s),
    "count": lambda xs: len(xs),
    "sum": lambda *xs: (lambda v: sum(v) if v else None)(_nums_or_none(_listify(xs))),
    "min": lambda *xs: _minmax(min, _listify(xs)),
    "max": lambda *xs: _minmax(max, _listify(xs)),
    "floor": lambda v: math.floor(_num(v)),
    "ceiling": lambda v: math.ceil(_num(v)),
    "abs": lambda v: abs(v) if isinstance(v, (Duration, YearMonthDuration)) else abs(_num(v)),
    "modulo": lambda a, b: _num(a) % _num(b),
    "sqrt": lambda v: math.sqrt(_num(v)),
    "not": lambda v: (not v) if isinstance(v, bool) else None,
    "append": lambda xs, *vs: list(xs) + list(vs),
    "list contains": lambda xs, v: v in xs,
    "date": lambda *a: _builtin_date(*a),
    "time": lambda *a: _builtin_time(*a),
    "date and time": lambda *a: _builtin_date_time(*a),
    "duration": lambda s: _null_on_temporal_error(_temporal.parse_duration, s)
    if isinstance(s, str) else (s if isinstance(s, (Duration, YearMonthDuration)) else None),
    "years and months duration": lambda a, b: _builtin_ym_duration(a, b),
    "day of week": lambda v: _WEEKDAY_NAMES[v.weekday - 1]
    if isinstance(v, (FeelDate, FeelDateTime)) else None,
    "day of year": lambda v: (v.d if isinstance(v, FeelDate) else v.dt).timetuple().tm_yday
    if isinstance(v, (FeelDate, FeelDateTime)) else None,
    "month of year": lambda v: _MONTH_NAMES[v.month - 1]
    if isinstance(v, (FeelDate, FeelDateTime)) else None,
    "week of year": lambda v: (v.d if isinstance(v, FeelDate) else v.dt).isocalendar()[1]
    if isinstance(v, (FeelDate, FeelDateTime)) else None,
    # -- string functions (camunda-feel StringBuiltinFunctions) -------------
    "substring": lambda s, start, length=None: _substring(s, start, length),
    "substring before": lambda s, m: (
        s.split(m, 1)[0] if isinstance(s, str) and isinstance(m, str)
        and m and m in s else ("" if isinstance(s, str) else None)),
    "substring after": lambda s, m: s.split(m, 1)[1] if isinstance(s, str)
    and isinstance(m, str) and m and m in s
    else (s if isinstance(s, str) and m == "" else
          ("" if isinstance(s, str) else None)),
    "replace": lambda s, pattern, repl, flags="": _regex(
        lambda rx: rx.sub(_feel_replacement(repl, rx.groups), s), pattern, flags
    ) if isinstance(s, str) else None,
    "split": lambda s, delim: _regex(lambda rx: rx.split(s), delim)
    if isinstance(s, str) else None,
    "matches": lambda s, pattern, flags="": _regex(
        lambda rx: rx.search(s) is not None, pattern, flags
    ) if isinstance(s, str) else None,
    "string join": lambda xs, delim="", prefix=None, suffix=None: _string_join(
        xs, delim, prefix, suffix),
    # -- list functions (ListBuiltinFunctions) ------------------------------
    "concatenate": lambda *ls: [x for l in ls for x in l]
    if all(isinstance(l, list) for l in ls) else None,
    "insert before": lambda xs, pos, item: (
        xs[: int(pos) - 1] + [item] + xs[int(pos) - 1:]
        if isinstance(xs, list) and 1 <= int(pos) <= len(xs) + 1 else None),
    "remove": lambda xs, pos: (
        xs[: int(pos) - 1] + xs[int(pos):]
        if isinstance(xs, list) and 1 <= int(pos) <= len(xs) else None),
    "reverse": lambda xs: list(reversed(xs)) if isinstance(xs, list) else None,
    "index of": lambda xs, match: [i + 1 for i, x in enumerate(xs) if x == match]
    if isinstance(xs, list) else None,
    "union": lambda *ls: _distinct([x for l in ls for x in l])
    if all(isinstance(l, list) for l in ls) else None,
    "distinct values": lambda xs: _distinct(xs) if isinstance(xs, list) else None,
    "duplicate values": lambda xs: _distinct(
        [x for x in xs if xs.count(x) > 1]  # first-appearance order
    ) if isinstance(xs, list) else None,
    "flatten": lambda xs: _flatten(xs) if isinstance(xs, list) else None,
    "sort": lambda xs: sorted(xs) if isinstance(xs, list) else None,
    "sublist": lambda xs, start, length=None: _sublist(xs, start, length),
    "partition": lambda xs, size: (
        [xs[i: i + int(size)] for i in range(0, len(xs), int(size))]
        if isinstance(xs, list) and int(size) > 0 else None),
    "product": lambda *xs: (lambda v: math.prod(v) if v else None)(
        _nums_or_none(_listify(xs))),
    "mean": lambda *xs: (lambda v: sum(v) / len(v) if v else None)(
        _nums_or_none(_listify(xs))),
    "median": lambda *xs: (lambda v: _median(v) if v else None)(
        _nums_or_none(_listify(xs))),
    "stddev": lambda *xs: (lambda v: _stddev(v) if v and len(v) > 1 else None)(
        _nums_or_none(_listify(xs))),
    "mode": lambda *xs: (lambda v: _mode(v) if v is not None else None)(
        _nums_or_none(_listify(xs))),
    "all": lambda xs: _all_bool(xs, True) if isinstance(xs, list) else None,
    "any": lambda xs: _all_bool(xs, False) if isinstance(xs, list) else None,
    # -- numeric functions (NumericBuiltinFunctions) ------------------------
    "round up": lambda n, scale=0: _scaled_round(n, scale, "up"),
    "round down": lambda n, scale=0: _scaled_round(n, scale, "down"),
    "round half up": lambda n, scale=0: _scaled_round(n, scale, "half_up"),
    "round half down": lambda n, scale=0: _scaled_round(n, scale, "half_down"),
    "decimal": lambda n, scale: _scaled_round(n, scale, "half_even"),
    "exp": lambda v: math.exp(_num(v)),
    "log": lambda v: math.log(_num(v)) if _num(v) > 0 else None,
    "odd": lambda v: _num(v) % 2 != 0,
    "even": lambda v: _num(v) % 2 == 0,
    # -- context functions (ContextBuiltinFunctions) ------------------------
    "get value": lambda ctx, key: ctx.get(key) if isinstance(ctx, dict) else None,
    "get entries": lambda ctx: [{"key": k, "value": v} for k, v in ctx.items()]
    if isinstance(ctx, dict) else None,
    "context put": lambda ctx, key, value: {**ctx, key: value}
    if isinstance(ctx, dict) and isinstance(key, str) else None,
    "context merge": lambda *cs: (
        {k: v for c in (cs[0] if len(cs) == 1 and isinstance(cs[0], list) else cs)
         for k, v in c.items()}
        if all(isinstance(c, dict)
               for c in (cs[0] if len(cs) == 1 and isinstance(cs[0], list) else cs))
        else None),
}


def _substring(s, start, length):
    if not isinstance(s, str):
        return None
    start = int(start)
    if start == 0 or (start < 0 and -start > len(s)):
        return None  # FEEL positions are 1-based; out of range → null
    i = start - 1 if start > 0 else len(s) + start
    end = len(s) if length is None else i + int(length)
    return s[i:end]


def _sublist(xs, start, length):
    if not isinstance(xs, list):
        return None
    start = int(start)
    if start == 0 or abs(start) > len(xs):
        return None
    i = start - 1 if start > 0 else len(xs) + start
    end = len(xs) if length is None else i + int(length)
    return xs[i:end]


def _regex(apply, pattern, flags=""):
    """camunda-feel regex builtins: XPath-style flags; invalid patterns are
    null, not errors."""
    f = 0
    for ch in flags or "":
        f |= {"i": re.IGNORECASE, "s": re.DOTALL, "m": re.MULTILINE,
              "x": re.VERBOSE}.get(ch, 0)
    try:
        return apply(re.compile(pattern, f))
    except re.error:
        return None


def _feel_replacement(repl: str, ngroups: int) -> str:
    """XPath replacement syntax → Python: $N takes the LONGEST digit prefix
    not exceeding the pattern's group count (so "$12" with one group is
    group 1 followed by a literal '2'); $0 is the whole match. A reference
    no prefix satisfies replaces with nothing, leaving trailing digits."""
    def sub(m):
        digits = m.group(1)
        for k in range(len(digits), 0, -1):
            n = int(digits[:k])
            if n <= ngroups:
                return f"\\g<{n}>{digits[k:]}"
        return digits[1:]  # $9 with fewer groups: drop the unresolvable digit

    return re.sub(r"\$(\d+)", sub, repl)


def _string_join(xs, delim, prefix, suffix):
    if not isinstance(xs, list):
        return None
    parts = [x for x in xs if x is not None]
    if not all(isinstance(x, str) for x in parts):
        return None
    joined = (delim or "").join(parts)
    if prefix is not None or suffix is not None:
        return (prefix or "") + joined + (suffix or "")
    return joined


def _listify(xs: tuple):
    """camunda-feel aggregate builtins accept both a single list and
    varargs (mean([1,2,3]) == mean(1,2,3)), like min/max here."""
    if len(xs) == 1 and isinstance(xs[0], list):
        return xs[0]
    return list(xs)


def _minmax(fn, v):
    """min/max return null on empty lists and incomparable/null members,
    like camunda-feel (instead of an evaluation incident)."""
    if not v:
        return None
    try:
        return fn(v)
    except TypeError:
        return None


def _nums_or_none(v) -> list | None:
    """All-numbers view of a list, or None — numeric aggregates return null
    (not an evaluation error) when any member is null/non-numeric, like
    camunda-feel."""
    if not isinstance(v, list):
        return None
    for x in v:
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            return None
    return v


def _distinct(xs: list) -> list:
    out: list = []
    for x in xs:
        if x not in out:
            out.append(x)
    return out


def _flatten(xs):
    out: list = []
    for x in xs:
        if isinstance(x, list):
            out.extend(_flatten(x))
        else:
            out.append(x)
    return out


def _median(xs: list):
    vals = sorted(_num(x) for x in xs)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2


def _stddev(xs: list):
    vals = [_num(x) for x in xs]
    m = sum(vals) / len(vals)
    return math.sqrt(sum((v - m) ** 2 for v in vals) / (len(vals) - 1))


def _mode(xs: list):
    if not xs:
        return []
    counts: dict = {}
    for x in xs:
        counts[_num(x)] = counts.get(_num(x), 0) + 1
    best = max(counts.values())
    return sorted(v for v, c in counts.items() if c == best)


def _all_bool(xs: list, conjunctive: bool):
    """all()/any() ternary logic: non-boolean members poison to null unless
    the result is already decided by a False (all) / True (any)."""
    saw_null = False
    for x in xs:
        if not isinstance(x, bool):
            saw_null = True
        elif x is not conjunctive:
            return not conjunctive
    return None if saw_null else conjunctive


def _scaled_round(n, scale, mode: str):
    import decimal

    try:
        # str() recovers the shortest decimal literal of the float —
        # matching camunda-feel, whose number literals are exact BigDecimals
        # (decimal(2.515, 2) is a true tie there and half-even gives 2.52)
        d = decimal.Decimal(str(_num(n)))
    except FeelEvalError:
        return None
    exp = decimal.Decimal(1).scaleb(-int(scale))
    rounding = {
        "up": decimal.ROUND_UP,
        "down": decimal.ROUND_DOWN,
        "half_up": decimal.ROUND_HALF_UP,
        "half_down": decimal.ROUND_HALF_DOWN,
        "half_even": decimal.ROUND_HALF_EVEN,
    }[mode]
    q = d.quantize(exp, rounding=rounding)
    f = float(q)
    return int(f) if f.is_integer() else f

_WEEKDAY_NAMES = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                  "Saturday", "Sunday")
_MONTH_NAMES = ("January", "February", "March", "April", "May", "June", "July",
                "August", "September", "October", "November", "December")


def _null_on_temporal_error(fn, *args):
    """camunda-feel returns null (with a warning) when a temporal constructor
    cannot parse its input; invalid input must not fail the expression."""
    try:
        return fn(*args)
    except TemporalParseError:
        return None


def _builtin_date(*args):
    if len(args) == 3:
        try:
            import datetime as _dt

            return FeelDate(_dt.date(int(args[0]), int(args[1]), int(args[2])))
        except (ValueError, TypeError):
            return None
    (v,) = args
    if isinstance(v, str):
        return _null_on_temporal_error(_temporal.parse_date, v)
    if isinstance(v, FeelDateTime):
        return v.date()
    if isinstance(v, FeelDate):
        return v
    return None


def _builtin_time(*args):
    import datetime as _dt

    if len(args) in (3, 4):
        try:
            tz = None
            if len(args) == 4 and isinstance(args[3], Duration):
                tz = _dt.timezone(_dt.timedelta(milliseconds=args[3].millis))
            sec = float(args[2])
            micros = int(round((sec - int(sec)) * 1e6))
            return FeelTime(_dt.time(int(args[0]), int(args[1]), int(sec), micros, tzinfo=tz))
        except (ValueError, TypeError):
            return None
    (v,) = args
    if isinstance(v, str):
        return _null_on_temporal_error(_temporal.parse_time, v)
    if isinstance(v, FeelDateTime):
        return v.time()
    if isinstance(v, FeelTime):
        return v
    return None


def _builtin_date_time(*args):
    import datetime as _dt

    if len(args) == 2:
        date_part, time_part = args
        if isinstance(date_part, FeelDateTime):
            date_part = date_part.date()
        if isinstance(date_part, FeelDate) and isinstance(time_part, FeelTime):
            return FeelDateTime(
                _dt.datetime.combine(date_part.d, time_part.t), zone=time_part.zone
            )
        return None
    (v,) = args
    if isinstance(v, str):
        return _null_on_temporal_error(_temporal.parse_date_time, v)
    if isinstance(v, FeelDateTime):
        return v
    if isinstance(v, FeelDate):
        return _builtin_date_time(str(v))
    return None


def _builtin_ym_duration(a, b):
    if isinstance(a, FeelDateTime):
        a = a.date()
    if isinstance(b, FeelDateTime):
        b = b.date()
    if not (isinstance(a, FeelDate) and isinstance(b, FeelDate)):
        return None
    months = (b.year - a.year) * 12 + (b.month - a.month)
    # truncate toward zero on partial months (FEEL spec)
    if months > 0 and b.day < a.day:
        months -= 1
    elif months < 0 and b.day > a.day:
        months += 1
    return YearMonthDuration(months)


class Evaluator:
    def __init__(self, context: dict[str, Any], clock_millis: Callable[[], int] | None = None):
        self.ctx = context
        self.clock_millis = clock_millis

    def eval(self, node: Any) -> Any:
        method = getattr(self, f"_eval_{type(node).__name__}")
        return method(node)

    def _eval_Lit(self, node: Lit) -> Any:
        return node.value

    def _eval_Var(self, node: Var) -> Any:
        value: Any = self.ctx
        for part in node.path:
            if isinstance(value, dict) and part in value:
                value = value[part]
            elif _temporal.is_temporal(value):
                value = _temporal.temporal_property(value, part)
            else:
                return None  # FEEL: missing variable evaluates to null
        return value

    def _index_or_filter(self, node: Bin) -> Any:
        """``a[e]``: a number selects (1-based, negative from the end, with
        FEEL's singleton semantics on non-lists); anything else filters with
        ``item`` — and, for context elements, their entries — in scope."""
        left = self.eval(node.left)
        try:
            sel = self.eval(node.right)
        except FeelEvalError:
            sel = None  # e.g. `item` arithmetic unbound here → filter below
        if isinstance(sel, (int, float)) and not isinstance(sel, bool):
            if float(sel) != int(sel):
                return None  # FEEL: a non-integer index is null, not truncated
            items = left if isinstance(left, list) else (
                [] if left is None else [left])
            i = int(sel)
            if 1 <= i <= len(items):
                return items[i - 1]
            if -len(items) <= i <= -1:
                return items[i]
            return None
        src = left if isinstance(left, list) else ([] if left is None else [left])
        out = []
        # ONE scope dict reused across elements (a per-element full-context
        # merge would be O(n·|ctx|)); dict elements still merge — their
        # entries enter the scope and must not leak between elements
        scope = dict(self.ctx)
        ev = Evaluator(scope, self.clock_millis)
        for el in src:
            if isinstance(el, dict):
                ev.ctx = {**self.ctx, **el, "item": el}
            else:
                ev.ctx = scope
                scope["item"] = el
            try:
                keep = ev.eval(node.right)
            except FeelEvalError:
                keep = None
            if keep is True:
                out.append(el)
        return out

    @staticmethod
    def _iter_bound(ev: "Evaluator", iterator) -> list:
        """An iterator clause's values, evaluated under ``ev``'s scope (which
        carries the bindings of the clauses to its left:
        ``for x in xs, y in x.ys …``)."""
        _name, src, hi = iterator
        if hi is not None:
            lo_v = ev.eval(src)
            hi_v = ev.eval(hi)
            if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                       for v in (lo_v, hi_v)):
                return []
            lo_i, hi_i = int(lo_v), int(hi_v)
            step = 1 if hi_i >= lo_i else -1
            return list(range(lo_i, hi_i + step, step))
        v = ev.eval(src)
        if isinstance(v, list):
            return v
        return [] if v is None else [v]

    def _eval_For(self, node: For) -> list:
        results: list = []
        # one shared scope, mutated per binding (save/restore is unnecessary:
        # inner clauses may only shadow ctx names, and the scope dies with
        # this evaluation). ``partial`` rebinds to a SNAPSHOT per iteration —
        # aliasing the live list would let a body that returns ``partial``
        # build a self-referential list (circular JSON on persistence) — but
        # only when the body actually reads it: a per-iteration copy would
        # make every plain for-loop O(n²)
        scope = dict(self.ctx)
        ev = Evaluator(scope, self.clock_millis)
        # scan body AND iterator sources: a later clause's source may read
        # the results so far (`for x in xs, y in partial return …`)
        wants_partial = _references_name((node.body, node.iterators), "partial")

        def rec(i: int) -> None:
            if wants_partial:
                # fresh snapshot for the body AND for iterator sources (a
                # later clause may iterate the results so far)
                scope["partial"] = list(results)
            if i == len(node.iterators):
                results.append(ev.eval(node.body))
                return
            name = node.iterators[i][0]
            for v in self._iter_bound(ev, node.iterators[i]):
                scope[name] = v
                rec(i + 1)

        rec(0)
        return results

    def _eval_Quant(self, node: Quant) -> Any:
        """some/every with ternary logic: an undecided quantifier poisoned by
        a non-boolean condition result is null, like all()/any()."""
        saw_null = False
        decided = None
        scope = dict(self.ctx)
        ev = Evaluator(scope, self.clock_millis)

        def rec(i: int) -> bool:
            nonlocal saw_null, decided
            if i == len(node.iterators):
                try:
                    r = ev.eval(node.cond)
                except FeelEvalError:
                    r = None
                if not isinstance(r, bool):
                    saw_null = True
                elif node.kind == "some" and r:
                    decided = True
                    return True
                elif node.kind == "every" and not r:
                    decided = False
                    return True
                return False
            name = node.iterators[i][0]
            for v in self._iter_bound(ev, node.iterators[i]):
                scope[name] = v
                if rec(i + 1):
                    return True
            return False

        rec(0)
        if decided is not None:
            return decided
        if saw_null:
            return None
        return node.kind == "every"

    def _eval_Unary(self, node: Unary) -> Any:
        v = self.eval(node.operand)
        if isinstance(v, (Duration, YearMonthDuration)):
            return -v
        return -_num(v)

    def _eval_Bin(self, node: Bin) -> Any:
        op = node.op
        if op == "and":
            left = self.eval(node.left)
            if left is False:
                return False
            right = self.eval(node.right)
            if left is True and right is True:
                return True
            return False if right is False else None
        if op == "or":
            left = self.eval(node.left)
            if left is True:
                return True
            right = self.eval(node.right)
            if right is True:
                return True
            return False if (left is False and right is False) else None
        if op == "index":
            return self._index_or_filter(node)
        left = self.eval(node.left)
        right = self.eval(node.right)
        if op == "access":
            if isinstance(left, dict):
                return left.get(right)
            if _temporal.is_temporal(left):
                return _temporal.temporal_property(left, right)
            return None
        if op == "=":
            return left == right
        if op == "!=":
            return left != right
        if op in ("<", "<=", ">", ">="):
            if left is None or right is None:
                return None
            try:
                if op == "<":
                    return left < right
                if op == "<=":
                    return left <= right
                if op == ">":
                    return left > right
                return left >= right
            except TypeError:
                raise FeelEvalError(f"cannot compare {type(left).__name__} and {type(right).__name__}")
        if left is None or right is None:
            return None
        if op in ("+", "-", "*", "/") and (
            _temporal.is_temporal(left) or _temporal.is_temporal(right)
        ):
            fn = {
                "+": _temporal.temporal_add,
                "-": _temporal.temporal_sub,
                "*": _temporal.temporal_mul,
                "/": _temporal.temporal_div,
            }[op]
            result = fn(left, right)
            if result is NotImplemented:
                raise FeelEvalError(
                    f"cannot apply {op!r} to {type(left).__name__} and {type(right).__name__}"
                )
            return result
        if op == "+":
            if isinstance(left, str) and isinstance(right, str):
                return left + right
            return _num(left) + _num(right)
        if op == "-":
            return _num(left) - _num(right)
        if op == "*":
            return _num(left) * _num(right)
        if op == "/":
            divisor = _num(right)
            if divisor == 0:
                return None  # FEEL: division by zero is null
            return _num(left) / divisor
        raise FeelEvalError(f"unknown operator {op!r}")

    def _eval_If(self, node: If) -> Any:
        return self.eval(node.then) if self.eval(node.cond) is True else self.eval(node.orelse)

    def _eval_Call(self, node: Call) -> Any:
        if node.name == "is defined":
            return self.eval(node.args[0]) is not None
        if node.name in ("now", "today"):
            if self.clock_millis is None:
                raise FeelEvalError(f"{node.name}() requires a clock")
            dt = FeelDateTime.from_epoch_millis(self.clock_millis())
            return dt if node.name == "now" else dt.date()
        fn = _BUILTINS.get(node.name)
        if fn is None:
            raise FeelEvalError(f"unknown function {node.name!r}")
        args = [self.eval(a) for a in node.args]
        try:
            return fn(*args)
        except FeelEvalError:
            raise
        except Exception as exc:  # noqa: BLE001 — builtin misuse becomes an eval error
            raise FeelEvalError(f"{node.name}() failed: {exc}")

    def _eval_ListLit(self, node: ListLit) -> Any:
        return [self.eval(item) for item in node.items]

    def _eval_ContextLit(self, node: ContextLit) -> Any:
        return {name: self.eval(expr) for name, expr in node.entries}

    def _eval_Range(self, node: Range) -> Any:
        return RangeVal(self.eval(node.lo), self.eval(node.hi),
                        node.lo_closed, node.hi_closed)

    def _eval_In(self, node: In) -> Any:
        needle = self.eval(node.needle)
        hay = self.eval(node.haystack)
        if isinstance(hay, list):
            return needle in hay
        if isinstance(hay, RangeVal):
            return _range_contains(hay, needle)
        return None


# ---------------------------------------------------------------------------
# Public API (the ExpressionLanguage facade)


def _ast_any(node: Any, pred) -> bool:
    """Generic AST walk: True when ``pred`` holds for any node."""
    if pred(node):
        return True
    if isinstance(node, (list, tuple)):
        return any(_ast_any(x, pred) for x in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return any(
            _ast_any(getattr(node, f.name), pred)
            for f in dataclasses.fields(node)
        )
    return False


def _references_name(node: Any, name: str) -> bool:
    """True when the AST reads the given root variable name anywhere."""
    return _ast_any(node, lambda n: isinstance(n, Var) and n.path[0] == name)


def _ast_references_clock(node: Any) -> bool:
    """True when the AST calls now() anywhere — the expression's value then
    depends on the evaluation clock, not only on its variable context."""
    return _ast_any(
        node, lambda n: isinstance(n, Call) and n.name in ("now", "today"))


@dataclasses.dataclass(frozen=True, slots=True)
class Expression:
    """A parsed expression: static string or FEEL AST (reference:
    el/Expression.java — isStatic/getExpression)."""

    source: str
    is_static: bool
    ast: Any = None

    def evaluate(self, context: dict[str, Any], clock_millis: Callable[[], int] | None = None) -> Any:
        if self.is_static:
            return self.source
        result = Evaluator(context, clock_millis).eval(self.ast)
        if _contains_range(result):
            # ranges are evaluation-internal values (interval builtins);
            # a range RESULT cannot serialize into a variable document —
            # fail as an eval error so callers raise a resolvable incident
            raise FeelEvalError(
                f"expression {self.source!r} evaluated to a range, which "
                "cannot be stored as a variable")
        return result

    def references_clock(self) -> bool:
        """True when evaluation reads the clock (now() in the AST): the value
        is not a pure function of the variable context, so consumers that
        cache or template derived values must not assume clock+constant."""
        return not self.is_static and _ast_references_clock(self.ast)


_parse_cache: dict[str, Expression] = {}


def parse_expression(source: str | None) -> Expression | None:
    """Attribute-value semantics: ``= expr`` is FEEL, anything else static.
    Parse errors raise FeelParseError at deploy time (reference behavior:
    invalid expressions reject the deployment)."""
    if source is None:
        return None
    cached = _parse_cache.get(source)
    if cached is not None:
        return cached
    if source.startswith("="):
        ast = _Parser(_tokenize(source[1:]), source).parse()
        expr = Expression(source=source, is_static=False, ast=ast)
    else:
        expr = Expression(source=source, is_static=True)
    if len(_parse_cache) < 10000:
        _parse_cache[source] = expr
    return expr


def parse_feel(source: str) -> Expression:
    """Parse a bare FEEL expression (no '=' marker), e.g. condition bodies."""
    return Expression(source=source, is_static=False, ast=_Parser(_tokenize(source), source).parse())
