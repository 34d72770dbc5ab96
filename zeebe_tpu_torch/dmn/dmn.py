"""DMN 1.x decision tables + literal expressions over FEEL-lite.

Reference: dmn/src/main/java/io/camunda/zeebe/dmn/impl/DmnScalaDecisionEngine.java
(parse + evaluate via camunda-dmn), EvaluatedDecision/EvaluatedInput/
EvaluatedOutput/MatchedRule audit records (dmn/…/DecisionEvaluationResult).

Supported: decision tables with hit policies UNIQUE, FIRST, ANY, PRIORITY,
RULE ORDER, OUTPUT ORDER, COLLECT (+ SUM/MIN/MAX/COUNT aggregation), literal
expression decisions, decision requirement graphs (required decisions are
evaluated first, their results bound by decision id and name), and FEEL unary
tests: "-", comparisons, intervals, disjunction lists, negation, expression
equality, and "?"-referencing tests.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Callable

from zeebe_tpu_torch.feel.feel import FeelError, parse_feel

_NS = {
    "dmn": "https://www.omg.org/spec/DMN/20191111/MODEL/",
}
# older DMN namespaces seen in the wild (the reference accepts all of them)
_DMN_NAMESPACES = [
    "https://www.omg.org/spec/DMN/20191111/MODEL/",
    "http://www.omg.org/spec/DMN/20180521/MODEL/",
    "http://www.omg.org/spec/DMN/20151101/dmn.xsd",
]


class DmnParseError(Exception):
    pass


class DmnEvalError(Exception):
    pass


@dataclass
class _Input:
    input_id: str
    label: str
    expression_text: str
    expression: Any  # compiled feel


@dataclass
class _Output:
    output_id: str
    name: str
    label: str


@dataclass
class _Rule:
    rule_id: str
    input_entries: list[str]
    output_entries: list[str]
    tests: list[Callable[[Any, dict], bool]] = field(default_factory=list)
    outputs: list[Any] = field(default_factory=list)  # compiled feel


@dataclass
class ParsedDecision:
    decision_id: str
    name: str
    kind: str  # "decisionTable" | "literalExpression"
    hit_policy: str = "UNIQUE"
    aggregation: str = ""
    inputs: list[_Input] = field(default_factory=list)
    outputs: list[_Output] = field(default_factory=list)
    rules: list[_Rule] = field(default_factory=list)
    literal: Any = None  # compiled feel for literalExpression
    result_name: str | None = None  # variable name for literal decisions
    required: list[str] = field(default_factory=list)  # required decision ids


@dataclass
class ParsedDrg:
    drg_id: str
    name: str
    namespace: str
    decisions: dict[str, ParsedDecision] = field(default_factory=dict)

    def decision_ids(self) -> list[str]:
        return list(self.decisions)


@dataclass
class EvaluatedInput:
    input_id: str
    input_name: str
    input_value: Any


@dataclass
class EvaluatedOutput:
    output_id: str
    output_name: str
    output_value: Any


@dataclass
class MatchedRule:
    rule_id: str
    rule_index: int
    evaluated_outputs: list[EvaluatedOutput]


@dataclass
class EvaluatedDecision:
    decision_id: str
    decision_name: str
    decision_type: str
    output: Any
    evaluated_inputs: list[EvaluatedInput] = field(default_factory=list)
    matched_rules: list[MatchedRule] = field(default_factory=list)


@dataclass
class DecisionEvaluationResult:
    """The audit trail the engine writes into DECISION_EVALUATION records."""

    output: Any = None
    failed: bool = False
    failure_message: str = ""
    failed_decision_id: str = ""
    evaluated_decisions: list[EvaluatedDecision] = field(default_factory=list)


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _text_of(el: ET.Element | None) -> str:
    if el is None:
        return ""
    # <text> child or direct text
    for child in el:
        if _strip(child.tag) == "text":
            return (child.text or "").strip()
    return (el.text or "").strip()


def parse_dmn_xml(xml: str) -> ParsedDrg:
    """Parse one <definitions> document into a decision requirements graph."""
    try:
        root = ET.fromstring(xml)
    except ET.ParseError as exc:
        raise DmnParseError(f"invalid DMN XML: {exc}") from exc
    if _strip(root.tag) != "definitions":
        raise DmnParseError(f"expected <definitions>, got <{_strip(root.tag)}>")
    drg = ParsedDrg(
        drg_id=root.get("id", "definitions"),
        name=root.get("name", root.get("id", "definitions")),
        namespace=root.get("namespace", ""),
    )
    for el in root:
        if _strip(el.tag) != "decision":
            continue
        decision = _parse_decision(el)
        drg.decisions[decision.decision_id] = decision
    if not drg.decisions:
        raise DmnParseError("no <decision> elements in definitions")
    return drg


def _parse_decision(el: ET.Element) -> ParsedDecision:
    decision_id = el.get("id") or ""
    if not decision_id:
        raise DmnParseError("decision without id")
    name = el.get("name", decision_id)
    required: list[str] = []
    table = None
    literal = None
    result_name = None
    for child in el:
        tag = _strip(child.tag)
        if tag == "informationRequirement":
            for req in child:
                if _strip(req.tag) == "requiredDecision":
                    href = req.get("href", "")
                    required.append(href.lstrip("#"))
        elif tag == "decisionTable":
            table = child
        elif tag == "literalExpression":
            literal = child
        elif tag == "variable":
            result_name = child.get("name")
    if table is not None:
        decision = _parse_decision_table(decision_id, name, table)
    elif literal is not None:
        text = _text_of(literal)
        decision = ParsedDecision(
            decision_id, name, "literalExpression",
            literal=_compile(text, decision_id),
            result_name=result_name,
        )
    else:
        raise DmnParseError(
            f"decision '{decision_id}' has neither decisionTable nor literalExpression"
        )
    decision.required = required
    return decision


def _parse_decision_table(decision_id: str, name: str, table: ET.Element) -> ParsedDecision:
    decision = ParsedDecision(
        decision_id, name, "decisionTable",
        hit_policy=table.get("hitPolicy", "UNIQUE").upper().replace(" ", "_"),
        aggregation=table.get("aggregation", "").upper(),
    )
    for child in table:
        tag = _strip(child.tag)
        if tag == "input":
            expr_el = next((c for c in child if _strip(c.tag) == "inputExpression"), None)
            text = _text_of(expr_el)
            decision.inputs.append(_Input(
                input_id=child.get("id", f"input_{len(decision.inputs)}"),
                label=child.get("label", text),
                expression_text=text,
                expression=_compile(text, decision_id),
            ))
        elif tag == "output":
            decision.outputs.append(_Output(
                output_id=child.get("id", f"output_{len(decision.outputs)}"),
                name=child.get("name", child.get("label", f"output_{len(decision.outputs)}")),
                label=child.get("label", ""),
            ))
        elif tag == "rule":
            input_entries = []
            output_entries = []
            for entry in child:
                etag = _strip(entry.tag)
                if etag == "inputEntry":
                    input_entries.append(_text_of(entry))
                elif etag == "outputEntry":
                    output_entries.append(_text_of(entry))
            rule = _Rule(child.get("id", f"rule_{len(decision.rules)}"),
                         input_entries, output_entries)
            rule.tests = [parse_unary_tests(t, decision_id) for t in input_entries]
            rule.outputs = [_compile(t, decision_id) for t in output_entries]
            decision.rules.append(rule)
    if not decision.outputs:
        raise DmnParseError(f"decision table '{decision_id}' has no outputs")
    for rule in decision.rules:
        if len(rule.input_entries) != len(decision.inputs) or \
                len(rule.output_entries) != len(decision.outputs):
            raise DmnParseError(
                f"rule '{rule.rule_id}' arity mismatch in decision '{decision_id}'"
            )
    return decision


def _compile(text: str, decision_id: str):
    if not text:
        return None
    try:
        return parse_feel(text)
    except FeelError as exc:
        raise DmnParseError(
            f"invalid FEEL in decision '{decision_id}': {text!r}: {exc}"
        ) from exc


# -- unary tests ---------------------------------------------------------------

_CMP_OPS = ("<=", ">=", "<", ">")


def parse_unary_tests(text: str, decision_id: str = "?") -> Callable[[Any, dict], bool]:
    """FEEL unary tests → predicate(input_value, context).

    Grammar subset (reference: FEEL spec §7.3.2, camunda-feel unary tests):
    ``-`` | test{, test} | not(tests) | <op> endpoint | [a..b] | expression
    (equality, or a boolean expression over ``?``).
    """
    text = (text or "").strip()
    if text in ("", "-"):
        return lambda value, ctx: True
    # disjunction first: 'not("a"), not("b")' is a list of two negations,
    # not one big not(...) wrapper
    parts = _split_top_level(text)
    if len(parts) > 1:
        tests = [parse_unary_tests(p, decision_id) for p in parts]
        return lambda value, ctx: any(t(value, ctx) for t in tests)
    if text.startswith("not(") and text.endswith(")"):
        inner = parse_unary_tests(text[4:-1], decision_id)
        return lambda value, ctx: not inner(value, ctx)
    return _parse_single_test(text, decision_id)


def _split_top_level(text: str) -> list[str]:
    parts, depth, start, in_str = [], 0, 0, False
    for i, ch in enumerate(text):
        if ch == '"':
            in_str = not in_str
        elif not in_str:
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append(text[start:i].strip())
                start = i + 1
    parts.append(text[start:].strip())
    return [p for p in parts if p]


def _parse_single_test(text: str, decision_id: str) -> Callable[[Any, dict], bool]:
    # interval [a..b], (a..b), ]a..b[
    if text[0] in "[(]" and ".." in text and text[-1] in "])[":
        lo_closed = text[0] == "["
        hi_closed = text[-1] == "]"
        lo_text, hi_text = text[1:-1].split("..", 1)
        lo = _compile(lo_text.strip(), decision_id)
        hi = _compile(hi_text.strip(), decision_id)

        def interval(value, ctx):
            lo_v = _eval(lo, ctx)
            hi_v = _eval(hi, ctx)
            try:
                if value is None:
                    return False
                above = value >= lo_v if lo_closed else value > lo_v
                below = value <= hi_v if hi_closed else value < hi_v
                return above and below
            except TypeError:
                return False

        return interval
    for op in _CMP_OPS:
        if text.startswith(op):
            endpoint = _compile(text[len(op):].strip(), decision_id)

            def cmp(value, ctx, op=op, endpoint=endpoint):
                other = _eval(endpoint, ctx)
                try:
                    if value is None:
                        return False
                    return {
                        "<": value < other, "<=": value <= other,
                        ">": value > other, ">=": value >= other,
                    }[op]
                except TypeError:
                    return False

            return cmp
    if "?" in _strip_strings(text):
        # boolean expression over the input value, e.g. "? * 2 > 10";
        # substitute only outside string literals ('? = "N/A?"' keeps the
        # question mark inside the string)
        expr = _compile(_replace_outside_strings(text, "?", "__input__"),
                        decision_id)

        def qmark(value, ctx):
            return bool(_eval(expr, {**ctx, "__input__": value}))

        return qmark
    # plain expression: equality (or truthiness for booleans with null input)
    expr = _compile(text, decision_id)

    def eq(value, ctx):
        return _eval(expr, ctx) == value

    return eq


def _replace_outside_strings(text: str, needle: str, replacement: str) -> str:
    out, in_str = [], False
    for ch in text:
        if ch == '"':
            in_str = not in_str
            out.append(ch)
        elif not in_str and ch == needle:
            out.append(replacement)
        else:
            out.append(ch)
    return "".join(out)


def _strip_strings(text: str) -> str:
    out, in_str = [], False
    for ch in text:
        if ch == '"':
            in_str = not in_str
        elif not in_str:
            out.append(ch)
    return "".join(out)


def _eval(expr, ctx: dict):
    if expr is None:
        return None
    return expr.evaluate(ctx)


# -- evaluation ----------------------------------------------------------------


class DecisionEngine:
    """Evaluate a decision (and its required decisions) against a variable
    context; returns the full audit result."""

    def evaluate(self, drg: ParsedDrg, decision_id: str,
                 context: dict[str, Any]) -> DecisionEvaluationResult:
        result = DecisionEvaluationResult()
        if decision_id not in drg.decisions:
            result.failed = True
            result.failed_decision_id = decision_id
            result.failure_message = (
                f"no decision found for id '{decision_id}' in '{drg.drg_id}'"
            )
            return result
        ctx = dict(context)
        try:
            output = self._evaluate_decision(
                drg, drg.decisions[decision_id], ctx, result, set(), {}
            )
            result.output = output
        except DmnEvalError as exc:
            result.failed = True
            result.failed_decision_id = exc.args[1] if len(exc.args) > 1 else decision_id
            result.failure_message = str(exc.args[0])
        return result

    def _evaluate_decision(self, drg: ParsedDrg, decision: ParsedDecision,
                           ctx: dict, result: DecisionEvaluationResult,
                           visiting: set[str], memo: dict[str, Any]) -> Any:
        if decision.decision_id in memo:
            # shared requirement in a diamond-shaped DRG: evaluate once,
            # audit once (re-evaluation would duplicate both)
            return memo[decision.decision_id]
        if decision.decision_id in visiting:
            raise DmnEvalError(
                f"cyclic decision requirement at '{decision.decision_id}'",
                decision.decision_id,
            )
        visiting.add(decision.decision_id)
        # required decisions first; outputs bound by id and by name
        for req_id in decision.required:
            req = drg.decisions.get(req_id)
            if req is None:
                raise DmnEvalError(
                    f"required decision '{req_id}' not found", decision.decision_id
                )
            value = self._evaluate_decision(drg, req, ctx, result, visiting, memo)
            ctx[req.decision_id] = value
            ctx[req.name] = value
        visiting.discard(decision.decision_id)

        if decision.kind == "literalExpression":
            try:
                output = _eval(decision.literal, ctx)
            except FeelError as exc:
                raise DmnEvalError(str(exc), decision.decision_id) from exc
            result.evaluated_decisions.append(EvaluatedDecision(
                decision.decision_id, decision.name, decision.kind, output,
            ))
        else:
            output = self._evaluate_table(decision, ctx, result)
        memo[decision.decision_id] = output
        return output

    def _evaluate_table(self, decision: ParsedDecision, ctx: dict,
                        result: DecisionEvaluationResult) -> Any:
        audit = EvaluatedDecision(
            decision.decision_id, decision.name, decision.kind, None,
        )
        result.evaluated_decisions.append(audit)
        input_values = []
        for inp in decision.inputs:
            try:
                value = _eval(inp.expression, ctx)
            except FeelError as exc:
                raise DmnEvalError(
                    f"input '{inp.expression_text}' failed: {exc}",
                    decision.decision_id,
                ) from exc
            input_values.append(value)
            audit.evaluated_inputs.append(
                EvaluatedInput(inp.input_id, inp.label, value)
            )
        matched: list[tuple[int, _Rule, dict]] = []
        for index, rule in enumerate(decision.rules):
            try:
                hit = all(
                    test(value, ctx)
                    for test, value in zip(rule.tests, input_values)
                )
            except FeelError as exc:
                raise DmnEvalError(
                    f"rule '{rule.rule_id}' failed: {exc}", decision.decision_id
                ) from exc
            if not hit:
                continue
            outputs = {}
            evaluated_outputs = []
            for out_def, out_expr in zip(decision.outputs, rule.outputs):
                try:
                    out_val = _eval(out_expr, ctx)
                except FeelError as exc:
                    raise DmnEvalError(
                        f"output of rule '{rule.rule_id}' failed: {exc}",
                        decision.decision_id,
                    ) from exc
                outputs[out_def.name] = out_val
                evaluated_outputs.append(
                    EvaluatedOutput(out_def.output_id, out_def.name, out_val)
                )
            matched.append((index, rule, outputs))
            audit.matched_rules.append(
                MatchedRule(rule.rule_id, index + 1, evaluated_outputs)
            )
            if decision.hit_policy in ("FIRST",):
                break
        output = self._apply_hit_policy(decision, matched)
        audit.output = output
        return output

    def _apply_hit_policy(self, decision: ParsedDecision,
                          matched: list[tuple[int, _Rule, dict]]) -> Any:
        single_output = len(decision.outputs) == 1
        out_name = decision.outputs[0].name if single_output else None

        def shape(outputs: dict) -> Any:
            return outputs[out_name] if single_output else outputs

        policy = decision.hit_policy
        if not matched:
            return None
        if policy in ("UNIQUE",):
            if len(matched) > 1:
                raise DmnEvalError(
                    f"UNIQUE hit policy violated in '{decision.decision_id}': "
                    f"{len(matched)} rules matched", decision.decision_id,
                )
            return shape(matched[0][2])
        if policy == "ANY":
            values = [shape(m[2]) for m in matched]
            if any(v != values[0] for v in values):
                raise DmnEvalError(
                    f"ANY hit policy violated in '{decision.decision_id}': "
                    "matched rules disagree", decision.decision_id,
                )
            return values[0]
        if policy == "FIRST" or policy == "PRIORITY":
            # PRIORITY without output value ordering degrades to first-match
            return shape(matched[0][2])
        if policy in ("RULE_ORDER", "OUTPUT_ORDER"):
            return [shape(m[2]) for m in matched]
        if policy == "COLLECT":
            values = [shape(m[2]) for m in matched]
            agg = decision.aggregation
            if not agg or agg == "LIST":
                return values
            if agg == "COUNT":
                return len(values)
            non_numeric = [v for v in values
                           if not isinstance(v, (int, float)) or isinstance(v, bool)]
            if non_numeric:
                # a modeling error must surface as an evaluation failure, not a
                # plausible-looking partial aggregate (reference behavior)
                raise DmnEvalError(
                    f"COLLECT {agg} over non-numeric outputs {non_numeric!r} in "
                    f"'{decision.decision_id}'", decision.decision_id,
                )
            if agg == "SUM":
                return sum(values)
            if agg == "MIN":
                return min(values) if values else None
            if agg == "MAX":
                return max(values) if values else None
        return shape(matched[0][2])
