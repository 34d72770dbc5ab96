"""DMN decision engine (SURVEY §2.9 dmn/).

Reference: dmn/src/main/java/io/camunda/zeebe/dmn/ — DecisionEngine facade
(DmnScalaDecisionEngine), ParsedDecisionRequirementsGraph, DecisionEvaluation
result + audit log (EvaluatedDecision/Input/Output, MatchedRule). Re-built on
the in-repo FEEL-lite instead of the external Scala engine.
"""

from zeebe_tpu_torch.dmn.dmn import (
    DecisionEngine,
    DecisionEvaluationResult,
    DmnParseError,
    ParsedDecision,
    ParsedDrg,
    parse_dmn_xml,
)

__all__ = [
    "DecisionEngine",
    "DecisionEvaluationResult",
    "DmnParseError",
    "ParsedDecision",
    "ParsedDrg",
    "parse_dmn_xml",
]
