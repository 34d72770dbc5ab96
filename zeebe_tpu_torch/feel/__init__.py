"""FEEL-lite expression language (SURVEY.md §2.9 expression-language/feel)."""

from zeebe_tpu_torch.feel.feel import (
    Evaluator,
    Expression,
    FeelError,
    FeelEvalError,
    FeelParseError,
    parse_expression,
    parse_feel,
)
from zeebe_tpu_torch.feel.temporal import (
    Duration,
    FeelDate,
    FeelDateTime,
    FeelTime,
    TemporalParseError,
    YearMonthDuration,
    normalize_value,
)

__all__ = [
    "Duration",
    "Evaluator",
    "Expression",
    "FeelDate",
    "FeelDateTime",
    "FeelError",
    "FeelEvalError",
    "FeelParseError",
    "FeelTime",
    "TemporalParseError",
    "YearMonthDuration",
    "normalize_value",
    "parse_expression",
    "parse_feel",
]
