"""ISO-8601 duration/cycle parsing for timer definitions.

Reference: the engine's timer transformation uses the BPMN timer definitions
(duration PT5S, cycles R3/PT10S, dates) evaluated via FEEL; this module is the
duration arithmetic behind it.
"""

from __future__ import annotations

import re

_CYCLE_RE = re.compile(r"^R(?P<reps>\d*)/(?P<dur>.+)$")


class InvalidTimerError(ValueError):
    pass


def parse_duration_millis(text: str) -> int:
    """'PT5S' → 5000. Timer intervals are non-negative days-time spans
    (years/months and negative spans are rejected — the engine's interval
    subset). Delegates to the single ISO-duration parser in feel.temporal."""
    from zeebe_tpu_torch.feel.temporal import Duration, TemporalParseError, parse_duration

    try:
        d = parse_duration(text)
    except TemporalParseError as exc:
        raise InvalidTimerError(f"invalid ISO-8601 duration: {text!r}") from exc
    if not isinstance(d, Duration) or d.millis < 0:
        raise InvalidTimerError(f"not a timer interval: {text!r}")
    return d.millis


def parse_cycle(text: str) -> tuple[int, int]:
    """'R3/PT10S' → (3, 10000); 'R/PT10S' → (-1, 10000) (infinite)."""
    m = _CYCLE_RE.match(text.strip())
    if not m:
        raise InvalidTimerError(f"invalid ISO-8601 cycle: {text!r}")
    reps = int(m.group("reps")) if m.group("reps") else -1
    return reps, parse_duration_millis(m.group("dur"))
