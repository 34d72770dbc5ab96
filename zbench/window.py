"""What a per-layer metric reads: the program's counters and histograms as
they moved over the window, the automaton's grid launch counts, the closed
loop's own counts and, on the card, the reduced device trace. Each
reader in ``zbench/metrics/`` takes a :class:`Window` and returns a number,
or None where it finds nothing to read."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def labels_of(label_str: str) -> dict:
    return dict(_LABEL.findall(label_str))


def registry_state(registry) -> dict:
    """(name, labels) -> value, or (count, sum) for a histogram."""
    out = {}
    for name, kind, label_str, value in registry.snapshot():
        key = (name, label_str)
        out[key] = (value[0], value[1]) if kind == "histogram" else value
    return out


@dataclass
class Window:
    seconds: float
    before: dict
    after: dict
    grid_launches: dict = field(default_factory=dict)
    #: the closed loop's activations in the window: jobs each returned
    activations: list = field(default_factory=list)
    #: the reduced device trace of a run on the card (``trace.reduce``), else None
    trace: dict | None = None
    #: the window's end-to-end numbers (``stats.end_to_end``), which a cell
    #: whose tails swing too widely for a bound reads as per-layer metrics
    e2e: dict = field(default_factory=dict)

    def _moved(self, name: str, match: dict | None = None):
        """The summed change over the window of every series of ``name``
        whose labels hold ``match``."""
        total = None
        for (metric, label_str), value in self.after.items():
            if metric != name:
                continue
            if match and any(labels_of(label_str).get(k) != v for k, v in match.items()):
                continue
            old = self.before.get((metric, label_str))
            if isinstance(value, tuple):
                old = old or (0, 0.0)
                moved = (value[0] - old[0], value[1] - old[1])
                total = moved if total is None else (total[0] + moved[0], total[1] + moved[1])
            else:
                moved = value - (old or 0.0)
                total = moved if total is None else total + moved
        return total

    def histogram(self, name: str) -> tuple[int, float]:
        """(observations, their sum) over the window."""
        return self._moved(name) or (0, 0.0)

    def counter(self, name: str, **match) -> float:
        return self._moved(name, match) or 0.0
