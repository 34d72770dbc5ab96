"""Alert-rule evaluation over the in-memory time-series store.

Prometheus-style ``expr for duration`` rules without Prometheus: a rule names
a stored series (exact name, or a histogram child like
``zeebe_journal_flush_duration_seconds:p99``), a threshold condition, and a
**for-duration** the condition must hold before the alert fires — the
for-duration is what separates "one slow flush" from "flushes have been slow
for five seconds". A second rule kind, ``changes``, counts value changes
inside a trailing window (raft-role flapping: the 0↔1 ``raft_role`` gauge
flipping four times in ten seconds is an election storm no threshold can
express).

State machine per (rule, series child): ``inactive → pending → firing →
inactive``. Transitions are reported to an optional listener (the broker
feeds them into the flight recorder) and mirrored into the
``zeebe_alerts_firing`` gauge (labels ``node``/``rule``, value = number of
firing children), whose total also rides ``/health`` details.

Evaluation is driven off the sampler tick (same cadence, same clock), so a
controlled-clock test advancing 6 virtual seconds fires a 5-second rule
deterministically.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

_M_FIRING = _REG.gauge(
    "alerts_firing",
    "alert rules currently firing (value = firing series per rule)",
    ("node", "rule"))

INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"

# a threshold rule ignores (and clears on) series whose latest sample is
# older than this: an idle broker stops appending :p99 quantile points, and
# without a staleness cutoff the last high value would keep a flush-latency
# alert firing forever on a completely quiet node
STALE_AFTER_MS = 30_000


@dataclasses.dataclass(frozen=True)
class AlertRule:
    name: str
    series: str                 # store series name (exact / histogram child)
    threshold: float = 0.0
    op: str = ">"               # ">" | "<"
    for_ms: int = 5_000
    kind: str = "threshold"     # "threshold" | "changes"
    window_ms: int = 10_000     # trailing window for "changes"
    labels_contains: str = ""   # child filter, substring of the label string
    severity: str = "warning"

    def describe(self) -> str:
        if self.kind == "changes":
            return (f"{self.series} changes >= {int(self.threshold)} "
                    f"within {self.window_ms}ms")
        return f"{self.series} {self.op} {self.threshold} for {self.for_ms}ms"


def default_rules() -> list[AlertRule]:
    """The out-of-the-box rule set + 5): exporter lag, backpressure
    drops, flush latency, raft role flapping, XLA recompile storms.
    Thresholds are deliberately conservative — a firing default alert should
    always be worth a look."""
    return [
        AlertRule(
            name="exporter_lag",
            series="zeebe_exporter_container_lag_records",
            threshold=1000.0, for_ms=5_000, severity="warning"),
        AlertRule(
            name="backpressure_drops",
            series="zeebe_dropped_request_count_total",  # stored as a rate
            threshold=1.0, for_ms=5_000, severity="warning"),
        AlertRule(
            name="journal_flush_slow",
            series="zeebe_journal_flush_duration_seconds:p99",
            threshold=0.5, for_ms=5_000, severity="critical"),
        AlertRule(
            name="raft_role_flapping",
            series="zeebe_raft_role",
            kind="changes", threshold=4.0, window_ms=10_000,
            severity="critical"),
        AlertRule(
            # the compile seam stores xla_compiles_total{cache="miss"} as a
            # rate: each cold compile is a 0→spike→0 episode (≤2 value
            # changes). Threshold 6 = ≥3 cold compiles inside a minute — a
            # recompile storm (geometry churn / redeploy loop), while the
            # expected process warmup (the two shape buckets compiling once)
            # contributes at most 4 changes and stays below it. The series
            # is process-scoped (no node label — the seam sits below the
            # broker), so like exporter lag it passes every evaluator's
            # _mine(); in an in-process multi-broker test cluster each
            # broker reports the shared storm.
            name="xla_recompile_storm",
            series="zeebe_xla_compiles_total",
            labels_contains='cache="miss"',
            kind="changes", threshold=6.0, window_ms=60_000,
            severity="warning"),
        AlertRule(
            # RSS watermark: the process self-metrics gauge (raw
            # name, un-namespaced — install_process_metrics follows the
            # prometheus_client convention) held above the watermark for
            # 10s. The default watermark is deliberately high (4 GiB);
            # deployments bound it tighter via
            # ZEEBE_ALERT_RSSWATERMARKBYTES — the scale soak wires this in
            # as an invariant monitor over the million-instance park.
            name="rss_watermark",
            series="process_resident_memory_bytes",
            threshold=float(os.environ.get(
                "ZEEBE_ALERT_RSSWATERMARKBYTES", 4 << 30)),
            for_ms=10_000, severity="critical"),
        AlertRule(
            # recovery_budget_exceeded_total is stored as a rate: a blown
            # recovery is a 0→spike→0 episode, so ANY value change inside
            # the trailing minute means a partition rebuild just ran past
            # its recovery_budget_ms. Partition-labeled only (no
            # node label — recoveries are partition-scoped), so like
            # exporter lag it passes every evaluator's _mine().
            name="recovery_budget_exceeded",
            series="zeebe_recovery_budget_exceeded_total",
            kind="changes", threshold=1.0, window_ms=60_000,
            severity="critical"),
    ]


class _SeriesState:
    __slots__ = ("state", "since_ms", "value")

    def __init__(self) -> None:
        self.state = INACTIVE
        self.since_ms = 0
        self.value = 0.0


class AlertEvaluator:
    def __init__(self, store, rules: list[AlertRule] | None = None,
                 node_id: str = "",
                 on_transition: Callable[[AlertRule, str, str, str], None] | None = None) -> None:
        self.store = store
        self.rules = rules if rules is not None else default_rules()
        self.node_id = node_id
        # (rule name, series labels) → state machine
        self._states: dict[tuple[str, str], _SeriesState] = {}
        self.on_transition = on_transition
        self._gauges = {
            r.name: _M_FIRING.labels(node_id, r.name) for r in self.rules
        }

    def add_rules(self, rules: list[AlertRule]) -> None:
        """Layer extra rules onto a live evaluator (the fleet auditor's
        burn-rate pair) — the per-rule firing gauge must exist before the
        next ``evaluate`` sweep, so appending to ``rules`` directly is not
        enough."""
        for rule in rules:
            self.rules.append(rule)
            self._gauges.setdefault(
                rule.name, _M_FIRING.labels(self.node_id, rule.name))

    # -- evaluation ------------------------------------------------------------

    def _breaches(self, rule: AlertRule, value: float) -> bool:
        return value > rule.threshold if rule.op == ">" else value < rule.threshold

    def _transition(self, rule: AlertRule, labels: str, st: _SeriesState,
                    new_state: str, now_ms: int, value: float) -> None:
        old = st.state
        st.state = new_state
        st.since_ms = now_ms
        st.value = value
        if self.on_transition is not None and old != new_state:
            try:
                self.on_transition(rule, labels, old, new_state)
            except Exception:  # noqa: BLE001 — a listener (flight recorder)
                pass           # failure must not stop rule evaluation

    def _mine(self, labels: str) -> bool:
        """Node scoping: the sampler snapshots the process-global registry,
        so in a multi-broker process every evaluator sees every broker's
        node-labeled series — evaluate only our own. Series without a
        ``node`` label (exporter lag, dropped requests) are process-scoped
        by construction and pass through (one broker per process in the
        deployed shape)."""
        if not self.node_id or 'node="' not in labels:
            return True
        return f'node="{self.node_id}"' in labels

    def _eval_threshold(self, rule: AlertRule, now_ms: int) -> None:
        for entry in self.store.latest(rule.series):
            if entry["name"] != rule.series:
                continue  # latest() prefix-matches histogram children
            labels = entry["labels"]
            if rule.labels_contains and rule.labels_contains not in labels:
                continue
            if not self._mine(labels):
                continue
            st = self._states.setdefault((rule.name, labels), _SeriesState())
            value = entry["value"]
            stale = now_ms - entry["t"] > STALE_AFTER_MS
            if stale or not self._breaches(rule, value):
                if st.state != INACTIVE:
                    self._transition(rule, labels, st, INACTIVE, now_ms, value)
                continue
            if st.state == INACTIVE:
                self._transition(rule, labels, st, PENDING, now_ms, value)
            elif st.state == PENDING and now_ms - st.since_ms >= rule.for_ms:
                self._transition(rule, labels, st, FIRING, now_ms, value)
            else:
                st.value = value

    def _eval_changes(self, rule: AlertRule, now_ms: int) -> None:
        for entry in self.store.query(rule.series, now_ms - rule.window_ms):
            if entry["name"] != rule.series:
                continue
            labels = entry["labels"]
            if rule.labels_contains and rule.labels_contains not in labels:
                continue
            if not self._mine(labels):
                continue
            samples = entry["samples"]
            changes = sum(
                1 for (_, a), (_, b) in zip(samples, samples[1:]) if a != b
            )
            st = self._states.setdefault((rule.name, labels), _SeriesState())
            if changes >= rule.threshold:
                if st.state != FIRING:
                    # changes-in-window IS the for-duration: fire immediately
                    self._transition(rule, labels, st, FIRING, now_ms,
                                     float(changes))
                else:
                    st.value = float(changes)
            elif st.state != INACTIVE:
                self._transition(rule, labels, st, INACTIVE, now_ms,
                                 float(changes))

    def evaluate(self, now_ms: int) -> None:
        for rule in self.rules:
            if rule.kind == "changes":
                self._eval_changes(rule, now_ms)
            else:
                self._eval_threshold(rule, now_ms)
        firing_per_rule: dict[str, int] = {r.name: 0 for r in self.rules}
        for (rule_name, _), st in self._states.items():
            if st.state == FIRING and rule_name in firing_per_rule:
                firing_per_rule[rule_name] += 1
        for rule_name, count in firing_per_rule.items():
            self._gauges[rule_name].set(float(count))

    # -- views -----------------------------------------------------------------

    def firing(self) -> list[dict]:
        return [a for a in self.snapshot() if a["state"] == FIRING]

    def snapshot(self) -> list[dict]:
        by_rule = {r.name: r for r in self.rules}
        out = []
        for (rule_name, labels), st in sorted(self._states.items()):
            if st.state == INACTIVE:
                continue
            rule = by_rule.get(rule_name)
            out.append({
                "rule": rule_name,
                "labels": labels,
                "state": st.state,
                "sinceMs": st.since_ms,
                "value": st.value,
                "severity": rule.severity if rule else "warning",
                "expr": rule.describe() if rule else "",
            })
        return out
