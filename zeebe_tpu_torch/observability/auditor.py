"""The fleet auditor: online invariant monitoring, SLO burn-rate alerts,
and leak-trend detection.

Every safety property the repo bought so far (PRs 9/11/14/15) is verified
*offline, after* a ≤2-minute gate. "Gray Failure" (Huang et al., HotOS'17)
argues the dangerous production state is degraded-but-not-dead — invisible
to binary health checks — and the Autopilot discipline (Rzadca et al.,
EuroSys'20) that long-horizon operation must be *audited*, not assumed.
This module watches the cluster's own invariants while it runs:

- :class:`BrokerAuditor` — per-broker, ticked off the EXISTING sampler
  cadence inside ``Broker.pump_control``. Monitors:

  * **acked-position monotonicity** per partition (stream last position and
    the processor's last processed position must never move backward within
    a process life);
  * **exporter-sequence gaplessness** per (exporter, partition): the
    persisted cursor is monotone and never ahead of the log end, and the
    delivery watermark never trails the persisted cursor;
  * **quarantine-latch duration bounds**: a device-health ladder latched in
    QUARANTINED beyond the configured bound (the canary loop should have
    re-proved or kept failing a real device long before) is flagged;
  * **replica-CRC spot checkpoints**: a windowed CRC over the replicated
    log's record bytes, finalized per aligned position window — replicas
    that hold the same window MUST agree (Raft log matching), and the
    checkpoints ride the existing worker status push for the harness-side
    comparison.

  Verdicts become typed ``audit_alert`` flight events on the node ring,
  ``zeebe_audit_*`` metrics, and the ``audit`` block on
  ``/cluster/status`` (and therefore the worker status push).

- **multi-window SLO burn-rate alerting** (:class:`BurnRateTracker`),
  layered on ``alerts.py``: each auditor tick classifies the admission
  ack-p99 and goodput against the SLO, accumulates fast/slow windows in
  the auditor's OWN bucket rings (the Gorilla store's default retention is
  5 minutes — shorter than the slow window, so the store cannot back this
  signal), publishes ``zeebe_audit_burn_rate`` into the store, and lets
  the broker's :class:`~zeebe_tpu_torch.observability.alerts.AlertEvaluator`
  fire page-vs-ticket rules over those series with its normal
  for-duration state machine.

- **resource-trend leak detection** (:class:`TrendDetector`): per-process
  RSS, fd count, thread count, flight-ring occupancy, and tracked
  tenant/table sizes, windowed least-squares slope with confidence gating
  — a genuine leak fires, a noisy flat line does not, and a one-off step
  is NOT a leak (both half-window slopes must agree with the full-window
  trend).

- :class:`ClusterAuditor` — the harness/gateway side: ingests the worker
  status rows the gateway already aggregates, joins replica-CRC
  checkpoints across workers per (partition, window), and checks
  acked-position monotonicity ACROSS pushes (a restarted worker re-serving
  an older position is visible here, not broker-side).

Honest caveats (docs/observability.md): per-broker monitors cannot see
cross-broker invariants (acked-write loss across a leader change is the
offline checker's domain); trend verdicts need at least two half-windows
of samples; the burn-rate windows default to the SRE-workbook 5m/1h but
the quick fleet-day gate shrinks them to fit minutes, not hours.
"""

from __future__ import annotations

import os
import zlib
from collections import deque
from dataclasses import dataclass, field

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

#: registered at import (the control-plane pattern) so the metrics-doc
#: scenario and the sampler see the families before the first verdict
_M_CHECKS = _REG.counter(
    "audit_checks_total",
    "online auditor invariant evaluations, by monitor", ("monitor",))
_M_VIOLATIONS = _REG.counter(
    "audit_violations_total",
    "online auditor invariant violations, by monitor", ("monitor",))
_M_BURN = _REG.gauge(
    "audit_burn_rate",
    "multi-window SLO burn rate (error-budget consumption multiple), by "
    "SLO and window", ("node", "slo", "window"))
_M_LEAK = _REG.gauge(
    "audit_leak_state",
    "resource-trend verdict per tracked resource (0=quiet, 1=warming, "
    "2=leak)", ("node", "resource"))
_M_ALERTS = _REG.gauge(
    "audit_alerts_active",
    "currently-latched online audit alerts on this broker", ("node",))
_M_RING = _REG.gauge(
    "flight_ring_occupancy_ratio",
    "mean fill ratio of the flight-recorder rings (0..1), sampled off the "
    "auditor tick", ("node",))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class AuditorCfg:
    """Knobs for the online auditor. Windows default to the SRE-workbook
    multi-window pair (5m fast / 1h slow); the fleet-day quick gate
    shrinks everything to fit a minutes-long run."""

    enabled: bool = True
    #: burn-rate windows (ms) over the SLO-classified tick stream
    fast_window_ms: int = 300_000
    slow_window_ms: int = 3_600_000
    #: burn-rate thresholds (error-budget consumption multiples): page
    #: fires when BOTH windows exceed page_burn, ticket when both exceed
    #: ticket_burn (Google SRE workbook, multi-window multi-burn-rate)
    page_burn: float = 14.4
    ticket_burn: float = 6.0
    #: the availability SLO the burn rate is measured against (error
    #: budget = 1 - slo_target)
    slo_target: float = 0.999
    #: ack-p99 bound classifying a tick as SLO-bad (ms)
    slo_p99_ms: float = 5_000.0
    #: goodput floor classifying a tick as SLO-bad (acks / admitted)
    goodput_floor: float = 0.7
    #: leak-trend window (ms); verdicts need two half-windows of samples
    leak_window_ms: int = 600_000
    #: minimum samples before a trend verdict (on top of the time span)
    leak_min_samples: int = 20
    #: slope t-statistic above which a trend is significant
    leak_tstat: float = 8.0
    #: minimum relative growth over the window (fraction of the window
    #: mean) — keeps a statistically-clean but microscopic drift quiet
    leak_min_growth: float = 0.05
    #: hold-off before trend observation starts (ms since the first tick):
    #: boot-era allocation (XLA compilation, cache warmup, rings filling)
    #: is a genuine monotone climb that would otherwise read as a leak
    leak_warmup_ms: int = 60_000
    #: QUARANTINED latch bound (ms): longer trips the invariant monitor
    quarantine_max_ms: int = 300_000
    #: replica-CRC checkpoint window (positions per checkpoint)
    crc_window: int = 256
    #: records walked per tick for the CRC monitor (bounds pump cost)
    crc_batch: int = 2_000

    @classmethod
    def from_env(cls) -> "AuditorCfg":
        cfg = cls()
        cfg.enabled = os.environ.get(
            "ZEEBE_AUDIT_ENABLED", "1").lower() not in ("0", "false", "off")
        cfg.fast_window_ms = _env_int("ZEEBE_AUDIT_FASTWINDOWMS",
                                      cfg.fast_window_ms)
        cfg.slow_window_ms = _env_int("ZEEBE_AUDIT_SLOWWINDOWMS",
                                      cfg.slow_window_ms)
        cfg.leak_window_ms = _env_int("ZEEBE_AUDIT_LEAKWINDOWMS",
                                      cfg.leak_window_ms)
        cfg.leak_min_samples = _env_int("ZEEBE_AUDIT_LEAKMINSAMPLES",
                                        cfg.leak_min_samples)
        cfg.leak_min_growth = _env_float("ZEEBE_AUDIT_LEAKMINGROWTH",
                                         cfg.leak_min_growth)
        cfg.leak_warmup_ms = _env_int("ZEEBE_AUDIT_LEAKWARMUPMS",
                                      cfg.leak_warmup_ms)
        cfg.quarantine_max_ms = _env_int("ZEEBE_AUDIT_QUARANTINEMAXMS",
                                         cfg.quarantine_max_ms)
        cfg.slo_p99_ms = _env_float("ZEEBE_AUDIT_SLOP99MS", cfg.slo_p99_ms)
        cfg.slo_target = _env_float("ZEEBE_AUDIT_SLOTARGET", cfg.slo_target)
        cfg.goodput_floor = _env_float("ZEEBE_AUDIT_GOODPUTFLOOR",
                                       cfg.goodput_floor)
        cfg.crc_window = max(
            1, _env_int("ZEEBE_AUDIT_CRCWINDOW", cfg.crc_window))
        return cfg


# -- resource-trend leak detection --------------------------------------------


def least_squares_slope(samples: list[tuple[float, float]]
                        ) -> tuple[float, float]:
    """Ordinary least squares over ``(t_seconds, value)`` points: returns
    ``(slope_per_second, t_statistic)``. The t-stat is slope / stderr —
    the confidence gate that keeps a noisy flat line quiet (its slope is
    small relative to the residual scatter)."""
    n = len(samples)
    if n < 3:
        return 0.0, 0.0
    mean_t = sum(t for t, _ in samples) / n
    mean_v = sum(v for _, v in samples) / n
    sxx = sum((t - mean_t) ** 2 for t, _ in samples)
    if sxx <= 0.0:
        return 0.0, 0.0
    sxy = sum((t - mean_t) * (v - mean_v) for t, v in samples)
    slope = sxy / sxx
    residual = sum((v - mean_v - slope * (t - mean_t)) ** 2
                   for t, v in samples)
    if residual <= 0.0:
        # perfectly linear (a synthetic ramp, or a constant): infinite
        # confidence either way — report a large finite t-stat
        return slope, (1e9 if slope != 0.0 else 0.0)
    stderr = (residual / (n - 2) / sxx) ** 0.5
    return slope, (slope / stderr if stderr > 0 else 0.0)


class TrendDetector:
    """Windowed least-squares leak detector for ONE resource series.

    Feed it ``observe(t_ms, value)`` at any cadence; it keeps a bounded
    deque spanning the window and produces a verdict:

    - ``insufficient`` — fewer than ``min_samples`` points or less than
      two half-windows of time span (the documented caveat);
    - ``quiet`` — no statistically significant positive trend;
    - ``leak`` — the full-window slope is positive, significant
      (t-statistic above ``tstat``), projects at least ``min_growth``
      relative growth over the window, AND both half-windows agree the
      value is still climbing. The half-window agreement is what makes a
      one-off STEP not a leak: after a step, the later half is flat, so
      its slope collapses while the full-window slope stays large.
    """

    def __init__(self, window_ms: int, min_samples: int = 20,
                 tstat: float = 8.0, min_growth: float = 0.05) -> None:
        self.window_ms = int(window_ms)
        self.min_samples = int(min_samples)
        self.tstat = float(tstat)
        self.min_growth = float(min_growth)
        self._samples: deque[tuple[float, float]] = deque()
        self.last = None  # latest verdict dict (surfaces read it)

    def observe(self, t_ms: float, value: float) -> None:
        self._samples.append((float(t_ms), float(value)))
        horizon = t_ms - self.window_ms
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def verdict(self) -> dict:
        pts = [(t / 1000.0, v) for t, v in self._samples]
        out: dict = {"state": "insufficient", "samples": len(pts),
                     "slopePerSec": 0.0, "tstat": 0.0}
        if len(pts) < self.min_samples:
            self.last = out
            return out
        span_s = pts[-1][0] - pts[0][0]
        if span_s * 1000.0 < self.window_ms * 0.5:
            # less than two half-windows of history: no verdict yet
            self.last = out
            return out
        slope, tstat = least_squares_slope(pts)
        mid = pts[0][0] + span_s / 2.0
        first = [p for p in pts if p[0] <= mid]
        second = [p for p in pts if p[0] > mid]
        slope_a, _ = least_squares_slope(first)
        slope_b, _ = least_squares_slope(second)
        mean_v = sum(v for _, v in pts) / len(pts)
        projected = slope * (self.window_ms / 1000.0)
        rel_growth = projected / mean_v if mean_v > 0 else (
            float("inf") if projected > 0 else 0.0)
        significant = (slope > 0.0 and tstat >= self.tstat
                       and rel_growth >= self.min_growth)
        # both halves must still be climbing (each at a meaningful share
        # of the full trend) — a step's later half is flat and vetoes
        halves_agree = (slope_a > 0.25 * slope and slope_b > 0.25 * slope)
        state = "leak" if (significant and halves_agree) else (
            "warming" if significant else "quiet")
        out.update({
            "state": state,
            "slopePerSec": round(slope, 6),
            "tstat": round(min(tstat, 1e9), 2),
            "relGrowthPerWindow": round(min(rel_growth, 1e9), 4),
            "halfSlopes": [round(slope_a, 6), round(slope_b, 6)],
            "spanMs": int(span_s * 1000),
        })
        self.last = out
        return out


# -- multi-window SLO burn-rate tracking --------------------------------------


class BurnRateTracker:
    """Fast/slow-window burn-rate state for ONE SLO.

    Each ``observe(now_ms, good, bad)`` adds a classified observation
    batch; windows are per-second buckets in bounded deques (the 1h slow
    window cannot ride the Gorilla store's 5-minute retention, so the
    tracker owns its history). ``evaluate`` returns the burn-rate pair and
    the page/ticket/ok state: burn rate = (bad fraction over the window) /
    error budget, the SRE-workbook error-budget-consumption multiple; an
    alert state needs BOTH windows above its threshold, which is what
    makes the fast window quick to clear after a transient."""

    def __init__(self, fast_window_ms: int, slow_window_ms: int,
                 slo_target: float = 0.999, page_burn: float = 14.4,
                 ticket_burn: float = 6.0) -> None:
        self.fast_window_ms = int(fast_window_ms)
        self.slow_window_ms = int(slow_window_ms)
        self.budget = max(1.0 - slo_target, 1e-9)
        self.page_burn = page_burn
        self.ticket_burn = ticket_burn
        # (second, good, bad) buckets, oldest first, bounded by slow window
        self._buckets: deque[list] = deque()
        self.state = "ok"

    def observe(self, now_ms: float, good: float, bad: float) -> None:
        sec = int(now_ms // 1000)
        if self._buckets and self._buckets[-1][0] == sec:
            self._buckets[-1][1] += good
            self._buckets[-1][2] += bad
        else:
            self._buckets.append([sec, float(good), float(bad)])
        horizon = sec - self.slow_window_ms // 1000 - 1
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def _rate(self, now_ms: float, window_ms: int) -> float:
        horizon = int(now_ms // 1000) - window_ms // 1000
        good = bad = 0.0
        for sec, g, b in reversed(self._buckets):
            if sec < horizon:
                break
            good += g
            bad += b
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / self.budget

    def evaluate(self, now_ms: float) -> dict:
        fast = self._rate(now_ms, self.fast_window_ms)
        slow = self._rate(now_ms, self.slow_window_ms)
        if fast >= self.page_burn and slow >= self.page_burn:
            self.state = "page"
        elif fast >= self.ticket_burn and slow >= self.ticket_burn:
            self.state = "ticket"
        else:
            self.state = "ok"
        return {"fast": round(fast, 3), "slow": round(slow, 3),
                "state": self.state}


def burn_rate_rules(node_id: str, cfg: AuditorCfg) -> list:
    """The layer onto ``alerts.py``: threshold rules over the
    ``zeebe_audit_burn_rate`` series the auditor publishes into the store,
    with page-vs-ticket severities. The series value is min(fast, slow) —
    a threshold rule over it IS the both-windows-exceed condition — and
    the evaluator's normal for-duration machine debounces it."""
    from zeebe_tpu_torch.observability.alerts import AlertRule

    return [
        AlertRule(
            name="slo_burn_page",
            series="zeebe_audit_burn_rate",
            threshold=cfg.page_burn * 0.999, op=">", for_ms=2_000,
            labels_contains='window="both"', severity="page"),
        AlertRule(
            name="slo_burn_ticket",
            series="zeebe_audit_burn_rate",
            threshold=cfg.ticket_burn * 0.999, op=">", for_ms=5_000,
            labels_contains='window="both"', severity="ticket"),
    ]


# -- the per-broker auditor ---------------------------------------------------


@dataclass
class _PartitionCursor:
    """Per-partition CRC walk state: next position to read, the crc
    accumulated inside the current (aligned) window, and whether the walk
    entered the window at its exact start (only then is the finalized
    checkpoint comparable across replicas)."""

    next_pos: int = 0          # 0 = not aligned yet
    window: int = -1
    crc: int = 0
    aligned: bool = False


class BrokerAuditor:
    """Per-broker online invariant monitors + burn rates + leak trends,
    ticked off the sampler cadence inside ``Broker.pump_control``.

    Violations are latched into a bounded ``alerts`` ring (the ``audit``
    status block ships it), emitted as ``audit_alert`` flight events on
    the node ring, and counted in ``zeebe_audit_violations_total``."""

    MAX_ALERTS = 64
    #: resources whose leak verdict gates the fleet: true process resources
    #: only. Ring occupancy is bounded by construction (it saturates, it
    #: cannot leak) and state/tenant table sizes are workload-proportional;
    #: those trend as ``capacity_trend`` alerts instead.
    GATING_RESOURCES = ("rss_bytes", "fd_count", "thread_count")

    def __init__(self, broker, cfg: AuditorCfg | None = None) -> None:
        self.broker = broker
        self.cfg = cfg or AuditorCfg.from_env()
        self.node_id = broker.cfg.node_id
        # invariant state
        self._last_positions: dict[int, int] = {}
        self._last_processed: dict[int, int] = {}
        self._exporter_cursors: dict[tuple[int, str], int] = {}
        self._exporter_directors: dict[int, object] = {}
        self._crc_cursors: dict[int, _PartitionCursor] = {}
        #: finalized (window, crc) checkpoints per partition, newest last
        self.crc_checkpoints: dict[int, deque] = {}
        self._quarantined_since_ms: float | None = None
        self._quarantine_flagged = False
        # SLO burn tracking (admission ack-p99 + goodput, one tracker)
        self.burn = BurnRateTracker(
            self.cfg.fast_window_ms, self.cfg.slow_window_ms,
            slo_target=self.cfg.slo_target, page_burn=self.cfg.page_burn,
            ticket_burn=self.cfg.ticket_burn)
        self.burn_state: dict = {"fast": 0.0, "slow": 0.0, "state": "ok"}
        # leak trend detectors, one per tracked resource
        self.trends: dict[str, TrendDetector] = {}
        self._leak_flagged: set[str] = set()
        self._first_tick_ms: float | None = None
        self.alerts: deque[dict] = deque(maxlen=self.MAX_ALERTS)
        self.violations_total = 0
        # burn-rate rules ride the broker's normal alert evaluator
        evaluator = getattr(broker, "alerts", None)
        if evaluator is not None:
            evaluator.add_rules(burn_rate_rules(self.node_id, self.cfg))

    # -- violation plumbing ---------------------------------------------------

    def _violation(self, monitor: str, message: str, **detail) -> None:
        self.violations_total += 1
        _M_VIOLATIONS.labels(monitor).inc()
        event = {"atMs": self.broker.clock_millis(), "monitor": monitor,
                 "message": message, **detail}
        self.alerts.append(event)
        flight = getattr(self.broker, "flight_recorder", None)
        if flight is not None:
            flight.record(0, "audit_alert", monitor=monitor,
                          message=message, **detail)
        _M_ALERTS.labels(self.node_id).set(float(len(self.alerts)))

    # -- invariant monitors ---------------------------------------------------

    def _check_position_monotonicity(self) -> None:
        _M_CHECKS.labels("acked_position").inc()
        for pid, partition in list(self.broker.partitions.items()):
            pos = partition.stream.last_position
            prev = self._last_positions.get(pid)
            if prev is not None and pos < prev:
                self._violation(
                    "acked_position",
                    f"partition {pid} log position moved backward "
                    f"{prev} -> {pos}", partition=pid, prev=prev, now=pos)
            self._last_positions[pid] = pos
            processor = partition.processor
            if processor is not None:
                processed = getattr(processor, "last_processed_position", 0)
                prev_p = self._last_processed.get(pid)
                if prev_p is not None and processed < prev_p:
                    self._violation(
                        "acked_position",
                        f"partition {pid} processed position moved backward "
                        f"{prev_p} -> {processed}", partition=pid,
                        prev=prev_p, now=processed)
                self._last_processed[pid] = processed

    def _check_exporter_sequences(self) -> None:
        _M_CHECKS.labels("exporter_sequence").inc()
        for pid, partition in list(self.broker.partitions.items()):
            director = getattr(partition, "exporter_director", None)
            if director is None:
                continue
            # a new director instance (leadership regained) boots fresh
            # containers that report 0 until they restore their persisted
            # cursor — a real regression is within ONE director's life, so
            # the baseline resets with the instance
            if self._exporter_directors.get(pid) is not director:
                self._exporter_directors[pid] = director
                for key in [k for k in self._exporter_cursors
                            if k[0] == pid]:
                    del self._exporter_cursors[key]
            log_end = partition.stream.last_position
            for container in getattr(director, "containers", ()):
                key = (pid, container.exporter_id)
                pos = container.position
                prev = self._exporter_cursors.get(key)
                if prev is not None and pos < prev:
                    self._violation(
                        "exporter_sequence",
                        f"exporter {container.exporter_id} cursor moved "
                        f"backward on partition {pid}: {prev} -> {pos}",
                        partition=pid, exporter=container.exporter_id,
                        prev=prev, now=pos)
                self._exporter_cursors[key] = pos
                if pos > log_end:
                    self._violation(
                        "exporter_sequence",
                        f"exporter {container.exporter_id} acked position "
                        f"{pos} past log end {log_end} on partition {pid}",
                        partition=pid, exporter=container.exporter_id,
                        position=pos, logEnd=log_end)
                if container.last_delivered < pos:
                    self._violation(
                        "exporter_sequence",
                        f"exporter {container.exporter_id} delivery "
                        f"watermark {container.last_delivered} trails its "
                        f"persisted cursor {pos} on partition {pid} (a gap "
                        f"was acked without delivery)",
                        partition=pid, exporter=container.exporter_id)

    def _check_quarantine_latch(self, now_ms: float) -> None:
        _M_CHECKS.labels("quarantine_latch").inc()
        try:
            from zeebe_tpu_torch.engine.device_health import (
                QUARANTINED,
                shared_device_health,
            )
        except Exception:  # noqa: BLE001 — audit must not need the engine
            return
        health = shared_device_health()
        if health.state != QUARANTINED:
            self._quarantined_since_ms = None
            self._quarantine_flagged = False
            return
        if self._quarantined_since_ms is None:
            # latch observed now; the transition record carries the true
            # start when available
            since = now_ms
            for tr in reversed(getattr(health, "transitions", [])):
                if tr.get("to") == QUARANTINED:
                    since = float(tr.get("atMs", now_ms))
                    break
            self._quarantined_since_ms = since
        held = now_ms - self._quarantined_since_ms
        if held > self.cfg.quarantine_max_ms and not self._quarantine_flagged:
            self._quarantine_flagged = True  # once per latch episode
            self._violation(
                "quarantine_latch",
                f"device QUARANTINED for {held / 1000.0:.0f}s, beyond the "
                f"{self.cfg.quarantine_max_ms / 1000.0:.0f}s bound "
                f"(canary loop is not re-proving or condemning the device)",
                heldMs=int(held))

    def _check_replica_crc(self) -> None:
        """Advance the windowed CRC walk over each partition's replicated
        log. The log below the last materialized position is committed by
        construction (the Raft path appends post-commit), so any two
        replicas holding the same aligned window must produce the same
        CRC — disagreement is detected harness-side where the status
        pushes meet (:class:`ClusterAuditor`)."""
        _M_CHECKS.labels("replica_crc").inc()
        window = self.cfg.crc_window
        budget = self.cfg.crc_batch
        for pid, partition in list(self.broker.partitions.items()):
            cursor = self._crc_cursors.get(pid)
            if cursor is None:
                cursor = self._crc_cursors[pid] = _PartitionCursor()
            if cursor.next_pos == 0:
                first = partition.stream.read_at_or_after(1)
                if first is None:
                    continue
                # start at the first window boundary at-or-after the first
                # readable record: a mid-window boot skips the incomplete
                # window instead of shipping an incomparable checkpoint
                start_window = (first.position + window - 1) // window
                if first.position == start_window * window - window + 1:
                    start_window -= 1
                cursor.window = start_window
                cursor.next_pos = start_window * window + 1
                cursor.aligned = True
            end = partition.stream.last_position
            if cursor.next_pos > end:
                continue
            reader = partition.stream.new_reader(cursor.next_pos)
            ring = self.crc_checkpoints.setdefault(pid, deque(maxlen=16))
            for logged in reader:
                if budget <= 0:
                    break
                budget -= 1
                w = (logged.position - 1) // window
                if w != cursor.window:
                    # positions are monotone, so leaving a window means no
                    # more records will ever land in it: finalize (the walk
                    # entered it from its aligned boundary by construction)
                    ring.append((cursor.window, cursor.crc))
                    cursor.window = w
                    cursor.crc = 0
                cursor.crc = zlib.crc32(
                    logged.record.to_bytes(), cursor.crc) & 0xFFFFFFFF
                cursor.next_pos = logged.position + 1

    # -- SLO + leak sampling --------------------------------------------------

    def _observe_slo(self, now_ms: float) -> None:
        """Classify this tick against the SLO from the broker's own
        series: ack-p99 from the admission latency histogram, goodput from
        the admitted-vs-shed counters (both sampled into the store by the
        tick that precedes this call)."""
        store = getattr(self.broker, "timeseries", None)
        if store is None:
            return
        node_label = f'node="{self.node_id}"'
        p99 = [e["value"]
               for e in store.latest("zeebe_admission_ack_latency_ms:p99")
               if node_label in e["labels"]
               and now_ms - e["t"] <= 15_000]
        # counters land in the store as per-second RATES (timeseries.py),
        # so the latest samples already are the goodput numerator/denominator
        admit_rate = sum(
            e["value"] for e in store.latest("zeebe_admission_admitted_total")
            if node_label in e["labels"])
        shed_rate = sum(
            e["value"] for e in store.latest("zeebe_admission_shed_total")
            if node_label in e["labels"])
        bad = 0.0
        good = 1.0
        if p99 and max(p99) > self.cfg.slo_p99_ms:
            bad = 1.0
            good = 0.0
        total = admit_rate + shed_rate
        if total > 0 and (admit_rate / total) < self.cfg.goodput_floor:
            bad = 1.0
            good = 0.0
        self.burn.observe(now_ms, good, bad)
        self.burn_state = self.burn.evaluate(now_ms)
        for window, value in (("fast", self.burn_state["fast"]),
                              ("slow", self.burn_state["slow"]),
                              ("both", min(self.burn_state["fast"],
                                           self.burn_state["slow"]))):
            _M_BURN.labels(self.node_id, "availability", window).set(value)

    _LEAK_STATE_VALUE = {"quiet": 0.0, "insufficient": 0.0, "warming": 1.0,
                         "leak": 2.0}

    def _trend(self, name: str) -> TrendDetector:
        det = self.trends.get(name)
        if det is None:
            det = self.trends[name] = TrendDetector(
                self.cfg.leak_window_ms,
                min_samples=self.cfg.leak_min_samples,
                tstat=self.cfg.leak_tstat,
                min_growth=self.cfg.leak_min_growth)
        return det

    def _sample_resources(self, now_ms: float) -> None:
        from zeebe_tpu_torch.utils.metrics import (
            read_fd_count,
            read_thread_count,
            _read_rss_bytes,
        )

        samples = {
            "rss_bytes": _read_rss_bytes(),
            "fd_count": read_fd_count(),
            "thread_count": read_thread_count(),
        }
        flight = getattr(self.broker, "flight_recorder", None)
        if flight is not None:
            occupancy = flight.occupancy()
            samples["flight_ring"] = occupancy
            _M_RING.labels(self.node_id).set(occupancy)
        # tracked-table growth: tenants the admission plane has seen, and
        # state-table keys per broker (a forgotten cleanup shows up here
        # long before RSS does)
        store = getattr(self.broker, "timeseries", None)
        if store is not None:
            node_label = f'node="{self.node_id}"'
            keys = sum(e["value"] for e in store.latest("zeebe_state_keys")
                       if node_label in e["labels"])
            if keys:
                samples["state_keys"] = keys
            # tracked-tenant table growth: distinct (node, tenant) children
            # of the admission counter — an unbounded tenant table shows up
            # as a climbing child count long before RSS moves
            tenants = len(store.latest("zeebe_admission_admitted_total"))
            if tenants:
                samples["tracked_tenants"] = tenants
        # boot-era hold-off: compilation, cache warmup, and rings filling
        # are genuine monotone climbs; observing them would seed every
        # detector with a false ramp. Gauges above stay live regardless.
        if now_ms - self._first_tick_ms < self.cfg.leak_warmup_ms:
            return
        for name, value in samples.items():
            det = self._trend(name)
            det.observe(now_ms, value)
            verdict = det.verdict()
            _M_LEAK.labels(self.node_id, name).set(
                self._LEAK_STATE_VALUE.get(verdict["state"], 0.0))
            if verdict["state"] == "leak":
                # process resources gate the fleet (monitor resource_leak);
                # workload-proportional series (ring occupancy, state/tenant
                # table sizes) are capacity trends: same detector, same
                # alert plumbing, but they never flip the leak VERDICT —
                # a busy fleet legitimately grows them
                monitor = ("resource_leak" if name in self.GATING_RESOURCES
                           else "capacity_trend")
                if name not in self._leak_flagged:  # once per episode
                    self._leak_flagged.add(name)
                    self._violation(
                        monitor,
                        f"{name} trending up: "
                        f"{verdict['slopePerSec']:+.3f}/s over "
                        f"{verdict['spanMs'] / 1000.0:.0f}s "
                        f"(t={verdict['tstat']})", resource=name, **{
                            k: v for k, v in verdict.items()
                            if k != "state"})
            else:
                self._leak_flagged.discard(name)

    # -- the tick + surfaces --------------------------------------------------

    def tick(self, now_ms: float) -> None:
        if not self.cfg.enabled:
            return
        if self._first_tick_ms is None:
            self._first_tick_ms = now_ms
        self._check_position_monotonicity()
        self._check_exporter_sequences()
        self._check_quarantine_latch(now_ms)
        self._check_replica_crc()
        self._observe_slo(now_ms)
        self._sample_resources(now_ms)

    def leak_verdicts(self) -> dict:
        return {name: det.last for name, det in sorted(self.trends.items())
                if det.last is not None}

    def snapshot(self) -> dict:
        """The ``audit`` block on a broker's /cluster/status row (and
        therefore the worker status push): latched alerts, burn-rate
        state, leak verdicts, and the replica-CRC checkpoints the
        harness-side auditor joins across workers."""
        leaks = self.leak_verdicts()
        return {
            "enabled": self.cfg.enabled,
            "violations": self.violations_total,
            "alerts": list(self.alerts)[-8:],
            "burn": dict(self.burn_state),
            "leaks": {
                name: {"state": v["state"],
                       "slopePerSec": v.get("slopePerSec", 0.0)}
                for name, v in leaks.items()},
            "leakVerdict": ("leak" if any(
                v["state"] == "leak" for name, v in leaks.items()
                if name in self.GATING_RESOURCES) else "clean"),
            "crc": {str(pid): [[w, c] for w, c in ring]
                    for pid, ring in sorted(self.crc_checkpoints.items())
                    if ring},
        }


# -- the harness/gateway-side auditor -----------------------------------------


class ClusterAuditor:
    """Cross-worker auditing over the worker status pushes the gateway
    already aggregates: replica-CRC spot agreement per (partition,
    window), acked-position monotonicity ACROSS pushes (per worker life),
    and a merged view of every worker's audit block.

    Fed by the fleet-day harness (``runtime._worker_status``) or any
    caller holding /cluster/status rows; pure and clock-free, so tests
    drive it with synthetic rows."""

    def __init__(self) -> None:
        #: (partition, window) -> {crc -> set(worker)}
        self._crc_seen: dict[tuple[int, int], dict[int, set]] = {}
        #: (worker, pid, partition) -> last pushed log position
        self._push_positions: dict[tuple, int] = {}
        self.violations: list[dict] = []
        self._flagged: set = set()
        self.worker_audits: dict[str, dict] = {}
        self.rows_ingested = 0

    def ingest(self, rows: dict) -> list[dict]:
        """Consume ``{worker_id: status_row}``; returns NEW violations."""
        fresh: list[dict] = []
        for worker, row in sorted(rows.items()):
            if not isinstance(row, dict):
                continue
            self.rows_ingested += 1
            audit = row.get("audit")
            if isinstance(audit, dict):
                self.worker_audits[worker] = audit
                for pid_s, checkpoints in audit.get("crc", {}).items():
                    pid = int(pid_s)
                    for window, crc in checkpoints:
                        key = (pid, int(window))
                        seen = self._crc_seen.setdefault(key, {})
                        seen.setdefault(int(crc), set()).add(worker)
                        if len(seen) > 1 and key not in self._flagged:
                            self._flagged.add(key)
                            fresh.append({
                                "monitor": "replica_crc",
                                "message": (
                                    f"replica CRC disagreement on partition "
                                    f"{pid} window {window}: " + ", ".join(
                                        f"{sorted(ws)}={c:#010x}"
                                        for c, ws in sorted(seen.items()))),
                                "partition": pid, "window": int(window)})
            worker_pid = row.get("workerPid", 0)
            for pid_s, pinfo in row.get("partitions", {}).items():
                pos = pinfo.get("lastPosition")
                if pos is None:
                    continue
                key = (worker, worker_pid, int(pid_s))
                prev = self._push_positions.get(key)
                if prev is not None and pos < prev:
                    flag = ("push_monotonicity", key, prev)
                    if flag not in self._flagged:
                        self._flagged.add(flag)
                        fresh.append({
                            "monitor": "acked_position",
                            "message": (
                                f"{worker} (pid {worker_pid}) pushed "
                                f"partition {pid_s} position {pos} after "
                                f"{prev}"),
                            "worker": worker, "partition": int(pid_s),
                            "prev": prev, "now": pos})
                self._push_positions[key] = pos
        self.violations.extend(fresh)
        return fresh

    def flagged_monitors(self) -> set:
        """Monitor classes with at least one online flag, merged across
        this auditor and every worker's own audit block — the recall
        cross-check joins the offline checker's findings against this."""
        out = {v["monitor"] for v in self.violations}
        for audit in self.worker_audits.values():
            for alert in audit.get("alerts", []):
                out.add(alert.get("monitor", ""))
            if audit.get("leakVerdict") == "leak":
                out.add("resource_leak")
        return out - {""}

    def snapshot(self) -> dict:
        return {
            "rowsIngested": self.rows_ingested,
            "violations": list(self.violations),
            "crcWindowsCompared": sum(
                1 for seen in self._crc_seen.values()
                if sum(len(ws) for ws in seen.values()) > 1),
            "workers": {w: {"burn": a.get("burn", {}),
                            "leakVerdict": a.get("leakVerdict", "unknown"),
                            "violations": a.get("violations", 0)}
                        for w, a in sorted(self.worker_audits.items())},
        }
