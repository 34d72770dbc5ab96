"""The controller catalog: conservative feedback over windowed telemetry.

Each controller is a pure decision function (`decide`) over distilled
signals read from the Gorilla time-series store — never the raw
registry, never partition state — plus the declarative wiring of which
:class:`~zeebe_tpu_torch.control.actuators.Actuator` it drives. Pure decisions
keep the unit tests deterministic (synthetic series in, knob trajectory
out) and keep every runtime side effect inside the actuator's bounded,
audited ``apply``.

Shipped loops:

- **ingress-coalescing** — the worker's ingress batch-coalescing window
  follows the observed append arrival rate: at low rates the window is 0
  (no added latency); at high rates a few milliseconds of coalescing turn
  N per-command raft appends (each an fsync + a replication round) into
  one batched append.
- **journal-flush** — the raft group-commit pacing
  (``RaftNode.flush_interval_s``) follows observed fsync latency/rate vs
  the ack-p99 target: when fsync utilization threatens the SLO the
  barrier widens (more appends per fsync, acks still strictly after the
  covering fsync); when the disk is idle it narrows back to per-append.
- **state-tiering** — ``park_after_ms``/``spill_batch`` follow the RSS
  watermark and the cold-fault rate: memory pressure parks sooner and
  spills harder; fault thrash with comfortable memory backs off.
- **kernel-routing** — the host-vs-device routing threshold
  (``BackendRouter.route_threshold_s``) follows the XLA compile
  telemetry from the compile seam: a recompile storm biases groups
  onto the host backend until the program set settles.

Signal staleness: a controller whose signals cannot be read fresh
returns None from ``read_signals`` — the plane then walks every actuator
back toward its static configured value (one bounded step per tick), so
a dead sensor degrades to the hand-tuned deployment.
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.control.actuators import Actuator

#: a retained sample older than this is not a live signal
DEFAULT_SIGNAL_MAX_AGE_MS = 15_000


class SignalReader:
    """Distilled-series access for controllers: freshness-guarded reads
    over the broker's :class:`TimeSeriesStore` (None = no live sample)."""

    def __init__(self, store, clock_millis: Callable[[], int],
                 max_age_ms: int = DEFAULT_SIGNAL_MAX_AGE_MS) -> None:
        self.store = store
        self.clock_millis = clock_millis
        self.max_age_ms = max_age_ms

    def _fresh(self, name: str, labels_contains: str) -> list[float]:
        now = self.clock_millis()
        return [entry["value"] for entry in self.store.latest(name)
                if entry["name"] == name
                and labels_contains in entry["labels"]
                and now - entry["t"] <= self.max_age_ms]

    def latest_sum(self, name: str,
                   labels_contains: str = "") -> float | None:
        values = self._fresh(name, labels_contains)
        return sum(values) if values else None

    def latest_max(self, name: str,
                   labels_contains: str = "") -> float | None:
        values = self._fresh(name, labels_contains)
        return max(values) if values else None


class Controller:
    """One feedback loop: named, with its actuators and its pure
    ``decide``. The plane owns the tick cadence and the apply/fallback
    mechanics."""

    name = ""

    def __init__(self, actuators: list[Actuator]) -> None:
        self.actuators = list(actuators)

    def read_signals(self, reader: SignalReader) -> dict | None:
        """Fresh signal values, or None (stale/absent → fallback)."""
        raise NotImplementedError

    def decide(self, signals: dict,
               current: dict[str, float]) -> dict[str, tuple[float, str]]:
        """{knob: (desired value, reason)} — pure, unit-testable."""
        raise NotImplementedError


class CoalescingController(Controller):
    """Ingress batch-coalescing window ← observed append arrival rate."""

    name = "ingress-coalescing"

    #: below this arrival rate the window stays 0 — coalescing only ever
    #: pays when several commands arrive inside a few milliseconds
    LOW_RATE_PER_S = 60.0
    #: aim for roughly this many commands per coalesced batch: the desired
    #: window is target/rate, so it SHRINKS as the rate grows (a hotter
    #: ingress gathers its batch sooner) and the actuator's max bound
    #: binds only in the just-above-the-floor regime
    TARGET_BATCH = 2.0

    KNOB = "ingress.coalesceWindowMs"

    def read_signals(self, reader: SignalReader) -> dict | None:
        # COMMAND arrivals, not record throughput: the admission
        # controller's admitted counter is the ingress-rate ground truth
        # (log-appender counts follow-up records too — 3-5x the command
        # rate — which would shrink the window far below its optimum).
        # Fallback for admission-disabled deployments: the appended-record
        # rate, the over-counting documented in docs/control.md.
        rate = reader.latest_sum("zeebe_admission_admitted_total")
        if rate is None:
            rate = reader.latest_sum(
                "zeebe_log_appender_record_appended_total")
            if rate is None:
                return None
        return {"appendPerSec": round(rate, 1)}

    def decide(self, signals, current):
        rate = signals["appendPerSec"]
        if rate <= self.LOW_RATE_PER_S:
            return {self.KNOB: (
                0.0, f"arrival rate {rate}/s under the coalescing floor "
                     f"({self.LOW_RATE_PER_S:.0f}/s)")}
        window_ms = 1000.0 * self.TARGET_BATCH / rate
        return {self.KNOB: (
            window_ms,
            f"arrival rate {rate}/s: ~{self.TARGET_BATCH:.0f} commands per "
            f"{window_ms:.1f}ms window")}


class JournalFlushController(Controller):
    """Raft group-commit pacing ← fsync latency/rate vs the ack-p99 SLO."""

    name = "journal-flush"

    #: fsync duty cycle (flushes/s x seconds/flush) above which the
    #: barrier widens — the disk, not the engine, is pacing acks
    UTIL_HIGH = 0.35
    #: duty cycle below which the barrier narrows back toward per-append
    UTIL_LOW = 0.05
    #: flush pressure that corroborates an ack-SLO breach
    UTIL_BREACH = 0.10

    KNOB = "raft.flushDelayMs"

    def __init__(self, actuators, ack_p99_target_ms: float = 250.0) -> None:
        super().__init__(actuators)
        self.ack_p99_target_ms = ack_p99_target_ms

    def read_signals(self, reader: SignalReader) -> dict | None:
        flush_rate = reader.latest_sum("zeebe_flush_duration_seconds")
        if flush_rate is None:
            return None
        p50_s = reader.latest_max("zeebe_flush_duration_seconds:p50") or 0.0
        signals = {"flushPerSec": round(flush_rate, 1),
                   "flushP50Ms": round(p50_s * 1000.0, 3),
                   "flushUtilization": round(flush_rate * p50_s, 3)}
        ack_p99 = reader.latest_max("zeebe_admission_ack_latency_ms:p99")
        if ack_p99 is not None:
            signals["ackP99Ms"] = round(ack_p99, 1)
        return signals

    def decide(self, signals, current):
        knob = self.KNOB
        util = signals["flushUtilization"]
        ack_p99 = signals.get("ackP99Ms")
        target = self.ack_p99_target_ms
        if util > self.UTIL_HIGH or (
                ack_p99 is not None and ack_p99 > target
                and util > self.UTIL_BREACH):
            return {knob: (
                float("inf"),  # the actuator clamps to its max bound
                f"fsync utilization {util:.2f} "
                + (f"with ack p99 {ack_p99}ms over the {target:.0f}ms target"
                   if ack_p99 is not None and ack_p99 > target
                   else f"over the {self.UTIL_HIGH:.2f} watermark")
                + ": widening the group-commit barrier")}
        if util < self.UTIL_LOW and (ack_p99 is None
                                     or ack_p99 < 0.5 * target):
            return {knob: (
                0.0, f"fsync utilization {util:.2f} idle and ack p99 clear: "
                     f"narrowing toward per-append flush")}
        return {knob: (current[knob],
                       f"holding: utilization {util:.2f} inside the band")}


class TieringController(Controller):
    """Tiering park horizon / spill batch ← RSS watermark + fault rate."""

    name = "state-tiering"

    #: back off (park later) only when memory is comfortably under target
    RSS_CLEAR_FRACTION = 0.7
    #: cold faults/s that count as thrash when memory is comfortable
    FAULT_HIGH_PER_S = 25.0

    KNOB_PARK = "tiering.parkAfterMs"
    KNOB_SPILL = "tiering.spillBatch"

    def __init__(self, actuators, rss_target_bytes: float) -> None:
        super().__init__(actuators)
        self.rss_target_bytes = float(rss_target_bytes)

    def read_signals(self, reader: SignalReader) -> dict | None:
        rss = reader.latest_max("process_resident_memory_bytes")
        if rss is None:
            return None
        faults = reader.latest_sum("zeebe_state_fault_in_total") or 0.0
        return {"rssBytes": rss, "faultPerSec": round(faults, 1),
                "rssTargetBytes": self.rss_target_bytes}

    def decide(self, signals, current):
        rss = signals["rssBytes"]
        faults = signals["faultPerSec"]
        target = self.rss_target_bytes
        mib = rss / (1 << 20)
        if rss > target:
            reason = (f"RSS {mib:.0f}MiB over the "
                      f"{target / (1 << 20):.0f}MiB target: park sooner, "
                      f"spill harder")
            return {self.KNOB_PARK: (0.0, reason),
                    self.KNOB_SPILL: (float("inf"), reason)}
        if rss < self.RSS_CLEAR_FRACTION * target \
                and faults > self.FAULT_HIGH_PER_S:
            reason = (f"cold-fault thrash ({faults}/s) with RSS "
                      f"{mib:.0f}MiB comfortable: park later")
            return {self.KNOB_PARK: (float("inf"), reason),
                    self.KNOB_SPILL: (current[self.KNOB_SPILL], reason)}
        if rss < self.RSS_CLEAR_FRACTION * target:
            reason = (f"RSS {mib:.0f}MiB comfortable: drifting back to the "
                      f"configured posture")
            return {self.KNOB_PARK: (float("nan"), reason),  # nan = static
                    self.KNOB_SPILL: (float("nan"), reason)}
        reason = f"holding: RSS {mib:.0f}MiB inside the band"
        return {self.KNOB_PARK: (current[self.KNOB_PARK], reason),
                self.KNOB_SPILL: (current[self.KNOB_SPILL], reason)}


class RoutingController(Controller):
    """Host-vs-device routing threshold ← XLA compile telemetry + the
    device health ladder: a SUSPECT/QUARANTINED device biases
    kernel groups host-ward through the same actuator a recompile storm
    uses — recent device faults and compile churn are the same posture
    (don't trust the accelerator with latency-critical groups right now)."""

    name = "kernel-routing"

    #: sustained cold-compile rate that reads as a recompile storm — the
    #: same posture as the xla_recompile_storm default alert (>= 3/min)
    STORM_MISS_PER_S = 0.05

    KNOB = "router.routeThresholdMs"

    def read_signals(self, reader: SignalReader) -> dict | None:
        miss_rate = reader.latest_sum("zeebe_xla_compiles_total",
                                      labels_contains='cache="miss"')
        device_state = reader.latest_max("zeebe_device_health_state")
        if miss_rate is None and not device_state:
            # no compile telemetry and a HEALTHY (or absent) ladder: the
            # health gauge is registered at import and always fresh, so it
            # must not masquerade as a live compile signal — report stale
            # and let the actuator walk back to the configured static
            # threshold instead of actuating on a fabricated 0.0 miss rate
            return None
        signals = {"compileMissPerSec": round(miss_rate or 0.0, 3)}
        if device_state is not None:
            signals["deviceHealthState"] = device_state
        p99 = reader.latest_max("zeebe_xla_compile_seconds:p99")
        if p99 is not None:
            signals["compileP99Ms"] = round(p99 * 1000.0, 1)
        return signals

    def decide(self, signals, current):
        miss = signals["compileMissPerSec"]
        device_state = signals.get("deviceHealthState", 0.0)
        if device_state and device_state >= 1.0:
            label = "QUARANTINED" if device_state >= 2.0 else "SUSPECT"
            return {self.KNOB: (
                float("inf"),
                f"device health {label}: biasing kernel groups onto the "
                f"host backend until the ladder clears")}
        if miss > self.STORM_MISS_PER_S:
            return {self.KNOB: (
                float("inf"),
                f"recompile storm ({miss}/s cold compiles): biasing kernel "
                f"groups onto the host backend")}
        return {self.KNOB: (
            0.0, f"compile churn {miss}/s settled: unbiased routing")}
