"""ControlPlane: the per-broker (and per-worker) closed control loop.

Ticks off the broker's control pump — after the metrics sampler, so every
tick sees at-most-one-tick-old distilled telemetry — and drives the knob
surface through the typed :class:`Actuator` framework. Disabled
(``ZEEBE_CONTROL_ENABLED=0``) the plane is simply not constructed:
``broker.control is None`` is the whole disabled hot path, exactly the
metrics/profiling planes' cost contract.

The plane also *aggregates* the runtime's pre-existing one-off feedback
loops (the adaptive snapshot scheduler, the admission shed
ladder) as read-only ``loops`` entries in its snapshot: their decisions
already land in the shared ``control_adjust`` vocabulary
(zeebe_tpu/control/audit.py), so ``/control``, ``/cluster/status`` and
``cli top``'s CONTROL section show every closed loop in one place.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from zeebe_tpu_torch.control.actuators import Actuator
from zeebe_tpu_torch.control.controllers import (
    CoalescingController,
    Controller,
    JournalFlushController,
    RoutingController,
    SignalReader,
    TieringController,
)

#: hard bounds + pacing per shipped knob (docs/control.md documents them).
#: The coalescing cap covers the window that gathers TARGET_BATCH commands
#: at the LOW_RATE floor — the window a burst actually wants shrinks as
#: the rate grows (target/rate), so the cap binds at moderate rates only.
COALESCE_WINDOW_MAX_MS = 25.0
COALESCE_WINDOW_STEP_MS = 5.0
#: the flush-delay cap is deliberately tighter than the coalescing cap:
#: every deferred fsync delays a COMMIT (acks wait for it), so past a few
#: milliseconds the latency cost outruns the amortization gain
FLUSH_DELAY_MAX_MS = 8.0
FLUSH_DELAY_STEP_MS = 2.0
PARK_AFTER_MIN_MS = 1_000.0
PARK_AFTER_MAX_MS = 600_000.0
PARK_AFTER_STEP_MS = 5_000.0
SPILL_BATCH_MIN = 32.0
SPILL_BATCH_MAX = 2_048.0
SPILL_BATCH_STEP = 128.0
ROUTE_THRESHOLD_MAX_MS = 250.0
ROUTE_THRESHOLD_STEP_MS = 25.0


@dataclasses.dataclass
class ControlCfg:
    """``ZEEBE_CONTROL_*`` knobs."""

    enabled: bool = True
    #: controller tick cadence (decisions are paced — one bounded actuator
    #: step per tick per controller)
    interval_ms: int = 500
    #: the journal-flush controller's ack-latency SLO (ms)
    ack_p99_target_ms: float = 250.0
    #: the tiering controller's RSS set point (bytes); 0 derives 80% of
    #: the rss_watermark alert's bound (ZEEBE_ALERT_RSSWATERMARKBYTES)
    rss_target_bytes: int = 0
    #: a distilled sample older than this is stale → fallback-to-static
    signal_max_age_ms: int = 15_000

    @classmethod
    def from_env(cls, env: dict | None = None) -> "ControlCfg":
        env = os.environ if env is None else env

        def _f(name: str, default: float) -> float:
            try:
                return float(env.get(name, ""))
            except ValueError:
                return default

        cfg = cls()
        cfg.enabled = env.get("ZEEBE_CONTROL_ENABLED", "true").lower() in (
            "1", "true", "yes")
        cfg.interval_ms = int(_f("ZEEBE_CONTROL_INTERVALMS", 500))
        cfg.ack_p99_target_ms = _f("ZEEBE_CONTROL_ACKP99TARGETMS", 250.0)
        cfg.rss_target_bytes = int(_f("ZEEBE_CONTROL_RSSTARGETBYTES", 0))
        if cfg.rss_target_bytes <= 0:
            cfg.rss_target_bytes = int(
                0.8 * _f("ZEEBE_ALERT_RSSWATERMARKBYTES", float(4 << 30)))
        return cfg


class ControlPlane:
    """Controllers + actuators over one broker's runtime objects."""

    def __init__(self, broker, cfg: ControlCfg | None = None) -> None:
        self.broker = broker
        self.cfg = cfg or ControlCfg.from_env()
        self.flight = getattr(broker, "flight_recorder", None)
        self.clock_millis = broker.clock_millis
        self.reader = SignalReader(broker.timeseries, broker.clock_millis,
                                   max_age_ms=self.cfg.signal_max_age_ms)
        self.controllers: list[Controller] = []
        self._last_tick_ms = 0
        self.ticks = 0
        #: read-only aggregated loops: name -> snapshot fn (the snapshot
        #: scheduler and admission ladder register here so every closed
        #: loop renders in one CONTROL view)
        self._loops: dict[str, Callable[[], dict]] = {}
        self._build_default_controllers()
        self._loops["snapshot-scheduler"] = self._snapshot_scheduler_loop
        if self.flight is not None:
            self.flight.add_context_provider(
                lambda: {"control": self.snapshot()})

    # -- wiring ----------------------------------------------------------------

    def _build_default_controllers(self) -> None:
        broker = self.broker
        cfg = self.cfg

        # journal-flush: ONE broker-wide knob written through to every
        # local partition's raft node (sync() re-propagates onto
        # partitions created after the last adjustment)
        static_delay_ms = float(
            getattr(broker.cfg, "log_flush_delay_ms", 0) or 0)
        self._flush_delay_ms = static_delay_ms

        def read_flush() -> float:
            return self._flush_delay_ms

        def write_flush(value: float) -> None:
            self._flush_delay_ms = value
            for partition in list(broker.partitions.values()):
                partition.raft.flush_interval_s = value / 1000.0

        self.add_controller(JournalFlushController(
            [Actuator(JournalFlushController.name,
                      JournalFlushController.KNOB,
                      read_flush, write_flush,
                      min_value=0.0, max_value=FLUSH_DELAY_MAX_MS,
                      max_step=FLUSH_DELAY_STEP_MS,
                      static=min(static_delay_ms, FLUSH_DELAY_MAX_MS),
                      hold_band=0.5)],
            ack_p99_target_ms=cfg.ack_p99_target_ms))

        # state-tiering: the broker's shared TieringCfg (one instance for
        # every partition's manager) — only when tiering is on at all
        tiering_cfg = broker._tiering_cfg()
        if tiering_cfg is not None:
            def write_park(value: float, c=tiering_cfg) -> None:
                c.park_after_ms = int(value)

            def write_spill(value: float, c=tiering_cfg) -> None:
                c.spill_batch = int(value)

            self.add_controller(TieringController(
                [Actuator(TieringController.name,
                          TieringController.KNOB_PARK,
                          lambda: float(tiering_cfg.park_after_ms),
                          write_park,
                          min_value=PARK_AFTER_MIN_MS,
                          max_value=PARK_AFTER_MAX_MS,
                          max_step=PARK_AFTER_STEP_MS,
                          static=float(min(max(tiering_cfg.park_after_ms,
                                               PARK_AFTER_MIN_MS),
                                           PARK_AFTER_MAX_MS)),
                          hold_band=100.0, integer=True),
                 Actuator(TieringController.name,
                          TieringController.KNOB_SPILL,
                          lambda: float(tiering_cfg.spill_batch),
                          write_spill,
                          min_value=SPILL_BATCH_MIN,
                          max_value=SPILL_BATCH_MAX,
                          max_step=SPILL_BATCH_STEP,
                          static=float(min(max(tiering_cfg.spill_batch,
                                               SPILL_BATCH_MIN),
                                           SPILL_BATCH_MAX)),
                          hold_band=16.0, integer=True)],
                rss_target_bytes=cfg.rss_target_bytes))

        # kernel-routing: the process-shared backend router's threshold
        from zeebe_tpu_torch.utils.device_link import shared_router

        router = shared_router()

        def write_route_threshold(value: float, r=router) -> None:
            r.route_threshold_s = value / 1000.0

        self.add_controller(RoutingController(
            [Actuator(RoutingController.name, RoutingController.KNOB,
                      lambda: router.route_threshold_s * 1000.0,
                      write_route_threshold,
                      min_value=0.0, max_value=ROUTE_THRESHOLD_MAX_MS,
                      max_step=ROUTE_THRESHOLD_STEP_MS, static=0.0,
                      hold_band=1.0)]))

    def add_controller(self, controller: Controller) -> None:
        self.controllers.append(controller)

    def add_coalescing_controller(self, read: Callable[[], float],
                                  write: Callable[[float], None],
                                  static_ms: float) -> None:
        """Wire the ingress batch-coalescing loop (the multiproc worker
        calls this with its own window attribute — the knob lives at the
        ingress seam, which the bare broker does not have)."""
        self.add_controller(CoalescingController(
            [Actuator(CoalescingController.name, CoalescingController.KNOB,
                      read, write,
                      min_value=0.0, max_value=COALESCE_WINDOW_MAX_MS,
                      max_step=COALESCE_WINDOW_STEP_MS,
                      static=min(static_ms, COALESCE_WINDOW_MAX_MS),
                      hold_band=2.0)]))

    def register_loop(self, name: str,
                      snapshot_fn: Callable[[], dict]) -> None:
        """Aggregate a pre-existing feedback loop (admission shed ladder)
        into the CONTROL view — read-only; the loop keeps its own
        decision engine and records through the audit vocabulary."""
        self._loops[name] = snapshot_fn

    def _snapshot_scheduler_loop(self) -> dict:
        partitions = {
            str(pid): {"adaptiveTriggers": p.adaptive_snapshot_count,
                       "replayDebtRecords": max(
                           p.stream.last_position
                           - max(p._last_snapshot_processed, 0), 0)}
            for pid, p in sorted(self.broker.partitions.items())
        }
        return {
            "knob": "snapshot.cadence",
            "description": "snapshots early when projected replay debt "
                           "threatens recovery_budget_ms",
            "partitions": partitions,
            "adjustments": sum(v["adaptiveTriggers"]
                               for v in partitions.values()),
        }

    # -- the tick --------------------------------------------------------------

    def maybe_tick(self, now_ms: int | None = None) -> bool:
        now = self.clock_millis() if now_ms is None else now_ms
        if now - self._last_tick_ms < self.cfg.interval_ms:
            return False
        self.tick(now)
        return True

    def tick(self, now_ms: int | None = None) -> int:
        """One control round: per controller, read fresh signals and step
        every actuator one bounded move (or fall back toward static on a
        stale sensor). Returns the number of knob changes this round."""
        now = self.clock_millis() if now_ms is None else now_ms
        self._last_tick_ms = now
        self.ticks += 1
        changed = 0
        for controller in self.controllers:
            try:
                signals = controller.read_signals(self.reader)
            except Exception:  # noqa: BLE001 — a torn store read must not
                signals = None  # kill the pump; treat as a stale sensor
            if signals is None:
                for actuator in controller.actuators:
                    before = actuator.read()
                    if actuator.fall_back(controller.name, flight=self.flight,
                                          now_ms=now) != before:
                        changed += 1
                continue
            current = {a.knob: a.read() for a in controller.actuators}
            desired = controller.decide(signals, current)
            for actuator in controller.actuators:
                target, reason = desired[actuator.knob]
                if actuator.apply(target, reason, signals,
                                  flight=self.flight,
                                  now_ms=now) != current[actuator.knob]:
                    changed += 1
                else:
                    actuator.sync()  # propagate onto late-created targets
        if changed and self.flight is not None:
            # throttled (one per reason class per 5s): the audit trail is
            # the events; the dump is the reviewable artifact CI uploads
            self.flight.dump("control")
        return changed

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        loops = {}
        for name, fn in sorted(self._loops.items()):
            try:
                loops[name] = fn()
            except Exception:  # noqa: BLE001 — a torn loop snapshot must
                loops[name] = {"error": "unavailable"}  # not break /control
        return {
            "enabled": True,
            "intervalMs": self.cfg.interval_ms,
            "ticks": self.ticks,
            "ackP99TargetMs": self.cfg.ack_p99_target_ms,
            "rssTargetBytes": self.cfg.rss_target_bytes,
            "controllers": {
                c.name: {"actuators": [a.snapshot() for a in c.actuators]}
                for c in self.controllers
            },
            "loops": loops,
        }


def maybe_build_plane(broker, env: dict | None = None) -> ControlPlane | None:
    """The broker's construction seam: None when the plane is disabled or
    the observability plane (its sensor) is off — one ``is None`` check is
    the entire disabled cost."""
    cfg = ControlCfg.from_env(env)
    if not cfg.enabled or getattr(broker, "timeseries", None) is None:
        return None
    return ControlPlane(broker, cfg)
