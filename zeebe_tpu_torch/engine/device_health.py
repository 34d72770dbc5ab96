"""Per-broker device health ladder: HEALTHY → SUSPECT → QUARANTINED →
(canary) → HEALTHY.

"Gray Failure" (Huang et al., HotOS'17) argues the dangerous accelerator
failure mode is *degraded-not-dead*: a device that still answers most
dispatches but wedges, errors, or silently corrupts some of them. The
kernel backend's containment (host re-execution of a failed group) and
detection (sampled shadow verification) layers report every observed
device fault here, and this ladder turns the fault stream into an audited
routing posture:

- **HEALTHY** — full kernel dispatch; shadow verification at the
  configured sample rate.
- **SUSPECT** — latched by the first fault (a dispatch exception, a
  watchdog-expired stall, or a shadow mismatch). Shadow sampling is
  boosted (``suspect_shadow_boost``), the kernel-routing controller reads
  the ``zeebe_device_health_state`` gauge and biases groups host-ward
  through its existing ``route_threshold_s`` actuator, and a quiet window
  (``suspect_clear_ms`` without a fault) steps back down to HEALTHY.
  ``quarantine_faults`` faults inside ``fault_window_ms`` escalate.
- **QUARANTINED** — no ordinary group rides the device: the backend
  host-routes every group (typed ``device-quarantined`` accounting).
  Every ``canary_interval_ms`` ONE canary group is dispatched under
  FORCED shadow verification — a known-answer probe whose answer is the
  host oracle's own result, so a wrong canary can never commit wrong
  bytes. ``canary_successes`` consecutive verified canaries re-prove the
  device and return to HEALTHY; any canary fault or mismatch resets the
  streak.

Every transition is a ``control_adjust``-style audited event
(controller ``device-health``, knob ``device.healthState``) plus a typed
``device_health`` flight event, a ``zeebe_device_*`` metric move, and —
under the device-chaos harness — a line in a JSONL evidence file the
offline gate joins against the injected-fault ledger.

Scope caveats (also in docs/device-faults.md): the ladder is per-BROKER
(one state for every partition in the process, matching the shared
router), per-process not per-chip, and it watches the *direct* dispatch
path — mesh dispatch has its own killable probe.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

logger = logging.getLogger("zeebe_tpu_torch.device_health")

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
QUARANTINED = "QUARANTINED"

_STATE_VALUE = {HEALTHY: 0, SUSPECT: 1, QUARANTINED: 2}

# registered at import so the metrics-doc scenario and the sampler see the
# families before the first fault (the control-plane pattern)
_M_STATE = _REG.gauge(
    "device_health_state",
    "device health ladder state of this broker's kernel dispatch path "
    "(0=HEALTHY, 1=SUSPECT, 2=QUARANTINED)", ())
_M_FAULTS = _REG.counter(
    "device_faults_total",
    "device faults observed at the kernel dispatch seam, by kind "
    "(dispatch-error, wedge, shadow-mismatch, canary classes)", ("kind",))
_M_TRANSITIONS = _REG.counter(
    "device_health_transitions_total",
    "device health ladder transitions, by target state", ("to",))
_M_CANARY = _REG.counter(
    "device_canary_total",
    "quarantine canary dispatches, by outcome (verified / failed)",
    ("outcome",))
_M_SHADOW_CHECKS = _REG.counter(
    "device_shadow_checks_total",
    "kernel groups re-executed on the host oracle and compared "
    "byte-for-byte before commit", ())
_M_SHADOW_MISMATCH = _REG.counter(
    "device_shadow_mismatches_total",
    "shadow verifications whose device result diverged from the host "
    "oracle — the result was quarantined (host result committed)", ())
_M_HOST_REROUTES = _REG.counter(
    "device_host_reroutes_total",
    "pump passes whose group was host-routed because the device is "
    "QUARANTINED", ())

_M_STATE.set(0.0)


@dataclass
class DeviceDefenseCfg:
    """The device-defense knob surface, bound from ``ZEEBE_BROKER_DEVICE_*``
    (read once per process at ladder construction — the knobs shape a
    process-wide posture, not per-partition behavior)."""

    #: watchdog deadline per device dispatch/fetch; 0 disables. Only armed
    #: on real accelerators (pipelined chunks) or under the chaos plane —
    #: the plain host XLA path pays nothing.
    dispatch_timeout_ms: int = 45_000
    #: fraction of kernel groups shadow-verified on the host oracle
    shadow_sample_rate: float = 0.02
    #: shadow-rate multiplier while SUSPECT
    suspect_shadow_boost: float = 8.0
    #: faults inside fault_window_ms that escalate SUSPECT → QUARANTINED
    quarantine_faults: int = 3
    fault_window_ms: int = 60_000
    #: fault-free window that clears SUSPECT back to HEALTHY
    suspect_clear_ms: int = 30_000
    #: cadence of canary dispatches while QUARANTINED
    canary_interval_ms: int = 5_000
    #: consecutive verified canaries that re-prove the device
    canary_successes: int = 2
    #: deterministic shadow-sampling stream seed
    shadow_seed: int = 0


def defense_cfg_from_env(env=None) -> DeviceDefenseCfg:
    env = os.environ if env is None else env
    cfg = DeviceDefenseCfg()

    def _get(var, convert, current):
        raw = env.get(var)
        if not raw:
            return current
        try:
            return convert(raw)
        except ValueError:
            logger.error("ignoring malformed %s=%r", var, raw)
            return current

    cfg.dispatch_timeout_ms = _get(
        "ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS", int, cfg.dispatch_timeout_ms)
    cfg.shadow_sample_rate = _get(
        "ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE", float, cfg.shadow_sample_rate)
    cfg.suspect_shadow_boost = _get(
        "ZEEBE_BROKER_DEVICE_SUSPECTSHADOWBOOST", float,
        cfg.suspect_shadow_boost)
    cfg.quarantine_faults = _get(
        "ZEEBE_BROKER_DEVICE_QUARANTINEFAULTS", int, cfg.quarantine_faults)
    cfg.fault_window_ms = _get(
        "ZEEBE_BROKER_DEVICE_FAULTWINDOWMS", int, cfg.fault_window_ms)
    cfg.suspect_clear_ms = _get(
        "ZEEBE_BROKER_DEVICE_SUSPECTCLEARMS", int, cfg.suspect_clear_ms)
    cfg.canary_interval_ms = _get(
        "ZEEBE_BROKER_DEVICE_CANARYINTERVALMS", int, cfg.canary_interval_ms)
    cfg.canary_successes = _get(
        "ZEEBE_BROKER_DEVICE_CANARYSUCCESSES", int, cfg.canary_successes)
    cfg.shadow_seed = _get(
        "ZEEBE_BROKER_DEVICE_SHADOWSEED", int, cfg.shadow_seed)
    return cfg


class DeviceHealth:
    """The ladder. Thread-safe: kernel backends of several partitions (and
    their watchdog threads) report faults concurrently; transitions are
    serialized under one lock and audited outside it."""

    def __init__(self, cfg: DeviceDefenseCfg | None = None,
                 clock=time.time) -> None:
        self.cfg = cfg if cfg is not None else defense_cfg_from_env()
        self._clock = clock
        self._lock = threading.Lock()
        self.state = HEALTHY
        self.faults: dict[str, int] = {}
        self._fault_times: list[float] = []  # ms, bounded by window pruning
        self._last_fault_ms = 0.0
        self._canary_streak = 0
        self._last_canary_ms = 0.0
        self.shadow_checks = 0
        self.shadow_mismatches = 0
        self.host_reroutes = 0
        self.canary_attempts = 0
        self.canary_verified = 0
        #: bounded transition history (status surfaces render the tail)
        self.transitions: list[dict] = []
        #: (flight_recorder, partition_id) sink for audited events — wired
        #: by the broker partition that owns the flight recorder; process-
        #: wide ladder ⇒ one sink, last wiring wins (same-broker recorders
        #: share the ring anyway)
        self.flight_sink = None
        # JSONL evidence ledger (device-chaos harness only) — the shared
        # line-flushed discipline, one home with the chaos planes'
        from zeebe_tpu_torch.testing.chaos_common import JsonlLedger

        self._evidence = JsonlLedger()

    @property
    def evidence_file(self) -> str | None:
        return self._evidence.path

    @evidence_file.setter
    def evidence_file(self, value: str | None) -> None:
        self._evidence.path = value

    # -- fault/clean stream (called by the kernel backend) -------------------

    def now_ms(self) -> float:
        return self._clock() * 1000.0

    def note_fault(self, kind: str, detail: str = "") -> None:
        """One observed device fault (containment or shadow mismatch).
        HEALTHY latches SUSPECT; enough faults in the window escalate to
        QUARANTINED."""
        now = self.now_ms()
        _M_FAULTS.labels(kind).inc()
        with self._lock:
            self.faults[kind] = self.faults.get(kind, 0) + 1
            self._last_fault_ms = now
            horizon = now - self.cfg.fault_window_ms
            self._fault_times = [t for t in self._fault_times if t >= horizon]
            self._fault_times.append(now)
            recent = len(self._fault_times)
            if self.state == HEALTHY:
                transition = (SUSPECT, f"device fault `{kind}`: {detail}"
                              if detail else f"device fault `{kind}`")
            elif (self.state == SUSPECT
                  and recent >= self.cfg.quarantine_faults):
                transition = (
                    QUARANTINED,
                    f"{recent} device faults inside "
                    f"{self.cfg.fault_window_ms}ms (latest `{kind}`): all "
                    f"groups host-side, canary re-proving begins")
            else:
                transition = None
            if transition is not None:
                event = self._transition_locked(*transition, now)
            else:
                event = None
        if self.flight_sink is not None:
            # typed per-fault flight evidence (rare by construction: the
            # ladder quarantines a noisy device after quarantine_faults)
            flight, partition_id = self.flight_sink
            flight.record(partition_id, "device_fault", faultKind=kind,
                          detail=detail, state=self.state)
        if event is not None:
            self._audit(event)

    def note_group_ok(self) -> None:
        """A kernel group committed cleanly. While SUSPECT, a fault-free
        ``suspect_clear_ms`` window steps back down to HEALTHY."""
        event = None
        with self._lock:
            if self.state != SUSPECT:
                return
            now = self.now_ms()
            if now - self._last_fault_ms >= self.cfg.suspect_clear_ms:
                event = self._transition_locked(
                    HEALTHY,
                    f"{self.cfg.suspect_clear_ms}ms fault-free under "
                    f"boosted shadow sampling", now)
        if event is not None:
            self._audit(event)

    # -- shadow accounting ---------------------------------------------------

    def note_shadow_check(self) -> None:
        _M_SHADOW_CHECKS.inc()
        with self._lock:
            self.shadow_checks += 1

    def note_shadow_mismatch(self, detail: str = "") -> None:
        _M_SHADOW_MISMATCH.inc()
        with self._lock:
            self.shadow_mismatches += 1
        self.note_fault("shadow-mismatch", detail)

    def note_host_reroute(self) -> None:
        _M_HOST_REROUTES.inc()
        with self._lock:
            self.host_reroutes += 1

    # -- quarantine canary ---------------------------------------------------

    def is_quarantined(self) -> bool:
        return self.state == QUARANTINED

    def canary_due(self) -> bool:
        """While QUARANTINED: claim the next canary slot (at most one per
        interval across every partition sharing the ladder)."""
        with self._lock:
            if self.state != QUARANTINED:
                return False
            now = self.now_ms()
            if now - self._last_canary_ms < self.cfg.canary_interval_ms:
                return False
            self._last_canary_ms = now
            return True

    def release_canary(self) -> None:
        """Un-claim a canary slot that never dispatched (the group declined
        admission — a non-admittable head or an empty candidate iterator):
        the next quarantined pass may probe immediately instead of waiting
        out a canary interval the device never saw."""
        with self._lock:
            self._last_canary_ms = 0.0

    def note_canary(self, verified: bool, detail: str = "") -> None:
        """Outcome of one canary dispatch (verified = dispatched clean AND
        shadow-matched the host oracle)."""
        _M_CANARY.labels("verified" if verified else "failed").inc()
        event = None
        with self._lock:
            self.canary_attempts += 1
            if not verified:
                self._canary_streak = 0
                return
            self.canary_verified += 1
            self._canary_streak += 1
            if (self.state == QUARANTINED
                    and self._canary_streak >= self.cfg.canary_successes):
                event = self._transition_locked(
                    HEALTHY,
                    f"{self._canary_streak} consecutive canary dispatches "
                    f"verified against the host oracle", self.now_ms())
                self._canary_streak = 0
                self._fault_times.clear()
        if event is not None:
            self._audit(event)

    # -- transitions + audit -------------------------------------------------

    def _transition_locked(self, to: str, reason: str, now_ms: float) -> dict:
        before = self.state
        self.state = to
        _M_STATE.set(float(_STATE_VALUE[to]))
        _M_TRANSITIONS.labels(to).inc()
        event = {"atMs": now_ms, "from": before, "to": to, "reason": reason,
                 "pid": os.getpid()}
        self.transitions.append(event)
        del self.transitions[:-32]
        logger.warning("device health %s -> %s: %s", before, to, reason)
        return event

    def _audit(self, event: dict) -> None:
        """The control_adjust-style audit record + evidence line for one
        transition — outside the ladder lock (the flight recorder takes its
        own lock; evidence IO must never serialize fault noting)."""
        from zeebe_tpu_torch.control.audit import record_adjust

        flight, partition_id = (self.flight_sink
                                if self.flight_sink is not None else (None, 0))
        record_adjust(
            flight, partition_id, "device-health", "device.healthState",
            event["from"], event["to"], event["reason"],
            signals={"recentFaults": len(self._fault_times),
                     "shadowMismatches": self.shadow_mismatches})
        if flight is not None:
            flight.record(partition_id, "device_health", **event)
        self._evidence.append(event)

    # -- surfaces ------------------------------------------------------------

    def status(self) -> dict:
        """The ``device`` block on ``/health`` kernelCoverage and the
        compact ``/cluster/status`` row."""
        with self._lock:
            return {
                "state": self.state,
                "faults": dict(self.faults),
                "shadowChecks": self.shadow_checks,
                "shadowMismatches": self.shadow_mismatches,
                "hostReroutes": self.host_reroutes,
                "canaries": {"attempts": self.canary_attempts,
                             "verified": self.canary_verified},
                **({"lastTransition": self.transitions[-1]}
                   if self.transitions else {}),
            }


_shared: DeviceHealth | None = None
_shared_lock = threading.Lock()


def shared_device_health() -> DeviceHealth:
    """Process-wide ladder: every partition's kernel backend shares one
    device health state (matching the shared BackendRouter — the device is
    a per-process resource)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = DeviceHealth()
        return _shared


def reset_shared_device_health() -> None:
    """Test seam: drop the process-wide ladder so a test that provoked
    SUSPECT/QUARANTINED cannot leak its posture into later tests."""
    global _shared
    with _shared_lock:
        _shared = None
        _M_STATE.set(0.0)
