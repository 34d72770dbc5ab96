"""Tenant-aware admission + cooperative load shedding (DAGOR-shaped).

Reference: Zhou et al., *Overload Control for Scaling WeChat Microservices*
(SoCC 2018) — feedback-driven admission with business priorities — applied
to this gateway's client-command ingress, in front of the per-partition
in-flight limiters (`broker/backpressure.py`). Three independent gates, in
order, each producing a **typed, fast** rejection (`RESOURCE_EXHAUSTED` at
the gRPC surface; a `resource-exhausted` error frame on the multi-process
wire) instead of a queue that collapses under overload:

1. **Priority ladder** (cooperative shedding): every client command is
   classified onto a four-rung ladder — internal completions (the
   backpressure whitelist: job COMPLETE/FAIL) > in-flight continuations
   (message publish, job batch activation, incident resolve, variable
   updates, cancels) > new work (instance creates, deployments, signals) >
   queries/unclassified. The shed level is driven by **observed ack-latency
   percentiles** (the Gorilla time-series plane where one is attached —
   shed signal latency is one sampler tick — or the controller's own
   bounded latency window otherwise) with hysteresis: `breach_ticks`
   consecutive p99 breaches raise the level one rung, `clear_ticks`
   consecutive clear ticks lower it. Completions are never shed — shedding
   work that *finishes* in-flight work makes overload worse.
2. **Per-tenant token buckets**: tenant identity comes from request
   metadata (the record value's ``tenantId``), falling back to the client
   stream id; each tenant refills at its quota rate up to a burst. A hot
   tenant saturates its own bucket and gets typed rejections while every
   other tenant's bucket stays full.
3. **Weighted-fair in-flight sharing**: when the admission window is
   contended (total in-flight at the cap), a tenant is admitted only while
   its in-flight count is below its weight share of the window — the
   work-conserving approximation of weighted-fair queuing over a
   synchronous ingress (an uncontended tenant may use the whole window).

Every shed is a flight-recorder event and a ``zeebe_admission_*`` metric;
sustained shedding at or above the new-work rung flips the controller into
a *draining* state so the gateway's ``/ready`` degrades and a load balancer
can rotate it out.

Thread model: ``try_admit``/``release`` run on gateway request threads (or
the worker ingress pump) under one controller lock; the controller never
touches partition state — committed-read discipline is moot because there
are no reads at all, only its own counters.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from zeebe_tpu_torch.broker.backpressure import WHITELIST
from zeebe_tpu_torch.protocol import Record, ValueType
from zeebe_tpu_torch.utils.metrics import REGISTRY, estimate_quantile

# -- the priority ladder -------------------------------------------------------

#: internal completions: finishing in-flight work drains load — never shed
#: (exactly the backpressure whitelist, one home: broker/backpressure.py)
PRIORITY_COMPLETION = 0
#: continuations of already-admitted work (activations, correlations,
#: incident resolution, variable updates, cancels)
PRIORITY_CONTINUATION = 1
#: new work entering the system (instance creates, deployments, signals)
PRIORITY_CREATE = 2
#: queries and anything unclassified — first against the wall
PRIORITY_QUERY = 3

_CONTINUATION_TYPES = frozenset({
    ValueType.JOB,                    # non-whitelist job commands (retries…)
    ValueType.JOB_BATCH,              # workers pulling queued work
    ValueType.MESSAGE,                # publishes correlate into waiting state
    ValueType.MESSAGE_BATCH,
    ValueType.VARIABLE_DOCUMENT,
    ValueType.INCIDENT,
    ValueType.PROCESS_INSTANCE,       # cancel / modify of a live instance
    ValueType.PROCESS_INSTANCE_MODIFICATION,
    ValueType.PROCESS_INSTANCE_MIGRATION,
    ValueType.USER_TASK,
})
_CREATE_TYPES = frozenset({
    ValueType.PROCESS_INSTANCE_CREATION,
    ValueType.DEPLOYMENT,
    ValueType.SIGNAL,
    ValueType.RESOURCE_DELETION,
})

#: shed ladder: at shed level L every priority >= _SHED_FLOOR - L is shed
#: (level 1 sheds queries, 2 sheds new work too, 3 leaves only completions)
_SHED_FLOOR = 4
MAX_SHED_LEVEL = 3


def priority_of(record: Record) -> int:
    """Ladder rung for a client command (smaller = shed later)."""
    if (record.value_type, int(record.intent)) in WHITELIST:
        return PRIORITY_COMPLETION
    if record.value_type in _CONTINUATION_TYPES:
        return PRIORITY_CONTINUATION
    if record.value_type in _CREATE_TYPES:
        return PRIORITY_CREATE
    return PRIORITY_QUERY


def tenant_of(record: Record) -> str:
    """Tenant identity from request metadata: the record value's
    ``tenantId`` when the client sent one, else the client stream id — an
    anonymous client is still rate-isolated from every other stream."""
    value = record.value
    tenant = value.get("tenantId") if isinstance(value, dict) else None
    if tenant:
        return str(tenant)
    return f"stream-{record.request_stream_id}"


# -- token bucket --------------------------------------------------------------


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s up to ``burst``. ``rate <= 0``
    means unmetered (always admits). Caller holds the controller lock."""

    __slots__ = ("rate", "burst", "tokens", "last_ms")

    def __init__(self, rate: float, burst: float, now_ms: float) -> None:
        self.rate = rate
        self.burst = max(burst, 1.0)
        self.tokens = self.burst
        self.last_ms = now_ms

    def try_take(self, now_ms: float) -> bool:
        if self.rate <= 0:
            return True
        elapsed = max(now_ms - self.last_ms, 0.0) / 1000.0
        self.last_ms = now_ms
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


# -- configuration -------------------------------------------------------------


def _parse_tenant_map(spec: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition("=")
        if name and value:
            out[name.strip()] = value.strip()
    return out


@dataclass
class AdmissionCfg:
    """Knobs (``ZEEBE_GATEWAY_TENANT_*`` / ``ZEEBE_GATEWAY_ADMISSION_*``)."""

    enabled: bool = True
    #: default per-tenant quota (tokens/s); 0 = unmetered
    default_rate: float = 0.0
    #: default burst; 0 = derive (2x rate)
    default_burst: float = 0.0
    #: per-tenant (rate, burst) overrides
    quotas: dict[str, tuple[float, float]] = field(default_factory=dict)
    #: per-tenant weights for the fair in-flight share (default 1.0)
    weights: dict[str, float] = field(default_factory=dict)
    #: admission window for the weighted-fair share (in-flight commands)
    max_inflight: int = 256
    #: shed target: raise the shed level while observed ack p99 exceeds this
    shed_p99_ms: float = 1000.0
    #: hysteresis: recover only below this fraction of the target
    recover_fraction: float = 0.5
    breach_ticks: int = 3
    clear_ticks: int = 5
    tick_interval_ms: int = 1000
    #: /ready degrades after shedding NEW WORK for this long (0 disables)
    drain_after_ms: int = 10_000

    @classmethod
    def from_env(cls, env: dict | None = None) -> "AdmissionCfg":
        env = os.environ if env is None else env

        def _f(name: str, default: float) -> float:
            try:
                return float(env.get(name, ""))
            except ValueError:
                return default

        cfg = cls()
        cfg.enabled = env.get(
            "ZEEBE_GATEWAY_ADMISSION_ENABLED", "true").lower() in (
                "1", "true", "yes")
        cfg.default_rate = _f("ZEEBE_GATEWAY_TENANT_DEFAULTRATE", 0.0)
        cfg.default_burst = _f("ZEEBE_GATEWAY_TENANT_DEFAULTBURST", 0.0)
        cfg.max_inflight = int(_f("ZEEBE_GATEWAY_ADMISSION_MAXINFLIGHT", 256))
        cfg.shed_p99_ms = _f("ZEEBE_GATEWAY_ADMISSION_SHEDP99MS", 1000.0)
        cfg.drain_after_ms = int(
            _f("ZEEBE_GATEWAY_ADMISSION_DRAINAFTERMS", 10_000))
        for tenant, spec in _parse_tenant_map(
                env.get("ZEEBE_GATEWAY_TENANT_QUOTAS", "")).items():
            rate_s, _, burst_s = spec.partition(":")
            try:
                rate = float(rate_s)
                burst = float(burst_s) if burst_s else 0.0
            except ValueError:
                continue
            cfg.quotas[tenant] = (rate, burst)
        for tenant, spec in _parse_tenant_map(
                env.get("ZEEBE_GATEWAY_TENANT_WEIGHTS", "")).items():
            try:
                cfg.weights[tenant] = float(spec)
            except ValueError:
                continue
        return cfg


# -- metrics (module-level: families exist from first import) ------------------

#: distinct tenant label values are bounded; overflow folds into "other"
_MAX_TENANT_LABELS = 64

#: per-tenant controller state (buckets, counters) is bounded too: a client
#: minting a fresh tenantId per request must not grow memory without limit —
#: oldest-inserted entries evict first (their tenants re-enter with a fresh
#: bucket, which only ever errs toward admitting)
_MAX_TRACKED_TENANTS = 4096

_M_ADMITTED = REGISTRY.counter(
    "admission_admitted_total",
    "client commands admitted by the tenant admission controller",
    ("node", "tenant"))
_M_SHED = REGISTRY.counter(
    "admission_shed_total",
    "client commands shed by the admission controller, by reason "
    "(priority = shed ladder, tenant-quota = token bucket, "
    "fair-share = weighted in-flight share)",
    ("node", "tenant", "reason"))
_M_SHED_LEVEL = REGISTRY.gauge(
    "admission_shed_level",
    "current shed-ladder level (0 = admit all, 3 = completions only)",
    ("node",))
_M_INFLIGHT = REGISTRY.gauge(
    "admission_inflight_commands",
    "client commands in flight through the admission window", ("node",))
_M_P99 = REGISTRY.gauge(
    "admission_observed_p99_ms",
    "the ack-latency p99 the shed ladder last evaluated (ms)", ("node",))
_M_DRAINING = REGISTRY.gauge(
    "admission_draining",
    "1 while sustained shedding degrades /ready so an LB can drain this "
    "gateway", ("node",))
_M_ACK_LATENCY = REGISTRY.histogram(
    "admission_ack_latency_ms",
    "ack latency observed by the admission controller (ms) — the shed "
    "ladder's feedback signal",
    ("node",),
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000))

_SHED_REASONS = ("priority", "tenant-quota", "fair-share")


class AdmissionController:
    """One admission gate: the multi-process gateway runtime holds one (its
    request threads call ``try_admit``/``release``), and every worker holds
    one in front of its partitions' backpressure limiters."""

    def __init__(self, cfg: AdmissionCfg | None = None,
                 node_id: str = "gateway",
                 clock_millis=None,
                 flight=None,
                 max_inflight_fn=None,
                 p99_source=None) -> None:
        self.cfg = cfg or AdmissionCfg()
        self.node_id = node_id
        self.clock_millis = clock_millis or (lambda: time.time() * 1000.0)
        #: flight recorder (or None): every shed and level change is an event
        self.flight = flight
        #: dynamic admission window override (the worker wires the sum of its
        #: leader partitions' backpressure limits here so the fair share sits
        #: exactly in front of the per-partition limiters)
        self.max_inflight_fn = max_inflight_fn
        #: external p99 source (ms) — the broker wires the Gorilla
        #: time-series store's retained percentile here; None falls back to
        #: the controller's own bounded window
        self.p99_source = p99_source
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self._inflight_total = 0
        # bounded ack-latency window for the store-less fallback: histogram
        # bucket counts, reset each tick (the same estimate_quantile shape
        # the time-series sampler uses)
        self._lat_buckets = list(_M_ACK_LATENCY.buckets)
        self._lat_counts = [0] * (len(self._lat_buckets) + 1)
        self.shed_level = 0
        self.level_changes = 0
        self._breaches = 0
        self._clears = 0
        self._last_tick_ms = 0.0
        self._shedding_creates_since: float | None = None
        self.draining = False
        self.last_p99_ms = 0.0
        # per-tenant running totals for snapshot()/top (metrics carry the
        # same data; these avoid a registry scrape on every status push)
        self._admitted: dict[str, int] = {}
        self._shed: dict[str, dict[str, int]] = {}
        self._tenant_labels: set[str] = set()
        label = node_id
        self._g_level = _M_SHED_LEVEL.labels(label)
        self._g_inflight = _M_INFLIGHT.labels(label)
        self._g_p99 = _M_P99.labels(label)
        self._g_draining = _M_DRAINING.labels(label)
        self._h_latency = _M_ACK_LATENCY.labels(label)
        self._g_level.set(0)
        self._g_draining.set(0)

    # -- label hygiene ---------------------------------------------------------

    def _label(self, tenant: str) -> str:
        if tenant in self._tenant_labels:
            return tenant
        if len(self._tenant_labels) >= _MAX_TENANT_LABELS:
            return "other"
        self._tenant_labels.add(tenant)
        return tenant

    # -- admission -------------------------------------------------------------

    def _bucket(self, tenant: str, now_ms: float) -> TokenBucket:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate, burst = self.cfg.quotas.get(
                tenant, (self.cfg.default_rate, self.cfg.default_burst))
            if burst <= 0:
                burst = max(rate, 1.0) * 2.0
            bucket = self._buckets[tenant] = TokenBucket(rate, burst, now_ms)
            for tracked in (self._buckets, self._admitted, self._shed):
                while len(tracked) > _MAX_TRACKED_TENANTS:
                    tracked.pop(next(iter(tracked)))
        return bucket

    def _fair_share(self, tenant: str) -> float:
        """This tenant's share of the admission window: weight over the sum
        of ACTIVE tenants' weights (work-conserving — an idle tenant's
        weight does not reserve capacity)."""
        weight = self.cfg.weights.get(tenant, 1.0)
        total = weight
        for other, count in self._inflight.items():
            if count > 0 and other != tenant:
                total += self.cfg.weights.get(other, 1.0)
        cap = (self.max_inflight_fn() if self.max_inflight_fn is not None
               else self.cfg.max_inflight) or self.cfg.max_inflight
        return max(1.0, cap * weight / total), cap

    def try_admit(self, record: Record,
                  now_ms: float | None = None) -> tuple[str | None, str, int]:
        """Admission decision for one client command. Returns
        ``(None, tenant, priority)`` on admit — the caller MUST pair it with
        ``release(tenant)`` once the command completes or fails — or
        ``(reason, tenant, priority)`` on shed (no release due)."""
        tenant = tenant_of(record)
        priority = priority_of(record)
        if not self.cfg.enabled:
            return None, tenant, priority
        now = self.clock_millis() if now_ms is None else now_ms
        with self._lock:
            reason = None
            if priority >= _SHED_FLOOR - self.shed_level:
                reason = "priority"
            elif (priority != PRIORITY_COMPLETION
                  and not self._bucket(tenant, now).try_take(now)):
                # completions ride for free: a tenant over quota must still
                # be able to finish the work it already holds
                reason = "tenant-quota"
            else:
                share, cap = self._fair_share(tenant)
                if (self._inflight_total >= cap
                        and priority != PRIORITY_COMPLETION
                        and self._inflight.get(tenant, 0) >= share):
                    reason = "fair-share"
            label = self._label(tenant)
            if reason is None:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
                self._inflight_total += 1
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            else:
                shed = self._shed.setdefault(tenant, {})
                shed[reason] = shed.get(reason, 0) + 1
        if reason is None:
            _M_ADMITTED.labels(self.node_id, label).inc()
            self._g_inflight.set(self._inflight_total)
        else:
            _M_SHED.labels(self.node_id, label, reason).inc()
            if self.flight is not None:
                self.flight.record(0, "admission_shed", tenant=tenant,
                                   reason=reason, priority=priority,
                                   level=self.shed_level,
                                   valueType=record.value_type.name)
        return reason, tenant, priority

    def release(self, tenant: str, latency_ms: float | None = None) -> None:
        """The admitted command completed (acked, rejected, or errored)."""
        if not self.cfg.enabled:
            return
        with self._lock:
            count = self._inflight.get(tenant, 0)
            if count > 1:
                self._inflight[tenant] = count - 1
                self._inflight_total -= 1
            elif count == 1:
                # drop the zero entry: idle tenants neither hold memory nor
                # count toward the active-weight denominator
                del self._inflight[tenant]
                self._inflight_total -= 1
        self._g_inflight.set(self._inflight_total)
        if latency_ms is not None:
            self.observe_ack(latency_ms)

    def observe_ack(self, latency_ms: float) -> None:
        """Feed one observed ack latency into the shed ladder's signal."""
        self._h_latency.observe(latency_ms)
        with self._lock:
            for i, bound in enumerate(self._lat_buckets):
                if latency_ms <= bound:
                    self._lat_counts[i] += 1
                    return
            self._lat_counts[-1] += 1

    # -- the shed ladder (feedback loop) ---------------------------------------

    def _window_p99(self) -> float | None:
        """p99 over the latencies observed since the last tick (the
        store-less fallback; the counts reset per tick so the signal tracks
        *recent* load, exactly like the sampler's delta percentiles)."""
        with self._lock:
            counts = list(self._lat_counts)
            self._lat_counts = [0] * len(self._lat_counts)
        if not sum(counts):
            return None
        return estimate_quantile(self._lat_buckets, counts, 0.99)

    def tick(self, now_ms: float | None = None) -> None:
        """Advance the feedback loop (call from the gateway poll loop or the
        worker pump); throttled to ``tick_interval_ms`` internally."""
        if not self.cfg.enabled:
            return
        now = self.clock_millis() if now_ms is None else now_ms
        if now - self._last_tick_ms < self.cfg.tick_interval_ms:
            return
        self._last_tick_ms = now
        p99 = None
        if self.p99_source is not None:
            try:
                p99 = self.p99_source()
            except Exception:  # noqa: BLE001 — a torn store read must not
                p99 = None     # kill the pump; fall back to the window
        if p99 is None:
            p99 = self._window_p99()
        if p99 is not None:
            self.last_p99_ms = p99
            self._g_p99.set(round(p99, 3))
        level = self.shed_level
        if p99 is not None and p99 > self.cfg.shed_p99_ms:
            self._breaches += 1
            self._clears = 0
            if self._breaches >= self.cfg.breach_ticks:
                self._breaches = 0
                level = min(level + 1, MAX_SHED_LEVEL)
        elif p99 is None or p99 <= (self.cfg.shed_p99_ms
                                    * self.cfg.recover_fraction):
            self._clears += 1
            self._breaches = 0
            if self._clears >= self.cfg.clear_ticks:
                self._clears = 0
                level = max(level - 1, 0)
        else:
            # between the recover floor and the target: hold (hysteresis)
            self._breaches = 0
            self._clears = 0
        if level != self.shed_level:
            old, self.shed_level = self.shed_level, level
            self.level_changes += 1
            self._g_level.set(level)
            # the shed ladder pre-dated the control plane but IS a closed
            # feedback loop: its decisions record under the shared
            # control_adjust vocabulary — one audit schema for
            # every loop, rendered together by `cli top` CONTROL
            from zeebe_tpu_torch.control.audit import record_adjust

            record_adjust(
                self.flight, 0, controller="admission-shed-ladder",
                knob="admission.shedLevel", before=old, after=level,
                reason=("ack p99 breached the shed target"
                        if level > old else
                        "ack p99 cleared the recovery floor"),
                signals={"p99Ms": round(p99 or 0.0, 1),
                         "targetMs": self.cfg.shed_p99_ms})
        # /ready drain: sustained shedding of NEW WORK (level >= 2) means
        # this gateway cannot serve its purpose — degrade readiness so the
        # LB sends tenants elsewhere while completions keep draining
        if self.shed_level >= MAX_SHED_LEVEL - 1 and self.cfg.drain_after_ms > 0:
            if self._shedding_creates_since is None:
                self._shedding_creates_since = now
            elif (not self.draining and now - self._shedding_creates_since
                  >= self.cfg.drain_after_ms):
                self.draining = True
                self._g_draining.set(1)
                if self.flight is not None:
                    self.flight.record(0, "admission_draining", draining=True)
        else:
            self._shedding_creates_since = None
            if self.draining:
                self.draining = False
                self._g_draining.set(0)
                if self.flight is not None:
                    self.flight.record(0, "admission_draining",
                                       draining=False)

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The admission block for ``/cluster/status`` and the worker status
        push (rendered by ``cli top``'s ADMISSION section)."""
        with self._lock:
            tenants = sorted(set(self._admitted) | set(self._shed)
                             | set(self._inflight))
            rows = {}
            for tenant in tenants:
                shed = self._shed.get(tenant, {})
                bucket = self._buckets.get(tenant)
                rows[tenant] = {
                    "admitted": self._admitted.get(tenant, 0),
                    "shed": sum(shed.values()),
                    "shedByReason": dict(shed),
                    "inflight": self._inflight.get(tenant, 0),
                    "quotaRate": bucket.rate if bucket is not None else None,
                    "weight": self.cfg.weights.get(tenant, 1.0),
                }
            return {
                "enabled": self.cfg.enabled,
                "shedLevel": self.shed_level,
                "draining": self.draining,
                "observedP99Ms": round(self.last_p99_ms, 1),
                "shedP99TargetMs": self.cfg.shed_p99_ms,
                "inflight": self._inflight_total,
                "maxInflight": (self.max_inflight_fn()
                                if self.max_inflight_fn is not None
                                else self.cfg.max_inflight),
                "tenants": rows,
            }
