"""Process-global tracer: the one object every instrumentation point checks.

The hot paths (writer append, stream processor command loop, exporter
delivery) each pay exactly ONE attribute read — ``if tracer.enabled:`` — when
tracing is off; everything else lives behind that guard. ``get_tracer()``
always returns the same singleton and ``configure_tracing`` mutates it in
place, so call sites may cache the reference at construction time and never
observe a stale tracer.

Three cross-cutting services ride on the tracer besides span emission:

- **append→ack latency**: ``note_append`` stamps a command position at append
  time; the stream processor takes the stamp when the command's step commits
  and feeds the ``command_ack_latency`` histogram (scope=processor). The
  gateway runtime observes the same histogram request→response
  (scope=gateway). A bounded reservoir of raw values backs ``bench.py
  --trace``'s p50/p99.
- **export dedupe**: per-(exporter, partition, position) first-seen check so
  at-least-once re-delivery after a crash-restart can never duplicate an
  ``exporter.export`` span (the zero-duplicate-spans replay contract).
- **sampling**: delegated to the seeded :class:`DeterministicSampler` so a
  chaos run replayed from its seed traces the same records.

Replay never reaches the tracer at all: spans are minted only on the live
processing path (gateway submit, client_write, PROCESSING-phase steps,
exporter delivery) — ``StreamProcessor.replay_available`` has no tracing
hooks, which is what makes crash-restart replay structurally unable to
emit duplicate spans.

Environment activation (for ``zeebe_tpu_torch.standalone`` and friends, no code
change needed): ``ZEEBE_TRACING=1`` enables at startup;
``ZEEBE_TRACE_SAMPLE_RATE`` (default 1.0), ``ZEEBE_TRACE_SEED`` (default 0)
and ``ZEEBE_TRACE_CAPACITY`` (default 16384) tune it.
"""

from __future__ import annotations

import os
import time

from zeebe_tpu_torch.observability.span import (
    DeterministicSampler,
    Span,
    SpanCollector,
    now_us,
)
from zeebe_tpu_torch.utils import evict_oldest_half as _evict_oldest_half
from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

# command→ack end-to-end histogram (the latency-attribution companion to the
# reference-parity process_instance_execution_time / job_life_time, which the
# exporter director's ExecutionLatencyObserver already serves):
#   scope=gateway   — request submitted → response received (full round trip)
#   scope=processor — command appended → step committed + response dispatched
_M_ACK_LATENCY = _REG.histogram(
    "command_ack_latency",
    "seconds from command submission/append to acknowledgment",
    ("scope",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0),
)

_APPEND_TABLE_LIMIT = 65536
_ROOT_TABLE_LIMIT = 131072
_EXPORT_SEEN_LIMIT = 65536
_ACK_RESERVOIR_LIMIT = 262144


class Tracer:
    __slots__ = ("enabled", "collector", "sampler", "_append_t", "_roots",
                 "_export_seen", "_ack_reservoir", "_ack_children")

    def __init__(self) -> None:
        self.enabled = False
        self.collector = SpanCollector()
        self.sampler = DeterministicSampler()
        # (partition, position) → perf_counter at append, bounded
        self._append_t: dict[tuple[int, int], float] = {}
        # (partition, position) → transitive root command position, bounded.
        # Populated at append time batch by batch (appends are ordered, so a
        # batch's source is registered before the batch itself), which keeps
        # multi-hop causal chains — a follow-up command's own follow-ups —
        # on their ORIGINAL trace id instead of fragmenting per hop
        self._roots: dict[tuple[int, int], int] = {}
        # ordered set (dict) of export-span identities already emitted
        self._export_seen: dict[tuple, None] = {}
        # raw ack latencies (seconds) for p50/p99; bounded — past the cap the
        # percentiles summarize the run's first N acks, which is fine for the
        # bench's steady-state question
        self._ack_reservoir: list[float] = []
        self._ack_children = {
            "gateway": _M_ACK_LATENCY.labels("gateway"),
            "processor": _M_ACK_LATENCY.labels("processor"),
        }

    # -- lifecycle -------------------------------------------------------------

    def enable(self, seed: int = 0, sample_rate: float = 1.0,
               capacity: int = 16384, reset: bool = True) -> None:
        if reset:
            self.clear()
        self.sampler = DeterministicSampler(seed=seed, rate=sample_rate)
        if capacity != self.collector.capacity:
            self.collector.resize(capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.collector.clear()
        self._append_t.clear()
        self._roots.clear()
        self._export_seen.clear()
        self._ack_reservoir.clear()

    # -- sampling / emission ---------------------------------------------------

    def sampled(self, trace_id: str) -> bool:
        return self.sampler.sampled(trace_id)

    def emit(self, trace_id: str, name: str, dur_s: float,
             partition_id: int = 0, parent: str = "",
             attrs: dict | None = None, start_us: int | None = None) -> None:
        """Record a span that just finished (start is back-dated by the
        duration unless the caller positions it with ``start_us`` — waits
        that ended BEFORE emission time, like a command's backlog wait
        reported at group end, must carry their real interval or the
        critical-path sweep would charge them to the wrong segment).
        Caller is responsible for the ``enabled`` + ``sampled`` guards —
        this method only materializes the span."""
        dur_us = int(dur_s * 1e6)
        if start_us is None:
            start_us = now_us() - dur_us
        self.collector.add(Span(trace_id, name, start_us, dur_us,
                                partition_id, parent, attrs))

    # -- trace roots (transitive causal lineage) -------------------------------

    def register_batch(self, partition_id: int, first_position: int,
                       count: int, source_position: int) -> None:
        """Record each appended record's transitive ROOT command position: a
        sourced batch inherits its source's root (the source was appended —
        and registered — earlier), a source-less batch's records are their
        own roots (client/scheduled/inter-partition commands)."""
        table = self._roots
        if len(table) + count >= _ROOT_TABLE_LIMIT:
            _evict_oldest_half(table, max(_ROOT_TABLE_LIMIT, len(table)))
        if source_position >= 1:
            root = table.get((partition_id, source_position), source_position)
            for i in range(count):
                table[(partition_id, first_position + i)] = root
        else:
            for i in range(count):
                table[(partition_id, first_position + i)] = first_position + i

    def resolve_root(self, partition_id: int, position: int,
                     fallback: int) -> int:
        """The registered transitive root of ``position`` (falls back to the
        caller's one-hop guess when the table evicted it or the record
        predates tracing being enabled)."""
        return self._roots.get((partition_id, position), fallback)

    # -- command→ack latency ---------------------------------------------------

    def note_append(self, partition_id: int, position: int) -> None:
        table = self._append_t
        if len(table) >= _APPEND_TABLE_LIMIT:
            _evict_oldest_half(table, _APPEND_TABLE_LIMIT)
        table[(partition_id, position)] = time.perf_counter()

    def take_append(self, partition_id: int, position: int) -> float | None:
        return self._append_t.pop((partition_id, position), None)

    def observe_ack(self, scope: str, seconds: float) -> None:
        self._ack_children[scope].observe(seconds)
        if self.enabled and len(self._ack_reservoir) < _ACK_RESERVOIR_LIMIT:
            self._ack_reservoir.append(seconds)

    def latency_percentiles(self) -> dict:
        """p50/p99 over the collected ack latencies (milliseconds)."""
        values = sorted(self._ack_reservoir)
        if not values:
            return {"ack_count": 0}
        def pct(q: float) -> float:
            idx = min(len(values) - 1, int(q * (len(values) - 1) + 0.5))
            return round(values[idx] * 1000.0, 4)
        return {
            "ack_count": len(values),
            "ack_p50_ms": pct(0.50),
            "ack_p99_ms": pct(0.99),
        }

    # -- export dedupe ---------------------------------------------------------

    def mark_exported(self, identity: tuple) -> bool:
        """True exactly once per identity — the second delivery of the same
        (exporter, partition, position), e.g. at-least-once re-delivery after
        a crash-restart, emits no span."""
        seen = self._export_seen
        if identity in seen:
            return False
        if len(seen) >= _EXPORT_SEEN_LIMIT:
            _evict_oldest_half(seen, _EXPORT_SEEN_LIMIT)
        seen[identity] = None
        return True


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer singleton (mutated in place by
    ``configure_tracing`` — cached references never go stale)."""
    return _TRACER


def configure_tracing(enabled: bool = True, seed: int = 0,
                      sample_rate: float = 1.0, capacity: int = 16384,
                      reset: bool = True) -> Tracer:
    if enabled:
        _TRACER.enable(seed=seed, sample_rate=sample_rate, capacity=capacity,
                       reset=reset)
    else:
        _TRACER.disable()
        if reset:
            _TRACER.clear()
    return _TRACER


def _configure_from_env() -> None:
    if os.environ.get("ZEEBE_TRACING", "").lower() not in ("1", "true", "yes"):
        return
    try:
        rate = float(os.environ.get("ZEEBE_TRACE_SAMPLE_RATE", "1.0"))
        seed = int(os.environ.get("ZEEBE_TRACE_SEED", "0"))
        capacity = int(os.environ.get("ZEEBE_TRACE_CAPACITY", "16384"))
    except ValueError:
        rate, seed, capacity = 1.0, 0, 16384
    _TRACER.enable(seed=seed, sample_rate=rate, capacity=capacity)


_configure_from_env()
