"""Per-partition flight recorder: the broker's black box.

A crashed broker's most valuable telemetry is the few hundred events *before*
the crash — exactly what a pull-based ``/metrics`` scrape has already lost by
the time anyone looks. The flight recorder keeps a bounded ring of
operationally significant events per partition (role changes, processing
errors, backpressure rejections, slow journal flushes, exporter health
transitions, committed-batch summaries) plus a node-level ring (broker health
transitions, alert state changes), and

- serves the live rings at ``GET /flight`` on the management server, and
- **dumps them to ``<data-dir>/flight-<ts>.json``** when the broker crashes
  or turns unhealthy, so the postmortem evidence survives the process.

Events are tiny dicts appended to ``deque(maxlen=...)`` rings — recording is
O(1), allocation-light, and safe on any thread. Dumps are throttled (one per
``dump_min_interval_ms`` per reason class) so a flapping component cannot
turn the data dir into a log spool; rings are NOT cleared by a dump, so a
later, more fatal dump still carries the earlier context.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable

DEFAULT_CAPACITY = 256
DUMP_MIN_INTERVAL_MS = 5_000
# per-dump serialized-size cap:'s autotune run
# committed multiple >4k-line flight JSONs — gate dumps must stay
# reviewable. Oldest ring entries drop first; the dump records how many.
DEFAULT_MAX_DUMP_BYTES = 262_144


def _max_dump_bytes() -> int:
    try:
        return int(os.environ.get("ZEEBE_FLIGHT_MAXDUMPBYTES",
                                  DEFAULT_MAX_DUMP_BYTES))
    except ValueError:
        return DEFAULT_MAX_DUMP_BYTES


class FlightRecorder:
    def __init__(self, node_id: str, data_dir: str | Path | None,
                 capacity: int = DEFAULT_CAPACITY,
                 clock_millis: Callable[[], int] | None = None,
                 max_dump_bytes: int | None = None) -> None:
        self.node_id = node_id
        self.data_dir = Path(data_dir) if data_dir is not None else None
        self.capacity = capacity
        self.max_dump_bytes = (max_dump_bytes if max_dump_bytes is not None
                               else _max_dump_bytes())
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        # partition id 0 = node-level ring (health, alerts, journal stalls)
        self._rings: dict[int, deque] = {}
        self._lock = threading.Lock()
        self._last_dump_ms: dict[str, int] = {}
        self.events_recorded = 0
        # extra context suppliers folded into dumps (alert snapshot etc.)
        self._context_providers: list[Callable[[], dict]] = []

    def add_context_provider(self, provider: Callable[[], dict]) -> None:
        self._context_providers.append(provider)

    def record(self, partition_id: int, kind: str, **detail) -> None:
        event = {"t": self.clock_millis(), "kind": kind, **detail}
        with self._lock:
            ring = self._rings.get(partition_id)
            if ring is None:
                ring = self._rings[partition_id] = deque(maxlen=self.capacity)
            ring.append(event)
            self.events_recorded += 1

    def occupancy(self) -> float:
        """Mean fill ratio across the live rings (0..1) — the fleet
        auditor's ``zeebe_flight_ring_occupancy_ratio`` source. Bounded
        rings saturate at 1.0 by design; the leak trend watches the CLIMB
        toward it, not the ceiling."""
        with self._lock:
            if not self._rings or self.capacity <= 0:
                return 0.0
            return sum(len(r) for r in self._rings.values()) / (
                len(self._rings) * self.capacity)

    def snapshot(self) -> dict:
        with self._lock:
            rings = {str(pid): list(ring)
                     for pid, ring in sorted(self._rings.items())}
        return {
            "nodeId": self.node_id,
            "capacityPerRing": self.capacity,
            "eventsRecorded": self.events_recorded,
            "partitions": rings,
        }

    def dump(self, reason: str, force: bool = False) -> Path | None:
        """Write the rings to ``<data-dir>/flight-<ts>.json``. Returns the
        path, or None when there is no data dir or the reason class dumped
        within the throttle window (``force`` bypasses the throttle — crashes
        always leave evidence)."""
        if self.data_dir is None:
            return None
        now = self.clock_millis()
        reason_class = reason.split(":", 1)[0]
        if not force:
            last = self._last_dump_ms.get(reason_class, -DUMP_MIN_INTERVAL_MS)
            if now - last < DUMP_MIN_INTERVAL_MS:
                return None
        self._last_dump_ms[reason_class] = now
        payload = self.snapshot()
        payload["reason"] = reason
        payload["dumpedAtMs"] = now
        for provider in self._context_providers:
            try:
                payload.update(provider())
            except Exception:  # noqa: BLE001 — context is best-effort; the
                pass           # rings themselves must always land on disk
        body = self._bounded_body(payload)
        # wall-clock nanos disambiguate dumps under a controlled test clock
        # (many dumps can share one frozen clock_millis value)
        path = self.data_dir / f"flight-{now}-{time.monotonic_ns()}.json"
        try:
            self.data_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".json.tmp")
            tmp.write_bytes(body)
            tmp.replace(path)
        except OSError:
            return None  # a full/readonly disk must not turn a dump fatal
        return path

    def dump_payload(self, reason: str, payload: dict,
                     force: bool = False) -> Path | None:
        """Write a non-ring evidence payload (e.g. the latency observatory's
        slow-exemplar span trees) under the same data dir, per-reason-class
        throttle, and ``max_dump_bytes`` cap as ring dumps. Oversized
        payloads drop whole entries from a ``traces`` dict, largest first,
        recording ``truncatedTraces`` — a bounded dump is never mistaken
        for the full evidence."""
        if self.data_dir is None:
            return None
        now = self.clock_millis()
        reason_class = reason.split(":", 1)[0]
        if not force:
            last = self._last_dump_ms.get(reason_class, -DUMP_MIN_INTERVAL_MS)
            if now - last < DUMP_MIN_INTERVAL_MS:
                return None
        self._last_dump_ms[reason_class] = now
        doc = {"nodeId": self.node_id, "reason": reason, "dumpedAtMs": now}
        doc.update(payload)
        body = json.dumps(doc, indent=1, default=str).encode("utf-8")
        while self.max_dump_bytes > 0 and len(body) > self.max_dump_bytes:
            traces = doc.get("traces")
            if not isinstance(traces, dict) or not traces:
                break  # nothing droppable; ship what we have
            victim = max(traces, key=lambda t: len(traces[t]))
            del traces[victim]
            doc["truncatedTraces"] = doc.get("truncatedTraces", 0) + 1
            body = json.dumps(doc, indent=1, default=str).encode("utf-8")
        path = self.data_dir / f"flight-{now}-{time.monotonic_ns()}.json"
        try:
            self.data_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".json.tmp")
            tmp.write_bytes(body)
            tmp.replace(path)
        except OSError:
            return None
        return path

    def _bounded_body(self, payload: dict) -> bytes:
        """Serialize a dump under ``max_dump_bytes`` (UTF-8 bytes on disk,
        not code points — non-ASCII event content must not overshoot the
        cap): oldest ring entries drop first (round-robin across the
        largest rings so one chatty partition cannot evict every other
        ring), and the dump records ``truncatedEntries`` so a bounded dump
        is never mistaken for the full evidence. Context providers are
        kept — they are small and per-dump (the rings are what grow)."""
        body = json.dumps(payload, indent=1, default=str).encode("utf-8")
        if self.max_dump_bytes <= 0 or len(body) <= self.max_dump_bytes:
            return body
        rings = {pid: list(events)
                 for pid, events in payload["partitions"].items()}
        truncated = 0
        while len(body) > self.max_dump_bytes:
            victim = max(rings, key=lambda pid: len(rings[pid]), default=None)
            if victim is None or not rings[victim]:
                break  # nothing left to drop; ship what we have
            # drop the oldest quarter of the largest ring per pass: a few
            # serialize rounds instead of one per event
            drop = max(1, len(rings[victim]) // 4)
            del rings[victim][:drop]
            truncated += drop
            payload["partitions"] = {p: r for p, r in rings.items() if r}
            payload["truncatedEntries"] = truncated
            body = json.dumps(payload, indent=1, default=str).encode("utf-8")
        return body


def install_journal_stall_listener(recorder: FlightRecorder) -> None:
    """Register the recorder on the journal module's slow-flush seam: a
    flush above ``journal.SLOW_FLUSH_THRESHOLD_S`` records a node-level
    ``flush_stall`` event (the journal is below the partition abstraction —
    it only knows its directory). The seam is module-global, so in a
    multi-broker process the recorder keeps only stalls under its own data
    directory — another broker's stalls are not this black box's evidence."""
    from zeebe_tpu_torch.journal import journal as journal_mod

    prefix = str(recorder.data_dir) if recorder.data_dir is not None else ""

    def on_slow_flush(directory: str, seconds: float) -> None:
        if prefix and not directory.startswith(prefix):
            return
        recorder.record(0, "flush_stall", dir=directory,
                        seconds=round(seconds, 4))

    # identity-tagged so remove can find this recorder's listener
    on_slow_flush._flight_recorder = recorder  # type: ignore[attr-defined]
    journal_mod.slow_flush_listeners.append(on_slow_flush)


def remove_journal_stall_listener(recorder: FlightRecorder) -> None:
    from zeebe_tpu_torch.journal import journal as journal_mod

    journal_mod.slow_flush_listeners[:] = [
        fn for fn in journal_mod.slow_flush_listeners
        if getattr(fn, "_flight_recorder", None) is not recorder
    ]
