"""ExporterDirector: drives all configured exporters over committed records.

Reference: broker/src/main/java/io/camunda/zeebe/broker/exporter/stream/
ExporterDirector.java:51 — an actor per partition reading the log *after*
commit (readNextEvent/exportEvent :389-431), wrapping each exporter in an
ExporterContainer, persisting exporter positions into the EXPORTER column
family (ExportersState), and reporting the minimum acknowledged position so
log compaction never deletes unexported records.

Here the director is pump-driven like the stream processor (the broker pump
calls ``export_available()`` after each processing round). Fault isolation is
per exporter: a throwing exporter pauses ITSELF with exponential retry backoff
(position pinned on the failed record — export stays at-least-once, the
director never skips), reports DEGRADED to the health monitor, and the other
exporters keep draining; each container owns its own read cursor so one
failing sink never stalls the rest (reference behavior: ExporterContainer
retries forever, but the reference runs one actor per exporter — isolation is
what the shared pump must reproduce)."""

from __future__ import annotations

import time as _time_mod

from typing import Callable

from zeebe_tpu_torch.exporters.api import Exporter, ExporterContext, ExporterController
from zeebe_tpu_torch.logstreams import LogStream
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.db import ColumnFamilyCode as CF
from zeebe_tpu_torch.utils.health import HealthStatus
from zeebe_tpu_torch.utils.zlogging import Loggers

# exponential retry backoff for a failing exporter (reference: the ES
# exporter's own client retries; here the seam is generic per container)
INITIAL_BACKOFF_MS = 100
MAX_BACKOFF_MS = 10_000


class ExecutionLatencyObserver:
    """Creation→completion latency metrics, computed on the committed
    record stream like the reference's broker exporter metrics (reference:
    broker/…/exporter/metrics/ExecutionLatencyMetrics.java) — so the kernel
    burst-template path is counted exactly like the sequential path."""

    _MAX_TRACKED = 32_768

    def __init__(self, partition_id: int) -> None:
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        pid = str(partition_id)
        self._partition = pid
        buckets = (0.005, 0.025, 0.1, 0.5, 1, 5, 30, 120, 600)
        self._m_pi_time = REGISTRY.histogram(
            "process_instance_execution_time",
            "seconds from instance activation to completion",
            ("partition",), buckets=buckets).labels(pid)
        self._m_creations = REGISTRY.counter(
            "process_instance_creations_total",
            "process instances created", ("partition",)).labels(pid)
        self._m_job_life = REGISTRY.histogram(
            "job_life_time", "seconds from job creation to completion",
            ("partition",), buckets=buckets).labels(pid)
        self._m_job_activation = REGISTRY.histogram(
            "job_activation_time", "seconds from job creation to activation",
            ("partition",), buckets=buckets).labels(pid)
        self._pi_started: dict[int, int] = {}
        self._job_created: dict[int, int] = {}
        self._m_pending_incidents = REGISTRY.gauge(
            "pending_incidents_total", "incidents created minus resolved",
            ("partition",)).labels(pid)
        self._m_buffered_messages = REGISTRY.gauge(
            "buffered_messages_count", "published messages minus expired",
            ("partition",)).labels(pid)

    def _remember(self, store: dict, key: int, ts: int) -> None:
        if len(store) >= self._MAX_TRACKED:
            store.pop(next(iter(store)))
        store[key] = ts

    def observe(self, logged) -> None:
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import (
            JobBatchIntent,
            JobIntent,
            ProcessInstanceCreationIntent,
            ProcessInstanceIntent,
        )

        rec = logged.record
        if not rec.is_event:
            return
        vt = rec.value_type
        intent = int(rec.intent)
        if vt == ValueType.PROCESS_INSTANCE:
            if rec.value.get("bpmnElementType") != "PROCESS":
                return
            if intent == int(ProcessInstanceIntent.ELEMENT_ACTIVATING):
                self._remember(self._pi_started, rec.key, rec.timestamp)
            elif intent in (int(ProcessInstanceIntent.ELEMENT_COMPLETED),
                            int(ProcessInstanceIntent.ELEMENT_TERMINATED)):
                started = self._pi_started.pop(rec.key, None)
                if started is not None:
                    self._m_pi_time.observe((rec.timestamp - started) / 1000.0)
        elif vt == ValueType.PROCESS_INSTANCE_CREATION:
            if intent == int(ProcessInstanceCreationIntent.CREATED):
                self._m_creations.inc()
        elif vt == ValueType.JOB:
            if intent == int(JobIntent.CREATED):
                self._remember(self._job_created, rec.key, rec.timestamp)
            elif intent in (int(JobIntent.COMPLETED), int(JobIntent.CANCELED)):
                created = self._job_created.pop(rec.key, None)
                if created is not None:
                    self._m_job_life.observe((rec.timestamp - created) / 1000.0)
        elif vt == ValueType.JOB_BATCH:
            if intent == int(JobBatchIntent.ACTIVATED):
                for job_key in rec.value.get("jobKeys", ()) or ():
                    created = self._job_created.get(job_key)
                    if created is not None:
                        self._m_job_activation.observe(
                            (rec.timestamp - created) / 1000.0)
        elif vt == ValueType.INCIDENT:
            from zeebe_tpu_torch.protocol.intent import IncidentIntent

            if intent == int(IncidentIntent.CREATED):
                self._m_pending_incidents.inc()
            elif intent == int(IncidentIntent.RESOLVED):
                self._m_pending_incidents.dec()
        elif vt == ValueType.MESSAGE:
            from zeebe_tpu_torch.protocol.intent import MessageIntent

            if intent == int(MessageIntent.PUBLISHED):
                self._m_buffered_messages.inc()
            elif intent == int(MessageIntent.EXPIRED):
                self._m_buffered_messages.dec()
        elif vt == ValueType.MESSAGE_BATCH:
            from zeebe_tpu_torch.protocol.intent import MessageBatchIntent

            if intent == int(MessageBatchIntent.EXPIRED):
                self._m_buffered_messages.dec(
                    len(rec.value.get("messageKeys", ()) or ()))


class ExporterContainer:
    def __init__(self, exporter_id: str, exporter: Exporter,
                 state: "ExportersState",
                 configuration: dict | None = None,
                 partition_id: int = 0,
                 on_health: Callable[[str, HealthStatus, str], None] | None = None) -> None:
        self.exporter_id = exporter_id
        self.exporter = exporter
        self.state = state
        self.position = state.position(exporter_id)
        # the cursor as RECOVERED from state at open, before any delivery —
        # test oracles use it to tell a legitimately-ahead recovered cursor
        # (stream not re-materialized yet) from an export past commit
        self.recovered_position = self.position
        # highest position handed to the exporter AND exported without error
        # but not yet acked; a skip may only advance the persisted position
        # when nothing is pending, or a crash-before-flush loses the buffered
        # records to compaction (reference:
        # ExporterContainer.updateLastExportedRecordPosition)
        self.last_delivered = self.position
        # per-container read cursor: restart resumes after the last ack
        # (at-least-once — unacked records are re-seen), and a backing-off
        # container catches up from here without stalling its siblings
        self.next_position = self.position + 1
        # retry-with-backoff state: consecutive failures and the millis
        # timestamp before which deliveries are suspended
        self.consecutive_failures = 0
        self.paused_until_ms: int | None = None
        self.last_error = ""
        self._on_health = on_health
        exporter.configure(ExporterContext(exporter_id, configuration or {}))
        exporter.open(ExporterController(
            self._update_position,  # (position, metadata): atomic persist
            on_metadata=lambda data: state.set_metadata(exporter_id, data),
            read_metadata=lambda: state.metadata(exporter_id),
        ))
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        # labeled per (exporter, partition): each child is incremented by
        # exactly one partition ownership thread, so the non-atomic
        # Counter.inc never races
        self._m_exported = REGISTRY.counter(
            "exporter_events_exported_total",
            "records handed to an exporter", ("exporter", "partition")
        ).labels(exporter_id, str(partition_id))
        self._m_failures = REGISTRY.counter(
            "exporter_failures_total",
            "export calls that raised", ("exporter", "partition")
        ).labels(exporter_id, str(partition_id))

    @property
    def paused(self) -> bool:
        return self.paused_until_ms is not None

    def maybe_resume(self, now_millis: int) -> None:
        """Open the retry window once the backoff expired; the failure count
        is kept so the NEXT failure backs off longer."""
        if self.paused_until_ms is not None and now_millis >= self.paused_until_ms:
            self.paused_until_ms = None

    def deliver(self, record, now_millis: int = 0) -> bool:
        """Hand one record to the exporter. On failure the position is pinned
        (``last_delivered``/``next_position`` stay put so the SAME record is
        retried), the container backs off exponentially, and health goes
        DEGRADED; returns False so the director moves on to the siblings."""
        try:
            self.exporter.export(record)
        except Exception as exc:  # noqa: BLE001 — exporter plugins are
            # third-party code; one bad sink must not poison the export loop
            self.consecutive_failures += 1
            backoff = min(
                INITIAL_BACKOFF_MS * (2 ** (self.consecutive_failures - 1)),
                MAX_BACKOFF_MS,
            )
            self.paused_until_ms = now_millis + backoff
            self.last_error = f"{type(exc).__name__}: {exc}"
            self._m_failures.inc()
            Loggers.exporter_logger(self.exporter_id).exception(
                "exporter %s failed on record %d (failure #%d) — backing off "
                "%d ms", self.exporter_id, record.position,
                self.consecutive_failures, backoff)
            self._report_health(
                HealthStatus.DEGRADED,
                f"retry #{self.consecutive_failures} in {backoff}ms after "
                f"{self.last_error}",
            )
            return False
        # the watermark advances ONLY after a successful export: a failed
        # export must not let skip() treat the record as pending-acked (the
        # stale watermark would corrupt the pending-ack accounting)
        self.last_delivered = record.position
        self.next_position = record.position + 1
        self._m_exported.inc()
        if self.consecutive_failures:
            self.consecutive_failures = 0
            self.last_error = ""
            self._report_health(HealthStatus.HEALTHY, "recovered")
        return True

    def skip(self, position: int) -> None:
        if self.last_delivered <= self.position:  # nothing unacked in flight
            self._update_position(position)
        self.last_delivered = max(self.last_delivered, position)
        self.next_position = max(self.next_position, position + 1)

    def _report_health(self, status: HealthStatus, message: str) -> None:
        if self._on_health is not None:
            self._on_health(self.exporter_id, status, message)

    def _update_position(self, position: int,
                         metadata: bytes | None = None) -> None:
        if position > self.position:
            self.position = position
            self.state.set_position_and_metadata(
                self.exporter_id, position, metadata)
        elif metadata is not None:
            self.state.set_metadata(self.exporter_id, metadata)


class ExportersState:
    """Exporter positions in the EXPORTER column family (reference:
    broker/…/exporter/stream/ExportersState.java)."""

    def __init__(self, db: ZbDb) -> None:
        self.db = db
        self._cf = db.column_family(CF.EXPORTER)

    def position(self, exporter_id: str) -> int:
        with self.db.transaction():
            return self._cf.get((exporter_id,)) or 0

    def set_position(self, exporter_id: str, position: int) -> None:
        with self.db.transaction():
            self._cf.put((exporter_id,), position)

    def set_position_and_metadata(self, exporter_id: str, position: int,
                                  metadata: bytes | None) -> None:
        """Both rows in ONE transaction: a crash must never persist advanced
        sequence counters without the position they were advanced for."""
        with self.db.transaction():
            self._cf.put((exporter_id,), position)
            if metadata is not None:
                self._cf.put(("__meta__", exporter_id), metadata)

    def metadata(self, exporter_id: str) -> bytes | None:
        with self.db.transaction():
            return self._cf.get(("__meta__", exporter_id))

    def set_metadata(self, exporter_id: str, data: bytes) -> None:
        with self.db.transaction():
            self._cf.put(("__meta__", exporter_id), data)

    def remove(self, exporter_id: str) -> None:
        with self.db.transaction():
            if self._cf.exists((exporter_id,)):
                self._cf.delete((exporter_id,))
            if self._cf.exists(("__meta__", exporter_id)):
                self._cf.delete(("__meta__", exporter_id))

    def lowest_position(self) -> int:
        with self.db.transaction():
            # metadata rows (key prefix "__meta__") share the CF; only the
            # single-part position keys carry int positions
            positions = [v for v in self._cf.values() if isinstance(v, int)]
        return min(positions) if positions else -1


class ExporterDirector:
    def __init__(self, stream: LogStream, db: ZbDb,
                 exporters: dict[str, "Exporter | tuple[Exporter, dict]"],
                 configurations: dict[str, dict] | None = None,
                 commit_position: Callable[[], int] | None = None,
                 clock_millis: Callable[[], int] | None = None,
                 on_health: Callable[[str, HealthStatus, str], None] | None = None) -> None:
        self.stream = stream
        self.state = ExportersState(db)
        self.clock_millis = clock_millis or (
            lambda: int(_time_mod.time() * 1000))
        # an entry may be (exporter, configuration) — the shape the
        # env-driven external-artifact loader produces (utils/external_code);
        # normalizing HERE keeps every construction site shape-agnostic
        configurations = dict(configurations or {})
        normalized: dict[str, Exporter] = {}
        for eid, entry in exporters.items():
            if isinstance(entry, tuple):
                normalized[eid], configurations[eid] = entry
            else:
                normalized[eid] = entry
        self.containers = [
            ExporterContainer(eid, exp, self.state,
                              configurations.get(eid),
                              partition_id=stream.partition_id,
                              on_health=on_health)
            for eid, exp in normalized.items()
        ]
        # committed-position supplier: records past it are not yet safe to
        # export (Raft quorum); None = everything in the log is committed
        self.commit_position = commit_position
        # director-level bookkeeping cursor (latency metrics observe each
        # record once); starts at the lowest acknowledged position — a
        # restarted exporter re-sees records after its last ack
        # (at-least-once)
        self._next_position = min(
            (c.position for c in self.containers), default=0
        ) + 1
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        pid = str(stream.partition_id)
        self._latency = ExecutionLatencyObserver(stream.partition_id)
        self._m_events = REGISTRY.counter(
            "exporter_events_total", "records visited by the director",
            ("partition",)).labels(pid)
        # exporter_last_exported_position is owned by the broker metrics
        # (node+partition labels) — not re-registered here
        self._m_last_updated = REGISTRY.gauge(
            "exporter_last_updated_exported_position",
            "lowest acknowledged exporter position", ("partition",)).labels(pid)
        # per-container lag (log end - acked position): the quantitative
        # face of a DEGRADED/backing-off exporter — a paused container's lag
        # grows on /metrics while its siblings' stays ~0
        lag = REGISTRY.gauge(
            "exporter_container_lag_records",
            "records between the log end and this exporter's acked position",
            ("exporter", "partition"))
        self._lag_children = {
            c.exporter_id: lag.labels(c.exporter_id, pid)
            for c in self.containers
        }
        from zeebe_tpu_torch.observability.tracer import get_tracer

        self._tracer = get_tracer()

    def _offer(self, container: "ExporterContainer", logged, now: int) -> None:
        """Hand one due record to a container (filter-skip or deliver; a
        failed delivery pauses the container and pins its cursor)."""
        if logged.position <= container.position:
            # already acked (restart resume): advance the cursor only
            container.next_position = logged.position + 1
            return
        ctx = container.exporter.context
        if ctx.record_filter is not None and not ctx.record_filter(logged):
            container.skip(logged.position)
            return
        tracer = self._tracer
        if not tracer.enabled:
            container.deliver(logged, now)
            return
        # sample FIRST: at low rates the common case must not pay the span
        # timing — only the trace-id resolution + one crc32
        pid = self.stream.partition_id
        fallback = (logged.source_position if logged.source_position >= 0
                    else logged.position)
        root = tracer.resolve_root(pid, logged.position, fallback)
        trace_id = f"{pid}:{root}"
        if not tracer.sampled(trace_id):
            container.deliver(logged, now)
            return
        t0 = _time_mod.perf_counter()
        ok = container.deliver(logged, now)
        dur = _time_mod.perf_counter() - t0
        # mark_exported dedupes re-delivery — export is at-least-once across
        # restarts, but the span stream must stay exactly-once; marked only
        # on SUCCESS so a retried failure still gets its span
        if ok and tracer.mark_exported(
                (container.exporter_id, pid, logged.position)):
            tracer.emit(trace_id, "exporter.export", dur, pid,
                        attrs={"position": logged.position,
                               "exporter": container.exporter_id})

    def export_available(self, max_records: int = 10_000) -> int:
        """Export committed records not yet seen; returns the work done this
        round (max of new records visited and per-container catch-up
        deliveries — a container draining backlog after backoff is work even
        when the director cursor is already at the head, or drain loops would
        stop pumping with backlog still pending). A failing exporter backs
        off alone while the rest advance. Steady state (all cursors at the
        head) is ONE reader pass; a lagging container (resumed from backoff
        or restart) gets its own bounded catch-up scan."""
        now = self.clock_millis()
        limit = self.commit_position() if self.commit_position else None
        for container in self.containers:
            container.maybe_resume(now)
        # catch-up: containers whose cursor fell behind the director cursor
        max_catch_up = 0
        for container in self.containers:
            if container.paused or container.next_position >= self._next_position:
                continue
            n = 0
            for logged in self.stream.new_reader(container.next_position):
                if logged.position >= self._next_position:
                    break  # reached the head: the shared pass takes over
                if limit is not None and logged.position > limit:
                    break
                self._offer(container, logged, now)
                if container.paused:
                    break
                n += 1
                if n >= max_records:
                    break
            max_catch_up = max(max_catch_up, n)
        # shared head pass: containers at (or beyond) the head when the pass
        # starts, plus the director-level bookkeeping (latency observation +
        # event count, once per record). Cursor comparisons are ranges, not
        # exact matches — materialized positions may gap where a position
        # range was consumed by a raft entry that never committed
        eligible = [c for c in self.containers
                    if not c.paused and c.next_position >= self._next_position]
        count = 0
        for logged in self.stream.new_reader(self._next_position):
            if limit is not None and logged.position > limit:
                break
            for container in eligible:
                if not container.paused and container.next_position <= logged.position:
                    self._offer(container, logged, now)
            self._latency.observe(logged)
            self._m_events.inc()
            self._next_position = logged.position + 1
            count += 1
            if count >= max_records:
                break
        if count or max_catch_up:
            self._m_last_updated.set(
                min((c.position for c in self.containers), default=-1))
        log_end = self.stream.last_position
        for container in self.containers:
            self._lag_children[container.exporter_id].set(
                log_end - container.position)
        return max(count, max_catch_up)

    def lowest_exporter_position(self) -> int:
        """Log compaction bound (reference: min exporter position vs snapshot
        position, AsyncSnapshotDirector). Uses the containers' in-memory
        positions (0 until first ack) so a bulk exporter that never flushed
        still pins the log."""
        if not self.containers:
            return 2**62
        return min(c.position for c in self.containers)

    def close(self) -> None:
        for container in self.containers:
            try:
                container.exporter.close()
            except Exception:  # noqa: BLE001 — one exporter's close failure
                # must not leak the remaining exporters' buffered flushes
                Loggers.exporter_logger(container.exporter_id).exception(
                    "exporter %s failed to close", container.exporter_id)
