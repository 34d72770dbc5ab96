"""Stream processor: replay → processing state machines over one partition's log.

Reference: stream-platform/src/main/java/io/camunda/zeebe/stream/impl/
StreamProcessor.java:77 (phases), ProcessingStateMachine.java:94 (command loop
documented at :55-93, batchProcessing :328-374), ReplayStateMachine.java:42
(REPLAY_FILTER: events only), StreamProcessorMode.java.

The command loop per step:
  read next unprocessed command → open txn → process (engine applies events to
  state as it appends them) → recursively process follow-up commands in the same
  txn up to ``max_commands_in_batch`` (marking them processed in the log) →
  append all follow-ups as one batch (source = command position) → record last
  processed position → commit → execute side effects (client responses).

Replay applies EVENT records only (processed-marked commands and rejections are
skipped) and tracks the last processed position from event source backlinks, so
a restarted or follower partition reaches state identical to the one that
processed the commands — the determinism contract the whole design rests on
(and what lets the TPU backend batch thousands of steps without changing
observable semantics).

Synchronous and pump-driven: callers (broker partition actor, tests, bench)
call ``run_until_idle``. The reference's actor pipeline exists to decouple
threads; one owner thread per partition gives the same single-writer guarantee.
"""

from __future__ import annotations

import enum
import logging
import os
from typing import Callable

from zeebe_tpu_torch.journal.journal import CorruptedJournalError
from zeebe_tpu_torch.logstreams import LogAppendEntry, LoggedRecord, LogStream
from zeebe_tpu_torch.observability.host_spans import clock_offset_us, drain_gc
from zeebe_tpu_torch.protocol import Record, RecordType, RejectionType, ValueType, rejection
from zeebe_tpu_torch.state.tiering import ColdCorruptionError

#: typed storage-corruption errors pass THROUGH the processor's
#: blanket failure containment: the partition pump catches them and runs
#: the matching repair (truncate/re-materialize/transition) — converting
#: them into FAILED phases or command rejections would bury a repairable
#: disk fault
# copied from the reference: _STORAGE_CORRUPTION .. StreamProcessorMode
_STORAGE_CORRUPTION = (CorruptedJournalError, ColdCorruptionError)
from zeebe_tpu_torch.state import ColumnFamilyCode, ZbDb
from zeebe_tpu_torch.stream.api import (
    ClientResponse,
    ExceededBatchRecordSizeError,
    ProcessingErrorHandling,
    ProcessingResultBuilder,
    ProcessingScheduleService,
    RecordProcessor,
    activatable_job_types,
)

from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent as _PI

# ELEMENT_* lifecycle intents → metric action label (reference:
# ProcessEngineMetrics.ExecutedInstanceAction)
_ELEMENT_ACTIONS = {
    int(_PI.ELEMENT_ACTIVATED): "activated",
    int(_PI.ELEMENT_COMPLETED): "completed",
    int(_PI.ELEMENT_TERMINATED): "terminated",
}

logger = logging.getLogger("zeebe_tpu_torch.stream")


class Phase(enum.Enum):
    INITIAL = "initial"
    REPLAY = "replay"
    PROCESSING = "processing"
    FAILED = "failed"


class StreamProcessorMode(enum.Enum):
    """PROCESSING: replay then process (leaders). REPLAY: replay continuously
    (followers) — reference: StreamProcessorMode.java:10-22."""

    PROCESSING = "processing"
    REPLAY = "replay"
# end of the copy


class StreamProcessor:
    """One partition's processing heart. Owns the db transaction lifecycle."""

    def __init__(
        self,
        log_stream: LogStream,
        db: ZbDb,
        processor: RecordProcessor,
        mode: StreamProcessorMode = StreamProcessorMode.PROCESSING,
        max_commands_in_batch: int = 100,
        response_sink: Callable[[ClientResponse], None] | None = None,
        clock_millis: Callable[[], int] | None = None,
        writer=None,
        kernel_backend=None,
    ) -> None:
        self.log_stream = log_stream
        self.db = db
        self.processor = processor
        self.mode = mode
        # pluggable write path: the broker passes a Raft-appending writer so
        # follow-ups/scheduled commands replicate before becoming readable
        # (reference: Sequencer → LogStorageAppender → AtomixLogStorage → Raft)
        self.writer = writer if writer is not None else log_stream.writer
        self.max_commands_in_batch = max_commands_in_batch
        # optional batched device execution (engine/kernel_backend.py): groups
        # of eligible commands ride the automaton kernel instead of the
        # per-command sequential path; everything else falls through unchanged
        self.kernel_backend = kernel_backend
        if kernel_backend is not None:
            # single source of truth: the backend's host-escape drain must
            # account commands against the SAME budget as _batch_process, or
            # the flattened bursts' processed flags diverge from sequential
            kernel_backend.max_commands_in_batch = max_commands_in_batch
        self.response_sink = response_sink or (lambda response: None)
        # post-commit jobs-available notification (reference: the engine's
        # jobsAvailable callback → gateway long-poll wakeup / job push);
        # receives the set of job types a committed step made activatable
        self.on_jobs_available: Callable[[set], None] | None = None
        self.phase = Phase.INITIAL
        self._positions = db.column_family(ColumnFamilyCode.LAST_PROCESSED_POSITION)
        # replicated request dedupe: materialized here on BOTH the
        # processing and replay paths from the same logged evidence, so the
        # family replays to byte-identical state (chaos parity oracle) and a
        # promoted follower / restarted leader inherits every request's fate
        from collections import OrderedDict as _OrderedDict

        from zeebe_tpu_torch.state.request_dedupe import RequestDedupeState

        self._dedupe = RequestDedupeState(db)
        # position → (stream id, request id) of request-carrying commands
        # seen during replay, awaiting their processing evidence (the
        # follow-up batch with that source); bounded — an evicted entry just
        # skips one awaiting note for a request that never got processed
        self._replay_pending: _OrderedDict[int, tuple[int, int]] = _OrderedDict()
        # hot-path metrics, children pre-resolved (reference names:
        # stream-platform impl/metrics/StreamProcessorMetrics —
        # zeebe_stream_processor_records_total, processing latency)
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        partition_label = str(log_stream.partition_id)
        records_total = REGISTRY.counter(
            "stream_processor_records_total",
            "records handled by the stream processor",
            ("partition", "action"))
        self._m_processed = records_total.labels(partition_label, "processed")
        self._m_replayed = records_total.labels(partition_label, "replayed")
        self._m_batched = records_total.labels(partition_label, "kernel_batched")
        self._m_latency = REGISTRY.histogram(
            "stream_processor_latency",
            "seconds spent processing one command (or one kernel group)",
            ("partition",)).labels(partition_label)
        # engine activity counters, observed PROCESSING-side from the step's
        # follow-up events — never during replay, so counts are not inflated
        # by followers or restart recovery (reference: engine/metrics/
        # ProcessEngineMetrics, JobMetrics, IncidentMetrics count in
        # processors, not appliers). Kernel burst hits are counted coarsely
        # via action=kernel_batched instead.
        instances = REGISTRY.counter(
            "executed_instances_total",
            "root process instances by lifecycle action",
            ("partition", "action"))
        jobs = REGISTRY.counter(
            "job_events_total", "job lifecycle events written",
            ("partition", "action"))
        incidents = REGISTRY.counter(
            "incident_events_total", "incident events written",
            ("partition", "action"))
        from zeebe_tpu_torch.protocol.intent import (
            IncidentIntent,
            JobIntent,
            ProcessInstanceIntent,
        )

        self._m_pi_actions = {
            int(ProcessInstanceIntent.ELEMENT_ACTIVATED):
                instances.labels(partition_label, "activated"),
            int(ProcessInstanceIntent.ELEMENT_COMPLETED):
                instances.labels(partition_label, "completed"),
            int(ProcessInstanceIntent.ELEMENT_TERMINATED):
                instances.labels(partition_label, "terminated"),
        }
        self._m_job_actions = {
            int(JobIntent.CREATED): jobs.labels(partition_label, "created"),
            int(JobIntent.COMPLETED): jobs.labels(partition_label, "completed"),
            int(JobIntent.FAILED): jobs.labels(partition_label, "failed"),
            int(JobIntent.TIMED_OUT): jobs.labels(partition_label, "timed_out"),
            int(JobIntent.CANCELED): jobs.labels(partition_label, "canceled"),
            int(JobIntent.ERROR_THROWN): jobs.labels(partition_label, "error_thrown"),
        }
        # element transitions by BPMN element type (reference:
        # ProcessEngineMetrics zeebe_element_instance_events_total)
        self._m_element_events = REGISTRY.counter(
            "element_instance_events_total",
            "element instance lifecycle events by element type",
            ("partition", "action", "type"))
        self._m_element_children: dict = {}
        self._m_incident_actions = {
            int(IncidentIntent.CREATED): incidents.labels(partition_label, "created"),
            int(IncidentIntent.RESOLVED): incidents.labels(partition_label, "resolved"),
        }
        self._m_batch_commands = REGISTRY.histogram(
            "stream_processor_batch_processing_commands",
            "commands processed in one batch/group", ("partition",),
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 512, 2048),
        ).labels(partition_label)
        self._m_batch_duration = REGISTRY.histogram(
            "stream_processor_batch_processing_duration",
            "seconds per processed batch/group", ("partition",)
        ).labels(partition_label)
        self._m_processing_duration = REGISTRY.histogram(
            "stream_processor_processing_duration",
            "seconds per processed command incl. write+commit",
            ("partition",)).labels(partition_label)
        self._m_post_commit = REGISTRY.histogram(
            "stream_processor_batch_processing_post_commit_tasks",
            "post-commit side effects per step", ("partition",),
            buckets=(0, 1, 2, 4, 8, 16, 64),
        ).labels(partition_label)
        self._m_batch_retry = REGISTRY.counter(
            "stream_processor_batch_processing_retry",
            "batches retried after an error rollback", ("partition",)
        ).labels(partition_label)
        # stream_processor_last_processed_position is owned by the broker
        # metrics (node+partition labels); here we only keep a no-label twin
        # out of the registry to avoid a label-shape collision
        self._m_recovery_time = REGISTRY.gauge(
            "stream_processor_startup_recovery_time",
            "seconds spent in startup replay recovery", ("partition",)
        ).labels(partition_label)
        self._m_replay_duration = REGISTRY.histogram(
            "replay_event_batch_replay_duration",
            "seconds per replayed event batch", ("partition",)
        ).labels(partition_label)
        self._m_replay_events = REGISTRY.counter(
            "replay_events_total", "events applied during replay",
            ("partition",)).labels(partition_label)
        self._m_replay_last_source = REGISTRY.gauge(
            "replay_last_source_position",
            "source position of the last replayed batch", ("partition",)
        ).labels(partition_label)
        # pipelined-batch stage histograms: the before/after breakdown of the
        # host-path gap (decode/admission, device run, burst materialization,
        # log append, group-commit flush, deferred side effects) — children
        # pre-resolved, the group loop is hot
        self._m_pipeline = {
            stage: REGISTRY.histogram(
                f"stream_processor_pipeline_{stage}",
                f"seconds per kernel group in the {stage} stage of the "
                "pipelined batch-execution path",
                ("partition",)).labels(partition_label)
            for stage in ("decode", "device", "materialize", "append",
                          "flush", "side_effects")
        }
        # dispatch-overlap receipt: fraction of a kernel group's
        # wall time during which the host did useful work (the previous
        # group's deferred side effects) while a dispatched device chunk was
        # in flight — the begin_group/finish_group double-buffer seam's
        # before/after number for the ROADMAP item 2 async work. EMA'd so
        # the gauge reads as a recent-history ratio, not one group's jitter.
        self._m_overlap = REGISTRY.gauge(
            "kernel_dispatch_overlap_ratio",
            "EMA of host-work-overlapping-device-dispatch time / kernel "
            "group wall time (begin_group..finish_group seam)",
            ("partition",)).labels(partition_label)
        self._overlap_ema: float | None = None
        # cross-wave double-buffered dispatch: wave k+1 is
        # admitted and its first device chunk dispatched inside wave k's
        # transaction, right after wave k materialized — the chunk computes
        # under wave k's entire host tail (append, dedupe notes, commit,
        # group-commit fsync, deferred effects) instead of starting cold at
        # the next round. The stash is (pending_group, expected_reader_pos,
        # state_epoch, dispatch_stamp); the next round consumes it only if
        # nothing invalidated the admission snapshot in between.
        self._spec_group: tuple | None = None
        # traced: the stashed group's admission start (0.0 untraced), taken
        # with the stash
        self._spec_begun_at = 0.0
        # bumped by anything that mutates engine state outside the group
        # pipeline itself (a post-commit task with its own transaction);
        # sequential commands are covered by the reader-position check
        self._state_epoch = 0
        self._speculation_enabled = os.environ.get(
            "ZEEBE_BROKER_PIPELINE_SPECULATION", "1"
        ).lower() not in ("0", "false", "off")
        self._m_spec = {
            outcome: REGISTRY.counter(
                "kernel_speculative_groups",
                "cross-wave speculative dispatches by outcome: consumed = "
                "committed by the next pump round; discarded = invalidated "
                "before consumption (interleaved sequential command, "
                "state-mutating post-commit task, quarantine latched, or "
                "the speculating round rolled back)",
                ("partition", "outcome")).labels(partition_label, outcome)
            for outcome in ("consumed", "discarded")
        }
        # bounded kernel_wave flight events: per-wave stats aggregate here
        # and flush through wave_listener (set by the broker partition →
        # flight recorder) at most once per second — the ring stays
        # reviewable and the hot loop never records per group
        self.wave_listener: Callable[[dict], None] | None = None
        self._wave_agg = {"waves": 0, "commands": 0, "chunks": 0,
                          "maxWave": 0}
        self._wave_marks: tuple[int, int, dict] = (0, 0, {})
        self._wave_last_emit = 0.0
        # tracing: spans are minted ONLY on the PROCESSING-phase paths below —
        # replay_available has no tracing hooks, so crash-restart replay is
        # structurally unable to emit (duplicate) spans. The singleton is
        # mutated in place by configure_tracing; caching it here is safe.
        from zeebe_tpu_torch.observability.tracer import get_tracer

        self._tracer = get_tracer()
        # ack-release hook: the broker partition wires this to its
        # LatencyObservatory — called as (trace_id, latency_s) at the moment
        # a command's reply is released, only while tracing is enabled
        self.on_ack: Callable[[str, float], None] | None = None
        clock = clock_millis or log_stream.clock_millis
        self.schedule_service = ProcessingScheduleService(clock, self._write_scheduled_commands)
        self._reader_position = 1
        self._scan_hint = -1  # batch-slot cursor for the sequential scans
        self.last_processed_position = -1
        self.last_written_position = -1
        # plain int lifetime counter (metrics children are shared across
        # partition transitions): the partition's recovery accounting reads
        # it right after start() to learn this recovery's replay length
        self.replayed_records = 0
        # double-buffered pipeline state: each processed group's post-commit
        # side effects (client responses, jobs-available notifications) are
        # deferred and run while the NEXT group's device chunk computes.
        # Entries are (last_written_position, builders, ack_notes); with a
        # journal flush_interval configured they additionally wait for the
        # covering group-commit fsync before acking (no-acked-command-lost
        # invariant). ack_notes (tracing only) are the commands' append→ack
        # stamps, resolved at RELEASE time — so the processor-scope
        # command_ack_latency observation and the ack/fsync-wait spans fire
        # when the reply actually goes out, never for a prefix whose
        # covering fsync failed and was rewound.
        self._deferred_effects: list[tuple[int, list, list | None]] = []
        self._acked_position = -1
        # acks gated on the covering group-commit fsync: only meaningful when
        # this processor appends to the local stream journal AND that journal
        # has a flush cadence configured (broker partitions pass a Raft
        # writer — durability is raft's ack barrier there, never gated here)
        self._ack_gated = (
            self.writer is log_stream.writer
            and getattr(log_stream.journal, "flush_interval", None) is not None
        )
        # async ack path: gated replies release from the journal's
        # flush callback — EVERY covering fsync (the pump-tail cadence check,
        # the idle-boundary flush, an external barrier) frees the replies it
        # covers the moment durability is real, instead of the pump polling
        # for it at the next group tail. The reentrancy latch stops the drain
        # from re-entering itself when a post-commit task (or the drain's own
        # forced flush) triggers another fsync mid-drain.
        self._in_flush_ack = False
        if self._ack_gated:
            log_stream.journal.flush_listeners.append(self._on_journal_flush)

    # -- bookkeeping ---------------------------------------------------------

    # copied from the reference: _load_last_processed .. _iter_candidate_commands
    def _load_last_processed(self) -> int:
        with self.db.transaction():
            pos = self._positions.get(("last",))
        return pos if pos is not None else -1

    def _store_last_processed(self, position: int) -> None:
        # caller must hold the open processing transaction
        self._positions.put(("last",), position)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Recover: replay from the last processed position, then (in
        PROCESSING mode) become ready to process commands."""
        import time as _time

        recovery_start = _time.perf_counter()
        self.phase = Phase.REPLAY
        self.last_processed_position = self._load_last_processed()
        self._reader_position = 1 if self.last_processed_position < 0 else self.last_processed_position + 1
        self.replay_available()
        self._m_recovery_time.set(_time.perf_counter() - recovery_start)
        if self.phase == Phase.FAILED:
            # a poison record during recovery replay FAILED the processor;
            # becoming a leader over half-replayed state would silently
            # reprocess logged commands and duplicate their events
            return
        if self.mode == StreamProcessorMode.PROCESSING:
            self.phase = Phase.PROCESSING
            # processing scans from the start of the unreplayed suffix
            self._reader_position = (
                1 if self.last_processed_position < 0 else self.last_processed_position + 1
            )

    # -- replay --------------------------------------------------------------

    def replay_available(self) -> int:
        """Apply committed events not yet reflected in state. Returns number of
        events applied. In REPLAY mode this is the follower's steady state.

        A throwing applier (poison record, applier bug) FAILS this processor —
        replay stops, the partition reports unhealthy — instead of propagating
        into the broker pump and taking every co-hosted partition down with it
        (reference: StreamProcessor onFailure → Phase.FAILED + health DEAD)."""
        import time as _time

        if self.phase == Phase.FAILED:
            return 0
        applied = 0
        position = self._reader_position
        while True:
            logged = self.log_stream.read_at_or_after(position)
            if logged is None:
                break
            batch = self.log_stream.read_batch_containing(logged.position)
            batch_start = _time.perf_counter()
            try:
                with self.db.transaction():
                    max_source = -1
                    batch_applied = 0
                    for rec in batch:
                        if rec.position < position:
                            continue
                        # Skip events already reflected in state: their
                        # producing command's position (source backlink) is <=
                        # the recovered last-processed position. This is what
                        # makes snapshot + replay idempotent (reference:
                        # ReplayStateMachine skips up to the snapshot's
                        # processed position).
                        if rec.source_position > self.last_processed_position:
                            if rec.record.is_event:
                                self.processor.replay(rec)
                                batch_applied += 1
                                if rec.source_position > max_source:
                                    max_source = rec.source_position
                            elif rec.record.is_rejection:
                                # a rejection-only step still marks its command
                                # processed, else restart reprocesses it and
                                # duplicates the rejection + client response
                                if rec.source_position > max_source:
                                    max_source = rec.source_position
                    self._note_replay_dedupe(batch, position)
                    if max_source > self.last_processed_position:
                        self.last_processed_position = max_source
                        self._store_last_processed(max_source)
                applied += batch_applied
            except _STORAGE_CORRUPTION:
                raise  # repairable disk fault: the pump's repair seam owns it
            except Exception:  # noqa: BLE001 — the transaction rolled back
                # (the failed batch's events count for nothing); retrying the
                # same batch would throw forever
                self.phase = Phase.FAILED
                logger.exception(
                    "replay failed in batch at position %d; partition marked "
                    "unhealthy (restart or failover to recover)", position)
                return applied
            self._m_replay_duration.observe(_time.perf_counter() - batch_start)
            if max_source >= 0:
                self._m_replay_last_source.set(max_source)
            position = batch[-1].position + 1
        self._reader_position = position
        if applied:
            self.replayed_records += applied
            self._m_replayed.inc(applied)
            self._m_replay_events.inc(applied)
        return applied

    # -- replicated request dedupe ---------------------------------
    #
    # One materialization rule, two observation points with identical final
    # state: the live paths note from the step's own builder/burst (whose
    # records become the logged batch verbatim), replay notes from the
    # logged batch. A processed command carrying a request id gets an
    # awaiting entry; every response-stamped EVENT/REJECTION frame
    # overwrites it with the stored reply; entries age out by log position.

    def _note_replay_dedupe(self, batch, resume_position: int) -> None:
        src = batch[0].source_position
        evidence = src >= 0 and src > self.last_processed_position
        noted = False
        reply_keys = None
        for rec in batch:
            if rec.position < resume_position:
                continue
            record = rec.record
            request_id = record.request_id
            if request_id < 0:
                continue
            if record.is_command:
                if not rec.processed:
                    # a client command awaiting its processing evidence (the
                    # later batch whose source backlink names this position)
                    self._replay_pending[rec.position] = (
                        record.request_stream_id, request_id)
                    while len(self._replay_pending) > 65536:
                        self._replay_pending.popitem(last=False)
                continue
            if evidence:
                self._dedupe.note_reply(src, record)
                noted = True
                if reply_keys is None:
                    reply_keys = set()
                reply_keys.add((record.request_stream_id, request_id))
        if not evidence:
            return
        pending = self._replay_pending.pop(src, None)
        if pending is not None and (reply_keys is None
                                    or pending not in reply_keys):
            # processed but not (yet) answered — await-result parks the
            # reply for a later step; live wrote the same awaiting entry at
            # processing time (its own reply, when present in this batch,
            # overwrote it there too)
            self._dedupe.note_awaiting(src, *pending)
            noted = True
        if noted:
            self._dedupe.age_out(src)

    def _note_live_dedupe(self, cmd: LoggedRecord, follow_ups) -> None:
        """Inside the step transaction, after the follow-ups are final."""
        record = cmd.record
        noted = False
        if record.request_id >= 0:
            self._dedupe.note_awaiting(cmd.position, record.request_stream_id,
                                       record.request_id)
            noted = True
        for f in follow_ups:
            fr = f.record
            if fr.request_id >= 0 and not fr.is_command:
                self._dedupe.note_reply(cmd.position, fr)
                noted = True
        if noted:
            self._dedupe.age_out(cmd.position)

    def _note_burst_dedupe(self, cmd: LoggedRecord, burst) -> None:
        """Burst fast path: the template's instantiated responses are the
        request-carrying follow-ups (build_template falls back to the slow
        path otherwise — the parity guard), so noting them here matches
        what replay derives from the patched frames."""
        record = cmd.record
        noted = False
        if record.request_id >= 0:
            self._dedupe.note_awaiting(cmd.position, record.request_stream_id,
                                       record.request_id)
            noted = True
        for _extra, resp, _stream_id, _request_id in burst.responses:
            if resp.request_id >= 0 and not resp.is_command:
                self._dedupe.note_reply(cmd.position, resp)
                noted = True
        if noted:
            self._dedupe.age_out(cmd.position)

    # -- processing ----------------------------------------------------------

    def _next_command(self) -> LoggedRecord | None:
        position = self._reader_position
        while True:
            logged, self._scan_hint, scanned = self.log_stream.next_command_with_hint(
                position, self._scan_hint
            )
            if logged is None:
                # safe to resume after batches the scan proved command-free
                self._reader_position = max(position, scanned)
                return None
            if logged.record.is_command and not logged.processed:
                self._reader_position = logged.position + 1
                return logged
            position = logged.position + 1

    def _iter_candidate_commands(self, start: int | None = None,
                                 note_head: bool = True):
        """Lazily yield pending commands in log order, stopping at the first
        the kernel backend cannot be a candidate for. Does not consume.

        Batched scan: after the hinted lookup finds a record, the rest of
        its decoded sequenced batch is walked inline — a wave-sized ingress
        batch (thousands of commands in one append) costs one slot lookup,
        not one ``next_command_with_hint`` round-trip per record.

        ``start``/``note_head``: the speculative cross-wave scan reads from
        an explicit position (the just-finished wave's end, before
        ``_reader_position`` advances) and must NOT note a sequential head —
        a discarded speculation would otherwise double-count the head when
        the next round's authoritative scan re-encounters it."""
        position = self._reader_position if start is None else start
        first = note_head
        is_candidate = self.kernel_backend.is_candidate
        while True:
            logged, self._scan_hint, _ = self.log_stream.next_command_with_hint(
                position, self._scan_hint
            )
            if logged is None:
                return
            batch = self.log_stream.read_batch_containing(logged.position)
            start = logged.position - batch[0].position if batch else -1
            if not (0 <= start < len(batch)
                    and batch[start].position == logged.position):
                batch, start = (logged,), 0  # defensive: non-contiguous batch
            for i in range(start, len(batch)):
                logged = batch[i]
                position = logged.position + 1
                if not (logged.record.is_command and not logged.processed):
                    continue
                if not is_candidate(logged.record):
                    if first:
                        # precise fallback accounting: a sequential HEAD is
                        # named by kind; an empty scan (end of log) counts
                        # nothing
                        self.kernel_backend.note_sequential_head(logged.record)
                    return
                first = False
                yield logged
    # end of the copy

    def process_available_batch(self) -> int:
        """Process a group of kernel-eligible commands in one device run and
        one transaction; returns commands consumed (0 → sequential path).

        Pipelined: the group's first device chunk is dispatched
        asynchronously (KernelBackend.begin_group), the PREVIOUS group's
        deferred post-commit side effects run in that window, and only then
        does the host block on the device (finish_group). This group's own
        side effects are deferred in turn, so device and host work run
        concurrently instead of in strict alternation."""
        if self.kernel_backend is None or self.phase != Phase.PROCESSING:
            return 0
        import time as _time

        group_start = _time.perf_counter()
        # the enabled flag once, for the whole group: its spans' stamps are
        # taken only when it is set
        traced = self._tracer.enabled
        from zeebe_tpu_torch.engine.burst_templates import PreparedBurst

        pipeline = self._m_pipeline
        cmds: list[LoggedRecord] = []
        builders: list[ProcessingResultBuilder] = []
        pending = None
        write_failed = False
        # cross-wave double buffering: pop any group speculated by the
        # PREVIOUS round — popped unconditionally so a group that fails
        # validation (or a round that fails outright) can never be consumed
        # against state its admission snapshot no longer matches
        spec, self._spec_group = self._spec_group, None
        spec_begun, self._spec_begun_at = self._spec_begun_at, 0.0
        spec_next = None
        spec_dispatched_at = 0.0
        # traced: begin_group's start and return (a consumed speculation's
        # in the round that dispatched it)
        begun_at = begin_end = 0.0
        # out-of-transaction drain point: deferred groups carrying post-commit
        # tasks (skipped by the in-transaction overlap drain below) go out here
        self._run_deferred_effects()
        overlap = 0.0
        try:
            with self.db.transaction():
                if spec is not None:
                    pg, expected_pos, epoch, t_disp = spec
                    if (expected_pos == self._reader_position
                            and epoch == self._state_epoch
                            and not self.kernel_backend.health.is_quarantined()):
                        # the admission snapshot still holds: the speculating
                        # round committed the exact state this transaction
                        # opened over, nothing processed or mutated since
                        pending = pg
                        spec_dispatched_at = t_disp
                        begun_at, begin_end = spec_begun, t_disp
                        self._m_spec["consumed"].inc()
                    else:
                        self._m_spec["discarded"].inc()
                        # exactly-once span contract:
                        # the ONLY span a discarded speculation ever emits is
                        # this off-path marker — outcome="discarded" keeps it
                        # out of critical-path attribution, and the next
                        # round's authoritative re-scan of the same wave owns
                        # every kernel_group/kernel_command emission
                        if self._tracer.enabled:
                            self._trace_speculative(expected_pos, t_disp,
                                                    "discarded")
                if pending is None:
                    if traced:
                        begun_at = _time.perf_counter()
                    pending = self.kernel_backend.begin_group(
                        self._iter_candidate_commands())
                    if traced:
                        begin_end = _time.perf_counter()
                # traced: the first chunk's dispatch time, before the fetch
                # adds to it
                dispatched = (pending.device_elapsed
                              if traced and pending is not None else 0.0)
                # the device is computing the first chunk: run the previous
                # group's deferred host work in the gap — the overlap window
                # the dispatch-overlap gauge measures
                t_overlap = _time.perf_counter()
                self._run_deferred_effects()
                overlap = _time.perf_counter() - t_overlap
                cmds, builders = self.kernel_backend.finish_group(
                    pending, ProcessingResultBuilder)
                finished_at = _time.perf_counter() if traced else 0.0
                if not cmds:
                    return 0
                # speculate wave k+1 BEFORE this wave's host tail: state is
                # materialized (the overlay this transaction will commit), so
                # admission is exact, and the dispatched chunk computes under
                # the append/commit/fsync work below. Stays local until the
                # commit succeeds — a rollback discards it with the overlay.
                if self._speculation_enabled:
                    spec_begun = _time.perf_counter() if traced else 0.0
                    spec_next = self._maybe_speculate(cmds[-1].position + 1)
                t_append = _time.perf_counter()
                try:
                    for cmd, result in zip(cmds, builders):
                        if isinstance(result, PreparedBurst):
                            if result.count:
                                self.last_written_position = self.writer.append_prepatched(
                                    result.buf, result.pos_offsets,
                                    result.ts_offsets, result.count,
                                    has_pending_commands=result.has_pending_commands,
                                )
                            continue
                        entries = [
                            LogAppendEntry(f.record, f.processed) for f in result.follow_ups
                        ]
                        if entries:
                            self.last_written_position = self.writer.try_write(
                                entries, source_position=cmd.position
                            )
                except Exception:
                    write_failed = True
                    raise
                self.last_processed_position = cmds[-1].position
                self._store_last_processed(self.last_processed_position)
                for cmd, result in zip(cmds, builders):
                    if isinstance(result, PreparedBurst):
                        if result.count:
                            self._note_burst_dedupe(cmd, result)
                    else:
                        self._note_live_dedupe(cmd, result.follow_ups)
                append_dur = _time.perf_counter() - t_append
                pipeline["append"].observe(append_dur)
        except _STORAGE_CORRUPTION:
            raise  # repairable disk fault: the pump's repair seam owns it
        except Exception:  # noqa: BLE001 — the fallback/rollback seam
            if write_failed:
                # a partial group append is already in the log; reprocessing
                # in-process would duplicate those records. Fail the partition
                # — restart replays the log, re-derives last-processed from
                # event source backlinks, and resumes exactly after the
                # partially-written commands (the reference treats appender
                # failures as partition-fatal the same way).
                self.phase = Phase.FAILED
                raise
            logger.exception("kernel group processing failed; falling back to sequential")
            # consolidated path accounting: the head retries sequentially,
            # so this IS one host-routed record with a runtime-only reason
            self.kernel_backend.fallbacks += 1
            self.kernel_backend.accounting.note_host("group-error")
            return 0
        self._reader_position = cmds[-1].position + 1
        # the commit succeeded: the speculative admission's state snapshot is
        # now THE committed state — promote the stash for the next round
        self._spec_group = spec_next
        self._spec_begun_at = spec_begun if spec_next is not None else 0.0
        # kernel-path accounting AFTER the commit: a rolled-back group that
        # re-admits next pump must not count twice (coverage/parity ruler)
        self.kernel_backend.note_group_success(pending)
        # defer this group's post-commit side effects: they run while the
        # NEXT group's device chunk computes (or at the next sequential
        # command / idle boundary, whichever comes first). Ack notes are
        # taken HERE (commit time) because the flush below may drain the
        # entry synchronously — gated notes must already ride it.
        notes = self._take_ack_notes(cmds) if traced else None
        self._deferred_effects.append(
            (self.last_written_position, builders,
             notes if self._ack_gated else None))
        t_flush = _time.perf_counter()
        self._group_commit_point()
        flush_dur = _time.perf_counter() - t_flush
        pipeline["flush"].observe(flush_dur)
        pipeline["decode"].observe(pending.t_admit)
        pipeline["device"].observe(pending.device_elapsed)
        pipeline["materialize"].observe(pending.t_materialize)
        self._m_batched.inc(len(cmds))
        group_end = _time.perf_counter()
        elapsed = group_end - group_start
        self._m_latency.observe(elapsed)
        self._m_batch_commands.observe(len(cmds))
        self._m_batch_duration.observe(elapsed)
        # overlap receipt: for a consumed speculation, the group's device
        # work really started at the PREVIOUS round's dispatch stamp, and the
        # window from there to this round's start was all host work (the
        # speculating wave's append, dedupe notes, commit, fsync, deferred
        # effects) done while the chunk was in flight — count it as overlap
        # and widen the denominator by the same amount so the ratio stays an
        # honest fraction of this group's true wall span
        if spec_dispatched_at:
            pre = max(0.0, group_start - spec_dispatched_at)
            overlap += pre
            elapsed += pre
        self._observe_wave(pending, len(cmds), overlap, elapsed)
        if traced:
            if spec_dispatched_at:
                self._trace_speculative(cmds[0].position, spec_dispatched_at,
                                        "consumed")
            stages = [
                ("device", t_overlap + overlap, pending.device_elapsed - dispatched),
                ("materialize", finished_at - pending.t_materialize, pending.t_materialize),
                ("append", t_append, append_dur),
                ("flush", t_flush, flush_dur),
            ]
            if begun_at:  # 0.0: a speculation dispatched while tracing was off
                stages[:0] = [("decode", begun_at, pending.t_admit),
                              ("dispatch", begin_end - dispatched, dispatched)]
            self._trace_group(cmds, elapsed, (min(begun_at or group_start, group_start),
                                              group_end), stages, overlap, notes)
        return len(cmds)

    # copied from the reference: _trace_speculative .. _release_acks
    def _trace_speculative(self, first_pos: int, t_disp: float,
                           outcome: str) -> None:
        """One span per speculative dispatch, emitted exactly once at
        outcome resolution on the wave's group trace. ``outcome="discarded"``
        marks it off the critical path (the extractor skips it);
        ``"consumed"`` measures how early the next wave's chunk launched."""
        import time as _time

        tracer = self._tracer
        pid = self.log_stream.partition_id
        group_trace = f"{pid}:g{first_pos}"
        # Group spans bypass head sampling: one per wave, and they are the
        # substitution substrate for EVERY sampled command's attribution —
        # a sampled command whose wave wasn't sampled would be unattributable.
        if tracer.enabled:
            tracer.emit(group_trace, "processor.speculative",
                        _time.perf_counter() - t_disp, pid,
                        attrs={"speculative": True, "outcome": outcome})

    def _maybe_speculate(self, start_pos: int) -> tuple | None:
        """Admit wave k+1 and dispatch its first device chunk while still
        inside wave k's transaction (cross-wave double buffering,.

        Runs strictly after wave k materialized, so the overlay this
        admission reads is exactly the state wave k is about to commit; the
        scan starts at wave k's end position and cannot see wave k's
        follow-up appends (not yet written — they land at higher positions
        and are picked up by later scans in order). Declines silently
        (``speculative=True``) and never notes a sequential head: if the
        stash is discarded, the next round's authoritative scan owns all
        accounting. Returns (group, expected_reader_pos, state_epoch,
        dispatch_stamp) or None."""
        import time as _time

        pg = self.kernel_backend.begin_group(
            self._iter_candidate_commands(start=start_pos, note_head=False),
            speculative=True,
        )
        if pg is None:
            return None
        return (pg, start_pos, self._state_epoch, _time.perf_counter())

    def _observe_wave(self, pending, commands: int, overlap: float,
                      elapsed: float) -> None:
        """Per-wave path accounting: the dispatch-overlap gauge
        and the bounded ``kernel_wave`` flight events (wave size, chunk
        count, kernel/host path split since the last event, dominant
        fallback reason), flushed through ``wave_listener`` at most once
        per second."""
        import time as _time

        if elapsed > 0:
            ratio = min(1.0, overlap / elapsed)
            ema = self._overlap_ema
            self._overlap_ema = ratio if ema is None else ema + 0.2 * (ratio - ema)
            self._m_overlap.set(round(self._overlap_ema, 4))
        agg = self._wave_agg
        agg["waves"] += 1
        agg["commands"] += commands
        agg["chunks"] += pending.chunks_run
        if commands > agg["maxWave"]:
            agg["maxWave"] = commands
        if self.wave_listener is None:
            return
        now = _time.perf_counter()
        if now - self._wave_last_emit < 1.0 and self._wave_last_emit:
            return
        self._wave_last_emit = now
        acct = self.kernel_backend.accounting
        k_mark, h_mark, reasons_mark = self._wave_marks
        delta_reasons = {
            r: c - reasons_mark.get(r, 0)
            for r, c in acct.reasons.items() if c > reasons_mark.get(r, 0)
        }
        dominant = max(delta_reasons, key=delta_reasons.get, default=None)
        d_kernel = acct.kernel_records - k_mark
        d_host = acct.host_records - h_mark
        health = self.kernel_backend.health
        event = {
            "waves": agg["waves"],
            "commands": agg["commands"],
            "avgWave": round(agg["commands"] / max(1, agg["waves"]), 1),
            "maxWave": agg["maxWave"],
            "chunks": agg["chunks"],
            "kernelRecords": d_kernel,
            "hostRecords": d_host,
            # the EVENT's window, consistent with its own delta counters
            # (the cumulative ratio lives on /health and the gauge)
            "coverageRatio": round(d_kernel / max(1, d_kernel + d_host), 4),
            "overlapRatio": round(self._overlap_ema or 0.0, 4),
            **({"dominantFallback": dominant} if dominant else {}),
            # device-fault defense: the wave event carries the
            # ladder state + shadow counters, so a quarantine explains its
            # own coverage drop right in the flight ring
            "deviceHealth": health.state,
            "shadowChecks": health.shadow_checks,
            "shadowMismatches": health.shadow_mismatches,
        }
        self._wave_marks = (acct.kernel_records, acct.host_records,
                            dict(acct.reasons))
        self._wave_agg = {"waves": 0, "commands": 0, "chunks": 0,
                          "maxWave": 0}
        try:
            self.wave_listener(event)
        except Exception:  # noqa: BLE001 — telemetry must not wedge the pump
            logger.exception("kernel_wave listener failed")

    def _take_ack_notes(self, cmds) -> list[tuple]:
        """Consume the commands' append stamps at COMMIT time into ack
        notes ``(trace_id, position, t_append, t_commit)``. Notes are
        resolved by :meth:`_release_acks` when the reply actually releases
        — immediately when ungated, at the covering-fsync drain when gated
        — so a failed flush (rewound prefix) can never feed the ack
        histogram or emit an ack span for a reply that never went out."""
        import time as _time

        tracer = self._tracer
        pid = self.log_stream.partition_id
        t_commit = _time.perf_counter()
        notes = []
        for cmd in cmds:
            t_append = tracer.take_append(pid, cmd.position)
            fallback = (cmd.source_position if cmd.source_position >= 0
                        else cmd.position)
            root = tracer.resolve_root(pid, cmd.position, fallback)
            notes.append((f"{pid}:{root}", cmd.position, t_append, t_commit))
        return notes

    def _release_acks(self, notes: list[tuple]) -> None:
        """The ack-release seam: observe append→ack latency, emit the
        ``processor.ack`` envelope (the attribution root on gateway-less
        harnesses) and the ``processor.fsync_wait`` cover span, and feed
        the slow-exemplar observatory."""
        import time as _time

        tracer = self._tracer
        pid = self.log_stream.partition_id
        now = _time.perf_counter()
        enabled = tracer.enabled
        on_ack = self.on_ack
        for trace_id, position, t_append, t_commit in notes:
            if t_append is None:
                continue  # stamp evicted, or a burst append without one
            latency = now - t_append
            tracer.observe_ack("processor", latency)
            if enabled and tracer.sampled(trace_id):
                tracer.emit(trace_id, "processor.ack", latency, pid,
                            attrs={"position": position})
                wait = now - t_commit
                if self._ack_gated and wait > 0:
                    tracer.emit(trace_id, "processor.fsync_wait", wait, pid,
                                parent="processor.ack",
                                attrs={"position": position})
            if enabled and on_ack is not None:
                on_ack(trace_id, latency)
    # end of the copy

    def _trace_group(self, cmds: list[LoggedRecord], elapsed: float,
                     window: tuple[float, float],
                     stages: list[tuple[str, float, float]],
                     overlap: float, notes: list[tuple] | None) -> None:
        """Spans for one kernel group: a group span over its real interval
        (``window``, perf_counter stamps; a consumed speculation's starts at
        its admission in the round that dispatched it) carrying ``overlap``
        (the host work run while the first chunk computed) as an attribute,
        and one child per pipeline stage at its real start, in sequence
        (``stages``: the stage, its start stamp, its seconds) — the
        per-trace view of the stream_processor_pipeline_* histograms, whose
        device stage is here two: ``dispatch``, the first chunk's launch at
        the end of admission, and ``device``, the wait for the device and
        its rows after the overlap; a backlog-wait span per sampled command
        (append → the group's start, at its REAL interval so the critical-path sweep
        charges it as queue time), plus a latency-attributed span per
        sampled command — Canopy-style: the group's wall time split evenly
        across its commands. Then the collections the gc hook holds.
        Ungated acks release here; gated acks release from the
        covering-fsync drain. Only called from the live PROCESSING path."""
        tracer = self._tracer
        pid = self.log_stream.partition_id
        offset = clock_offset_us()
        group_start, group_end = window
        group_trace = f"{pid}:g{cmds[0].position}"
        # Group spans bypass head sampling (see _trace_speculative): ~one
        # span bundle per wave, required by every sampled command's
        # interval substitution.
        if tracer.enabled:
            tracer.emit(group_trace, "processor.kernel_group", group_end - group_start, pid,
                        attrs={"commands": len(cmds),
                               "firstPosition": cmds[0].position,
                               "lastPosition": cmds[-1].position,
                               "overlapUs": int(overlap * 1e6)},
                        start_us=int(group_start * 1e6 + offset))
            for stage, start, dur in stages:
                if dur > 0:
                    tracer.emit(group_trace, f"processor.stage.{stage}", dur, pid,
                                parent="processor.kernel_group",
                                start_us=int(start * 1e6 + offset))
            drain_gc(tracer)
        share = elapsed / len(cmds)
        by_position = ({note[1]: note for note in notes} if notes else {})
        for cmd in cmds:
            note = by_position.get(cmd.position)
            trace_id = (note[0] if note is not None
                        else f"{pid}:{tracer.resolve_root(pid, cmd.position, cmd.position)}")
            if not tracer.sampled(trace_id):
                continue
            rec = cmd.record
            t_append = note[2] if note is not None else None
            if t_append is not None:
                backlog = group_start - t_append
                if backlog > 0:
                    tracer.emit(
                        trace_id, "processor.backlog_wait", backlog, pid,
                        parent="processor.ack",
                        attrs={"position": cmd.position},
                        start_us=int(t_append * 1e6 + offset))
            tracer.emit(trace_id, "processor.kernel_command", share, pid,
                        attrs={"position": cmd.position,
                               "valueType": rec.value_type.name,
                               "intent": rec.intent.name,
                               "group": group_trace,
                               "attributed": True})
        if notes and not self._ack_gated:
            self._release_acks(notes)

    # copied from the reference: _emit_group_effects .. run_until_idle
    def _emit_group_effects(self, builders: list) -> None:
        from zeebe_tpu_torch.engine.burst_templates import PreparedBurst

        job_types: set = set()
        for result in builders:
            if isinstance(result, PreparedBurst):
                for _extra, record, stream_id, request_id in result.responses:
                    self.response_sink(ClientResponse(record, stream_id, request_id))
                job_types |= result.job_types
            else:
                self._execute_side_effects(result)
                job_types |= activatable_job_types(result.follow_ups)
        self._notify_jobs_available(job_types)

    def _group_commit_point(self) -> None:
        """Per-step flush point: advance the acked position — immediately
        when acks are not flush-gated (append = visible, the pre-pipeline
        semantics). Gated acks are fully async: ``maybe_flush`` only decides
        WHETHER the cadence fsyncs here; the ack advance and the reply drain
        happen in ``_on_journal_flush``, fired by the journal after any
        successful covering fsync — this one or anyone else's."""
        if not self._ack_gated:
            self._acked_position = self.last_written_position
        else:
            self.log_stream.journal.maybe_flush()

    def _on_journal_flush(self, covered_index: int) -> None:
        """Journal flush callback — the async ack path. Runs strictly after
        a successful fsync, so everything appended before the flush call is
        durable: advance the acked position to the last appended record and
        emit the deferred replies it releases. A FAILED fsync never reaches
        this callback (FlushFailedError propagates from flush() first), so
        no reply can ever cover an unfsynced prefix. Single-threaded with
        the pump (every flush origin runs on the processor thread), so
        ``last_written_position`` is exactly the covered prefix."""
        self._acked_position = self.last_written_position
        if self._in_flush_ack:
            return  # re-entered from a drain-triggered fsync: outer drain owns it
        self._in_flush_ack = True
        try:
            self._run_deferred_effects()
        finally:
            self._in_flush_ack = False

    def _run_deferred_effects(self) -> None:
        """Emit deferred group side effects whose appends are acked (always
        the whole queue unless a journal flush_interval gates acks on the
        covering group-commit fsync)."""
        dq = self._deferred_effects
        if not dq:
            return
        import time as _time

        from zeebe_tpu_torch.engine.burst_templates import PreparedBurst

        t0 = _time.perf_counter()
        acked = self._acked_position
        in_txn = self.db.in_transaction
        emitted = 0
        while dq and dq[0][0] <= acked:
            if in_txn and any(
                not isinstance(b, PreparedBurst) and b.post_commit_tasks
                for b in dq[0][1]
            ):
                # post-commit tasks are an API allowed to open their own db
                # transaction — they only run at out-of-transaction drain
                # points (FIFO preserved: the queue stops at the first
                # task-bearing group; responses never overtake it)
                break
            _position, builders, notes = dq.pop(0)
            self._emit_group_effects(builders)
            if notes:
                # gated ack release: the covering fsync succeeded (this drain
                # only runs past an advanced acked position), so the
                # append→ack observation and ack/fsync-wait spans are real
                self._release_acks(notes)
            emitted += 1
        if emitted:
            # observed only when work happened: the stage breakdown stays a
            # per-group view, not inflated by empty drain attempts
            self._m_pipeline["side_effects"].observe(_time.perf_counter() - t0)

    def _flush_deferred_effects(self) -> None:
        """Pipeline boundary (idle, or a sequential command interleaving):
        everything still deferred must go out, forcing the covering
        group-commit fsync first when acks are gated on one."""
        dq = self._deferred_effects
        if not dq:
            return
        if dq[-1][0] > self._acked_position:
            # acks gated on durability: force the covering fsync. The flush
            # callback (_on_journal_flush) advances the acked position and
            # drains; the explicit advance below is the no-listener fallback
            # (a gated processor is always subscribed, but keep the boundary
            # correct even if the journal lacks the callback seam).
            self.log_stream.journal.flush()
            self._acked_position = max(self._acked_position,
                                       self.last_written_position)
        self._run_deferred_effects()

    def process_next(self) -> bool:
        """Process one command; returns False when no command is pending."""
        if self.phase != Phase.PROCESSING:
            raise RuntimeError(f"cannot process in phase {self.phase}")
        cmd = self._next_command()
        if cmd is None:
            return False
        self._process_command(cmd)
        return True

    def _process_command(self, cmd: LoggedRecord) -> None:
        import time as _time

        # sequential interleaving: responses stay in log order across the
        # batched and sequential paths. Flush-gated mode keeps the sequential
        # command's OWN effects in the deferred queue too (its ack must also
        # wait for the covering fsync), so order holds without forcing an
        # fsync per command; ungated mode drains everything immediately.
        if self._ack_gated:
            self._run_deferred_effects()
        else:
            self._flush_deferred_effects()
        start = _time.perf_counter()
        builder = ProcessingResultBuilder()
        try:
            with self.db.transaction():
                self._batch_process(cmd, builder)
                self._write_and_mark(cmd, builder)
        except _STORAGE_CORRUPTION:
            raise  # repairable disk fault: the pump's repair seam owns it
        except Exception as error:  # noqa: BLE001 — the rollback/onError seam
            logger.debug("processing error at position %s: %s", cmd.position, error, exc_info=True)
            self._m_batch_retry.inc()
            self._on_processing_error(cmd, error)
            return
        traced = self._tracer.enabled
        notes = self._take_ack_notes((cmd,)) if traced else None
        if self._ack_gated:
            # acked ⇒ durable: the response waits for the covering fsync
            # (maybe_flush cadence, or the idle-boundary flush); its ack
            # notes wait with it — a failed flush releases neither
            self._deferred_effects.append(
                (self.last_written_position, [builder], notes))
            self._group_commit_point()
            self._run_deferred_effects()
        else:
            self._execute_side_effects(builder)
            self._notify_jobs_available(activatable_job_types(builder.follow_ups))
        self._observe_follow_ups(builder.follow_ups)
        self._m_processed.inc()
        elapsed = _time.perf_counter() - start
        if traced:
            self._trace_command(cmd, builder, elapsed, notes)
        self._m_latency.observe(elapsed)
        self._m_processing_duration.observe(elapsed)
        self._m_batch_commands.observe(
            1 + sum(1 for f in builder.follow_ups
                    if f.record.is_command and f.processed))
        self._m_batch_duration.observe(elapsed)
        self._m_post_commit.observe(len(builder.post_commit_tasks))

    def _trace_command(self, cmd: LoggedRecord,
                       builder: ProcessingResultBuilder, elapsed: float,
                       notes: list[tuple] | None) -> None:
        """Spans for one sequentially processed command: the processing span,
        a backlog-wait span (append → processing start, at its real
        interval), and — when acks are ungated — the immediate ack release.
        Gated notes release from the covering-fsync drain instead. The trace
        id is the root command's position (follow-up commands inherit their
        producer's root via the batch source backlink), so the span stream
        joins to the lineage walker's trees."""
        import time as _time

        from zeebe_tpu_torch.observability.span import now_us as _now_us

        tracer = self._tracer
        pid = self.log_stream.partition_id
        note = notes[0] if notes else None
        trace_id = (note[0] if note is not None
                    else f"{pid}:{tracer.resolve_root(pid, cmd.position, cmd.position)}")
        if tracer.sampled(trace_id):
            rec = cmd.record
            t_append = note[2] if note is not None else None
            if t_append is not None:
                now = _time.perf_counter()
                backlog = (now - elapsed) - t_append
                if backlog > 0:
                    tracer.emit(
                        trace_id, "processor.backlog_wait", backlog, pid,
                        parent="processor.ack",
                        attrs={"position": cmd.position},
                        start_us=_now_us() - int((now - t_append) * 1e6))
            tracer.emit(trace_id, "processor.command", elapsed, pid,
                        attrs={"position": cmd.position,
                               "valueType": rec.value_type.name,
                               "intent": rec.intent.name,
                               "followUps": len(builder.follow_ups)})
        if notes and not self._ack_gated:
            self._release_acks(notes)

    def _batch_process(self, cmd: LoggedRecord, builder: ProcessingResultBuilder) -> None:
        """The batchProcessing loop: the input command plus follow-up commands
        produced during the step, processed in one transaction."""
        self.processor.process(cmd, builder)
        budget = self.max_commands_in_batch - 1
        scan = 0
        while budget > 0:
            follow_up = None
            while scan < len(builder.follow_ups):
                entry = builder.follow_ups[scan]
                if entry.record.is_command and not entry.processed:
                    follow_up = entry
                    break
                scan += 1
            if follow_up is None:
                break
            follow_up.processed = True
            budget -= 1
            logged = LoggedRecord(
                record=follow_up.record,
                position=-1,  # in-batch: position assigned at write time
                source_position=cmd.position,
                processed=True,
            )
            self.processor.process(logged, builder)
            scan += 1

    def _write_and_mark(self, cmd: LoggedRecord, builder: ProcessingResultBuilder) -> None:
        entries = [LogAppendEntry(f.record, f.processed) for f in builder.follow_ups]
        if entries:
            self.last_written_position = self.writer.try_write(
                entries, source_position=cmd.position
            )
        self.last_processed_position = cmd.position
        self._store_last_processed(cmd.position)
        self._note_live_dedupe(cmd, builder.follow_ups)

    def _on_processing_error(self, cmd: LoggedRecord, error: Exception) -> None:
        builder = ProcessingResultBuilder()
        with self.db.transaction():
            handling = self.processor.on_processing_error(error, cmd, builder)
            if handling == ProcessingErrorHandling.REJECT and builder.response is None:
                rej = rejection(cmd.record.replace(position=cmd.position),
                                RejectionType.PROCESSING_ERROR, str(error)[:8192])
                builder.append_record(rej)
                if cmd.record.request_id >= 0:
                    builder.with_response(rej, cmd.record.request_stream_id, cmd.record.request_id)
            self._write_and_mark(cmd, builder)
        if self._ack_gated:
            # rejections ack like any response: after the covering fsync
            # (no ack notes — rejections never fed the ack histogram)
            self._deferred_effects.append(
                (self.last_written_position, [builder], None))
            self._group_commit_point()
            self._run_deferred_effects()
            return
        self._execute_side_effects(builder)

    def _observe_follow_ups(self, follow_ups) -> None:
        for f in follow_ups:
            rec = f.record
            if not rec.is_event:
                continue
            vt = rec.value_type
            if vt == ValueType.JOB:
                child = self._m_job_actions.get(int(rec.intent))
                if child is not None:
                    child.inc()
            elif vt == ValueType.PROCESS_INSTANCE:
                intent = int(rec.intent)
                element_type = rec.value.get("bpmnElementType")
                if element_type == "PROCESS":
                    child = self._m_pi_actions.get(intent)
                    if child is not None:
                        child.inc()
                action = _ELEMENT_ACTIONS.get(intent)
                if action is not None and element_type:
                    key = (action, element_type)
                    child = self._m_element_children.get(key)
                    if child is None:
                        child = self._m_element_events.labels(
                            str(self.log_stream.partition_id), action,
                            element_type)
                        self._m_element_children[key] = child
                    child.inc()
            elif vt == ValueType.INCIDENT:
                child = self._m_incident_actions.get(int(rec.intent))
                if child is not None:
                    child.inc()

    def _notify_jobs_available(self, job_types: set) -> None:
        if job_types and self.on_jobs_available is not None:
            try:
                self.on_jobs_available(job_types)
            except Exception:  # noqa: BLE001 — notification must not wedge processing
                logger.exception("jobs-available notification failed")

    def _execute_side_effects(self, builder: ProcessingResultBuilder) -> None:
        if builder.response is not None:
            self.response_sink(builder.response)
        for extra in builder.extra_responses:
            self.response_sink(extra)
        if builder.post_commit_tasks:
            # post-commit tasks may open their own transaction and mutate
            # state a speculative admission already read: invalidate any
            # outstanding cross-wave stash (reader-position checks cannot
            # see this — tasks move no positions)
            self._state_epoch += 1
        for task in builder.post_commit_tasks:
            try:
                task()
            except Exception:  # noqa: BLE001 — side effects must not wedge the loop
                logger.exception("post-commit task failed")

    # -- pump ----------------------------------------------------------------

    def _write_scheduled_commands(self, commands: list[Record]) -> None:
        self.writer.try_write([LogAppendEntry(c) for c in commands])

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive scheduled tasks + processing until no work remains (or, in
        REPLAY mode, replay everything available). Returns steps executed."""
        steps = 0
        if self.phase == Phase.REPLAY:
            return self.replay_available()
        while steps < max_steps:
            self.schedule_service.run_due_tasks()
            if self.kernel_backend is not None:
                consumed = self.process_available_batch()
                if consumed:
                    steps += consumed
                    continue
            if not self.process_next():
                if self.schedule_service.run_due_tasks() == 0:
                    break
            steps += 1
        # idle boundary: the last group's deferred side effects (and, when
        # acks are flush-gated, the covering group-commit fsync) go out now
        self._flush_deferred_effects()
        return steps
    # end of the copy
