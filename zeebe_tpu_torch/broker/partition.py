"""ZeebePartition: one partition's full vertical on one broker node.

The counterpart of ``zeebe_tpu/broker/partition.py``, copied
(``testing/copies.py`` writes the marked runs) but for two members: the
constructor takes the kernel backend's ``device`` (resolved here, so a
partition asked for the card raises where CUDA is missing before it opens
anything), and ``_transition`` passes it to the leader's ``KernelBackend``.
The partition's Raft log is the replication transport and durable command
record; every replica materializes the committed prefix into its local
stream journal, and the leader's stream processor runs the commands, its
kernel-eligible groups on the backend's device.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from time import perf_counter as _perf_counter
from typing import Any, Callable

from zeebe_tpu_torch.cluster.messaging import MessagingService
from zeebe_tpu_torch.cluster.raft import RaftNode, RaftRole
from zeebe_tpu_torch.engine.distribution import CommandRedistributor
from zeebe_tpu_torch.engine.engine import Engine
from zeebe_tpu_torch.engine.message_timer import DueDateCheckers
from zeebe_tpu_torch.exporters.director import ExporterDirector
from zeebe_tpu_torch.journal import SegmentedJournal
from zeebe_tpu_torch.journal.journal import CorruptedJournalError
from zeebe_tpu_torch.state.tiering import ColdCorruptionError
from zeebe_tpu_torch.logstreams import LogAppendEntry, LogStream, patch_prepatched_batch
from zeebe_tpu_torch.observability.tracer import get_tracer as _get_tracer
from zeebe_tpu_torch.protocol import Record
from zeebe_tpu_torch.protocol.msgpack import packb, unpackb
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.snapshot import (
    DELTA_FILE,
    STATE_FILE,
    FileBasedSnapshotStore,
    load_chain_db,
)
from zeebe_tpu_torch.stream import Phase as _Phase
from zeebe_tpu_torch.stream import StreamProcessor, StreamProcessorMode
from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

# copied from the reference: DEFAULT_SNAPSHOT_PERIOD_MS .. _RaftWriter
DEFAULT_SNAPSHOT_PERIOD_MS = 5 * 60 * 1000
# recovery-time budget: recoveries slower than this increment the
# exceeded counter (default alert rule recovery_budget_exceeded) and the
# snapshot scheduler snapshots early when projected replay debt threatens it
DEFAULT_RECOVERY_BUDGET_MS = 60_000
# max base+delta chain length before the next snapshot rebases to a full one
DEFAULT_SNAPSHOT_CHAIN_LENGTH = 8
# replay throughput assumed before the first measured recovery (records/s);
# deliberately conservative so the adaptive scheduler errs toward snapshotting
DEFAULT_REPLAY_RATE_RPS = 10_000.0
# snapshot early once projected replay time passes this fraction of the budget
REPLAY_DEBT_BUDGET_FRACTION = 0.5

# command-ingress tracing (singleton mutated in place; one enabled-check per
# client_write when tracing is off)
_TRACER = _get_tracer()

# recovery-budget plane metrics (module-level so the families exist from
# first partition construction — the metrics-doc scenario and the sampler
# both see them without waiting for a slow recovery)
_M_RECOVERY_DURATION = _REG.histogram(
    "recovery_duration_seconds",
    "seconds to rebuild a partition's vertical (snapshot install + replay) "
    "on a restart or role transition", ("partition",),
    buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 60, 300))
_M_RECOVERY_REPLAYED = _REG.counter(
    "recovery_replay_records_total",
    "records replayed during partition recoveries", ("partition",))
_M_RECOVERY_SNAPSHOT_AGE = _REG.gauge(
    "recovery_snapshot_age_records",
    "records between the recovered snapshot's processed position and the "
    "log end at recovery time", ("partition",))
_M_RECOVERY_EXCEEDED = _REG.counter(
    "recovery_budget_exceeded_total",
    "recoveries that blew recovery_budget_ms", ("partition",))
_M_SNAPSHOT_KIND = _REG.counter(
    "snapshot_kind_total", "snapshots persisted by kind (full/delta/durable)",
    ("partition", "kind"))
_M_SNAPSHOT_CHAIN_LEN = _REG.gauge(
    "snapshot_chain_length",
    "length of the latest snapshot chain (1 = full snapshot)", ("partition",))
_M_REPLAY_DEBT = _REG.gauge(
    "snapshot_replay_debt_records",
    "records appended since the latest snapshot (recovery replay upper "
    "bound)", ("partition",))
_M_ADAPTIVE_SNAPSHOTS = _REG.counter(
    "snapshot_adaptive_triggers_total",
    "snapshots taken early because projected replay debt threatened the "
    "recovery budget", ("partition",))
_M_SNAPSHOT_WRITE_FAILURES = _REG.counter(
    "snapshot_write_failures_total",
    "snapshots aborted by a storage write/fsync fault; the "
    "previous valid chain stays the recovery anchor", ("partition",))
# replicated request dedupe: ingress consults the materialized
# table before appending — a hit suppresses a duplicate append, a replay
# re-sends the stored reply for an already-answered request
_M_DEDUPE_HITS = _REG.counter(
    "request_dedupe_hits_total",
    "resent requests recognized as in flight or processed (duplicate "
    "append suppressed)", ("partition",))
_M_DEDUPE_REPLAYS = _REG.counter(
    "request_dedupe_replays_total",
    "resent requests answered by replaying the stored reply from the "
    "replicated dedupe table", ("partition",))


class BackpressureExceeded(Exception):
    """Client command rejected by the in-flight limiter (maps to gRPC
    RESOURCE_EXHAUSTED at the gateway)."""


class _RaftWriter:
    """LogStreamWriter-shaped adapter the StreamProcessor writes through:
    follow-ups and scheduled commands replicate via Raft before they become
    readable (reference: AtomixLogStorage.append → LeaderRole.appendEntry)."""

    def __init__(self, partition: "ZeebePartition") -> None:
        self.partition = partition

    def try_write(self, entries, source_position: int = -1) -> int:
        result = self.partition.write_entries(list(entries), source_position)
        return result if result is not None else -1

    def append_prepatched(self, buf: bytearray, pos_offsets, ts_offsets,
                          count: int, has_pending_commands: bool = False) -> int:
        """Burst-template fast path over Raft: patch positions/timestamps into
        the pre-serialized batch, replicate the bytes (mirrors
        LogStreamWriter.append_prepatched; the committed entry materializes
        into the stream journal like any other batch)."""
        p = self.partition
        if p.role != RaftRole.LEADER:
            return -1
        first_position = p._next_position
        timestamp = p.clock_millis()
        patch_prepatched_batch(buf, pos_offsets, ts_offsets,
                               first_position, timestamp)
        if p.raft.append(bytes(buf), asqn=first_position) is None:
            return -1
        # remember the command-scan skip flag until the committed entry
        # materializes into the stream journal
        p._prepatched_flags[first_position] = has_pending_commands
        p._next_position = first_position + count
        return first_position + count - 1
# end of the copy


class ZeebePartition:
    def __init__(
        self,
        messaging: MessagingService,
        partition_id: int,
        members: list[str],
        directory: str | Path,
        clock_millis: Callable[[], int],
        partition_count: int = 1,
        exporters_factory: Callable[[], dict[str, Any]] | None = None,
        inter_partition_sender=None,
        response_sink: Callable[[Any], None] | None = None,
        snapshot_period_ms: int = DEFAULT_SNAPSHOT_PERIOD_MS,
        priority: int = 1,
        consistency_checks: bool = True,
        backup_service=None,
        on_checkpoint=None,
        backpressure=None,
        on_jobs_available=None,
        kernel_backend_enabled: bool = True,
        mesh_runner=None,
        device=None,
        durable_state: bool = False,
        health_monitor=None,
        flight_recorder=None,
        recovery_budget_ms: int = DEFAULT_RECOVERY_BUDGET_MS,
        snapshot_chain_length: int = DEFAULT_SNAPSHOT_CHAIN_LENGTH,
        tiering=None,
        log_flush_delay_ms: int = 0,
        log_max_unflushed_bytes: int = 1 << 20,
        scrub=None,
    ) -> None:
        self.partition_id = partition_id
        self.partition_count = partition_count
        self.directory = Path(directory)
        self.clock_millis = clock_millis
        # factory, not instances: each partition (and each transition) gets its
        # own exporter instances — a shared instance's controller would ack
        # positions into whichever partition opened it last
        self.exporters_factory = exporters_factory or (lambda: {})
        self.inter_partition_sender = inter_partition_sender
        self.response_sink = response_sink or (lambda r: None)
        self.snapshot_period_ms = snapshot_period_ms
        self.consistency_checks = consistency_checks
        self.backup_service = backup_service  # BackupService | None
        self.on_checkpoint = on_checkpoint  # broker cache-bump hook
        # jobs-available side effect: (partition_id, {job types}) → broker →
        # gateway hub (long-poll wakeup + job push dispatch)
        self.on_jobs_available = on_jobs_available
        self.kernel_backend_enabled = kernel_backend_enabled
        self.mesh_runner = mesh_runner
        # the kernel backend's device: CUDA unless the caller asks for the
        # CPU (the plain version); resolved before anything is opened, and
        # imported here so that a process that serves no kernel (a client,
        # a gateway) loads no torch
        from zeebe_tpu_torch.ops.automaton import resolve_device

        self.device = resolve_device(device) if kernel_backend_enabled else None
        self.durable_state = durable_state
        # state tiering: cold parked-instance store config
        # (state/tiering.py TieringCfg | None). Durable state supersedes it —
        # the durable backend has its own hot/cold residency story.
        self.tiering_cfg = tiering if (tiering is not None
                                       and getattr(tiering, "enabled", False)
                                       and not durable_state) else None
        self.tiering = None  # TieringManager | None, built per transition
        # broker health monitor (CriticalComponentsHealthMonitor | None): the
        # exporter director reports per-exporter DEGRADED/HEALTHY through it
        self.health_monitor = health_monitor
        # flight recorder (observability/flight_recorder.py | None): this
        # partition's bounded black-box ring of operational events
        self.flight = flight_recorder
        # latency observatory: windowed worst-N ack exemplars +
        # bounded critical_path flight events; built per transition so the
        # hook always points at the live processor
        self.latency_observatory = None
        self._exporter_flight_status: dict[str, Any] = {}
        # client-ingress backpressure (CommandRateLimiter | None) and the
        # disk-monitor pause flag; both gate client_write only — follow-ups,
        # scheduled commands, and inter-partition traffic always pass
        self.limiter = backpressure
        self.paused = False        # admin pause (BrokerAdminService)
        self.disk_paused = False   # disk watermark pause — independent source

        # recovery-budget plane: budget knob, incremental-snapshot
        # chain state, and the last recovery's observations (served on
        # /health and asserted by the soak harness)
        self.recovery_budget_ms = recovery_budget_ms
        self.snapshot_chain_length = max(1, snapshot_chain_length)
        self.last_recovery: dict | None = None
        # leader replay barrier: raft position materialization+replay must
        # reach before processing may start (None = no barrier pending);
        # the flag records a budget blown WHILE the barrier was pending so
        # the eventual _record_recovery doesn't double-count it
        self._replay_barrier: int | None = None
        self._barrier_budget_flagged = False
        self._recovery_started = 0.0
        self._snapshot_anchor = None   # chain-tip SnapshotId deltas build on
        self._chain_len = 0
        self._last_snapshot_processed = -1
        self._observed_replay_rate = DEFAULT_REPLAY_RATE_RPS
        self._last_debt_check_ms = 0
        # adaptive snapshot triggers this life (the control plane's
        # snapshot-scheduler loop row reads it without a registry scrape)
        self.adaptive_snapshot_count = 0
        # compaction-bound memo keyed by the newest snapshot id: chain
        # validation re-reads and CRCs every chain member (the base is the
        # whole state), and the guards run several times per snapshot — only
        # a new persist can change the store's answer in-process, so cache
        # until the newest id moves (crash-tampering always restarts the
        # partition, which rebuilds this object)
        self._compact_bound_memo: tuple = (None, -1)

        self.snapshot_store = FileBasedSnapshotStore(self.directory / "snapshots")
        self.raft = RaftNode(
            messaging, partition_id, members, self.directory / "raft",
            clock_millis, priority=priority,
            # group-commit pacing static defaults: runtime
            # mutation of raft.flush_interval_s belongs to the journal-flush
            # controller's actuator exclusively
            flush_interval_s=max(log_flush_delay_ms, 0) / 1000.0,
            max_unflushed_bytes=log_max_unflushed_bytes,
        )
        self.raft.commit_listeners.append(self._on_raft_commit)
        self.raft.role_listeners.append(self._on_role_change)
        self.raft.snapshot_provider = self._provide_install_snapshot
        self.raft.snapshot_receiver = self._receive_install_snapshot
        # compaction safety: segment deletion in EITHER journal is clamped to
        # min(latest snapshot position, all exporter container cursors) —
        # enforced below every caller, inside the journals themselves
        self.raft.journal.compact_guard = self._raft_compact_guard

        self._stream_dir = self.directory / "stream"
        self.stream_journal = SegmentedJournal(self._stream_dir)
        self.stream_journal.compact_guard = self._stream_compact_guard
        self.stream = LogStream(self.stream_journal, partition_id, clock=clock_millis)

        self.role = RaftRole.FOLLOWER
        self.db: ZbDb | None = None
        self.engine: Engine | None = None
        self.processor: StreamProcessor | None = None
        self.exporter_director: ExporterDirector | None = None
        self.checkers: DueDateCheckers | None = None
        self.redistributor: CommandRedistributor | None = None
        self._applied_raft_index = 0
        # asqn → has_pending_commands for burst batches appended via
        # append_prepatched (consumed at materialization)
        self._prepatched_flags: dict[int, bool] = {}
        self._latest_checkpoint = 0
        self._next_position = self.stream.last_position + 1
        self._last_snapshot_ms = clock_millis()
        # replicated dedupe, leader-side in-memory half: (stream id, request
        # id) → position of APPENDED-but-unprocessed client commands. The
        # dedupe column family only learns a request at processing time;
        # this map covers the append→process window and is REBUILT from the
        # materialized log on every leader transition, so a restarted leader
        # (or a promoted follower) still refuses to double-append a resend
        # that races recovery.
        self._pending_requests: dict[tuple[int, int], int] = {}
        # storage-fault plane: at-rest scrubber + repair seams.
        # ``scrub`` is a ScrubCfg | None; the scrubber survives transitions
        # (cursors and evidence are partition-lifetime) and reads the LIVE
        # journals/stores through `self` each slice.
        self.scrubber = None
        if scrub is not None and getattr(scrub, "enabled", False):
            from zeebe_tpu_torch.broker.scrubber import StorageScrubber

            self.scrubber = StorageScrubber(self, scrub, clock_millis)
        self.raft.storage_listener = self._on_raft_storage_event
        # repair-loop guard: target -> monotonic time of last repair; a
        # second repair of the same target within the window means the
        # fault is not repairable by that seam — fail the processor instead
        # of looping the partition through endless rebuilds
        self._last_storage_repair: dict[str, float] = {}
        self._transition()  # start as follower (replay mode)
        # catch up on whatever the raft log already committed before we wired
        self._materialize_committed()

    # -- raft integration ------------------------------------------------------

    # copied from the reference: _on_raft_commit .. _on_role_change
    def _on_raft_commit(self, commit_index: int) -> None:
        self._materialize_committed()

    def _materialize_committed(self) -> None:
        """Append newly committed raft entries' payloads to the stream journal."""
        for entry in self.raft.committed_entries(self._applied_raft_index + 1):
            self._applied_raft_index = entry["index"]
            if entry.get("init") or not entry.get("data"):
                continue
            self.stream.append_committed_payload(
                entry["data"], entry["asqn"],
                has_pending_commands=self._prepatched_flags.pop(entry["asqn"], None),
            )
            if self.flight is not None:
                # last-K committed-batch summaries (one ring entry per BATCH,
                # not per record — count is the payload's leading u32)
                import struct as _struct

                self.flight.record(
                    self.partition_id, "records", first=entry["asqn"],
                    count=_struct.unpack_from("<I", entry["data"], 0)[0])
        self._next_position = max(self._next_position, self.stream.last_position + 1)

    def _on_role_change(self, role: RaftRole, term: int) -> None:
        self.role = role
        if self.flight is not None:
            self.flight.record(self.partition_id, "role_change",
                               role=role.value, term=term)
        self._transition()
    # end of the copy

    # -- transition steps (reference: PartitionTransitionImpl) -----------------

    def _transition(self) -> None:
        """Tear down and rebuild the processing vertical for the current role:
        recover db from the latest snapshot chain, replay the stream journal,
        then process (leader) or keep replaying (follower). The whole
        rebuild is timed against ``recovery_budget_ms``: duration,
        replay length, and snapshot age land in the metrics plane and the
        flight recorder."""
        recovery_start = _perf_counter()
        self._pending_requests.clear()  # rebuilt below for leaders
        self._replay_barrier = None  # a re-transition supersedes any barrier
        # ...and so does its blown-budget flag: left set, it would suppress
        # the exceeded counter for this (distinct) rebuild's own verdict
        self._barrier_budget_flagged = False
        self._recover_db()
        # flags for appends that never committed under the previous role must
        # not leak onto a NEW leader's batch at a reused position (raft may
        # have truncated ours) — wrong flags make the command scan skip real
        # commands
        self._prepatched_flags.clear()
        # state migrations run between snapshot recovery and the stream
        # processor opening (reference: MigrationTransitionStep →
        # DbMigratorImpl.runMigrations)
        from zeebe_tpu_torch.engine.migration import DbMigrator

        DbMigrator(self.db).run_migrations()
        mode = (
            StreamProcessorMode.PROCESSING
            if self.role == RaftRole.LEADER else StreamProcessorMode.REPLAY
        )
        self.engine = Engine(
            self.db, self.partition_id, clock_millis=self.clock_millis,
            partition_count=self.partition_count,
        )
        # per-transition query façade (reference: QueryServiceTransitionStep —
        # closed and replaced with the db on every role change)
        from zeebe_tpu_torch.engine.query import QueryService

        if getattr(self, "query_service", None) is not None:
            self.query_service.close()
        self.query_service = QueryService(self.db, self.engine.state)
        if self.inter_partition_sender is not None:
            self.engine.wire_sender(self.inter_partition_sender)
        kernel_backend = None
        if self.kernel_backend_enabled and mode == StreamProcessorMode.PROCESSING:
            # the partition's batched execution backend (BASELINE.json north
            # star): groups of kernel-eligible commands ride the device;
            # construction is lazy — no device work until a candidate arrives
            from zeebe_tpu_torch.engine.kernel_backend import KernelBackend

            kernel_backend = KernelBackend(self.engine, max_group=2048,
                                           chunk_steps=8,
                                           mesh_runner=self.mesh_runner,
                                           device=self.device)
        self.processor = StreamProcessor(
            self.stream, self.db, self.engine, mode=mode,
            response_sink=self.response_sink, clock_millis=self.clock_millis,
            writer=_RaftWriter(self),
            kernel_backend=kernel_backend,
        )
        if kernel_backend is not None and self.flight is not None:
            # bounded per-wave path accounting into the black box: ≤1
            # kernel_wave event/s with the wave-size / chunk / path-split /
            # dominant-fallback aggregate since the last one
            self.processor.wave_listener = (
                lambda event, pid=self.partition_id:
                self.flight.record(pid, "kernel_wave", **event))
            # device health audit sink: the process-wide ladder's
            # transitions (control_adjust + device_health events) and typed
            # device_fault evidence land in this broker's flight recorder
            kernel_backend.health.flight_sink = (self.flight,
                                                 self.partition_id)
        if self.on_jobs_available is not None:
            listener = self.on_jobs_available
            self.processor.on_jobs_available = (
                lambda types, pid=self.partition_id: listener(pid, types)
            )
        if self.flight is not None:
            # slow-exemplar capture: the N worst acked traces per
            # window dump their span trees through the flight recorder, and
            # a bounded critical_path event carries the window's top stages
            # (→ /cluster/status → `cli top` LATENCY section). Zero cost
            # while tracing is off — the ack hook only fires under the
            # tracer's enabled guard.
            from zeebe_tpu_torch.observability.critical_path import (
                LatencyObservatory,
            )

            self.latency_observatory = LatencyObservatory(
                _TRACER, self.flight, self.partition_id)
            self.processor.on_ack = self.latency_observatory.observe
        self.processor.start()
        self.checkers = DueDateCheckers(
            self.engine.state, self.processor.schedule_service, self.clock_millis
        )
        if self.tiering_cfg is not None:
            # fresh manager per transition over the fresh db (the seams —
            # park_listener/woken_listener — rewire to it); replay feeds it
            # on followers too, so a promoted follower spills immediately
            from zeebe_tpu_torch.state.tiering import TieringManager

            self.tiering = TieringManager(
                self.db, self.clock_millis, self.tiering_cfg,
                partition_id=self.partition_id)
        self.redistributor = CommandRedistributor(
            self.engine.state, self.engine.sender,
            self.processor.schedule_service, self.clock_millis,
        )
        if self.exporter_director is not None:
            self.exporter_director.close()  # flush partial bulks, run Exporter.close
        if self.health_monitor is not None:
            # fresh containers know nothing of the old ones' failures: a
            # stale DEGRADED report must not outlive the director it came
            # from (the new director re-reports on its own first failure)
            self.health_monitor.deregister_matching(
                f"partition-{self.partition_id}.exporter-")
        self.exporter_director = ExporterDirector(
            self.stream, self.db, self.exporters_factory(),
            clock_millis=self.clock_millis,
            on_health=self._report_exporter_health,
        )
        self.engine.checkpoint.listeners.append(self._on_checkpoint_created)
        # lock-free checkpoint-id cache: refreshed here on the owner thread
        # and bumped by the applier hook on BOTH leader processing and
        # follower replay (the cross-partition send path reads it without
        # touching this db)
        self.engine.appliers.on_checkpoint_applied = self._observe_checkpoint_applied
        with self.db.transaction():
            self._latest_checkpoint = self.engine.checkpoint_state.latest_id()
        if self.role == RaftRole.LEADER:
            # leader sequencer continues after the last position in the raft
            # log (committed or not — uncommitted entries still own positions)
            raft_end = self._last_raft_position()
            self._next_position = max(self._next_position, raft_end + 1)
            if (raft_end > self.stream.last_position
                    and self.processor.phase != _Phase.FAILED):
                # (a FAILED processor — poison record contained during
                # start()'s replay — must STAY failed: flipping it to REPLAY
                # here would re-attempt the poison batch on the next pump)
                # REPLAY BARRIER: the raft log holds entries not
                # yet re-materialized into the stream journal (a power loss
                # wiped the derived journal's unfsynced bytes, or this
                # leader was elected before its commit index recovered).
                # Processing now would RE-process client commands whose
                # result events only exist in the unmaterialized suffix —
                # duplicating their effects (instances created twice). Hold
                # the processor in REPLAY until materialization + replay
                # reach the barrier (leader completeness guarantees every
                # entry in our log eventually commits); pump() flips to
                # PROCESSING and finalizes the recovery accounting there.
                self._replay_barrier = raft_end
                self._recovery_started = recovery_start
                self._barrier_budget_flagged = False
                self.processor.phase = _Phase.REPLAY
                return
        if self.role == RaftRole.LEADER:
            self._rebuild_pending_requests()
        self._record_recovery(_perf_counter() - recovery_start,
                              self.processor.replayed_records)

    # copied from the reference: _finish_leader_recovery .. health
    def _finish_leader_recovery(self) -> None:
        """Replay barrier cleared: the stream re-materialized through the
        raft log end known at election and replay applied it. Processing
        starts exactly where an uninterrupted recovery would have — after
        the last command whose events are reflected in state."""
        self._replay_barrier = None
        processor = self.processor
        processor.phase = _Phase.PROCESSING
        # commands between last_processed and the barrier that never got
        # processed pre-crash still need processing: scan from the front of
        # the unreplayed suffix (the command scan skips processed ones)
        processor._reader_position = (
            1 if processor.last_processed_position < 0
            else processor.last_processed_position + 1
        )
        self._rebuild_pending_requests()
        self._record_recovery(_perf_counter() - self._recovery_started,
                              processor.replayed_records)

    # -- recovery accounting (recovery-time budget, -------------------

    def _record_recovery(self, duration_s: float, replayed: int) -> None:
        pid = str(self.partition_id)
        age = max(
            self.stream.last_position - max(self._last_snapshot_processed, 0),
            0)
        duration_ms = duration_s * 1000.0
        budget = self.recovery_budget_ms
        within = budget <= 0 or duration_ms <= budget
        _M_RECOVERY_DURATION.labels(pid).observe(duration_s)
        _M_RECOVERY_REPLAYED.labels(pid).inc(replayed)
        _M_RECOVERY_SNAPSHOT_AGE.labels(pid).set(float(age))
        if replayed >= 64 and duration_s > 0:
            # measured replay throughput feeds the adaptive snapshot
            # scheduler's replay-debt projection
            self._observed_replay_rate = max(replayed / duration_s, 1.0)
        info = {
            "role": self.role.value,
            "durationMs": round(duration_ms, 3),
            "replayRecords": replayed,
            "snapshotId": (str(self._snapshot_anchor)
                           if self._snapshot_anchor is not None else None),
            "chainLength": self._chain_len,
            "snapshotAgeRecords": age,
            "budgetMs": budget,
            "withinBudget": within,
            "atMs": self.clock_millis(),
        }
        self.last_recovery = info
        if not within and not self._barrier_budget_flagged:
            # (already counted at the barrier the moment the budget blew)
            _M_RECOVERY_EXCEEDED.labels(pid).inc()
        self._barrier_budget_flagged = False
        if self.flight is not None:
            self.flight.record(self.partition_id, "recovery", **info)
            # every recovery leaves a reviewable artifact while the event is
            # still in the ring (per-batch records evict it fast under
            # load). Leader recoveries (the time-to-leader number the budget
            # is about) and blown budgets always force a dump; follower
            # transitions ride the 5s per-reason-class throttle
            self.flight.dump(
                f"recovery:partition-{pid}",
                force=not within or self.role == RaftRole.LEADER)

    # -- compaction safety gate ------------------------------------------------

    def _compaction_position_bound(self) -> int:
        """Highest stream position whose records may be deleted: covered by
        the latest persisted snapshot AND acknowledged by every exporter
        container (a DEGRADED/backing-off exporter pins this until it
        recovers — its growing ``exporter_container_lag_records`` gauge is
        the observable). -1 = nothing is compactable."""
        latest = self.snapshot_store.latest_snapshot()
        if latest is None:
            return -1
        memo_id, bound = self._compact_bound_memo
        if memo_id != latest.id:
            # the newest VALID chain's tip, not the newest directory: a torn
            # tip (power loss during commit) will be skipped by recovery,
            # which then needs the log back to the chain it actually falls
            # back to
            chain = self.snapshot_store.latest_valid_chain()
            bound = -1 if chain is None else chain[-1].id.processed_position
            self._compact_bound_memo = (latest.id, bound)
        if bound < 0:
            return -1
        director = getattr(self, "exporter_director", None)
        if director is not None:
            bound = min(bound, director.lowest_exporter_position())
        return bound

    def _raft_compact_guard(self) -> int:
        bound = self._compaction_position_bound()
        if bound < 0:
            return 0
        return max(self.raft.journal.seek_to_asqn(bound), 0)

    def _stream_compact_guard(self) -> int:
        bound = self._compaction_position_bound()
        if bound < 0:
            return 0
        return max(self.stream_journal.seek_to_asqn(bound), 0)

    def _recover_db(self) -> None:
        """StateControllerImpl.recover: newest fully-valid snapshot *chain*
        (base + deltas) → runtime db, falling back chain by chain on
        corruption — a torn tip (power loss during commit) recovers from its
        last fully-valid ancestor instead of crashing.

        Durable mode: the on-disk delta log (state/durable.py) recovers to
        its last checkpoint in O(bytes); a snapshot chain from the store only
        overrides it when NEWER (a received raft INSTALL persisted one)."""
        self._snapshot_anchor = None
        self._chain_len = 0
        self._last_snapshot_processed = -1
        from zeebe_tpu_torch.state.tiering import TieredZbDb

        if isinstance(self.db, TieredZbDb):
            # release the previous life's cold segments/fds; the new store
            # wipes the directory on open (cold is a cache tier — durability
            # lives in the chain + log)
            self.db.close()
        if self.durable_state:
            from zeebe_tpu_torch.state import ColumnFamilyCode
            from zeebe_tpu_torch.state.durable import DurableZbDb

            if isinstance(self.db, DurableZbDb):
                self.db.close()
            db = DurableZbDb.open(self.directory / "state",
                                  consistency_checks=self.consistency_checks)
            chain = self.snapshot_store.latest_valid_chain()
            state_bin = None
            if chain is not None and chain[0].has_file("state.bin"):
                # a received raft INSTALL persisted a full snapshot — or the
                # DURABLESTATE flag was just flipped ON over a non-durable
                # delta chain: materialize it so nothing is lost
                try:
                    if len(chain) == 1:
                        state_bin = chain[0].read_file("state.bin")
                    else:
                        state_bin = load_chain_db(chain).to_snapshot_bytes()
                except (OSError, ValueError):
                    state_bin = None
            if state_bin is not None:
                snap_processed = unpackb(
                    chain[-1].read_file("meta.bin")).get("lastProcessed", -1)
                durable_processed = db.committed_get(
                    ColumnFamilyCode.LAST_PROCESSED_POSITION, ("last",))
                if snap_processed > (durable_processed
                                     if durable_processed is not None else -1):
                    db.install_snapshot_bytes(state_bin)
            self.db = db
            return
        for chain in self.snapshot_store.iter_valid_chains():
            base, tip = chain[0], chain[-1]
            if not base.has_file("state.bin"):
                if base.has_file("durable.bin"):
                    # durable-marker snapshot (taken while the DURABLESTATE
                    # flag was on) with the flag now OFF: recover from the
                    # durable disk this once — the next snapshot writes
                    # state.bin and the migration back to in-memory completes
                    # (flag must stay reversible; reference config flags are)
                    from zeebe_tpu_torch.state.durable import DurableZbDb

                    self.db = DurableZbDb.open(
                        self.directory / "state",
                        consistency_checks=self.consistency_checks)
                    return
                continue
            try:
                db = load_chain_db(chain,
                                   consistency_checks=self.consistency_checks,
                                   db=self._new_memory_db())
            except (OSError, ValueError):
                continue  # corruption the manifest missed: next-older chain
            self.db = db
            db.begin_delta_tracking()
            self._snapshot_anchor = tip.id
            self._chain_len = len(chain)
            try:
                self._last_snapshot_processed = unpackb(
                    tip.read_file("meta.bin")).get(
                    "lastProcessed", tip.id.processed_position)
            except (OSError, ValueError):
                self._last_snapshot_processed = tip.id.processed_position
            # the chain we just validated and loaded IS the recovery
            # anchor: prime the compaction-bound memo so the first guard
            # pass doesn't re-CRC it (keyed on the newest DIR — if a
            # newer broken-chain dir exists the key misses and the guard
            # conservatively re-walks)
            self._compact_bound_memo = (tip.id, tip.id.processed_position)
            return
        db = self._new_memory_db()
        db.begin_delta_tracking()
        self.db = db

    def _new_memory_db(self) -> ZbDb:
        """An empty in-memory-rooted store for recovery to install into:
        tiered (cold parked-instance store under ``<partition>/cold``) when
        tiering is on, the plain dict store otherwise."""
        if self.tiering_cfg is not None:
            from zeebe_tpu_torch.state.tiering import TieredZbDb

            return TieredZbDb(
                self.directory / "cold",
                consistency_checks=self.consistency_checks,
                segment_max_bytes=self.tiering_cfg.segment_max_bytes,
                partition_id=self.partition_id)
        return ZbDb(consistency_checks=self.consistency_checks)

    def _last_raft_position(self) -> int:
        """Highest stream position assigned in the raft log (scan the suffix
        after the materialized prefix; usually empty or tiny)."""
        last = self.stream.last_position
        for rec in self.raft.journal.read_from(self._applied_raft_index + 1):
            entry = unpackb(rec.data)
            if entry.get("init") or not entry.get("data"):
                continue
            # count of records in the batch payload is the first u32
            import struct

            count = struct.unpack_from("<I", entry["data"], 0)[0]
            last = max(last, entry["asqn"] + count - 1)
        return last

    # -- command ingress (CommandApiRequestHandler equivalent) -----------------

    def _rebuild_pending_requests(self) -> None:
        """Re-derive the append→process request window from the materialized
        log: unprocessed client commands carrying a request id, scanned from
        the suffix after last-processed. Runs at leader transitions (after
        the replay barrier, when one was pending — the stream is complete
        through the election-time raft end by then)."""
        self._pending_requests.clear()
        if self.processor is None:
            return
        start = max(self.processor.last_processed_position + 1, 1)
        for logged in self.stream.new_reader(start):
            rec = logged.record
            if rec.is_command and not logged.processed and rec.request_id >= 0:
                self._pending_requests[
                    (rec.request_stream_id, rec.request_id)] = logged.position

    def _note_pending_request(self, record: Record, position: int) -> None:
        if record.request_id < 0:
            return
        pending = self._pending_requests
        pending[(record.request_stream_id, record.request_id)] = position
        while len(pending) > 65536:
            # oldest-first eviction keeps dedupe live for recent traffic
            # (an evicted request falls back to the dedupe column family
            # once processed — only its unprocessed window is uncovered)
            del pending[next(iter(pending))]

    @property
    def ready_for_ingress(self) -> bool:
        """Leader actively processing (replay barrier cleared): only then is
        the pending-request window complete enough for exactly-once ingress
        dedupe. A leader mid-recovery answers ``unavailable`` instead — it
        did NOT append, so the gateway may safely retry."""
        return (self.role == RaftRole.LEADER
                and self.processor is not None
                and self.processor.phase == _Phase.PROCESSING)

    def lookup_request(self, stream_id: int, request_id: int):
        """Replicated-dedupe ingress consult (committed-read discipline; the
        worker ingress handler runs on the pump thread between
        transactions). Returns ``("replied", entry)`` when a stored reply
        can be replayed, ``("pending", {"c": position})`` when the request
        is appended or processed-awaiting (do NOT append again; the reply
        arrives from processing), or None (unknown: append)."""
        if request_id < 0:
            return None
        key = (stream_id, request_id)
        position = self._pending_requests.get(key)
        if position is not None:
            if (self.processor is not None
                    and position <= self.processor.last_processed_position):
                # graduated to the dedupe column family at processing time
                del self._pending_requests[key]
            else:
                self._observe_dedupe("hit", request_id, position)
                return ("pending", {"c": position})
        if self.db is None or self.db.in_transaction:
            return None
        from zeebe_tpu_torch.state.request_dedupe import RequestDedupeState

        entry = RequestDedupeState.lookup_committed(self.db, stream_id,
                                                    request_id)
        if entry is None:
            return None
        if entry.get("f"):
            self._observe_dedupe("replay", request_id, entry["c"])
            return ("replied", entry)
        self._observe_dedupe("hit", request_id, entry["c"])
        return ("pending", entry)

    def _observe_dedupe(self, kind: str, request_id: int,
                        position: int) -> None:
        pid = str(self.partition_id)
        if kind == "replay":
            _M_DEDUPE_REPLAYS.labels(pid).inc()
        else:
            _M_DEDUPE_HITS.labels(pid).inc()
        if self.flight is not None:
            self.flight.record(self.partition_id, "request_dedupe",
                               result=kind, requestId=request_id,
                               commandPosition=position)

    def client_write(self, record: Record) -> int | None:
        """Client API ingress: backpressure + pause gate, then the normal
        write path (reference: CommandApiRequestHandler.handleExecuteCommand —
        rate limiter check before LogStreamWriter.tryWrite)."""
        if self.paused or self.disk_paused:
            return None
        tracer = _TRACER
        # capture the enabled flag once: a mid-flight configure_tracing must
        # not pair a real perf_counter with the 0.0 sentinel
        traced = tracer.enabled
        t0 = _perf_counter() if traced else 0.0
        if self.limiter is not None and not self.limiter.try_acquire(record):
            if self.flight is not None:
                # on the rejection (exception) path only — never on admits
                self.flight.record(
                    self.partition_id, "backpressure_reject",
                    limit=self.limiter.limit,
                    valueType=record.value_type.name)
            raise BackpressureExceeded(
                f"partition {self.partition_id} has reached its in-flight "
                f"command limit ({self.limiter.limit})"
            )
        t_acquired = _perf_counter() if traced else 0.0
        position = self.write_commands([record])
        if position is not None:
            self._note_pending_request(record, position)
            if self.limiter is not None:
                self.limiter.on_appended(position)
        if traced and position is not None:
            # the Raft path bypasses the local LogStreamWriter, so the ack
            # stamp is taken here; the trace root is the command's own
            # position — the same id the processor and exporter spans use
            tracer.note_append(self.partition_id, position)
            trace_id = f"{self.partition_id}:{position}"
            if tracer.sampled(trace_id):
                if self.limiter is not None:
                    tracer.emit(trace_id, "broker.backpressure_acquire",
                                t_acquired - t0, self.partition_id,
                                attrs={"position": position})
                tracer.emit(trace_id, "broker.command_append",
                            _perf_counter() - t_acquired, self.partition_id,
                            attrs={"position": position,
                                   "valueType": record.value_type.name,
                                   "intent": record.intent.name})
        return position

    def client_write_batch(self, records: list[Record]
                           ) -> list[tuple[str, int]]:
        """Batched client ingress (the worker's coalescing window): every record passes the SAME backpressure/pause gates as
        :meth:`client_write`, then the admitted ones append as ONE raft
        entry — one fsync, one replication round, positions assigned
        contiguously. Returns per-record ``(status, position)`` where
        status is ``"ok"`` | ``"backpressure"`` | ``"unavailable"``."""
        if self.paused or self.disk_paused:
            return [("unavailable", -1)] * len(records)
        results: list[tuple[str, int]] = [("unavailable", -1)] * len(records)
        admitted: list[tuple[int, Record]] = []
        # provisional count: the limiter's in_flight set only grows at
        # on_appended (after the batch appends), so without it every
        # record in the batch would be admitted against the same stale
        # count and one open window could overshoot the adaptive limit by
        # the whole batch size — exactly under the overload that made the
        # window open
        provisional = 0
        for i, record in enumerate(records):
            if self.limiter is not None and not self.limiter.try_acquire(
                    record, provisional=provisional):
                if self.flight is not None:
                    self.flight.record(
                        self.partition_id, "backpressure_reject",
                        limit=self.limiter.limit,
                        valueType=record.value_type.name)
                results[i] = ("backpressure", -1)
            else:
                provisional += 1
                admitted.append((i, record))
        if not admitted:
            return results
        tracer = _TRACER
        traced = tracer.enabled
        t_append = _perf_counter() if traced else 0.0
        last = self.write_commands([r for _, r in admitted])
        if last is None:
            # role lost between the gate and the append: same evidence as
            # client_write returning None (the gateway retries typed)
            return results
        append_dur = (_perf_counter() - t_append) if traced else 0.0
        first = last - len(admitted) + 1
        for offset, (i, record) in enumerate(admitted):
            position = first + offset
            results[i] = ("ok", position)
            self._note_pending_request(record, position)
            if self.limiter is not None:
                self.limiter.on_appended(position)
            if traced:
                tracer.note_append(self.partition_id, position)
                #'s coalesced ingress made this path span-blind: every
                # record in the batch waited the whole one-raft-entry append,
                # so each sampled trace gets the full window (batched=true
                # marks the shared cost for the throughput-minded reader)
                trace_id = f"{self.partition_id}:{position}"
                if tracer.sampled(trace_id):
                    tracer.emit(trace_id, "broker.command_append",
                                append_dur, self.partition_id,
                                attrs={"position": position,
                                       "valueType": record.value_type.name,
                                       "intent": record.intent.name,
                                       "batched": True,
                                       "batchSize": len(admitted)})
        return results

    def write_commands(self, records: list[Record],
                       source_position: int = -1) -> int | None:
        """Leader-only: sequence the records and append to Raft; they become
        processable once committed. Returns the last assigned position."""
        return self.write_entries([LogAppendEntry(r) for r in records],
                                  source_position)

    def write_entries(self, entries: list[LogAppendEntry],
                      source_position: int = -1) -> int | None:
        if self.role != RaftRole.LEADER or not entries:
            return None
        first_position = self._next_position
        payload = self.stream.serialize_batch(entries, first_position, source_position)
        on_commit = None
        if _TRACER.enabled:
            on_commit = self._replicate_span_cb(first_position, len(entries),
                                                source_position)
        index = self.raft.append(payload, asqn=first_position,
                                 on_commit=on_commit)
        if index is None:
            return None
        self._next_position = first_position + len(entries)
        return first_position + len(entries) - 1

    def _replicate_span_cb(self, first_position: int, count: int,
                           source_position: int):
        """Closure for ``raft.append(on_commit=...)``: fires once at quorum
        and emits one ``raft.replicate`` span per distinct sampled ROOT trace
        covered by the entry (append→quorum wall time — the replication wait
        the span set could not see). Capped at 256 records per entry,
        far above any client batch (≤128), so a pathological internal batch
        cannot turn a quorum callback into a span storm."""
        tracer = _TRACER
        partition_id = self.partition_id
        t_append = _perf_counter()

        def _on_commit(_index: int) -> None:
            if not tracer.enabled:
                return
            dur = _perf_counter() - t_append
            emitted: set[str] = set()
            for i in range(min(count, 256)):
                position = first_position + i
                fallback = source_position if source_position >= 0 else position
                root = tracer.resolve_root(partition_id, position, fallback)
                trace_id = f"{partition_id}:{root}"
                if trace_id in emitted or not tracer.sampled(trace_id):
                    continue
                emitted.add(trace_id)
                # `position` names the raft entry (its first record): one
                # root trace legitimately waits on several entries (command
                # append, then its follow-up records), and each wait is a
                # distinct span — the entry position is its identity.
                tracer.emit(trace_id, "raft.replicate", dur, partition_id,
                            parent="processor.ack",
                            attrs={"position": first_position,
                                   "entries": count})

        return _on_commit

    # -- pump (the actor loop, driven by the broker) ---------------------------

    def pump(self) -> int:
        """Advance processing/replay, scheduled work, and exporters.

        Storage-fault containment: the typed corruption errors
        the read paths raise — a cold-store CRC mismatch on fault-in, a
        stream-journal checksum mismatch under replay/export — are caught
        HERE, above the stream processor's blanket failure containment, and
        routed to their repair seams instead of poisoning the pump or
        failing the partition."""
        try:
            return self._pump_inner()
        except ColdCorruptionError as exc:
            self.repair_cold_corruption(str(exc))
            return 1
        except CorruptedJournalError as exc:
            if (exc.path is not None
                    and str(exc.path).startswith(str(self.raft.journal.dir))):
                # raft-journal rot surfaced through a pump-side read (e.g.
                # a compaction-guard seek): raft owns that repair, and its
                # storage_listener records the repair evidence
                if self.scrubber is not None:
                    self.scrubber.note_corruption(
                        "raft", {"corruptIndex": exc.index}, source="read")
                self.raft.repair_journal_corruption(exc)
                return 1
            if self.scrubber is not None:
                self.scrubber.note_corruption(
                    "stream", {"corruptIndex": exc.index}, source="read")
            self.repair_stream_corruption(exc.index)
            return 1

    def _pump_inner(self) -> int:
        work = 0
        if self.processor is None:
            return work
        if self.role == RaftRole.LEADER and self.processor.phase.value == "processing":
            work += self.processor.run_until_idle()
            self.checkers.reschedule()
            self.redistributor.reschedule()
            due = self.processor.schedule_service.next_due_millis
            if due is not None and due <= self.clock_millis():
                work += 1  # scheduled commands were written; next pump processes
        else:
            work += self.processor.replay_available()
            if self.checkers is not None:
                # followers never sweep, but their wheel (fed by replay)
                # must still drop spent deadlines or it grows with every
                # due date ever applied; throttled inside maybe_advance
                self.checkers.maybe_advance_wheel(self.clock_millis())
            if (self._replay_barrier is not None
                    and self.role == RaftRole.LEADER
                    and self.processor.phase == _Phase.REPLAY):
                if self.stream.last_position >= self._replay_barrier:
                    self._finish_leader_recovery()
                elif (self.recovery_budget_ms > 0
                      and not self._barrier_budget_flagged
                      and (_perf_counter() - self._recovery_started) * 1000.0
                      > self.recovery_budget_ms):
                    # the WORST recoveries are ones that never finish (a
                    # barrier stuck on a lost quorum): blow the budget the
                    # moment it is blown, not when/if the barrier clears —
                    # the exceeded counter drives the CRITICAL default alert
                    self._barrier_budget_flagged = True
                    _M_RECOVERY_EXCEEDED.labels(str(self.partition_id)).inc()
        work += self.exporter_director.export_available()
        if self.limiter is not None and self.limiter.in_flight:
            processed = self.processor.last_processed_position
            for position in [p for p in self.limiter.in_flight if p <= processed]:
                self.limiter.on_processed(position)
        self._maybe_snapshot()
        if self.tiering is not None:
            # between transactions by construction: processing/replay above
            # has drained, snapshots never hold a transaction open
            self.tiering.maybe_run()
        if self.scrubber is not None:
            # at-rest integrity walk: throttled, byte-budgeted,
            # between transactions like tiering
            self.scrubber.maybe_run()
        return work

    # -- storage-fault repair seams ---------------------------------

    def _storage_repair_ok(self, target: str) -> bool:
        """Repair-loop guard: the same target repairing twice inside the
        window means the fault is not repairable by that seam — contain it
        like a poison record (processor FAILED, partition unhealthy) instead
        of looping the partition through endless rebuilds."""
        now = _perf_counter()
        last = self._last_storage_repair.get(target, -60.0)
        self._last_storage_repair[target] = now
        if now - last < 5.0:
            if self.processor is not None:
                self.processor.phase = _Phase.FAILED
            if self.flight is not None:
                self.flight.record(self.partition_id, "storage_repair",
                                   target=target, action="gave-up",
                                   complete=False)
                self.flight.dump(f"storage-giveup:partition-"
                                 f"{self.partition_id}", force=True)
            return False
        return True

    def _on_raft_storage_event(self, event: str, detail: dict) -> None:
        """Raft's storage_listener: corruption repairs and fsync failures
        land in the flight recorder (and the scrubber's evidence, which
        the torture gate reads offline)."""
        if event == "journal_repair":
            if self.scrubber is not None:
                self.scrubber.note_repair("raft", "truncate-reconverge",
                                          detail)
            elif self.flight is not None:
                self.flight.record(self.partition_id, "storage_repair",
                                   target="raft",
                                   action="truncate-reconverge", **detail)
        elif event == "journal_unrepairable":
            # the raft repair seam is looping on a fault it cannot fix:
            # contain like a poison record — raft deliberately never raises
            # (its callers are rpc handlers and tick(), whose escape path
            # is the worker's whole poll loop)
            if self.processor is not None:
                self.processor.phase = _Phase.FAILED
            if self.flight is not None:
                self.flight.record(self.partition_id, "storage_repair",
                                   target="raft", action="gave-up",
                                   complete=False, **detail)
                self.flight.dump(f"storage-giveup:partition-"
                                 f"{self.partition_id}", force=True)
        elif self.flight is not None:
            self.flight.record(self.partition_id, "storage_error", **detail)

    def repair_stream_corruption(self, corrupt_index: int | None = None
                                 ) -> dict:
        """Stream-journal corruption repair: the materialized log is DERIVED
        from the raft log, so the repair is truncate-at-the-corrupt-frame +
        re-materialize. The raft compaction guard keeps every record any
        exporter still needs (and everything above the snapshot) in the
        raft log, so the refill is always sufficient: records that can no
        longer be refilled are exactly the ones snapshot + exporter cursors
        already covered."""
        if not self._storage_repair_ok("stream"):
            return {}
        evidence = self.stream_journal.repair_corruption()
        surviving_asqn = self.stream_journal.last_asqn
        # rebuild the LogStream over the repaired journal (its in-memory
        # position maps still describe the truncated suffix)
        self.stream = LogStream(self.stream_journal, self.partition_id,
                                clock=self.clock_millis)
        self.stream_journal.compact_guard = self._stream_compact_guard
        # rewind the applied raft index to the last surviving batch so
        # materialization re-appends the lost suffix from the raft log
        self._applied_raft_index = (
            self.raft.journal.seek_to_asqn(surviving_asqn)
            if surviving_asqn > 0 else 0)
        self._next_position = self.stream.last_position + 1
        evidence.update({"journal": "stream",
                         "corruptIndex": corrupt_index,
                         "rewoundRaftIndex": self._applied_raft_index})
        self._materialize_committed()
        self._transition()  # rebuild the vertical over the repaired log
        if self.scrubber is not None:
            self.scrubber.note_repair("stream", "truncate-rematerialize",
                                      evidence)
        elif self.flight is not None:
            self.flight.record(self.partition_id, "storage_repair",
                               target="stream",
                               action="truncate-rematerialize", **evidence)
        return evidence

    def repair_snapshot_corruption(self, detail: dict | None = None) -> dict:
        """Snapshot corruption repair (tip or mid-chain): QUARANTINE the
        corrupt member (renamed out of the recovery path — the chain
        validator, queries, and a later recovery all skip it), then
        re-anchor: a leader takes a fresh FULL snapshot from its live
        state; a follower asks the leader to stream an install
        (``receive_snapshot`` persists it). An idle partition that cannot
        produce a newer snapshot id yet re-anchors at its next periodic
        snapshot — recovery meanwhile falls back to the older valid chain
        (single-replica clusters with a compacted log can only truncate;
        docs/durability.md carries that caveat honestly)."""
        from zeebe_tpu_torch.state.snapshot import SnapshotId

        detail = detail or {}
        snap_id_str = detail.get("snapshotId")
        evidence: dict = {"snapshotId": snap_id_str}
        snap_id = SnapshotId.parse(snap_id_str) if snap_id_str else None
        quarantined = None
        snap = (self.snapshot_store.snapshot_at(snap_id)
                if snap_id is not None else None)
        if snap is not None:
            quarantined = self.snapshot_store.quarantine(snap)
            evidence["quarantined"] = (str(quarantined)
                                       if quarantined else None)
        # the corrupt member may sit anywhere in the live chain: drop the
        # anchor so the next snapshot rebases to a FULL one, and invalidate
        # the compaction-bound memo (it may have trusted the dead chain)
        self._snapshot_anchor = None
        self._chain_len = 0
        self._compact_bound_memo = (None, -1)
        action = "pending"
        if self.role == RaftRole.LEADER:
            try:
                if self.take_snapshot(force_full=True):
                    action = "fresh-full-snapshot"
            except OSError:
                pass  # disk still failing; retried on a later scrub pass
        elif self.raft.request_snapshot():
            action = "requested-install"
        evidence["action"] = action
        # "pending" (no leader to ask, or the fresh snapshot itself failed
        # on the still-faulting disk) must keep the DEGRADED latch so the
        # scrubber's per-cycle retry actually fires; quarantine alone is
        # only half the repair
        complete = (snap is None
                    or (quarantined is not None and action != "pending"))
        if self.scrubber is not None:
            self.scrubber.note_repair("snapshot", action, evidence,
                                      complete=complete)
        elif self.flight is not None:
            self.flight.record(self.partition_id, "storage_repair",
                               target="snapshot", action=action, **evidence)
        return evidence

    def repair_cold_corruption(self, reason: str) -> dict:
        """Cold-store corruption repair (read-side parity with's
        write-side degradation): latch tiering DEGRADED, then TRANSITION —
        the cold tier is a cache, so the rebuild from chain + log (which
        wipes the cold dir) restores every value the rotten frame held.
        The pump survives; nothing is served from the bad frame."""
        if not self._storage_repair_ok("cold"):
            return {}
        from zeebe_tpu_torch.state.tiering import note_cold_read_error

        evidence = {"reason": str(reason)[:300]}
        note_cold_read_error(self.partition_id)
        if self.tiering is not None:
            self.tiering.degraded = True
            self.tiering.degraded_reason = evidence["reason"]
        self._transition()
        if self.scrubber is not None:
            self.scrubber.note_repair("cold", "transition-rebuild", evidence)
        elif self.flight is not None:
            self.flight.record(self.partition_id, "storage_repair",
                               target="cold", action="transition-rebuild",
                               **evidence)
        return evidence

    # -- snapshotting (AsyncSnapshotDirector equivalent) -----------------------

    def _maybe_snapshot(self) -> None:
        now = self.clock_millis()
        if now - self._last_snapshot_ms >= self.snapshot_period_ms:
            self._last_snapshot_ms = now
            self.take_snapshot()
            return
        # adaptive cadence: between periodic snapshots, project the
        # replay debt (records a restart would replay) against the recovery
        # budget at the last MEASURED replay rate; snapshot early when the
        # projection passes REPLAY_DEBT_BUDGET_FRACTION of the budget.
        # Throttled to one projection per second — the pump is hot.
        if self.recovery_budget_ms <= 0:
            return
        if now - self._last_debt_check_ms < 1000:
            return
        self._last_debt_check_ms = now
        debt = self.stream.last_position - max(self._last_snapshot_processed, 0)
        pid = str(self.partition_id)
        _M_REPLAY_DEBT.labels(pid).set(float(max(debt, 0)))
        if debt <= 0:
            return
        projected_ms = debt * 1000.0 / self._observed_replay_rate
        if projected_ms <= self.recovery_budget_ms * REPLAY_DEBT_BUDGET_FRACTION:
            return
        if self.take_snapshot():
            # reset the period clock only on success: a transiently-declined
            # attempt (mid-pipeline, not-newer) must not push the next
            # PERIODIC snapshot out a full period while debt keeps growing
            self._last_snapshot_ms = now
            _M_ADAPTIVE_SNAPSHOTS.labels(pid).inc()
            self.adaptive_snapshot_count += 1
            # this pre-dated the control plane but IS a closed feedback
            # loop: its decisions record under the shared control_adjust
            # vocabulary so `cli top` CONTROL shows every loop
            from zeebe_tpu_torch.control.audit import record_adjust

            record_adjust(
                self.flight, self.partition_id,
                controller="snapshot-scheduler", knob="snapshot.cadence",
                before=round(projected_ms, 1), after=0,
                reason="snapshot early: projected replay debt threatened "
                       "recovery_budget_ms",
                signals={"debtRecords": debt,
                         "projectedReplayMs": round(projected_ms, 1),
                         "budgetMs": self.recovery_budget_ms})

    def take_snapshot(self, force_full: bool = False) -> bool:
        """Snapshot the db at lastProcessedPosition, then compact both logs up
        to min(processed, exported) (reference: AsyncSnapshotDirector.java:37 —
        wait for commit, persist, then Raft compacts).

        Incremental mode (non-durable state): when the db's changed-key set
        is anchored on the store's current tip and the chain is short enough,
        the snapshot is a DELTA (changed keys since the tip) — O(delta)
        instead of O(state). The chain rebases to a full snapshot every
        ``snapshot_chain_length`` links, when the delta would approach the
        full state's size, or on ``force_full`` (backups)."""
        if self.processor is None or self.db is None:
            return False
        processed = self.processor.last_processed_position
        if processed < 0:
            return False
        # the reference waits until lastWrittenPosition is committed before
        # persisting (AsyncSnapshotDirector): our materialized stream journal
        # IS the committed prefix, so written-but-unmaterialized means wait
        if self.processor.last_written_position > self.stream.last_position:
            return False
        import time as _time

        from zeebe_tpu_torch.utils.metrics import REGISTRY

        snapshot_started = _time.perf_counter()
        exported = self.exporter_director.lowest_exporter_position()
        term = self.raft.current_term
        raft_index = self.raft.journal.seek_to_asqn(processed)
        if raft_index <= 0:
            raft_index = self.raft.snapshot_index
        try:
            transient = self.snapshot_store.new_transient_snapshot(
                raft_index, term, processed, exported if exported < 2**62 else processed
            )
        except Exception:
            return False  # not newer than the latest snapshot
        return self._write_and_persist_snapshot(
            transient, processed, exported, force_full,
            snapshot_started=snapshot_started)

    def _write_and_persist_snapshot(self, transient, processed: int,
                                    exported: int, force_full: bool,
                                    snapshot_started: float) -> bool:
        import time as _time

        from zeebe_tpu_torch.utils.metrics import REGISTRY

        try:
            return self._write_and_persist_snapshot_inner(
                transient, processed, exported, force_full,
                snapshot_started, _time, REGISTRY)
        except OSError:
            # disk fault mid-snapshot: abort the transient (the
            # half-written pending dir must not survive) and decline — the
            # periodic/adaptive scheduler retries; recovery still has the
            # previous valid chain
            transient.abort()
            _M_SNAPSHOT_WRITE_FAILURES.labels(str(self.partition_id)).inc()
            return False

    def _write_and_persist_snapshot_inner(self, transient, processed: int,
                                          exported: int, force_full: bool,
                                          snapshot_started: float,
                                          _time, REGISTRY) -> bool:
        kind = "full"
        if self.durable_state:
            # O(delta): fsync the durable delta log + manifest; the snapshot
            # entry only carries bookkeeping (positions for recovery-ordering
            # and the raft compaction boundary) — reference: RocksDB
            # checkpoints are hard links, not value copies
            kind = "durable"
            manifest = self.db.checkpoint()
            transient.write_file("durable.bin", packb({"manifest": manifest}))
        else:
            anchor = (self.snapshot_store.snapshot_at(self._snapshot_anchor)
                      if self._snapshot_anchor is not None else None)
            dirty = getattr(self.db, "dirty_key_count", 0)
            # a delta at least as large (in entries) as the full state saves
            # nothing — rebase; likewise when the chain is at its length cap,
            # the anchor vanished (purge race / manual cleanup), or the
            # caller wants a self-contained snapshot (backups, installs)
            if (not force_full
                    and anchor is not None
                    and self.db.supports_delta_snapshots
                    and getattr(self.db, "delta_tracking", False)
                    and self._chain_len >= 1
                    and self._chain_len < self.snapshot_chain_length
                    and dirty < max(self.db.key_count, 1)):
                kind = "delta"
                transient.write_file(DELTA_FILE, self.db.to_delta_bytes())
                transient.link_parent(anchor, self._chain_len + 1)
            else:
                transient.write_file(STATE_FILE, self.db.to_snapshot_bytes())
        transient.write_file("meta.bin", packb({
            "lastProcessed": processed,
            "lastPosition": self.stream.last_position,
        }))
        persist_started = _time.perf_counter()
        snapshot = transient.persist()
        # chain bookkeeping only after the snapshot is durably committed: an
        # aborted persist must not clear the changed-key window (those keys
        # would silently fall out of the next delta)
        self._chain_len = self._chain_len + 1 if kind == "delta" else 1
        self._snapshot_anchor = snapshot.id
        self._last_snapshot_processed = processed
        # prime the compaction-bound memo: we just validated this tip by
        # persisting it — without this, every guard invocation after a
        # persist re-reads and CRCs the whole chain (the base is O(state))
        self._compact_bound_memo = (snapshot.id, processed)
        if not self.durable_state and self.db.supports_delta_snapshots:
            # the new tip covers everything up to `processed`; the next delta
            # records exactly the writes after it. The durable store opts
            # out: its _data holds _Packed/memoryview cold values a delta
            # could not serialize (DURABLESTATE-flag-flipped migrations
            # recover a DurableZbDb even with durable_state now False)
            self.db.begin_delta_tracking()
        pid = str(self.partition_id)
        _M_SNAPSHOT_KIND.labels(pid, kind).inc()
        _M_SNAPSHOT_CHAIN_LEN.labels(pid).set(float(self._chain_len))
        _M_REPLAY_DEBT.labels(pid).set(
            float(max(self.stream.last_position - processed, 0)))
        REGISTRY.counter(
            "snapshot_count", "snapshots persisted", ("partition",)
        ).labels(pid).inc()
        elapsed = _time.perf_counter() - snapshot_started
        REGISTRY.histogram(
            "snapshot_duration_seconds", "time to persist a snapshot",
            ("partition",)
        ).labels(pid).observe(elapsed)
        REGISTRY.histogram(
            "snapshot_duration", "time to take+persist a snapshot, seconds",
            ("partition",)).labels(pid).observe(elapsed)
        REGISTRY.histogram(
            "snapshot_persist_duration",
            "time to persist the transient snapshot, seconds",
            ("partition",)).labels(pid).observe(
            _time.perf_counter() - persist_started)
        try:
            size = 0
            chunks = 0
            for f in snapshot.path.rglob("*"):
                if f.is_file():
                    size += f.stat().st_size
                    chunks += 1
            REGISTRY.gauge(
                "snapshot_size_bytes", "bytes of the latest snapshot",
                ("partition",)).labels(pid).set(size)
            REGISTRY.gauge(
                "snapshot_file_size_megabytes",
                "megabytes of the latest snapshot", ("partition",)
            ).labels(pid).set(size / 1e6)
            REGISTRY.gauge(
                "snapshot_chunks_count",
                "files in the latest snapshot", ("partition",)
            ).labels(pid).set(chunks)
        except OSError:
            pass
        # raft log compaction bound: nothing above the snapshot index, nothing
        # unexported, nothing unmaterialized
        compact_position = min(processed, exported)
        compact_index = self.raft.journal.seek_to_asqn(compact_position)
        if compact_index > 1:
            # the snapshot boundary's term is the term of the entry it replaces
            # (not the current term) or _entry_term answers wrongly at the
            # boundary and replication backs up into a needless snapshot install
            boundary_term = self.raft.entry_term(compact_index - 1)
            # durable mode and delta snapshots have no self-contained
            # state.bin to store as a fallback install payload — pass None so
            # installs are served only by the live ``snapshot_provider``
            # (which materializes the chain), and when it declines, nothing
            # is sent (b"" would ship a torn install: journal reset + unpackb
            # crash on the receiver)
            self.raft.set_snapshot(
                compact_index - 1, boundary_term,
                self._install_payload(snapshot)
                if kind == "full" else None,
            )
        # the materialized stream journal compacts to the same bound (whole
        # segments only); its compact_guard re-derives the invariant from the
        # store + exporter cursors below this caller, so a stale `exported`
        # here can never over-delete
        self.stream.compact_to_position(compact_position)
        return True

    # -- snapshot replication (leader → lagging follower) ----------------------

    def _install_payload(self, snapshot) -> bytes:
        return packb({
            "state": snapshot.read_file("state.bin"),
            "meta": snapshot.read_file("meta.bin"),
        })

    def _provide_install_snapshot(self):
        if self.durable_state:
            # build the payload live from the durable store (rare path: a
            # follower fell behind the compacted log). Meta must describe the
            # LIVE state dump, not the last checkpoint — the receiver aligns
            # its stream to meta.lastPosition and the state's own
            # lastProcessed marker
            if self.db is None or self.processor is None or self.db.in_transaction:
                return None
            return (self.raft.snapshot_index, self.raft.snapshot_term, packb({
                "state": self.db.to_snapshot_bytes(),
                "meta": packb({
                    "lastProcessed": self.processor.last_processed_position,
                    "lastPosition": self.stream.last_position,
                }),
            }))
        chain = self.snapshot_store.latest_valid_chain()
        if chain is None or not chain[0].has_file(STATE_FILE):
            return None
        if len(chain) == 1:
            payload = self._install_payload(chain[0])
        else:
            # delta tip: the receiver installs a SELF-CONTAINED state blob
            # (followers know nothing about the leader's local chain), so
            # materialize base+deltas into one state.bin equivalent
            try:
                payload = packb({
                    "state": load_chain_db(chain).to_snapshot_bytes(),
                    "meta": chain[-1].read_file("meta.bin"),
                })
            except (OSError, ValueError):
                return None
        return (self.raft.snapshot_index, self.raft.snapshot_term, payload)

    def _receive_install_snapshot(self, data: bytes) -> None:
        """Follower fell behind the leader's compacted log: replace local state
        wholesale (reference: PassiveRole + FileBasedReceivedSnapshot →
        StateControllerImpl recover)."""
        payload = unpackb(data)
        meta = unpackb(payload["meta"])
        # persist locally so restart recovers from it
        try:
            transient = self.snapshot_store.new_transient_snapshot(
                self.raft.snapshot_index, self.raft.snapshot_term,
                meta["lastProcessed"], meta["lastProcessed"],
            )
            transient.write_file("state.bin", payload["state"])
            transient.write_file("meta.bin", payload["meta"])
            transient.persist()
        except Exception:
            pass  # not newer than what we have
        # reset the stream journal past the snapshot and rebuild the vertical
        self.stream_journal.close()
        shutil.rmtree(self._stream_dir, ignore_errors=True)
        self.stream_journal = SegmentedJournal(self._stream_dir)
        # the rebuilt journal must keep the compaction safety guard — losing
        # it here would leave every later compact() on this node unguarded
        self.stream_journal.compact_guard = self._stream_compact_guard
        self.stream = LogStream(self.stream_journal, self.partition_id,
                                clock=self.clock_millis)
        self.stream._next_position = meta["lastPosition"] + 1
        self._next_position = meta["lastPosition"] + 1
        # re-anchor materialization at the installed snapshot: entries below
        # it are covered by the snapshot, entries above it refill from the
        # (reset) raft log. Without this, a NON-lagging follower that
        # requested an install as a snapshot-corruption repair
        # would skip the refilled entries — its applied index still pointed
        # past them from the pre-install log.
        self._applied_raft_index = self.raft.snapshot_index
        self._transition()

    # -- lifecycle -------------------------------------------------------------

    def tick(self) -> None:
        self.raft.tick()

    def close(self) -> None:
        if self.exporter_director is not None:
            self.exporter_director.close()
        self.raft.close()
        self.stream_journal.close()
        if self.db is not None:
            from zeebe_tpu_torch.state.durable import DurableZbDb
            from zeebe_tpu_torch.state.tiering import TieredZbDb

            if isinstance(self.db, (DurableZbDb, TieredZbDb)):
                self.db.close()

    def hard_crash(self) -> None:
        """Power-loss crash simulation (chaos harness flush-boundary fault):
        unlike ``close``, nothing flushes — both journals discard every byte
        not covered by an fsync (buffered appends AND file bytes written
        since the last flush), exactly what surviving hardware would hold
        after losing power between a buffered append and its covering flush.
        Exporters/state are simply abandoned; recovery rebuilds them."""
        self.raft.journal.simulate_power_loss()
        self.stream_journal.simulate_power_loss()

    def latest_checkpoint_id(self) -> int:
        """Lock-free: read by OTHER partitions' ownership threads on every
        inter-partition send — must never open this partition's db (the owner
        thread may be mid-transaction). The cache refreshes at transition and
        on every checkpoint-created apply."""
        return self._latest_checkpoint

    def _observe_checkpoint_applied(self, checkpoint_id: int) -> None:
        self._latest_checkpoint = max(self._latest_checkpoint, checkpoint_id)
        if self.on_checkpoint is not None:
            # broker-level cache (max over local replicas) follows along —
            # on followers too, which the processing listener never covers
            self.on_checkpoint(checkpoint_id)

    def _on_checkpoint_created(self, checkpoint_id: int, position: int) -> None:
        self._latest_checkpoint = max(self._latest_checkpoint, checkpoint_id)
        if self.on_checkpoint is not None:
            self.on_checkpoint(checkpoint_id)
        if self.backup_service is not None:
            self.backup_service.take_backup(self, checkpoint_id, position)

    def _report_exporter_health(self, exporter_id: str, status,
                                message: str = "") -> None:
        """Per-exporter health sub-component under this partition (a backing-
        off exporter degrades the broker without taking the partition down)."""
        if (self.flight is not None
                and self._exporter_flight_status.get(exporter_id) != status):
            # transitions only: a backing-off exporter re-reports DEGRADED on
            # every retry, which would crowd everything else out of the ring
            self._exporter_flight_status[exporter_id] = status
            self.flight.record(self.partition_id, "exporter_state",
                               exporter=exporter_id, status=status.name,
                               message=message)
        if self.health_monitor is not None:
            self.health_monitor.report(
                f"partition-{self.partition_id}.exporter-{exporter_id}",
                status, message)

    @property
    def is_leader(self) -> bool:
        return self.role == RaftRole.LEADER

    def health(self) -> dict:
        return {
            "partitionId": self.partition_id,
            "role": self.role.value,
            "term": self.raft.current_term,
            "commitIndex": self.raft.commit_index,
            "lastPosition": self.stream.last_position,
            "lastProcessed": self.processor.last_processed_position
            if self.processor else -1,
            # recovery-budget plane: the last rebuild's cost (duration,
            # replay length, chain, budget verdict) — the soak harness and
            # operators read this off /health after every restart
            "lastRecovery": self.last_recovery,
            "snapshotChainLength": self._chain_len,
            # state tiering: parked-instance + tier accounting —
            # /cluster/status and `cli top` surface these
            **({"stateTiering": {
                **self.db.tier_stats(),
                "parkedColdInstances": self.tiering.spilled_instances,
                "parkCandidates": self.tiering.pending_candidates,
                # write-error degradation: ENOSPC/EIO
                # during spill stops admissions without killing the pump
                "status": ("DEGRADED" if self.tiering.degraded
                           else "HEALTHY"),
                **({"degradedReason": self.tiering.degraded_reason}
                   if self.tiering.degraded else {}),
            }} if self.tiering is not None and self.db is not None
               and hasattr(self.db, "tier_stats") else {}),
            # kernel-path coverage: which records rode the
            # device plane vs host, and why — the ruler ROADMAP item 3's
            # "≥90% on the kernel path" is graded with
            **({"kernelCoverage": {
                **self.processor.kernel_backend.accounting.snapshot(),
                # device-fault defense: health ladder state +
                # shadow counters, so a quarantine explains its own
                # coverage drop in the same block
                "device": self.processor.kernel_backend.device_status(),
            }} if self.processor is not None
               and self.processor.kernel_backend is not None else {}),
            # at-rest storage integrity: scrub coverage,
            # detections, repairs, and the DEGRADED latch while a repair
            # is still pending
            **({"storageIntegrity": self.scrubber.status()}
               if self.scrubber is not None else {}),
        }
    # end of the copy
