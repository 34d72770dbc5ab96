"""Broker: one node hosting a set of partition replicas.

The counterpart of ``zeebe_tpu/broker/broker.py``, copied
(``testing/copies.py`` writes the marked runs) but for the kernel backend's
``device``: ``BrokerCfg.device`` (None = CUDA, raising without it;
``"cpu"`` runs the plain version) reaches every partition's
``KernelBackend`` and the broker's own mesh runner. The auto mesh counts
the CUDA cards in a killable child (``utils/backend_probe.py``) and is 1 on
the CPU, so it turns on only where two or more cards answer. The count
sizes the mesh alone: every shard block of the port's mesh lies on one
card (``parallel.mesh.make_mesh``) until shards spread over cards.

``InProcessCluster`` is the ClusteringRule equivalent (qa/integration-tests
ClusteringRule.java:105): N brokers in one process over the loopback network,
with a deterministic pump — the primary multi-node test harness. The port's
takes ``kernel_backend`` and ``device`` for every broker it starts.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Any, Callable

from zeebe_tpu_torch.broker.partition import ZeebePartition
from zeebe_tpu_torch.cluster.membership import MembershipService
from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork, MessagingService
from zeebe_tpu_torch.cluster.raft import ELECTION_TIMEOUT_MS
from zeebe_tpu_torch.protocol import Record
from zeebe_tpu_torch.protocol.msgpack import packb, unpackb

# copied from the reference: INTER_PARTITION_TOPIC .. COMMAND_API_TOPIC
INTER_PARTITION_TOPIC = "inter-partition"  # + "-<partition id>"
COMMAND_API_TOPIC = "command-api"  # + "-<partition id>"
# end of the copy


@dataclasses.dataclass
class BrokerCfg:
    """The `zeebe.broker.*` configuration subset that shapes the cluster
    (reference: system/configuration/BrokerCfg.java, ClusterCfg)."""

    node_id: str = "broker-0"
    partition_count: int = 1
    replication_factor: int = 1
    cluster_members: list[str] = dataclasses.field(default_factory=lambda: ["broker-0"])
    snapshot_period_ms: int = 5 * 60 * 1000
    consistency_checks: bool = True
    # the device-kernel batched execution backend behind the stream processor
    # (reference: FeatureFlagsCfg-style gate). ON by default: the serving
    # path IS the kernel path; eligible commands batch onto the device,
    # everything else falls through to the sequential engine unchanged.
    kernel_backend: bool = True
    # > 0: the partitions' kernel groups run as shards of ONE device mesh
    # (parallel/mesh_runner.py) — partition = shard of the device batch.
    # -1 (default) = auto: shard over jax.devices() when more than one
    # device is attached, single-device otherwise. 0 = explicitly off.
    # A shared MeshKernelRunner may also be injected by the hosting runtime
    # (ClusterRuntime) so in-process brokers share a single mesh.
    kernel_mesh_shards: int = -1
    # the kernel backend's device: None = CUDA (raising without it), "cpu"
    # = the plain PyTorch version
    device: Any = None
    # disk-backed state with O(delta) checkpoints (state/durable.py) — the
    # large-state backend (reference: RocksDB zb-db + its checkpoint story).
    # Off by default: the in-memory store wins below ~100 MB of state.
    durable_state: bool = False
    # metrics plane (observability/timeseries.py): registry sampling cadence
    # for the in-memory time-series store + alert evaluation. 0 disables the
    # whole plane — no store, no sampler, one is-None check per control pump.
    metrics_sampling_ms: int = 250
    # continuous profiling plane (observability/profiler.py): stack sampling
    # rate of the always-on folded-stack profiler. 0 disables it (one is-None
    # check); the ~19 Hz default is a prime rate (GWP-style: cannot alias
    # against millisecond-periodic work) cheap enough to leave on.
    profiling_hz: float = 19.0
    # recovery-time budget: a partition rebuild (snapshot install +
    # replay) slower than this increments recovery_budget_exceeded_total
    # (default alert rule recovery_budget_exceeded) and the snapshot
    # scheduler snapshots early when projected replay debt threatens the
    # budget. <= 0 disables budget enforcement (metrics still emit).
    recovery_budget_ms: int = 60_000
    # max incremental-snapshot chain length (base + deltas) before the next
    # snapshot rebases to a full one; 1 = every snapshot is full
    snapshot_chain_length: int = 8
    # state tiering: spill parked process instances (waiting on
    # timers/messages/jobs past tiering_park_after_ms) from the hot dict to
    # a disk-backed cold store, faulting back in transparently on wake —
    # bounded RSS under a million-instance parked backlog. Off by default;
    # DURABLESTATE supersedes it (the durable backend has its own tiers).
    tiering: bool = False
    tiering_park_after_ms: int = 30_000
    tiering_spill_batch: int = 256
    # raft journal group-commit pacing: 0 = fsync before every
    # ack (the reference default); > 0 = defer the fsync up to this many ms
    # (or max_unflushed_bytes), with acks strictly AFTER the covering fsync
    # — the journal-flush controller's knob surface
    log_flush_delay_ms: int = 0
    log_max_unflushed_bytes: int = 1 << 20
    # closed-loop control plane: controllers tick off the pump
    # and drive the knob surface from the time-series store; requires the
    # metrics plane (its sensor). Off = the plane is not constructed.
    control: bool = True
    # at-rest storage scrubber: pump-throttled background CRC
    # walk over sealed journal bytes, snapshot chain files, and cold-store
    # segments — bit rot is detected (and repaired) before a read serves
    # it. ON by default: the budget bounds the pump cost per slice.
    scrub: bool = True
    scrub_interval_ms: int = 1_000
    scrub_bytes_per_pass: int = 4 << 20


# copied from the reference: _AUTO_DEVICE_COUNT .. _AUTO_DEVICE_COUNT
_AUTO_DEVICE_COUNT: int | None = None
# end of the copy


def _auto_device_count(device=None) -> int:
    """Device count for kernel_mesh_shards auto mode. On the CPU it is 1 (the
    plain version has one device). On CUDA it is the number of cards,
    resolved ONCE per process by probing in a killable subprocess: a wedged
    driver can hang the first CUDA call, and broker startup must never block
    on it. Probe failure = 0 (no mesh). The count only sizes the mesh: the
    port's mesh puts every shard block on one card, so on a host of two
    cards the second stays idle until shards spread over cards."""
    import torch

    global _AUTO_DEVICE_COUNT
    if torch.device("cuda" if device is None else device).type == "cpu":
        return 1
    if _AUTO_DEVICE_COUNT is None:
        from zeebe_tpu_torch.utils.backend_probe import probe_default_backend

        probed = probe_default_backend()
        _AUTO_DEVICE_COUNT = 0 if probed is None or probed[0] != "cuda" else probed[1]
    return _AUTO_DEVICE_COUNT


# copied from the reference: partition_distribution .. resolve_leader_partition
def partition_distribution(cfg: BrokerCfg) -> dict[int, list[str]]:
    """Round-robin partition→members assignment (reference:
    RoundRobinPartitionDistributor): partition p starts at member
    (p-1) % n and takes the next replication_factor members."""
    n = len(cfg.cluster_members)
    members = sorted(cfg.cluster_members)
    out: dict[int, list[str]] = {}
    for p in range(1, cfg.partition_count + 1):
        start = (p - 1) % n
        out[p] = [members[(start + i) % n] for i in range(min(cfg.replication_factor, n))]
    return out


class ClusterInterPartitionSender:
    """InterPartitionCommandSenderImpl equivalent: resolve the partition leader
    and ship the command over cluster messaging (topic inter-partition-<id>,
    reference: broker/…/partitionapi/InterPartitionCommandSenderImpl.java:27-80)."""

    def __init__(self, broker: "Broker") -> None:
        self.broker = broker

    def send_command(self, receiver_partition_id: int, record: Record) -> None:
        leader = self.broker.known_leader(receiver_partition_id)
        if leader is None:
            return  # no known leader: the redistributor/checker will retry
        # piggyback the checkpoint id: the receiver creates the checkpoint
        # BEFORE processing, keeping cluster-wide backups consistent
        # (reference: InterPartitionCommandSenderImpl checkpoint-id prefix)
        payload = {"record": record.to_bytes(), "key": record.key,
                   "checkpointId": self.broker.latest_checkpoint_id()}
        self.broker.messaging.send(
            leader, f"{INTER_PARTITION_TOPIC}-{receiver_partition_id}", payload
        )


def resolve_leader_partition(brokers, partition_id: int):
    """The partition replica that currently owns leadership: during failover a
    deposed-but-isolated leader may still claim the role; the highest term wins
    (the gateway resolves the same way via gossiped topology)."""
    best, best_term = None, -1
    for b in brokers:
        p = b.partitions.get(partition_id)
        if p is not None and p.is_leader and p.raft.current_term > best_term:
            best, best_term = p, p.raft.current_term
    return best
# end of the copy


class Broker:
    # copied from the reference: __init__ .. partition_guard
    def __init__(self, cfg: BrokerCfg, messaging: MessagingService,
                 directory: str | Path | None = None,
                 clock_millis: Callable[[], int] | None = None,
                 exporters_factory: Callable[[], dict[str, Any]] | None = None,
                 response_sink: Callable[[Any], None] | None = None,
                 backup_store: Any | None = None,
                 backup_store_directory: str | Path | None = None,
                 backpressure_algorithm: str = "vegas",
                 backpressure_enabled: bool = True,
                 disk_min_free_bytes: int = 0,
                 mesh_runner=None) -> None:
        import time

        from zeebe_tpu_torch.broker.disk import DiskSpaceMonitor
        from zeebe_tpu_torch.utils.health import CriticalComponentsHealthMonitor
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        self.cfg = cfg
        self.messaging = messaging
        self._injected_mesh_runner = mesh_runner
        self._owned_mesh_runner = None
        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory()
            directory = self._tmp.name
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        self.disk_monitor = (
            DiskSpaceMonitor(self.directory, disk_min_free_bytes,
                             clock_millis=self.clock_millis)
            if disk_min_free_bytes > 0 else None
        )
        self.membership = MembershipService(
            messaging, cfg.cluster_members, self.clock_millis
        )
        self.health_monitor = CriticalComponentsHealthMonitor(cfg.node_id)
        # metrics plane: flight recorder always on (recording is O(1) deque
        # appends); time-series store + sampler + alerts gated by cfg
        from zeebe_tpu_torch.observability.flight_recorder import (
            FlightRecorder,
            install_journal_stall_listener,
        )

        self.flight_recorder = FlightRecorder(
            cfg.node_id, self.directory, clock_millis=self.clock_millis)
        install_journal_stall_listener(self.flight_recorder)
        # continuous profiling plane: always-on folded-stack sampler (gated
        # by cfg like the metrics plane), alert-triggered capture into the
        # flight recorder, and the single-flight on-demand device capture.
        # Importing the module also registers the xla-compile / device-memory
        # metric families the kernel seam and the pump sampler feed.
        from zeebe_tpu_torch.observability import profiler as profiler_mod

        self._profiler_mod = profiler_mod
        if cfg.profiling_hz > 0:
            # process-global sampler, leased: an in-process multi-broker
            # cluster shares ONE sampling daemon instead of stacking N
            self.profiler, self._profiler_lease = (
                profiler_mod.acquire_profiler(
                    hz=cfg.profiling_hz, clock_millis=self.clock_millis))
            # dumps carry the recent hot stacks alongside the event rings
            self.flight_recorder.add_context_provider(
                lambda: {"profile": self.profiler.snapshot_summary()})
        else:
            self.profiler: profiler_mod.ContinuousProfiler | None = None
            self._profiler_lease: object | None = None
        self._alert_profile_capture = profiler_mod.AlertProfileCapture(
            self.flight_recorder, self.profiler,
            clock_millis=self.clock_millis)
        self.device_capture = profiler_mod.DeviceTraceCapture(self.directory)
        if cfg.metrics_sampling_ms > 0:
            from zeebe_tpu_torch.observability.alerts import AlertEvaluator
            from zeebe_tpu_torch.observability.timeseries import (
                MetricsSampler,
                TimeSeriesStore,
            )
            from zeebe_tpu_torch.utils.metrics import install_process_metrics

            # the rss_watermark default rule reads the process self-metrics
            # gauge: make sure it exists wherever the alert plane runs
            # (idempotent; refresh rides the sampler's collect hooks)
            install_process_metrics(REGISTRY)
            self.timeseries: TimeSeriesStore | None = TimeSeriesStore()
            self.sampler: MetricsSampler | None = MetricsSampler(
                REGISTRY, self.timeseries,
                interval_ms=cfg.metrics_sampling_ms,
                clock_millis=self.clock_millis)
            self.alerts: AlertEvaluator | None = AlertEvaluator(
                self.timeseries, node_id=cfg.node_id,
                on_transition=self._on_alert_transition)
            # dumps carry the alert state alongside the event rings
            self.flight_recorder.add_context_provider(
                lambda: {"alerts": self.alerts.snapshot()})
            # the fleet auditor rides the same cadence: online
            # invariant monitors + burn-rate + leak trends; its burn-rate
            # rules append onto self.alerts, so it constructs after it
            from zeebe_tpu_torch.observability.auditor import BrokerAuditor

            self.auditor: BrokerAuditor | None = BrokerAuditor(self)
        else:
            self.timeseries = None
            self.sampler = None
            self.alerts = None
            self.auditor = None
        self.health_monitor.add_listener(self._on_health_transition)
        self._metrics = {
            "written": REGISTRY.counter(
                "log_appender_record_appended_total",
                "records appended to partition logs", ("node", "partition")),
            "dropped": REGISTRY.counter(
                "backpressure_requests_dropped_total",
                "client commands rejected by backpressure", ("node", "partition")),
            "inflight": REGISTRY.gauge(
                "backpressure_inflight_requests_count",
                "commands appended but not yet processed", ("node", "partition")),
            "role": REGISTRY.gauge(
                "raft_role", "1=leader 0=follower", ("node", "partition")),
            "term": REGISTRY.gauge(
                "raft_term", "current raft term", ("node", "partition")),
            "commit": REGISTRY.gauge(
                "raft_commit_index", "raft commit index", ("node", "partition")),
            "processed": REGISTRY.gauge(
                "stream_processor_last_processed_position",
                "last processed record position", ("node", "partition")),
            "exported": REGISTRY.gauge(
                "exporter_last_exported_position",
                "lowest acked exporter position (lag = appended - this)",
                ("node", "partition")),
            "snapshot": REGISTRY.gauge(
                "snapshot_index", "raft index of the latest snapshot",
                ("node", "partition")),
            "health": REGISTRY.gauge(
                "health", "0=healthy 1=degraded 2=unhealthy 3=dead", ("node",)),
            "join_time": REGISTRY.histogram(
                "partition_server_join_time",
                "seconds to join a partition at runtime", ("partition",)),
            # state-tiering plane
            "state_keys": REGISTRY.gauge(
                "state_keys",
                "committed state keys per column family",
                ("node", "partition", "cf")),
            "tier_bytes": REGISTRY.gauge(
                "state_tier_bytes",
                "state bytes per tier (hot = estimated packed size of "
                "resident values, cold = exact live cold-store bytes)",
                ("node", "partition", "tier")),
            "parked": REGISTRY.gauge(
                "state_parked_instances",
                "process instances parked in a wait state and spilled cold, "
                "plus pending park candidates",
                ("node", "partition", "kind")),
        }
        # cf-gauge children already emitted per partition: a CF that empties
        # must drop to 0, not freeze at its last count
        self._state_cf_seen: dict[int, set[str]] = {}
        self._state_gauges_ms = 0
        self.responses: list = []
        # per-partition ownership guard (set by ClusterRuntime): topology-
        # driven partition lifecycle must not close journals under a pump
        # running on that partition's ownership thread
        self._partition_guard: Callable[[int], Any] | None = None
        sink = response_sink if response_sink is not None else self.responses.append
        backup_service = None
        if backup_store is not None:
            # remote store instance (S3BackupStore / GcsBackupStore) supplied
            # by the operator shell (reference: backup-stores selection via
            # zeebe.broker.data.backup.store config)
            from zeebe_tpu_torch.backup import BackupService

            self.backup_store = backup_store
            backup_service = BackupService(self.backup_store, cfg.node_id)
        elif backup_store_directory is not None:
            from zeebe_tpu_torch.backup import BackupService, FileSystemBackupStore

            self.backup_store = FileSystemBackupStore(backup_store_directory)
            backup_service = BackupService(self.backup_store, cfg.node_id)
        else:
            self.backup_store = None
        self.partitions: dict[int, ZeebePartition] = {}
        # one TieringCfg shared by every partition (control-plane actuated)
        self._shared_tiering_cfg = None
        # closed-loop control plane — built AFTER the partitions
        # exist, at the end of __init__; None = disabled (one is-None check
        # per control pump is the whole disabled cost)
        self.control = None
        # gateway-facing jobs-available listener (runtime hub); assignable
        # after construction — partitions route through the indirection below
        self.jobs_listener: Callable[[int, set], None] | None = None
        self._sender = ClusterInterPartitionSender(self)
        self._exporters_factory = exporters_factory
        self._response_sink = sink
        self._backup_service = backup_service
        self._backpressure_algorithm = backpressure_algorithm
        self._backpressure_enabled = backpressure_enabled
        # dynamic topology: gossiped versioned document + change plans
        # (reference: topology/ClusterTopologyManager); bootstrapped from the
        # static distribution on first start, RESTORED from disk afterwards —
        # a restart must not forget partitions that were moved here at runtime
        from zeebe_tpu_torch.cluster.topology import TopologyManager

        self._topology_path = self.directory / "topology.json"
        self.topology = TopologyManager(
            cfg.node_id, self.membership,
            start_replica=self._create_partition_for_join,
            stop_replica=self._stop_partition,
            raft_of=lambda pid: (
                self.partitions[pid].raft if pid in self.partitions else None
            ),
            request_reconfigure=self._request_reconfigure,
            persist=self._persist_topology,
        )
        start_steps = REGISTRY.histogram(
            "broker_start_step_latency",
            "seconds per broker startup step", ("step",))
        step_start = time.perf_counter()
        saved = self._load_topology()
        if saved is not None:
            self.topology.restore(saved)
            start_steps.labels("topology-restore").observe(
                time.perf_counter() - step_start)
            step_start = time.perf_counter()
            for pid, (members, priority) in self.topology.own_partitions().items():
                self._create_partition(pid, members, priority)
        else:
            distribution = partition_distribution(cfg)
            for partition_id, members in distribution.items():
                if cfg.node_id in members:
                    self._create_partition(partition_id, members)
            self.topology.bootstrap(distribution, sorted(cfg.cluster_members))
        start_steps.labels("partition-manager").observe(
            time.perf_counter() - step_start)
        if cfg.control:
            # the plane needs the time-series store (its sensor) and the
            # partitions (its knob surface): last startup step by design
            from zeebe_tpu_torch.control import maybe_build_plane

            self.control = maybe_build_plane(self)

    # -- metrics plane ---------------------------------------------------------

    def _on_health_transition(self, report) -> None:
        """Health changes land in the flight recorder; a transition to
        UNHEALTHY/DEAD dumps the rings to disk — the postmortem must exist
        BEFORE anyone asks for it."""
        from zeebe_tpu_torch.utils.health import HealthStatus

        component = report.component
        partition_id = 0
        if component.startswith("partition-"):
            try:
                partition_id = int(component[len("partition-"):].split(".")[0])
            except ValueError:
                pass
        self.flight_recorder.record(
            partition_id, "health", component=component,
            status=report.status.name, message=report.message)
        if report.status >= HealthStatus.UNHEALTHY:
            self.flight_recorder.dump(f"unhealthy:{component}")

    def _on_alert_transition(self, rule, labels: str, old: str,
                             new: str) -> None:
        self.flight_recorder.record(
            0, "alert", rule=rule.name, labels=labels, state=new,
            previous=old, expr=rule.describe())
        if new == "firing":
            # attach what the threads were doing when the rule fired (short
            # folded-stack profile, throttled per rule) — a dump then
            # explains the *why* next to the *what*
            self._alert_profile_capture.on_firing(rule.name, labels)

    def hard_crash(self) -> None:
        """Power-loss crash for the whole broker (chaos harness): dump the
        flight rings FIRST — the dump is the black box a real crash handler
        would flush — then lose every unfsynced byte."""
        for pid in self.partitions:
            self.flight_recorder.record(
                pid, "crash", detail="power-loss (hard crash)")
        self.flight_recorder.dump("hard-crash", force=True)
        self._remove_journal_listener()
        self._profiler_mod.release_profiler(self._profiler_lease)
        self._profiler_lease = None
        self.device_capture.cancel()
        for partition in self.partitions.values():
            partition.hard_crash()

    def _remove_journal_listener(self) -> None:
        from zeebe_tpu_torch.observability.flight_recorder import (
            remove_journal_stall_listener,
        )

        remove_journal_stall_listener(self.flight_recorder)

    def _persist_topology(self, doc: dict) -> None:
        import json

        tmp = self._topology_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(doc))
        tmp.replace(self._topology_path)

    def _load_topology(self) -> dict | None:
        import json

        if not self._topology_path.exists():
            return None
        try:
            return json.loads(self._topology_path.read_text())
        except (OSError, ValueError):
            return None

    def _partition_lifecycle_guard(self, partition_id: int):
        from contextlib import nullcontext

        if self.partition_guard is None:
            return nullcontext()
        return self.partition_guard(partition_id)

    @property
    def partition_guard(self):
        return self._partition_guard

    @partition_guard.setter
    def partition_guard(self, guard) -> None:
        # the topology manager applies partition-scoped operations
        # (reconfigure, replica lifecycle) under the same ownership guard
        self._partition_guard = guard
        self.topology.partition_guard = guard
    # end of the copy

    def _mesh_runner(self):
        """The shared kernel mesh runner: injected by the hosting runtime
        (one mesh per process), or lazily created from
        ``cfg.kernel_mesh_shards`` for a standalone broker. None = the
        kernel runs single-device."""
        if not self.cfg.kernel_backend:
            return None  # the kernel backend is the runner's only consumer
        if self._injected_mesh_runner is not None:
            return self._injected_mesh_runner
        shards = self.cfg.kernel_mesh_shards
        if shards < 0:
            # auto: as many shards as attached cards (all of them blocks on
            # the one card the broker's device names), capped at the broker's
            # partition count (extra shards would be permanent dummy-block
            # padding and larger per-chunk transfers); below 2 the direct
            # single-device dispatch path wins (no runner indirection)
            shards = min(_auto_device_count(device=self.cfg.device),
                         self.cfg.partition_count)
            if shards < 2:
                shards = 0
        if shards > 0 and self._owned_mesh_runner is None:
            from zeebe_tpu_torch.parallel.mesh_runner import MeshKernelRunner

            self._owned_mesh_runner = MeshKernelRunner(n_shards=shards,
                                                       device=self.cfg.device)
        return self._owned_mesh_runner

    # copied from the reference: _tiering_cfg .. _scrub_cfg
    def _tiering_cfg(self):
        """The partition-facing TieringCfg, or None when tiering is off.
        ONE shared instance per broker: every partition's manager reads the
        same object, so the state-tiering controller's actuator (the single
        runtime write path for park_after_ms/spill_batch) steers them all."""
        if not self.cfg.tiering:
            return None
        if self._shared_tiering_cfg is None:
            from zeebe_tpu_torch.state.tiering import TieringCfg

            self._shared_tiering_cfg = TieringCfg(
                enabled=True,
                park_after_ms=self.cfg.tiering_park_after_ms,
                spill_batch=self.cfg.tiering_spill_batch,
            )
        return self._shared_tiering_cfg

    def _scrub_cfg(self):
        """The partition-facing ScrubCfg, or None when scrubbing is off."""
        if not self.cfg.scrub:
            return None
        from zeebe_tpu_torch.broker.scrubber import ScrubCfg

        return ScrubCfg(enabled=True,
                        interval_ms=self.cfg.scrub_interval_ms,
                        bytes_per_pass=self.cfg.scrub_bytes_per_pass)
    # end of the copy

    def _create_partition(self, partition_id: int, members: list[str],
                          priority: int = 1) -> None:
        import time as _time

        from zeebe_tpu_torch.broker.backpressure import CommandRateLimiter

        bootstrap_start = _time.perf_counter()

        limiter = CommandRateLimiter(
            self._backpressure_algorithm, clock_millis=self.clock_millis,
        ) if self._backpressure_enabled else None
        self.partitions[partition_id] = ZeebePartition(
            self.messaging, partition_id, members,
            self.directory / f"partition-{partition_id}",
            self.clock_millis,
            partition_count=self.cfg.partition_count,
            exporters_factory=self._exporters_factory,
            inter_partition_sender=self._sender,
            response_sink=self._response_sink,
            snapshot_period_ms=self.cfg.snapshot_period_ms,
            consistency_checks=self.cfg.consistency_checks,
            backup_service=self._backup_service,
            on_checkpoint=self._observe_checkpoint,
            backpressure=limiter,
            priority=priority,
            on_jobs_available=self._on_jobs_available,
            kernel_backend_enabled=self.cfg.kernel_backend,
            mesh_runner=self._mesh_runner(),
            device=self.cfg.device,
            durable_state=self.cfg.durable_state,
            health_monitor=self.health_monitor,
            flight_recorder=self.flight_recorder,
            recovery_budget_ms=self.cfg.recovery_budget_ms,
            snapshot_chain_length=self.cfg.snapshot_chain_length,
            tiering=self._tiering_cfg(),
            log_flush_delay_ms=self.cfg.log_flush_delay_ms,
            log_max_unflushed_bytes=self.cfg.log_max_unflushed_bytes,
            scrub=self._scrub_cfg(),
        )
        self.health_monitor.register(f"partition-{partition_id}")
        from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

        _REG.histogram(
            "partition_server_bootstrap_time",
            "seconds to bootstrap a partition server", ("partition",)
        ).labels(str(partition_id)).observe(
            _time.perf_counter() - bootstrap_start)
        self.messaging.subscribe(
            f"{INTER_PARTITION_TOPIC}-{partition_id}",
            lambda s, p, pid=partition_id: self._on_inter_partition_command(pid, s, p),
        )
        self.messaging.subscribe(
            f"{COMMAND_API_TOPIC}-{partition_id}",
            lambda s, p, pid=partition_id: self._on_client_command(pid, s, p),
        )
        self.messaging.subscribe(
            f"raft-reconfigure-{partition_id}",
            lambda s, p, pid=partition_id: self._on_reconfigure_request(pid, s, p),
        )
        self.messaging.subscribe(
            f"raft-reconfigure-done-{partition_id}",
            lambda s, p, pid=partition_id: self._on_reconfigure_confirmed(pid, s, p),
        )

    # copied from the reference: _create_partition_for_join .. trigger_checkpoint
    def _create_partition_for_join(self, partition_id: int, members: list[str],
                                   priority: int = 1) -> None:
        """Topology PARTITION_JOIN: bootstrap a replica that is not yet part
        of the raft group (it syncs via append/snapshot once the leader adds
        it through reconfiguration)."""
        if partition_id not in self.partitions:
            import time as _time

            join_start = _time.perf_counter()
            self._create_partition(partition_id, members, priority)
            self._metrics["join_time"].labels(str(partition_id)).observe(
                _time.perf_counter() - join_start)

    _PARTITION_TOPICS = (
        "{t}-vote", "{t}-vote-resp", "{t}-append", "{t}-append-resp",
        "{t}-snapshot",
    )

    def _stop_partition(self, partition_id: int) -> None:
        with self._partition_lifecycle_guard(partition_id):
            self._stop_partition_locked(partition_id)

    def _stop_partition_locked(self, partition_id: int) -> None:
        partition = self.partitions.pop(partition_id, None)
        if partition is None:
            return
        # drop every handler first: a straggler raft message must never
        # dispatch into a replica whose journals are closed
        raft_topic = f"raft-{partition_id}"
        for template in self._PARTITION_TOPICS:
            self.messaging.unsubscribe(template.format(t=raft_topic))
        for topic in (f"{INTER_PARTITION_TOPIC}-{partition_id}",
                      f"{COMMAND_API_TOPIC}-{partition_id}",
                      f"raft-reconfigure-{partition_id}",
                      f"raft-reconfigure-done-{partition_id}"):
            self.messaging.unsubscribe(topic)
        self.health_monitor.deregister(f"partition-{partition_id}")
        # per-exporter sub-components ("partition-N.exporter-…") go with it
        self.health_monitor.deregister_matching(f"partition-{partition_id}.")
        partition.close()

    def _request_reconfigure(self, partition_id: int, change: dict) -> None:
        leader = self.known_leader(partition_id)
        payload = {**change, "from": self.cfg.node_id}
        if leader is not None and leader != self.cfg.node_id:
            self.messaging.send(leader, f"raft-reconfigure-{partition_id}", payload)
        elif leader == self.cfg.node_id:
            self._on_reconfigure_request(partition_id, self.cfg.node_id, payload)

    def _on_reconfigure_request(self, partition_id: int, sender: str,
                                payload: dict) -> None:
        """Reconfigure INTENT ({"add": m} / {"remove": m}): the leader derives
        the new member list from its OWN configuration — a requester with a
        stale view must never shrink the group past its intent."""
        partition = self.partitions.get(partition_id)
        if partition is None or not partition.is_leader:
            return
        raft = partition.raft
        members = set(raft.members)
        if payload.get("add"):
            members.add(payload["add"])
        if payload.get("remove"):
            members.discard(payload["remove"])
        if len(members) >= 1:
            raft.reconfigure(sorted(members))
        # confirm with the authoritative post-change membership so the
        # requester can complete its topology operation even if the raft
        # config entry never reaches it (e.g. it was the removed member)
        requester = payload.get("from", sender)
        if requester != self.cfg.node_id:
            self.messaging.send(
                requester, f"raft-reconfigure-done-{partition_id}",
                {"members": raft.members},
            )

    def _on_reconfigure_confirmed(self, partition_id: int, sender: str,
                                  payload: dict) -> None:
        self.topology.on_reconfigure_confirmed(partition_id, payload["members"])

    # -- command ingress -------------------------------------------------------

    def _on_inter_partition_command(self, partition_id: int, sender: str,
                                    payload: dict) -> None:
        record = Record.from_bytes(payload["record"])
        record = record.replace(key=payload.get("key", record.key))
        partition = self.partitions.get(partition_id)
        if partition is None or not partition.is_leader:
            return
        incoming_checkpoint = payload.get("checkpointId", 0)
        if incoming_checkpoint > partition.latest_checkpoint_id():
            from zeebe_tpu_torch.protocol import ValueType as _VT
            from zeebe_tpu_torch.protocol import command as _command
            from zeebe_tpu_torch.protocol.intent import CheckpointIntent as _CI

            partition.write_commands([_command(
                _VT.CHECKPOINT, _CI.CREATE, {"checkpointId": incoming_checkpoint},
            )])
        partition.write_commands([record])

    def _on_client_command(self, partition_id: int, sender: str,
                           payload: dict) -> None:
        record = Record.from_bytes(payload["record"])
        partition = self.partitions.get(partition_id)
        if partition is not None and partition.is_leader:
            partition.write_commands([record])

    def write_command(self, partition_id: int, record: Record) -> int | None:
        """Local API ingress (the gateway talks to the leader broker):
        backpressure + disk-pause gated, unlike internal write paths."""
        partition = self.partitions.get(partition_id)
        if partition is None or not partition.is_leader:
            return None
        return partition.client_write(record)

    def _on_jobs_available(self, partition_id: int, job_types: set) -> None:
        if self.jobs_listener is not None:
            self.jobs_listener(partition_id, job_types)

    # -- topology --------------------------------------------------------------

    def preferred_leader(self, partition_id: int) -> str | None:
        """The replica with the highest topology priority for a partition —
        the target leadership rebalancing converges to (reference:
        PartitionLeaderElection priorities; priorities are assigned
        round-robin at bootstrap, ClusterTopology.initial)."""
        from zeebe_tpu_torch.cluster.topology import ACTIVE

        best: str | None = None
        best_prio = -1
        for member_id, mstate in self.topology.topology.members.items():
            if mstate.get("state") != ACTIVE:
                continue  # leaving/left members must not attract leadership
            p = mstate.get("partitions", {}).get(str(partition_id))
            if p is None or p.get("state", ACTIVE) != ACTIVE:
                continue  # joining replicas may still be catching up
            prio = p.get("priority", 1)
            if prio > best_prio or (prio == best_prio and (best is None or member_id < best)):
                best, best_prio = member_id, prio
        return best

    def rebalance(self) -> dict[int, str]:
        """Leadership rebalancing (reference: dist/…/management/
        RebalancingEndpoint.java): for every LOCAL partition this broker
        leads whose preferred (highest-priority) replica is someone else,
        transfer raft leadership there. Returns partition → transfer target
        for the transfers actually initiated (best-effort, like the
        reference's actuator)."""
        transferred: dict[int, str] = {}
        # list(): served on the management HTTP thread while topology changes
        # may add/remove partitions concurrently
        for pid, partition in list(self.partitions.items()):
            if not partition.is_leader:
                continue
            preferred = self.preferred_leader(pid)
            if (preferred is not None and preferred != self.cfg.node_id
                    and partition.raft.transfer_leadership(preferred)):
                transferred[pid] = preferred
        return transferred

    def known_leader(self, partition_id: int) -> str | None:
        """Leader member for a partition: local raft knowledge first, then
        gossiped broker info (reference: BrokerTopologyManager)."""
        local = self.partitions.get(partition_id)
        if local is not None:
            if local.is_leader:
                return self.cfg.node_id
            if local.raft.leader_id is not None:
                return local.raft.leader_id
        for member in list(self.membership.members.values()):
            roles = member.properties.get("partitions", {})
            if roles.get(str(partition_id)) == "leader":
                return member.member_id
        return None

    def _gossip_roles(self) -> None:
        roles = {
            str(pid): ("leader" if p.is_leader else "follower")
            for pid, p in self.partitions.items()
        }
        current = self.membership.properties.get("partitions")
        if current != roles:
            self.membership.set_property("partitions", roles)

    # -- pump ------------------------------------------------------------------

    def pump(self) -> int:
        """One scheduling round: raft timers, membership, partition work."""
        work = self.pump_control()
        for pid in list(self.partitions):
            work += self.pump_partition(pid)
        return work

    def pump_partition(self, partition_id: int) -> int:
        """Advance ONE partition replica (raft timers + processing) — the
        per-partition ownership thread's slice of pump(). The partition may
        disappear mid-call under a concurrent topology change; the owning
        runtime's pump guard absorbs the resulting error for one tick."""
        partition = self.partitions.get(partition_id)
        if partition is None:
            return 0
        partition.tick()
        return partition.pump()

    def pump_control(self) -> int:
        """Advance the broker-level services (membership, topology, disk
        monitor, observability, role gossip) — the control thread's slice.
        Reads of partition state here are lock-free attribute reads; they may
        lag a partition thread by a tick, which gossip tolerates by design."""
        self.membership.tick()
        self.topology.tick()
        if self.disk_monitor is not None:
            disk_paused = self.disk_monitor.check()
            for partition in list(self.partitions.values()):
                partition.disk_paused = disk_paused
        self._update_observability()
        if self.sampler is not None and self.sampler.maybe_sample():
            # device memory rides the metrics cadence: stats read straight
            # off already-initialized devices (profiler._resolve_devices
            # never touches an unpinned, uninitialized accelerator backend)
            self._profiler_mod.sample_device_memory()
            if self.auditor is not None:
                # audit BEFORE the alert sweep so the burn-rate series this
                # tick publishes is what the evaluator judges
                self.auditor.tick(self.clock_millis())
            self.alerts.evaluate(self.clock_millis())
        if self.control is not None:
            # control ticks AFTER the sampler: decisions see telemetry at
            # most one sampling interval old
            self.control.maybe_tick(self.clock_millis())
        self._gossip_roles()
        return 0

    def _update_observability(self) -> None:
        from zeebe_tpu_torch.utils.health import HealthStatus

        node = self.cfg.node_id
        # the per-CF key-count gauges bisect the whole key index: 1s cadence,
        # not every pump round
        now_ms = self.clock_millis()
        for pid, partition in self.partitions.items():
            label = str(pid)
            self._metrics["role"].labels(node, label).set(
                1 if partition.is_leader else 0)
            if partition.limiter is not None:
                self._metrics["inflight"].labels(node, label).set(
                    len(partition.limiter.in_flight))
                dropped = self._metrics["dropped"].labels(node, label)
                dropped.value = float(partition.limiter.dropped_total)
            self._metrics["written"].labels(node, label).value = float(
                partition.stream.last_position)
            self._metrics["term"].labels(node, label).set(
                float(partition.raft.current_term))
            self._metrics["commit"].labels(node, label).set(
                float(partition.raft.commit_index))
            self._metrics["snapshot"].labels(node, label).set(
                float(partition.raft.snapshot_index))
            if partition.processor is not None:
                self._metrics["processed"].labels(node, label).set(
                    float(partition.processor.last_processed_position))
            if partition.exporter_director is not None:
                exported = partition.exporter_director.lowest_exporter_position()
                if exported < 2**62:
                    self._metrics["exported"].labels(node, label).set(
                        float(exported))
            db = partition.db
            if db is not None and not db.in_transaction \
                    and now_ms - self._state_gauges_ms >= 1000:
                counts = db.key_counts_by_cf()
                seen = self._state_cf_seen.setdefault(pid, set())
                for cf_name in seen - counts.keys():
                    self._metrics["state_keys"].labels(
                        node, label, cf_name).set(0.0)
                for cf_name, count in counts.items():
                    self._metrics["state_keys"].labels(
                        node, label, cf_name).set(float(count))
                seen.update(counts)
                stats = (db.tier_stats() if hasattr(db, "tier_stats")
                         else None)
                if stats is not None:
                    self._metrics["tier_bytes"].labels(node, label, "hot").set(
                        float(stats["hotBytesEstimate"]))
                    self._metrics["tier_bytes"].labels(node, label, "cold").set(
                        float(stats["coldBytes"]))
                if partition.tiering is not None:
                    self._metrics["parked"].labels(node, label, "cold").set(
                        float(partition.tiering.spilled_instances))
                    self._metrics["parked"].labels(
                        node, label, "candidate").set(
                        float(partition.tiering.pending_candidates))
            failed = (
                partition.processor is not None
                and partition.processor.phase.value == "failed"
            )
            self.health_monitor.report(
                f"partition-{pid}",
                HealthStatus.UNHEALTHY if failed else HealthStatus.HEALTHY,
            )
        if now_ms - self._state_gauges_ms >= 1000:
            self._state_gauges_ms = now_ms
        self._metrics["health"].labels(node).set(
            float(self.health_monitor.status()))

    def close(self) -> None:
        import time as _time

        from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

        close_latency = _REG.histogram(
            "broker_close_step_latency",
            "seconds per broker shutdown step", ("step",))
        self._remove_journal_listener()
        self._profiler_mod.release_profiler(self._profiler_lease)
        self._profiler_lease = None
        # an in-flight device trace would otherwise keep jax's global
        # profiler occupied and write into a directory about to disappear
        self.device_capture.cancel()
        for pid, partition in self.partitions.items():
            step_start = _time.perf_counter()
            partition.close()
            close_latency.labels(f"partition-{pid}").observe(
                _time.perf_counter() - step_start)
        if self._tmp is not None:
            self._tmp.cleanup()

    def health(self) -> dict:
        return {
            "nodeId": self.cfg.node_id,
            "partitions": [p.health() for p in self.partitions.values()],
        }

    def pause_processing(self) -> None:
        """BrokerAdminService pause: stop accepting client commands."""
        for partition in self.partitions.values():
            partition.paused = True

    def resume_processing(self) -> None:
        for partition in self.partitions.values():
            partition.paused = False

    # -- backup ----------------------------------------------------------------

    _checkpoint_cache = 0

    def latest_checkpoint_id(self) -> int:
        """Hot path (piggybacked on every inter-partition send): cached, and
        bumped by the partitions' checkpoint-created listeners."""
        if self._checkpoint_cache == 0:
            self._checkpoint_cache = max(
                (p.latest_checkpoint_id() for p in list(self.partitions.values())),
                default=0,
            )
        return self._checkpoint_cache

    def _observe_checkpoint(self, checkpoint_id: int) -> None:
        if checkpoint_id > self._checkpoint_cache:
            self._checkpoint_cache = checkpoint_id

    def trigger_checkpoint(self, checkpoint_id: int) -> int:
        """Write CHECKPOINT CREATE to every local leader partition (the admin
        BackupRequest fan-out, reference: BackupApiRequestHandler). Returns how
        many partitions accepted the trigger."""
        from zeebe_tpu_torch.protocol import ValueType as _VT
        from zeebe_tpu_torch.protocol import command as _command
        from zeebe_tpu_torch.protocol.intent import CheckpointIntent as _CI

        count = 0
        for partition in self.partitions.values():
            if partition.is_leader and partition.write_commands([_command(
                _VT.CHECKPOINT, _CI.CREATE, {"checkpointId": checkpoint_id},
            )]) is not None:
                count += 1
        return count
    # end of the copy


class InProcessCluster:
    """N brokers over the loopback network with a shared controlled clock —
    the ClusteringRule equivalent for multi-broker tests."""

    def __init__(self, broker_count: int = 3, partition_count: int = 3,
                 replication_factor: int = 3,
                 directory: str | Path | None = None,
                 exporters_factory: Callable[[], dict[str, Any]] | None = None,
                 snapshot_period_ms: int = 5 * 60 * 1000,
                 durable_state: bool = False,
                 network: LoopbackNetwork | None = None,
                 recovery_budget_ms: int = 60_000,
                 snapshot_chain_length: int = 8,
                 tiering: bool = False,
                 tiering_park_after_ms: int = 30_000,
                 tiering_spill_batch: int = 256,
                 kernel_backend: bool = True,
                 device=None) -> None:
        from zeebe_tpu_torch.testing import ControlledClock

        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory()
            directory = self._tmp.name
        self.directory = Path(directory)
        self.clock = ControlledClock()
        # injectable network: the chaos harness passes a fault-injecting
        # ChaosNetwork; default stays the plain deterministic loopback
        self.net = network if network is not None else LoopbackNetwork()
        members = [f"broker-{i}" for i in range(broker_count)]
        self.brokers: dict[str, Broker] = {}
        self._exporters_factory = exporters_factory
        # crashed brokers' configs, kept for restart_broker (snapshot period
        # and durable-state settings ride along inside the BrokerCfg)
        self._stopped_cfgs: dict[str, BrokerCfg] = {}
        # every broker's partitions run their kernel groups on this device
        # (None = CUDA); kernel_backend=False runs them sequentially
        self.kernel_backend = kernel_backend
        self.device = device
        for m in members:
            cfg = BrokerCfg(
                node_id=m, partition_count=partition_count,
                replication_factor=replication_factor, cluster_members=members,
                snapshot_period_ms=snapshot_period_ms,
                durable_state=durable_state,
                recovery_budget_ms=recovery_budget_ms,
                snapshot_chain_length=snapshot_chain_length,
                tiering=tiering,
                tiering_park_after_ms=tiering_park_after_ms,
                tiering_spill_batch=tiering_spill_batch,
                kernel_backend=kernel_backend,
                device=device,
            )
            self.brokers[m] = Broker(
                cfg, self.net.join(m), directory=self.directory / m,
                clock_millis=self.clock,
                exporters_factory=exporters_factory,
            )

    # copied from the reference: run .. restart_broker
    def run(self, millis: int, step: int = 50) -> None:
        for _ in range(max(millis // step, 1)):
            self.clock.advance(step)
            for broker in self.brokers.values():
                broker.pump()
            self.net.deliver_all()
            # drain work produced by delivered messages (commits → processing)
            for _ in range(20):
                moved = sum(b.pump() for b in self.brokers.values())
                self.net.deliver_all()
                if moved == 0 and not self.net.queue:
                    break

    def await_leaders(self) -> None:
        """Run until every partition has an elected leader."""
        for _ in range(40):
            self.run(ELECTION_TIMEOUT_MS)
            if all(
                self.leader(p) is not None
                for p in range(1, next(iter(self.brokers.values())).cfg.partition_count + 1)
            ):
                return
        raise RuntimeError("leaders not elected")

    def leader(self, partition_id: int) -> ZeebePartition | None:
        leaders = [
            b.partitions[partition_id]
            for b in self.brokers.values()
            if partition_id in b.partitions and b.partitions[partition_id].is_leader
        ]
        return leaders[0] if len(leaders) == 1 else None

    def leader_broker(self, partition_id: int) -> Broker | None:
        """During failover a deposed-but-isolated leader may still claim the
        role; the highest term wins (the gateway resolves the same way via
        gossiped topology, which always carries the newest term's claim)."""
        leader = resolve_leader_partition(self.brokers.values(), partition_id)
        if leader is None:
            return None
        for b in self.brokers.values():
            if b.partitions.get(partition_id) is leader:
                return b
        return None

    def write_command(self, partition_id: int, record: Record) -> int | None:
        broker = self.leader_broker(partition_id)
        if broker is None:
            return None
        position = broker.write_command(partition_id, record)
        self.run(300)
        return position

    def stop_broker(self, node_id: str) -> None:
        """Crash a broker mid-run: close its journals (durable state stays on
        disk), drop it from the network so in-flight traffic to it is lost,
        and forget it until ``restart_broker``."""
        broker = self.brokers.pop(node_id, None)
        if broker is None:
            raise KeyError(f"unknown broker {node_id}")
        self._stopped_cfgs[node_id] = broker.cfg
        self.net.leave(node_id)
        broker.close()

    def hard_crash_broker(self, node_id: str) -> None:
        """Power-loss crash: like ``stop_broker`` but journals lose every
        byte not covered by an fsync (the chaos suite's flush-boundary fault
        — a crash between a buffered append and its covering flush). Raft's
        ack barrier fsyncs before acknowledging, so acked entries survive;
        the unacked buffered suffix is legitimately gone."""
        broker = self.brokers.pop(node_id, None)
        if broker is None:
            raise KeyError(f"unknown broker {node_id}")
        self._stopped_cfgs[node_id] = broker.cfg
        self.net.leave(node_id)
        # dumps the flight rings (the black box), then loses unfsynced bytes
        broker.hard_crash()
        # the data directory stays intact (cluster brokers always get one
        # from the cluster): restart_broker recovers the fsynced prefix

    def restart_broker(self, node_id: str) -> Broker:
        """Rebuild a crashed broker over its on-disk directory: raft journal,
        stream journal, and snapshots recover exactly as a real process
        restart would (reference: ClusteringRule.restartBroker)."""
        cfg = self._stopped_cfgs.pop(node_id, None)
        if cfg is None:
            raise KeyError(f"broker {node_id} was not stopped")
        broker = Broker(
            cfg, self.net.join(node_id), directory=self.directory / node_id,
            clock_millis=self.clock, exporters_factory=self._exporters_factory,
        )
        self.brokers[node_id] = broker
        return broker
    # end of the copy

    def add_broker(self, node_id: str) -> Broker:
        """Start a NEW broker that joins the running cluster with no
        partitions of its own (the dynamic-topology entry point: move
        partitions onto it with topology change operations afterwards)."""
        seeds = sorted(self.brokers)
        cfg = BrokerCfg(
            node_id=node_id,
            partition_count=next(iter(self.brokers.values())).cfg.partition_count,
            replication_factor=next(iter(self.brokers.values())).cfg.replication_factor,
            cluster_members=seeds,  # not itself: hosts nothing at bootstrap
            kernel_backend=self.kernel_backend,
            device=self.device,
        )
        broker = Broker(cfg, self.net.join(node_id),
                        directory=self.directory / node_id,
                        clock_millis=self.clock)
        self.brokers[node_id] = broker
        return broker

    # copied from the reference: close .. close
    def close(self) -> None:
        for broker in self.brokers.values():
            broker.close()
        if self._tmp is not None:
            self._tmp.cleanup()
    # end of the copy
