"""BrokerClient + ClusterRuntime: the gateway's view of the broker cluster.

The counterpart of ``zeebe_tpu/gateway/broker_client.py``, copied
(``testing/copies.py`` writes the marked runs) but for the constructor of
``ClusterRuntime``, which takes the kernel backend's ``device`` (None =
CUDA, raising without it; ``"cpu"`` runs the plain version) and gives it to
every broker and to the shared mesh runner.

``ClusterRuntime`` drives an in-process broker cluster on background threads
(the brokers' actor loop equivalent): gRPC handler threads (the port's
``gateway.Gateway``) submit commands and block on a response future; the
pump threads advance raft/processing and resolve futures from each broker's
response sink."""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any

from zeebe_tpu_torch.broker import Broker, BrokerCfg
from zeebe_tpu_torch.broker.broker import resolve_leader_partition
from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
from zeebe_tpu_torch.parallel.partitioning import subscription_partition_id
from zeebe_tpu_torch.protocol import Record
from zeebe_tpu_torch.protocol.keys import decode_partition_id

# copied from the reference: logger .. GatewayRuntimeBase
logger = logging.getLogger("zeebe_tpu_torch.gateway.runtime")

DEPLOYMENT_PARTITION = 1


class RequestTimeoutError(Exception):
    pass


class DeadlineExceededError(RequestTimeoutError):
    """The overall per-request deadline expired (bounded gateway resend
    loop, ``ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS``): the request is abandoned
    with a typed error instead of retrying forever against a dead
    partition. Subclasses RequestTimeoutError so existing gRPC mappings
    (DEADLINE_EXCEEDED) and retry handlers keep working."""


class NoLeaderError(Exception):
    pass


class ResourceExhaustedError(Exception):
    pass


class GatewayRuntimeBase:
    """Shared request plumbing for gateway runtimes — in-process
    (:class:`ClusterRuntime`), one-broker-per-process TCP
    (:class:`~zeebe_tpu_torch.gateway.tcp_runtime.TcpClusterRuntime`), and
    supervised per-core workers
    (:class:`~zeebe_tpu_torch.multiproc.runtime.MultiProcClusterRuntime`): the
    nonce'd request-id sequence, the pending/response correlation table,
    and the partition-selection helpers."""

    def _init_jobstreams(self) -> None:
        """Jobs-available hub (long-poll wakeup) + push dispatcher (job
        streams); fed by the brokers' post-commit jobs-available side effect."""
        from zeebe_tpu_torch.gateway.jobstream import JobNotificationHub, JobStreamDispatcher

        self.jobs_hub = JobNotificationHub()
        self.job_streams = JobStreamDispatcher(self)

    def _on_jobs_available(self, partition_id: int, job_types: set) -> None:
        self.jobs_hub.notify(job_types)
        self.job_streams.on_jobs_available(partition_id, job_types)

    def _init_requests(self) -> None:
        self._round_robin = itertools.count()
        # request ids carry a startup nonce in the high bits: a restarted
        # gateway must never resolve a backlog command's stale request_id
        # against a fresh in-flight request
        nonce = int(time.time() * 1000) & 0x3FFFFF
        self._request_seq = itertools.count((nonce << 32) + 1)
        self._pending: dict[int, threading.Event] = {}
        self._responses: dict[int, Record] = {}

    def _register_request(self) -> tuple[int, threading.Event]:
        request_id = next(self._request_seq)
        event = threading.Event()
        self._pending[request_id] = event
        return request_id, event

    def _resolve_request(self, request_id: int, record: Record) -> None:
        event = self._pending.get(request_id)
        if event is not None:
            self._responses[request_id] = record
            event.set()

    def _take_response(self, request_id: int, event: threading.Event,
                       deadline: float, partition_id: int, timeout_s: float) -> Record:
        try:
            if not event.wait(max(deadline - time.time(), 0.001)):
                raise RequestTimeoutError(
                    f"partition {partition_id} did not respond in {timeout_s}s"
                )
            return self._responses.pop(request_id)
        finally:
            self._pending.pop(request_id, None)
            self._responses.pop(request_id, None)

    def partition_for_new_instance(self) -> int:
        return next(self._round_robin) % self.partition_count + 1

    def partition_for_correlation_key(self, key: str) -> int:
        return subscription_partition_id(key, self.partition_count)

    @staticmethod
    def partition_for_key(key: int) -> int:
        return decode_partition_id(key)
# end of the copy


class ClusterRuntime(GatewayRuntimeBase):
    """Owns N in-process brokers and the pump thread; thread-safe ingress."""

    def __init__(self, broker_count: int = 1, partition_count: int = 1,
                 replication_factor: int = 1, directory=None,
                 exporters_factory=None,
                 backpressure_algorithm: str = "vegas",
                 backpressure_enabled: bool = True,
                 disk_min_free_bytes: int = 0,
                 backup_store_directory=None,
                 backup_store=None,
                 kernel_backend: bool = True,
                 kernel_mesh_shards: int = 0,
                 device=None) -> None:
        self.partition_count = partition_count
        self.net = LoopbackNetwork(lanes=partition_count)
        self._lock = threading.RLock()
        # per-partition ownership locks: partition p's replicas (across all
        # brokers) advance only under _plocks[p] — the single-writer
        # guarantee the reference gets from partition actors, here extended
        # so one partition's slow step (a kernel compile) no longer stalls
        # the other partitions' raft heartbeats and processing
        self._plocks = {p: threading.RLock()
                        for p in range(1, partition_count + 1)}
        self._init_requests()
        self._init_jobstreams()
        members = [f"broker-{i}" for i in range(broker_count)]
        self.brokers: dict[str, Broker] = {}
        # one mesh per process: every in-process broker's partitions submit
        # kernel groups to the SAME runner, so the whole cluster's batch
        # coalesces onto one device mesh (partition = shard, SURVEY §2.13);
        # on a host of two or more cards the runner takes one launch group
        # per card (parallel.mesh.card_mesh), as the broker's auto mode does
        self.mesh_runner = None
        if kernel_mesh_shards > 0 and kernel_backend:
            from zeebe_tpu_torch.parallel.mesh_runner import MeshKernelRunner

            self.mesh_runner = MeshKernelRunner(n_shards=kernel_mesh_shards,
                                                device=device)
        from pathlib import Path

        for m in members:
            cfg = BrokerCfg(node_id=m, partition_count=partition_count,
                            replication_factor=replication_factor,
                            cluster_members=members,
                            kernel_backend=kernel_backend,
                            device=device)
            self.brokers[m] = Broker(
                cfg, self.net.join(m),
                directory=(Path(directory) / m if directory else None),
                exporters_factory=exporters_factory,
                response_sink=self._resolve,
                backpressure_algorithm=backpressure_algorithm,
                backpressure_enabled=backpressure_enabled,
                disk_min_free_bytes=disk_min_free_bytes,
                backup_store_directory=backup_store_directory,
                backup_store=backup_store,
                mesh_runner=self.mesh_runner,
            )
            self.brokers[m].jobs_listener = self._on_jobs_available
            # topology-driven partition add/remove must hold the partition's
            # ownership lock so lifecycle never races that partition's pump
            self.brokers[m].partition_guard = self._partition_guard
        self._running = False
        self._threads: list[threading.Thread] = []

    # copied from the reference: _partition_guard .. cluster_status
    def _partition_guard(self, partition_id: int):
        import contextlib

        lock = self._plocks.get(partition_id)
        return lock if lock is not None else contextlib.nullcontext()

    # -- pump thread -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        # one ownership thread per partition + one control thread (membership,
        # topology, gossip, observability) — the reference's partition actors,
        # as threads over the same single-writer discipline
        self._threads = [
            threading.Thread(target=self._run_partition, args=(pid,),
                             daemon=True, name=f"partition-{pid}")
            for pid in range(1, self.partition_count + 1)
        ]
        self._threads.append(
            threading.Thread(target=self._run_control, daemon=True,
                             name="cluster-control")
        )
        for t in self._threads:
            t.start()
        self.job_streams.start()
        self.await_leaders()

    def _pump_brokers(self, pump, logged: set) -> None:
        # one broker's pump failure (e.g. crashed/closed but still listed)
        # must not kill the thread that drives every other broker: keep
        # pumping the rest and retry the failed one each tick (a transient
        # cause — momentary disk pressure, a mid-transition race — recovers
        # by itself); the traceback is logged once per failure streak
        for name, broker in list(self.brokers.items()):
            try:
                pump(broker)
                logged.discard(name)
            except Exception:  # noqa: BLE001
                if name not in logged:
                    logged.add(name)
                    logger.exception("broker %s pump failed; retrying "
                                     "(logged once per streak)", name)

    def _run_partition(self, pid: int) -> None:
        logged: set[str] = set()
        while self._running:
            with self._plocks[pid]:
                self._pump_brokers(lambda b: b.pump_partition(pid), logged)
                try:
                    moved = self.net.deliver_lane(pid)
                except Exception:  # noqa: BLE001 — deliver_one already guards
                    # handler errors; this guards queue-level corruption
                    logger.exception("partition %s delivery failed", pid)
                    moved = 0
            if moved == 0:
                time.sleep(0.001)

    def _run_control(self) -> None:
        logged: set[str] = set()
        while self._running:
            with self._lock:
                self._pump_brokers(lambda b: b.pump_control(), logged)
                try:
                    moved = self.net.deliver_lane(0)
                except Exception:  # noqa: BLE001
                    logger.exception("control delivery failed")
                    moved = 0
            if moved == 0:
                time.sleep(0.001)

    def stop(self) -> None:
        self.job_streams.stop()
        self._running = False
        for t in getattr(self, "_threads", []):
            t.join(timeout=5)
        with self._lock:
            for broker in self.brokers.values():
                broker.close()

    def await_leaders(self, timeout_s: float = 30.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            # lock-free role reads: leadership claims are plain attributes
            # maintained by the partition threads
            ready = all(
                self._leader_partition(p) is not None
                for p in range(1, self.partition_count + 1)
            )
            if ready:
                return
            time.sleep(0.01)
        raise RuntimeError("partition leaders not elected in time")

    # -- topology --------------------------------------------------------------

    def _leader_partition(self, partition_id: int):
        return resolve_leader_partition(self.brokers.values(), partition_id)

    def topology(self) -> dict:
        with self._lock:
            return {
                "clusterSize": len(self.brokers),
                "partitionsCount": self.partition_count,
                "replicationFactor": next(iter(self.brokers.values())).cfg.replication_factor,
                "brokers": [b.health() for b in self.brokers.values()],
            }

    def cluster_status(self) -> dict:
        """Cluster-wide health/alert/rate aggregation for the management
        ``GET /cluster/status`` and ``zbctl top`` — the in-process fan-out
        over every hosted broker (reference analog: the gateway's topology
        view, widened with the metrics plane)."""
        from zeebe_tpu_torch.broker.management import cluster_status

        # lock-free reads: broker_status only touches plain attributes and
        # the thread-safe time-series store, so a stalled partition thread
        # cannot wedge the status endpoint behind the control lock
        status = cluster_status(list(self.brokers.values()))
        status["partitionsCount"] = self.partition_count
        return status
    # end of the copy

    # -- partition selection ---------------------------------------------------

    def has_activatable_jobs(self, partition_id: int, job_type: str,
                             tenant_ids: list[str] | None = None) -> bool:
        """Long-poll peek: checks the leader's state without writing a
        JOB_BATCH ACTIVATE into the replicated log (reference:
        LongPollingActivateJobsHandler parks requests until jobsAvailable).
        ``tenant_ids`` keeps a tenant-filtered long-poll from flooding the log
        with empty activations when only other tenants' jobs exist.

        Where the partition's ownership thread holds its lock past the
        peek's second, the answer is True, as the multi-process and TCP
        runtimes answer for a leader they cannot peek at: the caller writes
        a real activation, whose ``submit`` waits for the lock up to its own
        deadline (and the push dispatcher re-arms when that raises). An
        answer of False there lost jobs: the dispatcher had taken the
        partition's jobs-available notification, and no other comes for jobs
        already created, so they were never pushed."""
        lock = self._plocks.get(partition_id)
        if lock is None:
            return False
        if not lock.acquire(timeout=1.0):
            return True
        try:
            leader = self._leader_partition(partition_id)
            if leader is None or leader.db is None:
                return False
            # committed-read discipline: long-poll peeks run off the pump
            # thread — read the committed activatable index, never the
            # processing-owned transaction slot (zlint caught the old
            # `with leader.db.transaction()` here racing processing)
            from zeebe_tpu_torch.engine.engine_state import JobState

            return JobState.any_activatable_committed(
                leader.db, job_type, tenant_ids)
        finally:
            lock.release()

    # -- request path ----------------------------------------------------------

    def submit(self, partition_id: int, record: Record,
               timeout_s: float = 10.0) -> Record:
        """Write a command to the partition leader, await the engine response
        (retrying on leader miss — RequestRetryHandler semantics). Mints the
        trace's ROOT span: ``client_write`` returns the command's assigned
        stream position, which IS the trace id the broker-side spans
        (processing, export) key on — the gateway request joins its causal
        tree with no extra wire fields. Its child ``gateway.partition_lock``
        is the wait for the partition's lock, from the first try to the
        acquire that wrote the command (leader misses included)."""
        from zeebe_tpu_torch.broker.partition import BackpressureExceeded
        from zeebe_tpu_torch.observability.tracer import get_tracer

        tracer = get_tracer()
        # capture the enabled flag ONCE: enabling tracing while this request
        # is in flight must not feed perf_counter() minus the 0.0 sentinel
        # into the latency histogram
        traced = tracer.enabled
        t_submit = time.perf_counter() if traced else 0.0
        request_id, event = self._register_request()
        rec = record.replace(request_id=request_id, request_stream_id=0)
        deadline = time.time() + timeout_s
        written = False
        command_position = -1
        lock = self._plocks.get(partition_id)
        if lock is None:
            # a stale/crafted key can decode to a partition this cluster
            # never had — the same UNAVAILABLE surface as a leaderless one
            self._pending.pop(request_id, None)
            raise NoLeaderError(f"unknown partition {partition_id}")
        t_wait = time.perf_counter() if traced else 0.0
        t_locked = 0.0
        while time.time() < deadline:
            # bounded acquire: a stalled partition (held ownership lock) must
            # time this request out, not block the gRPC handler forever
            if lock.acquire(timeout=0.05):
                if traced:
                    t_locked = time.perf_counter()
                try:
                    leader = self._leader_partition(partition_id)
                    if leader is not None:
                        try:
                            position = leader.client_write(rec)
                            if position is not None:
                                written = True
                                command_position = position
                        except BackpressureExceeded as exc:
                            self._pending.pop(request_id, None)
                            raise ResourceExhaustedError(str(exc)) from exc
                finally:
                    lock.release()
            if written:
                break
            time.sleep(0.01)
        if not written:
            self._pending.pop(request_id, None)
            raise NoLeaderError(f"no leader for partition {partition_id}")
        response = self._take_response(request_id, event, deadline,
                                       partition_id, timeout_s)
        if traced:
            latency = time.perf_counter() - t_submit
            tracer.observe_ack("gateway", latency)
            trace_id = f"{partition_id}:{command_position}"
            if tracer.sampled(trace_id):
                attrs = {"position": command_position,
                         "requestId": request_id,
                         "valueType": record.value_type.name,
                         "intent": record.intent.name}
                if response.is_rejection:
                    attrs["rejection"] = response.rejection_type.name
                from zeebe_tpu_torch.observability.host_spans import clock_offset_us

                offset = clock_offset_us()
                tracer.emit(trace_id, "gateway.request", latency, partition_id,
                            attrs=attrs, start_us=int(t_submit * 1e6 + offset))
                tracer.emit(trace_id, "gateway.partition_lock", t_locked - t_wait,
                            partition_id, parent="gateway.request",
                            attrs={"position": command_position},
                            start_us=int(t_wait * 1e6 + offset))
        return response

    # copied from the reference: _resolve .. _resolve
    def _resolve(self, response) -> None:
        self._resolve_request(response.request_id, response.record)
    # end of the copy


