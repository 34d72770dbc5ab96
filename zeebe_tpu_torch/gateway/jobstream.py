"""Job push + jobs-available notifications: the gateway side of job streaming.

Reference: transport/stream/impl/ (AddStream/RemoveStream/PushStream message
flow between gateway ClientStreamManager.java:24 and the broker
RemoteStreamRegistry), broker jobstream/RemoteJobStreamer.java:19 (engine
side-effect push on job CREATED via BpmnJobActivationBehavior.java:39), and
gateway impl/job/LongPollingActivateJobsHandler.java:36 (parked long-polls
woken by a "jobsAvailable" notification instead of polling).

Design (tpu-native runtime): processing emits a post-commit jobs-available
side effect (stream/processor.py on_jobs_available) that lands here. The
``JobNotificationHub`` wakes parked ActivateJobs long-polls; the
``JobStreamDispatcher`` owns the registered client streams and, on
notification, writes a JOB_BATCH ACTIVATE through the normal command path and
delivers the activated jobs to a registered stream — so the record log is
byte-identical to pull activation and replay/exporters see nothing special.
Jobs pushed at a stream that died before delivery are handed back with
JOB YIELD (reference: YieldingJobStreamErrorHandler)."""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field

from zeebe_tpu_torch.protocol import DEFAULT_TENANT, ValueType, command
from zeebe_tpu_torch.protocol.intent import JobBatchIntent, JobIntent

logger = logging.getLogger("zeebe_tpu_torch.gateway.jobstream")

PUSH_BATCH_SIZE = 32


class JobNotificationHub:
    """Versioned per-job-type wakeup: long-polls snapshot a version, check
    state, then wait for the version to move (no sleep-poll)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._versions: dict[str, int] = {}

    def notify(self, job_types: set) -> None:
        with self._cond:
            for job_type in job_types:
                self._versions[job_type] = self._versions.get(job_type, 0) + 1
            self._cond.notify_all()

    def version(self, job_type: str) -> int:
        with self._cond:
            return self._versions.get(job_type, 0)

    def wait(self, job_type: str, seen_version: int, timeout_s: float) -> bool:
        """Block until jobs of the type were made available after
        ``seen_version`` was read, or the timeout passes."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._versions.get(job_type, 0) == seen_version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


@dataclass
class ClientJobStream:
    """One StreamActivatedJobs call's registration (ClientStream equivalent)."""

    stream_id: int
    job_type: str
    worker: str
    timeout_ms: int
    jobs: "queue.Queue[tuple[int, dict]]" = field(default_factory=queue.Queue)
    closed: bool = False
    tenant_ids: list | None = None  # authorized-tenant filter (None = default)


from time import perf_counter as _perf_counter

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

# job-stream registry metrics (reference: transport/stream metrics — clients,
# servers, streams, aggregated_stream_clients; broker jobstream metrics —
# broker_open_job_stream_count, broker_jobs_pushed_count,
# broker_jobs_push_fail_count, push)
_M_STREAMS = _REG.gauge(
    "streams", "open job streams in the registry").labels()
_M_CLIENTS = _REG.gauge(
    "clients", "connected stream clients").labels()
_M_SERVERS = _REG.gauge(
    "servers", "stream servers (one per dispatcher)").labels()
_M_AGG_CLIENTS = _REG.gauge(
    "aggregated_stream_clients",
    "clients aggregated over logically equal streams").labels()
_M_OPEN_STREAMS = _REG.gauge(
    "broker_open_job_stream_count", "open job streams, broker view").labels()
_M_PUSHED = _REG.counter(
    "broker_jobs_pushed_count", "jobs pushed to client streams").labels()
_M_PUSH_FAIL = _REG.counter(
    "broker_jobs_push_fail_count",
    "jobs that failed delivery and were re-routed/yielded").labels()
_M_PUSH_LATENCY = _REG.histogram(
    "push", "seconds per pushed job delivery").labels()


class JobStreamDispatcher:
    """RemoteStreamRegistry + RemoteJobStreamer, runtime-side: registered
    client streams per job type and a dispatcher thread turning notifications
    into JOB_BATCH ACTIVATE commands whose jobs feed the streams."""

    def __init__(self, runtime) -> None:
        # runtime surface used: submit, partition_for_key, partition_count,
        # has_activatable_jobs
        self.runtime = runtime
        self._ids = itertools.count(1)
        self._lock = threading.Condition()
        self._streams: dict[str, list[ClientJobStream]] = {}
        self._rr: dict[str, int] = {}
        self._pending: set[tuple[int, str]] = set()
        self._running = False
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        _M_SERVERS.inc()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="job-stream-dispatcher"
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        _M_SERVERS.dec()
        with self._lock:
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- stream registry (AddStream / RemoveStream) ----------------------------

    def add_stream(self, job_type: str, worker: str, timeout_ms: int,
                   tenant_ids: list | None = None) -> ClientJobStream:
        stream = ClientJobStream(next(self._ids), job_type, worker, timeout_ms,
                                 tenant_ids=tenant_ids)
        for g in (_M_STREAMS, _M_CLIENTS, _M_AGG_CLIENTS, _M_OPEN_STREAMS):
            g.inc()
        with self._lock:
            self._streams.setdefault(job_type, []).append(stream)
            # initial sweep: jobs that became activatable before the stream
            # existed must still be pushed (reference: broker re-notifies
            # streams on registration)
            for partition_id in range(1, self.runtime.partition_count + 1):
                self._pending.add((partition_id, job_type))
            self._lock.notify_all()
        return stream

    def remove_stream(self, stream: ClientJobStream,
                      in_flight: tuple[int, dict] | None = None) -> None:
        """Unregister; undelivered jobs (queued or the one being yielded to a
        now-dead client) go to another stream or back to the activatable
        queue via JOB YIELD. Drain happens under the registry lock, mutually
        exclusive with ``_deliver`` — a job can never land in the queue after
        the drain."""
        leftovers = [] if in_flight is None else [in_flight]
        with self._lock:
            stream.closed = True
            streams = self._streams.get(stream.job_type, [])
            if stream in streams:
                streams.remove(stream)
                for g in (_M_STREAMS, _M_CLIENTS, _M_AGG_CLIENTS,
                          _M_OPEN_STREAMS):
                    g.dec()
            if not streams:
                self._streams.pop(stream.job_type, None)
            while True:
                try:
                    leftovers.append(stream.jobs.get_nowait())
                except queue.Empty:
                    break
        for key, job in leftovers:
            if not self._redeliver(stream.job_type, key, job):
                self._yield_back(key)

    def has_streams(self, job_type: str) -> bool:
        with self._lock:
            return bool(self._streams.get(job_type))

    # -- notification ingress --------------------------------------------------

    def on_jobs_available(self, partition_id: int, job_types: set) -> None:
        with self._lock:
            armed = {t for t in job_types if self._streams.get(t)}
            if not armed:
                return
            self._pending.update((partition_id, t) for t in armed)
            self._lock.notify_all()

    # -- dispatcher ------------------------------------------------------------

    def _run(self) -> None:
        while self._running:
            with self._lock:
                while self._running and not self._pending:
                    self._lock.wait(0.5)
                if not self._running:
                    return
                partition_id, job_type = self._pending.pop()
            try:
                self._push(partition_id, job_type)
            except Exception:  # noqa: BLE001 — a failed push must not kill the loop
                logger.exception(
                    "job push failed (partition %s, type %r)", partition_id, job_type
                )
                # the jobs are still activatable and no fresh notification will
                # fire for them: re-arm and back off (CommandRedistributor-style
                # retry-forever; backpressure/no-leader conditions clear)
                with self._lock:
                    if self._streams.get(job_type):
                        self._pending.add((partition_id, job_type))
                time.sleep(0.05)

    @staticmethod
    def _tenant_group(stream: ClientJobStream) -> tuple:
        return tuple(sorted(stream.tenant_ids or [DEFAULT_TENANT]))

    def _tenant_groups(self, job_type: str) -> list[tuple]:
        """Distinct tenant filters across the type's streams: each group is
        pushed separately so one tenant's empty activation cannot starve
        another's (streams of different tenants see different job sets)."""
        with self._lock:
            return sorted({
                self._tenant_group(s) for s in self._streams.get(job_type, ())
            })

    def _pick_stream(self, job_type: str,
                     group: tuple | None = None) -> ClientJobStream | None:
        with self._lock:
            streams = self._streams.get(job_type)
            if streams and group is not None:
                streams = [s for s in streams if self._tenant_group(s) == group]
            if not streams:
                return None
            rr_key = (job_type, group)
            idx = self._rr.get(rr_key, 0) % len(streams)
            self._rr[rr_key] = idx + 1
            return streams[idx]

    def _push(self, partition_id: int, job_type: str) -> None:
        """Activate-and-deliver, per tenant-filter group, until the partition
        has no more activatable jobs each group can see or every stream is
        gone."""
        while self._running:
            progressed = False
            for group in self._tenant_groups(job_type):
                stream = self._pick_stream(job_type, group)
                if stream is None:
                    continue
                if not self.runtime.has_activatable_jobs(
                        partition_id, job_type, list(group)):
                    continue
                record = self.runtime.submit(
                    partition_id,
                    command(ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE, {
                        "type": job_type,
                        "worker": stream.worker,
                        "timeout": stream.timeout_ms,
                        "maxJobsToActivate": PUSH_BATCH_SIZE,
                        **({"tenantIds": stream.tenant_ids}
                           if stream.tenant_ids else {}),
                    }),
                )
                if record.is_rejection:
                    continue
                keys = record.value.get("jobKeys", [])
                jobs = record.value.get("jobs", [])
                for key, job in zip(keys, jobs):
                    _t0 = _perf_counter()
                    if self._deliver(stream, key, job):
                        _M_PUSHED.inc()
                        _M_PUSH_LATENCY.observe(_perf_counter() - _t0)
                    else:
                        _M_PUSH_FAIL.inc()
                        if not self._redeliver(job_type, key, job):
                            self._yield_back(key)
                if len(keys) >= PUSH_BATCH_SIZE:
                    progressed = True  # this group may have more to drain
            if not progressed:
                return

    def _deliver(self, stream: ClientJobStream, key: int, job: dict) -> bool:
        """Enqueue under the registry lock so the closed-check and the put are
        atomic against remove_stream's drain."""
        with self._lock:
            if stream.closed:
                return False
            stream.jobs.put((key, job))
            return True

    def _redeliver(self, job_type: str, key: int, job: dict) -> bool:
        """Route an undeliverable job to another live stream of the type that
        is authorized for the job's tenant (never across tenants)."""
        tenant = job.get("tenantId", DEFAULT_TENANT)
        for _ in range(8):
            stream = self._pick_stream(job_type)
            if stream is None:
                return False
            if tenant not in (stream.tenant_ids or [DEFAULT_TENANT]):
                # no eligible stream may exist at all; scan once under lock
                with self._lock:
                    eligible = [
                        s for s in self._streams.get(job_type, ())
                        if tenant in (s.tenant_ids or [DEFAULT_TENANT])
                    ]
                if not eligible:
                    return False
                stream = eligible[0]
            if self._deliver(stream, key, job):
                return True
        return False

    def _yield_back(self, job_key: int) -> None:
        try:
            self.runtime.submit(
                self.runtime.partition_for_key(job_key),
                command(ValueType.JOB, JobIntent.YIELD, {}, key=job_key),
            )
        except Exception:  # noqa: BLE001 — the job times out eventually anyway
            logger.exception("job yield-back failed for key %s", job_key)
