"""Gateway-side runtime for the multi-process cluster: route client commands
to per-core worker processes, aggregate topology and /cluster/status.

Implements the same surface as the in-process ``ClusterRuntime`` and the
one-broker ``TcpClusterRuntime`` (``submit``, partition selection,
``topology``, ``cluster_status``, jobs-available), so the gRPC gateway, the
management server, and ``cli top`` work unchanged — the client cannot tell
whether partitions live in this interpreter or in worker processes.

Routing: the gateway joins the TCP cluster as a messaging member (it hosts
no partitions and takes no part in Raft/SWIM). Worker leadership is learned
from the workers' ``worker-status`` pushes; commands go to the leader over
``mp-client-command-<partition>`` with the gateway request id on the
envelope, and responses return over ``mp-gateway-response`` addressed by the
record's ``request_stream_id`` (the gateway's index in the sorted member
list — both sides derive it, no handshake). A typed error frame
(``not-leader`` / ``backpressure`` / ``unavailable``) resolves the request
immediately instead of letting it time out: ``not-leader`` means the worker
did NOT append, so the gateway may safely re-route the SAME request id after
the next status refresh.

Tracing (Dapper discipline,: the response carries the command's
position, so the gateway mints its root ``gateway.request`` span with the
derived trace id ``partition:position`` — the same id the worker-side
ingress/processing/export spans key on. One trace, two processes, zero
extra wire fields beyond the request id the record already carries.

The port routes to the leader of the highest term among the fresh status
rows (``_leader_of``); the reference takes the first row in member order
that says leader, so a killed worker's last row kept its partitions routed
to the dead process until the row went stale (15 s), past the 10 s
default deadline of a request, whenever the worker restarted slower than
that. A supervised worker's status row counts only while the process
that pushed it lives (its ``workerPid`` is the supervisor's): a killed
worker leads nothing, a push still in flight from it is dropped, and its
restart drops its last row. A request whose leader died waits for the
next leader's row and goes there at once, instead of resending to a
process that is dead or still starting (~18 s on the card) through its
backoff (1, 3, 7 s). The rest is the reference's, copied.
"""

from __future__ import annotations

import os
import threading
import time

from zeebe_tpu_torch.gateway.admission import AdmissionCfg, AdmissionController
from zeebe_tpu_torch.gateway.broker_client import (
    DeadlineExceededError,
    GatewayRuntimeBase,
    NoLeaderError,
    ResourceExhaustedError,
)
from zeebe_tpu_torch.multiproc.worker import (
    CLIENT_COMMAND_TOPIC,
    GATEWAY_RESPONSE_TOPIC,
    JOBS_AVAILABLE_TOPIC,
    WORKER_STATUS_TOPIC,
)
from zeebe_tpu_torch.protocol import Record

#: a worker silent for this long is considered stale for leader routing
# copied from the reference: STALE_STATUS_MS .. _M_REQUEST_TIMEOUTS
STALE_STATUS_MS = 15_000

#: overall per-request deadline default (``ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS``)
DEFAULT_REQUEST_TIMEOUT_MS = 30_000


def request_timeout_s() -> float:
    """The bounded-resend ceiling: no request outlives this, however long
    the caller's own timeout is — a dead partition surfaces a typed
    DEADLINE_EXCEEDED instead of an unbounded retry loop."""
    try:
        ms = int(os.environ.get("ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS", ""))
    except ValueError:
        ms = DEFAULT_REQUEST_TIMEOUT_MS
    return max(ms, 1) / 1000.0


from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG  # noqa: E402

_M_REQUEST_TIMEOUTS = _REG.counter(
    "gateway_request_timeouts_total",
    "client requests abandoned at the overall gateway deadline "
    "(DEADLINE_EXCEEDED)", ("partition",))
# end of the copy


class MultiProcClusterRuntime(GatewayRuntimeBase):
    """The gateway's view of a supervised multi-process worker cluster."""

    # copied from the reference: __init__ .. await_leaders
    def __init__(self, node_id: str, workers: dict[str, tuple[str, int]],
                 partition_count: int, replication_factor: int = 1,
                 bind: tuple[str, int] | None = None,
                 supervisor=None, messaging=None,
                 gateway_members: list[str] | None = None,
                 admission: AdmissionController | None = None) -> None:
        self.node_id = node_id
        self.partition_count = partition_count
        self.replication_factor = replication_factor
        self.worker_members = sorted(workers)
        # stream-id derivation must MATCH the workers' _route_members
        # (sorted union of broker members and EVERY gateway): with multiple
        # gateways, pass the same gateway list the workers got via
        # --gateway, or responses route to the wrong gateway
        self._members = sorted(
            set(workers) | set(gateway_members or ()) | {node_id})
        self._stream_id = self._members.index(node_id)
        self.supervisor = supervisor
        if messaging is None:
            from zeebe_tpu_torch.cluster.messaging import TcpMessagingService

            if bind is None:
                raise ValueError("bind is required without injected messaging")
            messaging = TcpMessagingService(node_id, bind, dict(workers))
        self.messaging = messaging
        self._owns_messaging = hasattr(messaging, "start")
        self._init_requests()
        self._init_jobstreams()
        # error frames ride the same response table as records; submit()
        # inspects the type
        self._worker_status: dict[str, dict] = {}
        self._status_seen_ms: dict[str, float] = {}
        # cluster-routing observability: the gateway's own flight
        # recorder (node-level ring; no data dir — served live, dumped
        # never) records worker restarts and routing-table epoch changes
        from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

        self.flight = FlightRecorder(node_id, data_dir=None)
        # tenant-aware admission + cooperative shedding: every
        # client command passes the controller before it is routed; sheds
        # are typed RESOURCE_EXHAUSTED and land in this flight recorder
        self.admission = admission if admission is not None else \
            AdmissionController(AdmissionCfg.from_env(), node_id=node_id,
                                flight=self.flight)
        self.routing_epoch = 0
        self._last_leaders: dict[int, str | None] = {}
        if supervisor is not None:
            supervisor.on_restart = self._on_worker_restart
        messaging.subscribe(GATEWAY_RESPONSE_TOPIC, self._on_worker_response)
        messaging.subscribe(WORKER_STATUS_TOPIC, self._on_worker_status)
        messaging.subscribe(JOBS_AVAILABLE_TOPIC, self._on_remote_jobs_available)
        self._running = False
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._owns_messaging:
            start = getattr(self.messaging, "start", None)
            if start is not None and getattr(self.messaging, "_thread", None) is None:
                start()
        if self.supervisor is not None:
            self.supervisor.start()
        self._running = True
        poll = getattr(self.messaging, "poll", None)
        if poll is not None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=f"mp-gateway-{self.node_id}")
            self._thread.start()
        self.job_streams.start()

    def _run(self) -> None:
        poll = self.messaging.poll
        while self._running:
            # the shed ladder's feedback loop rides the poll thread
            # (throttled internally to its tick interval)
            self.admission.tick()
            if poll() == 0:
                time.sleep(0.001)

    def stop(self) -> None:
        # robust against a partially-started runtime (boot-failure teardown
        # path): whatever else breaks, the supervisor MUST be stopped — it
        # is the only thing that can tear down the detached workers
        try:
            self.job_streams.stop()
        except Exception:  # noqa: BLE001
            pass
        self._dump_spans()
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            if self.supervisor is not None:
                self.supervisor.stop()
        finally:
            stop = getattr(self.messaging, "stop", None)
            if stop is not None:
                stop()

    def _dump_spans(self) -> None:
        """Persist this gateway's span ring as ``spans-<node>-<pid>.jsonl``
        under ``ZEEBE_TRACE_DUMP_DIR`` (the gateway owns no data dir — the
        harness that wants merged cluster traces points every process at a
        shared dump dir). The offline assembler joins these per-process
        dumps by derived trace id."""
        import os

        from zeebe_tpu_torch.observability.tracer import get_tracer

        dump_dir = os.environ.get("ZEEBE_TRACE_DUMP_DIR")
        tracer = get_tracer()
        if not dump_dir or not tracer.enabled or not len(tracer.collector):
            return
        from pathlib import Path

        path = (Path(dump_dir)
                / f"spans-{self.node_id}-{os.getpid()}.jsonl")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tracer.collector.to_jsonl(path)
        except OSError:
            pass  # best-effort evidence; shutdown must not fail on a dump

    def ready(self) -> bool:
        """Readiness: every partition has a live (non-stale) leader AND the
        admission controller is not draining (sustained shedding of new work
        degrades /ready so an LB can rotate this gateway out while
        completions keep draining)."""
        if self.admission.draining:
            return False
        return all(self._leader_of(p) is not None
                   for p in range(1, self.partition_count + 1))

    def await_leaders(self, timeout_s: float = 60.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if all(self._leader_of(p) is not None
                   for p in range(1, self.partition_count + 1)):
                return
            time.sleep(0.05)
        raise RuntimeError("partition leaders not elected in time")
    # end of the copy

    # -- worker status ---------------------------------------------------------

    def _on_worker_status(self, sender: str, payload: dict) -> None:
        status = payload.get("status")
        if isinstance(status, dict):
            if (self.supervisor is not None
                    and status.get("workerPid") != self.supervisor.pid_of(sender)):
                # a row of a life that has ended (a push still in flight
                # when the process died): not the member's any more
                return
            self._worker_status[sender] = status
            self._status_seen_ms[sender] = time.time() * 1000.0
            self._observe_routing_table()

    def _on_worker_restart(self, node_id: str, restarts: int) -> None:
        # the dead life's last row names partitions it no longer leads:
        # forget it until the new life pushes its own
        self._worker_status.pop(node_id, None)
        self.flight.record(0, "worker_restart", worker=node_id,
                           restarts=restarts)

    # copied from the reference: _observe_routing_table .. _on_remote_jobs_available
    def _observe_routing_table(self) -> None:
        """Bump the routing epoch when the leader map changes — every
        re-route decision is attributable to a concrete epoch in the
        flight recorder."""
        leaders = {p: self._leader_of(p)
                   for p in range(1, self.partition_count + 1)}
        if leaders != self._last_leaders:
            self._last_leaders = leaders
            self.routing_epoch += 1
            self.flight.record(0, "routing_epoch", epoch=self.routing_epoch,
                               leaders={str(p): m
                                        for p, m in leaders.items()})

    def _on_remote_jobs_available(self, sender: str, payload: dict) -> None:
        self._on_jobs_available(payload["partitionId"], set(payload["types"]))
    # end of the copy

    def _leader_of(self, partition_id: int) -> str | None:
        """The member whose fresh status names it the partition's leader in
        the highest term (the first in member order on a tie). A worker
        that died keeps its last row, naming it leader, until the row goes
        stale; the member elected after it pushes a higher term, and
        routing follows that one at once instead of the dead member's row
        winning by its place in the member list. A supervised worker's row
        counts only while the process that pushed it lives (its
        ``workerPid`` is the supervisor's), and a restart drops the dead
        life's row (``_on_worker_restart``): until a new leader's row
        arrives, a request waits for it instead of going to a dead or
        still-starting process."""
        now_ms = time.time() * 1000.0
        key = str(partition_id)
        best, best_term = None, None
        for member in self.worker_members:
            status = self._worker_status.get(member)
            if status is None:
                continue
            if (self.supervisor is not None
                    and status.get("workerPid") != self.supervisor.pid_of(member)):
                continue  # its process died: a dead life leads nothing
            if now_ms - self._status_seen_ms.get(member, 0.0) > STALE_STATUS_MS:
                continue  # silent worker: likely dead, don't route to it
            part = status.get("partitions", {}).get(key, {})
            if part.get("role") != "leader":
                continue
            term = part.get("term", -1)
            if best_term is None or term > best_term:
                best, best_term = member, term
        return best

    # -- topology / status -----------------------------------------------------

    # copied from the reference: topology .. _on_worker_response
    def topology(self) -> dict:
        brokers = []
        for member in self.worker_members:
            status = self._worker_status.get(member)
            partitions = []
            if status is not None:
                partitions = [
                    {"partitionId": int(pid), "role": info.get("role", "?")}
                    for pid, info in sorted(
                        status.get("partitions", {}).items(),
                        key=lambda kv: int(kv[0]))
                ]
            brokers.append({"member": member, "nodeId": member,
                            "partitions": partitions})
        return {
            "clusterSize": len(self.worker_members),
            "partitionsCount": self.partition_count,
            "replicationFactor": self.replication_factor,
            "brokers": brokers,
        }

    def cluster_status(self) -> dict:
        """The /cluster/status aggregation, fed by worker status pushes
        instead of in-process fan-out — same shape as
        ``broker.management.cluster_status`` plus a ``workers`` supervision
        section (pids, restarts, liveness)."""
        order = ["HEALTHY", "DEGRADED", "UNHEALTHY", "DEAD"]
        rows = []
        worst = "HEALTHY"
        now_ms = time.time() * 1000.0
        for member in self.worker_members:
            status = self._worker_status.get(member)
            if status is None:
                rows.append({"nodeId": member, "health": "DEAD",
                             "partitions": {}, "stale": True})
                worst = "DEAD"
                continue
            row = dict(status)
            age = now_ms - self._status_seen_ms.get(member, 0.0)
            if age > STALE_STATUS_MS:
                row["stale"] = True
                worst = "DEAD"
            health = row.get("health", "HEALTHY")
            if health in order and order.index(health) > order.index(worst):
                worst = health
            rows.append(row)
        partition_ids = {
            pid for row in rows for pid in row.get("partitions", {})
        }
        out = {
            "clusterSize": len(rows),
            "partitionsCount": max(len(partition_ids), self.partition_count),
            "health": worst,
            "alertsFiring": sum(r.get("alertsFiring", 0) for r in rows),
            "appendPerSec": round(sum(
                r.get("rates", {}).get("appendPerSec", 0.0) for r in rows), 1),
            "processedPerSec": round(sum(
                r.get("rates", {}).get("processedPerSec", 0.0)
                for r in rows), 1),
            "topology": {"members": {
                r.get("nodeId", "?"): {"partitions": r.get("partitions", {})}
                for r in rows
            }},
            "brokers": rows,
        }
        out["routingEpoch"] = self.routing_epoch
        # admission + shed counters ride /cluster/status: the
        # gateway's own gate plus whatever the workers pushed in their rows
        out["admission"] = self.admission.snapshot()
        if self.supervisor is not None:
            out["workers"] = self.supervisor.status()
        return out

    def has_activatable_jobs(self, partition_id: int, job_type: str,
                             tenant_ids: list[str] | None = None) -> bool:
        # no local state to peek: let the long-poll write a real activation
        # (an empty JOB_BATCH comes back quickly) — same as the TCP runtime's
        # remote-leader case
        return True

    # -- request path ----------------------------------------------------------

    def _on_worker_response(self, sender: str, payload: dict) -> None:
        request_id = payload.get("requestId")
        event = self._pending.get(request_id)
        if event is None:
            return
        error = payload.get("error")
        if error is not None:
            self._responses[request_id] = {**error, "from": sender}
        else:
            self._responses[request_id] = {
                "record": Record.from_bytes(payload["record"]),
                "commandPosition": payload.get("commandPosition", -1),
                # "replayed": the worker answered from the replicated dedupe
                # table instead of processing (a resend of an answered
                # request) — surfaced to the consistency checker
                "dedupe": payload.get("dedupe"),
            }
        event.set()
    # end of the copy

    def submit(self, partition_id: int, record: Record,
               timeout_s: float = 10.0, meta: dict | None = None) -> Record:
        """Route a command to the partition leader and await the reply.

        Bounded: the effective deadline is
        ``min(timeout_s, ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS)``; expiry raises
        a typed :class:`DeadlineExceededError` and increments
        ``gateway_request_timeouts_total`` instead of retrying forever
        against a dead partition. ``meta`` (optional dict) is filled with
        routing evidence — resends, re-routes, the answering worker, the
        command position, and whether the reply was a dedupe replay — for
        the consistency harness's history."""
        from zeebe_tpu_torch.observability.tracer import get_tracer

        if not 1 <= partition_id <= self.partition_count:
            raise NoLeaderError(f"unknown partition {partition_id}")
        # admission-gate entry: the root span covers from HERE so the
        # critical-path sweep can see the admission wait as a queue edge
        t_enter = time.perf_counter()
        # tenant admission: typed, fast shed — no routing, no
        # worker round trip, no queue. The caller sees RESOURCE_EXHAUSTED
        # with the reason; the flight recorder carries the evidence.
        shed_reason, tenant, _priority = self.admission.try_admit(record)
        if shed_reason is not None:
            if meta is not None:
                meta.update(tenant=tenant, shed=shed_reason)
            raise ResourceExhaustedError(
                f"admission shed ({shed_reason}): tenant {tenant!r} on "
                f"partition {partition_id} (shed level "
                f"{self.admission.shed_level})")
        if meta is not None:
            meta.update(tenant=tenant)
        t_admitted = time.perf_counter()
        # feed the shed ladder only latencies that measure the CLUSTER:
        # engine replies and deadline expiries. Typed fast errors
        # (backpressure, not-leader) would read as "fast" and mask overload.
        observe_latency = False
        tracer = get_tracer()
        traced = tracer.enabled
        request_id = None
        try:
            request_id, event = self._register_request()
            rec = record.replace(request_id=request_id,
                                 request_stream_id=self._stream_id)
            payload = {"record": rec.to_bytes(), "requestId": request_id}
        except BaseException:
            # nothing was sent: the admitted in-flight slot must not leak —
            # an unserializable record value (to_bytes raising) would
            # otherwise inflate this tenant's count until the fair-share
            # gate sheds everyone forever
            if request_id is not None:
                self._pending.pop(request_id, None)
            self.admission.release(tenant)
            raise
        effective_timeout = min(timeout_s, request_timeout_s())
        deadline = time.time() + effective_timeout
        sent_to: str | None = None
        resend_slice = 1.0
        sends = 0
        reroutes = 0
        # a member that answered not-leader/unavailable is not re-routed to
        # until a NEWER status push from it arrives — the stale table that
        # mis-routed us would otherwise bounce the same envelope (and
        # produce duplicate typed frames) every retry tick
        refused_member: str | None = None
        refused_seen_ms = 0.0
        if meta is not None:
            meta.update(requestId=request_id, resends=0, reroutes=0)

        def _fill_meta(**kw) -> None:
            if meta is not None:
                meta.update(resends=max(sends - 1, 0), reroutes=reroutes,
                            worker=sent_to, **kw)

        try:
            while time.time() < deadline:
                leader = self._leader_of(partition_id)
                if (leader is not None and leader == refused_member
                        and self._status_seen_ms.get(leader, 0.0)
                        <= refused_seen_ms):
                    leader = None  # its refusal postdates our routing info
                if leader is None and sent_to is None:
                    time.sleep(0.02)
                    continue
                if sent_to is None:
                    sent_to = leader
                if not event.is_set():
                    # a restored wakeup (late reply raced a not-leader frame)
                    # means a response is already waiting — consume it below
                    # instead of sending a redundant envelope
                    sends += 1
                    self.messaging.send(
                        sent_to, f"{CLIENT_COMMAND_TOPIC}-{partition_id}",
                        payload)
                # bounded wait per send, then RESEND with backoff. A resend
                # normally targets the SAME worker (its dedupe map makes it
                # idempotent); when the routing table names a DIFFERENT
                # leader — the first worker died or lost leadership — the
                # resend re-routes there. Re-routing the same request id
                # without a typed "I did not append" frame used to risk a
                # duplicate append; the replicated dedupe table
                # travels with the partition's log, so the new leader
                # recognizes the first member's append and answers instead
                # of appending again.
                if not event.wait(
                        min(max(deadline - time.time(), 0.001), resend_slice)):
                    if time.time() >= deadline:
                        break  # deadline exceeded below
                    resend_slice = min(resend_slice * 2, 8.0)
                    current = self._leader_of(partition_id)
                    if current is None:
                        # no live leader known (the one sent to died): wait
                        # for the next one's row and send there at once, not
                        # into the void for the rest of the backoff
                        sent_to = None
                        continue
                    if current != sent_to:
                        sent_to = current
                        reroutes += 1
                        self.flight.record(0, "request_reroute",
                                           partition=partition_id,
                                           requestId=request_id,
                                           to=current,
                                           epoch=self.routing_epoch)
                    continue
                response = self._responses.pop(request_id, None)
                if response is None:  # pragma: no cover — resolver raced
                    break  # deadline path below
                if "record" in response:
                    observe_latency = True
                    result: Record = response["record"]
                    _fill_meta(
                        commandPosition=response.get("commandPosition", -1),
                        dedupe=response.get("dedupe"))
                    if traced:
                        self._emit_root_span(
                            tracer, partition_id, record, result,
                            response.get("commandPosition", -1),
                            request_id, sent_to,
                            time.perf_counter() - t_enter,
                            t_admitted - t_enter)
                    return result
                # typed error frame
                kind = response.get("type")
                if kind in ("backpressure", "resource-exhausted"):
                    # resource-exhausted: the WORKER's admission controller
                    # shed it (tenant quota / fair share / shed ladder) —
                    # same typed surface as partition backpressure
                    _fill_meta(error=kind)
                    raise ResourceExhaustedError(
                        response.get("message", kind))
                if kind in ("not-leader", "unavailable"):
                    # the worker did NOT append this request: safe to
                    # re-route the same request id once fresher status
                    # arrives
                    refused_member = response.get("from", sent_to)
                    if refused_member is not None:
                        refused_seen_ms = self._status_seen_ms.get(
                            refused_member, 0.0)
                    event.clear()
                    if request_id in self._responses:
                        # a reply from an earlier resend landed between the
                        # pop above and the clear — restore the wakeup and
                        # keep sent_to so the next iteration consumes it
                        # instead of resending
                        event.set()
                    else:
                        if sent_to is not None:
                            reroutes += 1
                        sent_to = None
                        time.sleep(0.02)
                    continue
                _fill_meta(error=kind)
                raise NoLeaderError(
                    response.get("message", f"worker error {kind!r}"))
            _M_REQUEST_TIMEOUTS.labels(str(partition_id)).inc()
            # a deadline IS an overload observation: feed it to the ladder
            observe_latency = True
            _fill_meta(error="deadline")
            raise DeadlineExceededError(
                f"partition {partition_id} request {request_id} exceeded the "
                f"{effective_timeout:.1f}s gateway deadline "
                f"(last worker {sent_to}, {sends} send(s), "
                f"{reroutes} re-route(s))")
        finally:
            self._pending.pop(request_id, None)
            self._responses.pop(request_id, None)
            self.admission.release(
                tenant,
                latency_ms=((time.perf_counter() - t_admitted) * 1000.0
                            if observe_latency else None))

    # copied from the reference: _emit_root_span .. _emit_root_span
    def _emit_root_span(self, tracer, partition_id: int, record: Record,
                        response: Record, position: int, request_id: int,
                        worker: str | None, latency: float,
                        admit_wait: float = 0.0) -> None:
        tracer.observe_ack("gateway", latency)
        if position < 0:
            return  # worker predates the position-carrying envelope
        trace_id = f"{partition_id}:{position}"
        if not tracer.sampled(trace_id):
            return
        attrs = {"position": position, "requestId": request_id,
                 "valueType": record.value_type.name,
                 "intent": record.intent.name,
                 "worker": worker or "?"}
        if response.is_rejection:
            attrs["rejection"] = response.rejection_type.name
        from zeebe_tpu_torch.observability.span import now_us

        root_start_us = now_us() - int(latency * 1e6)
        tracer.emit(trace_id, "gateway.request", latency, partition_id,
                    attrs=attrs, start_us=root_start_us)
        if admit_wait > 0:
            # admission-gate wait pinned to the FRONT of the root window —
            # a back-dated-from-now emit would charge it to the reply edge
            tracer.emit(trace_id, "gateway.admission", admit_wait,
                        partition_id, parent="gateway.request",
                        attrs={"requestId": request_id},
                        start_us=root_start_us)
    # end of the copy
