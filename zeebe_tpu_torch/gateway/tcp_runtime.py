"""Deployable multi-process cluster runtime: ONE broker per process over TCP.

Reference: dist/…/StandaloneBroker.java + BrokerCfg cluster section (node id,
initial contact points) and the gateway's BrokerClient routing
(impl/broker/BrokerRequestManager.java — requests go to the partition leader,
responses return to the requesting gateway).

Each process runs one Broker over TcpMessagingService; Raft, SWIM membership,
inter-partition commands, and deployment distribution all ride the same TCP
messaging the loopback tests exercise. The local gateway routes client
commands: leader-local writes go straight in; remote leaders receive the
command over the broker command-api topic, and the processing side's client
response is routed back to the ORIGIN gateway via its request_stream_id
(which encodes the origin node index — the reference does the same with
gateway stream ids over atomix messaging).

The port's runtime takes the kernel backend's ``device`` (None = CUDA,
raising without it; ``"cpu"`` runs the plain version) and gives it to its
broker; the rest is the reference's, copied."""

from __future__ import annotations

import itertools
import threading
import time

from zeebe_tpu_torch.broker.broker import COMMAND_API_TOPIC, Broker, BrokerCfg
from zeebe_tpu_torch.cluster.messaging import TcpMessagingService
from zeebe_tpu_torch.gateway.broker_client import (
    GatewayRuntimeBase,
    NoLeaderError,
    ResourceExhaustedError,
)
from zeebe_tpu_torch.protocol import Record

# copied from the reference: GATEWAY_RESPONSE_TOPIC .. JOBS_AVAILABLE_TOPIC
GATEWAY_RESPONSE_TOPIC = "gateway-response"
JOBS_AVAILABLE_TOPIC = "jobs-available"
# end of the copy


class TcpClusterRuntime(GatewayRuntimeBase):
    """The gateway-facing runtime for one deployed broker process. Implements
    the same surface as the in-process ClusterRuntime (submit, partition
    selection, topology) against a single local Broker + TCP peers."""

    def __init__(self, node_id: str, bind: tuple[str, int],
                 peers: dict[str, tuple[str, int]],
                 partition_count: int = 1, replication_factor: int = 1,
                 directory=None, kernel_backend: bool = True,
                 tls=None, device=None, **broker_kwargs) -> None:
        self.node_id = node_id
        self.partition_count = partition_count
        members = sorted(set(peers) | {node_id})
        self._members = members
        self._node_index = members.index(node_id)
        self.messaging = TcpMessagingService(node_id, bind, peers, tls=tls)
        self.messaging.start()
        self.messaging.subscribe(GATEWAY_RESPONSE_TOPIC, self._on_remote_response)
        self.messaging.subscribe(JOBS_AVAILABLE_TOPIC, self._on_remote_jobs_available)
        cfg = BrokerCfg(
            node_id=node_id, partition_count=partition_count,
            replication_factor=replication_factor, cluster_members=members,
            kernel_backend=kernel_backend, device=device,
        )
        self.broker = Broker(
            cfg, self.messaging, directory=directory,
            response_sink=self._on_local_response, **broker_kwargs,
        )
        self._lock = threading.RLock()
        self._init_requests()
        self._init_jobstreams()
        self.broker.jobs_listener = self._on_local_jobs_available
        self._running = False
        self._thread: threading.Thread | None = None

    # -- pump ------------------------------------------------------------------

    # copied from the reference: start .. submit
    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"runtime-{self.node_id}")
        self._thread.start()
        self.job_streams.start()

    def _run(self) -> None:
        while self._running:
            with self._lock:
                moved = self.messaging.poll()
                self.broker.pump()
            if moved == 0:
                time.sleep(0.001)

    def stop(self) -> None:
        self.job_streams.stop()
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            self.broker.close()
        self.messaging.stop()

    def await_leaders(self, timeout_s: float = 60.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                ready = all(
                    self.broker.known_leader(p) is not None
                    for p in range(1, self.partition_count + 1)
                )
            if ready:
                return
            time.sleep(0.05)
        raise RuntimeError("partition leaders not elected in time")

    # -- response routing ------------------------------------------------------

    def _on_local_response(self, response) -> None:
        """Processing on the LOCAL broker produced a client response: resolve
        it locally if this gateway originated the request, else route it to
        the origin gateway by its stream id."""
        origin = response.request_stream_id
        if origin == self._node_index:
            self._resolve_request(response.request_id, response.record)
            return
        if 0 <= origin < len(self._members):
            self.messaging.send(
                self._members[origin], GATEWAY_RESPONSE_TOPIC,
                {"requestId": response.request_id,
                 "record": response.record.to_bytes()},
            )

    def _on_remote_response(self, sender: str, payload: dict) -> None:
        self._resolve_request(payload["requestId"],
                              Record.from_bytes(payload["record"]))

    # -- jobs-available fan-out ------------------------------------------------

    def _on_local_jobs_available(self, partition_id: int, job_types: set) -> None:
        """A local partition made jobs activatable: wake this gateway AND the
        peer gateways (their workers may hold the streams/long-polls —
        reference: the broker gossips jobsAvailable to every gateway)."""
        self._on_jobs_available(partition_id, job_types)
        payload = {"partitionId": partition_id, "types": sorted(job_types)}
        for member in self._members:
            if member != self.node_id:
                self.messaging.send(member, JOBS_AVAILABLE_TOPIC, payload)

    def _on_remote_jobs_available(self, sender: str, payload: dict) -> None:
        self._on_jobs_available(payload["partitionId"], set(payload["types"]))

    # -- topology --------------------------------------------------------------

    def topology(self) -> dict:
        """Local broker health + gossiped peers — the full cluster view a
        `zbctl status` expects (reference: BrokerClusterState fed by gossip).
        Remote partition roles come from the membership properties the
        brokers gossip (`Broker._gossip_roles`)."""
        from zeebe_tpu_torch.cluster.membership import MemberState

        with self._lock:
            brokers = [dict(self.broker.health(), member=self.node_id)]
            for member in list(self.broker.membership.members.values()):
                if (member.member_id == self.node_id
                        or member.state == MemberState.DEAD):
                    continue
                roles = member.properties.get("partitions") or {}
                brokers.append({
                    "member": member.member_id,
                    "nodeId": member.member_id,
                    "partitions": [
                        {"partitionId": int(pid), "role": role}
                        for pid, role in sorted(roles.items(),
                                                key=lambda kv: int(kv[0]))
                    ],
                })
            brokers.sort(key=lambda b: str(b.get("member", "")))
            return {
                "clusterSize": len(self._members),
                "partitionsCount": self.partition_count,
                "replicationFactor": self.broker.cfg.replication_factor,
                "brokers": brokers,
            }

    def has_activatable_jobs(self, partition_id: int, job_type: str,
                             tenant_ids: list[str] | None = None) -> bool:
        with self._lock:
            partition = self.broker.partitions.get(partition_id)
            if partition is not None and partition.is_leader and partition.db is not None:
                # committed-read discipline: this runs on a gateway thread —
                # opening the processing-owned transaction slot here raced
                # the pump thread's own transaction (zlint caught it)
                from zeebe_tpu_torch.engine.engine_state import JobState

                return JobState.any_activatable_committed(
                    partition.db, job_type, tenant_ids)
        # remote leader: no cheap peek — let the long-poll try a real
        # activation (an empty JOB_BATCH comes back quickly)
        return True

    # -- request path ----------------------------------------------------------

    def submit(self, partition_id: int, record: Record,
               timeout_s: float = 10.0) -> Record:
        from zeebe_tpu_torch.broker.partition import BackpressureExceeded

        request_id, event = self._register_request()
        rec = record.replace(request_id=request_id,
                             request_stream_id=self._node_index)
        deadline = time.time() + timeout_s
        written = False
        while time.time() < deadline and not written:
            with self._lock:
                partition = self.broker.partitions.get(partition_id)
                if partition is not None and partition.is_leader:
                    try:
                        written = partition.client_write(rec) is not None
                    except BackpressureExceeded as exc:
                        self._pending.pop(request_id, None)
                        raise ResourceExhaustedError(str(exc)) from exc
                else:
                    leader = self.broker.known_leader(partition_id)
                    if leader is not None and leader != self.node_id:
                        self.messaging.send(
                            leader, f"{COMMAND_API_TOPIC}-{partition_id}",
                            {"record": rec.to_bytes()},
                        )
                        written = True  # at-most-once try; retry on timeout
            if not written:
                time.sleep(0.02)
        if not written:
            self._pending.pop(request_id, None)
            raise NoLeaderError(f"no leader for partition {partition_id}")
        return self._take_response(request_id, event, deadline, partition_id, timeout_s)
    # end of the copy
