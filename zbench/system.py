"""The system under test as a cell builds it: the port's in-process cluster
behind its gateway runtime (``ClusterRuntime``, built as
``python -m zeebe_tpu_torch.standalone`` builds its in-process shape, with
the kernel backend on the card and the benchmark's exporter,
``zbench.capture``), the cell's process model deployed, and what the judge
reads back from it once the load has stopped: every replica's committed
batches, the records the exporters saw and the state the instances left.

It reaches the cluster through public names alone: the runtime's
``brokers``, each broker's ``partition_guard`` (the lock a partition's
replicas advance under), ``resolve_leader_partition`` and a replica's
``stream`` and ``engine.state``."""

from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path

from zbench import capture
from zeebe_tpu_torch.broker.broker import resolve_leader_partition
from zeebe_tpu_torch.broker.config import load_broker_cfg
from zeebe_tpu_torch.gateway import ClusterRuntime
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import DeploymentIntent
from zeebe_tpu_torch.utils.external_code import exporters_factory_from_env


def build(config: dict, directory: Path, device) -> ClusterRuntime:
    """The runtime of ``config``'s cluster with its data under
    ``directory``, built from the broker's configuration and its exporters'
    environment (the benchmark's exporter added) as the standalone's
    in-process shape builds it; not started."""
    cfg = load_broker_cfg()
    capture.reset()
    return ClusterRuntime(
        exporters_factory=exporters_factory_from_env({**os.environ, **capture.ENV}),
        kernel_backend=cfg.base.kernel_backend,
        broker_count=config["cluster_size"],
        partition_count=config["partitions_count"],
        replication_factor=config["replication_factor"],
        directory=directory,
        backpressure_algorithm=cfg.backpressure.algorithm,
        backpressure_enabled=cfg.backpressure.enabled,
        disk_min_free_bytes=(cfg.disk.min_free_bytes if cfg.disk.enable_monitoring else 0),
        device=device,
    )


def _guard(runtime: ClusterRuntime, pid: int):
    """The lock partition ``pid``'s replicas advance under."""
    return next(iter(runtime.brokers.values())).partition_guard(pid)


def _leader(runtime: ClusterRuntime, pid: int):
    return resolve_leader_partition(runtime.brokers.values(), pid)


def deploy(runtime: ClusterRuntime, name: str, xml: str, process_id: str,
           timeout_s: float = 60.0) -> None:
    """Deploy one BPMN resource and wait until every partition's leader has
    its process."""
    reply = runtime.submit(1, command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": f"{name}.bpmn", "resource": xml}]}),
        timeout_s=timeout_s)
    if reply.is_rejection:
        raise RuntimeError(f"deployment rejected: {reply.rejection_reason}")
    deadline = time.monotonic() + timeout_s
    while not all(_deployed(runtime, pid, process_id)
                  for pid in range(1, runtime.partition_count + 1)):
        if time.monotonic() > deadline:
            raise RuntimeError("the deployment did not reach every partition")
        time.sleep(0.01)


def _deployed(runtime: ClusterRuntime, pid: int, process_id: str) -> bool:
    with _guard(runtime, pid):
        leader = _leader(runtime, pid)
        if leader is None or leader.db is None:
            return False
        with leader.db.transaction():
            return leader.engine.state.processes.latest_version(process_id) is not None


def _replicas(runtime: ClusterRuntime, pid: int) -> dict:
    return {name: broker.partitions[pid] for name, broker in runtime.brokers.items()
            if pid in broker.partitions}


def settle(runtime: ClusterRuntime, timeout_s: float = 30.0, quiet: int = 3) -> bool:
    """Wait until every replica of every partition holds the same log, the
    exporters have seen all of it, and no log has grown for ``quiet`` polls
    in a row (the load has stopped, so the leaders have processed all they
    will). False when that did not come."""
    deadline = time.monotonic() + timeout_s
    last, still = None, 0
    while time.monotonic() < deadline:
        now = []
        for pid in range(1, runtime.partition_count + 1):
            with _guard(runtime, pid):
                now.append(tuple(p.stream.last_position
                                 for _, p in sorted(_replicas(runtime, pid).items())))
        exported = capture.last_positions()
        same = all(len(set(positions)) == 1 and exported.get(pid, -1) >= positions[0]
                   for pid, positions in enumerate(now, 1))
        still = still + 1 if same and now == last else 0
        if still >= quiet:
            return True
        last = now
        time.sleep(0.05)
    return False


def _batches(stream) -> list[tuple[int, bytes]]:
    journal = stream.journal
    return [(jrec.asqn, hashlib.blake2b(jrec.data, digest_size=16).digest())
            for jrec in journal.read_from(journal.first_index) if jrec.asqn >= 0]


def gather(runtime: ClusterRuntime) -> dict:
    """Each partition's records as its exporters saw them, and every
    replica's committed batches (position and a digest of the bytes) from
    the first that every replica still holds (a snapshot compacts each
    replica's log on its own)."""
    replicas, leaders = {}, {}
    for pid in range(1, runtime.partition_count + 1):
        with _guard(runtime, pid):
            leader = _leader(runtime, pid)
            parts = _replicas(runtime, pid)
            held = {name: _batches(p.stream) for name, p in parts.items()}
            leaders[pid] = next(name for name, p in parts.items() if p is leader)
        start = max((b[0][0] for b in held.values() if b), default=0)
        replicas[pid] = {name: [b for b in batches if b[0] >= start]
                         for name, batches in held.items()}
    return {"logs": capture.logs(), "replicas": replicas, "leaders": leaders}


def leftovers(runtime: ClusterRuntime, logs: dict, checked: dict[int, int]) -> dict:
    """What the state of each instance of ``checked`` (key -> partition)
    still holds: its element instances, its jobs and its variable."""
    out = {}
    by_partition: dict[int, list[int]] = {}
    for key, pid in checked.items():
        by_partition.setdefault(pid, []).append(key)
    for pid, keys in by_partition.items():
        wanted = set(keys)
        elements: dict[int, set] = {k: set() for k in keys}
        jobs: dict[int, set] = {k: set() for k in keys}
        for r in logs[pid]:
            pik = r["value"].get("processInstanceKey") if isinstance(r["value"], dict) else None
            if pik not in wanted:
                continue
            if r["valueType"] == "PROCESS_INSTANCE" and r["intent"] == "ACTIVATE_ELEMENT":
                elements[pik].add(r["key"])
            elif r["valueType"] == "JOB" and r["intent"] == "CREATED":
                jobs[pik].add(r["key"])
        with _guard(runtime, pid):
            state = _leader(runtime, pid).engine.state
            with state.db.transaction():
                for key in keys:
                    held = [f"element instance {k}" for k in sorted(elements[key])
                            if state.element_instances.get(k) is not None]
                    held += [f"job {k}" for k in sorted(jobs[key])
                             if state.jobs.get(k) is not None]
                    if state.variables.has_local(key, "x"):
                        held.append("variable x")
                    if held:
                        out[key] = held
    return out
