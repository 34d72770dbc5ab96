# tests/test_multiproc.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Multi-process mesh scale-out: per-core broker worker processes
behind one gateway — supervisor crash-restart, routing/topology/status over
the gateway protocol, the killable device probe, and trace-context
propagation across the worker-process boundary.

The fast tests wire a real WorkerRuntime and MultiProcClusterRuntime over
the deterministic loopback network in ONE process (the same protocol the TCP
deployment speaks), so tier-1 covers the gateway↔worker envelope without
paying process spawns. The slow tests spawn real worker processes over TCP
and exercise the supervisor's restart path end to end.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.multiproc.supervisor import (
    WorkerSpec,
    WorkerSupervisor,
    worker_cmd,
)
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.protocol.record import command

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_task(pid="p"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type="w")
        .end_event("e").done()
    )


def deploy_cmd(model):
    return command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": f"{model.process_id}.bpmn",
                       "resource": to_bpmn_xml(model)}]})


def create_cmd(pid="p"):
    return command(
        ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": pid, "version": -1, "variables": {}})


# ---------------------------------------------------------------------------
# supervisor (stub workers: no broker, just processes)


def _sleeper(seconds: int = 600) -> list[str]:
    return [sys.executable, "-c", f"import time; time.sleep({seconds})"]


class TestSupervisor:
    def test_restarts_crashed_worker(self):
        sup = WorkerSupervisor(
            [WorkerSpec("w0", _sleeper()), WorkerSpec("w1", _sleeper())],
            env=dict(os.environ), restart_backoff_s=0.05)
        sup.start()
        try:
            pid = sup.pid_of("w0")
            assert pid is not None and sup.alive() == {"w0": True, "w1": True}
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                new_pid = sup.pid_of("w0")
                if new_pid is not None and new_pid != pid:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("supervisor never restarted the crashed worker")
            assert sup.restarts["w0"] == 1
            assert sup.restarts["w1"] == 0
            status = sup.status()
            assert status["w0"]["alive"] and status["w0"]["restarts"] == 1
        finally:
            sup.stop()
        assert not any(sup.alive().values())

    def test_repeated_crashes_back_off(self):
        # a crash-looping worker (exits immediately) restarts with growing
        # backoff instead of spinning
        sup = WorkerSupervisor(
            [WorkerSpec("loop", [sys.executable, "-c", "pass"])],
            env=dict(os.environ), restart_backoff_s=0.05, max_backoff_s=0.2)
        sup.start()
        try:
            time.sleep(1.0)
            restarts = sup.restarts["loop"]
            # 1s at backoffs 0.05→0.1→0.2→0.2… allows only a handful
            assert 1 <= restarts <= 12
        finally:
            sup.stop()

    def test_stop_escalates_to_sigkill(self):
        stubborn = [sys.executable, "-c",
                    "import signal, time; "
                    "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                    "time.sleep(600)"]
        sup = WorkerSupervisor([WorkerSpec("stubborn", stubborn)],
                               env=dict(os.environ), grace_period_s=0.3)
        sup.start()
        try:
            deadline = time.monotonic() + 5
            while not sup.alive().get("stubborn") and time.monotonic() < deadline:
                time.sleep(0.02)
            t0 = time.monotonic()
        finally:
            sup.stop()
        assert time.monotonic() - t0 < 10
        assert not sup.alive()["stubborn"]


# ---------------------------------------------------------------------------
# killable device probe


class TestKillableProbe:
    def test_wedged_probe_killed_at_deadline(self):
        from zeebe_tpu_torch.utils.backend_probe import probe_with_diagnostics

        t0 = time.monotonic()
        res, diag = probe_with_diagnostics(
            probe_cmd=_sleeper(600), timeout=1, use_cache=False)
        elapsed = time.monotonic() - t0
        assert res is None
        assert diag["outcome"] == "probe-killed"
        assert diag["killed"] is True
        assert diag["timeout_s"] == 1
        assert elapsed < 8, f"kill took {elapsed}s — deadline not enforced"

    def test_probe_verdict_memoized_per_process(self):
        # broker startup, worker boot, and mesh construction all consult the
        # probe: the SECOND consult must reuse the verdict, not pay another
        # subprocess deadline
        from zeebe_tpu_torch.utils.backend_probe import probe_with_diagnostics

        cmd = _sleeper(601)  # distinct from other tests' commands
        res1, diag1 = probe_with_diagnostics(probe_cmd=cmd, timeout=1)
        assert res1 is None and "cached" not in diag1
        t0 = time.monotonic()
        res2, diag2 = probe_with_diagnostics(probe_cmd=cmd, timeout=1)
        assert res2 is None
        assert diag2["cached"] is True
        assert time.monotonic() - t0 < 0.5, "cached probe paid the deadline"

    def test_probe_failure_is_a_verdict_not_an_exception(self):
        from zeebe_tpu_torch.utils.backend_probe import probe_with_diagnostics

        res, diag = probe_with_diagnostics(
            probe_cmd=[sys.executable, "-c", "raise SystemExit(3)"],
            timeout=5)
        assert res is None
        assert diag["outcome"] == "nonzero-exit"
        assert diag["rc"] == 3

    def test_probe_timeout_env_override(self, monkeypatch):
        from zeebe_tpu_torch.utils.backend_probe import (
            PROBE_TIMEOUT_SECS,
            probe_timeout_secs,
        )

        monkeypatch.delenv("ZEEBE_PROBE_TIMEOUT_S", raising=False)
        assert probe_timeout_secs() == PROBE_TIMEOUT_SECS
        monkeypatch.setenv("ZEEBE_PROBE_TIMEOUT_S", "7")
        assert probe_timeout_secs() == 7
        monkeypatch.setenv("ZEEBE_PROBE_TIMEOUT_S", "not-a-number")
        assert probe_timeout_secs() == PROBE_TIMEOUT_SECS


# ---------------------------------------------------------------------------
# gateway ↔ worker protocol over the deterministic loopback (fast, tier-1)


class _LoopbackCluster:
    """One WorkerRuntime + one MultiProcClusterRuntime in-process, pumped by
    a background thread — the full gateway protocol without process spawns."""

    def __init__(self, tmp_path, partition_count=2):
        from zeebe_tpu_torch.broker.broker import BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
        from zeebe_tpu_torch.multiproc.worker import WorkerRuntime

        self.net = LoopbackNetwork()
        cfg = BrokerCfg(node_id="worker-0", partition_count=partition_count,
                        replication_factor=1, cluster_members=["worker-0"],
                        kernel_backend=False, device="cpu")
        self.worker = WorkerRuntime(
            "worker-0", self.net.join("worker-0"), ["gateway-0"], cfg,
            directory=tmp_path / "worker-0", status_interval_ms=50)
        self.gateway = MultiProcClusterRuntime(
            "gateway-0", {"worker-0": ("loopback", 0)},
            partition_count=partition_count,
            messaging=self.net.join("gateway-0"))
        self.gateway.start()
        self._running = True
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()
        self.gateway.await_leaders(timeout_s=30)

    def _pump(self):
        while self._running:
            moved = self.worker.pump()
            moved += self.net.deliver_all()
            if not moved:
                time.sleep(0.001)

    def close(self):
        self._running = False
        self._thread.join(timeout=5)
        self.gateway.stop()
        self.worker.close()


class TestLoopbackProtocol:
    def test_end_to_end_routing_topology_and_status(self, tmp_path):
        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            topo = gw.topology()
            assert topo["clusterSize"] == 1
            assert topo["partitionsCount"] == 2
            roles = {p["partitionId"]: p["role"]
                     for p in topo["brokers"][0]["partitions"]}
            assert roles == {1: "leader", 2: "leader"}

            resp = gw.submit(1, deploy_cmd(one_task()))
            assert resp.intent == DeploymentIntent.CREATED
            created = gw.submit(2, create_cmd())
            assert created.value["processInstanceKey"] > 0

            status = gw.cluster_status()
            assert status["clusterSize"] == 1
            assert status["health"] == "HEALTHY"
            assert status["partitionsCount"] == 2
            row = status["brokers"][0]
            assert row["nodeId"] == "worker-0"
            assert row["workerPid"] == os.getpid()
            assert set(row["partitions"]) == {"1", "2"}
        finally:
            cluster.close()

    def test_unknown_partition_and_backpressure_surface(self, tmp_path):
        from zeebe_tpu_torch.gateway.broker_client import (
            NoLeaderError,
            ResourceExhaustedError,
        )

        cluster = _LoopbackCluster(tmp_path, partition_count=1)
        try:
            gw = cluster.gateway
            with pytest.raises(NoLeaderError):
                gw.submit(9, create_cmd())
            gw.submit(1, deploy_cmd(one_task()))
            # a saturated limiter surfaces RESOURCE_EXHAUSTED through the
            # typed error frame (the raw command-api topic would silently
            # time the request out instead)
            partition = cluster.worker.broker.partitions[1]
            original = partition.limiter.try_acquire
            partition.limiter.try_acquire = lambda record: False
            try:
                with pytest.raises(ResourceExhaustedError):
                    gw.submit(1, create_cmd(), timeout_s=5.0)
            finally:
                partition.limiter.try_acquire = original
            # ...and the partition keeps serving afterwards
            created = gw.submit(1, create_cmd(), timeout_s=10.0)
            assert created.value["processInstanceKey"] > 0
        finally:
            cluster.close()

    def test_trace_context_crosses_the_worker_boundary(self, tmp_path):
        """Satellite: gateway request id + derivable trace id ride the
        command envelope; `cli trace`'s lineage walker reconstructs the
        causal tree from the worker's journal alone, with the root
        annotated by the SAME request id the gateway's root span carries."""
        from zeebe_tpu_torch.journal import SegmentedJournal
        from zeebe_tpu_torch.logstreams import LogStream
        from zeebe_tpu_torch.observability import (
            collect_lineage,
            configure_tracing,
            get_tracer,
        )

        configure_tracing(enabled=True, seed=0, sample_rate=1.0)
        cluster = _LoopbackCluster(tmp_path, partition_count=1)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(one_task()))
            created = gw.submit(1, create_cmd())
            instance_key = created.value["processInstanceKey"]
            from zeebe_tpu_torch.protocol.intent import JobBatchIntent

            for _ in range(100):
                jobs = gw.submit(1, command(
                    ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE,
                    {"type": "w", "maxJobsToActivate": 5, "timeout": 10_000,
                     "worker": "t"}))
                if jobs.value.get("jobKeys"):
                    break
                time.sleep(0.05)
            assert jobs.value.get("jobKeys"), "job never activatable"
            gw.submit(1, command(ValueType.JOB, JobIntent.COMPLETE,
                                 {"variables": {}},
                                 key=jobs.value["jobKeys"][0]))

            spans = get_tracer().collector.snapshot()
            roots = [s for s in spans if s.name == "gateway.request"]
            ingress = [s for s in spans if s.name == "gateway.ingress"]
            assert roots and ingress
            # the trace id is DERIVED identically on both sides of the
            # process boundary: every gateway root span has a matching
            # worker-side ingress span for the same trace id
            ingress_ids = {s.trace_id for s in ingress}
            root_by_id = {s.trace_id: s for s in roots}
            assert set(root_by_id) <= ingress_ids
            create_roots = [
                s for s in roots
                if s.attrs.get("valueType") == "PROCESS_INSTANCE_CREATION"]
            assert create_roots
            create_span = create_roots[0]
            assert create_span.attrs["worker"] == "worker-0"
        finally:
            cluster.close()
            configure_tracing(enabled=False)

        # offline lineage over the worker's journal (the cli trace path):
        # the root command carries the gateway request id from the span
        journal_dir = tmp_path / "worker-0" / "partition-1" / "stream"
        journal = SegmentedJournal(journal_dir)
        try:
            stream = LogStream(journal, 1)
            lineage = collect_lineage(stream, instance_key)
            assert lineage["roots"], "no lineage reconstructed"
            request_ids = {t.get("gatewayRequestId")
                           for t in lineage["roots"]} - {None}
            assert create_span.attrs["requestId"] in request_ids
            # the creation root's position IS the span's trace id tail
            create_position = int(create_span.trace_id.split(":")[1])
            assert any(t["position"] == create_position
                       for t in lineage["roots"])
        finally:
            journal.close()


# ---------------------------------------------------------------------------
# real worker processes over TCP (slow)


from zeebe_tpu_torch.standalone import _free_ports  # noqa: E402 — shared helper


def _worker_env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND="false")


@pytest.mark.slow
class TestRealWorkerProcesses:
    def _boot(self, tmp_path, workers=2, partitions=2):
        from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime

        names = [f"worker-{i}" for i in range(workers)]
        ports = _free_ports(workers + 1)
        contacts = {n: ("127.0.0.1", p) for n, p in zip(names, ports)}
        contacts["gateway-0"] = ("127.0.0.1", ports[-1])
        contact_str = ",".join(
            f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))
        specs = [
            WorkerSpec(
                node_id=n,
                cmd=worker_cmd(n, f"127.0.0.1:{contacts[n][1]}", contact_str,
                               "gateway-0", partitions, 1,
                               data_dir=str(tmp_path / n), device="cpu"),
                data_dir=str(tmp_path / n))
            for n in names
        ]
        supervisor = WorkerSupervisor(specs, env=_worker_env(),
                                      restart_backoff_s=0.2)
        runtime = MultiProcClusterRuntime(
            "gateway-0", {m: a for m, a in contacts.items()
                          if m != "gateway-0"},
            partition_count=partitions, bind=contacts["gateway-0"],
            supervisor=supervisor)
        runtime.start()
        return runtime

    def test_cluster_serves_and_partitions_spread_across_processes(
            self, tmp_path):
        runtime = self._boot(tmp_path)
        try:
            runtime.await_leaders(timeout_s=120)
            resp = runtime.submit(1, deploy_cmd(one_task()), timeout_s=30)
            assert resp.intent == DeploymentIntent.CREATED
            keys = []
            for pid in (1, 2):
                created = runtime.submit(pid, create_cmd(), timeout_s=30)
                keys.append(created.value["processInstanceKey"])
            assert len(set(keys)) == 2
            topo = runtime.topology()
            leaders = {
                p["partitionId"]: b["nodeId"]
                for b in topo["brokers"] for p in b["partitions"]
                if p["role"] == "leader"
            }
            # round-robin distribution: the two partitions lead on DIFFERENT
            # worker processes — the per-core scale-out shape
            assert set(leaders) == {1, 2}
            assert len(set(leaders.values())) == 2
            status = runtime.cluster_status()
            pids = {w["pid"] for w in status["workers"].values()}
            assert os.getpid() not in pids and len(pids) == 2
        finally:
            runtime.stop()

    def test_supervisor_crash_restart_recovers_via_pr6_path(self, tmp_path):
        """Satellite: SIGKILL a worker mid-service; the supervisor restarts
        it, the partition recovers over its data dir snapshot+replay),
        and the recovery event is visible on /cluster/status."""
        runtime = self._boot(tmp_path, workers=1, partitions=1)
        try:
            runtime.await_leaders(timeout_s=120)
            runtime.submit(1, deploy_cmd(one_task()), timeout_s=30)
            first = runtime.submit(1, create_cmd(), timeout_s=30)
            assert first.value["processInstanceKey"] > 0

            sup = runtime.supervisor
            old_pid = sup.pid_of("worker-0")
            sup.kill_worker("worker-0")
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                new_pid = sup.pid_of("worker-0")
                if new_pid is not None and new_pid != old_pid:
                    break
                time.sleep(0.05)
            else:
                pytest.fail("worker never restarted")
            assert sup.restarts["worker-0"] >= 1
            runtime.await_leaders(timeout_s=120)

            # the restarted worker serves again over the recovered state
            second = runtime.submit(1, create_cmd(), timeout_s=60)
            assert second.value["processInstanceKey"] > 0

            # recovery accounting crossed the process boundary
            deadline = time.monotonic() + 30
            recovery = None
            while time.monotonic() < deadline and recovery is None:
                status = runtime.cluster_status()
                for row in status["brokers"]:
                    rec = row.get("recoveries", {}).get("1")
                    if rec:
                        recovery = rec
                time.sleep(0.1)
            assert recovery is not None, "no recovery event on /cluster/status"
            assert recovery["replayRecords"] >= 0 and "durationMs" in recovery
            assert status["workers"]["worker-0"]["restarts"] >= 1
        finally:
            runtime.stop()
