# tests/test_ops.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Ops shell tests: metrics, health, backpressure, config binding, disk
monitor, management server (reference: SURVEY §5.5/§5.6, backpressure docs,
dist/shared/management actuator endpoints)."""

from __future__ import annotations

import json
import urllib.request

import pytest

from zeebe_tpu_torch.broker.backpressure import (
    AimdLimit,
    CommandRateLimiter,
    VegasLimit,
)
from zeebe_tpu_torch.broker.config import load_broker_cfg
from zeebe_tpu_torch.broker.disk import DiskSpaceMonitor
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import JobIntent, ProcessInstanceCreationIntent
from zeebe_tpu_torch.utils.health import CriticalComponentsHealthMonitor, HealthStatus
from zeebe_tpu_torch.utils.metrics import MetricsRegistry


class TestMetricsRegistry:
    def test_counter_gauge_histogram_exposition(self):
        reg = MetricsRegistry()
        reg.counter("records_total", "records", ("partition",)).labels("1").inc(3)
        reg.gauge("role").set(1)
        reg.histogram("latency", buckets=(0.1, 1.0)).observe(0.5)
        text = reg.expose()
        assert 'zeebe_records_total{partition="1"} 3.0' in text
        assert "zeebe_role 1" in text
        assert 'zeebe_latency_bucket{le="1.0"} 1' in text
        assert "zeebe_latency_count 1" in text
        assert "# TYPE zeebe_records_total counter" in text

    def test_same_name_returns_same_metric(self):
        reg = MetricsRegistry()
        assert reg.counter("x") is reg.counter("x")


class TestHealthMonitor:
    def test_aggregates_to_worst(self):
        mon = CriticalComponentsHealthMonitor()
        mon.register("a")
        mon.register("b")
        assert mon.is_healthy()
        mon.report("b", HealthStatus.UNHEALTHY, "raft stalled")
        assert mon.status() == HealthStatus.UNHEALTHY
        mon.report("a", HealthStatus.DEAD)
        assert mon.status() == HealthStatus.DEAD

    def test_listeners_fire_on_change_only(self):
        mon = CriticalComponentsHealthMonitor()
        events = []
        mon.add_listener(lambda r: events.append((r.component, r.status)))
        mon.report("x", HealthStatus.UNHEALTHY)
        mon.report("x", HealthStatus.UNHEALTHY)  # no change
        mon.report("x", HealthStatus.HEALTHY)
        assert events == [("x", HealthStatus.UNHEALTHY), ("x", HealthStatus.HEALTHY)]

    def test_degraded_keeps_probes_green_but_shows_in_aggregate(self):
        mon = CriticalComponentsHealthMonitor()
        mon.register("exporter")
        mon.report("exporter", HealthStatus.DEGRADED, "backing off")
        assert mon.status() == HealthStatus.DEGRADED
        assert mon.is_healthy()  # degraded still serves
        mon.report("exporter", HealthStatus.UNHEALTHY)
        assert not mon.is_healthy()

    def test_throwing_listener_does_not_starve_later_listeners(self):
        mon = CriticalComponentsHealthMonitor()
        events = []

        def bad(report):
            raise RuntimeError("listener bug")

        mon.add_listener(bad)
        mon.add_listener(lambda r: events.append((r.component, r.status)))
        mon.report("x", HealthStatus.UNHEALTHY)
        # the later listener saw the change and the monitor is consistent
        assert events == [("x", HealthStatus.UNHEALTHY)]
        assert mon.status() == HealthStatus.UNHEALTHY

    def test_deregister_matching_drops_subcomponents(self):
        mon = CriticalComponentsHealthMonitor()
        mon.report("partition-1", HealthStatus.HEALTHY)
        mon.report("partition-1.exporter-es", HealthStatus.DEGRADED)
        mon.deregister("partition-1")
        mon.deregister_matching("partition-1.")
        assert mon.status() == HealthStatus.HEALTHY


def _cmd():
    return command(ValueType.PROCESS_INSTANCE_CREATION,
                   ProcessInstanceCreationIntent.CREATE, {})


class TestBackpressure:
    def test_fixed_limit_rejects_above_limit(self):
        limiter = CommandRateLimiter("fixed", limit=2)
        assert limiter.try_acquire(_cmd())
        limiter.on_appended(1)
        limiter.on_appended(2)
        assert not limiter.try_acquire(_cmd())
        assert limiter.dropped_total == 1
        limiter.on_processed(1)
        assert limiter.try_acquire(_cmd())

    def test_whitelist_bypasses(self):
        limiter = CommandRateLimiter("fixed", limit=0)
        complete = command(ValueType.JOB, JobIntent.COMPLETE, {}, key=1)
        assert limiter.try_acquire(complete)
        assert not limiter.try_acquire(_cmd())

    def test_aimd_backs_off_on_timeout(self):
        limit = AimdLimit(initial=100, timeout_ms=10)
        limit.on_sample(50.0, 10, dropped=False)  # rtt above timeout
        assert limit.limit < 100
        before = limit.limit
        limit.on_sample(1.0, before, dropped=False)  # fast + loaded: grow
        assert limit.limit == before + 1

    def test_vegas_adapts(self):
        limit = VegasLimit(initial=20)
        for _ in range(5):
            limit.on_sample(10.0, 10, dropped=False)  # rtt == minRTT: no queue
        assert limit.limit > 20
        grown = limit.limit
        for _ in range(50):
            limit.on_sample(1000.0, 10, dropped=False)  # huge queueing
        assert limit.limit < grown


class TestConfigBinding:
    def test_env_binding_and_validation(self):
        cfg = load_broker_cfg(env={
            "ZEEBE_BROKER_CLUSTER_NODEID": "node-7",
            "ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT": "5",
            "ZEEBE_BROKER_CLUSTER_INITIALCONTACTPOINTS": "node-7,node-8",
            "ZEEBE_BROKER_BACKPRESSURE_ALGORITHM": "aimd",
            "ZEEBE_BROKER_BACKPRESSURE_ENABLED": "false",
            "ZEEBE_BROKER_PROCESSING_MAXCOMMANDSINBATCH": "42",
        })
        assert cfg.base.node_id == "node-7"
        assert cfg.base.partition_count == 5
        assert cfg.base.cluster_members == ["node-7", "node-8"]
        assert cfg.backpressure.algorithm == "aimd"
        assert not cfg.backpressure.enabled
        assert cfg.processing.max_commands_in_batch == 42

    def test_invalid_config_rejected(self):
        with pytest.raises(ValueError):
            load_broker_cfg(env={"ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT": "0"})
        with pytest.raises(ValueError):
            load_broker_cfg(env={"ZEEBE_BROKER_BACKPRESSURE_ALGORITHM": "nope"})

    def test_overrides_beat_env(self):
        cfg = load_broker_cfg(
            env={"ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT": "5"},
            overrides={"base.partition_count": 2},
        )
        assert cfg.base.partition_count == 2


class TestDiskMonitor:
    def test_pauses_below_watermark(self, tmp_path):
        clock = {"now": 0}
        monitor = DiskSpaceMonitor(tmp_path, min_free_bytes=1,
                                   interval_ms=100,
                                   clock_millis=lambda: clock["now"])
        events = []
        monitor.listeners.append(events.append)
        assert not monitor.check(0)
        # absurd watermark → out of space
        monitor.min_free_bytes = 2**62
        clock["now"] = 200
        assert monitor.check()
        assert events == [True]
        monitor.min_free_bytes = 1
        clock["now"] = 400
        assert not monitor.check()
        assert events == [True, False]

    def test_stat_failure_treated_as_out_of_space(self, tmp_path):
        """The data directory vanishing mid-run must pause ingestion, not
        kill the tick loop with an OSError."""
        import shutil as _shutil

        clock = {"now": 0}
        data = tmp_path / "data"
        data.mkdir()
        monitor = DiskSpaceMonitor(data, min_free_bytes=1, interval_ms=100,
                                   clock_millis=lambda: clock["now"])
        events = []
        monitor.listeners.append(events.append)
        assert not monitor.check(0)
        _shutil.rmtree(data)
        clock["now"] = 200
        assert monitor.check()  # paused, no crash
        assert monitor.free_bytes() == -1
        assert events == [True]
        data.mkdir()  # volume comes back: ingestion resumes
        clock["now"] = 400
        assert not monitor.check()
        assert events == [True, False]

    def test_throwing_pause_listener_does_not_block_others(self, tmp_path):
        clock = {"now": 0}
        monitor = DiskSpaceMonitor(tmp_path, min_free_bytes=1,
                                   interval_ms=100,
                                   clock_millis=lambda: clock["now"])
        events = []

        def bad(paused):
            raise RuntimeError("listener bug")

        monitor.listeners.append(bad)
        monitor.listeners.append(events.append)
        monitor.min_free_bytes = 2**62
        clock["now"] = 200
        assert monitor.check()
        # the flag flipped and the later listener still heard about it
        assert monitor.out_of_space
        assert events == [True]

    def test_rate_limited(self, tmp_path):
        clock = {"now": 0}
        monitor = DiskSpaceMonitor(tmp_path, min_free_bytes=2**62,
                                   interval_ms=1000,
                                   clock_millis=lambda: clock["now"])
        clock["now"] = 1000
        assert monitor.check()
        monitor.min_free_bytes = 1
        clock["now"] = 1500  # within interval: stale answer
        assert monitor.check()
        clock["now"] = 2100
        assert not monitor.check()


class TestManagementServer:
    @pytest.fixture(scope="class")
    def broker_stack(self, tmp_path_factory):
        from zeebe_tpu_torch.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.broker.management import ManagementServer
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.testing import ControlledClock

        clock = ControlledClock()
        net = LoopbackNetwork()
        cfg = BrokerCfg(node_id="b0", partition_count=1, replication_factor=1,
                        cluster_members=["b0"], device="cpu")
        broker = Broker(cfg, net.join("b0"),
                        directory=tmp_path_factory.mktemp("mgmt"),
                        clock_millis=clock,
                        backup_store_directory=tmp_path_factory.mktemp("bk"))
        for _ in range(300):
            clock.advance(50)
            broker.pump()
            net.deliver_all()
        server = ManagementServer(broker)
        server.start()
        yield broker, server, clock, net
        server.stop()
        broker.close()

    def test_profile_endpoint_samples_threads(self, broker_stack):
        """/profile: the sampling profiler aggregates thread stacks (the
        management-surface profiling story; reference: actuator + JFR)."""
        _broker, server, _clock, _net = broker_stack
        status, body = self._get(server, "/profile?seconds=0.3")
        assert status == 200
        prof = json.loads(body)
        assert prof["samples"] > 0
        assert prof["threads"], prof
        assert all(f["pct"] <= 100.0 for f in prof["hot_frames"])

    def _get(self, server, path):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}"
        ) as resp:
            return resp.status, resp.read().decode()

    def test_health_ready_partitions(self, broker_stack):
        broker, server, clock, net = broker_stack
        status, body = self._get(server, "/health")
        assert status == 200
        assert json.loads(body)["status"] == "HEALTHY"
        status, body = self._get(server, "/ready")
        assert status == 200 and json.loads(body)["ready"]
        status, body = self._get(server, "/partitions")
        assert json.loads(body)[0]["partitionId"] == 1

    def test_metrics_exposition(self, broker_stack):
        broker, server, clock, net = broker_stack
        status, body = self._get(server, "/metrics")
        assert status == 200
        assert "zeebe_raft_role" in body

    def test_backup_trigger_endpoint(self, broker_stack):
        broker, server, clock, net = broker_stack
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/backups/3", method="POST"
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 202
            assert json.loads(resp.read())["partitions"] == 1
        for _ in range(20):
            clock.advance(50)
            broker.pump()
            net.deliver_all()
        status, body = self._get(server, "/backups")
        entries = json.loads(body)
        assert any(e["checkpointId"] == 3 and e["status"] == "COMPLETED"
                   for e in entries)

    def test_rebalance_endpoint(self, broker_stack):
        """POST /rebalance (reference: RebalancingEndpoint.java). Single
        broker: it already leads its only partition AND is the preferred
        replica, so the endpoint reports no transfers."""
        broker, server, clock, net = broker_stack
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/rebalance", method="POST")
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 202
            assert json.loads(resp.read())["transferred"] == {}
        assert broker.preferred_leader(1) == "b0"

    def test_pause_resume(self, broker_stack):
        broker, server, clock, net = broker_stack
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/pause", method="POST")
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
        assert all(p.paused for p in broker.partitions.values())
        assert broker.write_command(1, _cmd()) is None  # ingress rejected
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/resume", method="POST")
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
        assert not any(p.paused for p in broker.partitions.values())


class TestBackpressureGateRejection:
    def test_gate_rejection_does_not_collapse_limit(self):
        """Regression: a burst of gated rejections must not multiplicatively
        shrink the limit (death spiral); only timed-out in-flight samples do."""
        from zeebe_tpu_torch.broker.backpressure import CommandRateLimiter

        now = [0]
        lim = CommandRateLimiter(algorithm="aimd", clock_millis=lambda: now[0],
                                 timeout_ms=1000, initial=10)
        rec = _cmd()
        before = lim.limit
        for pos in range(before):
            assert lim.try_acquire(rec)
            lim.on_appended(pos)
        for _ in range(100):  # burst of rejections at the gate
            assert not lim.try_acquire(rec)
        assert lim.limit == before
        assert lim.dropped_total == 100
        # fast completions keep/raise the limit
        for pos in range(before):
            now[0] += 1
            lim.on_processed(pos)
        assert lim.limit >= before

    def test_timed_out_inflight_shrinks_limit(self):
        from zeebe_tpu_torch.broker.backpressure import CommandRateLimiter

        now = [0]
        lim = CommandRateLimiter(algorithm="aimd", clock_millis=lambda: now[0],
                                 timeout_ms=10, initial=10)
        rec = _cmd()
        assert lim.try_acquire(rec)
        lim.on_appended(1)
        now[0] += 50  # exceed timeout
        lim.on_processed(1)
        assert lim.limit < 10


class TestObservabilityBreadth:
    """New metric families land in the Prometheus exposition (reference:
    SURVEY §5.5 — stream_processor_*, journal_*, raft_*, exporter_*,
    gateway_*, engine metrics)."""

    def test_processing_metrics_populated(self):
        from zeebe_tpu_torch.testing import EngineHarness
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        h = EngineHarness(device="cpu")
        try:
            h.deploy(to_bpmn_xml(
                Bpmn.create_executable_process("obs").start_event("s")
                .service_task("t", job_type="ow").end_event("e").done()))
            h.create_instance("obs")
            jobs = h.activate_jobs("ow")
            h.complete_job(jobs[0]["key"])
        finally:
            h.close()
        text = REGISTRY.expose()
        for family in (
            "zeebe_stream_processor_records_total",
            "zeebe_stream_processor_latency_bucket",
            "zeebe_executed_instances_total",
            "zeebe_job_events_total",
            "zeebe_journal_append_total",
            "zeebe_journal_flush_duration_seconds_bucket",
            "zeebe_element_instance_events_total",
        ):
            assert family in text, f"missing metric family {family}"
        # engine counters moved: one instance activated+completed, one job
        # created+completed on partition 1
        assert 'zeebe_job_events_total{partition="1",action="created"}' in text
        # element transitions labelled by BPMN element type (reference:
        # ProcessEngineMetrics element_instance_events_total)
        assert ('zeebe_element_instance_events_total{partition="1",'
                'action="completed",type="SERVICE_TASK"}') in text

    def test_replay_does_not_count_engine_events(self):
        # follower/restart replay must not inflate processing-side counters
        # (they are observed from follow-up events at processing time only)
        from zeebe_tpu_torch.engine.engine import Engine
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.state import ZbDb
        from zeebe_tpu_torch.stream import StreamProcessor, StreamProcessorMode
        from zeebe_tpu_torch.testing import EngineHarness
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        created = REGISTRY.counter(
            "job_events_total", "", ("partition", "action")).labels("1", "created")
        h = EngineHarness(device="cpu")
        try:
            h.deploy(to_bpmn_xml(
                Bpmn.create_executable_process("rp").start_event("s")
                .service_task("t", job_type="rw").end_event("e").done()))
            h.create_instance("rp")
            after_processing = created.value
            # replay the same log into a fresh follower-mode processor
            db2 = ZbDb()
            engine2 = Engine(db2, 1, clock_millis=h.clock)
            follower = StreamProcessor(h.stream, db2, engine2,
                                       mode=StreamProcessorMode.REPLAY)
            follower.start()
            follower.replay_available()
            assert created.value == after_processing
        finally:
            h.close()

    def test_query_service_concurrent_with_open_transaction(self):
        # gateway-thread lookups must not collide with the processing
        # transaction slot (committed-store reads)
        from zeebe_tpu_torch.engine.query import QueryService
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.testing import EngineHarness

        h = EngineHarness(device="cpu")
        try:
            h.deploy(to_bpmn_xml(
                Bpmn.create_executable_process("qc").start_event("s")
                .service_task("t", job_type="qcw").end_event("e").done()))
            h.create_instance("qc")
            with h.db.transaction():
                meta = h.engine.state.processes.get_latest_by_id("qc")
            query = QueryService(h.db)
            with h.db.transaction():  # processing txn is OPEN on this slot
                assert query.get_bpmn_process_id_for_process(
                    meta["processDefinitionKey"]) == "qc"
        finally:
            h.close()
