# tests/test_timeseries.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Cluster metrics plane: time-series store, sampler, alerts, flight
recorder, management endpoints, `top` view, metrics-doc generator, and the
utils/metrics satellites (scrape race, process self-metrics, /profile)."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest

from zeebe_tpu_torch.observability.alerts import (
    AlertEvaluator,
    AlertRule,
    default_rules,
)
from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder
from zeebe_tpu_torch.observability.timeseries import (
    MetricsSampler,
    TimeSeriesStore,
)
from zeebe_tpu_torch.utils.metrics import (
    MetricsRegistry,
    estimate_quantile,
    install_process_metrics,
)


class FakeClock:
    def __init__(self, start: int = 1_000_000) -> None:
        self.ms = start

    def __call__(self) -> int:
        return self.ms

    def advance(self, ms: int) -> None:
        self.ms += ms


# ---------------------------------------------------------------------------
# TimeSeriesStore


class TestTimeSeriesStore:
    def test_append_query_roundtrip(self):
        store = TimeSeriesStore()
        for i in range(10):
            store.append("s", "", "gauge", 1000 + i * 250, float(i))
        [series] = store.query("s")
        assert series["samples"] == [[1000 + i * 250, float(i)]
                                     for i in range(10)]

    def test_delta_encoding_spans_blocks(self):
        store = TimeSeriesStore(block_samples=4)
        times = [1000, 1250, 1700, 1701, 5000, 5250, 9000, 9001, 9002]
        for i, t in enumerate(times):
            store.append("s", "", "gauge", t, float(i))
        [series] = store.query("s")
        assert [t for t, _ in series["samples"]] == times
        # 9 samples at block_samples=4 must have sealed at least 2 blocks
        with store._lock:
            assert len(store._series[("s", "")].blocks) >= 3

    def test_since_and_step_downsampling(self):
        store = TimeSeriesStore()
        for i in range(40):
            store.append("s", "", "gauge", i * 100, float(i))
        [series] = store.query("s", since_ms=2000)
        assert series["samples"][0][0] == 2000
        [series] = store.query("s", step_ms=1000)
        # last sample of each 1s bucket
        assert all(t % 1000 == 900 for t, _ in series["samples"][:-1])

    def test_retention_evicts_old_blocks(self):
        store = TimeSeriesStore(retention_ms=1000, block_samples=4)
        for i in range(40):
            store.append("s", "", "gauge", i * 100, float(i))
        store.evict(4000)
        [series] = store.query("s")
        # everything older than 3000 lives only in sealed blocks → evicted
        # (to block granularity: one partially-stale block may survive)
        assert series["samples"][0][0] >= 2400
        assert series["samples"][-1][0] == 3900

    def test_histogram_children_match_base_name(self):
        store = TimeSeriesStore()
        store.append("h", "", "rate", 1000, 5.0)
        store.append("h:p50", "", "quantile", 1000, 0.1)
        store.append("h:p99", "", "quantile", 1000, 0.4)
        assert {s["name"] for s in store.query("h")} == {"h", "h:p50", "h:p99"}
        assert {s["name"] for s in store.query("h:p99")} == {"h:p99"}

    def test_max_series_bound(self):
        store = TimeSeriesStore(max_series=3)
        for i in range(10):
            store.append(f"s{i}", "", "gauge", 1000, 1.0)
        assert len(store.series_names()) == 3
        assert store.stats()["droppedSeries"] == 7

    def test_rate_over_monotonic_gauge(self):
        store = TimeSeriesStore()
        for i in range(11):
            store.append("pos", '{node="n0"}', "gauge", i * 1000, i * 50.0)
        assert store.rate("pos", 10_000, 10_000) == pytest.approx(50.0)
        assert store.rate("pos", 10_000, 10_000,
                          labels_contains='node="n1"') == 0.0


# ---------------------------------------------------------------------------
# MetricsSampler


class TestMetricsSampler:
    def _sampler(self):
        clock = FakeClock()
        registry = MetricsRegistry(namespace="t")
        store = TimeSeriesStore()
        sampler = MetricsSampler(registry, store, interval_ms=250,
                                 clock_millis=clock)
        return clock, registry, store, sampler

    def test_counter_sampled_as_rate(self):
        clock, registry, store, sampler = self._sampler()
        counter = registry.counter("ops_total")
        sampler.sample_once()
        counter.inc(100)
        clock.advance(1000)
        sampler.sample_once()
        [series] = store.query("t_ops_total")
        assert series["kind"] == "rate"
        assert series["samples"][-1][1] == pytest.approx(100.0)

    def test_counter_reset_does_not_emit_negative_rate(self):
        clock, registry, store, sampler = self._sampler()
        counter = registry.counter("ops_total")
        counter.inc(100)
        sampler.sample_once()
        counter._default().value = 0.0  # restart/reset
        clock.advance(1000)
        sampler.sample_once()
        series = store.query("t_ops_total")
        samples = series[0]["samples"] if series else []
        assert all(v >= 0 for _, v in samples)

    def test_gauge_sampled_raw(self):
        clock, registry, store, sampler = self._sampler()
        gauge = registry.gauge("depth")
        gauge.set(42.0)
        sampler.sample_once()
        [series] = store.query("t_depth")
        assert series["samples"] == [[clock.ms, 42.0]]

    def test_histogram_sampled_as_quantiles_and_rate(self):
        clock, registry, store, sampler = self._sampler()
        hist = registry.histogram("lat", buckets=(0.1, 1.0, 10.0))
        sampler.sample_once()
        for _ in range(90):
            hist.observe(0.05)
        for _ in range(10):
            hist.observe(5.0)
        clock.advance(1000)
        sampler.sample_once()
        by_name = {s["name"]: s for s in store.query("t_lat")}
        assert by_name["t_lat"]["samples"][-1][1] == pytest.approx(100.0)
        p50 = by_name["t_lat:p50"]["samples"][-1][1]
        p99 = by_name["t_lat:p99"]["samples"][-1][1]
        assert 0.0 < p50 <= 0.1
        assert 1.0 < p99 <= 10.0
        # quantiles describe the observations SINCE the last sample: a quiet
        # interval adds no quantile points
        clock.advance(1000)
        sampler.sample_once()
        assert len(by_name["t_lat:p50"]["samples"]) == \
            len(store.query("t_lat:p50")[0]["samples"])

    def test_maybe_sample_honors_interval(self):
        clock, registry, store, sampler = self._sampler()
        registry.gauge("g").set(1.0)
        assert sampler.maybe_sample()
        assert not sampler.maybe_sample()
        clock.advance(249)
        assert not sampler.maybe_sample()
        clock.advance(1)
        assert sampler.maybe_sample()


def test_estimate_quantile_interpolates():
    buckets = (1.0, 2.0, 4.0)
    # 10 obs ≤1, 10 in (1,2], 0 in (2,4], 0 above
    counts = [10, 10, 0, 0]
    assert estimate_quantile(buckets, counts, 0.5) == pytest.approx(1.0)
    assert estimate_quantile(buckets, counts, 0.75) == pytest.approx(1.5)
    assert estimate_quantile(buckets, counts, 0.0) == pytest.approx(0.0)
    # everything in +Inf clamps to the top finite bound
    assert estimate_quantile(buckets, [0, 0, 0, 5], 0.5) == 4.0
    assert estimate_quantile(buckets, [0, 0, 0, 0], 0.5) == 0.0


# ---------------------------------------------------------------------------
# Alerts


class TestAlerts:
    def test_threshold_rule_fires_after_for_duration_and_clears(self):
        store = TimeSeriesStore()
        rule = AlertRule(name="lag", series="lag_records", threshold=100.0,
                         for_ms=5000)
        ev = AlertEvaluator(store, [rule], node_id="n0")
        store.append("lag_records", "", "gauge", 1000, 500.0)
        ev.evaluate(1000)
        assert ev.snapshot()[0]["state"] == "pending"
        assert not ev.firing()
        store.append("lag_records", "", "gauge", 6500, 800.0)
        ev.evaluate(6500)
        [alert] = ev.firing()
        assert alert["rule"] == "lag" and alert["value"] == 800.0
        # recovery clears
        store.append("lag_records", "", "gauge", 7000, 10.0)
        ev.evaluate(7000)
        assert not ev.firing()
        assert ev.snapshot() == []

    def test_blip_below_for_duration_never_fires(self):
        store = TimeSeriesStore()
        rule = AlertRule(name="lag", series="lag_records", threshold=100.0,
                         for_ms=5000)
        ev = AlertEvaluator(store, [rule], node_id="n0")
        store.append("lag_records", "", "gauge", 1000, 500.0)
        ev.evaluate(1000)
        store.append("lag_records", "", "gauge", 3000, 50.0)  # recovered
        ev.evaluate(3000)
        store.append("lag_records", "", "gauge", 4000, 500.0)  # breach again
        ev.evaluate(4000)
        ev.evaluate(8000)  # 4s after re-breach: for-duration not met
        assert not ev.firing()

    def test_changes_rule_detects_role_flapping(self):
        store = TimeSeriesStore()
        [rule] = [r for r in default_rules() if r.name == "raft_role_flapping"]
        ev = AlertEvaluator(store, [rule], node_id="n0")
        for i in range(8):  # 0,1,0,1,… = 7 changes inside the window
            store.append("zeebe_raft_role", '{node="n0",partition="1"}',
                         "gauge", 1000 + i * 1000, float(i % 2))
        ev.evaluate(8000)
        [alert] = ev.firing()
        assert alert["rule"] == "raft_role_flapping"
        # stable role for a full window clears it
        for i in range(12):
            store.append("zeebe_raft_role", '{node="n0",partition="1"}',
                         "gauge", 9000 + i * 1000, 1.0)
        ev.evaluate(21000)
        assert not ev.firing()

    def test_firing_gauge_reflects_state(self):
        from zeebe_tpu_torch.observability.alerts import _M_FIRING

        store = TimeSeriesStore()
        rule = AlertRule(name="g_lag", series="x", threshold=1.0, for_ms=1000)
        ev = AlertEvaluator(store, [rule], node_id="gauge-node")
        store.append("x", "", "gauge", 1000, 5.0)
        ev.evaluate(1000)
        ev.evaluate(2500)
        assert _M_FIRING.labels("gauge-node", "g_lag").value == 1.0
        store.append("x", "", "gauge", 3000, 0.0)
        ev.evaluate(3000)
        assert _M_FIRING.labels("gauge-node", "g_lag").value == 0.0

    def test_stale_series_clears_instead_of_firing_forever(self):
        """An idle broker stops appending :p99 points; the last high value
        must not keep a flush-latency alert firing forever."""
        from zeebe_tpu_torch.observability.alerts import STALE_AFTER_MS

        store = TimeSeriesStore(retention_ms=10 * STALE_AFTER_MS)
        rule = AlertRule(name="flush", series="f:p99", threshold=0.5,
                         for_ms=1000)
        ev = AlertEvaluator(store, [rule], node_id="n0")
        store.append("f:p99", "", "quantile", 1000, 2.0)
        ev.evaluate(1000)
        ev.evaluate(2500)
        assert ev.firing()
        # no new samples: past the staleness window the alert clears
        ev.evaluate(2500 + STALE_AFTER_MS + 1)
        assert not ev.firing()

    def test_node_labeled_series_scoped_to_own_node(self):
        """The sampler snapshots the process-global registry: an evaluator
        must ignore other brokers' node-labeled series."""
        store = TimeSeriesStore()
        rule = AlertRule(name="lag", series="x", threshold=1.0, for_ms=1000)
        ev = AlertEvaluator(store, [rule], node_id="broker-0")
        store.append("x", '{node="broker-1"}', "gauge", 1000, 5.0)
        ev.evaluate(1000)
        ev.evaluate(2500)
        assert not ev.firing() and ev.snapshot() == []
        store.append("x", '{node="broker-0"}', "gauge", 3000, 5.0)
        ev.evaluate(3000)
        ev.evaluate(4500)
        [alert] = ev.firing()
        assert 'node="broker-0"' in alert["labels"]

    def test_transition_listener_sees_lifecycle(self):
        store = TimeSeriesStore()
        seen = []
        rule = AlertRule(name="l", series="x", threshold=1.0, for_ms=1000)
        ev = AlertEvaluator(store, [rule], node_id="n",
                            on_transition=lambda r, labels, old, new:
                            seen.append((old, new)))
        store.append("x", "", "gauge", 1000, 5.0)
        ev.evaluate(1000)
        ev.evaluate(2500)
        store.append("x", "", "gauge", 3000, 0.0)
        ev.evaluate(3000)
        assert seen == [("inactive", "pending"), ("pending", "firing"),
                        ("firing", "inactive")]


# ---------------------------------------------------------------------------
# FlightRecorder


class TestFlightRecorder:
    def test_ring_is_bounded(self):
        rec = FlightRecorder("n0", None, capacity=4)
        for i in range(10):
            rec.record(1, "records", first=i)
        events = rec.snapshot()["partitions"]["1"]
        assert len(events) == 4
        assert [e["first"] for e in events] == [6, 7, 8, 9]
        assert rec.snapshot()["eventsRecorded"] == 10

    def test_dump_writes_readable_json(self, tmp_path):
        clock = FakeClock()
        rec = FlightRecorder("n0", tmp_path, clock_millis=clock)
        rec.record(1, "role_change", role="leader", term=3)
        rec.add_context_provider(lambda: {"alerts": [{"rule": "x"}]})
        path = rec.dump("test-reason")
        payload = json.loads(path.read_text())
        assert payload["reason"] == "test-reason"
        assert payload["partitions"]["1"][0]["role"] == "leader"
        assert payload["alerts"] == [{"rule": "x"}]

    def test_dump_throttled_per_reason_class_force_bypasses(self, tmp_path):
        clock = FakeClock()
        rec = FlightRecorder("n0", tmp_path, clock_millis=clock)
        assert rec.dump("unhealthy:a") is not None
        assert rec.dump("unhealthy:b") is None  # same class, inside window
        assert rec.dump("hard-crash") is not None  # different class
        assert rec.dump("unhealthy:c", force=True) is not None
        clock.advance(6000)
        assert rec.dump("unhealthy:d") is not None

    def test_no_data_dir_never_writes(self):
        rec = FlightRecorder("n0", None)
        rec.record(1, "x")
        assert rec.dump("r") is None

    def test_journal_slow_flush_listener(self, tmp_path):
        from zeebe_tpu_torch.journal import journal as journal_mod
        from zeebe_tpu_torch.observability.flight_recorder import (
            install_journal_stall_listener,
            remove_journal_stall_listener,
        )

        rec = FlightRecorder("n0", None)
        install_journal_stall_listener(rec)
        try:
            for listener in journal_mod.slow_flush_listeners:
                listener("/data/p1/stream", 0.7)
            events = rec.snapshot()["partitions"]["0"]
            assert events[-1]["kind"] == "flush_stall"
            assert events[-1]["seconds"] == 0.7
        finally:
            remove_journal_stall_listener(rec)
        assert not any(
            getattr(fn, "_flight_recorder", None) is rec
            for fn in journal_mod.slow_flush_listeners)

    def test_stall_listener_filters_foreign_directories(self, tmp_path):
        """The slow-flush seam is module-global: a recorder with a data dir
        must keep only stalls under it (multi-broker process)."""
        from zeebe_tpu_torch.journal import journal as journal_mod
        from zeebe_tpu_torch.observability.flight_recorder import (
            install_journal_stall_listener,
            remove_journal_stall_listener,
        )

        rec = FlightRecorder("n0", tmp_path / "broker-0")
        install_journal_stall_listener(rec)
        try:
            for listener in journal_mod.slow_flush_listeners:
                listener(str(tmp_path / "broker-1" / "stream"), 0.9)
                listener(str(tmp_path / "broker-0" / "stream"), 0.4)
            events = rec.snapshot()["partitions"]["0"]
            assert len(events) == 1
            assert events[0]["seconds"] == 0.4
        finally:
            remove_journal_stall_listener(rec)


# ---------------------------------------------------------------------------
# Broker integration: sampler + alerts + flight recorder + endpoints


class StallableExporter:
    """Exporter that raises until ``stalled`` is cleared (the acceptance
    scenario: a stalled exporter grows lag, the default alert fires, clears
    after recovery)."""

    stalled = True  # class-level so the factory-made instance is reachable

    def configure(self, context):
        self.context = context

    def open(self, controller):
        self.controller = controller

    def export(self, record):
        if StallableExporter.stalled:
            raise RuntimeError("sink unavailable")
        self.controller.update_last_exported_position(record.position)

    def close(self):
        pass


def _deploy_and_load(cluster, n_instances: int, pid: str = "mtp") -> None:
    from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
    from zeebe_tpu_torch.protocol import ValueType, command
    from zeebe_tpu_torch.protocol.intent import (
        DeploymentIntent,
        ProcessInstanceCreationIntent,
    )

    model = (Bpmn.create_executable_process(pid)
             .start_event("s").end_event("e").done())
    cluster.write_command(1, command(
        ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
        {"resources": [{"resourceName": f"{pid}.bpmn",
                        "resource": to_bpmn_xml(model)}]}))
    create = command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": pid, "version": -1, "variables": {}})
    leader = cluster.leader(1)
    for _ in range(n_instances // 10):
        # internal write path (no backpressure): the load is the point here
        leader.write_commands([create] * 10)
        cluster.run(100)


@pytest.fixture
def metrics_cluster(tmp_path):
    from zeebe_tpu_torch.broker.broker import InProcessCluster

    StallableExporter.stalled = True
    cluster = InProcessCluster(
        broker_count=1, partition_count=1, replication_factor=1,
        directory=tmp_path / "cluster",
        exporters_factory=lambda: {"stallable": StallableExporter()}, device="cpu")
    cluster.await_leaders()
    yield cluster
    cluster.close()


class TestBrokerMetricsPlane:
    def test_timeseries_retains_core_series_after_run(self, metrics_cluster):
        """Acceptance: after a (bench-like) run, /timeseries holds history
        for journal, stream-processor, exporter, and backpressure series."""
        StallableExporter.stalled = False
        _deploy_and_load(metrics_cluster, 30)
        metrics_cluster.run(2000)
        broker = metrics_cluster.brokers["broker-0"]
        assert broker.sampler.samples_taken > 4
        names = broker.timeseries.series_names()
        for required in ("zeebe_journal_append_rate",
                         "zeebe_stream_processor_records_total",
                         "zeebe_exporter_container_lag_records",
                         "zeebe_backpressure_inflight_requests_count"):
            assert required in names, f"missing {required} in store"
            [series] = [s for s in broker.timeseries.query(required)
                        if s["name"] == required][:1]
            assert len(series["samples"]) >= 2, f"{required} has no history"

    def test_default_exporter_lag_alert_fires_and_clears(self, metrics_cluster):
        """Acceptance: the DEFAULT rule set fires while an exporter is
        stalled past 1000 records of lag for >5s, and clears on recovery."""
        broker = metrics_cluster.brokers["broker-0"]
        _deploy_and_load(metrics_cluster, 160)  # ≫1000 records on the log
        metrics_cluster.run(6000)  # controlled time ≫ for_ms=5000
        firing = broker.alerts.firing()
        assert any(a["rule"] == "exporter_lag" for a in firing), firing
        # the health payload carries it (management /health serves this dict)
        assert any(e["kind"] == "alert"
                   for e in broker.flight_recorder.snapshot()
                   ["partitions"].get("0", []))
        # recovery: unstall, drain, lag collapses, alert clears
        StallableExporter.stalled = False
        metrics_cluster.run(8000)
        assert not any(a["rule"] == "exporter_lag"
                       for a in broker.alerts.firing()), \
            broker.alerts.snapshot()

    def test_hard_crash_leaves_readable_flight_dump(self, metrics_cluster,
                                                    tmp_path):
        """Acceptance: a chaos-killed broker leaves flight-*.json whose tail
        explains the crash."""
        StallableExporter.stalled = False
        _deploy_and_load(metrics_cluster, 20)
        metrics_cluster.hard_crash_broker("broker-0")
        dumps = sorted((tmp_path / "cluster" / "broker-0").glob("flight-*.json"))
        assert dumps, "hard crash left no flight dump"
        payload = json.loads(dumps[-1].read_text())
        assert payload["reason"] == "hard-crash"
        ring = payload["partitions"]["1"]
        assert ring[-1]["kind"] == "crash"
        # the tail carries the pre-crash context (committed batches, roles)
        assert any(e["kind"] in ("records", "role_change") for e in ring)

    def test_sampling_disabled_leaves_no_plane(self, tmp_path):
        from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

        net = LoopbackNetwork()
        broker = Broker(
            BrokerCfg(node_id="broker-0", metrics_sampling_ms=0, device="cpu"),
            net.join("broker-0"), directory=tmp_path / "b0")
        try:
            assert broker.sampler is None
            assert broker.timeseries is None
            assert broker.alerts is None
            broker.pump()  # the disabled path is one is-None check
        finally:
            broker.close()


def _http_get(port: int, path: str):
    req = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5)
    with req as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.fixture
def management(metrics_cluster):
    from zeebe_tpu_torch.broker.management import ManagementServer

    server = ManagementServer(metrics_cluster.brokers["broker-0"])
    server.start()
    yield server, metrics_cluster
    server.stop()


class TestManagementEndpoints:
    def test_timeseries_endpoint(self, management):
        server, cluster = management
        StallableExporter.stalled = False
        _deploy_and_load(cluster, 20)
        cluster.run(1500)
        status, listing = _http_get(server.port, "/timeseries")
        assert status == 200 and "zeebe_journal_append_rate" in listing["series"]
        status, body = _http_get(
            server.port, "/timeseries?name=zeebe_journal_append_rate&step=500")
        assert status == 200
        assert body["series"] and body["series"][0]["samples"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _http_get(server.port, "/timeseries?name=x&since=abc")
        assert err.value.code == 400

    def test_flight_endpoint(self, management):
        server, cluster = management
        StallableExporter.stalled = False
        _deploy_and_load(cluster, 10)
        status, body = _http_get(server.port, "/flight")
        assert status == 200
        assert body["nodeId"] == "broker-0"
        kinds = {e["kind"] for e in body["partitions"]["1"]}
        assert "records" in kinds and "role_change" in kinds

    def test_health_carries_alert_details(self, management):
        server, cluster = management
        status, body = _http_get(server.port, "/health")
        assert status == 200
        assert "alerts" in body and "alertsFiring" in body
        status, body = _http_get(server.port, "/alerts")
        # 9 default rules since added slo_burn_page/slo_burn_ticket
        assert status == 200 and len(body["rules"]) == 9

    def test_cluster_status_local(self, management):
        server, cluster = management
        StallableExporter.stalled = False
        _deploy_and_load(cluster, 20)
        cluster.run(1500)
        status, body = _http_get(server.port, "/cluster/status")
        assert status == 200
        assert body["clusterSize"] == 1
        assert body["topology"]["version"] >= 0  # bootstrap doc is v0
        assert "broker-0" in body["topology"]["members"]
        [row] = body["brokers"]
        assert row["partitions"]["1"]["role"] == "leader"
        assert "rates" in row and "appendPerSec" in row["rates"]

    def test_cluster_status_runtime_fanout(self):
        from zeebe_tpu_torch.gateway.broker_client import ClusterRuntime

        runtime = ClusterRuntime(broker_count=2, partition_count=2,
                                 replication_factor=2, device="cpu")
        try:
            status = runtime.cluster_status()
            assert status["clusterSize"] == 2
            assert status["partitionsCount"] == 2
            assert {r["nodeId"] for r in status["brokers"]} == \
                {"broker-0", "broker-1"}
        finally:
            # never started: close brokers directly
            for broker in runtime.brokers.values():
                broker.close()


# ---------------------------------------------------------------------------
# zbctl top


class TestTopView:
    STATUS = {
        "clusterSize": 2, "partitionsCount": 2, "health": "DEGRADED",
        "alertsFiring": 1, "appendPerSec": 120.5, "processedPerSec": 118.0,
        "topology": {"version": 7, "changeInProgress": True},
        "brokers": [
            {"nodeId": "broker-0", "health": "HEALTHY",
             "partitions": {"1": {"role": "leader"},
                            "2": {"role": "follower"}},
             "rates": {"appendPerSec": 60.5, "processedPerSec": 59.0,
                       "exportLagRecords": 12},
             "alertsFiring": 0},
            {"nodeId": "broker-1", "health": "DEGRADED",
             "partitions": {"1": {"role": "follower"},
                            "2": {"role": "leader"}},
             "rates": {"appendPerSec": 60.0, "processedPerSec": 59.0},
             "alertsFiring": 1,
             "alerts": [{"rule": "exporter_lag", "severity": "warning",
                         "labels": '{exporter="es"}', "value": 2300.0,
                         "expr": "lag > 1000 for 5000ms"}]},
        ],
    }

    def test_render_top_frame(self):
        from zeebe_tpu_torch.cli import _render_top

        frame = _render_top(self.STATUS)
        assert "2 broker(s)" in frame
        assert "health DEGRADED" in frame
        assert "1 alert(s) firing" in frame
        assert "change in progress" in frame
        assert "1:L 2:F" in frame and "1:F 2:L" in frame
        assert "exporter_lag" in frame and "2300.0" in frame

    def test_render_top_empty_status(self):
        from zeebe_tpu_torch.cli import _render_top

        frame = _render_top({})  # must not crash on a degenerate payload
        assert "0 broker(s)" in frame

    def test_render_top_admission_section(self):
        from zeebe_tpu_torch.cli import _render_top

        status = dict(self.STATUS)
        status["admission"] = {
            "enabled": True, "shedLevel": 2, "draining": True,
            "observedP99Ms": 1834.2, "shedP99TargetMs": 1000.0,
            "inflight": 37, "maxInflight": 256,
            "tenants": {
                "t-hot": {"admitted": 206, "shed": 520,
                          "shedByReason": {"tenant-quota": 520},
                          "inflight": 30, "quotaRate": 8.0, "weight": 1.0},
                "t-well": {"admitted": 400, "shed": 0, "shedByReason": {},
                           "inflight": 7, "quotaRate": None, "weight": 2.0},
            },
        }
        frame = _render_top(status)
        assert "ADMISSION" in frame and "shed level 2" in frame
        assert "DRAINING" in frame
        assert "t-hot" in frame and "520" in frame
        # unmetered tenant renders a dash, not None
        well_line = next(l for l in frame.splitlines() if "t-well" in l)
        assert " - " in well_line or well_line.rstrip().split()[-2] == "-"

    def test_top_once_against_live_server(self, management, capsys):
        from zeebe_tpu_torch.cli import main as cli_main

        server, _cluster = management
        rc = cli_main(["top", "--once",
                       "--management", f"http://127.0.0.1:{server.port}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "zeebe-tpu cluster" in out and "broker-0" in out

    def test_top_unreachable_server_exits_2(self, capsys):
        from zeebe_tpu_torch.cli import main as cli_main

        rc = cli_main(["top", "--once", "--management",
                       "http://127.0.0.1:1"])  # port 1: nothing listens
        assert rc == 2

    def test_top_non_json_response_exits_2(self, capsys):
        """A proxy error page (200 + HTML) must not become a traceback."""
        from http.server import BaseHTTPRequestHandler, HTTPServer

        from zeebe_tpu_torch.cli import main as cli_main

        class HtmlHandler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                body = b"<html>proxy error</html>"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = HTTPServer(("127.0.0.1", 0), HtmlHandler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            rc = cli_main(["top", "--once", "--management",
                           f"http://127.0.0.1:{server.server_address[1]}"])
        finally:
            server.shutdown()
        assert rc == 2
        assert "cannot reach" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# metrics-doc


class TestMetricsDoc:
    def test_renderer_covers_registered_families(self):
        from zeebe_tpu_torch.cli import _render_metrics_doc

        install_process_metrics()
        doc = _render_metrics_doc()
        assert doc.startswith("# Metrics reference")
        assert "| name | type | labels | help |" in doc
        assert "`process_cpu_seconds_total` | counter" in doc
        assert "`zeebe_alerts_firing` | gauge" in doc
        # sorted by family name (the row-string order differs where one
        # name prefixes another: '`' sorts after '_') and one row per family
        names = [line.split("`")[1] for line in doc.splitlines()
                 if line.startswith("| `")]
        assert names == sorted(names)
        assert len(names) == len(set(names))

    @pytest.mark.slow
    def test_committed_doc_matches_generator(self, tmp_path):
        """The full drift check (same command CI runs) in a fresh process —
        slow-marked: boots a broker scenario in a subprocess."""
        import os
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-m", "zeebe_tpu_torch.cli", "metrics-doc", "--check", "--device", "cpu"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# utils/metrics satellites


class TestScrapeRecordRace:
    def test_expose_while_registering(self):
        """Satellite: a scrape concurrent with labels()/register must never
        raise `dictionary changed size during iteration`."""
        registry = MetricsRegistry(namespace="race")
        errors: list[BaseException] = []
        stop = threading.Event()

        def register_loop():
            # bounded: an unbounded writer on a slow box grows the registry
            # to millions of label children, and every later expose() pass
            # over it takes minutes — the race window doesn't need volume
            for i in range(20_000):
                if stop.is_set():
                    break
                metric = registry.counter(f"m{i % 37}", "h", ("l",))
                metric.labels(str(i)).inc()
                registry.histogram(f"h{i % 23}", "h", ("l",)).labels(
                    str(i)).observe(0.01)

        def scrape_loop():
            try:
                for _ in range(300):
                    if stop.is_set():
                        break
                    registry.expose()
                    registry.snapshot()
            except BaseException as exc:  # noqa: BLE001 — the assertion
                errors.append(exc)

        writers = [threading.Thread(target=register_loop, daemon=True)
                   for _ in range(3)]
        scraper = threading.Thread(target=scrape_loop, daemon=True)
        for t in writers:
            t.start()
        scraper.start()
        scraper.join(timeout=60)
        stop.set()
        for t in writers:
            t.join(timeout=10)
        scraper.join(timeout=30)
        assert not errors, errors[0]
        # a leaked scrape thread outlives the test and stalls interpreter
        # shutdown for the whole suite — termination is part of the contract
        assert not scraper.is_alive(), "scrape loop failed to terminate"
        assert not any(t.is_alive() for t in writers)


class TestProcessSelfMetrics:
    def test_registered_and_live(self):
        registry = MetricsRegistry(namespace="psm")
        install_process_metrics(registry)
        text = registry.expose()
        assert "process_cpu_seconds_total" in text
        assert "process_resident_memory_bytes" in text
        assert "python_gc_collections_total" in text
        cpu = [line for line in text.splitlines()
               if line.startswith("process_cpu_seconds_total ")]
        assert cpu and float(cpu[0].split()[-1]) > 0
        rss = [line for line in text.splitlines()
               if line.startswith("process_resident_memory_bytes ")]
        assert rss and float(rss[0].split()[-1]) > 1024 * 1024

    def test_sampler_folds_process_metrics_into_store(self):
        clock = FakeClock()
        registry = MetricsRegistry(namespace="psm2")
        install_process_metrics(registry)
        store = TimeSeriesStore()
        sampler = MetricsSampler(registry, store, clock_millis=clock)
        sampler.sample_once()
        clock.advance(1000)
        sampler.sample_once()
        assert "process_resident_memory_bytes" in store.series_names()

    def test_install_idempotent(self):
        registry = MetricsRegistry(namespace="psm3")
        install_process_metrics(registry)
        install_process_metrics(registry)
        text = registry.expose()
        assert text.count("# TYPE process_cpu_seconds_total") == 1
        # hooks must not stack either: each call makes a fresh closure that
        # add_collect_hook's identity dedupe could never catch
        assert len(registry._collect_hooks) == 1


# ---------------------------------------------------------------------------
# /profile satellite


class TestProfileEndpoint:
    def test_parse_profile_seconds(self):
        from zeebe_tpu_torch.broker.management import parse_profile_seconds

        assert parse_profile_seconds("2") == 2.0
        assert parse_profile_seconds("0.05") == 0.05
        assert parse_profile_seconds("45") == 30.0  # clamped to the cap
        assert parse_profile_seconds("1e9") == 30.0
        assert parse_profile_seconds("abc") is None
        assert parse_profile_seconds("-1") is None
        assert parse_profile_seconds("0") is None
        assert parse_profile_seconds("nan") is None

    def test_profile_happy_path_and_bad_input(self):
        from zeebe_tpu_torch.broker.management import ManagementServer

        server = ManagementServer(broker=None)
        server.start()
        try:
            status, body = _http_get(server.port, "/profile?seconds=0.2")
            assert status == 200
            assert body["seconds"] == 0.2
            assert body["samples"] >= 1
            assert body["threads"]  # at least the HTTP serving threads
            assert isinstance(body["hot_frames"], list)
            # the profiler must not profile itself
            assert not any("sample_profile" in f["frame"]
                           for f in body["hot_frames"])
            for bad in ("abc", "-3", "0", "nan"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _http_get(server.port, f"/profile?seconds={bad}")
                assert err.value.code == 400
        finally:
            server.stop()

    def test_profile_default_window_accepted(self):
        from zeebe_tpu_torch.broker.management import parse_profile_seconds

        # the handler's default ("2.0") must parse — a regression here turns
        # every parameterless /profile call into a 400
        assert parse_profile_seconds("2.0") == 2.0
