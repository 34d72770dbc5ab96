# tests/test_profiler.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Continuous profiling plane: always-on folded-stack profiler,
XLA compile telemetry, device captures, and alert-triggered capture.

Covers: continuous-profiler window retention/eviction, folded-stack format
round-trips through a speedscope-style collapsed-stack parser, compile-seam
counters firing on a forced recompile, the device-capture endpoint's
single-flight guard (second POST → 409), and the alert-triggered profile
landing in the flight dump.
"""

from __future__ import annotations

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from zeebe_tpu_torch.observability.profiler import (
    AlertProfileCapture,
    CaptureInFlight,
    ContinuousProfiler,
    DeviceTraceCapture,
    fold_stacks,
    folded_text,
    observe_compile,
    sample_device_memory,
    sample_threads,
)


class FakeClock:
    def __init__(self, start: int = 1_000_000) -> None:
        self.now = start

    def __call__(self) -> int:
        return self.now

    def advance(self, ms: int) -> None:
        self.now += ms


def parse_folded(text: str) -> dict[tuple[str, ...], int]:
    """A speedscope-style collapsed-stack parser: each line is
    ``frame;frame;...;frame <count>`` — the round-trip oracle for the folded
    output format."""
    out: dict[tuple[str, ...], int] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        stack, _, weight = line.rpartition(" ")
        assert stack, f"no stack part in {line!r}"
        frames = tuple(stack.split(";"))
        assert all(frames), f"empty frame in {line!r}"
        out[frames] = out.get(frames, 0) + int(weight)
    return out


# ---------------------------------------------------------------------------
# stack sampling & folding


class TestStackSampling:
    def test_sample_threads_sees_current_thread_frames(self):
        [(name, frames)] = [
            (n, f) for n, f in sample_threads()
            if n == threading.current_thread().name
        ]
        assert any("test_torch_ref_profiler.py:" in frame for frame in frames)
        # root-first: this function sits nearer the leaf end than the root,
        # and the true leaf is the sampler itself
        assert frames[-1] == "profiler.py:sample_threads"
        assert any("test_sample_threads_sees_current_thread_frames" in f
                   for f in frames[-3:])

    def test_exclude_idents(self):
        own = threading.get_ident()
        names = [n for n, _ in sample_threads(exclude_idents=(own,))]
        assert threading.current_thread().name not in names

    def test_fold_and_round_trip_through_parser(self):
        stacks = [("worker", ["a.py:f", "b.py:g"]),
                  ("worker", ["a.py:f", "b.py:g"]),
                  ("pump", ["c.py:h"]),
                  ("idle", [])]
        folded = fold_stacks(stacks)
        assert folded == {"worker;a.py:f;b.py:g": 2, "pump;c.py:h": 1,
                          "idle": 1}
        parsed = parse_folded(folded_text(folded))
        assert parsed == {("worker", "a.py:f", "b.py:g"): 2,
                          ("pump", "c.py:h"): 1, ("idle",): 1}
        assert sum(parsed.values()) == len(stacks)

    def test_folded_text_orders_heaviest_first(self):
        text = folded_text({"a;b": 1, "c;d": 9, "e": 3})
        assert [line.rsplit(" ", 1)[0] for line in text.splitlines()] == \
            ["c;d", "e", "a;b"]


# ---------------------------------------------------------------------------
# continuous profiler


class TestContinuousProfiler:
    def make(self, clock: FakeClock, **kw) -> ContinuousProfiler:
        kw.setdefault("window_ms", 1000)
        kw.setdefault("max_windows", 3)
        return ContinuousProfiler(clock_millis=clock, **kw)

    def test_windows_bucket_by_clock(self):
        clock = FakeClock(10_000)
        prof = self.make(clock)
        prof.sample_now()
        clock.advance(100)
        prof.sample_now()
        clock.advance(1000)  # next bucket
        prof.sample_now()
        windows = prof.windows()
        assert [w["startMs"] for w in windows] == [10_000, 11_000]
        assert windows[0]["samples"] == 2 and windows[1]["samples"] == 1
        assert prof.samples_taken == 3
        # every window holds non-empty folded stacks of live threads
        assert all(w["stacks"] for w in windows)

    def test_whole_window_eviction_beyond_max_windows(self):
        clock = FakeClock(0)
        prof = self.make(clock, max_windows=3)
        for _ in range(5):
            prof.sample_now()
            clock.advance(1000)
        windows = prof.windows()
        assert len(windows) == 3
        # the OLDEST windows fell off whole; the newest survive
        assert [w["startMs"] for w in windows] == [2000, 3000, 4000]

    def test_since_filter_and_aggregate(self):
        clock = FakeClock(0)
        prof = self.make(clock)
        prof.sample_now()
        clock.advance(1000)
        prof.sample_now()
        assert len(prof.windows(since_ms=1000)) == 1
        total = sum(prof.aggregate().values())
        late = sum(prof.aggregate(since_ms=1000).values())
        assert 0 < late < total

    def test_folded_output_parses(self):
        clock = FakeClock(0)
        prof = self.make(clock)
        for _ in range(3):
            prof.sample_now()
        parsed = parse_folded(prof.folded())
        assert parsed
        # this test function is on the sampled main thread's stack
        assert any(
            any("test_torch_ref_profiler.py:" in frame for frame in frames)
            for frames in parsed
        )

    def test_hot_frames_and_top_stacks(self):
        clock = FakeClock(0)
        prof = self.make(clock)
        for _ in range(4):
            prof.sample_now()
        hot = prof.hot_frames(top=5)
        assert hot and hot[0]["samples"] >= 1
        assert all(set(h) == {"frame", "samples", "pct"} for h in hot)
        top = prof.top_stacks(top=2)
        assert len(top) <= 2 and top[0]["samples"] >= top[-1]["samples"]

    def test_thread_loop_samples_and_reports_achieved_rate(self):
        prof = ContinuousProfiler(hz=100.0, window_ms=60_000)
        prof.start()
        try:
            deadline = time.monotonic() + 3.0
            while prof.samples_taken < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            prof.stop()
        assert prof.samples_taken >= 5
        assert prof.achieved_hz > 0
        assert prof.folded()  # non-empty folded stacks from a live run

    def test_snapshot_summary_is_bounded(self):
        clock = FakeClock(0)
        prof = self.make(clock)
        prof.sample_now()
        summary = prof.snapshot_summary(top=2)
        assert summary["samples"] == 1 and summary["windows"] == 1
        assert len(summary["topStacks"]) <= 2

    def test_hz_zero_never_starts_a_thread(self):
        prof = ContinuousProfiler(hz=0)
        prof.start()
        assert prof._thread is None
        prof.stop()


# ---------------------------------------------------------------------------
# XLA compile telemetry


def _compile_counts() -> dict[str, int]:
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    out = {"hit": 0, "miss": 0}
    metric = REGISTRY._metrics.get("zeebe_xla_compiles_total")
    if metric is not None:
        for child in metric._children_snapshot():
            out[child.label_values[0]] = int(child.value)
    return out


class TestCompileTelemetry:
    def test_observe_compile_classifies_hit_and_miss(self):
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        before = _compile_counts()
        assert observe_compile("I8xT32", 0.02) == "hit"
        assert observe_compile("I8xT32", 5.0) == "miss"
        after = _compile_counts()
        assert after["hit"] == before["hit"] + 1
        assert after["miss"] == before["miss"] + 1
        hist = REGISTRY._metrics.get("zeebe_xla_compile_seconds")
        buckets = {c.label_values[0] for c in hist._children_snapshot()}
        assert "I8xT32" in buckets

    def test_compile_seam_fires_on_first_dispatch_and_forced_recompile(self):
        """The kernel backend's first dispatch per geometry is timed into
        the telemetry; deploying a second definition recompiles the shared
        table set (new content fingerprint → new compile key), so the next
        group dispatch counts again — the forced-recompile scenario."""
        from zeebe_tpu_torch.models.bpmn import Bpmn
        from zeebe_tpu_torch.testing import EngineHarness

        def model(pid, task):
            return (Bpmn.create_executable_process(pid)
                    .start_event("s").service_task(task, job_type=f"w_{pid}")
                    .end_event("e").done())

        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            before = _compile_counts()
            h.deploy(model("prof_a", "t1"))
            h.create_instance("prof_a")
            mid = _compile_counts()
            assert sum(mid.values()) == sum(before.values()) + 1, \
                "first group dispatch must be timed exactly once"
            # same geometry again: tracing-cache hit, no new observation
            h.create_instance("prof_a")
            assert _compile_counts() == mid
            seen_before = set(h.kernel_backend._compiles_seen)
            # forced recompile: a second deployment changes the shared table
            # set, so the same shape bucket is a NEW program
            h.deploy(model("prof_b", "t2"))
            h.create_instance("prof_b")
            after = _compile_counts()
            assert sum(after.values()) == sum(mid.values()) + 1
            assert set(h.kernel_backend._compiles_seen) != seen_before
        finally:
            h.close()


# ---------------------------------------------------------------------------
# device memory telemetry


# ---------------------------------------------------------------------------
# alert-triggered capture


class RecorderStub:
    def __init__(self) -> None:
        self.events: list[tuple[int, str, dict]] = []

    def record(self, partition_id, kind, **detail):
        self.events.append((partition_id, kind, detail))


class TestAlertProfileCapture:
    def test_capture_records_profile_event_throttled_per_rule(self):
        clock = FakeClock(0)
        recorder = RecorderStub()
        capture = AlertProfileCapture(recorder, profiler=None,
                                      min_interval_ms=30_000,
                                      clock_millis=clock)
        assert capture.on_firing("exporter_lag", '{node="b0"}')
        assert not capture.on_firing("exporter_lag")  # throttled
        assert capture.on_firing("journal_flush_slow")  # other rule passes
        clock.advance(31_000)
        assert capture.on_firing("exporter_lag")  # throttle window elapsed
        kinds = [(k, d["rule"]) for _, k, d in recorder.events]
        assert kinds == [("profile", "exporter_lag"),
                         ("profile", "journal_flush_slow"),
                         ("profile", "exporter_lag")]
        # without a continuous profiler the capture is one instant snapshot
        _, _, detail = recorder.events[0]
        assert detail["source"] == "instant" and detail["stacks"]

    def test_capture_prefers_continuous_profiler_aggregate(self):
        clock = FakeClock(50_000)
        prof = ContinuousProfiler(window_ms=10_000, clock_millis=clock)
        prof.sample_now()
        recorder = RecorderStub()
        capture = AlertProfileCapture(recorder, profiler=prof,
                                      clock_millis=clock)
        assert capture.on_firing("xla_recompile_storm")
        _, _, detail = recorder.events[0]
        assert detail["source"] == "continuous" and detail["stacks"]


# ---------------------------------------------------------------------------
# device trace capture (single-flight)


class TestDeviceTraceCapture:
    def test_single_flight_then_reusable(self, tmp_path):
        started: list[str] = []
        stopped: list[bool] = []
        capture = DeviceTraceCapture(
            tmp_path, start_fn=started.append,
            stop_fn=lambda: stopped.append(True))
        trace_dir = capture.start(seconds=30.0)
        assert trace_dir.exists() and started == [str(trace_dir)]
        with pytest.raises(CaptureInFlight):
            capture.start(seconds=1.0)
        capture.cancel()  # end early; the slot frees
        assert stopped == [True] and capture.active_dir is None
        second = capture.start(seconds=0.01)
        capture.wait()
        assert second != trace_dir and capture.captures_taken == 2

    def test_failing_stop_still_releases_slot(self, tmp_path):
        def bad_stop():
            raise RuntimeError("no trace in progress")

        capture = DeviceTraceCapture(tmp_path, start_fn=lambda d: None,
                                     stop_fn=bad_stop)
        capture.start(seconds=0.01)
        capture.wait()
        assert capture.active_dir is None
        capture.start(seconds=0.01)
        capture.wait()


# ---------------------------------------------------------------------------
# management endpoints


def _http_get(port: int, path: str):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.read().decode()


def _http_post(port: int, path: str):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read().decode()


class TestManagementProfileEndpoints:
    def test_one_shot_profile_folded_format(self):
        from zeebe_tpu_torch.broker.management import ManagementServer

        server = ManagementServer(broker=None)
        server.start()
        try:
            status, body = _http_get(
                server.port, "/profile?seconds=0.2&format=folded")
            assert status == 200
            parsed = parse_folded(body)
            assert parsed and sum(parsed.values()) >= 1
        finally:
            server.stop()

    def test_one_shot_profile_reports_achieved_rate(self):
        from zeebe_tpu_torch.broker.management import sample_profile

        result = sample_profile(0.2, hz=50.0)
        assert result["achievedHz"] > 0
        # deadline pacing: the achieved rate lands near the request instead
        # of undershooting by the per-tick work (generous floor for slow CI)
        assert result["achievedHz"] >= 20.0

    def test_one_shot_profile_names_threads_spawned_mid_window(self):
        from zeebe_tpu_torch.broker.management import sample_profile

        release = threading.Event()

        def late_work():
            release.wait(5)

        late = threading.Thread(target=late_work, name="late-spawned-thread")
        spawner = threading.Timer(0.1, late.start)
        spawner.start()
        try:
            result = sample_profile(0.5, hz=100.0)
        finally:
            release.set()
            spawner.join()
            late.join()
        assert "late-spawned-thread" in result["threads"]

    def test_continuous_endpoint_serves_windows_and_folded(self):
        from zeebe_tpu_torch.broker.management import ManagementServer

        clock = FakeClock(0)
        prof = ContinuousProfiler(window_ms=1000, clock_millis=clock)
        prof.sample_now()
        clock.advance(1000)
        prof.sample_now()
        broker = types.SimpleNamespace(profiler=prof)
        server = ManagementServer(broker=broker)
        server.start()
        try:
            status, body = _http_get(server.port, "/profile/continuous")
            assert status == 200
            payload = json.loads(body)
            assert payload["samples"] == 2 and len(payload["windows"]) == 2
            status, body = _http_get(
                server.port, "/profile/continuous?format=folded&since=1000")
            assert status == 200 and parse_folded(body)
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_get(server.port, "/profile/continuous?since=abc")
            assert err.value.code == 400
        finally:
            server.stop()

    def test_continuous_endpoint_404_when_disabled(self):
        from zeebe_tpu_torch.broker.management import ManagementServer

        server = ManagementServer(
            broker=types.SimpleNamespace(profiler=None))
        server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_get(server.port, "/profile/continuous")
            assert err.value.code == 404
        finally:
            server.stop()

    def test_device_capture_endpoint_is_single_flight(self, tmp_path):
        from zeebe_tpu_torch.broker.management import ManagementServer

        capture = DeviceTraceCapture(tmp_path, start_fn=lambda d: None,
                                     stop_fn=lambda: None)
        broker = types.SimpleNamespace(device_capture=capture)
        server = ManagementServer(broker=broker)
        server.start()
        try:
            status, body = _http_post(server.port,
                                      "/profile/device?seconds=20")
            assert status == 202
            payload = json.loads(body)
            assert "torch-trace-" in payload["traceDir"]
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_post(server.port, "/profile/device?seconds=1")
            assert err.value.code == 409  # second POST while in flight
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_post(server.port, "/profile/device?seconds=abc")
            assert err.value.code == 400
        finally:
            capture.cancel()
            server.stop()


# ---------------------------------------------------------------------------
# broker integration: profiler plane on a live broker


class StallableExporter:
    stalled = True

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


class TestBrokerProfilingPlane:
    def test_profiling_disabled_leaves_no_plane(self, tmp_path):
        from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

        net = LoopbackNetwork()
        broker = Broker(
            BrokerCfg(node_id="broker-0", profiling_hz=0, device="cpu"),
            net.join("broker-0"), directory=tmp_path / "b0")
        try:
            assert broker.profiler is None
            broker.pump()  # the disabled path is one is-None check
        finally:
            broker.close()

    def test_env_knob_binds(self):
        from zeebe_tpu_torch.broker.config import load_broker_cfg

        cfg = load_broker_cfg(env={"ZEEBE_BROKER_PROFILING_HZ": "7.5"})
        assert cfg.base.profiling_hz == 7.5
        cfg = load_broker_cfg(env={"ZEEBE_BROKER_PROFILING_HZ": "0"})
        assert cfg.base.profiling_hz == 0

    def test_alert_fire_attaches_profile_to_flight_dump(self, tmp_path):
        """Acceptance: a forced alert (stalled exporter) leaves a flight
        dump containing an attached profile snapshot — both the
        alert-triggered capture event in the rings and the continuous
        profiler's summary in the dump context."""
        from zeebe_tpu_torch.broker.broker import InProcessCluster
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.protocol import ValueType, command
        from zeebe_tpu_torch.protocol.intent import (
            DeploymentIntent,
            ProcessInstanceCreationIntent,
        )

        StallableExporter.stalled = True
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "cluster",
            exporters_factory=lambda: {"stallable": StallableExporter()}, device="cpu")
        try:
            cluster.await_leaders()
            broker = cluster.brokers["broker-0"]
            assert broker.profiler is not None  # on by default (~19 Hz)
            model = (Bpmn.create_executable_process("prof_alert")
                     .start_event("s").end_event("e").done())
            cluster.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "p.bpmn",
                                "resource": to_bpmn_xml(model)}]}))
            create = command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "prof_alert", "version": -1,
                 "variables": {}})
            leader = cluster.leader(1)
            for _ in range(16):
                leader.write_commands([create] * 10)
                cluster.run(100)
            cluster.run(6000)  # controlled time ≫ the 5s for-duration
            assert any(a["rule"] == "exporter_lag"
                       for a in broker.alerts.firing())
            ring = broker.flight_recorder.snapshot()["partitions"]["0"]
            profiles = [e for e in ring if e["kind"] == "profile"]
            assert profiles, "firing alert did not capture a profile"
            assert profiles[0]["rule"] == "exporter_lag"
            assert profiles[0]["stacks"]
            # the dump itself carries the continuous profiler's summary
            path = broker.flight_recorder.dump("test-profile", force=True)
            payload = json.loads(path.read_text())
            assert "profile" in payload
            assert any(e["kind"] == "profile"
                       for e in payload["partitions"]["0"])
        finally:
            StallableExporter.stalled = False
            cluster.close()

    def test_continuous_endpoint_on_live_broker_is_attributable(self,
                                                                tmp_path):
        """Acceptance: GET /profile/continuous?format=folded on a live
        broker returns non-empty folded stacks whose frames point into the
        codebase (thread name root + file:function frames)."""
        from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.broker.management import ManagementServer
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

        net = LoopbackNetwork()
        broker = Broker(BrokerCfg(node_id="broker-0", profiling_hz=50, device="cpu"),
                        net.join("broker-0"), directory=tmp_path / "b0")
        server = ManagementServer(broker)
        server.start()
        try:
            deadline = time.monotonic() + 5
            while broker.profiler.samples_taken < 3 \
                    and time.monotonic() < deadline:
                broker.pump()
                time.sleep(0.02)
            status, body = _http_get(
                server.port, "/profile/continuous?format=folded")
            assert status == 200
            parsed = parse_folded(body)
            assert parsed
            frames = {f for stack in parsed for f in stack}
            assert any(".py:" in f for f in frames)
        finally:
            server.stop()
            broker.close()


# ---------------------------------------------------------------------------
# default alert rule


def test_xla_recompile_storm_is_a_default_rule():
    from zeebe_tpu_torch.observability.alerts import default_rules

    [rule] = [r for r in default_rules() if r.name == "xla_recompile_storm"]
    assert rule.series == "zeebe_xla_compiles_total"
    assert rule.kind == "changes"
    assert 'cache="miss"' in rule.labels_contains
