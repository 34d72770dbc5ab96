# tests/test_observability.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Distributed tracing & record-lineage observability (zeebe_tpu/observability/).

Covers: the seeded deterministic sampler, the bounded span collector and its
Perfetto (Chrome trace event) export, trace-context propagation through the
live processing path (and its absence from replay), the lineage walker over
multi-instance fan-out and message-correlation flows, the offline CLI
``trace`` command, the exporter-lag gauge, the ``/traces`` management
endpoint, the command→ack histogram, and the Prometheus text-exposition
escaping fix in utils/metrics.py."""

from __future__ import annotations

import json

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.observability import (
    DeterministicSampler,
    Span,
    SpanCollector,
    chrome_trace,
    collect_lineage,
    configure_tracing,
    format_lineage,
    get_tracer,
)
from zeebe_tpu_torch.testing import EngineHarness


@pytest.fixture()
def tracing():
    """Enable the process-global tracer for one test, always disable+clear
    after — the singleton must never leak spans into other tests."""
    tracer = configure_tracing(enabled=True, seed=0, sample_rate=1.0,
                               capacity=1 << 15, reset=True)
    try:
        yield tracer
    finally:
        configure_tracing(enabled=False, reset=True)


def one_task(pid="p"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type="w").end_event("e").done()
    )


def fan_out(pid="fan"):
    """Parallel fan-out/fan-in: one create command fans out into two
    concurrently live service tasks."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .parallel_gateway("fork")
        .service_task("a", job_type="wa")
        .parallel_gateway("join")
        .end_event("e")
        .move_to_element("fork")
        .service_task("b", job_type="wb")
        .connect_to("join")
        .done()
    )


def msg_catch(pid="pay"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .intermediate_catch_message("wait", "paid", "=uid")
        .end_event("e")
        .done()
    )


# ---------------------------------------------------------------------------
# span model / sampler / collector


class TestSamplerAndCollector:
    def test_sampler_is_deterministic_in_seed_and_key(self):
        a = DeterministicSampler(seed=7, rate=0.5)
        b = DeterministicSampler(seed=7, rate=0.5)
        keys = [f"1:{i}" for i in range(512)]
        assert [a.sampled(k) for k in keys] == [b.sampled(k) for k in keys]
        c = DeterministicSampler(seed=8, rate=0.5)
        assert [a.sampled(k) for k in keys] != [c.sampled(k) for k in keys]

    def test_sampler_rate_bounds_and_approximation(self):
        assert all(DeterministicSampler(rate=1.0).sampled(f"k{i}")
                   for i in range(64))
        assert not any(DeterministicSampler(rate=0.0).sampled(f"k{i}")
                       for i in range(64))
        s = DeterministicSampler(seed=1, rate=0.25)
        kept = sum(s.sampled(f"1:{i}") for i in range(4000))
        assert 700 <= kept <= 1300  # ~1000 expected

    def test_collector_is_a_bounded_ring(self):
        c = SpanCollector(capacity=16)
        for i in range(50):
            c.add(Span("t", f"s{i}", i, 1))
        assert len(c) == 16
        assert c.emitted == 50
        names = [s.name for s in c.snapshot()]
        assert names == [f"s{i}" for i in range(34, 50)]  # newest survive

    def test_chrome_trace_export_shape(self, tmp_path):
        c = SpanCollector()
        c.add(Span("1:5", "processor.command", 100, 25, partition_id=1,
                   attrs={"position": 5}))
        c.add(Span("1:5", "exporter.export", 130, 5, partition_id=1,
                   parent="processor.command"))
        doc = c.chrome_trace()
        events = doc["traceEvents"]
        assert len(events) == 2
        assert all(e["ph"] == "X" for e in events)
        assert events[0]["args"]["traceId"] == "1:5"
        assert events[0]["tid"] == events[1]["tid"]  # same trace → same lane
        path = tmp_path / "trace.json"
        assert c.write_chrome_trace(path) == 2
        assert json.loads(path.read_text())["traceEvents"]
        jsonl = tmp_path / "spans.jsonl"
        assert c.to_jsonl(jsonl) == 2
        lines = [json.loads(line) for line in jsonl.read_text().splitlines()]
        assert lines[0]["name"] == "processor.command"


# ---------------------------------------------------------------------------
# Prometheus text-exposition escaping (satellite fix)


class TestExpositionEscaping:
    def test_label_values_are_escaped_per_spec(self):
        from zeebe_tpu_torch.utils.metrics import MetricsRegistry

        reg = MetricsRegistry(namespace="esc")
        counter = reg.counter("evil_total", "evil labels", ("name",))
        counter.labels('back\\slash "quoted"\nnewline').inc()
        body = reg.expose()
        line = next(l for l in body.splitlines()
                    if l.startswith("esc_evil_total{"))
        assert '\\\\slash' in line
        assert '\\"quoted\\"' in line
        assert '\\n' in line
        assert "\n" not in line  # the raw newline never reaches the output
        # exactly one sample line — a raw newline would have split it in two
        assert sum(1 for l in body.splitlines()
                   if l.startswith("esc_evil_total")) >= 1

    def test_help_text_escapes_backslash_and_newline(self):
        from zeebe_tpu_torch.utils.metrics import MetricsRegistry

        reg = MetricsRegistry(namespace="esc2")
        reg.gauge("g", "line one\nline two \\ done").set(1)
        body = reg.expose()
        help_line = next(l for l in body.splitlines() if l.startswith("# HELP"))
        assert help_line == "# HELP esc2_g line one\\nline two \\\\ done"

    def test_histogram_child_labels_escaped(self):
        from zeebe_tpu_torch.utils.metrics import MetricsRegistry

        reg = MetricsRegistry(namespace="esc3")
        hist = reg.histogram("h", "", ("who",), buckets=(1.0,))
        hist.labels('a"b').observe(0.5)
        body = reg.expose()
        assert 'who="a\\"b"' in body


# ---------------------------------------------------------------------------
# trace-context propagation on the live processing path


class TestProcessingSpans:
    def test_sequential_processing_emits_spans_and_ack_latency(self, tracing):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p")
            jobs = h.activate_jobs("w")
            h.complete_job(jobs[0]["key"])
            assert h.is_instance_done(key)
        finally:
            h.close()
        spans = tracing.collector.snapshot()
        names = {s.name for s in spans}
        assert "processor.command" in names
        # every span carries the partition:root trace id scheme
        for s in spans:
            if s.name == "processor.command":
                assert s.trace_id.startswith("1:")
                assert s.attrs and "position" in s.attrs
        # append→ack latency observed for the processed commands
        pct = tracing.latency_percentiles()
        assert pct["ack_count"] >= 3  # deploy + create + activate + complete
        assert pct["ack_p50_ms"] >= 0
        assert pct["ack_p99_ms"] >= pct["ack_p50_ms"]

    def test_replay_emits_zero_spans(self, tracing):
        from zeebe_tpu_torch.engine import Engine
        from zeebe_tpu_torch.state import ZbDb
        from zeebe_tpu_torch.stream import StreamProcessor, StreamProcessorMode

        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p")
            jobs = h.activate_jobs("w")
            h.complete_job(jobs[0]["key"])
            assert h.is_instance_done(key)
            before = [(s.name, s.trace_id, (s.attrs or {}).get("position"))
                      for s in tracing.collector.snapshot()]
            assert before, "live processing emitted no spans — vacuous test"

            # a restarted/follower replica replays the same log: zero spans
            db = ZbDb()
            engine = Engine(db, 1, clock_millis=h.clock)
            replayer = StreamProcessor(h.stream, db, engine,
                                       mode=StreamProcessorMode.REPLAY)
            replayer.start()
            replayer.run_until_idle()
            assert replayer.phase.value != "failed"
            after = [(s.name, s.trace_id, (s.attrs or {}).get("position"))
                     for s in tracing.collector.snapshot()]
            assert after == before, "replay minted spans"
        finally:
            h.close()

    def test_kernel_batch_path_emits_group_and_stage_spans(self, tracing):
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(one_task())
            for i in range(6):
                h.create_instance("p")
            names = {s.name for s in tracing.collector.snapshot()}
            if h.kernel_backend.groups_processed:
                assert "processor.kernel_group" in names
                assert "processor.stage.device" in names
                assert "processor.kernel_command" in names
        finally:
            h.close()

    def test_disabled_tracer_collects_nothing(self):
        tracer = get_tracer()
        assert not tracer.enabled
        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            h.create_instance("p")
        finally:
            h.close()
        assert len(tracer.collector) == 0

    def test_transitive_roots_keep_multi_hop_chains_on_one_trace(self, tracing):
        """A follow-up command's own follow-ups must resolve to the ORIGINAL
        root, not fragment per hop — sampling would otherwise tear the trace
        apart at depth 2."""
        # client command at 10 (no source), its follow-ups at 15-16
        # (source=10), a grandchild batch at 20 (source=15)
        tracing.register_batch(1, 10, 1, -1)
        tracing.register_batch(1, 15, 2, 10)
        tracing.register_batch(1, 20, 1, 15)
        assert tracing.resolve_root(1, 10, 10) == 10
        assert tracing.resolve_root(1, 15, 10) == 10
        assert tracing.resolve_root(1, 16, 10) == 10
        assert tracing.resolve_root(1, 20, 15) == 10  # transitive, not 15
        # unknown position falls back to the caller's one-hop guess
        assert tracing.resolve_root(1, 99, 42) == 42
        # other partitions don't alias
        assert tracing.resolve_root(2, 15, 7) == 7

    def test_export_spans_deduped_on_redelivery(self, tracing):
        assert tracing.mark_exported(("es", 1, 10))
        assert not tracing.mark_exported(("es", 1, 10))  # re-delivery
        assert tracing.mark_exported(("es", 1, 11))
        assert tracing.mark_exported(("other", 1, 10))  # second exporter: own span


# ---------------------------------------------------------------------------
# lineage walker


class TestLineage:
    def test_one_task_causal_chain_from_journal_alone(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p", request_id=41)
            jobs = h.activate_jobs("w")
            h.complete_job(jobs[0]["key"], request_id=42)
            assert h.is_instance_done(key)
            lineage = collect_lineage(h.stream, key)
        finally:
            h.close()
        assert lineage["processInstanceKey"] == key
        roots = lineage["roots"]
        assert roots, "no causal roots found"
        # the CREATE command tree: gateway request annotated at the root
        create_root = next(
            r for r in roots
            if r["valueType"] == "PROCESS_INSTANCE_CREATION")
        assert create_root["recordType"] == "COMMAND"
        assert create_root["gatewayRequestId"] == 41
        flat = _flatten(create_root)
        kinds = {(n["valueType"], n["intent"]) for n in flat}
        assert ("PROCESS_INSTANCE", "ELEMENT_ACTIVATING") in kinds
        assert ("JOB", "CREATED") in kinds
        # the COMPLETE command tree carries the instance to completion
        complete_root = next(
            r for r in roots
            if r["valueType"] == "JOB" and r["intent"] == "COMPLETE")
        assert complete_root["gatewayRequestId"] == 42
        kinds = {(n["valueType"], n["intent"])
                 for n in _flatten(complete_root)}
        assert ("PROCESS_INSTANCE", "ELEMENT_COMPLETED") in kinds
        # ASCII rendering mentions the root request
        text = format_lineage(lineage)
        assert "gateway request 41" in text
        assert f"process instance {key}" in text

    def test_fan_out_lineage_covers_both_branches(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(fan_out())
            key = h.create_instance("fan")
            for job_type in ("wa", "wb"):
                jobs = h.activate_jobs(job_type)
                assert jobs, f"no {job_type} job"
                h.complete_job(jobs[0]["key"])
            assert h.is_instance_done(key)
            lineage = collect_lineage(h.stream, key)
        finally:
            h.close()
        flat = [n for r in lineage["roots"] for n in _flatten(r)]
        element_ids = {n.get("elementId") for n in flat}
        assert {"a", "b", "fork", "join"} <= element_ids
        # both service tasks' jobs appear in the causal forest
        job_nodes = [n for n in flat
                     if n["valueType"] == "JOB" and n["intent"] == "CREATED"]
        assert len(job_nodes) >= 2

    def test_message_correlation_flow_joins_publish_tree(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(msg_catch())
            key = h.create_instance("pay", variables={"uid": "order-7"})
            assert not h.is_instance_done(key)
            h.publish_message("paid", "order-7", variables={"amount": 3},
                              request_id=77)
            h.pump()
            assert h.is_instance_done(key)
            lineage = collect_lineage(h.stream, key)
        finally:
            h.close()
        publish_roots = [r for r in lineage["roots"]
                         if r["valueType"] == "MESSAGE"]
        assert publish_roots, "publish command not part of the causal forest"
        assert publish_roots[0]["gatewayRequestId"] == 77
        kinds = {(n["valueType"], n["intent"])
                 for r in lineage["roots"] for n in _flatten(r)}
        assert ("PROCESS_MESSAGE_SUBSCRIPTION", "CORRELATED") in kinds \
            or ("PROCESS_INSTANCE", "ELEMENT_COMPLETED") in kinds

    def test_exported_annotation(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p")
            mid = h.stream.last_position // 2
            lineage = collect_lineage(h.stream, key, exported_position=mid)
        finally:
            h.close()
        flat = [n for r in lineage["roots"] for n in _flatten(r)]
        assert any(n["exported"] for n in flat)
        assert all("exported" in n for n in flat)


def _flatten(node: dict) -> list[dict]:
    out = [node]
    for child in node.get("children", ()):
        out.extend(_flatten(child))
    return out


# ---------------------------------------------------------------------------
# CLI `trace` (offline, journal alone)


class TestCliTrace:
    def test_trace_command_reconstructs_chain_offline(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        h = EngineHarness(directory=tmp_path, device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p", request_id=9)
            jobs = h.activate_jobs("w")
            h.complete_job(jobs[0]["key"])
            assert h.is_instance_done(key)
        finally:
            h.close()  # journal closed: the CLI opens it like a fresh process

        rc = cli.main(["trace", str(key),
                       "--journal-dir", str(tmp_path / "log")])
        assert rc == 0
        lineage = json.loads(capsys.readouterr().out)
        assert lineage["processInstanceKey"] == key
        roots = lineage["roots"]
        create_root = next(r for r in roots
                           if r["valueType"] == "PROCESS_INSTANCE_CREATION")
        assert create_root["gatewayRequestId"] == 9
        kinds = {(n["valueType"], n["intent"])
                 for r in roots for n in _flatten(r)}
        assert ("PROCESS_INSTANCE", "ELEMENT_COMPLETED") in kinds
        assert ("JOB", "CREATED") in kinds

    def test_trace_data_dir_fallback_and_pretty(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        h = EngineHarness(directory=tmp_path, device="cpu")
        try:
            h.deploy(one_task())
            key = h.create_instance("p", request_id=3)
        finally:
            h.close()
        rc = cli.main(["trace", str(key), "--data-dir", str(tmp_path),
                       "--pretty"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "gateway request 3" in out

    def test_trace_unknown_key_fails_cleanly(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        h = EngineHarness(directory=tmp_path, device="cpu")
        try:
            h.deploy(one_task())
        finally:
            h.close()
        rc = cli.main(["trace", "999999",
                       "--journal-dir", str(tmp_path / "log")])
        assert rc == 1


# ---------------------------------------------------------------------------
# exporter lag gauge (satellite) + /traces endpoint


class TestExporterLagGauge:
    def test_paused_exporter_lag_grows_while_sibling_drains(self):
        from zeebe_tpu_torch.exporters import ExporterDirector
        from zeebe_tpu_torch.exporters.api import Exporter
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        class Good(Exporter):
            def export(self, record):
                self.controller.update_last_exported_position(record.position)

        class AlwaysFails(Exporter):
            def export(self, record):
                raise RuntimeError("down")

        h = EngineHarness(device="cpu")
        try:
            director = ExporterDirector(
                h.stream, h.db, {"good": Good(), "bad": AlwaysFails()},
                clock_millis=h.clock)
            h.deploy(one_task())
            h.create_instance("p")
            for _ in range(3):
                director.export_available()
                h.clock.advance(50)
            gauge = REGISTRY.gauge(
                "exporter_container_lag_records", "", ("exporter", "partition"))
            good_lag = gauge.labels("good", "1").value
            bad_lag = gauge.labels("bad", "1").value
            assert good_lag == 0
            assert bad_lag >= h.stream.last_position - 1
        finally:
            h.close()


class TestTracesEndpoint:
    def test_traces_endpoint_serves_spans_and_chrome_format(self, tracing):
        import urllib.request

        from zeebe_tpu_torch.broker.management import ManagementServer

        tracing.emit("1:5", "processor.command", 0.001, 1,
                     attrs={"position": 5})
        tracing.emit("1:5", "exporter.export", 0.0005, 1)
        server = ManagementServer(broker=None)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(f"{base}/traces", timeout=5) as resp:
                doc = json.loads(resp.read())
            assert doc["enabled"] is True
            assert len(doc["spans"]) == 2
            assert doc["spans"][0]["traceId"] == "1:5"
            with urllib.request.urlopen(
                    f"{base}/traces?format=chrome&limit=1", timeout=5) as resp:
                chrome = json.loads(resp.read())
            assert len(chrome["traceEvents"]) == 1
            assert chrome["traceEvents"][0]["ph"] == "X"
        finally:
            server.stop()


class TestAckHistogram:
    def test_command_ack_latency_registered_and_observed(self, tracing):
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task())
            h.create_instance("p")
        finally:
            h.close()
        hist = REGISTRY.histogram("command_ack_latency", "", ("scope",))
        child = hist.labels("processor")
        assert child.count >= 2  # deploy + create at minimum
        assert "command_ack_latency" in REGISTRY.expose()
