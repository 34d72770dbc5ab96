# tests/test_critical_path.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""The latency observatory: critical-path extraction as pure
units over hand-built span DAGs, the cluster assembler's merge == the
per-process dumps it consumed, and the live span seams the extractor
depends on — exactly-once emission at the speculative-dispatch seam, the
failed-covering-fsync blackout (no ack span, no ack observation for a
rewound prefix), and the mesh-runner submit seam."""

from __future__ import annotations

import json
import random

import pytest

from zeebe_tpu_torch.journal import SegmentedJournal
from zeebe_tpu_torch.journal.journal import FlushFailedError
from zeebe_tpu_torch.logstreams import LogAppendEntry, LogStream
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.observability import (
    EDGES,
    Span,
    SpanCollector,
    aggregate_breakdowns,
    assemble,
    breakdowns_from_spans,
    check_conservation,
    configure_tracing,
    load_spans,
    top_stages,
)
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import SignalIntent
from zeebe_tpu_torch.state import ColumnFamilyCode, ZbDb
from zeebe_tpu_torch.stream import StreamProcessor
from zeebe_tpu_torch.testing import EngineHarness
from zeebe_tpu_torch.testing.evidence import collect_span_dumps
from zeebe_tpu_torch.utils import storage_io


@pytest.fixture()
def tracing():
    tracer = configure_tracing(enabled=True, seed=0, sample_rate=1.0,
                               capacity=1 << 15, reset=True)
    try:
        yield tracer
    finally:
        configure_tracing(enabled=False, reset=True)


def span(trace, name, start, dur, parent="", **attrs):
    """A span dict in the JSONL/`Span.to_dict()` shape the extractor eats."""
    return {"traceId": trace, "name": name, "startUs": start, "durUs": dur,
            "partitionId": 1, "parent": parent,
            "attrs": attrs if attrs else None}


def one_task(pid="one_task"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("start").service_task("task", job_type="work")
        .end_event("end").done()
    )


# ---------------------------------------------------------------------------
# pure-unit extraction over hand-built DAGs


class TestExtractorUnits:
    def test_overlapped_device_fsync_latest_start_wins(self):
        """Overlapping replicate/device/fsync intervals: every elementary
        segment goes to the covering interval with the LATEST start (the
        deepest blocked-on cause), never double-charged."""
        spans = [
            span("1:10", "gateway.request", 0, 1000),
            span("1:10", "raft.replicate", 0, 400),
            span("1:10", "processor.stage.device", 100, 500),
            span("1:10", "processor.fsync_wait", 500, 400),
        ]
        (b,) = breakdowns_from_spans(spans)
        assert b["totalUs"] == 1000.0
        assert b["edges"]["replicate"] == 100.0   # [0,100): only replicate
        assert b["edges"]["device"] == 400.0      # [100,500) then loses to fsync
        assert b["edges"]["fsync"] == 400.0       # [500,900): latest start
        assert b["unattributedUs"] == 100.0       # [900,1000): uncovered
        assert check_conservation(b) == []

    def test_coalesce_dominated_trace_ranks_coalesce_first(self):
        spans = [
            span("1:20", "gateway.request", 0, 1000),
            span("1:20", "gateway.coalesce_wait", 0, 700),
            span("1:20", "broker.command_append", 700, 50),
            span("1:20", "processor.reply_release", 750, 50),
        ]
        (b,) = breakdowns_from_spans(spans)
        assert b["edges"]["coalesce"] == 700.0
        assert b["edges"]["host-execute"] == 50.0
        assert b["edges"]["reply"] == 50.0
        assert b["unattributedUs"] == 200.0
        agg = aggregate_breakdowns([b])
        ranked = top_stages(agg)
        assert ranked[0]["stage"] == "coalesce"
        assert check_conservation(b) == []

    def test_replication_dominated_trace(self):
        spans = [
            span("1:30", "gateway.request", 0, 1000),
            span("1:30", "raft.replicate", 0, 900),
            # nested host work: later start steals its segment from replicate
            span("1:30", "processor.command", 850, 50),
        ]
        (b,) = breakdowns_from_spans(spans)
        assert b["edges"]["replicate"] == 850.0
        assert b["edges"]["host-execute"] == 50.0
        assert b["unattributedUs"] == 100.0
        assert top_stages(aggregate_breakdowns([b]))[0]["stage"] == "replicate"

    def test_group_substitution_splits_by_stage_fractions(self):
        """A batched command's 1/N accounting share is replaced by its
        wave's REAL wall interval, split by the wave's measured stage
        fractions — a request that rode a wave waited the wave's wall."""
        spans = [
            span("1:40", "gateway.request", 0, 1000, position=40),
            span("1:40", "processor.kernel_command", 600, 10,
                 position=40, group="1:g40", attributed=True),
            span("1:g40", "processor.kernel_group", 200, 600),
            span("1:g40", "processor.stage.device", 200, 300),
            span("1:g40", "processor.stage.flush", 500, 150),
            span("1:g40", "processor.stage.append", 650, 150),
        ]
        breakdowns = breakdowns_from_spans(spans)
        assert len(breakdowns) == 1  # the group trace has no root of its own
        (b,) = breakdowns
        # wave wall 600us split 300/150/150 → device .5 / fsync .25 / host .25
        assert b["edges"]["device"] == 300.0
        assert b["edges"]["fsync"] == 150.0
        assert b["edges"]["host-execute"] == 150.0
        assert b["unattributedUs"] == 400.0  # [0,200) + [800,1000)
        assert check_conservation(b) == []

    def test_discarded_speculative_span_is_off_path(self):
        spans = [
            span("1:50", "gateway.request", 0, 1000),
            span("1:50", "processor.speculative", 0, 500,
                 speculative=True, outcome="discarded"),
        ]
        (b,) = breakdowns_from_spans(spans)
        assert b["edges"]["device"] == 0.0
        assert b["unattributedUs"] == 1000.0

    def test_child_skew_is_clipped_to_the_root_window(self):
        """A skewed child (cross-process clock) can never inflate an edge
        past the measured total — it clips, and skew lands in residual."""
        spans = [
            span("1:60", "gateway.request", 100, 500),
            span("1:60", "raft.replicate", 0, 2000),  # wildly skewed
        ]
        (b,) = breakdowns_from_spans(spans)
        assert b["edges"]["replicate"] == 500.0
        assert b["unattributedUs"] == 0.0
        assert check_conservation(b) == []

    def test_conservation_violation_detection(self):
        (clean,) = breakdowns_from_spans([
            span("1:70", "gateway.request", 0, 1000),
            span("1:70", "processor.fsync_wait", 0, 600),
        ])
        assert check_conservation(clean) == []
        inflated = {**clean, "edges": dict(clean["edges"])}
        inflated["edges"]["device"] = 500.0  # hand-damaged: sum overshoots
        assert any("!=" in v for v in check_conservation(inflated))
        negative = {**clean, "edges": {**clean["edges"], "reply": -5.0}}
        assert any("negative edge" in v for v in check_conservation(negative))

    def test_aggregate_reports_every_edge_zero_filled(self):
        (b,) = breakdowns_from_spans([
            span("1:80", "gateway.request", 0, 100),
            span("1:80", "processor.fsync_wait", 0, 100),
        ])
        agg = aggregate_breakdowns([b])
        assert set(agg["edges"]) == set(EDGES)
        assert agg["edges"]["device"] == {"p50Us": 0.0, "p99Us": 0.0}
        assert agg["unattributed"]["fracOfP99"] == 0.0


# ---------------------------------------------------------------------------
# assembler merge == per-process dumps (seeded round-trip)


class TestAssemblerMerge:
    def test_seeded_round_trip_merge_equals_per_process_dumps(self, tmp_path):
        """Two processes (gateway + worker) dump disjoint halves of the same
        traces; the assembler's merge must be exactly the union, ordered by
        start, with nothing lost or invented across the JSONL round-trip."""
        rng = random.Random(0x19)
        gw, worker = SpanCollector(capacity=1 << 12), SpanCollector(capacity=1 << 12)
        expected: dict[str, list[tuple]] = {}
        for i in range(40):
            trace = f"{1 + i % 2}:{100 + i}"
            t0 = rng.randrange(0, 10_000)
            total = rng.randrange(200, 2000)
            gw.add(Span(trace, "gateway.request", t0, total,
                        partition_id=1 + i % 2))
            worker.add(Span(trace, "processor.fsync_wait",
                            t0 + rng.randrange(0, total // 2),
                            rng.randrange(1, total // 2),
                            partition_id=1 + i % 2, parent="processor.ack"))
            expected.setdefault(trace, [])
        (tmp_path / "gw").mkdir()
        (tmp_path / "w0").mkdir()
        assert gw.to_jsonl(tmp_path / "gw" / "spans-gw-1.jsonl") == 40
        assert worker.to_jsonl(tmp_path / "w0" / "spans-w0-2.jsonl") == 40
        dumps = collect_span_dumps(tmp_path)
        assert [p.name for p in dumps] == ["spans-gw-1.jsonl",
                                           "spans-w0-2.jsonl"]
        merged = assemble(load_spans(dumps))
        assert set(merged) == set(expected)
        in_memory = assemble([s.to_dict() for s in gw.snapshot()]
                             + [s.to_dict() for s in worker.snapshot()])
        assert merged == in_memory  # the round-trip loses nothing
        for spans in merged.values():
            assert {s["name"] for s in spans} == {"gateway.request",
                                                  "processor.fsync_wait"}
            starts = [s["startUs"] for s in spans]
            assert starts == sorted(starts)
        # and the merged view extracts: one breakdown per root, conserving
        breakdowns = breakdowns_from_spans(load_spans(dumps))
        assert len(breakdowns) == 40
        for b in breakdowns:
            assert check_conservation(b) == []

    def test_load_spans_skips_torn_and_foreign_lines(self, tmp_path):
        path = tmp_path / "spans-w0-9.jsonl"
        path.write_text(
            json.dumps(span("1:1", "gateway.request", 0, 10)) + "\n"
            + '{"traceId": "1:2", "name": "torn...\n'
            + "\n"
            + '{"noTraceId": true}\n')
        spans = load_spans([path, tmp_path / "missing.jsonl"])
        assert [s["traceId"] for s in spans] == ["1:1"]


# ---------------------------------------------------------------------------
# live seams: speculative exactly-once, mesh submit coverage


def create_cmd(process_id="one_task"):
    from zeebe_tpu_torch.protocol.intent import ProcessInstanceCreationIntent

    return command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": process_id, "version": -1, "variables": {}},
    )


class TestSpeculativeSpanSeam:
    def test_discarded_stash_emits_exactly_one_offpath_marker(self, tracing):
        """Satellite: a discarded speculation emits ONE ``speculative=true``
        marker with ``outcome="discarded"`` and nothing else — the re-scan
        of the same wave owns every kernel_group/kernel_command emission, so
        no command span may appear twice."""
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(one_task())
            h.stream.writer.try_write(
                [LogAppendEntry(create_cmd()) for _ in range(8)])
            sentinel = object()  # never consumable: a consume would crash
            h.processor._spec_group = (sentinel, -999, 0, 0.0)
            h.pump()
            spans = tracing.collector.snapshot()
            discarded = [s for s in spans
                         if s.name == "processor.speculative"
                         and (s.attrs or {}).get("outcome") == "discarded"]
            assert len(discarded) == 1
            assert discarded[0].attrs["speculative"] is True
            # the re-scanned wave emitted each command exactly once
            positions = [(s.attrs or {}).get("position") for s in spans
                         if s.name == "processor.kernel_command"]
            assert len(positions) == len(set(positions))
            # no orphan group skeleton rode the discarded marker's trace
            orphan_trace = discarded[0].trace_id
            names_on_orphan = {s.name for s in spans
                               if s.trace_id == orphan_trace}
            assert names_on_orphan == {"processor.speculative"}
        finally:
            h.close()

    def test_consumed_speculation_tagged_on_the_wave_trace(self, tracing):
        """The consumed marker lands on the REAL wave's group trace (where
        the extractor can see it as device time), outcome-tagged."""
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(one_task())
            h.stream.writer.try_write(
                [LogAppendEntry(create_cmd()) for _ in range(150)])
            h.pump()
            consumed = [s for s in tracing.collector.snapshot()
                        if s.name == "processor.speculative"
                        and (s.attrs or {}).get("outcome") == "consumed"]
            assert consumed, "multi-wave pump never consumed a speculation"
            assert all(":g" in s.trace_id for s in consumed)
        finally:
            h.close()


class TestMeshSubmitSeam:
    def test_mesh_submit_emits_group_trace_spans(self, tracing):
        """Acceptance: the mesh-runner submit seam emits spans, so the
        fused-dispatch refactor (ROADMAP item 1) inherits attribution."""
        from zeebe_tpu_torch.parallel.mesh_runner import MeshKernelRunner

        runner = MeshKernelRunner(n_shards=8, device="cpu")
        h = EngineHarness(use_kernel_backend=True, mesh_runner=runner, device="cpu")
        try:
            h.deploy(one_task())
            for i in range(6):
                h.create_instance("one_task", variables={"n": i})
            assert runner.dispatches > 0
            submits = [s for s in tracing.collector.snapshot()
                       if s.name == "kernel.mesh_submit"]
            assert submits, "mesh dispatch emitted no submit span"
            for s in submits:
                assert ":g" in s.trace_id  # rides the wave's group trace
                assert s.parent == "processor.kernel_group"
                assert {"instances", "tokens", "outcome"} <= set(s.attrs)
        finally:
            h.close()


# ---------------------------------------------------------------------------
# the live observatory: flight event + bounded slow-exemplar dumps


class TestLatencyObservatory:
    def test_roll_records_flight_event_and_exemplar_dump(self, tmp_path,
                                                         tracing):
        from zeebe_tpu_torch.observability import FlightRecorder, LatencyObservatory

        flight = FlightRecorder("n0", tmp_path, clock_millis=lambda: 1000,
                                max_dump_bytes=1 << 20)
        clock = [0.0]
        obs = LatencyObservatory(tracing, flight, partition_id=1,
                                 window_s=5.0, worst_n=2,
                                 clock=lambda: clock[0])
        tracing.emit("1:10", "processor.ack", 0.004, 1,
                     attrs={"position": 10}, start_us=1000)
        tracing.emit("1:10", "processor.fsync_wait", 0.003, 1,
                     parent="processor.ack",
                     attrs={"position": 10}, start_us=1500)
        tracing.emit("1:11", "processor.ack", 0.001, 1,
                     attrs={"position": 11}, start_us=1000)
        obs.observe("1:10", 0.004)
        obs.observe("1:11", 0.001)
        assert obs.status() is None  # nothing rolled yet
        clock[0] = 6.0
        obs.roll()
        status = obs.status()
        assert status["windowAcks"] == 2
        assert status["worstMs"] == 4.0
        assert status["topStages"][0]["stage"] == "fsync"
        events = [e for ring in flight.snapshot()["partitions"].values()
                  for e in ring if e["kind"] == "critical_path"]
        assert len(events) == 1
        assert events[0]["windowAcks"] == 2
        (dump,) = list(tmp_path.glob("flight-*.json"))
        doc = json.loads(dump.read_text())
        assert doc["reason"] == "slow-exemplars"
        assert "1:10" in doc["traces"]  # the worst trace ships its tree

    def test_exemplar_dump_respects_max_dump_bytes(self, tmp_path):
        """ZEEBE_FLIGHT_MAXDUMPBYTES applies to exemplar dumps: oversized
        payloads drop whole traces (largest first) and say so."""
        from zeebe_tpu_torch.observability import FlightRecorder

        flight = FlightRecorder("n0", tmp_path, clock_millis=lambda: 1000,
                                max_dump_bytes=400)
        path = flight.dump_payload("slow-exemplars", {"traces": {
            "1:1": [span("1:1", "processor.ack", 0, 100) for _ in range(50)],
            "1:2": [span("1:2", "processor.ack", 0, 100)],
        }})
        assert path is not None
        assert path.stat().st_size <= 400
        doc = json.loads(path.read_text())
        assert doc["truncatedTraces"] >= 1
        assert "1:1" not in doc["traces"]  # largest dropped first


# ---------------------------------------------------------------------------
# satellite: failed covering fsync emits no ack span / no ack observation


INCREMENT = SignalIntent.BROADCAST
INCREMENTED = SignalIntent.BROADCASTED


class _CounterProcessor:
    def __init__(self, db: ZbDb):
        self.cf = db.column_family(ColumnFamilyCode.DEFAULT)

    def accepts(self, value_type):
        return value_type == ValueType.SIGNAL

    def process(self, logged, result):
        from zeebe_tpu_torch.protocol import event

        ev = event(ValueType.SIGNAL, INCREMENTED, {})
        self.cf.put(("counter",), (self.cf.get(("counter",)) or 0) + 1)
        result.append_record(ev)
        if logged.record.request_id >= 0:
            result.with_response(ev, logged.record.request_stream_id,
                                 logged.record.request_id)

    def replay(self, logged):
        pass


class _FsyncFailOnJournal:
    def write_fault(self, path, n):
        return ("ok", 0)

    def fsync_fault(self, path):
        from zeebe_tpu_torch.testing.chaos_disk import classify_path

        if classify_path(path) == "journal":
            raise OSError(5, f"chaos fsync failure on {path}")


def _gated_env(tmp_path):
    journal = SegmentedJournal(tmp_path / "log", flush_interval=3600.0)
    stream = LogStream(journal, partition_id=1, clock=lambda: 1000)
    db = ZbDb()
    responses = []
    sp = StreamProcessor(stream, db, _CounterProcessor(db),
                         response_sink=responses.append)
    sp.start()
    return journal, stream, sp, responses


class TestFailedFlushEmitsNothing:
    def test_seeded_fsync_failure_interleave_blacks_out_ack_telemetry(
            self, tmp_path, tracing):
        """Seeded interleave of failing/healthy covering fsyncs: a failing
        iteration must move NEITHER the ``command_ack_latency`` count nor
        the ``processor.ack``/``processor.fsync_wait`` span set — the
        rewound prefix was never acked, so telemetry claiming it was would
        be the observability bug this PR exists to rule out."""
        rng = random.Random(0xA19)
        for i in range(10):
            fail = rng.random() < 0.5
            journal, stream, sp, responses = _gated_env(tmp_path / f"it{i}")
            stream.writer.try_write([LogAppendEntry(
                command(ValueType.SIGNAL, INCREMENT, {},
                        request_id=100 + i, request_stream_id=9))])
            assert sp.process_next()
            acks_before = tracing.latency_percentiles()["ack_count"]
            spans_before = sum(
                1 for s in tracing.collector.snapshot()
                if s.name in ("processor.ack", "processor.fsync_wait"))
            if fail:
                storage_io.install_controller(_FsyncFailOnJournal())
                try:
                    with pytest.raises(FlushFailedError):
                        sp.run_until_idle()
                finally:
                    storage_io.install_controller(None)
                assert responses == []
                after = sum(
                    1 for s in tracing.collector.snapshot()
                    if s.name in ("processor.ack", "processor.fsync_wait"))
                assert after == spans_before, (
                    "a rewound prefix emitted ack/fsync spans")
                assert (tracing.latency_percentiles()["ack_count"]
                        == acks_before), (
                    "a rewound prefix fed command_ack_latency")
            else:
                sp.run_until_idle()
                assert [r.request_id for r in responses] == [100 + i]
                assert (tracing.latency_percentiles()["ack_count"]
                        == acks_before + 1)
                ack_spans = [s for s in tracing.collector.snapshot()
                             if s.name == "processor.ack"]
                assert len(ack_spans) > 0
            journal.close()
