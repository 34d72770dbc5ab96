"""The port's spans where its host work really started, on the device
trace's clock: a kernel group's stage spans in sequence inside the group
span, ``journal.flush`` at the flush's start and before its listeners with
the journal's partition and member, the submit's ``gateway.partition_lock``,
the collections' ``runtime.gc`` spans (only while tracing is on, and
without the span collector's lock), the automaton calls' geometry counted
only while tracing is on, and nothing of it while tracing is off."""

from __future__ import annotations

import collections
import gc
import threading

import pytest
import torch

from zeebe_tpu_torch.gateway import ClusterRuntime
from zeebe_tpu_torch.journal.journal import SegmentedJournal
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.observability import configure_tracing, critical_path, get_tracer, host_spans
from zeebe_tpu_torch.observability.span import now_us
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.testing import EngineHarness

#: int() truncation of each start and duration on the microsecond clock
ROUNDING_US = 2
STAGES = ("decode", "dispatch", "device", "materialize", "append", "flush")


@pytest.fixture
def tracing():
    tracer = configure_tracing(enabled=True, seed=7, capacity=1 << 16)
    try:
        yield tracer
    finally:
        configure_tracing(enabled=False)


def one_task():
    return (Bpmn.create_executable_process("p").start_event("s")
            .service_task("t", job_type="w").end_event("e").done())


def _end(span) -> int:
    return span.start_us + span.dur_us


def test_stage_spans_lie_in_sequence_inside_the_group(tracing):
    h = EngineHarness(use_kernel_backend=True, device="cpu")
    try:
        h.deploy(one_task())
        for i in range(6):
            h.create_instance("p", {"x": i})
        assert h.kernel_backend.groups_processed
    finally:
        h.close()
    spans = tracing.collector.snapshot()
    groups = [s for s in spans if s.name == "processor.kernel_group"]
    assert groups
    for group in groups:
        stages = sorted((s for s in spans if s.trace_id == group.trace_id
                         and s.name.startswith("processor.stage.")),
                        key=lambda s: s.start_us)
        names = [s.name.removeprefix("processor.stage.") for s in stages]
        assert set(names) <= set(STAGES) and {"decode", "device", "materialize"} <= set(names)
        # in pipeline order, each at or after the previous one's end
        assert names == sorted(names, key=STAGES.index)
        for before, after in zip(stages, stages[1:]):
            assert after.start_us >= _end(before) - ROUNDING_US, (before.name, after.name)
        assert stages[0].start_us >= group.start_us - ROUNDING_US
        assert _end(stages[-1]) <= _end(group) + ROUNDING_US
        # the overlap is an attribute of the group, not a span on the time axis
        assert "overlapUs" in group.attrs and "overlap" not in names
        # one span a stage: the first chunk's dispatch is a stage of its own
        assert len(names) == len(set(names))


def test_the_critical_path_charges_a_groups_dispatch_and_wait_to_the_device(tracing):
    """A real kernel group through ``breakdowns_from_spans``: the device edge
    of a command that rode it is the group's ``device_elapsed`` (its
    dispatch and wait spans) over the sum of its stages."""
    h = EngineHarness(use_kernel_backend=True, device="cpu")
    device_elapsed = []
    note = h.kernel_backend.note_group_success

    def noted(pending):
        device_elapsed.append(pending.device_elapsed)
        note(pending)

    h.kernel_backend.note_group_success = noted
    try:
        h.deploy(one_task())
        for i in range(6):
            h.create_instance("p", {"x": i})
    finally:
        h.close()
    spans = [s.to_dict() for s in tracing.collector.snapshot()]
    groups = sorted((s for s in spans if s["name"] == "processor.kernel_group"),
                    key=lambda s: s["startUs"])
    assert groups and len(groups) == len(device_elapsed)
    fractions = {}
    for group, elapsed in zip(groups, device_elapsed):
        stages = {s["name"].removeprefix("processor.stage."): s["durUs"] for s in spans
                  if s["traceId"] == group["traceId"] and s["name"].startswith("processor.stage.")}
        device_us = stages.get("dispatch", 0) + stages["device"]
        assert device_us == pytest.approx(elapsed * 1e6, abs=ROUNDING_US)
        fractions[group["traceId"]] = device_us / sum(stages.values())
    checked = 0
    for command in (s for s in spans if s["name"] == "processor.kernel_command"):
        # the command's root and its share of the group, and nothing else of
        # its trace: the group's split alone decides the edges
        roots = [s for s in spans if s["traceId"] == command["traceId"]
                 and s["name"] == "processor.ack"
                 and s["attrs"]["position"] == command["attrs"]["position"]]
        for breakdown in critical_path.breakdowns_from_spans(
                roots + [command] + [s for s in spans if s["traceId"] == command["attrs"]["group"]]):
            edges = breakdown["edges"]
            charged = edges["device"] + edges["host-execute"] + edges["fsync"]
            if charged <= 0:
                continue
            assert edges["device"] / charged == pytest.approx(
                fractions[command["attrs"]["group"]], rel=1e-3, abs=1e-3)
            checked += 1
    assert checked


def test_journal_flush_starts_before_its_listeners_and_names_its_owner(tmp_path, tracing):
    journal = SegmentedJournal(tmp_path / "j", owner=(3, "broker-1"))
    heard = []
    journal.flush_listeners.append(lambda index: heard.append(now_us()))
    try:
        t0 = now_us()
        journal.append(b"x" * 64)
        journal.flush()
    finally:
        journal.close()
    (span,) = [s for s in tracing.collector.snapshot() if s.name == "journal.flush"]
    assert span.attrs["partition"] == 3 and span.attrs["member"] == "broker-1"
    assert span.partition_id == 3 and span.attrs["journal"] == "j"
    assert t0 - ROUNDING_US <= span.start_us
    assert _end(span) <= heard[0] + ROUNDING_US


def _submit(runtime, record):
    reply = runtime.submit(1, record, timeout_s=30.0)
    assert not reply.is_rejection, reply
    return reply


def test_submit_waits_for_the_partition_lock_under_its_request(tmp_path, tracing):
    runtime = ClusterRuntime(broker_count=1, partition_count=1, replication_factor=1,
                             directory=tmp_path / "c", device="cpu")
    runtime.start()
    try:
        runtime.await_leaders()
        _submit(runtime, command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
            "resources": [{"resourceName": "p.bpmn", "resource": to_bpmn_xml(one_task())}]}))
        _submit(runtime, command(ValueType.PROCESS_INSTANCE_CREATION,
                                 ProcessInstanceCreationIntent.CREATE,
                                 {"bpmnProcessId": "p", "version": -1, "variables": {}}))
        jobs = _submit(runtime, command(ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE, {
            "type": "w", "worker": "t", "timeout": 60_000, "maxJobsToActivate": 1}))
        for key in jobs.value["jobKeys"]:
            _submit(runtime, command(ValueType.JOB, JobIntent.COMPLETE, {"variables": {}},
                                     key=key))
        members = {b.raft.member_id for b in
                   (p for broker in runtime.brokers.values()
                    for p in broker.partitions.values())}
    finally:
        runtime.stop()
    spans = tracing.collector.snapshot()
    requests = {s.trace_id: s for s in spans if s.name == "gateway.request"}
    locks = [s for s in spans if s.name == "gateway.partition_lock"]
    assert len(locks) == len(requests) >= 4
    for lock in locks:
        request = requests[lock.trace_id]
        assert lock.parent == "gateway.request"
        assert request.start_us - ROUNDING_US <= lock.start_us
        assert _end(lock) <= _end(request) + ROUNDING_US
    flushes = [s for s in spans if s.name == "journal.flush"]
    assert flushes
    assert {(s.attrs["partition"], s.attrs["member"]) for s in flushes} <= {
        (1, m) for m in members}
    assert {s.attrs["journal"] for s in flushes} <= {"stream", "raft-log"}


def test_gc_spans_only_while_tracing_is_on():
    tracer = get_tracer()
    configure_tracing(enabled=False)
    assert host_spans.GC not in gc.callbacks
    gc.collect()
    assert not host_spans.GC.pending
    configure_tracing(enabled=True, seed=1, capacity=1 << 10)
    try:
        assert host_spans.GC in gc.callbacks
        t0 = now_us()
        gc.collect()
        gc.collect(1)  # a younger generation: no span
        assert host_spans.drain_gc(tracer) == 1
        (span,) = [s for s in tracer.collector.snapshot() if s.name == "runtime.gc"]
        assert span.trace_id == host_spans.GC_TRACE_ID
        assert t0 - ROUNDING_US <= span.start_us <= now_us()
    finally:
        configure_tracing(enabled=False)
    assert host_spans.GC not in gc.callbacks
    gc.collect()
    assert not host_spans.GC.pending


class _CollectingDeque(list):
    """A span ring whose append runs a full collection, as one that starts
    while a thread holds the collector's lock."""

    def append(self, item) -> None:
        gc.collect()
        super().append(item)


def test_a_collection_inside_the_collectors_lock_does_not_deadlock(tracing):
    tracing.collector._spans = _CollectingDeque()
    done = threading.Event()

    def add():
        tracing.emit("t:1", "x", 0.001)
        done.set()

    thread = threading.Thread(target=add, daemon=True)
    thread.start()
    thread.join(30.0)
    assert done.is_set() and not thread.is_alive()
    tracing.collector._spans = collections.deque(maxlen=tracing.collector.capacity)
    assert host_spans.drain_gc(tracing) == 1
    assert [s.name for s in tracing.collector.snapshot()] == ["runtime.gc"]


class _Enqueued(Exception):
    pass


def _enqueue_on_cpu(monkeypatch):
    """``kernels._enqueue``'s count on CPU tensors: the allocation that
    follows it (the card's) is cut short."""
    from zeebe_tpu_torch.ops import automaton as A
    from zeebe_tpu_torch.ops.tables import compile_tables
    from zeebe_tpu_torch.models.bpmn import transform

    def stop(*args, **kwargs):
        raise _Enqueued

    monkeypatch.setattr(kernels, "allocate", stop)
    tables = compile_tables([transform(one_task())])
    dt = A.DeviceTables.from_numpy(tables, "cpu")
    state = A.make_state(tables, 4, torch.zeros(4, dtype=torch.int32).numpy(),
                         token_capacity=16, device="cpu")
    out = torch.empty((8, 10), dtype=torch.int32)
    with pytest.raises(_Enqueued):
        kernels._enqueue(dt, state, 8, tables.kernel_config, 0, out, 10, 1, False, "fused")
    return dt, state


def test_the_geometry_counts_only_while_tracing_is_on(monkeypatch):
    from zeebe_tpu_torch.ops import automaton as A

    monkeypatch.setattr(kernels, "GEOMETRY", {})
    configure_tracing(enabled=False)
    _enqueue_on_cpu(monkeypatch)
    assert A.geometry_counts() == []
    configure_tracing(enabled=True, seed=1)
    try:
        dt, state = _enqueue_on_cpu(monkeypatch)
        _enqueue_on_cpu(monkeypatch)
    finally:
        configure_tracing(enabled=False)
    (geometry,) = A.geometry_counts()
    assert geometry["path"] == "fused" and geometry["calls"] == 2
    assert geometry["out_bytes"] == 8 * 10 * 4
    assert geometry["tables"]["kernel_op"] == dt.kernel_op.numel() * 4
    assert geometry["state"]["elem"] == state["elem"].numel() * 4
    assert set(geometry["flags"]) == set(kernels.GEOMETRY_FLAGS)


def test_tracing_off_emits_nothing_at_the_new_sites(tmp_path, monkeypatch):
    """With tracing off: no hook, no geometry, no span from a journal flush,
    a kernel group or a submit."""
    monkeypatch.setattr(kernels, "GEOMETRY", {})
    tracer = configure_tracing(enabled=False)
    journal = SegmentedJournal(tmp_path / "j", owner=(1, "m"))
    journal.append(b"x")
    journal.flush()
    journal.close()
    h = EngineHarness(use_kernel_backend=True, device="cpu")
    try:
        h.deploy(one_task())
        h.create_instance("p", {"x": 1})
        assert h.kernel_backend.groups_processed
    finally:
        h.close()
    _enqueue_on_cpu(monkeypatch)
    assert tracer.collector.emitted == 0 and len(tracer.collector) == 0
    assert host_spans.GC not in gc.callbacks and not host_spans.GC.pending
    assert kernels.GEOMETRY == {}
