# tests/test_consistency.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Exactly-once command delivery under cluster chaos: the
replicated request-dedupe table, the TCP fault injector, the gateway's
bounded resend/re-route loop, and the Jepsen-shaped consistency checker.

Fast tests drive the real gateway↔worker protocol over the deterministic
loopback network in one process (same shape as test_multiproc); the slow
test runs the full consistency harness over real worker processes with a
kill and asserts the checker's verdict.
"""

from __future__ import annotations

import errno
import os
import threading
import time

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.protocol.record import command
from zeebe_tpu_torch.state import ColumnFamilyCode, ZbDb
from zeebe_tpu_torch.state.request_dedupe import RequestDedupeState
from zeebe_tpu_torch.testing.consistency import ClientOp, check_consistency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_task(pid="p"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type="w")
        .end_event("e").done()
    )


def simple(pid="p"):
    return (Bpmn.create_executable_process(pid)
            .start_event("s").end_event("e").done())


def deploy_cmd(model):
    return command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": f"{model.process_id}.bpmn",
                       "resource": to_bpmn_xml(model)}]})


def create_cmd(pid="p"):
    return command(
        ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": pid, "version": -1, "variables": {}})


# ---------------------------------------------------------------------------
# dedupe state facade


class TestRequestDedupeState:
    def test_note_lookup_and_reply_overwrite(self):
        db = ZbDb()
        ded = RequestDedupeState(db)
        from zeebe_tpu_torch.protocol.record import event
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceCreationIntent as PIC

        reply = event(ValueType.PROCESS_INSTANCE_CREATION, PIC.CREATED,
                      {"processInstanceKey": 7},
                      request_stream_id=2, request_id=41)
        with db.transaction():
            ded.note_awaiting(10, 2, 41)
        entry = RequestDedupeState.lookup_committed(db, 2, 41)
        assert entry == {"c": 10}
        with db.transaction():
            ded.note_reply(10, reply)
        entry = RequestDedupeState.lookup_committed(db, 2, 41)
        assert entry["c"] == 10 and "f" in entry
        from zeebe_tpu_torch.protocol import Record

        replayed = Record.from_bytes(entry["f"])
        assert replayed.value == {"processInstanceKey": 7}
        assert replayed.request_id == 41

    def test_age_out_by_position(self):
        from zeebe_tpu_torch.state.request_dedupe import RETENTION_POSITIONS

        db = ZbDb()
        ded = RequestDedupeState(db)
        with db.transaction():
            ded.note_awaiting(5, 0, 100)
            ded.note_awaiting(6, 0, 101)
            ded.age_out(6)
        assert RequestDedupeState.lookup_committed(db, 0, 100) is not None
        with db.transaction():
            far = 6 + RETENTION_POSITIONS + 1
            ded.note_awaiting(far, 0, 102)
            ded.age_out(far)
        assert RequestDedupeState.lookup_committed(db, 0, 100) is None
        assert RequestDedupeState.lookup_committed(db, 0, 101) is None
        assert RequestDedupeState.lookup_committed(db, 0, 102) is not None
        # the position index aged out with the table entries
        with db.transaction() as txn:
            index = db.column_family(
                ColumnFamilyCode.REQUEST_DEDUPE_BY_POSITION)
            assert sum(1 for _ in index.items()) == 1


# ---------------------------------------------------------------------------
# checker (pure)


def _op(i, partition, outcome, rid, position, done_ms=None, **kw):
    return ClientOp(index=i, partition=partition, kind="create",
                    outcome=outcome, request_id=rid, position=position,
                    done_ms=float(i if done_ms is None else done_ms), **kw)


def _cmd(p, rid, sid=0):
    return {"p": p, "rt": 1, "rid": rid, "sid": sid}


def _reply(p, rid, rejected=False):
    return {"p": p, "rt": 3 if rejected else 2, "rid": rid, "sid": 0}


class TestChecker:
    def test_clean_history_passes(self):
        history = [_op(1, 1, "ack", 100, 5), _op(2, 1, "ack", 101, 8)]
        logs = {1: [_cmd(5, 100), _reply(6, 100),
                    _cmd(8, 101), _reply(9, 101)]}
        exports = {1: {5: {}, 6: {}, 8: {}, 9: {}}}
        assert check_consistency(history, logs, exports) == []

    def test_acked_loss_detected(self):
        history = [_op(1, 1, "ack", 100, 5)]
        violations = check_consistency(history, {1: []}, {1: {}})
        assert any("acked loss" in v for v in violations)

    def test_acked_loss_on_export_stream_detected(self):
        history = [_op(1, 1, "ack", 100, 5)]
        violations = check_consistency(
            history, {1: [_cmd(5, 100)]}, {1: {}})
        assert any("export stream" in v for v in violations)

    def test_duplicate_application_detected(self):
        history = [_op(1, 1, "ack", 100, 5)]
        logs = {1: [_cmd(5, 100), _cmd(9, 100)]}
        violations = check_consistency(history, logs, {1: {5: {}, 9: {}}})
        assert any("duplicate application" in v for v in violations)

    def test_rejection_not_terminal_detected(self):
        logs = {1: [_cmd(5, 100), _reply(6, 100, rejected=True),
                    _reply(7, 100)]}
        violations = check_consistency([], logs, {1: {}})
        assert any("not terminal" in v for v in violations)

    def test_position_regression_detected(self):
        history = [_op(1, 1, "ack", 100, 9, done_ms=1),
                   _op(2, 1, "ack", 101, 5, done_ms=2)]
        logs = {1: [_cmd(9, 100), _cmd(5, 101)]}
        violations = check_consistency(history, logs,
                                       {1: {5: {}, 9: {}}})
        assert any("regressed" in v for v in violations)


# ---------------------------------------------------------------------------
# TCP chaos wrapper (fake inner transport)


class _FakeMessaging:
    def __init__(self, member_id="worker-0"):
        self.member_id = member_id
        self.sent: list[tuple] = []
        self.polled = 0

    def subscribe(self, topic, handler):
        pass

    def unsubscribe(self, topic):
        pass

    def send(self, member_id, topic, payload):
        self.sent.append((member_id, topic, payload))

    def poll(self, max_messages=10_000):
        self.polled += 1
        return 0


class TestChaosTcp:
    def test_spec_roundtrip(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import (
            LinkWindow,
            format_spec,
            parse_spec,
        )

        plan = FaultPlan(seed=7, drop_p=0.1, duplicate_p=0.05,
                         delay_p=0.2, reorder_p=0.01, max_delay_ticks=4)
        windows = [LinkWindow("a", "b", 1000, 2000),
                   LinkWindow("c", "*", 5000, 9000)]
        spec = format_spec(plan, windows, tick_ms=25)
        plan2, windows2, tick_ms = parse_spec(spec)
        assert (plan2.seed, plan2.drop_p, plan2.duplicate_p, plan2.delay_p,
                plan2.reorder_p, plan2.max_delay_ticks) == (
            7, 0.1, 0.05, 0.2, 0.01, 4)
        assert windows2 == windows and tick_ms == 25

    def test_seeded_faults_are_deterministic_per_member(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService

        plan = FaultPlan(seed=3, drop_p=0.2, duplicate_p=0.2, delay_p=0.0,
                         reorder_p=0.0)
        runs = []
        for _ in range(2):
            inner = _FakeMessaging("worker-1")
            chaos = ChaosTcpMessagingService(inner, plan, epoch_ms=0.0)
            for i in range(200):
                chaos.send("peer", "t", i)
            runs.append((len(inner.sent), dict(chaos.counts)))
        assert runs[0] == runs[1]
        assert runs[0][1]["dropped"] > 0 and runs[0][1]["duplicated"] > 0

    def test_link_window_blocks_both_named_members(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import (
            ChaosTcpMessagingService,
            LinkWindow,
        )

        now_ms = time.time() * 1000.0
        inner = _FakeMessaging("worker-0")
        chaos = ChaosTcpMessagingService(
            inner, FaultPlan(seed=0),
            windows=[LinkWindow("worker-0", "worker-1", 0, 60_000)],
            epoch_ms=now_ms)
        chaos.send("worker-1", "t", 1)   # blocked
        chaos.send("worker-2", "t", 2)   # open link
        assert [m for m, _, _ in inner.sent] == ["worker-2"]
        assert chaos.counts["link_blocked"] == 1

    def test_reordered_frame_is_overtaken_by_the_next_one(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService

        inner = _FakeMessaging()
        chaos = ChaosTcpMessagingService(inner, FaultPlan(seed=0))
        chaos.plan.reorder_p = 1.0
        chaos.send("peer", "t", 1)      # held for reorder
        assert not inner.sent
        chaos.plan.reorder_p = 0.0
        chaos.send("peer", "t", 2)      # overtakes, then releases the held
        assert [p for _, _, p in inner.sent] == [2, 1]
        assert chaos.counts["reordered"] == 1

    def test_reordered_frame_on_quiet_link_flushes_eventually(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService

        inner = _FakeMessaging()
        chaos = ChaosTcpMessagingService(inner, FaultPlan(seed=0))
        chaos.plan.reorder_p = 1.0
        chaos._reorder_max_hold_s = 0.02
        chaos.send("peer", "t", 1)
        assert not inner.sent
        time.sleep(0.05)
        chaos.poll()
        assert [p for _, _, p in inner.sent] == [1]

    def test_windows_file_reload_blocks_link(self, tmp_path):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService

        inner = _FakeMessaging("worker-0")
        chaos = ChaosTcpMessagingService(inner, FaultPlan(seed=0),
                                         epoch_ms=time.time() * 1000.0)
        chaos.windows_file = str(tmp_path / "windows.txt")
        chaos.poll()  # controller has not written the file yet
        assert chaos.windows == []
        (tmp_path / "windows.txt").write_text(
            "worker-0|worker-1@0-60000\n", encoding="utf-8")
        chaos._last_windows_check = 0.0  # bypass the reload throttle
        chaos.poll()
        assert len(chaos.windows) == 1
        chaos.send("worker-1", "t", 1)
        assert not inner.sent and chaos.counts["link_blocked"] == 1

    def test_delayed_frames_release_on_poll(self):
        from zeebe_tpu_torch.testing.chaos import FaultPlan
        from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService

        inner = _FakeMessaging()
        chaos = ChaosTcpMessagingService(
            inner, FaultPlan(seed=1, delay_p=1.0, max_delay_ticks=1),
            tick_ms=10)
        chaos.send("peer", "t", 1)
        assert not inner.sent and chaos.counts["delayed"] == 1
        time.sleep(0.05)
        chaos.poll()
        assert [p for _, _, p in inner.sent] == [1]


# ---------------------------------------------------------------------------
# loopback cluster: exactly-once ingress over the real protocol


class _LoopbackCluster:
    def __init__(self, tmp_path, partition_count=1, workers=1,
                 replication=1):
        from zeebe_tpu_torch.broker.broker import BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
        from zeebe_tpu_torch.multiproc.worker import WorkerRuntime

        self.net = LoopbackNetwork()
        names = [f"worker-{i}" for i in range(workers)]
        self.workers = {}
        for name in names:
            cfg = BrokerCfg(node_id=name, partition_count=partition_count,
                            replication_factor=replication,
                            cluster_members=names, kernel_backend=False, device="cpu")
            self.workers[name] = WorkerRuntime(
                name, self.net.join(name), ["gateway-0"], cfg,
                directory=tmp_path / name, status_interval_ms=50)
        self.gateway = MultiProcClusterRuntime(
            "gateway-0", {n: ("loopback", 0) for n in names},
            partition_count=partition_count,
            replication_factor=replication,
            messaging=self.net.join("gateway-0"))
        self.gateway.start()
        self._running = True
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()
        self.gateway.await_leaders(timeout_s=60)

    def _pump(self):
        while self._running:
            moved = sum(w.pump() for w in self.workers.values())
            moved += self.net.deliver_all()
            if not moved:
                time.sleep(0.001)

    def pause(self):
        self._running = False
        self._thread.join(timeout=5)

    def resume(self):
        self._running = True
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def close(self):
        self._running = False
        self._thread.join(timeout=5)
        self.gateway.stop()
        for w in self.workers.values():
            w.close()


def _resend_envelope(cluster, worker_name, partition, record, request_id):
    """Re-deliver a client envelope as the gateway's resend loop would."""
    from zeebe_tpu_torch.multiproc.worker import CLIENT_COMMAND_TOPIC

    rec = record.replace(request_id=request_id,
                         request_stream_id=cluster.gateway._stream_id)
    cluster.gateway.messaging.send(
        worker_name, f"{CLIENT_COMMAND_TOPIC}-{partition}",
        {"record": rec.to_bytes(), "requestId": request_id})


class TestReplicatedDedupe:
    def test_resend_after_memory_loss_replays_stored_reply(self, tmp_path):
        """THE acceptance sequence in-process: answer a request, wipe the
        worker's in-memory dedupe (what a crash destroys), resend the
        envelope — the reply must come back from the replicated table with
        the ORIGINAL command position, and the log must hold exactly one
        command for the request id."""
        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()))
            meta: dict = {}
            created = gw.submit(1, create_cmd(), meta=meta)
            assert created.intent.name == "CREATED"
            worker = cluster.workers["worker-0"]
            worker._inflight_positions.clear()
            worker._recent_replies.clear()

            event = threading.Event()
            gw._pending[meta["requestId"]] = event
            try:
                _resend_envelope(cluster, "worker-0", 1, create_cmd(),
                                 meta["requestId"])
                assert event.wait(10), "no replayed reply"
                response = gw._responses.pop(meta["requestId"])
            finally:
                gw._pending.pop(meta["requestId"], None)
            assert response.get("dedupe") == "replayed"
            assert response["commandPosition"] == meta["commandPosition"]
            assert (response["record"].value["processInstanceKey"]
                    == created.value["processInstanceKey"])
            partition = worker.broker.partitions[1]
            commands = [lr for lr in partition.stream.new_reader(1)
                        if lr.record.is_command
                        and lr.record.request_id == meta["requestId"]]
            assert len(commands) == 1
        finally:
            cluster.close()

    def test_replay_parity_includes_dedupe_family(self, tmp_path):
        from zeebe_tpu_torch.testing.chaos import (
            engine_state_equals,
            replay_state_of,
        )
        import struct

        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()))
            for _ in range(3):
                gw.submit(1, create_cmd())
            # await-result: the reply comes from a LATER step (respond_to),
            # re-keying the awaiting entry onto the completing command
            with_result = command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "p", "version": -1, "variables": {},
                 "awaitResult": True})
            result = gw.submit(1, with_result)
            assert result.value_type.name == "PROCESS_INSTANCE_RESULT"
            # a terminal rejection's reply is in the table too
            rejected = gw.submit(1, create_cmd("missing"))
            assert rejected.is_rejection
            cluster.pause()  # single-writer: replay off the live journal
            partition = cluster.workers["worker-0"].broker.partitions[1]
            replayed = replay_state_of(partition)
            assert engine_state_equals(replayed, partition.db)
            prefix = struct.pack(">H", int(ColumnFamilyCode.REQUEST_DEDUPE))
            entries = [k for k in replayed._data if k.startswith(prefix)]
            assert len(entries) >= 5  # deploy + 3 creates + rejection
            cluster.resume()
        finally:
            cluster.close()

    def test_unprocessed_resend_does_not_double_append(self, tmp_path):
        """Crash window BEFORE processing: command appended, worker memory
        gone, pending map rebuilt from the log — the resend must not append
        again, and the reply still arrives once processing runs."""
        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()))
            cluster.pause()
            worker = cluster.workers["worker-0"]
            partition = worker.broker.partitions[1]
            # deliver ONE create by hand with the pump stopped: appended to
            # raft, never processed (replication factor 1 commits locally)
            request_id = 987654321
            _resend_envelope(cluster, "worker-0", 1, create_cmd(), request_id)
            while cluster.net.deliver_one():
                pass
            partition._materialize_committed()
            appended = [lr for lr in partition.stream.new_reader(1)
                        if lr.record.is_command
                        and lr.record.request_id == request_id]
            assert len(appended) == 1
            # the crash: in-memory maps gone, pending window rebuilt from log
            worker._inflight_positions.clear()
            worker._recent_replies.clear()
            partition._pending_requests.clear()
            partition._rebuild_pending_requests()
            _resend_envelope(cluster, "worker-0", 1, create_cmd(), request_id)
            while cluster.net.deliver_one():
                pass
            partition._materialize_committed()
            appended = [lr for lr in partition.stream.new_reader(1)
                        if lr.record.is_command
                        and lr.record.request_id == request_id]
            assert len(appended) == 1, "resend double-appended"
            # processing answers the original request exactly once
            replies = []
            gw_member = cluster.net.members["gateway-0"]
            from zeebe_tpu_torch.multiproc.worker import GATEWAY_RESPONSE_TOPIC

            original = gw_member.handlers[GATEWAY_RESPONSE_TOPIC]

            def tee(sender, payload):
                if payload.get("requestId") == request_id:
                    replies.append(payload)
                original(sender, payload)

            gw_member.handlers[GATEWAY_RESPONSE_TOPIC] = tee
            cluster.resume()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not replies:
                time.sleep(0.02)
            assert len(replies) == 1
            assert replies[0]["commandPosition"] == appended[0].position
        finally:
            cluster.close()

    def test_leader_mid_recovery_answers_unavailable_not_append(self, tmp_path):
        from zeebe_tpu_torch.stream import Phase

        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()))
            cluster.pause()
            worker = cluster.workers["worker-0"]
            partition = worker.broker.partitions[1]
            partition.processor.phase = Phase.REPLAY  # simulated barrier
            end_before = partition.stream.last_position
            errors = []
            gw_member = cluster.net.members["gateway-0"]
            from zeebe_tpu_torch.multiproc.worker import GATEWAY_RESPONSE_TOPIC

            gw_member.handlers[GATEWAY_RESPONSE_TOPIC] = (
                lambda s, p: errors.append(p))
            _resend_envelope(cluster, "worker-0", 1, create_cmd(), 555)
            while cluster.net.deliver_one():
                pass
            assert errors and errors[0]["error"]["type"] == "unavailable"
            partition._materialize_committed()
            assert partition.stream.last_position == end_before
            partition.processor.phase = Phase.PROCESSING
        finally:
            cluster.close()


class TestNotLeaderReroute:
    def test_stale_route_produces_one_not_leader_one_reroute_one_append(
            self, tmp_path):
        """Satellite: a request routed from a stale table gets exactly one
        typed not-leader frame from the non-leader, one re-route, and (with
        replicated dedupe) exactly one appended command."""
        cluster = _LoopbackCluster(tmp_path, workers=2, replication=2)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()), timeout_s=30)
            leader_name = gw._leader_of(1)
            follower = [n for n in cluster.workers if n != leader_name][0]
            # poison the routing table: only the FOLLOWER claims leadership
            fake = dict(gw._worker_status[leader_name])
            fake["partitions"] = {"1": {"role": "leader"}}
            gw._worker_status = {follower: fake}
            gw._status_seen_ms = {follower: time.time() * 1000.0}
            not_leader_frames = []
            follower_partition = cluster.workers[follower].broker.partitions[1]
            original_reply = cluster.workers[follower]._reply_error

            def counting_reply(gateway, request_id, kind, message):
                if kind == "not-leader":
                    not_leader_frames.append(request_id)
                original_reply(gateway, request_id, kind, message)

            cluster.workers[follower]._reply_error = counting_reply
            meta: dict = {}
            created = gw.submit(1, create_cmd(), timeout_s=30, meta=meta)
            assert created.value["processInstanceKey"] > 0
            assert not_leader_frames.count(meta["requestId"]) == 1
            assert meta["reroutes"] == 1
            assert not follower_partition.is_leader
            leader_partition = (
                cluster.workers[leader_name].broker.partitions[1])
            commands = [lr for lr in leader_partition.stream.new_reader(1)
                        if lr.record.is_command
                        and lr.record.request_id == meta["requestId"]]
            assert len(commands) == 1
        finally:
            cluster.close()


class TestGatewayDeadline:
    def test_dead_partition_surfaces_deadline_exceeded(self, tmp_path,
                                                       monkeypatch):
        """Satellite: the overall per-request deadline bounds the resend
        loop with a typed DEADLINE_EXCEEDED and counts it."""
        from zeebe_tpu_torch.gateway.broker_client import DeadlineExceededError
        from zeebe_tpu_torch.multiproc.runtime import _M_REQUEST_TIMEOUTS
        from zeebe_tpu_torch.multiproc.worker import CLIENT_COMMAND_TOPIC

        cluster = _LoopbackCluster(tmp_path)
        try:
            gw = cluster.gateway
            gw.submit(1, deploy_cmd(simple()))
            # the worker stops answering ingress entirely (dead partition)
            cluster.workers["worker-0"].messaging.unsubscribe(
                f"{CLIENT_COMMAND_TOPIC}-1")
            monkeypatch.setenv("ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS", "1200")
            before = _M_REQUEST_TIMEOUTS.labels("1").value
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceededError):
                gw.submit(1, create_cmd(), timeout_s=60)
            assert time.monotonic() - t0 < 10
            assert _M_REQUEST_TIMEOUTS.labels("1").value == before + 1
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# tiering write-error degradation (satellite)


class TestTieringDegradation:
    def _parked_db(self, tmp_path):
        from zeebe_tpu_torch.state import TieredZbDb
        from zeebe_tpu_torch.state.db import encode_key

        db = TieredZbDb(tmp_path / "cold", partition_id=1)
        with db.transaction() as txn:
            for key in (100, 200):
                txn.put(encode_key(ColumnFamilyCode.ELEMENT_INSTANCE_KEY,
                                   (key,)),
                        {"processInstanceKey": key, "jobKey": -1})
        return db

    def test_failing_writes_dir_degrades_without_poisoning_pump(
            self, tmp_path):
        from zeebe_tpu_torch.state import TieringCfg, TieringManager

        db = self._parked_db(tmp_path)
        clock = [0]
        manager = TieringManager(db, lambda: clock[0],
                                 TieringCfg(enabled=True, park_after_ms=10,
                                            spill_batch=8,
                                            check_interval_ms=0),
                                 partition_id=1)
        # one instance spills while the dir is healthy: its cold read must
        # keep serving after degradation
        manager.note_parked(100)
        clock[0] = 100
        assert manager.maybe_run() == 1
        assert manager.spilled_instances == 1
        # injected failing-writes dir: every further cold write hits ENOSPC
        # (chmod-style injection is a no-op under root, so the failure is
        # injected at the store's write seam instead)
        def enospc_append(key, packed, tag=-1):
            raise OSError(errno.ENOSPC, "No space left on device (injected)")

        db.cold.append = enospc_append
        try:
            manager.note_parked(200)
            clock[0] = 200
            spilled = manager.maybe_run()
            assert spilled == 0  # OSError contained
            assert manager.degraded
            assert "ENOSPC" in manager.degraded_reason \
                or "No space" in manager.degraded_reason
            # degraded latches: later passes are no-ops, never raise
            manager.note_parked(200)
            clock[0] = 300
            assert manager.maybe_run() == 0
            # cold value spilled before the failure is still servable
            value = db.committed_get(ColumnFamilyCode.ELEMENT_INSTANCE_KEY,
                                     (100,))
            assert value["processInstanceKey"] == 100
        finally:
            db.close()

    def test_degraded_tiering_flags_partition_health(self, tmp_path):
        from zeebe_tpu_torch.broker import InProcessCluster

        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path, tiering=True, tiering_park_after_ms=10,
            tiering_spill_batch=8, device="cpu")
        try:
            leader = None
            for _ in range(40):
                cluster.run(500)
                leader = cluster.leader(1)
                if leader is not None:
                    break
            assert leader is not None
            health = leader.health()
            assert health["stateTiering"]["status"] == "HEALTHY"
            leader.tiering.degraded = True
            leader.tiering.degraded_reason = \
                f"OSError: [Errno {errno.ENOSPC}] injected"
            health = leader.health()
            assert health["stateTiering"]["status"] == "DEGRADED"
            assert "injected" in health["stateTiering"]["degradedReason"]
        finally:
            cluster.close()


class TestKernelPathDedupe:
    def test_burst_path_dedupe_replay_parity(self, tmp_path):
        """The kernel/burst fast path notes the same dedupe entries replay
        derives from the patched frames: drive request-stamped creates
        through a kernel-enabled broker until burst templates engage, then
        assert replay≡live over the dedupe family too."""
        from zeebe_tpu_torch.broker import InProcessCluster
        from zeebe_tpu_torch.testing.chaos import (
            engine_state_equals,
            replay_state_of,
        )
        from zeebe_tpu_torch.utils.metrics import REGISTRY
        import struct

        cluster = InProcessCluster(broker_count=1, partition_count=1,
                                   replication_factor=1, directory=tmp_path, device="cpu")
        try:
            leader = None
            for _ in range(40):
                cluster.run(500)
                leader = cluster.leader(1)
                if leader is not None:
                    break
            assert leader is not None
            assert leader.processor.kernel_backend is not None
            batched = REGISTRY.counter(
                "stream_processor_records_total",
                "records handled by the stream processor",
                ("partition", "action")).labels("1", "kernel_batched")
            batched_before = batched.value
            cluster.write_command(1, deploy_cmd(simple()))
            cluster.run(1000)
            rid_base = 5_000_000
            for i in range(48):
                cluster.write_command(
                    1, create_cmd().replace(request_id=rid_base + i,
                                            request_stream_id=0))
            for _ in range(20):
                cluster.run(500)
                if (leader.processor.last_processed_position
                        >= leader.stream.last_position - 1):
                    break
            assert batched.value > batched_before, \
                "kernel path never engaged — burst dedupe untested"
            replayed = replay_state_of(leader)
            assert engine_state_equals(replayed, leader.db)
            prefix = struct.pack(">H", int(ColumnFamilyCode.REQUEST_DEDUPE))
            entries = [k for k in replayed._data if k.startswith(prefix)]
            assert len(entries) >= 48
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# full harness over real worker processes (slow)


@pytest.mark.slow
class TestRealClusterConsistency:
    def test_two_worker_kill_run_is_exactly_once(self, tmp_path):
        """Satellite (slow leg): a worker kill mid-request against real
        processes — the checker proves no acked loss, no duplicate
        application, and at least one request survived through a
        resend/re-route + the dedupe-replay probe."""
        from zeebe_tpu_torch.testing.consistency import (
            ConsistencyConfig,
            run_consistency,
        )

        cfg = ConsistencyConfig(
            seed=11, workers=2, partitions=1, replication=2,
            drive_seconds=10.0, kills=1, link_windows=0,
            drop_p=0.0, duplicate_p=0.02, delay_p=0.02, reorder_p=0.0,
            crash_after_appends=2, reject_every=10, device="cpu")
        report = run_consistency(cfg, tmp_path)
        assert report["violations"] == [], report["violations"]
        assert report["ackedCommands"] > 0
        assert report["kills"] == 1
        assert report["crashBetweenAppendAndReplyFired"]
        assert report["crashSequencesVerified"] >= 1
        assert report["dedupeProbe"]["verified"], report["dedupeProbe"]
