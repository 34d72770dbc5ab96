# tests/test_recovery.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Recovery under a budget: incremental snapshot chains,
torn-snapshot fallback, compaction-safe durability, recovery metrics +
budget alert, the offline ``cli snapshots`` inspector, and a short
slow-marked crash-recovery soak gate."""

from __future__ import annotations

import json

import pytest

from zeebe_tpu_torch.broker import InProcessCluster
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.state import ColumnFamilyCode, FileBasedSnapshotStore, ZbDb
from zeebe_tpu_torch.state.snapshot import (
    DELTA_FILE,
    STATE_FILE,
    inspect_store,
    load_chain_db,
)
from zeebe_tpu_torch.utils.metrics import REGISTRY


def _metric_total(name: str, **labels) -> float:
    """Sum of a family's child values, filtered by label fragments (process-
    global registry: callers compare deltas, not absolutes)."""
    total = 0.0
    for fam, kind, label_str, value in REGISTRY.snapshot():
        if fam != f"zeebe_{name}" or kind == "histogram":
            continue
        if all(f'{k}="{v}"' in label_str for k, v in labels.items()):
            total += value
    return total


def _histogram_count(name: str) -> int:
    count = 0
    for fam, kind, _label_str, value in REGISTRY.snapshot():
        if fam == f"zeebe_{name}" and kind == "histogram":
            count += value[0]
    return count


# ---------------------------------------------------------------------------
# Delta serialization (db layer)


class TestDeltaSerialization:
    def test_roundtrip_including_deletes(self):
        db = ZbDb()
        cf = db.column_family(ColumnFamilyCode.JOBS)
        with db.transaction():
            for i in range(10):
                cf.put((i,), {"n": i})
        db.begin_delta_tracking()
        with db.transaction():
            cf.put((3,), {"n": "updated"})
            cf.put((100,), {"n": "new"})
            cf.delete((7,))
        delta = db.to_delta_bytes()
        # replica: base state without the tracked writes
        replica = ZbDb()
        rcf = replica.column_family(ColumnFamilyCode.JOBS)
        with replica.transaction():
            for i in range(10):
                rcf.put((i,), {"n": i})
        replica.apply_delta_bytes(delta)
        with replica.transaction():
            assert rcf.get((3,)) == {"n": "updated"}
            assert rcf.get((100,)) == {"n": "new"}
            assert rcf.get((7,)) is None
            assert rcf.get((4,)) == {"n": 4}

    def test_durable_db_opts_out_of_delta_snapshots(self):
        """DurableZbDb._data holds _Packed/memoryview cold values a delta
        cannot serialize — the partition's delta path must gate on the
        opt-in flag, not hasattr (DurableZbDb inherits the methods)."""
        from zeebe_tpu_torch.state.durable import DurableZbDb

        assert ZbDb.supports_delta_snapshots is True
        assert DurableZbDb.supports_delta_snapshots is False

    def test_delta_requires_tracking(self):
        db = ZbDb()
        with pytest.raises(RuntimeError, match="tracking"):
            db.to_delta_bytes()

    def test_corrupt_delta_rejected(self):
        db = ZbDb()
        db.begin_delta_tracking()
        cf = db.column_family(ColumnFamilyCode.JOBS)
        with db.transaction():
            cf.put((1,), "v")
        delta = db.to_delta_bytes()
        with pytest.raises(ValueError, match="magic"):
            ZbDb().apply_delta_bytes(b"XXXX" + delta[4:])
        torn = delta[: len(delta) - 2]
        with pytest.raises(ValueError, match="checksum"):
            ZbDb().apply_delta_bytes(torn)

    def test_dirty_window_survives_serialization_until_cleared(self):
        """An aborted persist must not lose changes: to_delta_bytes leaves
        the tracked set intact; only clear_delta_tracking resets it."""
        db = ZbDb()
        db.begin_delta_tracking()
        cf = db.column_family(ColumnFamilyCode.JOBS)
        with db.transaction():
            cf.put((1,), "v")
        assert db.dirty_key_count == 1
        db.to_delta_bytes()
        assert db.dirty_key_count == 1
        db.clear_delta_tracking()
        assert db.dirty_key_count == 0


# ---------------------------------------------------------------------------
# Snapshot chains (store layer)


def _full_snapshot(store, db, index, processed):
    t = store.new_transient_snapshot(index, 1, processed, processed)
    t.write_file(STATE_FILE, db.to_snapshot_bytes())
    t.write_file("meta.bin", b"\x80")
    return t.persist()


def _delta_snapshot(store, db, parent, depth, index, processed):
    t = store.new_transient_snapshot(index, 1, processed, processed)
    t.write_file(DELTA_FILE, db.to_delta_bytes())
    t.link_parent(parent, depth)
    t.write_file("meta.bin", b"\x80")
    db.clear_delta_tracking()
    return t.persist()


@pytest.fixture
def chain_store(tmp_path):
    """A store holding base(full) ← delta ← delta, with the db evolved a
    step per snapshot."""
    store = FileBasedSnapshotStore(tmp_path / "snapshots")
    db = ZbDb()
    cf = db.column_family(ColumnFamilyCode.JOBS)
    with db.transaction():
        cf.put((1,), "base")
    base = _full_snapshot(store, db, 10, 100)
    db.begin_delta_tracking()
    with db.transaction():
        cf.put((2,), "d1")
    d1 = _delta_snapshot(store, db, base, 2, 20, 200)
    with db.transaction():
        cf.put((3,), "d2")
        cf.delete((1,))
    d2 = _delta_snapshot(store, db, d1, 3, 30, 300)
    return store, db, (base, d1, d2)


class TestSnapshotChains:
    def test_chain_resolves_base_to_tip_and_loads(self, chain_store):
        store, db, (base, d1, d2) = chain_store
        chain = store.latest_valid_chain()
        assert [s.id for s in chain] == [base.id, d1.id, d2.id]
        loaded = load_chain_db(chain)
        assert loaded.content_equals(db)

    def test_purge_keeps_chain_ancestors(self, chain_store):
        """Persisting a delta tip purges older *chains*, never the live
        chain's own base/intermediates."""
        store, _db, (base, d1, d2) = chain_store
        ids = {s.id for s in store.list_snapshots()}
        assert {base.id, d1.id, d2.id} <= ids

    def test_torn_tip_falls_back_to_valid_ancestor(self, chain_store):
        store, _db, (base, d1, d2) = chain_store
        blob = (d2.path / DELTA_FILE).read_bytes()
        (d2.path / DELTA_FILE).write_bytes(blob[: len(blob) // 2])
        chain = store.latest_valid_chain()
        assert [s.id for s in chain] == [base.id, d1.id]
        loaded = load_chain_db(chain)
        cf = loaded.column_family(ColumnFamilyCode.JOBS)
        with loaded.transaction():
            assert cf.get((2,)) == "d1"
            assert cf.get((3,)) is None

    def test_missing_base_invalidates_descendants(self, chain_store):
        import shutil

        store, _db, (base, d1, d2) = chain_store
        shutil.rmtree(base.path)
        assert store.latest_valid_chain() is None

    def test_malformed_manifest_reads_invalid_not_crash(self, chain_store):
        store, _db, (_base, _d1, d2) = chain_store
        (d2.path / "CHECKSUM.sfv").write_text("not\tan-integer\ngarbage")
        assert store.chain_of(d2) is None

    def test_reopen_drops_torn_snapshot_and_pending_leftovers(self, tmp_path,
                                                              chain_store):
        """Power loss during commit: the half-written pending dir and the
        torn persisted tip are both cleaned on the next open; recovery sees
        the valid ancestor chain (satellite: torn-snapshot handling)."""
        store, _db, (base, d1, d2) = chain_store
        blob = (d2.path / DELTA_FILE).read_bytes()
        (d2.path / DELTA_FILE).write_bytes(blob[: len(blob) // 2])
        pending = store.pending_dir / "999-1-999-999"
        pending.mkdir()
        (pending / STATE_FILE).write_bytes(b"partial")
        reopened = FileBasedSnapshotStore(store.root)
        assert not pending.exists()
        chain = reopened.latest_valid_chain()
        assert [s.id for s in chain] == [base.id, d1.id]

    def test_inspect_store_reports_chain_validity(self, chain_store):
        store, _db, (base, d1, d2) = chain_store
        blob = (d2.path / DELTA_FILE).read_bytes()
        (d2.path / DELTA_FILE).write_bytes(blob[: len(blob) // 2])
        rows = {r["id"]: r for r in inspect_store(store.root)}
        assert rows[str(base.id)]["kind"] == "full"
        assert rows[str(d1.id)]["kind"] == "delta"
        assert rows[str(d1.id)]["chainValid"] is True
        assert rows[str(d1.id)]["parent"] == str(base.id)
        assert rows[str(d2.id)]["valid"] is False
        assert rows[str(d2.id)]["chainValid"] is False


# ---------------------------------------------------------------------------
# Compaction safety (journal + partition)


class TestJournalCompactGuard:
    def _journal(self, tmp_path, n=60):
        from zeebe_tpu_torch.journal import SegmentedJournal

        journal = SegmentedJournal(tmp_path / "j", max_segment_size=256)
        for i in range(1, n + 1):
            journal.append(b"x" * 64, asqn=i)
        journal.flush()
        assert len(journal.segments) > 3
        return journal

    def test_guard_clamps_overreaching_compaction(self, tmp_path):
        journal = self._journal(tmp_path)
        journal.compact_guard = lambda: 10
        before = _metric_total("journal_compaction_clamped_total")
        journal.compact(50)
        assert journal.first_index <= 10
        assert _metric_total("journal_compaction_clamped_total") == before + 1
        # reads below the clamp still serve
        assert journal.seek_to_asqn(12) >= journal.first_index
        journal.close()

    def test_broken_guard_fails_safe(self, tmp_path):
        def boom():
            raise RuntimeError("guard source unavailable")

        journal = self._journal(tmp_path)
        journal.compact_guard = boom
        journal.compact(50)
        assert journal.first_index == 1  # nothing deleted unguarded
        journal.close()

    def test_unguarded_journal_compacts_normally(self, tmp_path):
        journal = self._journal(tmp_path)
        journal.compact(50)
        assert journal.first_index > 1
        journal.close()


class StallingExporter:
    """Never acknowledges: the cursor pins compaction DEGRADED/backoff
    behavior under a permanently-failing sink)."""

    stalled = True

    def configure(self, context):
        self.context = context

    def open(self, controller):
        self.controller = controller

    def export(self, record):
        if StallingExporter.stalled:
            raise RuntimeError("sink down")
        self.controller.update_last_exported_position(record.position)

    def close(self):
        pass


def _one_task_model():
    return (
        Bpmn.create_executable_process("rec")
        .start_event("s").end_event("e").done()
    )


def _deploy(cluster):
    cluster.write_command(1, command(
        ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
        {"resources": [{"resourceName": "rec.bpmn",
                        "resource": to_bpmn_xml(_one_task_model())}]}))
    cluster.run(300)


def _load(cluster, n):
    create = command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": "rec", "version": -1, "variables": {}})
    leader = cluster.leader(1)
    for _ in range(n // 5):
        leader.write_commands([create] * 5)
        cluster.run(100)


class TestCompactionGatedOnExporters:
    def test_degraded_exporter_blocks_segment_deletion(self, tmp_path):
        """Satellite: segment deletion never passes an exporter container
        cursor — a stalled (DEGRADED, backing-off) exporter pins BOTH
        journals even when a snapshot would allow compaction, with the
        ``exporter_container_lag_records`` gauge as the observable; once the
        exporter recovers and drains, the same snapshot path compacts."""
        StallingExporter.stalled = True
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c",
            exporters_factory=lambda: {"stall": StallingExporter()}, device="cpu")
        try:
            cluster.await_leaders()
            leader = cluster.leader(1)
            # shrink segments so compaction has something deletable
            leader.stream_journal.max_segment_size = 512
            leader.raft.journal.max_segment_size = 512
            _deploy(cluster)
            _load(cluster, 60)
            assert len(leader.stream_journal.segments) > 2
            assert leader.take_snapshot(force_full=True)
            # min(snapshot, exporter cursor) pins everything: no deletion
            assert leader.stream_journal.first_index == 1
            assert _metric_total("exporter_container_lag_records",
                                 exporter="stall") > 0
            # a buggy/raced caller bypassing the snapshot bound is clamped
            # by the guard INSIDE the journal
            before = _metric_total("journal_compaction_clamped_total")
            leader.stream_journal.compact(10**6)
            assert leader.stream_journal.first_index == 1
            assert _metric_total(
                "journal_compaction_clamped_total") == before + 1
            # exporter recovers → cursor advances → compaction proceeds
            StallingExporter.stalled = False
            cluster.run(4000)
            _load(cluster, 10)
            cluster.run(1000)
            assert leader.take_snapshot(force_full=True)
            assert leader.stream_journal.first_index > 1
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# Recovery accounting: metrics, /health, flight dump, budget alert


class TestRecoveryAccounting:
    def _cluster(self, tmp_path, **kw):
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", **kw, device="cpu")
        cluster.await_leaders()
        return cluster

    def test_killed_broker_restart_records_recovery(self, tmp_path):
        """Satellite: after a kill+restart the partition carries a recovery
        record (duration, replay count, budget verdict), the metrics plane
        has the series, /health serves it, and a flight dump explains it."""
        cluster = self._cluster(tmp_path, snapshot_period_ms=10**9)
        try:
            _deploy(cluster)
            _load(cluster, 40)
            durations_before = _histogram_count("recovery_duration_seconds")
            replayed_before = _metric_total("recovery_replay_records_total",
                                            partition="1")
            cluster.hard_crash_broker("broker-0")
            cluster.restart_broker("broker-0")
            cluster.await_leaders()
            leader = cluster.leader(1)
            rec = leader.last_recovery
            assert rec is not None
            assert rec["role"] == "leader"
            assert rec["durationMs"] > 0
            # no snapshot was taken: the whole log replays
            assert rec["replayRecords"] > 0
            assert rec["withinBudget"] is True
            assert _histogram_count(
                "recovery_duration_seconds") > durations_before
            assert _metric_total(
                "recovery_replay_records_total",
                partition="1") >= replayed_before + rec["replayRecords"]
            # /health carries the record
            from zeebe_tpu_torch.broker.management import ManagementServer

            server = ManagementServer(cluster.brokers["broker-0"])
            server.start()
            try:
                import urllib.request

                with urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/health",
                        timeout=5) as resp:
                    health = json.loads(resp.read().decode())
            finally:
                server.stop()
            probe = health["recoveries"]["1"]
            assert probe["replayRecords"] == rec["replayRecords"]
            assert probe["durationMs"] == rec["durationMs"]
            # the leader recovery force-dumped a flight artifact whose ring
            # carries the recovery event
            dumps = sorted(
                (tmp_path / "c" / "broker-0").glob("flight-*.json"))
            assert dumps, "recovery left no flight dump"
            events = [
                ev
                for path in dumps
                for ring in json.loads(path.read_text())
                ["partitions"].values()
                for ev in ring if ev.get("kind") == "recovery"
            ]
            assert events, "no flight dump carries the recovery event"
            assert events[-1]["replayRecords"] == rec["replayRecords"]
        finally:
            cluster.close()

    def test_blown_budget_counts_and_fires_default_alert(self, tmp_path):
        """recovery_budget_ms=1 makes any real recovery a budget violation:
        the exceeded counter increments and the DEFAULT rule set's
        ``recovery_budget_exceeded`` alert fires off the stored series."""
        cluster = self._cluster(tmp_path, recovery_budget_ms=1)
        try:
            _deploy(cluster)
            _load(cluster, 20)
            exceeded_before = _metric_total("recovery_budget_exceeded_total",
                                            partition="1")
            cluster.hard_crash_broker("broker-0")
            cluster.restart_broker("broker-0")
            cluster.await_leaders()
            leader = cluster.leader(1)
            assert leader.last_recovery["withinBudget"] is False
            # a restart may rebuild more than once (follower boot, then the
            # leader transition) — each one legitimately blows a 1ms budget
            assert _metric_total("recovery_budget_exceeded_total",
                                 partition="1") >= exceeded_before + 1
            # let the restarted broker's sampler store the spike and the
            # evaluator pass its for-duration
            cluster.run(8000)
            broker = cluster.brokers["broker-0"]
            firing = broker.alerts.firing()
            assert any(a["rule"] == "recovery_budget_exceeded"
                       for a in firing), broker.alerts.snapshot()
        finally:
            cluster.close()

    def test_budget_disabled_never_exceeds(self, tmp_path):
        cluster = self._cluster(tmp_path, recovery_budget_ms=0)
        try:
            _deploy(cluster)
            cluster.hard_crash_broker("broker-0")
            cluster.restart_broker("broker-0")
            cluster.await_leaders()
            assert cluster.leader(1).last_recovery["withinBudget"] is True
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# Incremental snapshots + adaptive cadence through the partition


def _parked_model():
    """Instances park on a message wait: state ACCUMULATES across snapshot
    periods, which is the regime where deltas beat full snapshots (short-
    lived instances delete their keys, making dirty ≥ key_count and every
    snapshot a rebase — correct, but not what this test exercises)."""
    return (
        Bpmn.create_executable_process("park")
        .start_event("s")
        .intermediate_catch_message("wait", message_name="park-msg",
                                    correlation_key="=ck")
        .end_event("e").done()
    )


def _park_instances(cluster, n, tag):
    create = [command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": "park", "version": -1,
         "variables": {"ck": f"{tag}-{i}"}}) for i in range(n)]
    leader = cluster.leader(1)
    for cmd in create:
        leader.write_commands([cmd])
        cluster.run(50)


class TestPartitionIncrementalSnapshots:
    def test_delta_chain_grows_rebases_and_recovers(self, tmp_path):
        """Snapshots after the first are deltas until the chain-length cap
        forces a full rebase; a crash-restart installs base+deltas and the
        recovery record names the chain."""
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=1000,
            snapshot_chain_length=3, device="cpu")
        try:
            cluster.await_leaders()
            leader = cluster.leader(1)
            cluster.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "park.bpmn",
                                "resource": to_bpmn_xml(_parked_model())}]}))
            cluster.run(300)
            kinds = []
            for i in range(5):
                _park_instances(cluster, 6, f"round{i}")
                cluster.run(1100)  # cross the period boundary
                chain = leader.snapshot_store.latest_valid_chain()
                assert chain is not None
                kinds.append(
                    "delta" if chain[-1].is_delta else "full")
            assert kinds[0] == "full"
            assert "delta" in kinds, kinds
            # cap = 3: a rebase must have happened among 5 snapshots
            assert kinds.count("full") >= 2, kinds
            _park_instances(cluster, 6, "final")
            cluster.run(1100)
            chain_len_before_crash = len(
                leader.snapshot_store.latest_valid_chain())
            cluster.hard_crash_broker("broker-0")
            cluster.restart_broker("broker-0")
            cluster.await_leaders()
            leader = cluster.leader(1)
            rec = leader.last_recovery
            assert rec["snapshotId"] is not None
            assert rec["chainLength"] == chain_len_before_crash
            # replay is bounded by the debt past the snapshot, not the log
            assert rec["replayRecords"] <= rec["snapshotAgeRecords"] + 8
        finally:
            cluster.close()

    def test_adaptive_scheduler_snapshots_before_debt_blows_budget(
            self, tmp_path):
        """With a tiny budget and an effectively-infinite period, the
        replay-debt projection alone must trigger a snapshot."""
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=10**9,
            recovery_budget_ms=10, device="cpu")
        try:
            cluster.await_leaders()
            leader = cluster.leader(1)
            adaptive_before = _metric_total("snapshot_adaptive_triggers_total",
                                            partition="1")
            _deploy(cluster)
            # debt > budget_ms/1000*rate*fraction = 10/1000*10000*0.5 = 50
            _load(cluster, 80)
            cluster.run(2500)  # past the 1s debt-check throttle
            assert _metric_total(
                "snapshot_adaptive_triggers_total",
                partition="1") > adaptive_before
            assert leader.snapshot_store.latest_valid_chain() is not None
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# Torn snapshot during commit, end to end (satellite 1 at partition level)


class TestTornSnapshotRecovery:
    def test_recovery_skips_torn_tip_and_survives(self, tmp_path):
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=1000,
            snapshot_chain_length=4, device="cpu")
        try:
            cluster.await_leaders()
            leader = cluster.leader(1)
            cluster.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "park.bpmn",
                                "resource": to_bpmn_xml(_parked_model())}]}))
            cluster.run(300)
            for i in range(3):
                _park_instances(cluster, 6, f"torn{i}")
                cluster.run(1100)
            chain = leader.snapshot_store.latest_valid_chain()
            assert len(chain) >= 2
            expected_anchor = chain[-2].id  # tip's parent survives the tear
            acked_position = leader.stream.last_position
            cluster.hard_crash_broker("broker-0")
            # power loss during commit: torn tip + half-written pending dir
            tip = chain[-1]
            victim = tip.path / (DELTA_FILE if tip.is_delta else STATE_FILE)
            blob = victim.read_bytes()
            victim.write_bytes(blob[: len(blob) // 2])
            store_root = tip.path.parent.parent
            pending = store_root / "pending" / "999999-1-999999-999999"
            pending.mkdir(parents=True)
            (pending / STATE_FILE).write_bytes(b"partial")
            cluster.restart_broker("broker-0")
            cluster.await_leaders()
            leader = cluster.leader(1)
            rec = leader.last_recovery
            assert rec is not None, "recovery crashed on the torn snapshot"
            assert rec["snapshotId"] == str(expected_anchor)
            # the fsynced committed prefix fully replays past the old ack
            cluster.run(1000)
            assert leader.stream.last_position >= acked_position
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# Offline inspector: cli snapshots


class TestCliSnapshots:
    def test_lists_chains_and_replay_debt(self, chain_store, tmp_path,
                                          capsys):
        from zeebe_tpu_torch.cli import main

        store, _db, (base, d1, d2) = chain_store
        rc = main(["snapshots", str(store.root)])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        [part] = report["partitions"]
        assert part["recoveryAnchor"]["id"] == str(d2.id)
        assert part["recoveryAnchor"]["chainLength"] == 3
        kinds = [s["kind"] for s in part["snapshots"]]
        assert kinds == ["full", "delta", "delta"]
        rc = main(["snapshots", str(store.root), "--pretty"])
        out = capsys.readouterr().out
        assert rc == 0
        assert str(d2.id) in out and "recovery anchor" in out

    def test_broker_data_dir_layout_with_journal_debt(self, tmp_path,
                                                      capsys):
        from zeebe_tpu_torch.cli import main

        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=1000, device="cpu")
        try:
            cluster.await_leaders()
            _deploy(cluster)
            _load(cluster, 20)
            cluster.run(1100)
            leader = cluster.leader(1)
            assert leader.snapshot_store.latest_valid_chain() is not None
            _load(cluster, 10)  # debt past the snapshot
            leader.stream_journal.flush()
        finally:
            cluster.close()
        rc = main(["snapshots", str(tmp_path / "c" / "broker-0")])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        [part] = report["partitions"]
        assert part["partition"] == "partition-1"
        assert part["recoveryAnchor"] is not None
        assert part["journalEndPosition"] > 0
        assert part["replayDebtRecords"] > 0
        assert part["projectedReplayMs"] >= 0

    def test_rejects_missing_dir(self, tmp_path, capsys):
        from zeebe_tpu_torch.cli import main

        assert main(["snapshots", str(tmp_path / "nope")]) == 2
        assert main(["snapshots", str(tmp_path)]) == 2


# ---------------------------------------------------------------------------
# The soak gate, short mode (slow-marked: the CI soak job runs the full
# short mode via bench.py --soak --quick)


@pytest.mark.slow
class TestSoakGate:
    def test_short_soak_survives_crashes_with_zero_violations(self, tmp_path):
        from zeebe_tpu_torch.testing.soak import SoakConfig, run_soak

        report = run_soak(
            SoakConfig(rounds=3, traffic_per_round=12),
            directory=tmp_path / "soak", device="cpu")
        assert report["violations"] == []
        assert report["restarts"] == 3
        assert report["withinBudget"] is True
        assert report["ackedCommands"] > 0
        assert report["flightDumps"]
        # the cadence actually exercised the incremental path
        assert report["maxChainLength"] >= 1
