# tests/test_durable_state.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Disk-backed state store: O(delta) checkpoints, hot/cold residency,
crash recovery, compaction (VERDICT r4 item 2).

Reference anchors: zb-db RocksDB transactional store (ZeebeTransaction.java:22)
and LargeStateControllerPerformanceTest.java:69-78 (snapshot+recover ops/s on
large state). The large-state floor itself lives in test_bench_floor.py; this
file covers the mechanics.
"""

from __future__ import annotations

import os
import time

import pytest

from zeebe_tpu_torch.state import ColumnFamilyCode, DurableZbDb, ZbDb
from zeebe_tpu_torch.state.durable import _Packed


CF = ColumnFamilyCode.VARIABLES


def put_n(db, n, start=0, size=100):
    payload = "x" * size
    with db.transaction():
        cf = db.column_family(CF)
        for i in range(start, start + n):
            cf.put((i,), {"seq": i, "payload": payload})


class TestDurableBasics:
    def test_transactional_interface_matches_zbdb(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 50)
        with db.transaction():
            cf = db.column_family(CF)
            assert cf.get((7,))["seq"] == 7
            assert cf.get((99,)) is None
            vals = list(cf.values())
            assert len(vals) == 50
            cf.delete((7,))
            assert cf.get((7,)) is None
        with db.transaction():
            assert db.column_family(CF).get((7,)) is None
        db.close()

    def test_rollback_discards(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 5)
        try:
            with db.transaction():
                db.column_family(CF).put((0,), {"seq": -1})
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        with db.transaction():
            assert db.column_family(CF).get((0,))["seq"] == 0
        db.close()

    def test_checkpoint_recover_round_trip(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 200)
        db.checkpoint()
        put_n(db, 100, start=200)
        with db.transaction():
            db.column_family(CF).delete((5,))
        db.checkpoint()
        db.close()

        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            cf = rec.column_family(CF)
            assert cf.get((5,)) is None
            assert cf.get((250,))["seq"] == 250
            assert sum(1 for _ in cf.values()) == 299
        rec.close()

    def test_uncheckpointed_tail_not_recovered(self, tmp_path):
        """Writes after the last checkpoint are NOT durable — by design (the
        replicated log is the durability source; recovery replays the log
        suffix from the checkpointed position)."""
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 10)
        db.checkpoint()
        put_n(db, 10, start=10)  # no checkpoint
        db.close()
        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            assert sum(1 for _ in rec.column_family(CF).values()) == 10
        rec.close()

    def test_checkpoint_cost_is_o_delta(self, tmp_path):
        """After a big base, checkpointing a tiny delta must not rescale
        with total state size (the in-memory store's O(total) failure)."""
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 20_000, size=200)  # ~5 MB state
        db.checkpoint()
        deltas = []
        for r in range(5):
            put_n(db, 10, start=30_000 + r * 10)
            t0 = time.perf_counter()
            db.checkpoint()
            deltas.append(time.perf_counter() - t0)
        # tiny-delta checkpoints are fast in absolute terms (fsync-bound)
        assert min(deltas) < 0.05, deltas
        db.close()


class TestHotColdResidency:
    def test_demotion_packs_cold_values(self, tmp_path):
        db = DurableZbDb(tmp_path / "s", hot_budget_bytes=20_000)
        put_n(db, 500, size=200)  # ~100KB packed >> 20KB budget
        put_n(db, 1, start=1000)  # trigger the deferred demotion sweep
        packed = sum(1 for v in db._data.values() if type(v) is _Packed)
        assert packed > 300, packed
        assert db._hot_bytes <= 20_000
        db.close()

    def test_cold_reads_resolve_and_promote(self, tmp_path):
        db = DurableZbDb(tmp_path / "s", hot_budget_bytes=10_000)
        put_n(db, 300, size=200)
        put_n(db, 1, start=1000)
        with db.transaction():
            cf = db.column_family(CF)
            for i in range(300):
                assert cf.get((i,))["seq"] == i
        db.close()

    def test_committed_get_resolves_without_promoting(self, tmp_path):
        db = DurableZbDb(tmp_path / "s", hot_budget_bytes=1)
        put_n(db, 20)
        put_n(db, 1, start=100)
        cold_before = sum(1 for v in db._data.values() if type(v) is _Packed)
        assert cold_before > 0
        for i in range(20):
            assert db.committed_get(CF, (i,))["seq"] == i
        cold_after = sum(1 for v in db._data.values() if type(v) is _Packed)
        assert cold_after == cold_before  # query path left residency alone
        db.close()

    def test_recovered_values_are_cold(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 100)
        db.checkpoint()
        db.close()
        rec = DurableZbDb.open(tmp_path / "s")
        assert all(type(v) in (_Packed, memoryview)
                   for v in rec._data.values())
        rec.close()


class TestCompaction:
    def test_wal_chain_compacts_into_base(self, tmp_path):
        db = DurableZbDb(tmp_path / "s", min_compact_bytes=10_000)
        for r in range(6):
            put_n(db, 200, start=r * 200, size=100)
            db.checkpoint()
        assert db._base_file is not None  # chain outgrew the threshold
        files = set(os.listdir(tmp_path / "s"))
        assert db._base_file in files
        db.close()
        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            assert sum(1 for _ in rec.column_family(CF).values()) == 1200
        rec.close()

    def test_overwrites_and_deletes_survive_compaction(self, tmp_path):
        db = DurableZbDb(tmp_path / "s", min_compact_bytes=1)
        put_n(db, 50)
        with db.transaction():
            cf = db.column_family(CF)
            cf.put((3,), {"seq": 333})
            cf.delete((4,))
        db.checkpoint()  # compacts (threshold 1)
        db.close()
        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            cf = rec.column_family(CF)
            assert cf.get((3,))["seq"] == 333
            assert cf.get((4,)) is None
        rec.close()


class TestFullSnapshotCompat:
    def test_to_snapshot_bytes_matches_zbdb(self, tmp_path):
        dur = DurableZbDb(tmp_path / "s", hot_budget_bytes=1)
        mem = ZbDb()
        for db in (dur, mem):
            put_n(db, 40)
        put_n(dur, 1, start=100)
        put_n(mem, 1, start=100)
        assert dur.to_snapshot_bytes() == mem.to_snapshot_bytes()
        assert dur.content_equals(mem)
        dur.close()

    def test_install_snapshot_replaces_state(self, tmp_path):
        src = ZbDb()
        put_n(src, 30)
        dur = DurableZbDb(tmp_path / "s")
        put_n(dur, 5, start=900)
        dur.install_snapshot_bytes(src.to_snapshot_bytes())
        with dur.transaction():
            cf = dur.column_family(CF)
            assert cf.get((900,)) is None
            assert sum(1 for _ in cf.values()) == 30
        dur.close()
        rec = DurableZbDb.open(tmp_path / "s")
        assert rec.content_equals(src)
        rec.close()


class TestCrashRecovery:
    def test_torn_wal_tail_truncated(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 20)
        db.checkpoint()
        wal = tmp_path / "s" / db._wal_files[-1]
        db.close()
        with open(wal, "ab") as f:
            f.write(b"\x13\x07torn-garbage")
        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            assert sum(1 for _ in rec.column_family(CF).values()) == 20
        rec.close()

    def test_corrupt_manifest_rejected(self, tmp_path):
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 5)
        db.checkpoint()
        db.close()
        manifest = tmp_path / "s" / "MANIFEST"
        raw = bytearray(manifest.read_bytes())
        raw[-1] ^= 0xFF
        manifest.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="manifest"):
            DurableZbDb.open(tmp_path / "s")


class TestReopenDiscipline:
    def test_uncheckpointed_tail_never_resurfaces_after_rewrites(self, tmp_path):
        """A recovered segment may hold frames past its checkpointed tail
        (reverted commits). Re-deriving them differently after recovery must
        win over the stale disk frames on every subsequent recovery."""
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 10)
        db.checkpoint()
        with db.transaction():
            db.column_family(CF).put((0,), {"seq": "stale-tail"})
        db.close()  # crash: the overwrite was never checkpointed

        db2 = DurableZbDb.open(tmp_path / "s")
        with db2.transaction():
            assert db2.column_family(CF).get((0,))["seq"] == 0  # reverted
            db2.column_family(CF).put((0,), {"seq": "rederived"})
        db2.checkpoint()
        db2.close()

        db3 = DurableZbDb.open(tmp_path / "s")
        with db3.transaction():
            assert db3.column_family(CF).get((0,))["seq"] == "rederived"
        db3.close()


class TestDurablePartition:
    """Broker-level integration: ZEEBE_BROKER_EXPERIMENTAL_DURABLESTATE."""

    def test_cluster_end_to_end_and_restart_recovery(self, tmp_path):
        from zeebe_tpu_torch.broker import InProcessCluster
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.protocol import ValueType, command
        from zeebe_tpu_torch.protocol.intent import (
            DeploymentIntent,
            JobIntent,
            ProcessInstanceCreationIntent,
        )
        from zeebe_tpu_torch.state.durable import DurableZbDb

        model = (
            Bpmn.create_executable_process("p")
            .start_event("s").service_task("t", job_type="w").end_event("e")
            .done()
        )
        c = InProcessCluster(broker_count=1, partition_count=1,
                             replication_factor=1,
                             directory=tmp_path / "cluster",
                             durable_state=True,
                             snapshot_period_ms=500, device="cpu")
        try:
            c.await_leaders()
            c.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "p.bpmn",
                                "resource": to_bpmn_xml(model)}]}))
            for i in range(20):
                c.write_command(1, command(
                    ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "p", "version": -1, "variables": {"i": i}}))
            leader = c.leader(1)
            assert isinstance(leader.db, DurableZbDb)
            with leader.db.transaction():
                jobs = leader.engine.state.jobs.activatable_keys("w", 50)
            assert len(jobs) == 20
            for jk in jobs[:10]:
                c.write_command(1, command(ValueType.JOB, JobIntent.COMPLETE,
                                           {"variables": {}}, key=jk))
            c.run(2_000)  # cross a snapshot period → durable checkpoint
            # the periodic snapshot director checkpointed the durable store
            assert leader.snapshot_store.latest_snapshot() is not None
            assert (leader.directory / "state" / "MANIFEST").exists()
        finally:
            c.close()

        # restart on the same directory: durable recovery + log replay
        c2 = InProcessCluster(broker_count=1, partition_count=1,
                              replication_factor=1,
                              directory=tmp_path / "cluster",
                              durable_state=True, device="cpu")
        try:
            c2.await_leaders()
            leader = c2.leader(1)
            assert isinstance(leader.db, DurableZbDb)
            with leader.db.transaction():
                jobs = leader.engine.state.jobs.activatable_keys("w", 50)
            assert len(jobs) == 10  # the 10 completions survived recovery
        finally:
            c2.close()

    def test_durable_state_matches_in_memory_state(self, tmp_path):
        """Same command sequence through a durable and an in-memory broker:
        identical final state content (the replay≡processing oracle applied
        across backends)."""
        from zeebe_tpu_torch.broker import InProcessCluster
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.protocol import ValueType, command
        from zeebe_tpu_torch.protocol.intent import (
            DeploymentIntent,
            ProcessInstanceCreationIntent,
        )

        model = (
            Bpmn.create_executable_process("q")
            .start_event("s").service_task("t", job_type="w").end_event("e")
            .done()
        )

        def drive(directory, durable):
            c = InProcessCluster(broker_count=1, partition_count=1,
                                 replication_factor=1, directory=directory,
                                 durable_state=durable, device="cpu")
            try:
                c.await_leaders()
                c.write_command(1, command(
                    ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                    {"resources": [{"resourceName": "q.bpmn",
                                    "resource": to_bpmn_xml(model)}]}))
                for i in range(8):
                    c.write_command(1, command(
                        ValueType.PROCESS_INSTANCE_CREATION,
                        ProcessInstanceCreationIntent.CREATE,
                        {"bpmnProcessId": "q", "version": -1,
                         "variables": {"i": i}}))
                leader = c.leader(1)
                snap = {k: leader.db._resolve(v) if hasattr(leader.db, "_resolve")
                        else v for k, v in leader.db._data.items()}
                return snap
            finally:
                c.close()

        durable = drive(tmp_path / "dur", True)
        memory = drive(tmp_path / "mem", False)
        assert durable == memory


class TestStaleWalTruncation:
    def test_crashed_session_tail_never_resurrects(self, tmp_path):
        """A session that crashed before checkpointing its fresh WAL segment
        leaves dead frames in a file a LATER session will reuse by name; the
        new segment must truncate them or a future recovery replays a
        reverted timeline (code-review r5 finding)."""
        db = DurableZbDb(tmp_path / "s")
        put_n(db, 5)
        db.checkpoint()  # manifest lists wal-1
        db.close()

        # session B: appends to wal-2, NEVER checkpoints, crashes
        b = DurableZbDb.open(tmp_path / "s")
        with b.transaction():
            b.column_family(CF).put((0,), {"seq": "dead-timeline"})
        b._wal.flush()  # bytes reach the file, manifest never updated
        b._wal.close(); b._wal = None  # crash without close() cleanup
        assert (tmp_path / "s" / "wal-00000002.log").stat().st_size > 0

        # session C: same wal-2 name; writes its own (correct) value
        c = DurableZbDb.open(tmp_path / "s")
        with c.transaction():
            assert c.column_family(CF).get((0,))["seq"] == 0  # B reverted
            c.column_family(CF).put((0,), {"seq": "rederived"})
        c.checkpoint()
        c.close()

        rec = DurableZbDb.open(tmp_path / "s")
        with rec.transaction():
            assert rec.column_family(CF).get((0,))["seq"] == "rederived"
        rec.close()
