# tests/test_backup.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Backup/restore + checkpoint tests (reference: backup/src/test
CheckpointRecordsProcessorTest, backup-stores testkit acceptance suite,
restore/ PartitionRestoreService tests)."""

from __future__ import annotations

import pytest

from zeebe_tpu_torch.backup import FileSystemBackupStore, PartitionRestoreService
from zeebe_tpu_torch.backup.store import BackupStatusCode
from zeebe_tpu_torch.broker import InProcessCluster
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    CheckpointIntent,
    DeploymentIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.testing import EngineHarness


def one_task():
    return (
        Bpmn.create_executable_process("p")
        .start_event("s").service_task("t", job_type="w").end_event("e").done()
    )


def deploy_cmd(model):
    return command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": "p.bpmn", "resource": to_bpmn_xml(model)}],
    })


def create_cmd():
    return command(
        ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": "p", "version": -1, "variables": {}},
    )


def checkpoint_cmd(checkpoint_id):
    return command(ValueType.CHECKPOINT, CheckpointIntent.CREATE,
                   {"checkpointId": checkpoint_id})


class TestCheckpointRecords:
    def test_create_and_ignore(self):
        h = EngineHarness(device="cpu")
        try:
            h.write_command(checkpoint_cmd(5))
            created = h.exporter.all().with_value_type(ValueType.CHECKPOINT) \
                .with_intent(CheckpointIntent.CREATED).to_list()
            assert len(created) == 1
            assert created[0].record.value["checkpointId"] == 5
            # same or lower id → IGNORED (at-least-once dedup)
            h.write_command(checkpoint_cmd(5))
            h.write_command(checkpoint_cmd(3))
            ignored = h.exporter.all().with_value_type(ValueType.CHECKPOINT) \
                .with_intent(CheckpointIntent.IGNORED).to_list()
            assert len(ignored) == 2
            with h.db.transaction():
                assert h.engine.checkpoint_state.latest_id() == 5
        finally:
            h.close()


class TestBackupStore:
    def test_save_status_list_delete(self, tmp_path):
        from zeebe_tpu_torch.backup.store import Backup

        store = FileSystemBackupStore(tmp_path / "store")
        assert store.get_status(1, 1).status == BackupStatusCode.DOES_NOT_EXIST
        backup = Backup(
            checkpoint_id=1, partition_id=1, node_id="broker-0",
            checkpoint_position=42, descriptor={"snapshotId": "s"},
            snapshot_files={"state.bin": b"\x01\x02"},
            segment_files={"journal-1.log": b"\x03"},
        )
        status = store.save(backup)
        assert status.status == BackupStatusCode.COMPLETED
        assert status.descriptor["checkpointPosition"] == 42
        assert [s.checkpoint_id for s in store.list_backups(1)] == [1]
        roundtrip = store.read(1, 1)
        assert roundtrip.snapshot_files == backup.snapshot_files
        assert roundtrip.segment_files == backup.segment_files
        store.delete(1, 1)
        assert store.get_status(1, 1).status == BackupStatusCode.DOES_NOT_EXIST


class TestClusterBackupRestore:
    def test_checkpoint_triggers_backup_on_all_partitions(self, tmp_path):
        c = InProcessCluster(broker_count=1, partition_count=2,
                             replication_factor=1, directory=tmp_path / "c", device="cpu")
        broker = next(iter(c.brokers.values()))
        # enable backups post-hoc is awkward; rebuild with store via Broker arg
        c.close()
        from zeebe_tpu_torch.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.testing import ControlledClock

        clock = ControlledClock()
        net = LoopbackNetwork()
        cfg = BrokerCfg(node_id="b0", partition_count=2, replication_factor=1,
                        cluster_members=["b0"], device="cpu")
        broker = Broker(cfg, net.join("b0"), directory=tmp_path / "b0",
                        clock_millis=clock,
                        backup_store_directory=tmp_path / "backups")

        def pump(ms=5000):
            for _ in range(ms // 50):
                clock.advance(50)
                broker.pump()
                net.deliver_all()

        try:
            pump(12_000)  # elect
            assert all(p.is_leader for p in broker.partitions.values())
            broker.write_command(1, deploy_cmd(one_task()))
            pump(500)
            broker.write_command(1, create_cmd())
            pump(500)
            assert broker.trigger_checkpoint(7) == 2
            pump(500)
            store = broker.backup_store
            for pid in (1, 2):
                status = store.get_status(7, pid)
                assert status.status == BackupStatusCode.COMPLETED, (pid, status)
            # inter-partition piggyback: new checkpoint then cross-partition
            # traffic propagates it (deployment distribution to partition 2)
            assert broker.latest_checkpoint_id() == 7
        finally:
            broker.close()

    def test_restore_reconstitutes_partition(self, tmp_path):
        from zeebe_tpu_torch.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.testing import ControlledClock

        clock = ControlledClock()
        net = LoopbackNetwork()
        cfg = BrokerCfg(node_id="b0", partition_count=1, replication_factor=1,
                        cluster_members=["b0"], device="cpu")
        broker = Broker(cfg, net.join("b0"), directory=tmp_path / "orig",
                        clock_millis=clock,
                        backup_store_directory=tmp_path / "backups")

        def pump(b, n, ms=5000):
            for _ in range(ms // 50):
                clock.advance(50)
                b.pump()
                n.deliver_all()

        pump(broker, net, 12_000)
        broker.write_command(1, deploy_cmd(one_task()))
        pump(broker, net, 500)
        for _ in range(3):
            broker.write_command(1, create_cmd())
            pump(broker, net, 300)
        old_db = broker.partitions[1].db
        broker.trigger_checkpoint(1)
        pump(broker, net, 500)
        broker.close()

        # restore into a fresh directory, boot a broker over it
        store = FileSystemBackupStore(tmp_path / "backups")
        restore = PartitionRestoreService(store)
        restore.restore(1, 1, tmp_path / "restored" / "partition-1")
        net2 = LoopbackNetwork()
        broker2 = Broker(cfg, net2.join("b0"), directory=tmp_path / "restored",
                        clock_millis=clock)
        try:
            pump(broker2, net2, 12_000)
            restored = broker2.partitions[1]
            assert restored.is_leader
            assert restored.db.content_equals(old_db)
            with restored.db.transaction():
                jobs = restored.engine.state.jobs.activatable_keys("w", 10)
            assert len(jobs) == 3
            # and processing continues after restore
            broker2.write_command(1, create_cmd())
            pump(broker2, net2, 500)
            with restored.db.transaction():
                jobs = restored.engine.state.jobs.activatable_keys("w", 10)
            assert len(jobs) == 4
        finally:
            broker2.close()


class TestMultiNodeWipeRestore:
    def test_cluster_survives_full_data_wipe_via_backup(self, tmp_path):
        """The disaster-recovery path: a 3-broker replicated cluster backs up
        on a checkpoint, EVERY node's data directory is wiped, each node
        restores its partition from the shared backup store, and the rebooted
        cluster carries identical state and keeps processing (reference:
        restore/PartitionRestoreService + backup acceptance tests)."""
        import shutil

        from zeebe_tpu_torch.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
        from zeebe_tpu_torch.testing import ControlledClock

        members = ["b0", "b1", "b2"]
        backup_dir = tmp_path / "backups"

        def boot(directory):
            clock = ControlledClock()
            net = LoopbackNetwork()
            brokers = {
                m: Broker(
                    BrokerCfg(node_id=m, partition_count=1,
                              replication_factor=3, cluster_members=members, device="cpu"),
                    net.join(m), directory=directory / m, clock_millis=clock,
                    backup_store_directory=backup_dir,
                )
                for m in members
            }
            return clock, net, brokers

        def pump(clock, net, brokers, ms):
            for _ in range(max(ms // 50, 1)):
                clock.advance(50)
                for b in brokers.values():
                    b.pump()
                net.deliver_all()

        def leader(brokers):
            return next(b for b in brokers.values()
                        if b.partitions[1].is_leader)

        clock, net, brokers = boot(tmp_path / "data")
        pump(clock, net, brokers, 12_000)
        lead = leader(brokers)
        lead.write_command(1, deploy_cmd(one_task()))
        pump(clock, net, brokers, 500)
        for _ in range(4):
            leader(brokers).write_command(1, create_cmd())
            pump(clock, net, brokers, 300)
        old_db = leader(brokers).partitions[1].db
        with old_db.transaction():
            jobs_before = len(
                leader(brokers).partitions[1].engine.state.jobs
                .activatable_keys("w", 100))
        assert jobs_before == 4
        leader(brokers).trigger_checkpoint(7)
        pump(clock, net, brokers, 1_000)
        db_image = old_db.to_snapshot_bytes()
        for b in brokers.values():
            b.close()

        # the disaster: every node's data directory is gone
        shutil.rmtree(tmp_path / "data")

        # restore each node's partition from the shared store, then reboot
        store = FileSystemBackupStore(backup_dir)
        restore = PartitionRestoreService(store)
        for m in members:
            restore.restore(7, 1, tmp_path / "data" / m / "partition-1")
        clock2, net2, brokers2 = boot(tmp_path / "data")
        try:
            pump(clock2, net2, brokers2, 15_000)
            lead2 = leader(brokers2)
            restored = lead2.partitions[1]
            from zeebe_tpu_torch.state import ZbDb

            reference_db = ZbDb.from_snapshot_bytes(db_image)
            assert restored.db.content_equals(reference_db)
            # the restored cluster keeps serving
            lead2.write_command(1, create_cmd())
            pump(clock2, net2, brokers2, 500)
            with restored.db.transaction():
                jobs = restored.engine.state.jobs.activatable_keys("w", 100)
            assert len(jobs) == 5
        finally:
            for b in brokers2.values():
                b.close()
