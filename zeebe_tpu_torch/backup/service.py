"""Backup + restore services over a partition's files.

Reference: backup/src/main/java/io/camunda/zeebe/backup/management/
BackupServiceImpl (snapshot + segment files → BackupStore, reserving the
snapshot during the copy) and restore/…/PartitionRestoreService.java:36
(download backup, reconstitute the partition data directories so a broker
boots from them).
"""

from __future__ import annotations

from pathlib import Path

from zeebe_tpu_torch.backup.store import Backup, BackupStatus, FileSystemBackupStore


from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

_M_BACKUP_TOTAL = _REG.counter(
    "backup_operations_total", "backup operations by outcome",
    ("operation", "outcome"))
_M_BACKUP_LATENCY = _REG.histogram(
    "backup_operations_latency", "seconds per backup operation",
    ("operation",))
_M_BACKUP_IN_PROGRESS = _REG.gauge(
    "backup_operations_in_progress", "backup operations running").labels()


class BackupService:
    """Takes one partition's backup at a checkpoint."""

    def __init__(self, store: FileSystemBackupStore, node_id: str) -> None:
        self.store = store
        self.node_id = node_id

    def take_backup(self, partition, checkpoint_id: int,
                    checkpoint_position: int) -> BackupStatus:
        import time as _time

        start = _time.perf_counter()
        _M_BACKUP_IN_PROGRESS.inc()
        try:
            status = self._take_backup(partition, checkpoint_id,
                                       checkpoint_position)
            _M_BACKUP_TOTAL.labels("take", "completed").inc()
            return status
        except Exception:
            _M_BACKUP_TOTAL.labels("take", "failed").inc()
            raise
        finally:
            _M_BACKUP_IN_PROGRESS.dec()
            _M_BACKUP_LATENCY.labels("take").observe(_time.perf_counter() - start)

    def _take_backup(self, partition, checkpoint_id: int,
                     checkpoint_position: int) -> BackupStatus:
        """Backup = current persisted snapshot + the stream journal suffix
        (events after the snapshot up to the checkpoint). The partition keeps
        processing — the checkpoint record already fixed the logical cut."""
        # force_full: a backup must be self-contained — a delta tip would
        # reference a base snapshot that exists only in the live data dir
        partition.take_snapshot(force_full=True)
        snapshot_files = {}
        descriptor = {"snapshotId": None}
        chain = partition.snapshot_store.latest_valid_chain()
        if chain is not None:
            tip = chain[-1]
            descriptor["snapshotId"] = str(tip.id)
            if len(chain) == 1:
                snapshot_files = {p.name: p.read_bytes() for p in tip.files()}
            else:
                # the force_full above declined (nothing newer to snapshot)
                # and the tip is still a delta: materialize base+deltas into
                # one self-contained snapshot, manifest recomputed to match
                from zeebe_tpu_torch.state.snapshot import (
                    STATE_FILE,
                    load_chain_db,
                    manifest_bytes,
                )

                snapshot_files = {
                    STATE_FILE: load_chain_db(chain).to_snapshot_bytes(),
                    "meta.bin": tip.read_file("meta.bin"),
                }
                snapshot_files["CHECKSUM.sfv"] = manifest_bytes(snapshot_files)
        partition.stream_journal.flush()
        segment_files = {
            p.name: p.read_bytes()
            for p in sorted(partition.stream_journal.dir.iterdir())
            if p.is_file()
        }
        backup = Backup(
            checkpoint_id=checkpoint_id,
            partition_id=partition.partition_id,
            node_id=self.node_id,
            checkpoint_position=checkpoint_position,
            descriptor=descriptor,
            snapshot_files=snapshot_files,
            segment_files=segment_files,
        )
        return self.store.save(backup)


class PartitionRestoreService:
    """Reconstitute a partition data directory from a backup; a broker started
    over the directory recovers via the normal snapshot+replay path."""

    def __init__(self, store: FileSystemBackupStore) -> None:
        self.store = store

    def restore(self, checkpoint_id: int, partition_id: int,
                target_directory: str | Path) -> None:
        backup = self.store.read(checkpoint_id, partition_id)
        target = Path(target_directory)
        stream_dir = target / "stream"
        snapshot_dir = target / "snapshots" / "snapshots"
        stream_dir.mkdir(parents=True, exist_ok=True)
        for name, data in backup.segment_files.items():
            (stream_dir / name).write_bytes(data)
        # cut the restored log at the checkpoint: records appended after the
        # CHECKPOINT command (the backup raced ongoing processing) would move
        # the logical cut point and break cross-partition consistency
        from zeebe_tpu_torch.journal import SegmentedJournal

        journal = SegmentedJournal(stream_dir)
        try:
            cut_index = journal.seek_to_asqn(backup.checkpoint_position)
            if cut_index > 0:
                journal.truncate_after(cut_index)
        finally:
            journal.close()
        snapshot_id = backup.descriptor.get("snapshotId")
        if snapshot_id and backup.snapshot_files:
            snap_target = snapshot_dir / snapshot_id
            snap_target.mkdir(parents=True, exist_ok=True)
            for name, data in backup.snapshot_files.items():
                (snap_target / name).write_bytes(data)
