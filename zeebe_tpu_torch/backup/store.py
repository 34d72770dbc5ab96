"""Backup store: where completed backups live.

Reference: backup/src/main/java/io/camunda/zeebe/backup/api/BackupStore.java —
save / getStatus / list / delete / restore over BackupIdentifier
(checkpointId, partitionId, nodeId) with status DOES_NOT_EXIST / IN_PROGRESS /
COMPLETED / FAILED; S3 (backup-stores/s3) and GCS (backup-stores/gcs) remote
implementations. This module provides the filesystem implementation (object
layout mirrors the S3 key scheme ``<prefix>/<partitionId>/<checkpointId>/``)
— a remote store is the same interface over a blob client.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import shutil
from pathlib import Path

from zeebe_tpu_torch.utils import storage_io


class BackupStatusCode(enum.Enum):
    DOES_NOT_EXIST = "DOES_NOT_EXIST"
    IN_PROGRESS = "IN_PROGRESS"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclasses.dataclass
class BackupStatus:
    checkpoint_id: int
    partition_id: int
    status: BackupStatusCode
    descriptor: dict = dataclasses.field(default_factory=dict)
    failure_reason: str = ""


@dataclasses.dataclass
class Backup:
    """One partition's contribution to a checkpoint backup."""

    checkpoint_id: int
    partition_id: int
    node_id: str
    checkpoint_position: int
    descriptor: dict
    # name → bytes: the state snapshot files and log segment files
    snapshot_files: dict[str, bytes]
    segment_files: dict[str, bytes]


class FileSystemBackupStore:
    def __init__(self, directory: str | Path) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _backup_dir(self, partition_id: int, checkpoint_id: int) -> Path:
        return self.directory / str(partition_id) / str(checkpoint_id)

    def save(self, backup: Backup) -> BackupStatus:
        target = self._backup_dir(backup.partition_id, backup.checkpoint_id)
        if target.exists():
            shutil.rmtree(target)
        in_progress = target.with_suffix(".tmp")
        if in_progress.exists():
            shutil.rmtree(in_progress)
        (in_progress / "snapshot").mkdir(parents=True)
        (in_progress / "segments").mkdir(parents=True)
        for name, data in backup.snapshot_files.items():
            storage_io.write_bytes(in_progress / "snapshot" / name, data)
        for name, data in backup.segment_files.items():
            storage_io.write_bytes(in_progress / "segments" / name, data)
        manifest = {
            "checkpointId": backup.checkpoint_id,
            "partitionId": backup.partition_id,
            "nodeId": backup.node_id,
            "checkpointPosition": backup.checkpoint_position,
            "descriptor": backup.descriptor,
            "snapshotFiles": sorted(backup.snapshot_files),
            "segmentFiles": sorted(backup.segment_files),
        }
        storage_io.write_text(in_progress / "manifest.json",
                              json.dumps(manifest, indent=2))
        storage_io.replace(in_progress, target)  # atomic publish ("COMPLETED")
        return self.get_status(backup.checkpoint_id, backup.partition_id)

    def get_status(self, checkpoint_id: int, partition_id: int) -> BackupStatus:
        target = self._backup_dir(partition_id, checkpoint_id)
        if target.with_suffix(".tmp").exists():
            return BackupStatus(checkpoint_id, partition_id,
                                BackupStatusCode.IN_PROGRESS)
        manifest_path = target / "manifest.json"
        if not manifest_path.exists():
            return BackupStatus(checkpoint_id, partition_id,
                                BackupStatusCode.DOES_NOT_EXIST)
        try:
            manifest = json.loads(manifest_path.read_text())
        except json.JSONDecodeError as exc:
            return BackupStatus(checkpoint_id, partition_id,
                                BackupStatusCode.FAILED,
                                failure_reason=f"corrupt manifest: {exc}")
        return BackupStatus(checkpoint_id, partition_id,
                            BackupStatusCode.COMPLETED, descriptor=manifest)

    def list_backups(self, partition_id: int | None = None) -> list[BackupStatus]:
        out = []
        partitions = (
            [self.directory / str(partition_id)] if partition_id is not None
            else sorted((p for p in self.directory.iterdir() if p.is_dir()),
                        key=lambda p: int(p.name))
        )
        for pdir in partitions:
            if not pdir.exists():
                continue
            for cdir in sorted(pdir.iterdir(),
                               key=lambda p: int(p.name.removesuffix(".tmp"))):
                if cdir.is_dir() and not cdir.name.endswith(".tmp"):
                    out.append(self.get_status(int(cdir.name), int(pdir.name)))
        return out

    def delete(self, checkpoint_id: int, partition_id: int) -> None:
        target = self._backup_dir(partition_id, checkpoint_id)
        if target.exists():
            shutil.rmtree(target)

    def read(self, checkpoint_id: int, partition_id: int) -> Backup:
        target = self._backup_dir(partition_id, checkpoint_id)
        manifest = json.loads((target / "manifest.json").read_text())
        return Backup(
            checkpoint_id=manifest["checkpointId"],
            partition_id=manifest["partitionId"],
            node_id=manifest["nodeId"],
            checkpoint_position=manifest["checkpointPosition"],
            descriptor=manifest["descriptor"],
            snapshot_files={
                name: (target / "snapshot" / name).read_bytes()
                for name in manifest["snapshotFiles"]
            },
            segment_files={
                name: (target / "segments" / name).read_bytes()
                for name in manifest["segmentFiles"]
            },
        )
