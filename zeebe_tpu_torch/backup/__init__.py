"""Backup/restore: cluster-consistent checkpoints shipped to a backup store.

Reference: backup/ + backup-stores/{s3,gcs} + restore/ (SURVEY §2.12, §5.4) —
CheckpointRecordsProcessor.java:34 (CHECKPOINT records interleaved on the
stream; inter-partition commands carry checkpoint ids so a cluster-wide
consistent checkpoint forms without stopping processing), BackupServiceImpl
(snapshot + segments → BackupStore), PartitionRestoreService.java:36.
"""

import os

from zeebe_tpu_torch.backup.checkpoint import CheckpointProcessor, CheckpointState
from zeebe_tpu_torch.backup.gcs import GcsBackupStore, GcsClient
from zeebe_tpu_torch.backup.s3 import S3BackupStore, S3Client
from zeebe_tpu_torch.backup.store import Backup, BackupStatus, FileSystemBackupStore
from zeebe_tpu_torch.backup.service import BackupService, PartitionRestoreService

def backup_store_from_env(env: dict | None = None):
    """Construct a backup store from ``ZEEBE_BROKER_DATA_BACKUP_*`` env vars
    (reference: broker data.backup config — store selection NONE/S3/GCS with
    per-store sub-sections). Returns None when no remote store is configured.

    S3:  ZEEBE_BROKER_DATA_BACKUP_STORE=S3 + _S3_ENDPOINT, _S3_BUCKETNAME,
         _S3_ACCESSKEY, _S3_SECRETKEY [, _S3_REGION, _S3_BASEPATH]
    GCS: ZEEBE_BROKER_DATA_BACKUP_STORE=GCS + _GCS_BUCKETNAME
         [, _GCS_HOST, _GCS_AUTH (bearer token), _GCS_BASEPATH]
    """
    env = env if env is not None else os.environ
    prefix = "ZEEBE_BROKER_DATA_BACKUP"
    kind = env.get(f"{prefix}_STORE", "NONE").upper()
    if kind in ("", "NONE"):
        return None
    if kind == "S3":
        client = S3Client(
            endpoint=env[f"{prefix}_S3_ENDPOINT"],
            bucket=env[f"{prefix}_S3_BUCKETNAME"],
            access_key=env[f"{prefix}_S3_ACCESSKEY"],
            secret_key=env[f"{prefix}_S3_SECRETKEY"],
            region=env.get(f"{prefix}_S3_REGION", "us-east-1"),
        )
        return S3BackupStore(client, env.get(f"{prefix}_S3_BASEPATH", "backups"))
    if kind == "GCS":
        client = GcsClient(
            bucket=env[f"{prefix}_GCS_BUCKETNAME"],
            access_token=env.get(f"{prefix}_GCS_AUTH", ""),
            endpoint=env.get(f"{prefix}_GCS_HOST",
                             "https://storage.googleapis.com"),
        )
        return GcsBackupStore(client, env.get(f"{prefix}_GCS_BASEPATH", "backups"))
    raise ValueError(f"unknown backup store kind {kind!r} (NONE/S3/GCS)")


__all__ = [
    "backup_store_from_env",
    "Backup",
    "BackupService",
    "BackupStatus",
    "CheckpointProcessor",
    "CheckpointState",
    "FileSystemBackupStore",
    "GcsBackupStore",
    "GcsClient",
    "PartitionRestoreService",
    "S3BackupStore",
    "S3Client",
]
