"""State substrate: column-family KV store + snapshot store (SURVEY.md §2.4, §2.6)."""

from zeebe_tpu_torch.state.db import (
    ColumnFamily,
    ColumnFamilyCode,
    Transaction,
    ZbDb,
    ZbDbInconsistentError,
    encode_key,
)
from zeebe_tpu_torch.state.durable import DurableZbDb
from zeebe_tpu_torch.state.tiering import (
    ColdRef,
    ColdStore,
    TieredZbDb,
    TieringCfg,
    TieringManager,
)
from zeebe_tpu_torch.state.snapshot import (
    FileBasedSnapshotStore,
    InvalidSnapshotError,
    PersistedSnapshot,
    SnapshotChunk,
    SnapshotId,
    TransientSnapshot,
)

__all__ = [
    "ColdRef",
    "ColdStore",
    "ColumnFamily",
    "ColumnFamilyCode",
    "DurableZbDb",
    "TieredZbDb",
    "TieringCfg",
    "TieringManager",
    "FileBasedSnapshotStore",
    "InvalidSnapshotError",
    "PersistedSnapshot",
    "SnapshotChunk",
    "SnapshotId",
    "Transaction",
    "TransientSnapshot",
    "ZbDb",
    "ZbDbInconsistentError",
    "encode_key",
]
