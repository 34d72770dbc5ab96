"""DbMigrator: one-shot state migrations run at partition transition.

Reference: engine/src/main/java/io/camunda/zeebe/engine/state/migration/
DbMigratorImpl.java:29 — an ordered list of ``MigrationTask``s runs when a
partition transitions (before the stream processor opens); each task executes
at most once per partition, recorded in the MIGRATIONS_STATE column family
(the reference's MigrationsState). The shipped tasks mirror the reference's
to_8_3/ multi-tenancy backfills: they rewrite pre-tenancy key shapes from
older snapshots into the tenant-aware shapes the current state code reads.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

from zeebe_tpu_torch.protocol import DEFAULT_TENANT
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.db import ColumnFamilyCode as CF
from zeebe_tpu_torch.state.db import decode_key, encode_key

logger = logging.getLogger("zeebe_tpu_torch.engine.migration")


@dataclasses.dataclass(frozen=True)
class MigrationTask:
    """One idempotent migration; ``run`` returns how many entries changed."""

    identifier: str
    run: Callable[[ZbDb], int]


def _retenant_index(db: ZbDb, code: CF, old_arity: int) -> int:
    """Rewrite pre-tenancy keys (old_arity parts) to tenant-prefixed keys
    ((DEFAULT_TENANT, *old_parts)); newer keys are left untouched."""
    txn = db.require_transaction()
    cf = db.column_family(code)
    moves: list[tuple[bytes, bytes, object]] = []
    for enc_key, value in cf.items():
        _, parts = decode_key(enc_key)
        if len(parts) == old_arity and not (
            parts and isinstance(parts[0], str) and parts[0] == DEFAULT_TENANT
        ):
            moves.append(
                (enc_key, encode_key(code, (DEFAULT_TENANT, *parts)), value)
            )
    for old, new, value in moves:
        txn.delete(old)
        txn.put(new, value)
    return len(moves)


def _migrate_process_version_tenancy(db: ZbDb) -> int:
    """Process id/version indexes gained a leading tenant component; backfill
    entries from pre-tenancy snapshots under the default tenant (reference:
    to_8_3 ProcessDefinitionVersionMigration)."""
    changed = _retenant_index(db, CF.PROCESS_CACHE_BY_ID_AND_VERSION, 2)
    changed += _retenant_index(db, CF.PROCESS_VERSION, 1)
    changed += _retenant_index(db, CF.PROCESS_CACHE_DIGEST_BY_ID, 1)
    return changed


def _migrate_message_id_tenancy(db: ZbDb) -> int:
    """Message-id dedup keys gained a trailing tenant component (reference:
    to_8_3 MessageStateMigration)."""
    txn = db.require_transaction()
    cf = db.column_family(CF.MESSAGE_IDS)
    moves = []
    for enc_key, value in cf.items():
        code, parts = decode_key(enc_key)
        if len(parts) == 3:
            moves.append(
                (enc_key, encode_key(code, (*parts, DEFAULT_TENANT)), value)
            )
    for old, new, value in moves:
        txn.delete(old)
        txn.put(new, value)
    return len(moves)


def _migrate_job_activatable_tenancy(db: ZbDb) -> int:
    """Activatable-job index keys gained a middle tenant component:
    (type, key) → (type, tenant, key)."""
    txn = db.require_transaction()
    cf = db.column_family(CF.JOB_ACTIVATABLE)
    moves = []
    for enc_key, value in cf.items():
        code, parts = decode_key(enc_key)
        if len(parts) == 2:
            moves.append(
                (enc_key,
                 encode_key(code, (parts[0], DEFAULT_TENANT, parts[1])), value)
            )
    for old, new, value in moves:
        txn.delete(old)
        txn.put(new, value)
    return len(moves)


def _migrate_dmn_latest_tenancy(db: ZbDb) -> int:
    """DMN latest-by-id indexes gained a leading tenant component."""
    changed = _retenant_index(db, CF.DMN_LATEST_DECISION_BY_ID, 1)
    changed += _retenant_index(db, CF.DMN_LATEST_DRG_BY_ID, 1)
    return changed


MIGRATION_TASKS: list[MigrationTask] = [
    MigrationTask("process-version-tenancy", _migrate_process_version_tenancy),
    MigrationTask("message-id-tenancy", _migrate_message_id_tenancy),
    MigrationTask("job-activatable-tenancy", _migrate_job_activatable_tenancy),
    MigrationTask("dmn-latest-tenancy", _migrate_dmn_latest_tenancy),
]


class DbMigrator:
    """Runs the migration task list once per partition lifetime."""

    def __init__(self, db: ZbDb,
                 tasks: list[MigrationTask] | None = None) -> None:
        self.db = db
        self.tasks = tasks if tasks is not None else MIGRATION_TASKS

    def run_migrations(self) -> list[str]:
        """Execute not-yet-run tasks in order; returns their identifiers.
        All tasks commit in one transaction: a crash mid-migration reruns
        them wholesale on the next transition (each task is idempotent)."""
        executed: list[str] = []
        with self.db.transaction():
            markers = self.db.column_family(CF.MIGRATIONS_STATE)
            for task in self.tasks:
                if markers.get((task.identifier,)) is not None:
                    continue
                changed = task.run(self.db)
                markers.put((task.identifier,), {"entriesChanged": changed})
                executed.append(task.identifier)
                if changed:
                    logger.info("migration %s rewrote %d entries",
                                task.identifier, changed)
        return executed
