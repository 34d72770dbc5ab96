"""Checkpoint records: the cluster-consistent cut marker.

Reference: backup/src/main/java/io/camunda/zeebe/backup/processing/
CheckpointRecordsProcessor.java:34 — a CHECKPOINT CREATE command either
creates a checkpoint (id > last: CREATED event, listeners fire → backup
starts) or is IGNORED (id <= last, at-least-once propagation dedup).
Inter-partition commands piggyback the sender's checkpoint id; the receiver
creates the checkpoint BEFORE processing the command, which is what makes the
cut consistent across partitions without pausing processing.
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import CheckpointIntent
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.db import ColumnFamilyCode as CF


class CheckpointState:
    def __init__(self, db: ZbDb) -> None:
        self._cf = db.column_family(CF.CHECKPOINT)

    def latest_id(self) -> int:
        latest = self._cf.get(("latest",))
        return latest["checkpointId"] if latest else 0

    def latest(self) -> dict | None:
        return self._cf.get(("latest",))

    def put(self, checkpoint_id: int, position: int) -> None:
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.gauge("checkpoint_id", "latest checkpoint id").set(checkpoint_id)
        REGISTRY.gauge("checkpoint_position",
                       "latest checkpoint position").set(position)
        REGISTRY.counter("checkpoint_records_total",
                         "checkpoint records applied").inc()
        self._cf.put(("latest",), {"checkpointId": checkpoint_id,
                                   "position": position})


class CheckpointProcessor:
    """Handles CHECKPOINT CREATE commands + applies CREATED events."""

    def __init__(self, state: CheckpointState) -> None:
        self.state = state
        # fired post-commit with (checkpoint_id, position) on creation —
        # the broker hangs the backup trigger here
        self.listeners: list[Callable[[int, int], None]] = []

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        checkpoint_id = cmd.record.value.get("checkpointId", -1)
        if checkpoint_id <= self.state.latest_id():
            writers.append_event(
                cmd.record.key if cmd.record.key > 0 else -1,
                ValueType.CHECKPOINT, CheckpointIntent.IGNORED,
                {"checkpointId": checkpoint_id,
                 "checkpointPosition": cmd.position},
            )
            return
        writers.append_event(
            cmd.record.key if cmd.record.key > 0 else -1,
            ValueType.CHECKPOINT, CheckpointIntent.CREATED,
            {"checkpointId": checkpoint_id, "checkpointPosition": cmd.position},
        )
        position = cmd.position
        listeners = list(self.listeners)

        def notify() -> None:
            for listener in listeners:
                listener(checkpoint_id, position)

        writers.after_commit(notify)
