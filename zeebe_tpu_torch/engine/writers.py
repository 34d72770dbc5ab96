"""Engine writers: the append-and-apply seam.

Reference: engine/…/processing/streamprocessor/writers/Writers.java —
StateWriter (appending an event also applies it to state immediately,
StateWriter.java:11), TypedCommandWriter, TypedRejectionWriter,
TypedResponseWriter. Keeping "write event" and "apply event" in lock-step is
what guarantees replay equivalence.
"""

from __future__ import annotations

from typing import Any, Mapping

from zeebe_tpu_torch.engine.appliers import EventAppliers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import (
    Record,
    RejectionType,
    ValueType,
    command,
    event,
    rejection,
)
from zeebe_tpu_torch.protocol.intent import Intent
from zeebe_tpu_torch.stream import ProcessingResultBuilder


class Writers:
    def __init__(self, builder: ProcessingResultBuilder, appliers: EventAppliers) -> None:
        self._builder = builder
        self._appliers = appliers

    # -- StateWriter: append event + apply immediately ------------------------

    def append_event(
        self, key: int, value_type: ValueType, intent: Intent, value: Mapping[str, Any]
    ) -> Record:
        rec = event(value_type, intent, value, key=key)
        self._builder.append_record(rec)
        self._appliers.apply(rec)
        return rec

    # -- TypedCommandWriter ---------------------------------------------------

    def append_command(
        self, key: int, value_type: ValueType, intent: Intent, value: Mapping[str, Any]
    ) -> Record:
        rec = command(value_type, intent, value, key=key)
        self._builder.append_record(rec)
        return rec

    # -- TypedRejectionWriter -------------------------------------------------

    def append_rejection(
        self, cmd: LoggedRecord, rejection_type: RejectionType, reason: str
    ) -> Record:
        rec = rejection(cmd.record.replace(position=cmd.position), rejection_type, reason)
        self._builder.append_record(rec)
        return rec

    # -- TypedResponseWriter --------------------------------------------------

    def _stamp_response(self, record: Record, request_stream_id: int,
                        request_id: int) -> Record:
        """Stamp the request identity into the response record's FRAME (the
        reference does the same in RecordMetadata): the logged bytes then
        carry which request a reply answers, which is what lets the
        replicated dedupe table (state/request_dedupe.py) be materialized
        identically on processing and replay. Appliers never read the
        request fields, so applied state is unchanged; the follow-up entry
        is swapped in place so the stamped frame is what gets logged."""
        if (record.request_id == request_id
                and record.request_stream_id == request_stream_id):
            return record  # rejections arrive pre-stamped
        stamped = record.replace(request_stream_id=request_stream_id,
                                 request_id=request_id)
        for entry in self._builder.follow_ups:
            if entry.record is record:
                entry.record = stamped
                break
        return stamped

    def respond(self, cmd: LoggedRecord, record: Record) -> None:
        if cmd.record.request_id >= 0:
            stamped = self._stamp_response(
                record, cmd.record.request_stream_id, cmd.record.request_id)
            self._builder.with_response(
                stamped, cmd.record.request_stream_id, cmd.record.request_id
            )

    def respond_to(self, record: Record, request_stream_id: int, request_id: int) -> None:
        """Answer a parked request from an earlier command (await-result)."""
        if request_id >= 0:
            stamped = self._stamp_response(record, request_stream_id,
                                           request_id)
            self._builder.add_response(stamped, request_stream_id, request_id)

    def respond_rejection(self, cmd: LoggedRecord, rejection_type: RejectionType, reason: str) -> None:
        rec = self.append_rejection(cmd, rejection_type, reason)
        self.respond(cmd, rec)

    # -- SideEffectWriter: run after the transaction commits ------------------

    def after_commit(self, task) -> None:
        self._builder.append_post_commit_task(task)
