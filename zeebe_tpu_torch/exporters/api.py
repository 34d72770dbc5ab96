"""Exporter SPI: the plugin seam for shipping committed records to sinks.

Reference: exporter-api/src/main/java/io/camunda/zeebe/exporter/api/
Exporter.java — lifecycle ``configure(context) → open(controller) →
export(record)* → close()``; the Controller exposes
``updateLastExportedRecordPosition`` (bounds log compaction) and
``scheduleCancellableTask`` (flush timers).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from zeebe_tpu_torch.logstreams import LoggedRecord


@dataclass
class ExporterContext:
    """Configuration handed to the exporter before open (reference:
    Exporter#configure(Context) — id, configuration map, record filter)."""

    exporter_id: str
    configuration: dict[str, Any] = field(default_factory=dict)
    # optional record filter: (record_type_name, value_type_name) -> bool
    record_filter: Callable[[LoggedRecord], bool] | None = None


class ExporterController:
    """Hands the exporter its position-acknowledgement, durable metadata, and
    task scheduling (reference: exporter-api Controller —
    updateLastExportedRecordPosition(position, metadata) and readMetadata;
    ExporterContainer implements it)."""

    def __init__(self, on_position: Callable[..., None],
                 schedule: Callable[[int, Callable[[], None]], Any] | None = None,
                 on_metadata: Callable[[bytes], None] | None = None,
                 read_metadata: Callable[[], bytes | None] | None = None) -> None:
        import inspect

        self._on_position = on_position
        # a two-parameter on_position receives (position, metadata) in ONE
        # call so the host can persist both atomically; single-parameter
        # callbacks (tests / custom hosts) keep the split delivery
        try:
            params = inspect.signature(on_position).parameters.values()
            positional = [
                p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                              p.VAR_POSITIONAL)
            ]
            # only positional capacity counts: `lambda p, **kw` is still a
            # one-arg callback under the old Callable[[int], None] contract
            self._atomic = (len(positional) >= 2
                            or any(p.kind == p.VAR_POSITIONAL for p in positional))
        except (TypeError, ValueError):
            self._atomic = False
        self._schedule = schedule
        self._on_metadata = on_metadata
        self._read_metadata = read_metadata

    def update_last_exported_position(self, position: int,
                                      metadata: bytes | None = None) -> None:
        # position and metadata must land atomically where the host supports
        # it: a crash between two separate writes would leave sequence
        # counters ahead of the acked position, and re-exported records would
        # re-index with different sequences (reference: ExporterContainer
        # persists both in the ExportersState in one transaction)
        if self._atomic:
            self._on_position(position, metadata)
            return
        if metadata is not None and self._on_metadata is not None:
            self._on_metadata(metadata)
        self._on_position(position)

    def read_metadata(self) -> bytes | None:
        """Durable exporter-private state persisted with the position acks
        (reference: Controller#readMetadata — the ES exporter keeps its
        record-sequence counters here so restarts do not reset sequences)."""
        return self._read_metadata() if self._read_metadata is not None else None

    def schedule_task(self, delay_millis: int, task: Callable[[], None]) -> Any:
        if self._schedule is None:
            raise RuntimeError("scheduling not available in this context")
        return self._schedule(delay_millis, task)


class Exporter:
    """Base class; subclasses override what they need (reference default
    methods on the Exporter interface)."""

    def configure(self, context: ExporterContext) -> None:
        self.context = context

    def open(self, controller: ExporterController) -> None:
        self.controller = controller

    def export(self, record: LoggedRecord) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass
