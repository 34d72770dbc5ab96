"""Per-partition log stream abstraction (SURVEY.md §2.5)."""

from zeebe_tpu_torch.logstreams.log_stream import (
    LogAppendEntry,
    LoggedRecord,
    LogStream,
    LogStreamReader,
    LogStreamWriter,
    RecordView,
    patch_prepatched_batch,
)

__all__ = [
    "LogAppendEntry",
    "LoggedRecord",
    "LogStream",
    "LogStreamReader",
    "LogStreamWriter",
    "RecordView",
    "patch_prepatched_batch",
]
