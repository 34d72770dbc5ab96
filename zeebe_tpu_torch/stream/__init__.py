"""Stream-processing platform (SURVEY.md §2.7)."""

from zeebe_tpu_torch.stream.api import (
    ClientResponse,
    ExceededBatchRecordSizeError,
    FollowUpRecord,
    ProcessingErrorHandling,
    ProcessingResultBuilder,
    ProcessingScheduleService,
    RecordProcessor,
)
from zeebe_tpu_torch.stream.processor import Phase, StreamProcessor, StreamProcessorMode

__all__ = [
    "ClientResponse",
    "ExceededBatchRecordSizeError",
    "FollowUpRecord",
    "Phase",
    "ProcessingErrorHandling",
    "ProcessingResultBuilder",
    "ProcessingScheduleService",
    "RecordProcessor",
    "StreamProcessor",
    "StreamProcessorMode",
]
