"""Protocol layer: record schema, intents, keys, msgpack codec (SURVEY.md §2.9)."""

from zeebe_tpu_torch.protocol.enums import (
    DEFAULT_TENANT,
    BpmnElementType,
    BpmnEventType,
    ErrorType,
    PartitionRole,
    RecordType,
    RejectionType,
    ValueType,
)
from zeebe_tpu_torch.protocol.intent import Intent
from zeebe_tpu_torch.protocol.keys import (
    KeyGenerator,
    decode_key_in_partition,
    decode_partition_id,
    encode_partition_id,
)
from zeebe_tpu_torch.protocol.record import Record, command, event, rejection

__all__ = [
    "DEFAULT_TENANT",
    "BpmnElementType",
    "BpmnEventType",
    "ErrorType",
    "Intent",
    "KeyGenerator",
    "PartitionRole",
    "Record",
    "RecordType",
    "RejectionType",
    "ValueType",
    "command",
    "decode_key_in_partition",
    "decode_partition_id",
    "encode_partition_id",
    "event",
    "rejection",
]
