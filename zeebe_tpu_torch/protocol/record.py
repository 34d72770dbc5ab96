"""Record — the unit of the event-sourced stream.

A record is metadata (position, key, record type, value type, intent, rejection)
plus a value payload (a msgpack map). Mirrors the reference's ``Record<T>``
interface and ``RecordMetadata`` SBE header (reference: protocol/src/main/java/io/
camunda/zeebe/protocol/record/Record.java; protocol-impl/…/record/RecordMetadata.java).

Values are plain dicts with camelCase keys matching the reference's JSON view, so
parity tests can diff event streams directly against reference semantics.
Serialization is a fixed-layout metadata header + msgpack value body.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Mapping

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.protocol.enums import RecordType, RejectionType, ValueType
from zeebe_tpu_torch.protocol.intent import Intent


def _intent_tables() -> dict[int, dict[int, Intent]]:
    out: dict[int, dict[int, Intent]] = {}
    for vt in ValueType:
        try:
            cls = Intent.for_value_type(vt)
        except (KeyError, ValueError):
            continue
        out[int(vt)] = {int(member): member for member in cls}
    return out


# decode lookup tables: plain dict gets beat Enum.__call__ 4x per record on
# the log-scan hot path
_RT_BY_VALUE = {int(v): v for v in RecordType}
_VT_BY_VALUE = {int(v): v for v in ValueType}
_REJ_BY_VALUE = {int(v): v for v in RejectionType}
_INTENT_BY_VT = _intent_tables()

# Wire layout for the serialized metadata header, preceding the msgpack body
# (the reference frames this with SBE; we use a fixed little-endian struct —
# same information, simpler codegen story):
#   u8 recordType | u8 valueType | u8 intent | u8 rejectionType
#   i64 key | i64 sourceRecordPosition | i64 timestamp
#   i32 requestStreamId | i64 requestId | i64 operationReference
#   u16 rejectionReasonLen | rejectionReason (utf-8)
#   u32 valueLen | value (msgpack)
_HEADER = struct.Struct("<BBBBqqqiqqH")


def _py_decode_frame(data: bytes) -> tuple:
    """Pure-Python frame decode; same 12-tuple as the native fast path."""
    fields = _HEADER.unpack_from(data, 0)
    reason_len = fields[10]
    off = _HEADER.size
    reason = data[off : off + reason_len].decode("utf-8")
    off += reason_len
    (value_len,) = struct.unpack_from("<I", data, off)
    off += 4
    if off + value_len != len(data):
        raise ValueError(
            f"record frame length mismatch: header says {off + value_len}, got {len(data)}"
        )
    value = msgpack.unpackb(data[off : off + value_len])
    return (*fields[:10], reason, value)


from zeebe_tpu_torch import native as _native  # noqa: E402  (cycle-free leaf package)

_codec = _native.load_codec()
_decode_frame = (
    _codec.decode_record_frame
    if _codec is not None and hasattr(_codec, "decode_record_frame")
    else _py_decode_frame
)
# encode mirror (native/codec.c encode_record_frame): None on a stale .so or
# under ZEEBE_TPU_NO_NATIVE — the Python body in _py_encode stays the
# byte-parity oracle either way
_encode_frame = _native.codec_fn("encode_record_frame")

NO_POSITION = -1
NO_KEY = -1
NO_REQUEST = -1


@dataclasses.dataclass(frozen=True, slots=True)
class Record:
    """Immutable stream record. ``position`` is assigned by the sequencer at
    append time; ``source_record_position`` back-links a follow-up record to the
    command that produced it (drives replay's lastProcessedPosition tracking)."""

    record_type: RecordType
    value_type: ValueType
    intent: Intent
    value: Mapping[str, Any]
    key: int = NO_KEY
    position: int = NO_POSITION
    source_record_position: int = NO_POSITION
    timestamp: int = 0  # epoch millis, assigned at append time
    partition_id: int = 0
    rejection_type: RejectionType = RejectionType.NULL_VAL
    rejection_reason: str = ""
    # Request correlation for client responses (gateway stream/request ids).
    request_stream_id: int = NO_REQUEST
    request_id: int = NO_REQUEST
    # Client-supplied reference carried through to events (reference 8.4 feature).
    operation_reference: int = 0

    @property
    def is_command(self) -> bool:
        return self.record_type == RecordType.COMMAND

    @property
    def is_event(self) -> bool:
        return self.record_type == RecordType.EVENT

    @property
    def is_rejection(self) -> bool:
        return self.record_type == RecordType.COMMAND_REJECTION

    def replace(self, **kw: Any) -> "Record":
        # hand-rolled dataclasses.replace: this runs once per record on the
        # append path (timestamp/request stamping) and dataclasses.replace's
        # signature re-validation is ~4x the cost of the constructor call;
        # positional construction skips the kwargs dict plumbing on top.
        # _FIELDS/_FIELD_INDEX are derived from the dataclass below so new
        # fields can never be silently dropped.
        current = [getattr(self, name) for name in _FIELDS]
        for name, value in kw.items():
            current[_FIELD_INDEX[name]] = value
        return Record(*current)

    # -- serialization -------------------------------------------------------

    def to_bytes(self) -> bytes:
        return self.encode()[0]

    def encode(self, timestamp: int | None = None) -> tuple[bytes, bytes]:
        """Serialize; returns (frame, value_body) — the msgpack value bytes
        are exposed so the append path can seed its decode cache without
        re-packing the value. ``timestamp`` (when given) is packed instead of
        ``self.timestamp`` — the append path stamps one batch timestamp, and
        passing it here avoids a per-record replace().

        One native call builds header, reason, and msgpack body in a single
        buffer pass (native/codec.c encode_record_frame); ``_py_encode`` is
        the pure-Python specification with identical bytes."""
        if _encode_frame is not None:
            value = self.value
            return _encode_frame(
                self.record_type, self.value_type, self.intent,
                self.rejection_type, self.key, self.source_record_position,
                self.timestamp if timestamp is None else timestamp,
                self.request_stream_id, self.request_id,
                self.operation_reference, self.rejection_reason,
                value if type(value) is dict else dict(value),
            )
        return self._py_encode(timestamp)

    def _py_encode(self, timestamp: int | None = None) -> tuple[bytes, bytes]:
        """Pure-Python frame encode; same (frame, body) as the native path."""
        reason = self.rejection_reason.encode("utf-8")
        if len(reason) > 0xFFFF:
            # the wire field is u16; truncate on a codepoint boundary so an
            # oversized error message can never poison the append path
            reason = reason[:0xFFFF]
            while reason and (reason[-1] & 0xC0) == 0x80:
                reason = reason[:-1]
            if reason and reason[-1] >= 0xC0:  # dangling lead byte
                reason = reason[:-1]
        value = self.value
        body = msgpack.packb(value if type(value) is dict else dict(value))
        header = _HEADER.pack(
            int(self.record_type),
            int(self.value_type),
            int(self.intent),
            int(self.rejection_type),
            self.key,
            self.source_record_position,
            self.timestamp if timestamp is None else timestamp,
            self.request_stream_id,
            self.request_id,
            self.operation_reference,
            len(reason),
        )
        return b"".join((header, reason, struct.pack("<I", len(body)), body)), body

    @classmethod
    def from_bytes(cls, data: bytes, position: int = NO_POSITION, partition_id: int = 0,
                   timestamp: int | None = None) -> "Record":
        """``timestamp`` (when given) overrides the frame's timestamp field —
        the batch framing stamps one timestamp per batch, and passing it here
        avoids a per-record replace() on the decode path."""
        try:
            return cls._from_bytes(data, position, partition_id, timestamp)
        except (struct.error, UnicodeDecodeError, msgpack.MsgPackError,
                KeyError) as exc:
            # KeyError: unknown enum value in the frame header (lookup tables)
            raise ValueError(f"malformed record frame: {exc}") from exc

    @classmethod
    def _from_bytes(cls, data: bytes, position: int, partition_id: int,
                    timestamp_override: int | None = None) -> "Record":
        # one native call parses the fixed header, the rejection reason, and
        # the msgpack body together (native/codec.c decode_record_frame);
        # _py_decode_frame is the pure-Python fallback with identical output
        (
            record_type,
            value_type,
            intent_val,
            rejection_type,
            key,
            source_pos,
            timestamp,
            request_stream_id,
            request_id,
            operation_reference,
            reason,
            value,
        ) = _decode_frame(data)
        # dict lookups instead of Enum.__call__ (4 enum constructions per
        # record add up on the log-scan hot path)
        vt = _VT_BY_VALUE[value_type]
        intent = _INTENT_BY_VT[value_type][intent_val]
        return cls(
            record_type=_RT_BY_VALUE[record_type],
            value_type=vt,
            intent=intent,
            value=value,
            key=key,
            position=position,
            source_record_position=source_pos,
            timestamp=timestamp if timestamp_override is None else timestamp_override,
            partition_id=partition_id,
            rejection_type=_REJ_BY_VALUE[rejection_type],
            rejection_reason=reason,
            request_stream_id=request_stream_id,
            request_id=request_id,
            operation_reference=operation_reference,
        )

    # -- JSON view (reference: protocol-jackson) -----------------------------

    def to_json_dict(self) -> dict[str, Any]:
        """Camel-case JSON view matching the reference's Record JSON shape."""
        return {
            "position": self.position,
            "sourceRecordPosition": self.source_record_position,
            "key": self.key,
            "timestamp": self.timestamp,
            "recordType": self.record_type.name,
            "valueType": self.value_type.name,
            "intent": self.intent.name,
            "partitionId": self.partition_id,
            "rejectionType": self.rejection_type.name,
            "rejectionReason": self.rejection_reason,
            "operationReference": self.operation_reference,
            "value": dict(self.value),
        }


_FIELDS = tuple(f.name for f in dataclasses.fields(Record))
_FIELD_INDEX = {name: i for i, name in enumerate(_FIELDS)}


def command(value_type: ValueType, intent: Intent, value: Mapping[str, Any], **kw: Any) -> Record:
    return Record(RecordType.COMMAND, value_type, intent, value, **kw)


def event(value_type: ValueType, intent: Intent, value: Mapping[str, Any], **kw: Any) -> Record:
    return Record(RecordType.EVENT, value_type, intent, value, **kw)


def rejection(
    cmd: Record, rejection_type: RejectionType, reason: str, position: int = NO_POSITION
) -> Record:
    """Build the COMMAND_REJECTION record answering ``cmd``."""
    return Record(
        record_type=RecordType.COMMAND_REJECTION,
        value_type=cmd.value_type,
        intent=cmd.intent,
        value=cmd.value,
        key=cmd.key,
        position=position,
        source_record_position=cmd.position,
        partition_id=cmd.partition_id,
        rejection_type=rejection_type,
        rejection_reason=reason,
        request_stream_id=cmd.request_stream_id,
        request_id=cmd.request_id,
        operation_reference=cmd.operation_reference,
    )
