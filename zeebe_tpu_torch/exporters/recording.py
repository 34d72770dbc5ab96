"""RecordingExporter: the behavioral-assertion test harness.

Reference: test-util/src/main/java/io/camunda/zeebe/test/util/record/
RecordingExporter.java:77 — every record written to the stream is captured and
tests assert on filtered record streams (``records().process_instance()
.with_intent(ELEMENT_COMPLETED).first()``). This is the parity oracle: the
same scenario run on the reference and here must produce equivalent streams.
"""

from __future__ import annotations

from typing import Callable, Iterator

from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import Record, RecordType, ValueType
from zeebe_tpu_torch.protocol.intent import Intent


class RecordStream:
    """Chainable filter over captured records."""

    def __init__(self, records: list[LoggedRecord]) -> None:
        self._records = records
        self._filters: list[Callable[[LoggedRecord], bool]] = []

    def _with(self, predicate: Callable[[LoggedRecord], bool]) -> "RecordStream":
        clone = RecordStream(self._records)
        clone._filters = self._filters + [predicate]
        return clone

    def with_value_type(self, value_type: ValueType) -> "RecordStream":
        return self._with(lambda r: r.record.value_type == value_type)

    def with_intent(self, intent: Intent) -> "RecordStream":
        return self._with(lambda r: r.record.intent == intent)

    def with_record_type(self, record_type: RecordType) -> "RecordStream":
        return self._with(lambda r: r.record.record_type == record_type)

    def events(self) -> "RecordStream":
        return self._with(lambda r: r.record.is_event)

    def commands(self) -> "RecordStream":
        return self._with(lambda r: r.record.is_command)

    def rejections(self) -> "RecordStream":
        return self._with(lambda r: r.record.is_rejection)

    def with_element_id(self, element_id: str) -> "RecordStream":
        return self._with(lambda r: r.record.value.get("elementId") == element_id)

    def with_element_type(self, element_type) -> "RecordStream":
        return self._with(lambda r: r.record.value.get("bpmnElementType") == element_type.name)

    def with_process_instance_key(self, key: int) -> "RecordStream":
        return self._with(lambda r: r.record.value.get("processInstanceKey") == key)

    def with_key(self, key: int) -> "RecordStream":
        return self._with(lambda r: r.record.key == key)

    def with_value(self, **fields) -> "RecordStream":
        return self._with(
            lambda r: all(r.record.value.get(k) == v for k, v in fields.items())
        )

    # terminals

    def __iter__(self) -> Iterator[LoggedRecord]:
        for rec in self._records:
            if all(f(rec) for f in self._filters):
                yield rec

    def to_list(self) -> list[LoggedRecord]:
        return list(self)

    def first(self) -> LoggedRecord:
        for rec in self:
            return rec
        raise AssertionError(f"no record matched (captured {len(self._records)} records)")

    def exists(self) -> bool:
        return next(iter(self), None) is not None

    def count(self) -> int:
        return sum(1 for _ in self)

    def intent_sequence(self) -> list[str]:
        """Intent names in stream order — the shape used in parity assertions."""
        return [r.record.intent.name for r in self]


class RecordingExporter:
    def __init__(self) -> None:
        self.records: list[LoggedRecord] = []

    def export(self, record: LoggedRecord) -> None:
        self.records.append(record)

    def clear(self) -> None:
        self.records.clear()

    # filtered views (naming mirrors the reference's static accessors)

    def all(self) -> RecordStream:
        return RecordStream(self.records)

    def process_instance_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.PROCESS_INSTANCE)

    def job_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.JOB)

    def job_batch_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.JOB_BATCH)

    def deployment_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.DEPLOYMENT)

    def process_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.PROCESS)

    def variable_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.VARIABLE)

    def incident_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.INCIDENT)

    def timer_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.TIMER)

    def message_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.MESSAGE)

    def signal_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.SIGNAL)

    def signal_subscription_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.SIGNAL_SUBSCRIPTION)

    def escalation_records(self) -> RecordStream:
        return self.all().with_value_type(ValueType.ESCALATION)
