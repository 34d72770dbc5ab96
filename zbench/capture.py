"""The benchmark's exporter: every committed record each partition hands to
its exporters, kept for the judge in a compact form while the run goes.

The cluster loads it as the standalone loads any exporter, through the
broker's ``ZEEBE_BROKER_EXPORTERS_<ID>_CLASSNAME`` setting, and it
acknowledges what it has seen as any exporter does, so the log is
compacted after a snapshot as the system's defaults have it while the
judge still reads every record. A record is kept as a tuple of plain
numbers and strings (its value as canonical JSON), which the interpreter's
cycle collector does not walk."""

from __future__ import annotations

import json
import threading

from zeebe_tpu_torch.exporters.api import Exporter
from zeebe_tpu_torch.protocol.keys import decode_partition_id

#: the exporter's id in the broker's configuration
EXPORTER_ID = "zbench"
#: the environment that loads it
ENV = {f"ZEEBE_BROKER_EXPORTERS_{EXPORTER_ID.upper()}_CLASSNAME": "zbench.capture.Capture"}
#: records between two acknowledgements of the exported position
ACK_EVERY = 256

_lock = threading.Lock()
#: every exporter instance opened in this process, one per partition replica
#: and leadership term
OPENED: list["Capture"] = []


def canonical(value) -> str:
    """A record value as JSON with sorted keys, the same for equal values."""
    return json.dumps(value, sort_keys=True, separators=(",", ":"), default=repr)


class Capture(Exporter):
    def open(self, controller) -> None:
        super().open(controller)
        #: (position, source, processed, record type, value type, intent, key,
        #: value as canonical JSON) per record, in the order exported
        self.records: list[tuple] = []
        self._unacked = 0
        with _lock:
            OPENED.append(self)

    def export(self, logged) -> None:
        rec = logged.record
        self.records.append((logged.position, logged.source_position, logged.processed,
                             rec.record_type.name, rec.value_type.name, rec.intent.name,
                             rec.key, canonical(rec.value)))
        self._unacked += 1
        if self._unacked >= ACK_EVERY:
            self._unacked = 0
            self.controller.update_last_exported_position(logged.position)

    def partition(self) -> int | None:
        """The partition whose records this instance saw: the one that its
        process instances' keys name (a deployment's records carry the key
        of the partition that deployed it, so they do not tell)."""
        for r in self.records:
            if r[4] == "PROCESS_INSTANCE" and r[6] >= 0:
                return decode_partition_id(r[6])
        return None


def reset() -> None:
    with _lock:
        OPENED.clear()


def last_positions() -> dict[int, int]:
    """Partition -> the highest position any of its exporters has seen."""
    out: dict[int, int] = {}
    for capture in list(OPENED):
        pid = capture.partition()
        if pid is not None and capture.records:
            out[pid] = max(out.get(pid, -1), capture.records[-1][0])
    return out


def logs() -> dict[int, list[dict]]:
    """Partition -> its records in position order, each once, as the
    judge reads them (``value`` parsed back from its JSON)."""
    merged: dict[int, dict[int, tuple]] = {}
    for capture in list(OPENED):
        pid = capture.partition()
        if pid is None:
            continue
        into = merged.setdefault(pid, {})
        for r in capture.records:
            into.setdefault(r[0], r)
    return {pid: [{"position": r[0], "source": r[1], "processed": r[2], "recordType": r[3],
                   "valueType": r[4], "intent": r[5], "key": r[6], "value": json.loads(r[7])}
                  for _, r in sorted(records.items())]
            for pid, records in merged.items()}
