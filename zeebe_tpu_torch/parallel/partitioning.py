"""Partition routing: correlation-key hashing + inter-partition command sender.

Reference: engine/…/message/command/SubscriptionCommandSender.java:43 +
SubscriptionUtil (correlation-key hash → partition), broker/…/partitionapi/
InterPartitionCommandSenderImpl.java:27-80 (topic "inter-partition-<id>"),
and the test-side TestInterPartitionCommandSender that loops sends back into
sibling in-process streams (SURVEY.md §4: the primary multi-node harness).
"""

from __future__ import annotations

from typing import Callable, Protocol

from zeebe_tpu_torch.protocol import Record
from zeebe_tpu_torch.protocol.keys import START_PARTITION_ID


def subscription_partition_id(correlation_key: str, partition_count: int) -> int:
    """Stable hash routing a correlation key to its message partition
    (reference: SubscriptionUtil.getSubscriptionPartitionId)."""
    h = 0
    for b in correlation_key.encode("utf-8"):
        h = (h * 31 + b) & 0x7FFFFFFF
    return START_PARTITION_ID + (h % partition_count)


class InterPartitionCommandSender(Protocol):
    """Ships a command record to another partition's log (at-least-once;
    receivers must deduplicate by key / state checks)."""

    def send_command(self, receiver_partition_id: int, record: Record) -> None: ...


class LoopbackCommandSender:
    """Single-partition deployment: inter-partition sends loop back into the
    local log (exactly what happens when sender == receiver in the reference)."""

    def __init__(self, write_local: Callable[[Record], None]) -> None:
        self._write_local = write_local

    def send_command(self, receiver_partition_id: int, record: Record) -> None:
        self._write_local(record)


class InProcessClusterSender:
    """Multi-partition in-process cluster: delivers into sibling partition
    logs synchronously (the TestInterPartitionCommandSender harness role).
    Registration happens as partitions boot."""

    def __init__(self) -> None:
        self._writers: dict[int, Callable[[Record], None]] = {}
        self.sent: list[tuple[int, Record]] = []

    def register(self, partition_id: int, write: Callable[[Record], None]) -> None:
        self._writers[partition_id] = write

    def send_command(self, receiver_partition_id: int, record: Record) -> None:
        self.sent.append((receiver_partition_id, record))
        writer = self._writers.get(receiver_partition_id)
        if writer is None:
            raise KeyError(f"no partition {receiver_partition_id} registered")
        writer(record.replace(partition_id=receiver_partition_id))
