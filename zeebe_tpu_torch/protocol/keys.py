"""Partition-scoped key encoding.

Every entity key generated by a partition encodes the partition id in its high
bits so keys are globally unique and any node can route a key back to its owning
partition (reference: protocol/src/main/java/io/camunda/zeebe/protocol/Protocol.java
— KEY_BITS=51, partition id in bits 51..63).

Keys fit in a signed int64 so they can live in device arrays (jnp.int64) and in
the msgpack wire format without boxing.
"""

from __future__ import annotations

KEY_BITS = 51
PARTITION_BITS = 13
# Keys must stay positive in a signed int64 (device arrays are jnp.int64):
# 51 key bits + 12 usable partition bits + sign bit = 64. The 13-bit wire field
# is kept for format compatibility; ids >= 4096 are rejected at encode time.
MAX_PARTITION_ID = (1 << (PARTITION_BITS - 1)) - 1
KEY_MASK = (1 << KEY_BITS) - 1

# Start of the per-partition key space; key 0 is reserved as "no key".
START_PARTITION_ID = 1


def encode_partition_id(partition_id: int, key: int) -> int:
    """Pack (partition_id, local key counter) into a single int64 key."""
    if not 0 <= partition_id <= MAX_PARTITION_ID:
        raise ValueError(f"partition id out of range: {partition_id}")
    if not 0 <= key <= KEY_MASK:
        raise ValueError(f"key out of range: {key}")
    return (partition_id << KEY_BITS) | key


def decode_partition_id(key: int) -> int:
    """Recover the owning partition id from a key."""
    return (key >> KEY_BITS) & MAX_PARTITION_ID


def decode_key_in_partition(key: int) -> int:
    """Recover the partition-local counter from a key."""
    return key & KEY_MASK


class KeyGenerator:
    """Monotonically increasing per-partition key source (reference:
    stream-platform/…/state/DbKeyGenerator.java).

    The current value is engine state: it is persisted in the state store and
    restored on replay so processing and replay generate identical keys.
    """

    __slots__ = ("_partition_id", "_next")

    def __init__(self, partition_id: int, start: int = 1) -> None:
        self._partition_id = partition_id
        self._next = start

    def next_key(self) -> int:
        key = encode_partition_id(self._partition_id, self._next)
        self._next += 1
        return key

    @property
    def current(self) -> int:
        """Next local counter value to be assigned (for persistence)."""
        return self._next

    def set_current(self, value: int) -> None:
        """Jump the local counter (bulk mint: one jump stands for N
        next_key calls). Rejects values past the key space so a bulk range
        can never silently wrap into another partition's bits."""
        if not 0 <= value <= KEY_MASK:
            raise ValueError(f"key counter out of range: {value}")
        self._next = value

    def set_key_if_higher(self, key: int) -> None:
        """On replay: fast-forward past the highest key seen in events."""
        local = decode_key_in_partition(key)
        if decode_partition_id(key) == self._partition_id and local >= self._next:
            self._next = local + 1
