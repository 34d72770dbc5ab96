"""Hierarchical timer wheel: O(1) due-date scheduling at a million parked
timers.

Reference shape: Varghese & Lauck hashed hierarchical timing wheels — the
structure behind Kafka's purgatory and Netty's HashedWheelTimer. The engine's
due-date machinery (timers, message TTLs, job deadlines, job retry backoff)
previously derived "when is the next sweep?" by scanning four sorted state
indexes after every processing batch — each scan materialized the WHOLE
index, so a broker parking a million timers paid O(parked) per batch for the
privilege of learning that nothing is due for an hour.

The wheel is a **physical scheduling cache**, not state:

- it lives outside the column-family store, is rebuilt from the due-date
  indexes on every partition transition (one O(parked) pass at recovery,
  where recovery is already O(state)), and is fed afterwards by the
  ``ZbDb.note_due`` seam the state facades call on every deadline insert —
  on BOTH processing and replay, so a follower's wheel is warm at takeover;
- it only **over-approximates**: entries are never removed on cancel
  (a canceled timer costs one empty sweep when its slot comes due), and a
  rolled-back transaction's insert stays as a stale entry — the sweep
  re-verifies against the sorted state indexes (now range-bounded, O(due)),
  which remain the single source of truth;
- consequently it can never fire LATE: every real deadline was inserted
  through the seam or the rebuild scan, and ``next_due`` returns a time at
  or before the earliest real deadline.

Sweep cost is therefore O(due) and the next-due probe O(levels × slots)
(constant), independent of the parked backlog — the property the scale soak
gate measures (1k vs 100k parked timers within 2× per-sweep wall time).
"""

from __future__ import annotations

import heapq
from typing import Callable

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

_M_SCHEDULED = _REG.counter(
    "timer_wheel_scheduled_total",
    "deadline entries inserted into the hierarchical timer wheel",
    ("partition",))
_M_ENTRIES = _REG.gauge(
    "timer_wheel_entries",
    "deadline entries currently resident in the wheel (incl. lazy-canceled)",
    ("partition",))


class HierarchicalTimerWheel:
    """Multi-level circular timing wheel over absolute millisecond deadlines.

    ``levels`` rings of ``slots`` buckets each; level ``l`` buckets are
    ``tick_ms * slots**l`` wide, so the default (64ms × 64 slots × 4 levels)
    spans ~4.1s / ~4.4min / ~4.7h / ~12.4d; deadlines beyond the top span
    wait in an overflow heap and promote into the rings as time approaches.

    Only two mutations exist: ``schedule(due_ms)`` and ``advance(now_ms)``
    (drop passed deadlines, cascade entered higher-level buckets downward).
    ``next_due(now_ms)`` is a pure query. Entries are bare timestamps — the
    wheel schedules *sweeps*, the state indexes say what is actually due.
    """

    __slots__ = ("tick_ms", "slots", "levels", "_width", "_span",
                 "_slots", "_mins", "_overflow", "_now", "_count")

    def __init__(self, now_ms: int, tick_ms: int = 64, slots: int = 64,
                 levels: int = 4) -> None:
        self.tick_ms = max(1, int(tick_ms))
        self.slots = max(2, int(slots))
        self.levels = max(1, int(levels))
        self._width = [self.tick_ms * self.slots ** l
                       for l in range(self.levels)]
        self._span = [w * self.slots for w in self._width]
        self._slots: list[list[list[int]]] = [
            [[] for _ in range(self.slots)] for _ in range(self.levels)]
        # per-slot cached minimum (None = empty): next_due never scans a
        # 100k-entry storm bucket
        self._mins: list[list[int | None]] = [
            [None] * self.slots for _ in range(self.levels)]
        self._overflow: list[int] = []  # min-heap of far-future deadlines
        self._now = int(now_ms)
        self._count = 0

    def __len__(self) -> int:
        return self._count + len(self._overflow)

    # -- mutations -------------------------------------------------------------

    def schedule(self, due_ms: int) -> None:
        due_ms = int(due_ms)
        now = self._now
        delta = due_ms - now
        if delta >= self._span[-1]:
            heapq.heappush(self._overflow, due_ms)
            return
        if delta <= 0:
            # already due: park in the CURRENT level-0 bucket so the next
            # advance reports it and next_due sees it immediately
            lvl, idx = 0, (now // self._width[0]) % self.slots
        else:
            lvl = 0
            while delta >= self._span[lvl]:
                lvl += 1
            idx = (due_ms // self._width[lvl]) % self.slots
        self._slots[lvl][idx].append(due_ms)
        cur_min = self._mins[lvl][idx]
        if cur_min is None or due_ms < cur_min:
            self._mins[lvl][idx] = due_ms
        self._count += 1

    def advance(self, now_ms: int) -> int:
        """Move wheel time forward: drop deadlines ≤ ``now_ms`` (the caller's
        sweep covers them), cascade entered higher-level buckets down into
        finer rings. Returns the number of deadlines dropped."""
        now_ms = int(now_ms)
        if now_ms < self._now:
            return 0
        prev = self._now
        self._now = now_ms
        fired = 0
        carry: list[int] = []  # deadlines to re-place at finer levels
        for lvl in range(self.levels):
            w = self._width[lvl]
            start, end = prev // w, now_ms // w
            if lvl > 0 and start == end:
                break  # this ring's cursor didn't move; neither did coarser
            # walk at most one lap — past that every bucket flushed anyway
            first = max(start, end - self.slots + 1)
            for b in range(first, end + 1):
                idx = b % self.slots
                bucket = self._slots[lvl][idx]
                if not bucket:
                    continue
                keep: list[int] = []
                for due in bucket:
                    if due <= now_ms:
                        fired += 1
                        self._count -= 1
                    elif lvl == 0 and b == end:
                        keep.append(due)  # current fine bucket, later ms
                    else:
                        # entered coarse bucket: redistribute downward
                        self._count -= 1
                        carry.append(due)
                self._slots[lvl][idx] = keep
                self._mins[lvl][idx] = min(keep) if keep else None
        for due in carry:
            self.schedule(due)
        # promote overflow deadlines that now fit the top ring
        horizon = now_ms + self._span[-1]
        overflow = self._overflow
        while overflow and overflow[0] < horizon:
            self.schedule(heapq.heappop(overflow))
        return fired

    # -- queries ---------------------------------------------------------------

    def next_due(self, now_ms: int | None = None) -> int | None:
        """Earliest resident deadline, or None. Never later than the true
        earliest (the wheel only over-approximates)."""
        best: int | None = None
        for lvl in range(self.levels):
            # min over every bucket's cached minimum — NOT first-non-empty
            # in ring order: a deadline almost a full lap ahead shares a slot
            # index with the cursor, and stopping at that slot would report
            # it over a nearer deadline in a later slot (lap aliasing)
            for m in self._mins[lvl]:
                if m is not None and (best is None or m < best):
                    best = m
        if self._overflow:
            top = self._overflow[0]
            if best is None or top < best:
                best = top
        return best


class DueDateWheel:
    """The engine-facing wheel: one ``HierarchicalTimerWheel`` covering all
    four deadline kinds (timers, message TTLs, job deadlines, job retry
    backoff), rebuilt from the sorted due-date indexes at construction and
    fed afterwards through ``ZbDb.note_due``."""

    def __init__(self, clock_millis: Callable[[], int], partition_id: int = 0,
                 tick_ms: int = 64, slots: int = 64, levels: int = 4) -> None:
        self.clock_millis = clock_millis
        self.partition_id = partition_id
        self.wheel = HierarchicalTimerWheel(
            clock_millis(), tick_ms=tick_ms, slots=slots, levels=levels)
        self._m_scheduled = _M_SCHEDULED.labels(str(partition_id))
        self._m_entries = _M_ENTRIES.labels(str(partition_id))

    # the ZbDb.note_due seam target — hot path, keep it one call deep
    def note_due(self, due_ms: int) -> None:
        self.wheel.schedule(due_ms)
        self._m_scheduled.inc()

    def rebuild(self, engine_state) -> int:
        """One pass over the four due-date indexes (committed keys only — no
        transaction, no value materialization): the recovery-time rebuild.
        O(parked) once per transition, where recovery is already O(state)."""
        from zeebe_tpu_torch.engine.engine_state import _decode_two_i64
        from zeebe_tpu_torch.state import ColumnFamilyCode as CF

        db = engine_state.db
        n = 0
        for cf in (CF.TIMER_DUE_DATES, CF.MESSAGE_DEADLINES,
                   CF.JOB_DEADLINES, CF.JOB_BACKOFF):
            for enc_key in db.committed_keys_of(cf):
                self.wheel.schedule(_decode_two_i64(enc_key)[0])
                n += 1
        self._m_entries.set(float(len(self.wheel)))
        return n

    def next_due(self) -> int | None:
        return self.wheel.next_due()

    def advance(self, now_ms: int) -> int:
        fired = self.wheel.advance(now_ms)
        self._m_entries.set(float(len(self.wheel)))
        return fired
