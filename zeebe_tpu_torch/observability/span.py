"""Span model + bounded collector for the distributed-tracing subsystem.

Reference shape: Dapper (Sigelman et al., 2010) spans with Canopy-style
(Kaldor et al., SOSP '17) end-to-end latency attribution. The reference
broker has no tracing at all (SURVEY §5.1) — its only latency story is
per-actor metrics; this module is the span substrate the rest of
``zeebe_tpu_torch.observability`` builds on.

Design constraints:

- **Bounded**: the collector is a per-process ring buffer (``deque`` with a
  ``maxlen``) — tracing can never grow memory without bound, the oldest spans
  simply fall off.
- **Deterministic**: the sampler's keep/drop decision is a pure function of
  (seed, trace id), so a chaos run replayed from its seed samples the exact
  same traces and the span stream is reproducible.
- **Cheap**: ``Span`` is a plain ``__slots__`` class (no dataclass machinery
  on the hot path) and the sampler is one crc32 over a short key.

Exports open directly in Perfetto / ``chrome://tracing`` via the Chrome
trace-event JSON format (one complete-event ``"ph": "X"`` per span), or as
JSONL for ad-hoc tooling.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import zlib
from typing import Iterable


class Span:
    """One timed operation. ``trace_id`` groups the spans of one causal
    chain (for record lineage: ``"<partition>:<root command position>"``);
    ``parent`` names the parent span within the trace (span granularity is
    coarse enough here that a name, not an id, disambiguates)."""

    __slots__ = ("trace_id", "name", "start_us", "dur_us", "partition_id",
                 "parent", "attrs")

    def __init__(self, trace_id: str, name: str, start_us: int, dur_us: int,
                 partition_id: int = 0, parent: str = "",
                 attrs: dict | None = None) -> None:
        self.trace_id = trace_id
        self.name = name
        self.start_us = start_us
        self.dur_us = dur_us
        self.partition_id = partition_id
        self.parent = parent
        self.attrs = attrs

    def to_dict(self) -> dict:
        out = {
            "traceId": self.trace_id,
            "name": self.name,
            "startUs": self.start_us,
            "durUs": self.dur_us,
            "partitionId": self.partition_id,
        }
        if self.parent:
            out["parent"] = self.parent
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class DeterministicSampler:
    """Head-based sampling whose decision is a pure function of
    (seed, trace id): crc32 over the seeded key against a rate threshold.
    Same seed + same trace ids ⇒ same sampled set, run after run — the
    property that keeps seeded chaos runs replayable with tracing on."""

    def __init__(self, seed: int = 0, rate: float = 1.0) -> None:
        self.seed = seed
        self.rate = max(0.0, min(1.0, rate))
        self._all = self.rate >= 1.0
        self._none = self.rate <= 0.0
        self._threshold = int(self.rate * 0x1_0000_0000)
        self._seed_crc = zlib.crc32(str(seed).encode("ascii"))

    def sampled(self, trace_id: str) -> bool:
        if self._all:
            return True
        if self._none:
            return False
        return zlib.crc32(trace_id.encode("utf-8"),
                          self._seed_crc) < self._threshold


class SpanCollector:
    """Bounded per-process span ring buffer. Adds take the lock — the
    ``emitted`` counter is a read-modify-write and ``resize`` swaps the
    deque, so a lock-free add could undercount or land a span on an
    orphaned buffer. The lock is only paid for spans that survived the
    enabled + sampled guards. ``emitted`` counts every span ever added —
    ``emitted - len(self)`` is the number the ring has already evicted."""

    def __init__(self, capacity: int = 16384) -> None:
        self.capacity = capacity
        self._spans: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.emitted = 0

    def add(self, span: Span) -> None:
        with self._lock:
            self.emitted += 1
            self._spans.append(span)

    def __len__(self) -> int:
        return len(self._spans)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.emitted = 0

    def resize(self, capacity: int) -> None:
        with self._lock:
            self.capacity = capacity
            self._spans = collections.deque(self._spans, maxlen=capacity)

    # -- export ---------------------------------------------------------------

    def to_jsonl(self, path) -> int:
        """One span JSON object per line; returns the number written."""
        spans = self.snapshot()
        with open(path, "w") as f:
            for span in spans:
                f.write(json.dumps(span.to_dict()))
                f.write("\n")
        return len(spans)

    def chrome_trace(self) -> dict:
        return chrome_trace(self.snapshot())

    def write_chrome_trace(self, path) -> int:
        spans = self.snapshot()
        with open(path, "w") as f:
            json.dump(chrome_trace(spans), f)
            f.write("\n")
        return len(spans)


def chrome_trace(spans: Iterable[Span]) -> dict:
    """Chrome trace-event JSON (the format Perfetto and ``chrome://tracing``
    open directly): one complete event per span, process = partition, one
    thread lane per trace id so a trace's spans stack together visually."""
    tids: dict[str, int] = {}
    events = []
    for span in spans:
        tid = tids.get(span.trace_id)
        if tid is None:
            tid = len(tids) + 1
            tids[span.trace_id] = tid
        args = {"traceId": span.trace_id}
        if span.parent:
            args["parent"] = span.parent
        if span.attrs:
            args.update(span.attrs)
        events.append({
            "name": span.name,
            "cat": "zeebe",
            "ph": "X",
            "ts": span.start_us,
            "dur": max(span.dur_us, 1),
            "pid": span.partition_id,
            "tid": tid,
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "zeebe_tpu_torch.observability"},
    }


def now_us() -> int:
    return int(time.time() * 1e6)
