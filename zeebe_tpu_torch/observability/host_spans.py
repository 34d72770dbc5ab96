"""The port's own span helpers: the span clock for work timed with
``time.perf_counter``, and the interpreter's full collections as spans.

**The clock.** Spans carry their start on ``span.now_us()``: the wall clock
(CLOCK_REALTIME) in microseconds. ``torch.profiler`` writes its trace on
the same clock, as ``baseTimeNanoseconds`` plus each event's ``ts``
(microseconds), CUDA activity included, so a span and a device operation
lie on one time axis once the trace's base is added
(``tests/test_torch_span_clock.py`` holds both on the CPU and on the card).
Work timed with ``perf_counter`` is placed on that clock by
:func:`clock_offset_us`: the two clocks' difference, read once per
emission, added to each stamp.

**Collections.** ``runtime.gc`` is each generation-2 collection, which stops
every thread of the process. A ``gc.callbacks`` hook (:data:`GC`) stamps
each one's start and end; ``Tracer.enable`` installs it and
``Tracer.disable`` removes it, so it costs nothing while tracing is off.
The hook takes no lock: a collection can start on a thread that holds the
span collector's lock, which is not reentrant, so the hook only appends
to a bounded deque (one atomic append), and :func:`drain_gc` emits what
it holds as spans outside the callback: at each traced kernel group, and
wherever spans are taken.
"""

from __future__ import annotations

import collections
import gc
import time

from zeebe_tpu_torch.observability.span import now_us

#: trace id of the process-wide spans (no command's, no partition's)
GC_TRACE_ID = "infra:gc"
#: pauses the hook holds at most between drains (the oldest fall off)
GC_SLOT_CAPACITY = 4096


def clock_offset_us() -> float:
    """Microseconds to add to a ``perf_counter`` stamp (in microseconds) to
    place it on the span clock: ``int(t * 1e6 + offset)``."""
    return now_us() - time.perf_counter() * 1e6


class GcPauses:
    """The ``gc.callbacks`` hook: each generation-2 collection as (start,
    end, objects collected) in perf_counter seconds, in a bounded deque."""

    def __init__(self) -> None:
        self.pending: collections.deque[tuple[float, float, int]] = collections.deque(
            maxlen=GC_SLOT_CAPACITY)
        self._started = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._started = time.perf_counter()
        else:
            self.pending.append((self._started, time.perf_counter(),
                                 info.get("collected", 0)))

    def install(self) -> None:
        """Hook into the collector (once); pauses from before are dropped."""
        self.pending.clear()
        if self not in gc.callbacks:
            gc.callbacks.append(self)

    def remove(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)


#: the process's hook (``Tracer.enable`` installs it)
GC = GcPauses()


def drain_gc(tracer) -> int:
    """Emit each collection the hook holds as a ``runtime.gc`` span at its
    real interval; returns how many. Never call it from the hook."""
    pending = GC.pending
    if not pending:
        return 0
    offset = clock_offset_us()
    n = 0
    while pending:
        try:
            start, end, collected = pending.popleft()
        except IndexError:  # another thread drained the last one
            break
        tracer.emit(GC_TRACE_ID, "runtime.gc", end - start,
                    attrs={"collected": collected}, start_us=int(start * 1e6 + offset))
        n += 1
    return n
