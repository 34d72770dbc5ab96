"""The arithmetic of the end-to-end metrics, on the closed loop's stamps
(seconds on one monotonic clock), and what a run prints beside them to
split its spread: the rate in slices of the window and the interpreter's
full collections inside it."""

from __future__ import annotations

import gc
import math
import time

#: the slice of the window the rate is printed for
SLICE_S = 5.0


def percentile(ordered: list, q: float) -> float:
    """Nearest-rank percentile (rank = ceil(q*n)) over an ASCENDING list,
    0 < q <= 1; a copy of the port's ``testing/evidence.percentile``. Empty
    input yields 0.0."""
    if not ordered:
        return 0.0
    rank = max(math.ceil(q * len(ordered)) - 1, 0)
    return float(ordered[min(rank, len(ordered) - 1)])


def end_to_end(instances, creates, t_open: float, t_close: float) -> dict:
    """The window's end-to-end numbers.

    ``instances``: (send, reply, end) per instance, ``end`` None for one
    that never ended; ``creates``: (send, reply) per create. An instance
    counts where it ended inside the window, a create where it was sent
    inside it; latencies run from the send."""
    seconds = t_close - t_open
    ended = sorted(end - send for send, _, end in instances
                   if end is not None and t_open <= end < t_close)
    created = sorted(reply - send for send, reply in creates if t_open <= send < t_close)
    return {"instances_per_s": len(ended) / seconds,
            "instance_p95_ms": 1e3 * percentile(ended, 0.95),
            "create_p95_ms": 1e3 * percentile(created, 0.95),
            "instances": len(ended), "creates": len(created)}


def rate_per_slice(ends: list[float], t_open: float, t_close: float,
                   slice_s: float = SLICE_S) -> list[float]:
    """Instances ended per second in each whole ``slice_s`` of the window."""
    n = int((t_close - t_open) // slice_s)
    counts = [0] * n
    for end in ends:
        i = int((end - t_open) // slice_s)
        if t_open <= end and i < n:
            counts[i] += 1
    return [c / slice_s for c in counts]


class CollectorPauses:
    """The interpreter's full (generation 2) collections from now until
    :meth:`stop`: how many, their seconds and the longest."""

    def __init__(self) -> None:
        self.count, self.seconds, self.longest = 0, 0.0, 0.0
        self._started = None
        gc.callbacks.append(self._observe)

    def _observe(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._started = time.perf_counter()
        elif self._started is not None:
            pause = time.perf_counter() - self._started
            self._started = None
            self.count += 1
            self.seconds += pause
            self.longest = max(self.longest, pause)

    def stop(self) -> None:
        if self._observe in gc.callbacks:
            gc.callbacks.remove(self._observe)
