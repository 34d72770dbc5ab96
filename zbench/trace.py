"""The device half of a traced run: a ``torch.profiler`` session over the
window (CUDA activity, which CUPTI records from every thread that launches
work) and its reduction to the numbers the metrics read: the union of the
device's busy intervals, each device operation's time and count, and the
longest gaps between device operations."""

from __future__ import annotations

import json
import os
import tempfile
import time

#: trace categories of work that occupies the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """Start before the window opens, ``stop`` when it closes."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.started = time.monotonic()
        self.window_s = 0.0

    def stop(self) -> dict:
        """The reduced trace (see :func:`reduce`)."""
        self._prof.__exit__(None, None, None)
        self.window_s = time.monotonic() - self.started
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return reduce(events, self.window_s)


def reduce(events: list[dict], window_s: float) -> dict:
    """From chrome-trace events: ``busy_s`` (the union of device intervals),
    ``window_s``, ``ops`` (name -> [seconds, count]) and ``gaps`` (the
    longest idle stretches between device operations, as [label, seconds],
    labelled by the operations on either side)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    ops: dict[str, list] = {}
    busy_us = 0.0
    gaps: list[tuple[float, str]] = []
    end, last_name = None, None
    for start, stop, name in spans:
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (stop - start) / 1e6
        entry[1] += 1
        if end is None or start >= end:
            if end is not None:
                gaps.append((start - end, f"after {last_name} before {name}"))
            busy_us += stop - start
            end, last_name = stop, name
        elif stop > end:
            busy_us += stop - end
            end, last_name = stop, name
    gaps.sort(reverse=True)
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "ops": ops,
            "gaps": [[label, us / 1e6] for us, label in gaps[:10]]}
