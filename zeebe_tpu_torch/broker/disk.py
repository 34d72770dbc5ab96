"""Disk-space monitor: pause ingestion when the data volume runs low.

Reference: broker/src/main/java/io/camunda/zeebe/broker/system/monitoring/
DiskSpaceUsageMonitorActor.java:22,57-72 — periodic free-space check against
the configured watermark; listeners pause command ingestion (and exporting)
while below it and resume once space frees up. Processing of already-committed
work continues so the log can compact itself back under the watermark.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Callable

from zeebe_tpu_torch.utils.zlogging import Loggers


class DiskSpaceMonitor:
    def __init__(self, directory: str | Path, min_free_bytes: int,
                 interval_ms: int = 10_000,
                 clock_millis: Callable[[], int] | None = None) -> None:
        import time

        self.directory = Path(directory)
        self.min_free_bytes = min_free_bytes
        self.interval_ms = interval_ms
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        self.out_of_space = False
        self._last_check_ms = 0
        self.listeners: list[Callable[[bool], None]] = []

    def free_bytes(self) -> int:
        """Free bytes on the data volume; -1 when the directory cannot be
        statted (vanished / unmounted mid-run) — the caller must treat that
        as out-of-space, not crash the tick loop."""
        try:
            return shutil.disk_usage(self.directory).free
        except OSError:
            Loggers.SYSTEM.exception(
                "disk usage check failed for %s — treating as out of space",
                self.directory)
            return -1

    def check(self, now_millis: int | None = None) -> bool:
        """Returns True when ingestion must pause. Rate-limited by interval."""
        now = self.clock_millis() if now_millis is None else now_millis
        if now - self._last_check_ms < self.interval_ms:
            return self.out_of_space
        self._last_check_ms = now
        below = self.free_bytes() < self.min_free_bytes
        if below != self.out_of_space:
            # flip the flag BEFORE notifying: a throwing listener must not
            # leave the monitor claiming the old state
            self.out_of_space = below
            for listener in self.listeners:
                try:
                    listener(below)
                except Exception:  # noqa: BLE001 — pause/resume must reach
                    # every remaining listener even if one throws
                    Loggers.SYSTEM.exception(
                        "disk-space listener failed (out_of_space=%s)", below)
        return self.out_of_space
