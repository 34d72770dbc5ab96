"""At-rest storage scrubber: find bit rot before the read path trips on it
.

Detection-at-read (CRC checks on every journal/cold read, manifest checks at
recovery) bounds *served* corruption but leaves a window: a rotten frame is
only discovered when something reads it — possibly at the worst moment
(recovery, a leader transition, an exporter catching up). The scrubber
closes the window from the other side: a pump-throttled, byte-budgeted
background walk re-CRCs every at-rest artifact the partition owns —

- the **raft journal** (the replicated source of truth),
- the **stream journal** (the materialized committed prefix),
- the **snapshot chain** files (one file per slice, against the manifest),
- sealed **cold-store** segments (parked-instance frames),

— and on a mismatch immediately hands the finding to the partition's repair
seam for that target (truncate + re-converge, quarantine + re-snapshot /
re-fetch, DEGRADED + transition). Every pass, detection, and repair lands in
``zeebe_storage_scrub_*`` metrics, typed flight events, and the
``storageIntegrity`` block on partition ``/health`` (compact form on
``/cluster/status`` rows), plus a per-partition ``scrub-state.json``
evidence file the torture gate reads offline.

Honesty notes (also in docs/durability.md): scrubbing is *eventual* — rot
landing between the last pass and a read is caught at the read, not by the
scrubber; the walk covers drained file bytes (the pump thread is the only
writer, so the extent is race-free); and a repair that cannot complete yet
(no leader to re-fetch from, an idle partition that cannot take a newer
snapshot) leaves the partition DEGRADED until it can.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from collections import deque
from pathlib import Path
from typing import Callable

from zeebe_tpu_torch.state.snapshot import manifest_entries
from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

_M_SCANNED = _REG.counter(
    "storage_scrub_scanned_bytes_total",
    "bytes re-CRCed by the at-rest storage scrubber", ("partition",))
_M_PASSES = _REG.counter(
    "storage_scrub_passes_total",
    "completed full scrub cycles over every target", ("partition",))
_M_CORRUPTIONS = _REG.counter(
    "storage_scrub_corruptions_total",
    "at-rest corruptions detected (by scrub or read path)",
    ("partition", "target"))
_M_REPAIRS = _REG.counter(
    "storage_scrub_repairs_total",
    "storage repairs executed (truncate/quarantine/refetch/transition)",
    ("partition", "target"))

#: target walk order; one target slice per pump pass
TARGETS = ("raft", "stream", "snapshot", "cold")


@dataclasses.dataclass
class ScrubCfg:
    """Knobs (env: ``ZEEBE_BROKER_DATA_SCRUB*``, broker/config.py)."""

    enabled: bool = True
    #: minimum ms between scrub slices (pump-throttle)
    interval_ms: int = 1_000
    #: byte budget per slice (bounds pump stall per pass)
    bytes_per_pass: int = 4 << 20


class StorageScrubber:
    """One partition's scrubber. Pump-thread only (every walk shares the
    storage owners' single-writer discipline). Holds resumable cursors per
    target and bounded detection/repair evidence rings."""

    def __init__(self, partition, cfg: ScrubCfg,
                 clock_millis: Callable[[], int]) -> None:
        self.partition = partition
        self.cfg = cfg
        self.clock_millis = clock_millis
        pid = str(partition.partition_id)
        self._m_scanned = _M_SCANNED.labels(pid)
        self._m_passes = _M_PASSES.labels(pid)
        self._target_i = 0
        self._raft_cursor = 0
        self._stream_cursor = 0
        self._cold_cursor = (0, 0)
        self._snapshot_queue: list[tuple[str, str]] = []  # (snap dir, file)
        # resumable intra-file CRC state for the snapshot walk
        self._snapshot_offset = 0
        self._snapshot_crc = 0
        self._last_run_ms = 0
        self._last_pass_ms: int | None = None
        self.scanned_bytes = 0
        self.full_passes = 0
        self.detections: deque = deque(maxlen=64)
        self.repairs: deque = deque(maxlen=64)
        #: unrepaired-corruption latch: set on detection, cleared when the
        #: repair for that target reports completion
        self.pending_repair: dict | None = None
        self._evidence_path = Path(partition.directory) / "scrub-state.json"
        self._last_evidence_ms = 0

    # -- public accounting (read by /health, the repair seams, torture) --------

    def note_corruption(self, target: str, detail: dict,
                        source: str = "scrub") -> None:
        """Record a detection — from a scrub walk OR a read path that
        tripped first (one evidence home for both detectors)."""
        pid = str(self.partition.partition_id)
        _M_CORRUPTIONS.labels(pid, target).inc()
        event = {"target": target, "source": source,
                 "atMs": self.clock_millis(), **detail}
        self.detections.append(event)
        self.pending_repair = event
        flight = self.partition.flight
        if flight is not None:
            flight.record(self.partition.partition_id, "storage_corruption",
                          **event)
        self._write_evidence(force=True)

    def note_repair(self, target: str, action: str, detail: dict,
                    complete: bool = True) -> None:
        pid = str(self.partition.partition_id)
        _M_REPAIRS.labels(pid, target).inc()
        event = {"target": target, "action": action, "complete": complete,
                 "atMs": self.clock_millis(), **detail}
        self.repairs.append(event)
        if complete:
            self.pending_repair = None
        flight = self.partition.flight
        if flight is not None:
            flight.record(self.partition.partition_id, "storage_repair",
                          **event)
            flight.dump(f"storage-repair:partition-{pid}")
        self._write_evidence(force=True)

    def status(self) -> dict:
        """The ``storageIntegrity`` block for partition ``/health``."""
        return {
            "status": "DEGRADED" if self.pending_repair is not None
                      else "HEALTHY",
            "scannedBytes": self.scanned_bytes,
            "fullPasses": self.full_passes,
            "lastFullPassMs": self._last_pass_ms,
            "corruptionsDetected": len(self.detections),
            "repairs": len(self.repairs),
            **({"pendingRepair": self.pending_repair}
               if self.pending_repair is not None else {}),
            "lastDetections": list(self.detections)[-5:],
            "lastRepairs": list(self.repairs)[-5:],
        }

    # -- the pump hook ---------------------------------------------------------

    def maybe_run(self, now_ms: int | None = None) -> int:
        now = self.clock_millis() if now_ms is None else now_ms
        if now - self._last_run_ms < self.cfg.interval_ms:
            return 0
        self._last_run_ms = now
        target = TARGETS[self._target_i]
        scanned = 0
        try:
            if target == "raft":
                scanned = self._scrub_journal(
                    self.partition.raft.journal, "raft")
            elif target == "stream":
                scanned = self._scrub_journal(
                    self.partition.stream_journal, "stream")
            elif target == "snapshot":
                scanned = self._scrub_snapshots()
            else:
                scanned = self._scrub_cold()
        except Exception:  # noqa: BLE001 — the scrubber must never take
            # the pump down; an unrepairable fault already latched FAILED /
            # DEGRADED through the repair seam's own containment
            import logging

            logging.getLogger("zeebe_tpu_torch.broker.scrubber").exception(
                "scrub slice for %s failed on partition %s", target,
                self.partition.partition_id)
        finally:
            # a repair seam raising out of a slice must not wedge the
            # rotation on one target forever
            self._advance_target(target)
        if scanned:
            self.scanned_bytes += scanned
            self._m_scanned.inc(scanned)
        self._write_evidence()
        # a pending repair retries once per cycle (e.g. a follower waiting
        # for a leader to re-fetch its snapshot from)
        pending = self.pending_repair
        if pending is not None and pending.get("target") == "snapshot" \
                and self._target_i == 0:
            self.partition.repair_snapshot_corruption(pending)
        return 1 if scanned else 0

    def _advance_target(self, target: str) -> None:
        self._target_i = (self._target_i + 1) % len(TARGETS)
        if self._target_i == 0 and target == TARGETS[-1]:
            self.full_passes += 1
            self._last_pass_ms = self.clock_millis()
            self._m_passes.inc()

    # -- per-target walks ------------------------------------------------------

    def _scrub_journal(self, journal, target: str) -> int:
        cursor = self._raft_cursor if target == "raft" else self._stream_cursor
        next_index, scanned, corrupt = journal.scrub(
            cursor, self.cfg.bytes_per_pass)
        if next_index > journal.last_index:
            next_index = 0  # wrapped: restart from the head next slice
        if target == "raft":
            self._raft_cursor = next_index
        else:
            self._stream_cursor = next_index
        if corrupt is not None:
            self.note_corruption(target, {
                "corruptIndex": corrupt, "directory": str(journal.dir)})
            if target == "raft":
                # the repair evidence flows back through raft's
                # storage_listener → note_repair (one evidence path whether
                # the scrubber or a live read found the rot)
                self.partition.raft.repair_journal_corruption()
            else:
                self.partition.repair_stream_corruption(corrupt)
        return scanned

    def _scrub_snapshots(self) -> int:
        store = self.partition.snapshot_store
        if not self._snapshot_queue:
            # refresh the work list: every persisted snapshot's manifest
            # entries, one (dir, file) pair per slice
            for snap in store.list_snapshots():
                entries = manifest_entries(snap.path)
                if entries is None:
                    self.note_corruption("snapshot", {
                        "snapshotId": str(snap.id),
                        "file": "CHECKSUM.sfv",
                        "reason": "manifest-unreadable"})
                    self.partition.repair_snapshot_corruption(
                        {"snapshotId": str(snap.id)})
                    return 0
                for name in entries:
                    self._snapshot_queue.append((str(snap.path), name))
            if not self._snapshot_queue:
                return 0
        scanned = 0
        while self._snapshot_queue and scanned < self.cfg.bytes_per_pass:
            dirname, name = self._snapshot_queue[-1]
            path = Path(dirname) / name
            expected = manifest_entries(Path(dirname))
            if expected is None or name not in expected:
                # snapshot purged/replaced since queueing — stale entry
                self._snapshot_queue.pop()
                self._snapshot_offset = 0
                self._snapshot_crc = 0
                continue
            # resumable incremental CRC: persisted snapshot files are
            # immutable, so the rolling crc survives across slices — the
            # byte budget bounds the pump stall even for a huge state.bin
            # (file_crc in one gulp would read it all on one slice)
            done = False
            actual: int | None = None
            try:
                with open(path, "rb") as f:
                    f.seek(self._snapshot_offset)
                    while scanned < self.cfg.bytes_per_pass:
                        chunk = f.read(min(
                            1 << 20, self.cfg.bytes_per_pass - scanned))
                        if not chunk:
                            done = True
                            actual = self._snapshot_crc & 0xFFFFFFFF
                            break
                        self._snapshot_crc = zlib.crc32(
                            chunk, self._snapshot_crc)
                        self._snapshot_offset += len(chunk)
                        scanned += len(chunk)
            except OSError:
                done = True  # vanished mid-walk: unreadable = mismatch
            if not done:
                break  # budget exhausted mid-file; resume next slice
            self._snapshot_queue.pop()
            self._snapshot_offset = 0
            self._snapshot_crc = 0
            if actual != expected[name]:
                snap_id = os.path.basename(dirname)
                self.note_corruption("snapshot", {
                    "snapshotId": snap_id, "file": name,
                    "path": str(path)})
                self.partition.repair_snapshot_corruption(
                    {"snapshotId": snap_id})
                break
        return scanned

    def _scrub_cold(self) -> int:
        db = self.partition.db
        cold = getattr(db, "cold", None)
        if cold is None:
            return 0
        cursor, scanned, corruption = cold.scrub(
            self._cold_cursor, self.cfg.bytes_per_pass)
        self._cold_cursor = cursor
        if corruption is not None:
            self._cold_cursor = (0, 0)
            self.note_corruption("cold", corruption)
            self.partition.repair_cold_corruption(
                f"at-rest cold corruption: {corruption}")
        return scanned

    # -- offline evidence (the torture checker reads this) ---------------------

    def _write_evidence(self, force: bool = False) -> None:
        now = time.time() * 1000.0
        if not force and now - self._last_evidence_ms < 1000:
            return
        self._last_evidence_ms = now
        payload = {
            "partitionId": self.partition.partition_id,
            "pid": os.getpid(),
            **self.status(),
            "detections": list(self.detections),
            "repairs": list(self.repairs),
        }
        try:
            tmp = self._evidence_path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(payload), encoding="utf-8")
            os.replace(tmp, self._evidence_path)
        except OSError:  # pragma: no cover — evidence is best-effort
            pass
