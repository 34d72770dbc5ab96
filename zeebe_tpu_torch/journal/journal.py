"""Append-only segmented journal with checksummed framing.

The durable log under Raft and the log stream (reference: journal/src/main/java/io/
camunda/zeebe/journal/file/SegmentedJournal.java:34, SegmentedJournalWriter,
SegmentsManager, SparseJournalIndex, record/SBESerializer.java,
util/ChecksumGenerator.java, JournalMetaStore.java).

Design (host-side, file-per-segment):
- A journal is a directory of fixed-capacity segment files ``<name>-<id>.log``
  plus a ``meta`` file holding the last-flushed index.
- Each segment starts with a fixed header (magic, version, segment id, first
  index); records are framed as
  ``u32 length | u32 crc32c | u64 index | i64 asqn | data``.
- ``asqn`` (application sequence number) carries the record *position* assigned
  by the sequencer, enabling ``seek_to_asqn`` during recovery — exactly the
  reference's asqn contract (SegmentedJournal's JournalRecord.asqn).
- A sparse in-memory index (every Nth record) accelerates seeks.
- Corruption: a bad checksum or truncated frame on open truncates the journal at
  the last valid record (the reference's CorruptedJournalException/FrameUtil
  handling — data after a crash-torn write is discarded, consistent with Raft
  semantics where unflushed suffix entries were never acknowledged).

The hot append path is deliberately simple buffered-write + explicit flush so it
can later be swapped for the C++ implementation without contract changes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import struct
import zlib
from pathlib import Path
from typing import Callable, Iterator

from zeebe_tpu_torch.observability.host_spans import clock_offset_us
from zeebe_tpu_torch.observability.tracer import get_tracer as _get_tracer
from zeebe_tpu_torch.utils import storage_io
from zeebe_tpu_torch.utils.metrics import REGISTRY as _REGISTRY

# group-flush tracing (singleton mutated in place; one enabled-check per
# flush when tracing is off)
# copied from the reference: _TRACER .. _Segment
_TRACER = _get_tracer()

logger = logging.getLogger("zeebe_tpu_torch.journal")

# journal metrics (reference names: journal/ JournalMetrics —
# zeebe_journal_append_total, flush counts/latency); process-global because a
# journal only knows its directory, not its partition
_M_APPENDS = _REGISTRY.counter(
    "journal_append_total", "records appended across all journals")
_M_APPEND_RATE = _REGISTRY.counter(
    "journal_append_rate", "records appended (rate source)")
_M_APPEND_BYTES = _REGISTRY.counter(
    "journal_append_data_rate", "bytes appended (rate source)")
_M_APPEND_LATENCY = _REGISTRY.histogram(
    "journal_append_latency", "seconds per journal append")
_M_TRY_APPEND = _REGISTRY.counter(
    "try_to_append_total", "append attempts incl. rejected asqn")
_M_FLUSHES = _REGISTRY.counter(
    "journal_flush_total", "journal fsyncs across all journals")
_M_FLUSH_SECONDS = _REGISTRY.histogram(
    "journal_flush_duration_seconds", "time per journal fsync")
_M_FLUSH_TIME = _REGISTRY.histogram(
    "journal_flush_time", "time per journal fsync (reference name)")
_M_FAILED_FLUSH = _REGISTRY.counter(
    "failed_flush", "journal fsyncs that raised")
_M_OPEN_TIME = _REGISTRY.histogram(
    "journal_open_time", "seconds to open+scan a journal")
_M_SEEK_LATENCY = _REGISTRY.histogram(
    "journal_seek_latency", "seconds per random-access journal read/seek")
_M_SEGMENT_COUNT = _REGISTRY.gauge(
    "segment_count", "live segment files across all journals")
_M_SEGMENT_CREATION = _REGISTRY.histogram(
    "segment_creation_time", "seconds to roll/create a segment")
_M_SEGMENT_FLUSH = _REGISTRY.histogram(
    "segment_flush_time", "seconds to fsync one segment")
_M_SEGMENT_TRUNCATE = _REGISTRY.histogram(
    "segment_truncate_time", "seconds to truncate a segment")
_M_LAST_FLUSHED = _REGISTRY.gauge(
    "last_flushed_index_update", "last index recorded as flushed")
_M_COMPACTION_MS = _REGISTRY.histogram(
    "compaction_time_ms", "ms per journal compaction pass",
    buckets=(0.1, 0.5, 1, 5, 10, 50, 100, 1000))
_M_COMPACTION_CLAMPED = _REGISTRY.counter(
    "journal_compaction_clamped_total",
    "compaction requests clamped by the safety guard "
    "(min of snapshot position and exporter cursors)")
_M_SEGMENT_ALLOC = _REGISTRY.histogram(
    "segment_allocation_time", "seconds to allocate a new segment file")
_M_DRAINS = _REGISTRY.counter(
    "journal_buffer_drain_total",
    "group-commit write-buffer drains (one file write each)")
_M_DRAIN_BYTES = _REGISTRY.histogram(
    "journal_buffer_drain_bytes", "bytes per write-buffer drain",
    buckets=(1024, 4096, 16384, 65536, 262144, 1048576, 4194304))
# cached label-less children: the append path is hot, and Metric.inc() pays a
# lock + dict lookup per call that the child skips
_C_APPENDS = _M_APPENDS.labels()
_C_APPEND_RATE = _M_APPEND_RATE.labels()
_C_APPEND_BYTES = _M_APPEND_BYTES.labels()
_C_APPEND_LATENCY = _M_APPEND_LATENCY.labels()
_C_TRY_APPEND = _M_TRY_APPEND.labels()
_C_DRAINS = _M_DRAINS.labels()
_C_DRAIN_BYTES = _M_DRAIN_BYTES.labels()

# flight-recorder seam (observability/flight_recorder.py): listeners called
# with (directory, seconds) when a flush exceeds the stall threshold. Module
# level because a journal knows only its directory, not its partition; the
# empty-list common case costs one truthiness check per fsync (not per append)
SLOW_FLUSH_THRESHOLD_S = 0.25
slow_flush_listeners: list = []

from time import perf_counter as _perf

_MAGIC = 0x5A4A4E4C  # "ZJNL"
_VERSION = 1
_SEG_HEADER = struct.Struct("<IIQQ")  # magic, version, segment_id, first_index
_FRAME = struct.Struct("<IIQq")  # length, crc32, index, asqn
_SPARSE_EVERY = 64


class CorruptedJournalError(Exception):
    """Corruption detected on a read path (checksum mismatch, bad header).

    ``index`` (first corrupt record index, when known) and ``path`` (the
    segment file) let the storage-repair plane truncate at the
    corrupt frame and re-converge from a replica instead of crashing."""

    def __init__(self, message: str, index: int | None = None,
                 path: Path | None = None) -> None:
        super().__init__(message)
        self.index = index
        self.path = path


class FlushFailedError(OSError):
    """An fsync failed (fsyncgate,: the page cache state of the
    device is undefined, so the journal already failed the segment hard —
    closed the fd, reopened, and re-verified from the last known-flushed
    offset. Bytes covered by the failed fsync were discarded and MUST NOT
    count toward any acked prefix (the raft layer clamps its flushed index
    to ``journal.last_index`` on this error)."""


class InvalidAsqnError(Exception):
    """Append with an asqn that is not monotonically increasing."""


ASQN_IGNORE = -1


@dataclasses.dataclass(frozen=True, slots=True)
class JournalRecord:
    index: int
    asqn: int
    data: bytes


def _py_checksum(index: int, asqn: int, data: bytes) -> int:
    head = struct.pack("<Qq", index, asqn)
    return zlib.crc32(data, zlib.crc32(head)) & 0xFFFFFFFF


# native frame fast path (native/codec.c): _py_checksum above is the crc
# specification (tests assert equality); journal_frame builds the complete
# <IIQq>-framed record in one C pass — one allocation and one crc sweep per
# append instead of two zlib calls, two struct packs, and a bytes concat
from zeebe_tpu_torch import native as _native  # noqa: E402  (cycle-free leaf package)

_native_checksum = _native.codec_fn("journal_checksum")
_native_frame = _native.codec_fn("journal_frame")
_checksum = _native_checksum if _native_checksum is not None else _py_checksum


class _Segment:
    """One segment file: header + frames. Keeps an in-memory sparse index of
    (record index → file offset) for every ``_SPARSE_EVERY``-th record.

    Appends land in an in-memory write buffer (``_pending``) and reach the
    file in one bulk write per ``_drain()`` — interleaved per-append
    seek+write on a BufferedRandom thrashes its read buffer into a syscall
    per record (measured ~13% of e2e wall time), while group-commit drains
    pay one write per processed group. ``size`` is the LOGICAL size (file +
    pending); every read path drains first. ``durable_size`` tracks the
    fsync-covered prefix for power-loss simulation."""

    def __init__(self, path: Path, segment_id: int, first_index: int, create: bool) -> None:
        self.path = path
        self.segment_id = segment_id
        self.first_index = first_index
        self.last_index = first_index - 1
        self.last_asqn = ASQN_IGNORE
        self.sparse: list[tuple[int, int]] = []  # (index, offset)
        # (next_index, its_offset) after the last read_entry — log scans are
        # sequential, so most reads jump straight here
        self._read_hint: tuple[int, int] | None = None
        # file position tracker: -1 = unknown (a read moved it); the drain
        # only seeks when the position is not already at the file tail
        self._file_pos = -1
        self._pending: list[bytes] = []
        self._pending_bytes = 0
        if create:
            start = _perf()
            self.file = storage_io.open_file(path, "w+b")
            self.file.write(_SEG_HEADER.pack(_MAGIC, _VERSION, segment_id, first_index))
            self.file.flush()
            self.size = _SEG_HEADER.size
            self.durable_size = _SEG_HEADER.size
            _M_SEGMENT_ALLOC.observe(_perf() - start)
        else:
            self.file = storage_io.open_file(path, "r+b")
            self.size = _SEG_HEADER.size  # recomputed by scan()
            self.durable_size = _SEG_HEADER.size

    @classmethod
    def open_existing(cls, path: Path) -> "_Segment":
        with storage_io.open_file(path, "rb") as f:
            raw = f.read(_SEG_HEADER.size)
        if len(raw) < _SEG_HEADER.size:
            raise CorruptedJournalError(f"segment header truncated: {path}")
        magic, version, segment_id, first_index = _SEG_HEADER.unpack(raw)
        if magic != _MAGIC:
            raise CorruptedJournalError(f"bad segment magic in {path}: 0x{magic:08x}")
        if version != _VERSION:
            raise CorruptedJournalError(f"unsupported segment version {version} in {path}")
        return cls(path, segment_id, first_index, create=False)

    def scan(self) -> None:
        """Rebuild in-memory state from disk; truncate at first corrupt
        frame. Idempotent: a RE-scan (the repair path) resets the
        in-memory view first, so a walk that finds less than before (a
        mid-file corruption truncation) cannot leave stale last_index /
        last_asqn claims behind."""
        f = self.file
        self._pending.clear()
        self._pending_bytes = 0
        self._file_pos = -1
        self.last_index = self.first_index - 1
        self.last_asqn = ASQN_IGNORE
        f.seek(0, os.SEEK_END)
        file_len = f.tell()
        offset = _SEG_HEADER.size
        expected = self.first_index
        self.sparse.clear()
        self._read_hint = None
        mv = None
        f.seek(0)
        mv = memoryview(f.read())
        while offset + _FRAME.size <= file_len:
            length, crc, index, asqn = _FRAME.unpack_from(mv, offset)
            end = offset + _FRAME.size + length
            if length == 0 or end > file_len or index != expected:
                break
            data = bytes(mv[offset + _FRAME.size : end])
            if _checksum(index, asqn, data) != crc:
                break
            if (index - self.first_index) % _SPARSE_EVERY == 0:
                self.sparse.append((index, offset))
            self.last_index = index
            if asqn != ASQN_IGNORE:
                self.last_asqn = asqn
            expected += 1
            offset = end
        mv.release()
        if offset < file_len:
            # crash-torn or corrupt suffix: discard it
            f.truncate(offset)
            f.flush()
        self.size = offset
        self.durable_size = offset

    def append(self, index: int, asqn: int, data: bytes) -> None:
        # data may be any bytes-like object (the prepatched burst path hands
        # the writer's bytearray straight through); both paths below copy it
        # into an immutable pending frame synchronously, so the caller's
        # buffer is never aliased past this call
        if _native_frame is not None:
            self._pending.append(_native_frame(index, asqn, data))
        else:
            frame = _FRAME.pack(len(data), _checksum(index, asqn, data), index, asqn)
            self._pending.append(frame + data)
        self._pending_bytes += _FRAME.size + len(data)
        if (index - self.first_index) % _SPARSE_EVERY == 0:
            self.sparse.append((index, self.size))
        self.size += _FRAME.size + len(data)
        self.last_index = index
        if asqn != ASQN_IGNORE:
            self.last_asqn = asqn

    def _drain(self) -> None:
        """Write buffered appends to the file in one bulk write. Every read,
        fsync, truncation, and close goes through here first, so the file
        view is complete whenever anything other than append looks at it."""
        if not self._pending:
            return
        file_size = self.size - self._pending_bytes
        if self._file_pos != file_size:
            self.file.seek(file_size)
        # invalidate across the write: if it tears mid-way (ENOSPC), the next
        # drain must re-seek and overwrite the torn bytes
        self._file_pos = -1
        chunk = b"".join(self._pending)
        self.file.write(chunk)
        self._pending.clear()
        self._pending_bytes = 0
        self._file_pos = self.size
        _C_DRAINS.inc()
        _C_DRAIN_BYTES.observe(len(chunk))

    def _sparse_span(self, index: int) -> tuple[int, int]:
        """(start_offset, end_offset) of the sparse span holding ``index`` —
        O(1): record indexes are consecutive, so sparse entry k covers
        records [first_index + k*N, first_index + (k+1)*N)."""
        k = (index - self.first_index) // _SPARSE_EVERY
        if k < 0 or not self.sparse:
            return _SEG_HEADER.size, self.size
        k = min(k, len(self.sparse) - 1)
        start = self.sparse[k][1]
        end = self.sparse[k + 1][1] if k + 1 < len(self.sparse) else self.size
        return start, end

    def read_from(self, index: int) -> Iterator[JournalRecord]:
        """Yield records from ``index`` (clamped to first_index) to the end."""
        if index < self.first_index:
            index = self.first_index
        if index > self.last_index:
            return
        self._drain()
        offset, _ = self._sparse_span(index)
        self.file.seek(offset)
        self._file_pos = -1
        mv = memoryview(self.file.read(self.size - offset))
        pos = 0
        while pos + _FRAME.size <= len(mv):
            length, crc, rec_index, asqn = _FRAME.unpack_from(mv, pos)
            data = bytes(mv[pos + _FRAME.size : pos + _FRAME.size + length])
            pos += _FRAME.size + length
            if rec_index >= index:
                if _checksum(rec_index, asqn, data) != crc:
                    mv.release()
                    raise CorruptedJournalError(
                        f"checksum mismatch reading record {rec_index} in "
                        f"{self.path}", index=rec_index, path=self.path)
                yield JournalRecord(rec_index, asqn, data)
        mv.release()

    def read_entry(self, index: int) -> JournalRecord | None:
        """Read exactly one record by index (sparse-index seek + bounded walk),
        without materializing the rest of the segment."""
        if index < self.first_index or index > self.last_index:
            return None
        # sequential-read hint: log scans read index, index+1, … — the hint
        # jumps straight to the frame with no sparse walk at all; otherwise
        # the O(1) sparse floor bounds the walk to < _SPARSE_EVERY frames,
        # skipped header-by-header (seek past bodies, never reading them)
        hint = self._read_hint
        if hint is not None and hint[0] == index:
            offset = hint[1]
        else:
            offset, _ = self._sparse_span(index)
        f = self.file
        self._drain()
        self._file_pos = -1
        while offset < self.size:
            f.seek(offset)
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                return None
            length, crc, rec_index, asqn = _FRAME.unpack(head)
            if rec_index == index:
                data = f.read(length)
                if _checksum(rec_index, asqn, data) != crc:
                    raise CorruptedJournalError(
                        f"checksum mismatch reading record {rec_index} in "
                        f"{self.path}", index=rec_index, path=self.path)
                self._read_hint = (index + 1, offset + _FRAME.size + length)
                return JournalRecord(rec_index, asqn, data)
            offset += _FRAME.size + length
        return None

    def truncate_after(self, index: int) -> None:
        """Delete all records with index > ``index``."""
        if index >= self.last_index:
            return
        self._drain()
        offset = _SEG_HEADER.size
        new_last = self.first_index - 1
        new_asqn = ASQN_IGNORE
        for rec in self.read_from(self.first_index):
            if rec.index > index:
                break
            offset += _FRAME.size + len(rec.data)
            new_last = rec.index
            if rec.asqn != ASQN_IGNORE:
                new_asqn = rec.asqn
        start = _perf()
        self.file.truncate(offset)
        self.file.flush()
        self._file_pos = -1
        self.size = offset
        self.durable_size = min(self.durable_size, offset)
        self.last_index = new_last
        _M_SEGMENT_TRUNCATE.observe(_perf() - start)
        self.last_asqn = new_asqn
        self.sparse = [(i, o) for i, o in self.sparse if i <= new_last]
        self._read_hint = None

    def flush(self) -> None:
        start = _perf()
        self._drain()
        self.file.flush()
        try:
            storage_io.fsync(self.file.fileno(), self.path)
        except OSError as exc:
            # fsyncgate: after a failed fsync the page cache
            # state is UNDEFINED — retrying on the same fd can "succeed"
            # without the earlier dirty pages ever reaching the platter
            # (the PostgreSQL fsyncgate lesson). Fail the segment hard:
            # drop the fd, reopen, re-verify from the last known-flushed
            # offset; everything the failed fsync covered is discarded and
            # must never count toward an acked prefix.
            self._reopen_after_failed_fsync()
            raise FlushFailedError(
                exc.errno, f"fsync failed on {self.path}: {exc}") from exc
        self.durable_size = self.size
        _M_SEGMENT_FLUSH.observe(_perf() - start)

    def _reopen_after_failed_fsync(self) -> None:
        self._pending.clear()
        self._pending_bytes = 0
        try:
            self.file.close()
        except OSError:
            pass
        self.file = storage_io.open_file(self.path, "r+b")
        # bytes beyond the durable prefix may or may not have hit the
        # platter — truncate them away and re-verify what remains (scan
        # re-CRCs every frame and truncates at the first bad one)
        try:
            self.file.truncate(self.durable_size)
        except OSError:
            pass
        self.last_index = self.first_index - 1
        self.last_asqn = ASQN_IGNORE
        self.scan()

    def scrub(self, from_index: int, max_bytes: int) -> tuple[int, int, int | None]:
        """CRC-walk the drained file extent from ``from_index`` for up to
        ``max_bytes`` scrubber). Returns ``(next_index,
        scanned_bytes, corrupt_index)`` — ``next_index`` past this
        segment's end means the segment is clean through its extent. Never
        drains and never raises on corruption: detection is the caller's
        signal to repair. Runs on the pump thread (the only writer), so
        the extent is stable for the duration of the walk."""
        limit = self.size - self._pending_bytes
        if from_index < self.first_index:
            from_index = self.first_index
        offset, _ = self._sparse_span(from_index)
        f = self.file
        self._file_pos = -1
        scanned = 0
        index = from_index
        while offset < limit and scanned < max_bytes:
            f.seek(offset)
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                break
            length, crc, rec_index, asqn = _FRAME.unpack(head)
            end = offset + _FRAME.size + length
            if length == 0 or end > limit:
                # a torn frame inside the drained extent: corrupt from
                # here. The garbage header's rec_index is only trusted
                # when it is a plausible index for this segment — rotted
                # header bytes otherwise leak an arbitrary huge value into
                # the repair evidence
                plausible = (self.first_index <= rec_index
                             <= self.last_index + 1)
                return (self.last_index + 1, scanned,
                        rec_index if plausible else index)
            if rec_index >= from_index:
                data = f.read(length)
                scanned += _FRAME.size + length
                if _checksum(rec_index, asqn, data) != crc:
                    return self.last_index + 1, scanned, rec_index
                index = rec_index + 1
            offset = end
        return index, scanned, None

    def close(self) -> None:
        # clean shutdown: buffered appends reach the OS (matching the old
        # behavior where the file object's own buffer flushed on close)
        self._drain()
        self.file.close()

    def delete(self) -> None:
        self._pending.clear()  # no point writing out a file being unlinked
        self._pending_bytes = 0
        self.close()
        self.path.unlink(missing_ok=True)
# end of the copy


class SegmentedJournal:
    """The journal: ordered segments, append/read/seek/truncate/compact.

    Indexes are 1-based and contiguous; asqns are strictly increasing where
    provided (reference: SegmentedJournalWriter append validation).
    """

    def __init__(
        self,
        directory: str | Path,
        name: str = "journal",
        max_segment_size: int = 8 * 1024 * 1024,
        flush_interval: float | None = None,
        max_unflushed_bytes: int = 1 << 20,
        owner: tuple[int, str] | None = None,
    ) -> None:
        self.dir = Path(directory)
        # the (partition, member) whose journal this is, named on its flush
        # spans; None for a journal no partition owns
        self.owner = owner
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.max_segment_size = max_segment_size
        # group-commit knobs: appends buffer in memory and reach the file in
        # one write per drain (at ``max_unflushed_bytes``, or whenever a read
        # or fsync needs the file view); ``maybe_flush`` — called by the
        # stream processor at group boundaries — fsyncs only when
        # ``flush_interval`` seconds elapsed since the last fsync or the
        # unflushed backlog exceeds ``max_unflushed_bytes``. ``flush()``
        # itself stays an unconditional drain + fsync (Raft ack barriers).
        self.flush_interval = flush_interval
        self.max_unflushed_bytes = max_unflushed_bytes
        self._unflushed_bytes = 0
        self._last_flush_t = _perf()
        self._meta_path = self.dir / f"{name}.meta"
        self._meta_fd: int | None = None
        # compaction safety guard (broker/partition.py installs one): a
        # callable returning the max journal index (exclusive) compaction may
        # delete below — derived from min(snapshot position, all exporter
        # container cursors). compact() clamps to it; a guard failure fails
        # SAFE (no compaction this pass). None = unguarded (standalone
        # journals: tests, raft-internal resets).
        self.compact_guard: "Callable[[], int] | None" = None
        # async ack seam: called with the covered last index after
        # EVERY successful fsync — the pump-tail cadence flush, the idle
        # boundary, a backup barrier. Flush-gated consumers (the stream
        # processor's deferred client replies) release acks from here instead
        # of polling at the pump tail. Listeners are only ever invoked after
        # the fsync returned, so an acked prefix is a durable prefix by
        # construction; a failed fsync raises before this point and the
        # listeners stay silent.
        self.flush_listeners: list[Callable[[int], None]] = []
        self.segments: list[_Segment] = []
        # this journal's contribution to the global segment_count gauge —
        # updated by delta whenever the segment list changes, and returned
        # on close, so reopen cycles and resets can never drift the gauge
        self._counted_segments = 0
        # amortized append-metric accumulators (flushed by _flush_append_metrics)
        self._m_pending = 0
        self._m_pending_bytes = 0
        start = _perf()
        self._open_or_create()
        _M_OPEN_TIME.observe(_perf() - start)
        self._update_segment_gauge()

    # copied from the reference: _update_segment_gauge .. _roll_segment
    def _update_segment_gauge(self) -> None:
        n = len(self.segments)
        if n != self._counted_segments:
            _M_SEGMENT_COUNT.inc(n - self._counted_segments)
            self._counted_segments = n

    # -- lifecycle -----------------------------------------------------------

    def _segment_path(self, segment_id: int) -> Path:
        return self.dir / f"{self.name}-{segment_id}.log"

    def _open_or_create(self) -> None:
        paths = sorted(
            self.dir.glob(f"{self.name}-*.log"),
            key=lambda p: int(p.stem.rsplit("-", 1)[1]),
        )
        prev_last: int | None = None
        for path in paths:
            seg = _Segment.open_existing(path)
            seg.scan()
            if prev_last is not None and seg.first_index != prev_last + 1:
                # gap between segments: discard this and all later segments
                seg.delete()
                for later in paths[paths.index(path) + 1 :]:
                    later.unlink(missing_ok=True)
                break
            self.segments.append(seg)
            prev_last = seg.last_index
        if not self.segments:
            self.segments.append(_Segment(self._segment_path(1), 1, 1, create=True))
        # drop empty trailing segments except the first
        while len(self.segments) > 1 and self.segments[-1].last_index < self.segments[-1].first_index:
            self.segments.pop().delete()

    def close(self) -> None:
        self._flush_append_metrics()
        if self._counted_segments:
            _M_SEGMENT_COUNT.inc(-self._counted_segments)
            self._counted_segments = 0
        for seg in self.segments:
            seg.close()
        if self._meta_fd is not None:
            os.close(self._meta_fd)
            self._meta_fd = None

    # -- properties ----------------------------------------------------------

    @property
    def first_index(self) -> int:
        return self.segments[0].first_index

    @property
    def last_index(self) -> int:
        return self.segments[-1].last_index

    @property
    def last_asqn(self) -> int:
        for seg in reversed(self.segments):
            if seg.last_asqn != ASQN_IGNORE:
                return seg.last_asqn
        return ASQN_IGNORE

    def is_empty(self) -> bool:
        return self.last_index < self.first_index

    @property
    def unflushed_bytes(self) -> int:
        """Appended bytes not yet covered by an fsync (group-commit pacing
        reads this to decide when a deferred flush is due)."""
        return self._unflushed_bytes

    # -- write path ----------------------------------------------------------

    def append(self, data: bytes, asqn: int = ASQN_IGNORE) -> JournalRecord:
        """Append one record; returns it with its assigned index. ``data``
        may be any contiguous bytes-like object — it is copied into the
        segment's framed write buffer before this call returns, so passing a
        mutable buffer (the prepatched burst path) is safe; the returned
        record aliases the caller's object.

        Metric updates are amortized the way the reference's hot loops do:
        counts/bytes accumulate in plain ints and flush to the registry every
        64 appends (and on fsync/close), and the latency histogram sees a
        1-in-64 sample — per-append registry traffic would otherwise be a
        measurable share of the append itself."""
        if asqn != ASQN_IGNORE and asqn <= self.last_asqn:
            _C_TRY_APPEND.inc()
            raise InvalidAsqnError(f"asqn {asqn} <= last asqn {self.last_asqn}")
        sampled = (self._m_pending & 63) == 0
        start = _perf() if sampled else 0.0
        tail = self.segments[-1]
        if tail.size + _FRAME.size + len(data) > self.max_segment_size and tail.last_index >= tail.first_index:
            tail = self._roll_segment()
        index = tail.last_index + 1
        tail.append(index, asqn, data)
        self._unflushed_bytes += _FRAME.size + len(data)
        if tail._pending_bytes >= self.max_unflushed_bytes:
            try:
                tail._drain()
            except OSError:
                # transient write fault (EIO/ENOSPC/torn): the buffered
                # frames are KEPT and the next drain re-seeks over any torn
                # prefix — the append itself stays valid, and durability is
                # decided at flush() where a persistent error surfaces
                pass
        self._m_pending += 1
        self._m_pending_bytes += _FRAME.size + len(data)
        if sampled:
            _C_APPEND_LATENCY.observe(_perf() - start)
        elif self._m_pending >= 64:
            self._flush_append_metrics()
        return JournalRecord(index, asqn, data)

    def _flush_append_metrics(self) -> None:
        n = self._m_pending
        if n:
            self._m_pending = 0
            _C_APPENDS.inc(n)
            _C_APPEND_RATE.inc(n)
            _C_TRY_APPEND.inc(n)
            _C_APPEND_BYTES.inc(self._m_pending_bytes)
            self._m_pending_bytes = 0

    def _roll_segment(self) -> _Segment:
        start = _perf()
        prev = self.segments[-1]
        prev.flush()
        seg = _Segment(
            self._segment_path(prev.segment_id + 1),
            prev.segment_id + 1,
            prev.last_index + 1,
            create=True,
        )
        self.segments.append(seg)
        self._update_segment_gauge()
        _M_SEGMENT_CREATION.observe(_perf() - start)
        return seg
    # end of the copy

    def flush(self) -> int:
        """fsync the tail segment (the only one that can be dirty: rolling
        flushes the previous segment, and truncation makes the truncated
        segment the tail) and record the last flushed index (reference:
        JournalMetaStore last-flushed index). The meta write is advisory —
        recovery re-derives state from segment scans — so it is a plain
        8-byte overwrite, not an fsync'd rename, keeping the hot append path
        at one fsync per flush. The ``journal.flush`` span (the reference's)
        starts where the flush starts, ends before the flush listeners run,
        and names the journal's owner."""
        self._flush_append_metrics()
        covered_bytes = self._unflushed_bytes
        start = _perf()
        try:
            self.segments[-1].flush()
        except OSError:
            _M_FAILED_FLUSH.inc()
            raise
        idx = self.last_index
        self._write_flush_marker(max(idx, 0))
        self._unflushed_bytes = 0
        self._last_flush_t = _perf()
        _M_LAST_FLUSHED.set(max(idx, 0))
        _M_FLUSHES.inc()
        elapsed = _perf() - start
        _M_FLUSH_SECONDS.observe(elapsed)
        _M_FLUSH_TIME.observe(elapsed)
        if _TRACER.enabled:
            # group-flush span: the durability edge every gated ack waits on
            # (flushes are group-commit cadence, not per-append — cheap)
            partition, member = self.owner or (0, "")
            _TRACER.emit("infra:journal", "journal.flush", elapsed, partition,
                         attrs={"coveredBytes": covered_bytes, "lastIndex": idx,
                                "partition": partition, "member": member,
                                "journal": self.dir.name},
                         start_us=int(start * 1e6 + clock_offset_us()))
        if slow_flush_listeners and elapsed >= SLOW_FLUSH_THRESHOLD_S:
            for listener in list(slow_flush_listeners):
                try:
                    listener(str(self.dir), elapsed)
                except Exception:  # noqa: BLE001 — diagnostics must never
                    pass           # fail the durability path
        # async ack callbacks: the fsync succeeded, so every appended byte is
        # durable — release whatever was gated on this covering flush. Fired
        # after all durability bookkeeping; listener failures must not
        # invalidate the flush itself.
        for listener in list(self.flush_listeners):
            try:
                listener(max(idx, 0))
            except Exception:  # noqa: BLE001 — ack fan-out must never
                logger.exception("journal flush listener failed (%s)", self.dir)
        return idx

    # copied from the reference: maybe_flush .. reset
    def maybe_flush(self) -> int | None:
        """Group-commit flush point: called once per processed group (not per
        append). fsyncs — and returns the covered index — only when there is
        an unflushed backlog AND the configured cadence says so: either
        ``flush_interval`` seconds passed since the last fsync, or the
        backlog exceeds ``max_unflushed_bytes``. With ``flush_interval=None``
        (the default) it never fsyncs on its own — durability stays owned by
        explicit ``flush()`` callers (Raft ack barriers, backups) exactly as
        before."""
        if self.flush_interval is None or not self._unflushed_bytes:
            return None
        if (self._unflushed_bytes >= self.max_unflushed_bytes
                or _perf() - self._last_flush_t >= self.flush_interval):
            return self.flush()
        return None

    @property
    def unflushed_bytes(self) -> int:
        return self._unflushed_bytes

    def simulate_power_loss(self) -> None:
        """Crash simulation for tests: discard every byte not covered by an
        fsync — in-memory append buffers AND file bytes written after the
        last ``flush()`` — then close the files. The caller reopens a fresh
        journal over the directory, exactly like a process restart after the
        machine lost power between a buffered append and its covering
        flush."""
        self._flush_append_metrics()
        if self._counted_segments:
            _M_SEGMENT_COUNT.inc(-self._counted_segments)
            self._counted_segments = 0
        for seg in self.segments:
            seg._pending.clear()
            seg._pending_bytes = 0
            seg.file.truncate(seg.durable_size)
            seg.file.close()
        if self._meta_fd is not None:
            os.close(self._meta_fd)
            self._meta_fd = None

    def _write_flush_marker(self, idx: int) -> None:
        # advisory (recovery re-derives from segment scans): a write fault
        # here must not fail a flush whose fsync already succeeded
        try:
            if self._meta_fd is None:
                self._meta_fd = storage_io.os_open(
                    self._meta_path, os.O_RDWR | os.O_CREAT, 0o644)
            storage_io.pwrite(self._meta_fd, struct.pack("<Q", idx), 0,
                              path=self._meta_path)
        except OSError:
            pass

    @property
    def last_flushed_index(self) -> int:
        try:
            return struct.unpack("<Q", self._meta_path.read_bytes())[0]
        except FileNotFoundError:
            return 0

    # -- read path -----------------------------------------------------------

    def read_from(self, index: int) -> Iterator[JournalRecord]:
        """Iterate records with record.index >= index, in order."""
        for seg in self.segments:
            if seg.last_index < index:
                continue
            yield from seg.read_from(index)

    def read_entry(self, index: int) -> JournalRecord | None:
        """Random-access read of one record by index (O(segment count) + one
        sparse-bounded walk; no whole-segment materialization)."""
        start = _perf()
        try:
            for seg in self.segments:
                if seg.first_index <= index <= seg.last_index:
                    return seg.read_entry(index)
            return None
        finally:
            _M_SEEK_LATENCY.observe(_perf() - start)

    def entries_meta(self) -> Iterator[tuple[int, int]]:
        """Yield (index, asqn) for every record — header-only scan used to
        rebuild derived indexes on open (e.g. the log stream's position map)."""
        for seg in self.segments:
            f = seg.file
            seg._drain()
            seg._file_pos = -1
            offset = _SEG_HEADER.size
            while offset < seg.size:
                f.seek(offset)
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    break
                length, _, rec_index, asqn = _FRAME.unpack(head)
                yield rec_index, asqn
                offset += _FRAME.size + length

    def seek_to_asqn(self, asqn: int) -> int:
        """Return the index of the last record with record.asqn <= asqn
        (0 if none) — recovery's entry point (reference: Journal.seekToAsqn)."""
        best = 0
        for rec in self.read_from(self.first_index):
            if rec.asqn != ASQN_IGNORE and rec.asqn <= asqn:
                best = rec.index
            elif rec.asqn != ASQN_IGNORE and rec.asqn > asqn:
                break
        return best

    # -- admin ---------------------------------------------------------------

    def truncate_after(self, index: int) -> None:
        """Remove all records after ``index`` (Raft conflict resolution).

        ``_unflushed_bytes`` intentionally keeps counting the discarded
        suffix: the counter must never UNDER-report (maybe_flush skipping a
        needed fsync would ack without durability), and the truncated
        segment's surviving prefix may itself still be un-fsynced — the
        worst case of the conservative choice is one spurious fsync."""
        while len(self.segments) > 1 and self.segments[-1].first_index > index:
            self.segments.pop().delete()
        self.segments[-1].truncate_after(index)

    # -- at-rest integrity ----------------------------------------

    def scrub(self, from_index: int, max_bytes: int
              ) -> tuple[int, int, int | None]:
        """Incremental CRC walk over the drained file bytes, resumable at
        ``from_index``: returns ``(next_index, scanned_bytes,
        corrupt_index)``. ``next_index > last_index`` means the walk
        wrapped (one full pass complete). Detection only — the caller
        decides whether to :meth:`repair_corruption`. Pump-thread only."""
        scanned = 0
        index = max(from_index, self.first_index)
        for seg in self.segments:
            if scanned >= max_bytes:
                break
            if seg.last_index < index and seg.last_index >= seg.first_index:
                continue
            next_index, seg_scanned, corrupt = seg.scrub(
                index, max_bytes - scanned)
            scanned += seg_scanned
            if corrupt is not None:
                return next_index, scanned, corrupt
            index = max(index, next_index)
        return index, scanned, None

    def repair_corruption(self) -> dict:
        """Truncate the journal at its first corrupt frame repair
        seam): every segment is re-scanned from disk — ``scan()`` re-CRCs
        each frame and truncates at the first bad one — and any segment
        left non-contiguous with its predecessor is deleted. The surviving
        prefix is exactly what a crash-restart open would have recovered.
        Returns before/after evidence for the repair's flight event. The
        caller (raft) owns the consequences: clamping its flushed index and
        re-converging the lost suffix from the leader."""
        before_last = self.last_index
        self._flush_append_metrics()
        for seg in self.segments:
            try:
                seg._drain()  # valid buffered appends survive the re-scan
            except OSError:
                pass  # never-acked bytes; losing them is safe
            seg.scan()
        kept = [self.segments[0]]
        for seg in self.segments[1:]:
            if seg.first_index != kept[-1].last_index + 1:
                seg.delete()
                continue
            kept.append(seg)
        self.segments = kept
        # drop empty trailing segments except the first (mirrors open)
        while len(self.segments) > 1 and \
                self.segments[-1].last_index < self.segments[-1].first_index:
            self.segments.pop().delete()
        self._update_segment_gauge()
        return {"beforeLastIndex": before_last,
                "afterLastIndex": self.last_index,
                "truncatedRecords": max(before_last - self.last_index, 0)}

    def compact(self, index: int) -> None:
        """Delete whole segments whose records are all < ``index`` (snapshot
        compaction; reference: SegmentedJournal.deleteUntil). Never deletes the
        tail segment, and never passes the installed ``compact_guard`` — the
        durability invariant that segment deletion cannot outrun the latest
        snapshot or any exporter container cursor is enforced HERE, below
        every caller."""
        if self.compact_guard is not None:
            try:
                bound = self.compact_guard()
            except Exception:  # noqa: BLE001 — a broken guard must fail safe
                bound = 0      # (skip compaction), never delete unguarded
            if index > bound:
                _M_COMPACTION_CLAMPED.inc()
                index = bound
        start = _perf()
        compacted = False
        while len(self.segments) > 1 and self.segments[0].last_index < index:
            self.segments.pop(0).delete()
            compacted = True
        if compacted:
            self._update_segment_gauge()
            _M_COMPACTION_MS.observe((_perf() - start) * 1000.0)

    def reset(self, next_index: int) -> None:
        """Discard everything and restart at ``next_index`` (snapshot install)."""
        for seg in self.segments:
            seg.delete()
        self.segments = [_Segment(self._segment_path(1), 1, next_index, create=True)]
        self._unflushed_bytes = 0  # the pre-reset backlog no longer exists
        self._update_segment_gauge()
        # invalidate the stale flushed-index marker from the pre-reset log
        self._write_flush_marker(max(next_index - 1, 0))
    # end of the copy


# copied from the reference: read_only_records .. read_only_records
def read_only_records(directory: str | Path,
                      name: str = "journal") -> Iterator[JournalRecord]:
    """Iterate a journal directory's records WITHOUT opening it for write —
    unlike ``SegmentedJournal`` (which truncates crash-torn suffixes on
    open), this never mutates anything, so operator inspection tools (``cli
    snapshots``) can point it at a live broker's data directory. Stops
    silently at the first corrupt/torn frame, exactly where a real open
    would truncate."""
    directory = Path(directory)
    paths = sorted(directory.glob(f"{name}-*.log"),
                   key=lambda p: int(p.stem.rsplit("-", 1)[1]))
    prev_last: int | None = None
    for path in paths:
        try:
            raw = path.read_bytes()
        except OSError:
            return
        if len(raw) < _SEG_HEADER.size:
            return
        magic, version, _seg_id, first_index = _SEG_HEADER.unpack_from(raw)
        if magic != _MAGIC or version != _VERSION:
            return
        if prev_last is not None and first_index != prev_last + 1:
            return  # gap between segments: later segments are unreachable
        offset = _SEG_HEADER.size
        expected = first_index
        n = len(raw)
        while offset + _FRAME.size <= n:
            length, crc, index, asqn = _FRAME.unpack_from(raw, offset)
            end = offset + _FRAME.size + length
            if length == 0 or end > n or index != expected:
                return
            data = raw[offset + _FRAME.size:end]
            if _checksum(index, asqn, data) != crc:
                return
            yield JournalRecord(index, asqn, data)
            prev_last = index
            expected += 1
            offset = end
# end of the copy
