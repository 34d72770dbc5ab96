"""Per-partition log stream: position-assigning writer + readers over the journal.

Reference: logstreams/src/main/java/io/camunda/zeebe/logstreams/log/LogStream.java,
impl/log/Sequencer.java:37 (position assignment, tryWrite :67-96),
impl/log/LogStorageAppender.java, impl/serializer/LogAppendEntrySerializer.java,
log/LogAppendEntry.java (ofProcessed).

One journal entry holds one *sequenced batch*: all follow-up records of a single
processing step, written atomically. Each record gets a monotonically increasing
stream position; the batch's first position is the journal entry's asqn, which
makes ``seek_to_position`` a journal asqn-seek. Entries marked ``processed``
(follow-ups already applied in the same processing step) are skipped by replay
— LogAppendEntry.ofProcessed semantics.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import time
from typing import Iterator

from zeebe_tpu_torch import native as _native
from zeebe_tpu_torch.journal import SegmentedJournal
from zeebe_tpu_torch.utils import evict_oldest_half as _evict_oldest_half
from zeebe_tpu_torch.protocol import Record
from zeebe_tpu_torch.protocol.enums import RecordType
from zeebe_tpu_torch.protocol.msgpack import unpackb as msgpack_unpackb

_BATCH_HEADER = struct.Struct("<IqQ")  # record count, source position, timestamp ms
_ENTRY_HEADER = struct.Struct("<BqI")  # processed flag, position, record length
_PACK_LE_Q = struct.Struct("<q")
_FRAME_KEY = struct.Struct("<q")
_FRAME_HEADER_SIZE = 50  # protocol/record.py _HEADER.size
# hoisted for the scan hot loop (RecordView.is_event/is_command)
_RT_EVENT = int(RecordType.EVENT)
_RT_COMMAND = int(RecordType.COMMAND)


def _py_scan_batch_headers(payload: bytes):
    """Pure-Python mirror of the native scan_batch_headers: same tuples, and
    the same MsgPackError on every malformed-input shape the C scanner
    rejects (truncation, impossible lengths, trailing bytes)."""
    from zeebe_tpu_torch.protocol.msgpack import MsgPackError

    n = len(payload)
    if n < _BATCH_HEADER.size:
        raise MsgPackError(f"batch payload truncated: {n} bytes")
    count, source_position, timestamp = _BATCH_HEADER.unpack_from(payload, 0)
    off = _BATCH_HEADER.size
    records = []
    for i in range(count):
        if off + _ENTRY_HEADER.size > n:
            raise MsgPackError(f"batch entry {i} truncated")
        processed, position, length = _ENTRY_HEADER.unpack_from(payload, off)
        off += _ENTRY_HEADER.size
        if off + length > n or length < _FRAME_HEADER_SIZE:
            raise MsgPackError(f"batch record {i} truncated")
        records.append((
            processed, position, payload[off], payload[off + 1],
            payload[off + 2], _FRAME_KEY.unpack_from(payload, off + 4)[0],
            off, length,
        ))
        off += length
    if off != n:
        raise MsgPackError(f"trailing bytes after batch: {n - off}")
    return source_position, timestamp, records


from zeebe_tpu_torch.utils.metrics import REGISTRY as _METRICS

# sequencer/appender metrics (reference: logstreams impl/Sequencer +
# LogStorageAppender metrics); label-less children cached — the writer is hot
_M_SEQ_BATCH_SIZE = _METRICS.histogram(
    "sequencer_batch_size", "records per sequenced batch",
    (), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 512)).labels()
_M_SEQ_BATCH_BYTES = _METRICS.histogram(
    "sequencer_batch_length_bytes", "bytes per sequenced batch",
    (), buckets=(256, 1024, 4096, 16384, 65536, 262144)).labels()
_M_APPEND_LATENCY = _METRICS.histogram(
    "log_appender_append_latency", "seconds per log append").labels()
_M_LAST_APPENDED = _METRICS.gauge(
    "log_appender_last_appended_position",
    "last record position appended").labels()
_M_LAST_COMMITTED = _METRICS.gauge(
    "log_appender_last_committed_position",
    "last record position committed/visible").labels()
_M_COMMIT_LATENCY = _METRICS.histogram(
    "log_appender_commit_latency",
    "seconds from sequencing to committed visibility").labels()
# the writer is synchronous (no sequencer ring buffer between ingress and
# the appender), so the queue depth is structurally 0 — registered for
# dashboard parity with the reference's sequencer_queue_size
_METRICS.gauge(
    "sequencer_queue_size",
    "sequenced batches queued for append (synchronous writer: 0)").set(0)

# append→ack latency stamping: one enabled-check per append when tracing is
# off (the singleton is mutated in place, never replaced)
from zeebe_tpu_torch.observability.tracer import get_tracer as _get_tracer

_TRACER = _get_tracer()

_codec = _native.load_codec()
_scan_batch_headers = (
    _codec.scan_batch_headers
    if _codec is not None and hasattr(_codec, "scan_batch_headers")
    else _py_scan_batch_headers
)


def _py_scan_batch_headers_filtered(payload, record_type, value_type, intent):
    src, ts, headers = _scan_batch_headers(payload)
    return src, ts, [
        h for h in headers
        if h[2] == record_type and h[3] == value_type
        and (intent < 0 or h[4] == intent)
    ]


_scan_batch_headers_filtered = (
    _codec.scan_batch_headers_filtered
    if _codec is not None and hasattr(_codec, "scan_batch_headers_filtered")
    else _py_scan_batch_headers_filtered
)


class RecordView:
    """Header-only view of one record inside a sequenced batch.

    A filtering scan (job discovery, export filters, command scans) reads the
    fixed header fields — ``record_type``/``value_type``/``intent`` are the
    raw wire ints, comparable to the IntEnums by value — and pays for the full
    ``Record`` (rejection reason + msgpack value) only on first ``.record``
    access."""

    __slots__ = ("position", "processed", "source_position", "record_type",
                 "value_type", "intent", "key", "_payload", "_off", "_len",
                 "_timestamp", "_partition_id", "_record")

    def __init__(self, position, processed, source_position, record_type,
                 value_type, intent, key, payload, off, length, timestamp,
                 partition_id, record=None):
        self.position = position
        self.processed = processed
        self.source_position = source_position
        self.record_type = record_type
        self.value_type = value_type
        self.intent = intent
        self.key = key
        self._payload = payload
        self._off = off
        self._len = length
        self._timestamp = timestamp
        self._partition_id = partition_id
        self._record = record

    @property
    def is_event(self) -> bool:
        return self.record_type == _RT_EVENT

    @property
    def is_command(self) -> bool:
        return self.record_type == _RT_COMMAND

    @property
    def record(self) -> Record:
        if self._record is None:
            self._record = Record.from_bytes(
                self._payload[self._off : self._off + self._len],
                position=self.position, partition_id=self._partition_id,
                timestamp=self._timestamp,
            )
        return self._record

    @property
    def value(self):
        return self.record.value


@dataclasses.dataclass(frozen=True, slots=True)
class LogAppendEntry:
    """One record to append. ``processed=True`` marks a follow-up that the
    processing step already applied to state (replay must skip it)."""

    record: Record
    processed: bool = False

    @classmethod
    def of_processed(cls, record: Record) -> "LogAppendEntry":
        return cls(record, processed=True)


@dataclasses.dataclass(frozen=True, slots=True)
class LoggedRecord:
    """A record as read back from the stream."""

    record: Record
    position: int
    source_position: int
    processed: bool


class LogStreamWriter:
    """Assigns positions and appends batches — Sequencer + appender collapsed
    into one synchronous path (the actor pipeline between them in the reference
    exists to decouple network ingress threads from the io thread; here one
    writer thread per partition owns the log end-to-end)."""

    def __init__(self, stream: "LogStream") -> None:
        self._stream = stream
        self._lock = threading.Lock()
        # histogram sampling tick (1-in-16): per-writer, mutated under
        # self._lock — a module global would race across partitions' writers
        self._m_tick = 0

    def try_write(
        self, entries: list[LogAppendEntry], source_position: int = -1
    ) -> int:
        """Append a batch; returns the position of the last record (or -1 if
        entries is empty). Positions are contiguous within the batch."""
        if not entries:
            return -1
        stream = self._stream
        with self._lock:
            # histograms see a 1-in-16 sample (the reference's hot appenders
            # amortize metric updates the same way); position gauges stay exact
            self._m_tick += 1
            sampled = not (self._m_tick & 15)
            start = time.perf_counter() if sampled else 0.0
            first_position = stream._next_position
            timestamp = stream.clock_millis()
            payload, bodies = _serialize_batch_with_bodies(
                entries, first_position, source_position, timestamp
            )
            jrec = stream.journal.append(payload, asqn=first_position)
            stream._on_appended(first_position, jrec.index)
            stream._next_position = first_position + len(entries)
            last = first_position + len(entries) - 1
            _M_LAST_APPENDED.set(last)
            _M_LAST_COMMITTED.set(last)  # local log: visible on append
            if sampled:
                _M_SEQ_BATCH_SIZE.observe(len(entries))
                _M_SEQ_BATCH_BYTES.observe(len(payload))
                elapsed = time.perf_counter() - start
                _M_APPEND_LATENCY.observe(elapsed)
                _M_COMMIT_LATENCY.observe(elapsed)
            stream._batch_has_commands[jrec.index] = any(
                e.record.is_command and not e.processed for e in entries
            )
            if _TRACER.enabled:
                # stamp unprocessed commands' append time (resolved into
                # command_ack_latency at commit) and register the batch's
                # transitive trace roots so multi-hop chains keep one trace id
                pid = stream.partition_id
                _TRACER.register_batch(pid, first_position, len(entries),
                                       source_position)
                for i, e in enumerate(entries):
                    if e.record.is_command and not e.processed:
                        _TRACER.note_append(pid, first_position + i)
            # seed the decode cache from the in-memory entries: every local
            # append is read back at least twice (processing scan + export),
            # and the bytes round-trip is pure waste for records we hold.
            # The value is re-decoded from the body bytes just written
            # (tuple→list normalization etc.) so a cached read is
            # indistinguishable from a disk read. Oversized rejection reasons
            # are truncated on the wire (Record.encode) — skip seeding then so
            # the cached view never diverges from disk (cheap codepoint-count
            # precheck before paying for the utf-8 encode).
            if any(
                len(e.record.rejection_reason) > 0x3FFF
                and len(e.record.rejection_reason.encode("utf-8")) > 0xFFFF
                for e in entries
            ):
                return last
            pid = stream.partition_id
            seeded = []
            for i, entry in enumerate(entries):
                rec = entry.record
                # positional Record construction (field order = dataclass
                # order; arity drift fails loudly): replace()'s per-field
                # getattr/index plumbing is measurable at wave sizes
                seeded.append(LoggedRecord(
                    record=Record(
                        rec.record_type, rec.value_type, rec.intent,
                        msgpack_unpackb(bodies[i]), rec.key,
                        first_position + i, rec.source_record_position,
                        timestamp, pid, rec.rejection_type,
                        rec.rejection_reason, rec.request_stream_id,
                        rec.request_id, rec.operation_reference,
                    ),
                    position=first_position + i,
                    source_position=source_position,
                    processed=entry.processed,
                ))
            stream._cache_batch(jrec.index, seeded)
        return last

    def append_prepatched(
        self, buf: bytearray, pos_offsets: list[int], ts_offsets: list[int],
        count: int, has_pending_commands: bool = False,
    ) -> int:
        """Append a pre-serialized batch whose only unknown fields are the
        positions and timestamps (the burst-template fast path): patch them
        under the lock and hand the bytes straight to the journal. Returns the
        last record's position. The decode cache is NOT seeded — readers
        decode on demand — but the command-scan skip index is."""
        stream = self._stream
        with self._lock:
            self._m_tick += 1
            sampled = not (self._m_tick & 15)
            start = time.perf_counter() if sampled else 0.0
            first_position = stream._next_position
            timestamp = stream.clock_millis()
            patch_prepatched_batch(buf, pos_offsets, ts_offsets,
                                   first_position, timestamp)
            # the journal copies the buffer into its framed write buffer
            # synchronously, so the bytearray goes straight through — no
            # bytes() copy. Safe: every PreparedBurst buf is freshly built
            # per instantiation and never mutated after this append.
            jrec = stream.journal.append(buf, asqn=first_position)
            stream._on_appended(first_position, jrec.index)
            stream._next_position = first_position + count
            last = first_position + count - 1
            _M_LAST_APPENDED.set(last)
            _M_LAST_COMMITTED.set(last)
            if sampled:
                _M_SEQ_BATCH_SIZE.observe(count)
                _M_SEQ_BATCH_BYTES.observe(len(buf))
                elapsed = time.perf_counter() - start
                _M_APPEND_LATENCY.observe(elapsed)
                _M_COMMIT_LATENCY.observe(elapsed)
            stream._batch_has_commands[jrec.index] = has_pending_commands
        return last


_native_stamp_batch = _native.codec_fn("stamp_batch")


def patch_prepatched_batch(buf: bytearray, pos_offsets, ts_offsets,
                           first_position: int, timestamp: int) -> None:
    """Stamp the only two unknowns of a pre-serialized burst batch — record
    positions and the batch timestamp — at their captured byte offsets
    (shared by the local LogStreamWriter and the broker's Raft writer)."""
    if _native_stamp_batch is not None and type(buf) is bytearray:
        _native_stamp_batch(buf, pos_offsets, ts_offsets, first_position,
                            timestamp)
        return
    for i, off in enumerate(pos_offsets):
        _PACK_LE_Q.pack_into(buf, off, first_position + i)
    for off in ts_offsets:
        _PACK_LE_Q.pack_into(buf, off, timestamp)


def _serialize_batch(
    entries: list[LogAppendEntry], first_position: int, source_position: int, timestamp: int
) -> bytes:
    return _serialize_batch_with_bodies(entries, first_position, source_position, timestamp)[0]


# record-frame encode cache, keyed by Record object identity (stored records
# pin their ids against reuse): a record appended more than once — gateway
# command fan-out, retried scheduled commands, bench injection — serializes
# exactly once; the batch builder patches the timestamp into its own copy at
# the captured offset. Sound because Record is frozen and values are never
# mutated after reaching a writer (the same contract the decode-cache seeding
# in try_write already depends on). Frames are cached only on the SECOND
# encode of the same object: the dominant path appends each record exactly
# once, and caching those would pin thousands of dead frame copies for zero
# hits (the _frame_seen stage pins only the records themselves).
_TS_OFFSET = 20  # timestamp field offset inside the record frame header
_FRAME_CACHE_LIMIT = 4096
_FRAME_SEEN_LIMIT = 4096
_frame_cache: dict[int, tuple[Record, bytes, bytes]] = {}
_frame_seen: dict[int, Record] = {}


def _encoded_frame(record: Record) -> tuple[bytes, bytes]:
    rid = id(record)
    hit = _frame_cache.get(rid)
    if hit is not None and hit[0] is record:
        return hit[1], hit[2]
    frame, body = record.encode(0)  # timestamp patched per batch
    if _frame_seen.get(rid) is record:
        del _frame_seen[rid]
        _evict_oldest_half(_frame_cache, _FRAME_CACHE_LIMIT)
        _frame_cache[rid] = (record, frame, body)
    else:
        _evict_oldest_half(_frame_seen, _FRAME_SEEN_LIMIT)
        _frame_seen[rid] = record
    return frame, body


def _serialize_batch_with_bodies(
    entries: list[LogAppendEntry], first_position: int, source_position: int, timestamp: int
) -> tuple[bytes, list[bytes]]:
    """Serialize into ONE growing buffer; also returns each record's msgpack
    value body so the writer can seed the decode cache without re-encoding
    anything. Record frames come pre-encoded from the identity cache (with
    the batch timestamp patched in place at its fixed header offset) instead
    of a per-``LogAppendEntry`` encode per append."""
    buf = bytearray(_BATCH_HEADER.pack(len(entries), source_position, timestamp))
    bodies: list[bytes] = []
    pack_entry = _ENTRY_HEADER.pack
    pack_ts = _PACK_LE_Q.pack_into
    for i, entry in enumerate(entries):
        frame, body = _encoded_frame(entry.record)
        bodies.append(body)
        buf += pack_entry(1 if entry.processed else 0, first_position + i, len(frame))
        off = len(buf)
        buf += frame
        pack_ts(buf, off + _TS_OFFSET, timestamp)
    return bytes(buf), bodies


def _deserialize_batch(payload: bytes, partition_id: int) -> list[LoggedRecord]:
    count, source_position, timestamp = _BATCH_HEADER.unpack_from(payload, 0)
    off = _BATCH_HEADER.size
    out = []
    for _ in range(count):
        processed, position, length = _ENTRY_HEADER.unpack_from(payload, off)
        off += _ENTRY_HEADER.size
        record = Record.from_bytes(
            payload[off : off + length], position=position,
            partition_id=partition_id, timestamp=timestamp,
        )
        off += length
        out.append(
            LoggedRecord(
                record=record,
                position=position,
                source_position=source_position,
                processed=bool(processed),
            )
        )
    return out


def _record_at_or_after(batch: list["LoggedRecord"], position: int):
    """First record with record.position >= ``position`` in one decoded
    batch, or None past its end. Record positions within a sequenced batch
    are contiguous (first_position + i by construction), so this is direct
    indexing — the command scan over a wave-sized batch (thousands of
    commands in one append) would otherwise rescan the list per command and
    go quadratic. A non-contiguous batch (defensive: never produced by any
    writer) falls back to the linear walk."""
    if not batch:
        return None
    idx = position - batch[0].position
    if idx <= 0:
        return batch[0]
    if idx < len(batch):
        logged = batch[idx]
        if logged.position == position:
            return logged
    elif batch[-1].position < position:
        return None  # truly past the batch even if non-contiguous
    for logged in batch:
        if logged.position >= position:
            return logged
    return None


class LogStreamReader:
    """Sequential reader over the stream from a given position. Keeps a batch
    cursor hint so the sequential case (the only hot one: processing, replay,
    export all walk forward) costs one dict hit instead of a bisect + batch
    rescan per record."""

    def __init__(self, stream: "LogStream", from_position: int = 1) -> None:
        self._stream = stream
        self.seek(from_position)

    def seek(self, position: int) -> None:
        self._position = max(position, 1)
        self._hint = -1

    def seek_to_end(self) -> None:
        self._position = self._stream.last_position + 1
        self._hint = -1

    def __iter__(self) -> Iterator[LoggedRecord]:
        return self

    def __next__(self) -> LoggedRecord:
        rec, self._hint = self._stream.read_with_hint(self._position, self._hint)
        if rec is None:
            raise StopIteration
        self._position = rec.position + 1
        return rec

    def has_next(self) -> bool:
        rec, self._hint = self._stream.read_with_hint(self._position, self._hint)
        return rec is not None


class LogStream:
    """Per-partition log facade; creates readers and exactly one writer.

    Keeps an in-memory batch index — (first position, journal index) per
    sequenced batch, rebuilt from a header-only journal scan on open and
    appended on write — so position lookups are a bisect + one journal entry
    read instead of a log scan (2 ints per batch; a 1M-batch partition costs
    ~16 MB, and snapshots compact the journal long before that).
    """

    def __init__(self, journal: SegmentedJournal, partition_id: int, clock=None) -> None:
        self.journal = journal
        self.partition_id = partition_id
        self.clock_millis = clock or (lambda: int(time.time() * 1000))
        # parallel arrays: batch first positions (sorted) and journal indexes
        self._batch_positions: list[int] = []
        self._batch_indexes: list[int] = []
        # decoded-batch LRU keyed by journal index: the processing reader, the
        # kernel group scanner, and exporters all walk the same recent suffix
        # interleaved, so a single-slot cache thrashes (every read re-decodes
        # a batch); 1024 batches ≈ one processing burst window
        self._batch_cache: dict[int, list[LoggedRecord]] = {}
        # sized so one ingress burst window (thousands of single-command
        # batches) plus its follow-up reads stays decoded end-to-end
        self._batch_cache_limit = 8192
        # journal index → False when the batch is known to contain no
        # unprocessed commands (burst appends): the command scan skips such
        # batches without decoding them. Absent = unknown (must decode).
        self._batch_has_commands: dict[int, bool] = {}
        self.rebuild_index()
        self._writer = LogStreamWriter(self)

    def rebuild_index(self) -> None:
        """Recompute the batch index and next position from the journal
        (call after external journal mutation, e.g. Raft truncation)."""
        self._batch_positions.clear()
        self._batch_indexes.clear()
        self._batch_cache.clear()
        self._batch_has_commands.clear()
        for index, asqn in self.journal.entries_meta():
            if asqn >= 0:
                self._batch_positions.append(asqn)
                self._batch_indexes.append(index)
        if self._batch_positions:
            last_batch = self._read_batch_at(self._batch_indexes[-1])
            self._next_position = last_batch[-1].position + 1
        else:
            self._next_position = 1

    def _read_batch_at(self, journal_index: int) -> list[LoggedRecord]:
        cache = self._batch_cache
        batch = cache.get(journal_index)
        if batch is not None:
            return batch
        jrec = self.journal.read_entry(journal_index)
        if jrec is None:
            return []
        batch = _deserialize_batch(jrec.data, self.partition_id)
        self._cache_batch(journal_index, batch)
        if journal_index not in self._batch_has_commands:
            self._batch_has_commands[journal_index] = any(
                r.record.is_command and not r.processed for r in batch
            )
        return batch

    def _on_appended(self, first_position: int, journal_index: int) -> None:
        self._batch_positions.append(first_position)
        self._batch_indexes.append(journal_index)

    def _cache_batch(self, journal_index: int, batch: list[LoggedRecord]) -> None:
        _evict_oldest_half(self._batch_cache, self._batch_cache_limit)
        self._batch_cache[journal_index] = batch

    @property
    def writer(self) -> LogStreamWriter:
        return self._writer

    def append_committed_payload(self, payload: bytes, first_position: int,
                                 has_pending_commands: bool | None = None) -> None:
        """Materialize a batch that was sequenced elsewhere (the Raft leader)
        and is now committed: the payload embeds its record positions, assigned
        at ingress. Used by the broker partition on leaders AND followers — the
        stream journal holds exactly the committed prefix of the Raft log
        (reference: AtomixLogStorage reads committed Raft entries; we
        materialize them so readers/recovery are identical on every role)."""
        if first_position < self._next_position:
            return  # already materialized (e.g. re-delivered commit)
        jrec = self.journal.append(payload, asqn=first_position)
        self._on_appended(first_position, jrec.index)
        if has_pending_commands is not None:
            # burst batches carry the command-scan skip flag from the leader's
            # append (absent = unknown = decode on demand)
            self._batch_has_commands[jrec.index] = has_pending_commands
        batch = self._read_batch_at(jrec.index)
        self._next_position = batch[-1].position + 1 if batch else first_position + 1
        if _TRACER.enabled and batch:
            # the broker materialization path (leader AND follower): register
            # trace roots so processor/exporter spans resolve transitively
            _TRACER.register_batch(self.partition_id, first_position,
                                   len(batch), batch[0].source_position)

    def serialize_batch(self, entries: list[LogAppendEntry], first_position: int,
                        source_position: int = -1) -> bytes:
        """Sequencer half of the write path: assign positions into a payload
        without appending (the Raft path appends only after quorum commit)."""
        return _serialize_batch(entries, first_position, source_position,
                                self.clock_millis())

    @property
    def last_position(self) -> int:
        return self._next_position - 1

    def compact_to_position(self, position: int) -> int:
        """Compact the backing journal so records whose positions are all
        <= ``position`` can be deleted (whole segments only; the journal's
        ``compact_guard`` — min of snapshot position and exporter cursors —
        clamps further). The batch index arrays are intentionally NOT pruned:
        reader hints are slots into them, and a prune would silently shift
        every live hint; stale leading entries cost 2 ints per batch and
        resolve to empty reads nobody issues (all consumers are past the
        bound by construction). Decoded-batch caches for compacted indexes
        ARE dropped. Returns the journal's new first index."""
        idx = self.journal.seek_to_asqn(position)
        if idx > 1:
            self.journal.compact(idx)
        first = self.journal.first_index
        for stale in [k for k in self._batch_cache if k < first]:
            del self._batch_cache[stale]
        for stale in [k for k in self._batch_has_commands if k < first]:
            del self._batch_has_commands[stale]
        return first

    def new_reader(self, from_position: int = 1) -> LogStreamReader:
        return LogStreamReader(self, from_position)

    def _batch_slot_for(self, position: int) -> int:
        """Index into the batch arrays of the batch that would hold
        ``position`` (greatest first_position <= position), or -1."""
        from bisect import bisect_right

        return bisect_right(self._batch_positions, position) - 1

    def read_at_or_after(self, position: int) -> LoggedRecord | None:
        """First record with record.position >= position, or None."""
        return self.read_with_hint(position, -1)[0]

    def next_command_with_hint(
        self, position: int, hint: int
    ) -> tuple[LoggedRecord | None, int, int]:
        """Like read_with_hint, but for the command scan: whole batches known
        to contain no unprocessed commands (``_batch_has_commands`` is False)
        are skipped without decoding. Returns (record, hint, scan_position):
        the first record at-or-after ``position`` that MAY be an unprocessed
        command (the caller still filters — the skip is an optimization, not a
        contract), and the position the scan safely advanced to (when no
        record is returned the caller may resume from scan_position and never
        rescan the skipped batches)."""
        while True:
            if position > self.last_position:
                return None, hint, position
            slot = self._locate_slot(position, hint)
            has = self._batch_has_commands.get(self._batch_indexes[slot])
            if has is False:
                hint = slot
                if slot + 1 < len(self._batch_positions):
                    position = self._batch_positions[slot + 1]
                    continue
                return None, slot, self.last_position + 1
            batch = self._read_batch_at(self._batch_indexes[slot])
            logged = _record_at_or_after(batch, position)
            if logged is not None:
                return logged, slot, logged.position
            if slot + 1 < len(self._batch_indexes):
                position = self._batch_positions[slot + 1]
                hint = slot + 1
                continue
            return None, slot, self.last_position + 1

    def _locate_slot(self, position: int, hint: int) -> int:
        positions = self._batch_positions
        n = len(positions)
        if 0 <= hint < n and positions[hint] <= position:
            if hint + 1 >= n or positions[hint + 1] > position:
                return hint
            if hint + 2 >= n or positions[hint + 2] > position:
                return hint + 1
        slot = self._batch_slot_for(position)
        return 0 if slot < 0 else slot

    def read_with_hint(self, position: int, hint: int) -> tuple[LoggedRecord | None, int]:
        """``read_at_or_after`` with a batch-slot cursor: ``hint`` is the slot
        the caller last read from (-1 = unknown); returns (record, slot) so
        sequential readers skip the bisect. A stale hint (e.g. after
        rebuild_index truncated the arrays) is detected and falls back."""
        if position > self.last_position:
            return None, hint
        slot = self._locate_slot(position, hint)
        while True:
            batch = self._read_batch_at(self._batch_indexes[slot])
            logged = _record_at_or_after(batch, position)
            if logged is not None:
                return logged, slot
            # position falls in a gap after this batch — or the batch was
            # compacted away (journal read returns empty; the stale index
            # entry is kept so hints stay valid): first record of the next
            if slot + 1 >= len(self._batch_indexes):
                return None, slot
            slot += 1

    def _scan_batches(self, from_position: int):
        """Shared scan skeleton: yields (cached_records, payload) per
        sequenced batch from the one holding ``from_position`` — exactly one
        of the two is non-None. One streaming journal read (a single seek +
        bulk read per segment) instead of a random-access read per batch;
        batches appended after the scan started are excluded."""
        last = self.last_position
        if from_position > last:
            return
        slot = self._batch_slot_for(from_position)
        if slot < 0:
            slot = 0
        cache = self._batch_cache
        for jrec in self.journal.read_from(self._batch_indexes[slot]):
            if jrec.asqn < 0:
                continue
            if jrec.asqn > last:
                return  # appended after this scan started
            cached = cache.get(jrec.index)
            yield (cached, None) if cached is not None else (None, jrec.data)

    def scan(self, from_position: int = 1) -> Iterator[RecordView]:
        """Header-only forward scan from ``from_position``: yields
        ``RecordView``s whose full records (msgpack values) decode lazily on
        first access. The cheap path for filtering consumers — job discovery,
        export filters, metrics sweeps — that inspect header fields of every
        record but need the value of few. Batches already decoded in the cache
        are served from it; undecoded batches are scanned natively without
        populating the cache."""
        from_position = max(from_position, 1)
        pid = self.partition_id
        for cached, payload in self._scan_batches(from_position):
            if cached is not None:
                for logged in cached:
                    if logged.position < from_position:
                        continue
                    rec = logged.record
                    yield RecordView(
                        logged.position, logged.processed,
                        logged.source_position, int(rec.record_type),
                        int(rec.value_type), int(rec.intent), rec.key,
                        None, 0, 0, rec.timestamp, pid, record=rec,
                    )
                continue
            source_position, timestamp, headers = _scan_batch_headers(payload)
            for (processed, position, record_type, value_type, intent, key,
                 off, length) in headers:
                if position < from_position:
                    continue
                yield RecordView(
                    position, bool(processed), source_position, record_type,
                    value_type, intent, key, payload, off, length, timestamp,
                    pid,
                )

    def scan_filtered(self, from_position: int, record_type: int,
                      value_type: int, intent: int | None = None
                      ) -> Iterator[RecordView]:
        """``scan`` that filters on the raw header ints BEFORE building a
        ``RecordView`` — a discovery sweep (job scan, transition count) over
        N records with k matches costs k view objects, not N (uncached
        batches filter inside the native scanner). ``intent=None`` matches
        any intent."""
        from_position = max(from_position, 1)
        pid = self.partition_id
        for cached, payload in self._scan_batches(from_position):
            if cached is not None:
                for logged in cached:
                    if logged.position < from_position:
                        continue
                    rec = logged.record
                    if (int(rec.record_type) != record_type
                            or int(rec.value_type) != value_type
                            or (intent is not None and int(rec.intent) != intent)):
                        continue
                    yield RecordView(
                        logged.position, logged.processed,
                        logged.source_position, record_type,
                        value_type, int(rec.intent), rec.key,
                        None, 0, 0, rec.timestamp, pid, record=rec,
                    )
                continue
            source_position, timestamp, headers = _scan_batch_headers_filtered(
                payload, record_type, value_type,
                -1 if intent is None else intent)
            for (processed, position, rt, vt, it, key, off, length) in headers:
                if position < from_position:
                    continue
                yield RecordView(
                    position, bool(processed), source_position, rt,
                    vt, it, key, payload, off, length, timestamp, pid,
                )

    def read_batch_containing(self, position: int) -> list[LoggedRecord]:
        """The whole sequenced batch holding ``position`` (for batch replay)."""
        slot = self._batch_slot_for(position)
        if slot < 0:
            return []
        batch = self._read_batch_at(self._batch_indexes[slot])
        if batch and batch[0].position <= position <= batch[-1].position:
            return batch
        return []
