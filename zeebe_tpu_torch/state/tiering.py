"""Tiered partition state: a disk-backed cold store for parked instances
, ROADMAP item 4).

A real tenant parks millions of process instances — waiting on timers,
messages, human tasks — for days. The hot ``ZbDb`` dict holds every value as
a decoded Python object, so resident memory grows with the parked backlog
even though parked state is never read until its wake event. Gorilla
(PAPERS.md) showed the tier shape that works: a bounded in-memory hot tier
with whole-block eviction over a durable cold layer.

The split here exploits this engine's own durability invariant — **the
replicated log + snapshot chain are the durability source of truth** (state
is always recomputable), so the cold tier is a *memory-extension cache*, not
a durability layer:

- **Spill** moves a parked instance's state records (element-instance tree,
  variables, message subscriptions, timers, jobs) out of the hot dict into a
  CRC-framed append-only segment file, leaving a ~56-byte ``ColdRef`` stub
  behind. Keys stay resident in the sorted index, so prefix iteration and
  existence checks are unchanged.
- **Fault-in** is transparent: any committed read of a ``ColdRef`` (the wake
  path — timer fire, message correlate, job activate — or a query) resolves
  the frame, CRC-checks it, and promotes the value back to hot.
- **Crash safety**: cold segments are wiped on every open. A spilled value
  is resolved from its frame whenever a snapshot or delta serializes it, so
  the persisted chain is byte-identical to an unspilled partition's — after
  a crash, recovery rebuilds the instance from the chain + replay exactly as
  before (the scale soak crashes mid-spill to prove it), and the manager
  simply re-spills once the instance re-parks.
- **Reclamation**: a segment whose entries all faulted back in (or were
  deleted) unlinks; a mostly-dead segment's survivors are rewritten into the
  current segment on the pump thread (``compact_cold``), so cold disk tracks
  live parked bytes.

Spill *candidates* arrive through the physical ``ZbDb.note_parked`` seam the
state facades fire when an instance enters a wait state; the
``TieringManager`` (driven from the partition pump, between transactions)
spills candidates that stayed parked past ``park_after_ms``. Both seams are
observation-only: a lost candidate just stays hot, a stale one costs one
no-op pass — determinism and replay parity are untouched.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.state.db import ZbDb, encode_key
from zeebe_tpu_torch.utils import storage_io
from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

#: cold frame: total length, crc32(key+value), key length
_FRAME = struct.Struct("<IIH")

_M_SPILLED_INSTANCES = _REG.gauge(
    "state_parked_cold_instances",
    "parked process instances currently resident in the cold tier",
    ("partition",))
_M_SPILLS = _REG.counter(
    "state_spill_total", "state records spilled to the cold tier",
    ("partition",))
_M_FAULTS = _REG.counter(
    "state_fault_in_total",
    "cold state records faulted back into the hot tier", ("partition",))
_M_COLD_SEGMENTS = _REG.gauge(
    "state_cold_segments", "cold-tier segment files", ("partition",))
_M_TIER_WRITE_ERRORS = _REG.counter(
    "state_tier_write_errors_total",
    "cold-tier write failures (ENOSPC/EIO during spill or compaction); "
    "tiering degrades to hot-only instead of poisoning the pump",
    ("partition",))
_M_TIER_READ_ERRORS = _REG.counter(
    "state_tier_read_errors_total",
    "cold-tier read failures (CRC mismatch / EIO on fault-in); the "
    "partition latches DEGRADED and rebuilds from chain + log",
    ("partition",))


def note_cold_read_error(partition_id: int) -> None:
    """Read-side degradation metric seam (the partition's cold-corruption
    repair calls this; one metric home next to its write-side sibling)."""
    _M_TIER_READ_ERRORS.labels(str(partition_id)).inc()


class ColdCorruptionError(ValueError):
    """A cold-store read hit a CRC mismatch, short read, or IO error
   . Typed so the partition pump can catch it ABOVE the stream
    processor's blanket failure containment and repair — latch tiering
    DEGRADED + transition (state rebuilds from chain + log; cold is a
    cache) — instead of poisoning the pump or failing the partition.
    Subclasses ValueError: pre-existing corrupt-frame handling keeps
    matching."""

    def __init__(self, message: str, ref: "ColdRef | None" = None) -> None:
        super().__init__(message)
        self.ref = ref


class ColdRef:
    """A committed value demoted to disk: (segment, offset, frame length).
    ``tag`` carries the owning process-instance key so the first fault-in of
    an instance can notify the tiering manager (wake observation)."""

    __slots__ = ("seg", "off", "length", "tag")

    def __init__(self, seg: int, off: int, length: int, tag: int = -1) -> None:
        self.seg = seg
        self.off = off
        self.length = length
        self.tag = tag

    def __repr__(self) -> str:  # debugging/postmortem friendliness
        return f"ColdRef(seg={self.seg}, off={self.off}, len={self.length})"


class _Segment:
    __slots__ = ("seg_id", "path", "write_f", "read_fd", "size",
                 "live", "live_bytes", "keys")

    def __init__(self, seg_id: int, path: Path) -> None:
        self.seg_id = seg_id
        self.path = path
        self.write_f = storage_io.open_file(path, "wb")
        self.read_fd = storage_io.os_open(path, os.O_RDONLY)
        self.size = 0
        self.live = 0
        self.live_bytes = 0
        # off → (encoded db key, frame length) per LIVE entry (compaction
        # moves these; release drops them)
        self.keys: dict[int, tuple[bytes, int]] = {}


class ColdStore:
    """Append-only CRC-framed segment files holding spilled state values.

    No fsync anywhere: the store is a cache (see module docstring) — a torn
    frame after a crash is impossible to even observe because open() wipes
    the directory. Reads go through ``os.pread`` (thread-safe, no shared
    file position) and only ever see flushed bytes: ``append`` buffers, and
    the spiller installs refs into the db strictly after ``flush()``.
    """

    def __init__(self, directory: str | Path,
                 segment_max_bytes: int = 32 << 20) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        for stale in self.directory.glob("cold-*.seg"):
            try:
                stale.unlink()
            except OSError:
                pass
        self.segment_max_bytes = segment_max_bytes
        self._segments: dict[int, _Segment] = {}
        self._next_seg = 0
        self._current: _Segment | None = None
        self.bytes_written = 0

    # -- write side ------------------------------------------------------------

    def _roll(self) -> _Segment:
        self._next_seg += 1
        seg = _Segment(self._next_seg,
                       self.directory / f"cold-{self._next_seg:08d}.seg")
        self._segments[seg.seg_id] = seg
        self._current = seg
        return seg

    def append(self, key: bytes, packed: bytes, tag: int = -1) -> ColdRef:
        seg = self._current
        if seg is None or seg.size >= self.segment_max_bytes:
            if seg is not None:
                seg.write_f.flush()
            seg = self._roll()
        crc = zlib.crc32(packed, zlib.crc32(key)) & 0xFFFFFFFF
        frame_len = _FRAME.size + len(key) + len(packed)
        seg.write_f.write(_FRAME.pack(frame_len, crc, len(key)))
        seg.write_f.write(key)
        seg.write_f.write(packed)
        ref = ColdRef(seg.seg_id, seg.size, frame_len, tag)
        seg.keys[seg.size] = (key, frame_len)
        seg.size += frame_len
        seg.live += 1
        seg.live_bytes += frame_len
        self.bytes_written += frame_len
        return ref

    def flush(self) -> None:
        if self._current is not None:
            self._current.write_f.flush()

    # -- read side -------------------------------------------------------------

    def read_value(self, ref: ColdRef) -> bytes:
        seg = self._segments.get(ref.seg)
        if seg is None:
            raise ValueError(f"cold segment {ref.seg} is gone ({ref!r})")
        try:
            raw = storage_io.pread(seg.read_fd, ref.length, ref.off)
        except OSError as exc:
            # EIO on fault-in: same degradation class as corruption — the
            # frame is unreadable, the value must rebuild from chain + log
            raise ColdCorruptionError(
                f"cold read failed at {ref!r}: {exc}", ref=ref) from exc
        if len(raw) != ref.length:
            raise ColdCorruptionError(f"short cold read at {ref!r}", ref=ref)
        frame_len, crc, key_len = _FRAME.unpack_from(raw)
        payload = raw[_FRAME.size:]
        if frame_len != ref.length or \
                zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ColdCorruptionError(
                f"corrupt cold frame at {ref!r} (crc mismatch)", ref=ref)
        return payload[key_len:]

    def scrub(self, cursor: tuple[int, int], max_bytes: int
              ) -> tuple[tuple[int, int], int, dict | None]:
        """CRC-walk sealed segments' frames from ``cursor=(seg_id, off)``
        for up to ``max_bytes`` scrubber). Returns ``(next_cursor,
        scanned_bytes, corruption)``; a ``(0, 0)`` next cursor means the
        walk wrapped. Sealed segments only — the current segment still has
        a buffered tail. Pump-thread only (segments roll/drop there)."""
        seg_ids = sorted(s for s, seg in self._segments.items()
                         if seg is not self._current)
        scanned = 0
        seg_id, off = cursor
        for sid in seg_ids:
            if sid < seg_id:
                continue
            seg = self._segments.get(sid)
            if seg is None:
                continue
            pos = off if sid == seg_id else 0
            while pos < seg.size and scanned < max_bytes:
                head = storage_io.pread(seg.read_fd, _FRAME.size, pos)
                if len(head) < _FRAME.size:
                    return ((sid, pos), scanned,
                            {"segment": sid, "offset": pos,
                             "reason": "short-header"})
                frame_len, crc, _key_len = _FRAME.unpack_from(head)
                if frame_len < _FRAME.size or pos + frame_len > seg.size:
                    return ((sid, pos), scanned,
                            {"segment": sid, "offset": pos,
                             "reason": "bad-frame-length"})
                payload = storage_io.pread(
                    seg.read_fd, frame_len - _FRAME.size, pos + _FRAME.size)
                scanned += frame_len
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    return ((sid, pos), scanned,
                            {"segment": sid, "offset": pos,
                             "reason": "crc-mismatch"})
                pos += frame_len
            if scanned >= max_bytes:
                return (sid, pos), scanned, None
        return (0, 0), scanned, None

    # -- reclamation -----------------------------------------------------------

    def release(self, ref: ColdRef) -> None:
        """The ref's value faulted in, was overwritten, or was deleted."""
        seg = self._segments.get(ref.seg)
        if seg is None:
            return
        if seg.keys.pop(ref.off, None) is not None:
            seg.live -= 1
            seg.live_bytes -= ref.length
        if seg.live <= 0 and seg is not self._current:
            self._drop(seg)

    def _drop(self, seg: _Segment) -> None:
        self._segments.pop(seg.seg_id, None)
        try:
            seg.write_f.close()
        except OSError:
            pass
        try:
            os.close(seg.read_fd)
        except OSError:
            pass
        try:
            seg.path.unlink()
        except OSError:
            pass

    def worst_segment(self) -> _Segment | None:
        """The sealed segment with the most dead bytes (compaction pick)."""
        worst, worst_dead = None, 0
        for seg in self._segments.values():
            if seg is self._current:
                continue
            dead = seg.size - seg.live_bytes
            if dead > worst_dead:
                worst, worst_dead = seg, dead
        return worst

    # -- accounting ------------------------------------------------------------

    # accounting reads run on management HTTP threads while the pump thread
    # rolls/drops segments: snapshot the dict (list() is atomic under the
    # GIL) so iteration never races a size change

    @property
    def live_entries(self) -> int:
        return sum(seg.live for seg in list(self._segments.values()))

    @property
    def live_bytes(self) -> int:
        return sum(seg.live_bytes for seg in list(self._segments.values()))

    @property
    def disk_bytes(self) -> int:
        return sum(seg.size for seg in list(self._segments.values()))

    @property
    def segment_count(self) -> int:
        return len(self._segments)

    def close(self) -> None:
        for seg in list(self._segments.values()):
            self._drop(seg)
        self._current = None


class TieredZbDb(ZbDb):
    """ZbDb whose committed values may live in the cold store.

    Drop-in for the engine/processor: transactions, column families, FK
    checks, dirty-key delta tracking, and snapshot/delta serialization are
    inherited — serialization resolves cold values from their frames, so a
    tiered partition's snapshots are byte-identical to an untiered one's
    (the crash-safety argument in the module docstring rests on this).

    The native iterate/commit passes are disabled: iterate must resolve
    ``ColdRef`` values per read, and commit must release superseded refs —
    both per-key concerns the C passes don't know. Tiered mode trades that
    sliver of batch throughput for a bounded hot tier.
    """

    def __init__(self, directory: str | Path,
                 consistency_checks: bool = False,
                 segment_max_bytes: int = 32 << 20,
                 partition_id: int = 0) -> None:
        super().__init__(consistency_checks)
        self._native_iterate = None
        self._native_commit = None
        self.cold = ColdStore(directory, segment_max_bytes=segment_max_bytes)
        self.partition_id = partition_id
        # first-fault-of-an-instance observation (tiering manager wake seam)
        self.woken_listener: Callable[[int], None] | None = None
        self.spills_total = 0
        self.faults_total = 0
        self._m_spills = _M_SPILLS.labels(str(partition_id))
        self._m_faults = _M_FAULTS.labels(str(partition_id))
        # ewma of packed hot-value size (spill-time observations) for the
        # hot-tier byte estimate surfaced by zeebe_state_tier_bytes
        self._avg_packed = 128.0

    # -- committed-store internals (cold resolution) ---------------------------

    def _committed_value(self, key: bytes) -> Any:
        val = self._data.get(key)
        if type(val) is not ColdRef:
            return val
        obj = msgpack.unpackb(self.cold.read_value(val))
        # fault-in: promote back to hot — the instance is waking up
        self._data[key] = obj
        self.cold.release(val)
        self.faults_total += 1
        self._m_faults.inc()
        if val.tag >= 0 and self.woken_listener is not None:
            self.woken_listener(val.tag)
        return obj

    def _put_committed(self, key: bytes, value: Any) -> None:
        prev = self._data.get(key)
        if type(prev) is ColdRef:
            self.cold.release(prev)
        super()._put_committed(key, value)

    def _delete_committed(self, key: bytes) -> None:
        prev = self._data.get(key)
        if type(prev) is ColdRef:
            self.cold.release(prev)
        super()._delete_committed(key)

    def committed_get(self, code, key_parts) -> Any:
        """Cross-thread committed read (QueryService): resolves cold values
        WITHOUT promoting — no dict/LRU mutation off the owner thread.
        ``pread`` + an immutable ref make the read itself thread-safe; if a
        pump-thread compaction drops the ref's segment between our dict read
        and the pread, the retry sees the already-swapped new ref (the swap
        happens strictly before the release)."""
        if not isinstance(key_parts, tuple):
            key_parts = (key_parts,)
        key = encode_key(code, key_parts)
        for attempt in (0, 1):
            val = self._data.get(key)
            if type(val) is not ColdRef:
                return val
            try:
                return msgpack.unpackb(self.cold.read_value(val))
            except (OSError, ValueError, ColdCorruptionError):
                if attempt:
                    raise
        return None  # unreachable

    # -- spill (the tiering manager's write path) ------------------------------

    def spill_keys(self, keys: list[bytes], tag: int = -1) -> tuple[int, int]:
        """Demote the given committed keys' values to the cold store.
        Two-phase: every frame is appended and FLUSHED before any ``ColdRef``
        becomes visible in ``_data`` — a concurrent query-thread read of a
        ref can then always ``pread`` it. Values that are None (pure index
        entries), already cold, or not containers stay put. Returns
        (records spilled, packed bytes)."""
        if self.in_transaction:
            raise RuntimeError("cannot spill with an open transaction")
        staged: list[tuple[bytes, ColdRef]] = []
        spilled_bytes = 0
        data = self._data
        for key in keys:
            val = data.get(key)
            t = type(val)
            if val is None or t is ColdRef or not (t is dict or t is list):
                continue
            packed = msgpack.packb(val)
            staged.append((key, self.cold.append(key, packed, tag)))
            spilled_bytes += len(packed)
            self._avg_packed += (len(packed) - self._avg_packed) * 0.01
        if not staged:
            return 0, 0
        self.cold.flush()
        for key, ref in staged:
            data[key] = ref
        self.spills_total += len(staged)
        self._m_spills.inc(len(staged))
        return len(staged), spilled_bytes

    def compact_cold(self, max_moves: int = 4096,
                     min_dead_bytes: int = 4 << 20,
                     min_dead_fraction: float = 0.5) -> int:
        """Rewrite the worst sealed segment's survivors into the current
        segment and unlink it. Runs on the pump thread; each key's ref swaps
        atomically (one dict assignment), so concurrent query-thread reads
        see either the old frame (file still open) or the new one."""
        seg = self.cold.worst_segment()
        if seg is None:
            return 0
        dead = seg.size - seg.live_bytes
        if dead < min_dead_bytes or dead < seg.size * min_dead_fraction:
            return 0
        data = self._data
        # two-phase like spill_keys: append every survivor, ONE flush, then
        # swap the refs — frames are visible before any ref publishes, and
        # the pump pays one flush per pass instead of one per frame
        staged: list[tuple[bytes, ColdRef, ColdRef]] = []
        for off, (key, length) in list(seg.keys.items()):
            if len(staged) >= max_moves:
                break
            ref = data.get(key)
            if type(ref) is not ColdRef or ref.seg != seg.seg_id \
                    or ref.off != off:
                # the index lost track (overwritten without release — should
                # not happen, but never move a frame the db doesn't own)
                if seg.keys.pop(off, None) is not None:
                    seg.live -= 1
                    seg.live_bytes -= length
                continue
            packed = self.cold.read_value(ref)
            staged.append((key, ref, self.cold.append(key, packed, ref.tag)))
        if staged:
            self.cold.flush()
        for key, old_ref, new_ref in staged:
            data[key] = new_ref
            self.cold.release(old_ref)
        if seg.live <= 0:
            self.cold._drop(seg)
        return len(staged)

    # -- snapshot/delta serialization (cold values resolve) --------------------

    def _resolve(self, val: Any) -> Any:
        if type(val) is ColdRef:
            return msgpack.unpackb(self.cold.read_value(val))
        return val

    def to_snapshot_bytes(self) -> bytes:
        """Full serialization with cold frames resolved in place: the bytes
        are identical to an untiered db holding the same logical state (the
        chain a follower installs or recovery loads never knows tiers)."""
        if self.in_transaction:
            raise RuntimeError("cannot snapshot with an open transaction")
        body = msgpack.packb(
            [[k, self._resolve(self._data[k])] for k in self._sorted_keys]
        )
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return self.SNAPSHOT_MAGIC + struct.pack("<I", crc) + body

    def to_delta_bytes(self) -> bytes:
        if self.in_transaction:
            raise RuntimeError("cannot snapshot with an open transaction")
        if self._dirty_keys is None:
            raise RuntimeError("delta tracking is not active")
        data = self._data
        entries = []
        for key in sorted(self._dirty_keys):
            if key in data:
                entries.append([key, False, self._resolve(data[key])])
            else:
                entries.append([key, True, None])
        body = msgpack.packb(entries)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return self.DELTA_MAGIC + struct.pack("<I", crc) + body

    def content_equals(self, other: ZbDb) -> bool:
        if set(self._data) != set(other._data):
            return False
        other_resolve = getattr(other, "_resolve", lambda v: v)
        for key, val in self._data.items():
            if self._resolve(val) != other_resolve(other._data[key]):
                return False
        return True

    # -- accounting ------------------------------------------------------------

    def tier_stats(self) -> dict:
        cold_keys = self.cold.live_entries
        hot_keys = len(self._data) - cold_keys
        return {
            "hotKeys": hot_keys,
            "coldKeys": cold_keys,
            "coldBytes": self.cold.live_bytes,
            "coldDiskBytes": self.cold.disk_bytes,
            "coldSegments": self.cold.segment_count,
            # estimate: resident hot values × learned mean packed size (the
            # exact number would cost an O(hot) pack pass)
            "hotBytesEstimate": int(hot_keys * self._avg_packed),
            "spills": self.spills_total,
            "faults": self.faults_total,
        }

    def close(self) -> None:
        self.cold.close()


@dataclasses.dataclass
class TieringCfg:
    """Knobs (env: ``ZEEBE_BROKER_DATA_TIERING*``, broker/config.py)."""

    enabled: bool = False
    #: an instance must stay parked this long before it spills — short
    #: waits (job round-trips, immediate correlations) never touch disk
    park_after_ms: int = 30_000
    #: instances spilled per pump pass (bounds pump-stall per pass)
    spill_batch: int = 256
    #: tiering-manager pass cadence on the pump
    check_interval_ms: int = 1_000
    #: cold segment roll size
    segment_max_bytes: int = 32 << 20


class TieringManager:
    """Decides *what* parks and *when* it spills; the db does the moving.

    Candidates arrive via ``ZbDb.note_parked`` (timer created, message
    subscription opened, job created — fired on processing AND replay, so a
    promoted follower's manager is warm). A candidate that stays parked past
    ``park_after_ms`` has its whole instance subtree spilled: element
    instances (walked through the parent/child index), their variables,
    message subscriptions, timers, and jobs. Wake-ups are observed through
    the db's first-fault ``woken_listener`` so instance accounting stays
    honest without any read-path bookkeeping."""

    def __init__(self, db: TieredZbDb, clock_millis: Callable[[], int],
                 cfg: TieringCfg, partition_id: int = 0) -> None:
        self.db = db
        self.clock_millis = clock_millis
        self.cfg = cfg
        self.partition_id = partition_id
        self._candidates: OrderedDict[int, int] = OrderedDict()
        self._spilled: set[int] = set()
        self._last_check_ms = 0
        # write-error degradation: a persistent OSError
        # (ENOSPC/EIO) during spill/compaction latches DEGRADED — no new
        # spill batches are admitted, the pump thread survives, and cold
        # values already faulted-in (or still readable) keep serving. The
        # next partition transition rebuilds the manager (and wipes the
        # cold dir), which is the retry path.
        self.degraded = False
        self.degraded_reason: str | None = None
        db.park_listener = self.note_parked
        db.woken_listener = self.note_woken
        self._m_instances = _M_SPILLED_INSTANCES.labels(str(partition_id))
        self._m_segments = _M_COLD_SEGMENTS.labels(str(partition_id))

    # -- seams -----------------------------------------------------------------

    def note_parked(self, process_instance_key: int) -> None:
        if process_instance_key < 0 or process_instance_key in self._spilled:
            return
        if process_instance_key not in self._candidates:
            self._candidates[process_instance_key] = self.clock_millis()

    def note_woken(self, process_instance_key: int) -> None:
        if process_instance_key in self._spilled:
            self._spilled.discard(process_instance_key)
            self._m_instances.set(float(len(self._spilled)))

    @property
    def spilled_instances(self) -> int:
        return len(self._spilled)

    @property
    def pending_candidates(self) -> int:
        return len(self._candidates)

    # -- the pump hook ---------------------------------------------------------

    def maybe_run(self, now_ms: int | None = None) -> int:
        """One tiering pass (throttled): spill due candidates, reclaim cold
        garbage. Called from the partition pump between transactions."""
        now = self.clock_millis() if now_ms is None else now_ms
        if now - self._last_check_ms < self.cfg.check_interval_ms:
            return 0
        self._last_check_ms = now
        if self.degraded:
            return 0  # no new spill batches; reads/fault-ins stay servable
        spilled = 0
        horizon = now - self.cfg.park_after_ms
        try:
            while self._candidates and spilled < self.cfg.spill_batch:
                pi_key, noted_at = next(iter(self._candidates.items()))
                if noted_at > horizon:
                    break  # FIFO order: the rest are younger
                self._candidates.popitem(last=False)
                if self.spill_instance(pi_key):
                    spilled += 1
            if spilled:
                self._m_instances.set(float(len(self._spilled)))
            self.db.compact_cold()
            self._m_segments.set(float(self.db.cold.segment_count))
        except OSError as exc:
            # ENOSPC/EIO on the cold dir: a half-appended frame is harmless
            # (refs only publish after flush), but the segment write cursor
            # can no longer be trusted — latch DEGRADED instead of poisoning
            # the pump thread on every pass
            self.degraded = True
            self.degraded_reason = f"{type(exc).__name__}: {exc}"
            _M_TIER_WRITE_ERRORS.labels(str(self.partition_id)).inc()
            import logging

            logging.getLogger("zeebe_tpu_torch.state.tiering").error(
                "partition %s cold-tier write failed (%s); tiering DEGRADED "
                "— parked instances stay hot, cold reads keep serving",
                self.partition_id, self.degraded_reason)
        return spilled

    # -- instance spilling -----------------------------------------------------

    def instance_keys(self, pi_key: int) -> list[bytes]:
        """The committed key set of one process instance's parked state:
        element-instance records (tree walk over the parent/child index),
        variables per scope, message subscriptions, timers, and jobs.
        Committed-read only (runs between transactions on the pump)."""
        from zeebe_tpu_torch.engine.engine_state import _decode_trailing_i64
        from zeebe_tpu_torch.state import ColumnFamilyCode as CF

        db = self.db
        data = db._data
        out: list[bytes] = []
        element_keys = [pi_key]
        frontier = [pi_key]
        while frontier:
            scope = frontier.pop()
            for enc in db.committed_keys_of(
                    CF.ELEMENT_INSTANCE_PARENT_CHILD, (scope,)):
                child = _decode_trailing_i64(enc)
                element_keys.append(child)
                frontier.append(child)
        for e in element_keys:
            ei_key = encode_key(CF.ELEMENT_INSTANCE_KEY, (e,))
            record = data.get(ei_key)
            out.append(ei_key)
            out.extend(db.committed_keys_of(CF.VARIABLES, (e,)))
            out.extend(db.committed_keys_of(
                CF.PROCESS_SUBSCRIPTION_BY_KEY, (e,)))
            for enc in db.committed_keys_of(CF.TIMER_BY_ELEMENT, (e,)):
                out.append(encode_key(CF.TIMERS,
                                      (_decode_trailing_i64(enc),)))
            if type(record) is dict:
                job_key = record.get("jobKey", -1)
                if job_key is not None and job_key >= 0:
                    out.append(encode_key(CF.JOBS, (job_key,)))
        return out

    def spill_instance(self, pi_key: int) -> bool:
        db = self.db
        from zeebe_tpu_torch.state import ColumnFamilyCode as CF

        root = db._data.get(encode_key(CF.ELEMENT_INSTANCE_KEY, (pi_key,)))
        if root is None or type(root) is ColdRef:
            return False  # instance finished, or already cold
        n, _ = db.spill_keys(self.instance_keys(pi_key), tag=pi_key)
        if n == 0:
            return False
        self._spilled.add(pi_key)
        return True
