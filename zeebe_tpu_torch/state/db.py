"""Column-family KV state store with transactions — the zb-db equivalent.

Reference: zb-db/src/main/java/io/camunda/zeebe/db/ZeebeDb.java,
impl/rocksdb/transaction/ZeebeTransaction.java:22, TransactionalColumnFamily,
DbLong/DbString/DbCompositeKey key types, ConsistencyChecksSettings.java:10.

Like the reference — a single store where *logical* column families share one
keyspace via an enum prefix — but host-memory-resident: the data set a
partition owns is bounded by snapshot size, the durability story is the log +
snapshots (state is always recomputable by replay), so an LSM on disk buys
nothing on the hot path. The store is an ordered map from encoded
``(cf, *key_parts)`` tuples to msgpack-able values, with:

- order-preserving key encoding (ints sign-flipped big-endian, strings
  NUL-terminated) so prefix iteration matches RocksDB iterator semantics;
- optimistic transactions: an overlay of pending puts/deletes applied on
  commit, discarded on rollback — the processing state machine wraps each
  command batch in one transaction (reference: ProcessingStateMachine:55-93);
- optional foreign-key consistency checks (reference: ForeignKeyChecker);
- whole-state serialization for the snapshot store (state/snapshot.py).
"""

from __future__ import annotations

import enum
import struct
import zlib
from bisect import bisect_left, insort
from typing import Any, Callable, Iterator

from zeebe_tpu_torch.native import codec_fn as _codec_fn
from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.utils import evict_oldest_half as _evict_oldest_half

_commit_overlay = _codec_fn("commit_overlay")
_iterate_snapshot = _codec_fn("iterate_snapshot")


class ZbDbInconsistentError(Exception):
    """A consistency check failed (reference: ZeebeDbInconsistentException)."""


class ColumnFamilyCode(enum.IntEnum):
    """Logical column families (reference: protocol/…/ZbColumnFamilies.java:20).

    Only families the engine currently uses are defined; codes are append-only
    and are the first byte of every encoded key.
    """

    DEFAULT = 0
    KEY = 1  # key generator state
    PROCESS_VERSION = 2
    PROCESS_CACHE = 3
    PROCESS_CACHE_BY_ID_AND_VERSION = 4
    PROCESS_CACHE_DIGEST_BY_ID = 5
    ELEMENT_INSTANCE_PARENT_CHILD = 6
    ELEMENT_INSTANCE_KEY = 7
    NUMBER_OF_TAKEN_SEQUENCE_FLOWS = 8
    JOBS = 10
    JOB_STATES = 11
    JOB_DEADLINES = 12
    JOB_ACTIVATABLE = 13
    JOB_BACKOFF = 14
    MESSAGE_KEY = 20
    MESSAGES = 21
    MESSAGE_DEADLINES = 22
    MESSAGE_IDS = 23
    MESSAGE_CORRELATED = 24
    MESSAGE_PROCESSES = 25
    MESSAGE_SUBSCRIPTION_BY_KEY = 30
    MESSAGE_SUBSCRIPTION_BY_SENT_TIME = 31
    MESSAGE_SUBSCRIPTION_BY_NAME_AND_CORRELATION_KEY = 32
    PROCESS_SUBSCRIPTION_BY_KEY = 33
    MESSAGE_START_EVENT_SUBSCRIPTION_BY_NAME_AND_KEY = 34
    MESSAGE_START_EVENT_SUBSCRIPTION_BY_KEY_AND_NAME = 35
    TIMERS = 40
    TIMER_DUE_DATES = 41
    TIMER_BY_ELEMENT = 42
    PENDING_DEPLOYMENT = 50
    DEPLOYMENT_RAW = 51
    EVENT_SCOPE = 60
    EVENT_TRIGGER = 61
    VARIABLES = 70
    TEMPORARY_VARIABLE_STORE = 71
    INCIDENTS = 80
    INCIDENT_PROCESS_INSTANCES = 81
    INCIDENT_JOBS = 82
    BANNED_INSTANCE = 90
    EXPORTER = 100
    LAST_PROCESSED_POSITION = 101
    MIGRATIONS_STATE = 102
    PROCESS_INSTANCE_KEY_BY_DEFINITION_KEY = 103
    SIGNAL_SUBSCRIPTION_BY_NAME_AND_KEY = 110
    SIGNAL_SUBSCRIPTION_BY_KEY_AND_NAME = 111
    DISTRIBUTION = 120
    PENDING_DISTRIBUTION = 121
    COMMAND_DISTRIBUTION_RECORD = 122
    RECEIVED_DISTRIBUTION_BY_TIME = 123
    MULTI_INSTANCE_OUTPUT = 130
    AWAIT_RESULT_METADATA = 131
    CHECKPOINT = 140
    FORMS = 150
    FORM_BY_ID_AND_VERSION = 151
    FORM_VERSION = 152
    FORM_DIGEST = 153
    DMN_DECISIONS = 160
    DMN_DECISION_REQUIREMENTS = 161
    DMN_LATEST_DECISION_BY_ID = 162
    DMN_LATEST_DRG_BY_ID = 163
    DMN_DECISIONS_BY_DRG = 164
    USER_TASKS = 170
    USER_TASK_STATES = 171
    COMPENSATION_SUBSCRIPTION = 180
    PROCESS_INSTANCE_RESULT = 190
    # replicated request dedupe: (gateway stream id, request id) →
    # {command position, stored reply frame}; the BY_POSITION index ages
    # entries out by log position. Materialized on processing AND replay, so
    # followers and restarted leaders inherit acked-command identity.
    REQUEST_DEDUPE = 200
    REQUEST_DEDUPE_BY_POSITION = 201


_I64 = struct.Struct(">Q")
_INT_PART = struct.Struct(">BQ")  # tag 0x01 + sign-flipped u64, fused


def _encode_part(part: Any, out: bytearray) -> None:
    """Order-preserving encoding per key part, type-tagged so mixed-type parts
    cannot collide: ints sort before strings sort before bytes."""
    if isinstance(part, bool):
        raise TypeError("bool key parts are ambiguous; use int 0/1")
    if isinstance(part, int):
        # flip sign bit: two's-complement int64 → lexicographically ordered u64
        out += _INT_PART.pack(0x01, (part & 0xFFFFFFFFFFFFFFFF) ^ 0x8000000000000000)
    elif isinstance(part, str):
        raw = part.encode("utf-8")
        if b"\x00" in raw:
            raise ValueError("NUL byte in string key part")
        out.append(0x02)
        out += raw
        out.append(0x00)
    elif isinstance(part, bytes):
        out.append(0x03)
        out += _I64.pack(len(part))
        out += part
    else:
        raise TypeError(f"unsupported key part type {type(part).__name__}")


# per-CF 2-byte prefixes, precomputed (encode_key runs several times per
# command on the admission/processing hot path)
_CF_PREFIX = {code: struct.pack(">H", int(code)) for code in ColumnFamilyCode}


_encode_key_native = _codec_fn("encode_key")


_INT2_PART = struct.Struct(">BQBQ")  # two fused int parts (tag+payload ×2)
_SIGN_FLIP = 0x8000000000000000
_U64_MASK = 0xFFFFFFFFFFFFFFFF


def _encode_key_py(cf: ColumnFamilyCode, parts: tuple) -> bytes:
    """Pure-Python encoding — THE SPEC the native pass must byte-match
    (tests/test_native_codec.py TestNativeEncodeKey fuzzes equality)."""
    prefix = _CF_PREFIX[cf]
    n = len(parts)
    # preallocated struct-packed fast paths for the dominant shapes:
    # (int,), (int, int), and (int, str)
    if n == 1:
        p0 = parts[0]
        if type(p0) is int:
            return prefix + _INT_PART.pack(
                0x01, (p0 & _U64_MASK) ^ _SIGN_FLIP)
    elif n == 2:
        p0, p1 = parts
        if type(p0) is int:
            if type(p1) is int:
                return prefix + _INT2_PART.pack(
                    0x01, (p0 & _U64_MASK) ^ _SIGN_FLIP,
                    0x01, (p1 & _U64_MASK) ^ _SIGN_FLIP)
            if type(p1) is str:
                raw = p1.encode("utf-8")
                if b"\x00" not in raw:
                    return b"".join((
                        prefix,
                        _INT_PART.pack(0x01, (p0 & _U64_MASK) ^ _SIGN_FLIP),
                        b"\x02", raw, b"\x00"))
    out = bytearray(prefix)
    for part in parts:
        _encode_part(part, out)
    return bytes(out)


_raw_encode_key = (
    (lambda cf, parts: _encode_key_native(_CF_PREFIX[cf], parts))
    if _encode_key_native is not None
    else _encode_key_py
)

# encoded-key LRU keyed by (cf, parts): the admission/processing hot path
# re-derives the same handful of keys several times per command (element
# instance by key, job by key, variables by (scope, name), …). Measured: a
# dict hit beats the pure-Python encoder ~2-8x (most for multi-part/str
# keys) but LOSES to the native codec's direct call — so the cache fronts
# only the Python fallback; with the native codec loaded, encode_key stays
# the direct native call. Only int/str/bytes parts are cacheable: Python
# equality would otherwise alias 1.0/True onto an int entry and silently
# bypass the codec's type rejection (int, str, and bytes never compare
# equal across types, so the tuple key is collision-free within that set).
_KEY_CACHE_LIMIT = 16384
_key_cache: dict[tuple, bytes] = {}


def _encode_key_cached(cf: ColumnFamilyCode, parts: tuple) -> bytes:
    for p in parts:
        t = type(p)
        if t is not int and t is not str and t is not bytes:
            return _raw_encode_key(cf, parts)
    key = (int(cf), parts)
    cached = _key_cache.get(key)
    if cached is not None:
        return cached
    encoded = _raw_encode_key(cf, parts)
    _evict_oldest_half(_key_cache, _KEY_CACHE_LIMIT)
    _key_cache[key] = encoded
    return encoded


encode_key = (
    _raw_encode_key if _encode_key_native is not None else _encode_key_cached
)


def decode_key(encoded: bytes) -> tuple[ColumnFamilyCode, tuple]:
    """Inverse of encode_key: used by state migrations to inspect and rewrite
    keys whose shape changed between versions (reference: DbMigratorImpl
    migration tasks iterate raw column families)."""
    cf = ColumnFamilyCode(struct.unpack_from(">H", encoded)[0])
    parts: list = []
    i = 2
    n = len(encoded)
    while i < n:
        tag = encoded[i]
        i += 1
        if tag == 0x01:
            raw = _I64.unpack_from(encoded, i)[0] ^ 0x8000000000000000
            parts.append(raw - (1 << 64) if raw >= (1 << 63) else raw)
            i += 8
        elif tag == 0x02:
            j = encoded.index(0, i)
            parts.append(encoded[i:j].decode("utf-8"))
            i = j + 1
        elif tag == 0x03:
            length = _I64.unpack_from(encoded, i)[0]
            i += 8
            parts.append(encoded[i:i + length])
            i += length
        else:
            raise ValueError(f"unknown key part tag 0x{tag:02x}")
    return cf, tuple(parts)


_DELETED = object()
_MISSING_READ = object()


def _prefix_successor(prefix: bytes) -> bytes | None:
    """The smallest byte string greater than every string starting with
    ``prefix`` (exact range upper bound for sorted-key bisects), or None when
    no such bound exists (prefix is empty or all 0xff)."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


class Transaction:
    """Pending puts/deletes overlaying the committed store.

    ``_sorted_writes`` mirrors ``_writes``'s keys in sorted order (insort on
    first write of a key) so prefix iteration is a bisect range over the
    overlay instead of a full overlay scan — batch processing applies tens of
    thousands of events in one transaction, and an O(pending-writes) cost per
    ``iterate`` call turns the group quadratic."""

    __slots__ = ("_db", "_writes", "_sorted_writes", "_reads", "closed", "capture")

    def __init__(self, db: "ZbDb") -> None:
        self._db = db
        self._writes: dict[bytes, Any] = {}
        self._sorted_writes: list[bytes] = []
        # per-transaction read cache of defensively-copied committed values
        # (one copy per key per transaction; see get)
        self._reads: dict[bytes, Any] = {}
        self.closed = False
        # optional write-capture log: when a list, every put/delete is also
        # appended as ("put", key, value) / ("del", key, None) — the burst
        # template builder uses this to learn a command's state write-set
        self.capture: list | None = None

    def _committed_read(self, key: bytes) -> Any:
        """Committed value via the per-transaction copy cache: state code
        mutates fetched documents in place before put(); handing out the
        committed object would leak those mutations into the committed store
        on ROLLBACK (breaking transaction atomicity) and expose mid-mutation
        values to the lock-free committed readers (ZbDb.committed_get).
        Shallow copy: mutators only touch top-level fields (deep structures
        are replaced, not edited). get() and iterate() share the cache so a
        value mutated after a get() is seen identically by a later scan."""
        val = self._reads.get(key, _MISSING_READ)
        if val is not _MISSING_READ:
            return val
        val = self._db._committed_value(key)
        # only containers are copied (and cached): scalars are immutable, and
        # index scans over None/int values must stay allocation-free
        t = type(val)
        if t is dict:
            val = dict(val)
            self._reads[key] = val
        elif t is list:
            val = list(val)
            self._reads[key] = val
        return val

    def get(self, key: bytes) -> Any:
        if key in self._writes:
            val = self._writes[key]
            return None if val is _DELETED else val
        return self._committed_read(key)

    def put(self, key: bytes, value: Any) -> None:
        if key not in self._writes:
            insort(self._sorted_writes, key)
        self._writes[key] = value
        if self.capture is not None:
            self.capture.append(("put", key, value))

    def delete(self, key: bytes) -> None:
        if key not in self._writes:
            insort(self._sorted_writes, key)
        self._writes[key] = _DELETED
        if self.capture is not None:
            self.capture.append(("del", key, None))

    def exists(self, key: bytes) -> bool:
        if key in self._writes:
            return self._writes[key] is not _DELETED
        return key in self._db._data

    def iterate(self, prefix: bytes) -> Iterator[tuple[bytes, Any]]:
        """Ordered iteration over committed ∪ pending entries under prefix.

        Snapshot semantics (RocksDB-iterator-like): the view is materialized at
        call time, so scan-and-update loops (job deadlines, timer due dates)
        see a stable snapshot and never skip or double-see entries mutated
        mid-iteration.
        """
        db = self._db
        if db._native_iterate is not None:
            # one native merge pass (codec.c iterate_snapshot) — identical
            # semantics to the Python path below, including the defensive
            # copy-and-cache of committed container values
            return iter(db._native_iterate(
                db._sorted_keys, db._data, prefix, self._sorted_writes,
                self._writes, _DELETED, self._reads))
        return self.iterate_range(prefix, _prefix_successor(prefix))

    def iterate_range(self, lo: bytes, hi: bytes | None) -> Iterator[tuple[bytes, Any]]:
        """Ordered iteration over committed ∪ pending entries in ``[lo, hi)``.

        The due-date sweep primitive: the work (and the materialized
        snapshot) is O(entries in range), never O(entries under the column
        family) — a million parked deadlines cost a sweep nothing when none
        are due. Same snapshot semantics as ``iterate``."""
        db = self._db
        snapshot: list[tuple[bytes, Any]] = []
        writes = self._writes
        sw = self._sorted_writes
        wlo = bisect_left(sw, lo)
        whi = bisect_left(sw, hi) if hi is not None else len(sw)
        overlay_keys = sw[wlo:whi]
        if not overlay_keys:
            for key in db._keys_in_range(lo, hi):
                snapshot.append((key, self._committed_read(key)))
            return iter(snapshot)
        overlay = set(overlay_keys)
        for key in db._keys_in_range(lo, hi):
            if key in overlay:
                continue  # superseded by pending write/delete
            snapshot.append((key, self._committed_read(key)))
        for key in overlay_keys:
            val = writes[key]
            if val is not _DELETED:
                snapshot.append((key, val))
        snapshot.sort(key=lambda kv: kv[0])
        return iter(snapshot)

    def first_in_range(self, lo: bytes, hi: bytes | None) -> tuple[bytes, Any] | None:
        """Smallest committed-∪-pending entry in ``[lo, hi)``, or None.

        O(log n): one bisect each side plus a skip loop over pending deletes
        — the next-due-date probe that used to materialize a whole index."""
        db = self._db
        writes = self._writes
        sw = self._sorted_writes
        wi = bisect_left(sw, lo)
        cursor = lo
        while True:
            ck = db._first_key_at_or_after(cursor, hi)
            wk = None
            while wi < len(sw):
                k = sw[wi]
                if hi is not None and k >= hi:
                    break
                if k >= cursor:
                    wk = k
                    break
                wi += 1
            if wk is not None and (ck is None or wk <= ck):
                val = writes[wk]
                if val is _DELETED:
                    # deleted overlay entry shadows any committed twin; skip
                    # past it in both streams
                    wi += 1
                    cursor = wk + b"\x00"
                    continue
                return (wk, val)
            if ck is None:
                return None
            return (ck, self._committed_read(ck))

    def commit(self) -> None:
        db = self._db
        dirty = db._dirty_keys
        if dirty is not None and self._writes:
            # incremental-snapshot delta tracking: every committed overlay
            # key (put OR delete) joins the changed-keys-since-last-snapshot
            # set, regardless of which commit pass (native/python/durable)
            # applies it below
            dirty.update(self._writes)
        db._pre_commit(self._writes)
        if db._native_commit is not None:
            # one native pass (codec.c commit_overlay) applying the overlay
            # to the committed dict + sorted-keys list — identical semantics
            # to the per-key loop below
            db._native_commit(self._writes, db._data, db._sorted_keys, _DELETED)
        else:
            for key, val in self._writes.items():
                if val is _DELETED:
                    db._delete_committed(key)
                else:
                    db._put_committed(key, val)
        self._writes.clear()
        self.closed = True

    def rollback(self) -> None:
        self._writes.clear()
        self.closed = True


class ColumnFamily:
    """Typed facade over one logical column family within a transaction context.

    Keys are tuples of (int | str | bytes); values any msgpack-able object.
    Mirrors the reference's TransactionalColumnFamily get/put/iterate surface.
    """

    __slots__ = ("_db", "code", "_prefix")

    def __init__(self, db: "ZbDb", code: ColumnFamilyCode) -> None:
        self._db = db
        self.code = code
        self._prefix = struct.pack(">H", int(code))

    def _ctx(self) -> Transaction:
        return self._db.require_transaction()

    def _key(self, key_parts: tuple) -> bytes:
        if not isinstance(key_parts, tuple):
            key_parts = (key_parts,)
        return encode_key(self.code, key_parts)

    def get(self, key_parts: tuple) -> Any:
        return self._ctx().get(self._key(key_parts))

    def exists(self, key_parts: tuple) -> bool:
        return self._ctx().exists(self._key(key_parts))

    def put(self, key_parts: tuple, value: Any) -> None:
        self._db._check_foreign_keys(self.code, value)
        self._ctx().put(self._key(key_parts), value)

    def insert(self, key_parts: tuple, value: Any) -> None:
        """Put that requires the key to be absent (consistency precondition)."""
        key = self._key(key_parts)
        ctx = self._ctx()
        if self._db.consistency_checks and ctx.exists(key):
            raise ZbDbInconsistentError(f"insert: key already exists in {self.code.name}: {key_parts}")
        self._db._check_foreign_keys(self.code, value)
        ctx.put(key, value)

    def update(self, key_parts: tuple, value: Any) -> None:
        """Put that requires the key to exist (consistency precondition)."""
        key = self._key(key_parts)
        ctx = self._ctx()
        if self._db.consistency_checks and not ctx.exists(key):
            raise ZbDbInconsistentError(f"update: key missing in {self.code.name}: {key_parts}")
        self._db._check_foreign_keys(self.code, value)
        ctx.put(key, value)

    def delete(self, key_parts: tuple) -> None:
        key = self._key(key_parts)
        ctx = self._ctx()
        if self._db.consistency_checks and not ctx.exists(key):
            raise ZbDbInconsistentError(f"delete: key missing in {self.code.name}: {key_parts}")
        ctx.delete(key)

    def items(self, prefix: tuple = ()) -> Iterator[tuple[bytes, Any]]:
        """Iterate (encoded_key, value) pairs under a key-part prefix, ordered."""
        # a key-part prefix encodes exactly like a key of those parts, so the
        # scan prefix rides the same fast path (native/cached) as point keys
        pfx = encode_key(self.code, prefix) if prefix else self._prefix
        yield from self._ctx().iterate(pfx)

    def items_below(self, hi_parts: tuple,
                    prefix: tuple = ()) -> Iterator[tuple[bytes, Any]]:
        """Ordered (encoded_key, value) pairs under ``prefix`` whose key
        parts sort strictly below ``hi_parts`` — the O(in-range) primitive
        for due-date sweeps: ``items_below((now + 1,))`` over a
        ``(deadline, key)`` index touches exactly the due entries, never the
        parked backlog behind them."""
        lo = encode_key(self.code, prefix) if prefix else self._prefix
        hi = encode_key(self.code, hi_parts)
        yield from self._ctx().iterate_range(lo, hi)

    def first_item(self, prefix: tuple = ()) -> tuple[bytes, Any] | None:
        """Smallest (encoded_key, value) under ``prefix`` or None — O(log n),
        where ``next(items())`` materializes the whole prefix first."""
        lo = encode_key(self.code, prefix) if prefix else self._prefix
        return self._ctx().first_in_range(lo, _prefix_successor(lo))

    def values(self, prefix: tuple = ()) -> Iterator[Any]:
        for _, v in self.items(prefix):
            yield v

    def is_empty(self, prefix: tuple = ()) -> bool:
        return self.first_item(prefix) is None

    def first_value(self, prefix: tuple = ()) -> Any:
        item = self.first_item(prefix)
        return None if item is None else item[1]


class ZbDb:
    """The partition state store. One instance per partition.

    ``transaction()`` is a context manager committing on success, rolling back
    on exception — the unit of processing atomicity.
    """

    def __init__(self, consistency_checks: bool = False) -> None:
        self._data: dict[bytes, Any] = {}
        self._sorted_keys: list[bytes] = []
        self._txn: Transaction | None = None
        self.consistency_checks = consistency_checks
        self._foreign_key_checkers: dict[ColumnFamilyCode, Callable[["ZbDb", Any], None]] = {}
        # subclass hooks: the durable backend (state/durable.py) swaps the
        # native iterate/commit out (its cold values need per-read
        # resolution and its key index is a blocked sorted structure, not
        # the flat list the C pass mutates) and journals commit overlays
        # through _pre_commit
        self._native_iterate = _iterate_snapshot
        self._native_commit = _commit_overlay
        # changed-keys-since-last-snapshot set for incremental snapshots
        # (state/snapshot.py delta chains); None = tracking off — one is-None
        # check per commit
        self._dirty_keys: set[bytes] | None = None
        # physical observation seams — NOT state, never replayed:
        # due_listener feeds deadline inserts to the hierarchical timer wheel
        # (engine/timer_wheel.py); park_listener feeds instances entering a
        # wait state to the tiering manager (state/tiering.py). Both fire on
        # processing AND replay (appliers run on both), both tolerate loss
        # (wheel rebuilds at transition; an unspilled instance just stays
        # hot), and both cost one is-None check when unwired.
        self.due_listener: Callable[[int], None] | None = None
        self.park_listener: Callable[[int], None] | None = None

    def note_due(self, due_ms: int) -> None:
        """State facades call this on every deadline-index insert (timer due
        dates, message TTLs, job deadlines/backoff)."""
        listener = self.due_listener
        if listener is not None:
            listener(due_ms)

    def note_parked(self, process_instance_key: int) -> None:
        """State facades call this when an instance enters a wait state
        (timer created, message subscription opened, job created)."""
        listener = self.park_listener
        if listener is not None:
            listener(process_instance_key)

    def key_counts_by_cf(self) -> dict[str, int]:
        """Committed key count per (non-empty) column family — one boundary
        bisect per CF over the sorted index, O(cfs × log n): cheap enough
        for the metrics cadence (``zeebe_state_keys{cf=…}``)."""
        out: dict[str, int] = {}
        for code, prefix in _CF_PREFIX.items():
            end = _prefix_successor(prefix)
            count = self._count_key_range(prefix, end)
            if count:
                out[code.name] = count
        return out

    def _count_key_range(self, lo: bytes, hi: bytes | None) -> int:
        i = bisect_left(self._sorted_keys, lo)
        j = (bisect_left(self._sorted_keys, hi) if hi is not None
             else len(self._sorted_keys))
        return j - i

    def committed_keys_of(self, code: ColumnFamilyCode,
                          prefix_parts: tuple = ()) -> list[bytes]:
        """Encoded COMMITTED keys under a column family (optionally a
        key-part prefix) without opening a transaction or materializing
        values — the timer-wheel rebuild and tiering scans read key indexes
        only. The returned list holds references into the sorted index, so a
        million keys cost one slice, not a million tuples."""
        pfx = (encode_key(code, prefix_parts) if prefix_parts
               else _CF_PREFIX[code])
        return self._keys_with_prefix(pfx)

    # -- committed-store internals ------------------------------------------

    def _committed_value(self, key: bytes) -> Any:
        """Committed read hook — overridden by backends whose stored
        representation needs resolving (durable cold values)."""
        return self._data.get(key)

    def _pre_commit(self, writes: dict[bytes, Any]) -> None:
        """Called with the overlay just before it applies — the durable
        backend appends it to the write-ahead delta log here."""

    def _put_committed(self, key: bytes, value: Any) -> None:
        if key not in self._data:
            insort(self._sorted_keys, key)
        self._data[key] = value

    def _delete_committed(self, key: bytes) -> None:
        if key in self._data:
            del self._data[key]
            i = bisect_left(self._sorted_keys, key)
            if i < len(self._sorted_keys) and self._sorted_keys[i] == key:
                self._sorted_keys.pop(i)

    def _keys_with_prefix(self, prefix: bytes) -> list[bytes]:
        return self._keys_in_range(prefix, _prefix_successor(prefix))

    def _keys_in_range(self, lo: bytes, hi: bytes | None) -> list[bytes]:
        i = bisect_left(self._sorted_keys, lo)
        j = bisect_left(self._sorted_keys, hi) if hi is not None else len(self._sorted_keys)
        return self._sorted_keys[i:j]

    def _first_key_at_or_after(self, lo: bytes, hi: bytes | None) -> bytes | None:
        i = bisect_left(self._sorted_keys, lo)
        if i >= len(self._sorted_keys):
            return None
        key = self._sorted_keys[i]
        if hi is not None and key >= hi:
            return None
        return key

    # -- transactions --------------------------------------------------------

    def transaction(self) -> "_TxnContext":
        self._before_transaction()
        return _TxnContext(self)

    def _before_transaction(self) -> None:
        """Hook before a transaction opens — the durable backend finishes
        lazy recovery (base-segment indexing) here."""

    def committed_get(self, code: ColumnFamilyCode, key_parts: tuple) -> Any:
        """Lock-free point read of the COMMITTED store, bypassing the single
        processing-owned transaction slot — the cross-thread read path for
        the QueryService (reference: StateQueryService reads a RocksDB
        snapshot concurrently with processing). An open processing
        transaction's uncommitted writes are invisible, exactly as with a
        storage snapshot; dict point reads are atomic under the GIL."""
        if not isinstance(key_parts, tuple):
            key_parts = (key_parts,)
        return self._data.get(encode_key(code, key_parts))

    def require_transaction(self) -> Transaction:
        if self._txn is None or self._txn.closed:
            raise RuntimeError("state access outside a transaction")
        return self._txn

    @property
    def in_transaction(self) -> bool:
        return self._txn is not None and not self._txn.closed

    # -- column families -----------------------------------------------------

    def column_family(self, code: ColumnFamilyCode) -> ColumnFamily:
        return ColumnFamily(self, code)

    def register_foreign_key_check(
        self, code: ColumnFamilyCode, check: Callable[["ZbDb", Any], None]
    ) -> None:
        self._foreign_key_checkers[code] = check

    def _check_foreign_keys(self, code: ColumnFamilyCode, value: Any) -> None:
        if self.consistency_checks:
            checker = self._foreign_key_checkers.get(code)
            if checker is not None:
                checker(self, value)

    # -- snapshot serialization ---------------------------------------------

    SNAPSHOT_MAGIC = b"ZSNP\x01"

    def to_snapshot_bytes(self) -> bytes:
        """Serialize the committed state (msgpack body + crc32 trailer)."""
        if self.in_transaction:
            raise RuntimeError("cannot snapshot with an open transaction")
        body = msgpack.packb(
            [[k, v] for k, v in ((k, self._data[k]) for k in self._sorted_keys)]
        )
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return self.SNAPSHOT_MAGIC + struct.pack("<I", crc) + body

    @classmethod
    def from_snapshot_bytes(cls, raw: bytes, consistency_checks: bool = False) -> "ZbDb":
        db = cls(consistency_checks=consistency_checks)
        db.load_snapshot_bytes(raw)
        return db

    def load_snapshot_bytes(self, raw: bytes) -> int:
        """Install a full snapshot into THIS (possibly subclassed) store in
        one bulk pass — the instance-method twin of ``from_snapshot_bytes``
        for backends whose constructors need more than consistency flags
        (the tiered store). Returns the entry count."""
        if raw[:5] != self.SNAPSHOT_MAGIC:
            raise ValueError("bad state snapshot magic")
        (crc,) = struct.unpack_from("<I", raw, 5)
        body = raw[9:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("state snapshot checksum mismatch")
        entries = msgpack.unpackb(body)
        data = self._data
        if not data:
            # snapshot bodies serialize in sorted-key order: installing into
            # an empty store is a straight O(n) append, no sort needed
            keys = []
            for k, v in entries:
                data[k] = v
                keys.append(k)
            self._install_sorted_keys(keys)
        else:
            for k, v in entries:
                data[k] = v
            self._rebuild_sorted_keys()
        return len(entries)

    # -- bulk load (snapshot/chain install fast path) -------------------------

    def bulk_apply(self, puts: dict[bytes, Any],
                   deletes: "tuple | list | set" = ()) -> None:
        """Apply many puts/deletes in one pass: dict update + ONE sorted-key
        rebuild — O(n log n) total where per-key ``insort`` is O(n) each
        (quadratic on a million-key restore). Semantically identical to the
        incremental path (tests/test_state.py asserts parity)."""
        data = self._data
        for key in deletes:
            data.pop(key, None)
        data.update(puts)
        self._rebuild_sorted_keys()

    def _rebuild_sorted_keys(self) -> None:
        """Rebuild the key index from ``_data`` (hook: the durable backend
        rebuilds its blocked SortedList here instead of a flat list)."""
        self._sorted_keys = sorted(self._data)

    def _install_sorted_keys(self, keys: list[bytes]) -> None:
        """Install an ALREADY-SORTED key list as the index (same hook)."""
        self._sorted_keys = keys

    def content_equals(self, other: "ZbDb") -> bool:
        """Deep state equality — the replay≡processing test oracle."""
        return self._data == other._data

    # -- incremental-snapshot delta serialization ----------------------------

    DELTA_MAGIC = b"ZDLT\x01"
    # subclasses whose _data holds non-msgpack-able representations (the
    # durable store's _Packed/memoryview cold values) must opt OUT: a delta
    # serialized from them would crash packb or decode as the wrong type
    supports_delta_snapshots = True

    def begin_delta_tracking(self) -> None:
        """Start (or restart) recording changed keys. Call after recovery so
        the first delta captures exactly the writes since the recovered
        snapshot chain's tip."""
        self._dirty_keys = set()

    @property
    def delta_tracking(self) -> bool:
        return self._dirty_keys is not None

    @property
    def dirty_key_count(self) -> int:
        return len(self._dirty_keys) if self._dirty_keys is not None else 0

    @property
    def key_count(self) -> int:
        return len(self._data)

    def to_delta_bytes(self) -> bytes:
        """Serialize the changed-keys-since-tracking-start as a delta
        (msgpack ``[[key, deleted, value], …]`` + crc32 trailer, same
        integrity scheme as the full snapshot). Does NOT clear the tracked
        set — the caller clears only after the delta is durably persisted,
        so an aborted snapshot never loses changes."""
        if self.in_transaction:
            raise RuntimeError("cannot snapshot with an open transaction")
        if self._dirty_keys is None:
            raise RuntimeError("delta tracking is not active")
        data = self._data
        entries = []
        for key in sorted(self._dirty_keys):
            if key in data:
                entries.append([key, False, data[key]])
            else:
                entries.append([key, True, None])
        body = msgpack.packb(entries)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return self.DELTA_MAGIC + struct.pack("<I", crc) + body

    def clear_delta_tracking(self) -> None:
        """Reset the changed-key window (the just-persisted delta covers it)."""
        self._dirty_keys = set()

    def apply_delta_bytes(self, raw: bytes) -> int:
        """Apply one delta on top of the committed store (chain recovery:
        base snapshot, then each delta in order). Returns the entry count."""
        if raw[:5] != self.DELTA_MAGIC:
            raise ValueError("bad state delta magic")
        (crc,) = struct.unpack_from("<I", raw, 5)
        body = raw[9:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("state delta checksum mismatch")
        entries = msgpack.unpackb(body)
        # bulk fast path: insort per key is O(existing) each — a delta the
        # size of the store (chain recovery of a freshly-parked million
        # instances) turns quadratic. Sort-once rebuild wins when the delta
        # is large both absolutely and relative to the resident key set.
        if len(entries) >= 1024 and len(entries) * 8 >= len(self._data):
            puts: dict[bytes, Any] = {}
            deletes: list[bytes] = []
            for key, deleted, value in entries:
                if deleted:
                    puts.pop(key, None)
                    deletes.append(key)
                else:
                    puts[key] = value
            self.bulk_apply(puts, deletes)
        else:
            for key, deleted, value in entries:
                if deleted:
                    self._delete_committed(key)
                else:
                    self._put_committed(key, value)
        return len(entries)


class _TxnContext:
    __slots__ = ("_db", "_txn")

    def __init__(self, db: ZbDb) -> None:
        self._db = db

    def __enter__(self) -> Transaction:
        if self._db.in_transaction:
            raise RuntimeError("nested transactions are not supported")
        self._txn = Transaction(self._db)
        self._db._txn = self._txn
        return self._txn

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._txn.closed:
            if exc_type is None:
                self._txn.commit()
            else:
                self._txn.rollback()
        self._db._txn = None
