"""Burst templates: run-time codegen of a command's full record burst.

The sequential materializer (kernel_backend's cascade + the head processors)
is a deterministic function of a small input vector: the keys it mints, the
command's correlation fields, the clock, and the instance-scoped state it
reads. For a given *route* through a definition (the device-step trace) and a
given byte-image of those state reads (the context fingerprint), its output —
the serialized log batch, the state write-set, the client responses — is
IDENTICAL up to substituting that input vector.

So we capture it once per (definition, kind, trace, fingerprint): run the slow
path with the inputs tagged (RoleInt) or registered by value (keys are unique
ints ≥ 2^51, so value-equality identifies them unambiguously — equal ints are
the same quantity), record where each input lands in the payload bytes / db
keys / value objects, and replay every later identical-shaped command by
patching a byte template — no Writers, no per-event appliers, no Record
objects. This is the same trick the reference plays with SBE codegen
(protocol/src/main/resources/protocol.xml): fixed layouts patched at
runtime; here the layouts are derived from the engine itself at first use.

Safety model:
- the cache key pins the route (trace) AND every instance-scoped document the
  slow path reads (fingerprint) — a command whose inputs differ in any
  non-role byte can never hit a template built for another;
- capture validates by re-instantiating with the capture inputs and requiring
  byte-equality with the slow path's own serialization;
- EngineHarness runs kernel backends in audit mode by default: every template
  hit ALSO runs the slow path and asserts payload/state/response equality, so
  the whole test suite (incl. the 120-process randomized parity suite)
  continuously cross-checks the codegen against the interpreter.

Reference seams: ProcessingStateMachine's writeRecords batch
(stream-platform/…/ProcessingStateMachine.java:495), SBE codegen
(protocol.xml), StateWriter lock-step apply (StateWriter.java:11).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Callable

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.state.db import ColumnFamilyCode, _DELETED as _DB_DELETED
from zeebe_tpu_torch.stream.api import activatable_job_types as _activatable_job_types

# record header layout (protocol/record.py _HEADER = "<BBBBqqqiqqH")
_REC_KEY_OFF = 4
_REC_SOURCE_OFF = 12
_REC_TS_OFF = 20
_REC_STREAM_OFF = 28
_REC_REQ_OFF = 32
_REC_OPREF_OFF = 40
_REC_REASON_LEN_OFF = 48
_REC_HEADER_SIZE = 50
_BATCH_HEADER = struct.Struct("<IqQ")
_ENTRY_HEADER = struct.Struct("<BqI")

_PACK_LE_Q = struct.Struct("<q")
_PACK_LE_I = struct.Struct("<i")
_PACK_BE_Q = struct.Struct(">Q")

_ROLE_VALUE_MIN = 1 << 32  # below this, only explicit RoleInt tagging counts


class RoleInt(int):
    """An int carrying its provenance ('which template input am I').

    (int subclasses cannot use nonempty __slots__, so instances carry a dict —
    they only exist transiently during capture/audit runs.)"""

    def __new__(cls, value: int, role: tuple):
        obj = super().__new__(cls, value)
        obj.role = role
        return obj


class _RoleSlot:
    """Sentinel standing in for a role inside a template value object."""

    __slots__ = ("role",)

    def __init__(self, role: tuple) -> None:
        self.role = role

    def __repr__(self) -> str:  # debugging clarity only
        return f"<role {self.role}>"


class NotTemplatable(Exception):
    pass


# ---------------------------------------------------------------------------
# role resolution


class Roles:
    """Capture-time role context: which template input does an int stand for.

    - ``role_map``: exact value → role. Keys (pi/tok/cmd/mint/wait), request
      ids, fingerprint-extracted document fields (("fp", i) — dueDate /
      deadline values read from admission docs, normalized out of the cache
      fingerprint and re-extracted per command at the same canonical
      position), and clock-note values (("clock", delta) — due dates the
      engine computed as clock + clock-free-duration during this capture,
      recorded by the ``clock_note`` hooks below).
    - ``allowed``: large ints the fingerprint pins byte-for-byte — they may
      appear as constants (the slow path copies them verbatim).

    There is deliberately NO range-based clock detection: an unexplained
    value near the clock could be an engine-computed quantity that is NOT
    clock + fixed-delta (e.g. a now()-entangled FEEL result), and patching
    it as one would silently corrupt later instantiations. Clock roles come
    only from provenance (the notes), everything else unexplained rejects.
    """

    __slots__ = ("role_map", "allowed")

    def __init__(self, role_map: dict[int, tuple],
                 allowed: frozenset[int] | set[int] = frozenset()) -> None:
        self.role_map = role_map
        self.allowed = allowed

    def of(self, v: Any) -> tuple | None:
        if isinstance(v, RoleInt):
            return v.role
        if not isinstance(v, int) or isinstance(v, bool) or v < _ROLE_VALUE_MIN:
            return None
        return self.role_map.get(int(v))


# ---------------------------------------------------------------------------
# clock-value provenance notes
#
# The engine's timer machinery computes clock-derived values (dueDate =
# clock + duration). During a template capture/audit run the kernel backend
# activates this collector; the computing site reports each value together
# with its clock-free delta — or poisons the run when the delta itself reads
# the clock (a now()-referencing duration expression), because such a value
# cannot be expressed as clock + constant. Inactive outside capture runs
# (plain attribute check), so the hot sequential path pays ~nothing.

import threading as _threading

_clock_notes = _threading.local()


def clock_note_begin() -> None:
    _clock_notes.items = []
    _clock_notes.poison = False


def clock_note_end() -> tuple[list[tuple[int, int]], bool]:
    items = getattr(_clock_notes, "items", None) or []
    poison = getattr(_clock_notes, "poison", False)
    _clock_notes.items = None
    _clock_notes.poison = False
    return items, poison


def note_clock_value(value: int, delta: int) -> None:
    """Report ``value = clock + delta`` with ``delta`` a pure function of
    the (fingerprint-pinned) variable context."""
    items = getattr(_clock_notes, "items", None)
    if items is not None:
        items.append((int(value), int(delta)))


def note_clock_poison() -> None:
    """Report a clock-derived value whose delta is NOT clock-free — the
    enclosing burst must not be templated."""
    if getattr(_clock_notes, "items", None) is not None:
        _clock_notes.poison = True


# ---------------------------------------------------------------------------
# msgpack serialization with role-offset tracking (mirrors msgpack._pack; the
# parity invariant is enforced by the capture-time byte-equality check against
# the slow path's own codec output)

_pack_f64 = struct.Struct(">d").pack
_pack_u16 = struct.Struct(">H").pack
_pack_u32 = struct.Struct(">I").pack
_pack_u64 = struct.Struct(">Q").pack
_pack_i8 = struct.Struct(">b").pack
_pack_i16 = struct.Struct(">h").pack
_pack_i32 = struct.Struct(">i").pack
_pack_i64 = struct.Struct(">q").pack


def _pack_with_roles(obj: Any, buf: bytearray, patches: list, roles: Roles,
                     unknown: list | None = None) -> None:
    role = roles.of(obj)
    if role is not None:
        v = int(obj)
        if not (0 <= v < 1 << 64) or v < _ROLE_VALUE_MIN:
            raise NotTemplatable(f"role int out of patchable range: {v}")
        buf.append(0xCF)
        patches.append((len(buf), "be_q", role))
        buf += _pack_u64(v)
        return
    if (unknown is not None and isinstance(obj, int) and not isinstance(obj, bool)
            and abs(obj) >= _ROLE_VALUE_MIN):
        unknown.append(int(obj))
    if obj is None:
        buf.append(0xC0)
    elif obj is True:
        buf.append(0xC3)
    elif obj is False:
        buf.append(0xC2)
    elif isinstance(obj, int):
        _pack_int_plain(obj, buf)
    elif isinstance(obj, float):
        buf.append(0xCB)
        buf += _pack_f64(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            buf.append(0xA0 | n)
        elif n < 0x100:
            buf.append(0xD9)
            buf.append(n)
        elif n < 0x10000:
            buf.append(0xDA)
            buf += _pack_u16(n)
        else:
            buf.append(0xDB)
            buf += _pack_u32(n)
        buf += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 0x100:
            buf.append(0xC4)
            buf.append(n)
        elif n < 0x10000:
            buf.append(0xC5)
            buf += _pack_u16(n)
        else:
            buf.append(0xC6)
            buf += _pack_u32(n)
        buf += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            buf.append(0x90 | n)
        elif n < 0x10000:
            buf.append(0xDC)
            buf += _pack_u16(n)
        else:
            buf.append(0xDD)
            buf += _pack_u32(n)
        for item in obj:
            _pack_with_roles(item, buf, patches, roles, unknown)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            buf.append(0x80 | n)
        elif n < 0x10000:
            buf.append(0xDE)
            buf += _pack_u16(n)
        else:
            buf.append(0xDF)
            buf += _pack_u32(n)
        for k, v in obj.items():
            _pack_with_roles(k, buf, patches, roles, unknown)
            _pack_with_roles(v, buf, patches, roles, unknown)
    else:
        raise NotTemplatable(f"cannot template msgpack type {type(obj).__name__}")


def _pack_int_plain(v: int, buf: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            buf.append(v)
        elif v < 0x100:
            buf.append(0xCC)
            buf.append(v)
        elif v < 0x10000:
            buf.append(0xCD)
            buf += _pack_u16(v)
        elif v < 0x100000000:
            buf.append(0xCE)
            buf += _pack_u32(v)
        else:
            buf.append(0xCF)
            buf += _pack_u64(v)
    else:
        if v >= -32:
            buf.append(v & 0xFF)
        elif v >= -0x80:
            buf.append(0xD0)
            buf += _pack_i8(v)
        elif v >= -0x8000:
            buf.append(0xD1)
            buf += _pack_i16(v)
        elif v >= -0x80000000:
            buf.append(0xD2)
            buf += _pack_i32(v)
        else:
            buf.append(0xD3)
            buf += _pack_i64(v)


# ---------------------------------------------------------------------------
# value-object templating (state writes, response record values)


def _templatize_value(obj: Any, roles: Roles, unknown: list | None = None):
    """Replace role ints with _RoleSlot sentinels; returns (template, n_roles)."""
    role = roles.of(obj)
    if role is not None:
        return _RoleSlot(role), 1
    if (unknown is not None and isinstance(obj, int) and not isinstance(obj, bool)
            and abs(obj) >= _ROLE_VALUE_MIN):
        unknown.append(int(obj))
    if isinstance(obj, dict):
        n = 0
        out = {}
        for k, v in obj.items():
            kt, nk = _templatize_value(k, roles, unknown)
            vt, nv = _templatize_value(v, roles, unknown)
            out[k if nk == 0 else kt] = vt
            n += nk + nv
        return out, n
    if isinstance(obj, (list, tuple)):
        items = []
        n = 0
        for v in obj:
            vt, nv = _templatize_value(v, roles, unknown)
            items.append(vt)
            n += nv
        return (items if isinstance(obj, list) else tuple(items)), n
    if isinstance(obj, RoleInt):  # small tagged int (request ids)
        return _RoleSlot(obj.role), 1
    return obj, 0


def _build_value(template: Any, resolve: Callable[[tuple], int]):
    """Instantiate a templatized value object."""
    if isinstance(template, _RoleSlot):
        return resolve(template.role)
    if isinstance(template, dict):
        return {
            (_build_value(k, resolve) if isinstance(k, _RoleSlot) else k): _build_value(v, resolve)
            for k, v in template.items()
        }
    if isinstance(template, list):
        return [_build_value(v, resolve) for v in template]
    if isinstance(template, tuple):
        return tuple(_build_value(v, resolve) for v in template)
    return template


# ---------------------------------------------------------------------------
# encoded-db-key templating (keys are self-describing: type-tagged parts)


def _templatize_db_key(enc: bytes, roles: Roles,
                       unknown: list | None = None) -> tuple[bytes, list]:
    """Parse an encoded state key; return (bytes, [(offset, role)]) patching
    int parts whose value is a role. Layout per state/db._encode_part:
    u16 cf | parts, each 0x01+BE-u64(sign-flipped) | 0x02+utf8+NUL |
    0x03+BE-u64-len+bytes."""
    patches = []
    off = 2
    n = len(enc)
    while off < n:
        tag = enc[off]
        off += 1
        if tag == 0x01:
            raw = _PACK_BE_Q.unpack_from(enc, off)[0]
            v = raw ^ 0x8000000000000000
            if v >= 1 << 63:
                v -= 1 << 64
            role = roles.of(v)
            if role is not None:
                patches.append((off, role))
            elif unknown is not None and abs(v) >= _ROLE_VALUE_MIN:
                unknown.append(v)
            off += 8
        elif tag == 0x02:
            end = enc.index(b"\x00", off)
            off = end + 1
        elif tag == 0x03:
            length = _PACK_BE_Q.unpack_from(enc, off)[0]
            off += 8 + length
        else:
            raise NotTemplatable(f"unknown key part tag 0x{tag:02x}")
    return enc, patches


# ---------------------------------------------------------------------------
# the template


@dataclass
class StateOp:
    op: str  # "put" | "del"
    key: bytes
    key_patches: list  # [(offset, role)]
    value_template: Any = None
    # fast value rebuild: when the value round-trips the codec exactly, it is
    # stored as msgpack bytes + patch offsets and rebuilt with one C unpack —
    # also guaranteeing a FRESH object per instantiation (the engine mutates
    # state values in place, so sharing a template object would corrupt
    # every instance that hit the template)
    value_bytes: bytes | None = None
    value_byte_patches: list = field(default_factory=list)

    def build_value(self, resolve: Callable[[tuple], int]):
        if self.value_bytes is not None:
            if self.value_byte_patches:
                buf = bytearray(self.value_bytes)
                for off, _fmt, role in self.value_byte_patches:
                    _PACK_BE_Q.pack_into(buf, off, resolve(role) & 0xFFFFFFFFFFFFFFFF)
                return msgpack.unpackb(bytes(buf))
            return msgpack.unpackb(self.value_bytes)
        return _build_value(self.value_template, resolve)


@dataclass
class ResponseTemplate:
    extra: bool  # False → with_response, True → add_response (await-result)
    header: dict  # field → constant or _RoleSlot
    value_template: Any = None
    stream_role: Any = None  # constant int or _RoleSlot
    req_role: Any = None


@dataclass
class PreparedBurst:
    """An instantiated template, ready for the writer: the payload needs only
    position/timestamp patching inside the append lock."""

    buf: bytearray
    pos_offsets: list[int]
    ts_offsets: list[int]
    count: int
    responses: list  # [(extra, Record, request_stream_id, request_id)]
    has_pending_commands: bool = False
    job_types: frozenset = frozenset()  # job types made activatable by the burst


_FMT_CODES = {"le_q": 0, "le_i": 1, "be_q": 2}
_PLAN_ENTRY = struct.Struct("<IBB")


from zeebe_tpu_torch.native import codec_fn as _codec_fn

_apply_patches = _codec_fn("apply_patches")
_apply_state_plan = _codec_fn("apply_state_plan")
_STATE_PATCH = struct.Struct("<IB")


@dataclass
class BurstTemplate:
    """Everything needed to replay one command's burst by patching."""

    payload: bytes
    count: int  # records in the batch
    pos_offsets: list[int]  # entry-header position fields (first_position + i)
    ts_offsets: list[int]  # batch header + per-record timestamp fields
    role_patches: list  # [(offset, fmt, role)] fmt ∈ {"be_q","le_q","le_i"}
    mint_count: int
    state_ops: list[StateOp] = field(default_factory=list)
    responses: list[ResponseTemplate] = field(default_factory=list)
    has_pending_commands: bool = False
    job_types: frozenset = frozenset()
    # compiled payload patch plan (native apply_patches): entry bytes +
    # distinct role list; False = not compilable (fallback loop)
    _plan: Any = field(default=None, repr=False, compare=False)
    # compiled state-op plan (native apply_state_plan): per-op tuples +
    # distinct role list; False = not compilable (fallback loop)
    _state_plan: Any = field(default=None, repr=False, compare=False)
    # cached puts into the due-date index CFs (timer-wheel note_due replay)
    _due_ops: Any = field(default=None, repr=False, compare=False)
    # cached puts into the wait-state CFs (tiering note_parked replay)
    _park_ops: Any = field(default=None, repr=False, compare=False)

    def _compiled_plan(self):
        """(plan bytes, distinct roles) for the native patcher, or None.
        Each distinct role resolves ONCE per instantiation; the C pass
        applies every offset."""
        plan = self._plan
        if plan is None:
            role_idx: dict[tuple, int] = {}
            entries = bytearray()
            for off, fmt, role in self.role_patches:
                idx = role_idx.setdefault(role, len(role_idx))
                if idx > 0xFF or off > 0xFFFFFFFF:
                    self._plan = plan = False
                    break
                entries += _PLAN_ENTRY.pack(off, _FMT_CODES[fmt], idx)
            else:
                self._plan = plan = (bytes(entries), list(role_idx))
        return None if plan is False else plan

    def instantiate_payload(self, resolve: Callable[[tuple], int]) -> bytearray:
        buf = bytearray(self.payload)
        if _apply_patches is not None:
            plan = self._compiled_plan()
            if plan is not None:
                entries, roles = plan
                _apply_patches(buf, entries, [resolve(r) for r in roles])
                return buf
        for off, fmt, role in self.role_patches:
            v = resolve(role)
            if fmt == "be_q":
                _PACK_BE_Q.pack_into(buf, off, v & 0xFFFFFFFFFFFFFFFF)
            elif fmt == "le_q":
                _PACK_LE_Q.pack_into(buf, off, v)
            else:
                _PACK_LE_I.pack_into(buf, off, v)
        return buf

    def _compiled_state_plan(self):
        """(per-op tuples, distinct roles) for the native state applier, or
        None. Compilable iff every put carries codec-stable value bytes and
        role/offset widths fit the packed patch format. Each distinct role
        resolves ONCE per instantiation."""
        plan = self._state_plan
        if plan is None:
            role_idx: dict[tuple, int] = {}
            ops: list[tuple] = []

            def pack_patches(patches) -> bytes | None:
                out = bytearray()
                for entry in patches:
                    off, role = entry[0], entry[-1]
                    idx = role_idx.setdefault(role, len(role_idx))
                    if idx > 0xFF or off > 0xFFFFFFFF:
                        return None
                    out += _STATE_PATCH.pack(off, idx)
                return bytes(out)

            for op in self.state_ops:
                kp = pack_patches(op.key_patches)
                if kp is None:
                    ops = None
                    break
                if op.op != "put":
                    ops.append((0, op.key, kp, None, b""))
                    continue
                if op.value_bytes is None:
                    ops = None  # template-object value: python fallback
                    break
                vp = pack_patches(op.value_byte_patches)
                if vp is None:
                    ops = None
                    break
                ops.append((1, op.key, kp, op.value_bytes, vp))
            self._state_plan = plan = (
                False if ops is None else (ops, list(role_idx)))
        return None if plan is False else plan

    def _due_index_ops(self) -> list:
        """Puts into the due-date index CFs (timer due dates, message TTLs,
        job deadlines/backoff): the template applies raw encoded keys below
        the state facades, so the hierarchical timer wheel's ``note_due``
        seam must be replayed from the key bytes — a missed due
        insert would be a timer that never fires."""
        ops = self._due_ops
        if ops is None:
            from zeebe_tpu_torch.state import ColumnFamilyCode as _CF

            prefixes = {struct.pack(">H", int(cf)) for cf in (
                _CF.TIMER_DUE_DATES, _CF.MESSAGE_DEADLINES,
                _CF.JOB_DEADLINES, _CF.JOB_BACKOFF)}
            ops = [op for op in self.state_ops
                   if op.op == "put" and op.key[:2] in prefixes]
            self._due_ops = ops
        return ops

    def _park_index_ops(self) -> list:
        """Puts into the wait-state CFs (timers, jobs, message
        subscriptions): the tiering manager's ``note_parked`` seam must be
        replayed too, or template-cacheable park workloads (constant
        variables → near-1.0 template hit rates) would never produce spill
        candidates and RSS would grow unbounded with the parked backlog."""
        ops = self._park_ops
        if ops is None:
            from zeebe_tpu_torch.state import ColumnFamilyCode as _CF

            prefixes = {struct.pack(">H", int(cf)) for cf in (
                _CF.TIMERS, _CF.JOBS, _CF.PROCESS_SUBSCRIPTION_BY_KEY)}
            ops = [op for op in self.state_ops
                   if op.op == "put" and op.key[:2] in prefixes]
            self._park_ops = ops
        return ops

    def _note_parks(self, txn, resolve: Callable[[tuple], int]) -> None:
        db = getattr(txn, "_db", None)
        if db is None or db.park_listener is None:
            return  # tiering off: zero cost beyond this check
        for op in self._park_index_ops():
            # the instance key lives in the record document; one small
            # unpack per park-op per instantiation, paid only with a
            # tiering manager wired
            val = op.build_value(resolve)
            if type(val) is dict:
                db.note_parked(val.get("processInstanceKey", -1))

    def _note_dues(self, txn, resolve: Callable[[tuple], int]) -> None:
        db = getattr(txn, "_db", None)
        if db is None or db.due_listener is None:
            return
        for op in self._due_index_ops():
            # first key part = the due millis: tag byte at offset 2, flipped
            # big-endian i64 at 3..11 — patched when role-derived
            due = None
            for off, role in op.key_patches:
                if off == 3:
                    due = resolve(role)
                    break
            if due is None:
                flipped = _PACK_BE_Q.unpack_from(op.key, 3)[0]
                raw = flipped ^ 0x8000000000000000
                due = raw - (1 << 64) if raw >= (1 << 63) else raw
            db.note_due(due)

    def apply_state(self, txn, resolve: Callable[[tuple], int]) -> None:
        if (_apply_state_plan is not None and getattr(txn, "capture", True) is None
                and getattr(txn, "_writes", None) is not None):
            plan = self._compiled_state_plan()
            if plan is not None:
                ops, roles = plan
                _apply_state_plan(ops, [resolve(r) for r in roles],
                                  txn._writes, txn._sorted_writes, _DB_DELETED)
                self._note_dues(txn, resolve)
                self._note_parks(txn, resolve)
                return
        for op in self.state_ops:
            if op.key_patches:
                key = bytearray(op.key)
                for off, role in op.key_patches:
                    _PACK_BE_Q.pack_into(
                        key, off, (resolve(role) & 0xFFFFFFFFFFFFFFFF) ^ 0x8000000000000000
                    )
                key = bytes(key)
            else:
                key = op.key
            if op.op == "put":
                txn.put(key, op.build_value(resolve))
            else:
                txn.delete(key)
        self._note_dues(txn, resolve)
        self._note_parks(txn, resolve)

    def build_responses(self, resolve: Callable[[tuple], int]):
        from zeebe_tpu_torch.protocol.record import Record

        out = []
        for rt in self.responses:
            fields = {
                k: (resolve(v.role) if isinstance(v, _RoleSlot) else v)
                for k, v in rt.header.items()
            }
            fields["value"] = _build_value(rt.value_template, resolve)
            rec = Record(**fields)
            stream = resolve(rt.stream_role.role) if isinstance(rt.stream_role, _RoleSlot) else rt.stream_role
            req = resolve(rt.req_role.role) if isinstance(rt.req_role, _RoleSlot) else rt.req_role
            out.append((rt.extra, rec, stream, req))
        return out


# ---------------------------------------------------------------------------
# capture


def build_template(
    builder,
    state_log: list,
    roles: Roles,
    mint_count: int,
    partition_id: int,
) -> BurstTemplate:
    """Build a BurstTemplate from one slow-path materialization: the result
    builder (records + responses) and the transaction's write capture log.
    Raises NotTemplatable when anything resists the role model.

    ``roles`` carries the full role context: exact value→role map (keys,
    mints, fingerprint-extracted fields), the fingerprint-pinned constants
    (``roles.allowed`` — large ints that may legitimately be baked in because
    the cache key's fingerprint pins them), and the capture clock base for
    clock-derived detection. Any other large non-role int is evidence of
    hidden variance the role model cannot express — baking it in would
    silently corrupt later instantiations, so the burst is rejected."""
    if builder.post_commit_tasks:
        raise NotTemplatable("post-commit tasks cannot be templated")
    unknown: list[int] = []

    # ---- payload: batch header + per-entry header + record frames ----------
    payload = bytearray(_BATCH_HEADER.pack(len(builder.follow_ups), -1, 0))
    pos_offsets: list[int] = []
    ts_offsets: list[int] = [12]  # batch header timestamp
    role_patches: list = [(4, "le_q", ("source_position",))]
    for fu in builder.follow_ups:
        rec = fu.record
        if rec.rejection_reason and len(rec.rejection_reason.encode("utf-8")) > 0xFFFF:
            raise NotTemplatable("oversized rejection reason")
        body = bytearray()
        body_patches: list = []
        _pack_with_roles(dict(rec.value), body, body_patches, roles, unknown)
        reason = rec.rejection_reason.encode("utf-8")
        entry_off = len(payload)
        rec_off = entry_off + _ENTRY_HEADER.size
        rec_len = _REC_HEADER_SIZE + len(reason) + 4 + len(body)
        payload += _ENTRY_HEADER.pack(1 if fu.processed else 0, 0, rec_len)
        pos_offsets.append(entry_off + 1)
        header = struct.pack(
            "<BBBBqqqiqqH",
            int(rec.record_type),
            int(rec.value_type),
            int(rec.intent),
            int(rec.rejection_type),
            int(rec.key),
            int(rec.source_record_position),
            0,  # timestamp patched at append
            int(rec.request_stream_id),
            int(rec.request_id),
            int(rec.operation_reference),
            len(reason),
        )
        payload += header
        # header field roles
        for value, off, fmt in (
            (rec.key, _REC_KEY_OFF, "le_q"),
            (rec.source_record_position, _REC_SOURCE_OFF, "le_q"),
            (rec.request_stream_id, _REC_STREAM_OFF, "le_i"),
            (rec.request_id, _REC_REQ_OFF, "le_q"),
            (rec.operation_reference, _REC_OPREF_OFF, "le_q"),
        ):
            role = roles.of(value)
            if role is not None:
                role_patches.append((rec_off + off, fmt, role))
            elif abs(int(value)) >= _ROLE_VALUE_MIN:
                unknown.append(int(value))
        ts_offsets.append(rec_off + _REC_TS_OFF)
        payload += reason
        payload += struct.pack("<I", len(body))
        body_base = len(payload)
        for boff, fmt, role in body_patches:
            role_patches.append((body_base + boff, fmt, role))
        payload += body

    # ---- state ops ---------------------------------------------------------
    # collapse to the final op per key: instantiation replays ops blindly
    # (no reads in between), so only the last write to each key matters —
    # slow-path bursts touch the same element-instance row once per lifecycle
    # event, and replaying every intermediate version would dominate the fast
    # path
    final_ops: dict[bytes, tuple] = {}
    for op, enc_key, value in state_log:
        cf = struct.unpack_from(">H", enc_key, 0)[0]
        if cf == int(ColumnFamilyCode.KEY):
            continue  # replaced by the single bulk-mint write at instantiation
        if enc_key in final_ops:
            del final_ops[enc_key]  # re-insert to keep last-write order
        final_ops[enc_key] = (op, value)
    state_ops: list[StateOp] = []
    for enc_key, (op, value) in final_ops.items():
        key_bytes, key_patches = _templatize_db_key(enc_key, roles, unknown)
        if op != "put":
            state_ops.append(StateOp("del", key_bytes, key_patches))
            continue
        entry = StateOp("put", key_bytes, key_patches)
        # prefer the bytes rebuild when the value survives the codec exactly
        try:
            vbuf = bytearray()
            vpatches: list = []
            _pack_with_roles(value, vbuf, vpatches, roles, unknown)
            if msgpack.unpackb(bytes(vbuf)) == value:
                entry.value_bytes = bytes(vbuf)
                entry.value_byte_patches = vpatches
            else:
                raise NotTemplatable("value not codec-stable")
        except (NotTemplatable, msgpack.MsgPackError):
            vt, _n = _templatize_value(value, roles, unknown)
            entry.value_template = vt
        state_ops.append(entry)

    # ---- responses ---------------------------------------------------------
    responses: list[ResponseTemplate] = []
    all_responses = ([] if builder.response is None else [(False, builder.response)]) + [
        (True, r) for r in builder.extra_responses
    ]
    # replicated-dedupe parity guard: the live burst path notes
    # dedupe entries from `responses` while replay notes them from the
    # logged frames — a request-carrying follow-up frame that is NOT a
    # registered response would make the two diverge. Such steps (none in
    # the engine today) fall back to the slow path instead.
    response_records = {id(r.record) for _extra, r in all_responses}
    for fu in builder.follow_ups:
        rec = fu.record
        if (rec.request_id >= 0 and not rec.is_command
                and id(rec) not in response_records):
            raise NotTemplatable(
                "request-carrying follow-up is not a registered response")
    for extra, resp in all_responses:
        rec = resp.record
        header: dict[str, Any] = {}
        for name in (
            "record_type", "value_type", "intent", "key", "position",
            "source_record_position", "timestamp", "partition_id",
            "rejection_type", "rejection_reason", "request_stream_id",
            "request_id", "operation_reference",
        ):
            v = getattr(rec, name)
            role = roles.of(v)
            header[name] = _RoleSlot(role) if role is not None else v
        vt, _ = _templatize_value(dict(rec.value), roles, unknown)
        stream_role = roles.of(resp.request_stream_id)
        req_role = roles.of(resp.request_id)
        responses.append(
            ResponseTemplate(
                extra=extra,
                header=header,
                value_template=vt,
                stream_role=(
                    _RoleSlot(stream_role) if stream_role is not None else int(resp.request_stream_id)
                ),
                req_role=_RoleSlot(req_role) if req_role is not None else int(resp.request_id),
            )
        )

    stray = [v for v in unknown if v not in roles.allowed]
    if stray:
        raise NotTemplatable(
            f"unexplained large ints (not roles, not fingerprint-pinned): {stray[:4]}"
        )

    return BurstTemplate(
        payload=bytes(payload),
        count=len(builder.follow_ups),
        pos_offsets=pos_offsets,
        ts_offsets=ts_offsets,
        role_patches=role_patches,
        mint_count=mint_count,
        state_ops=state_ops,
        responses=responses,
        has_pending_commands=any(
            f.record.is_command and not f.processed for f in builder.follow_ups
        ),
        job_types=frozenset(_activatable_job_types(builder.follow_ups)),
    )


def serialize_reference(builder, first_position: int, source_position: int, timestamp: int) -> bytes:
    """The slow path's own serialization of the builder (for capture-time
    byte-equality validation of a freshly built template)."""
    from zeebe_tpu_torch.logstreams.log_stream import LogAppendEntry, _serialize_batch

    entries = [LogAppendEntry(f.record, f.processed) for f in builder.follow_ups]
    return _serialize_batch(entries, first_position, source_position, timestamp)


def validate_template(template: BurstTemplate, builder, resolve: Callable[[tuple], int]) -> None:
    """Instantiate with the capture inputs and require byte-equality with the
    slow path's serializer output for synthetic position/timestamp."""
    synth_pos, synth_src, synth_ts = 977_717, 977_713, 1_234_567_890_123

    def resolve_with_synth(role: tuple) -> int:
        if role == ("source_position",):
            return synth_src
        return resolve(role)

    buf = template.instantiate_payload(resolve_with_synth)
    for i, off in enumerate(template.pos_offsets):
        _PACK_LE_Q.pack_into(buf, off, synth_pos + i)
    for off in template.ts_offsets:
        _PACK_LE_Q.pack_into(buf, off, synth_ts)
    expected = serialize_reference(builder, synth_pos, synth_src, synth_ts)
    if bytes(buf) != expected:
        raise NotTemplatable("template instantiation does not reproduce the slow path bytes")
