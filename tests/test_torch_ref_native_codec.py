# tests/test_native_codec.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Parity tests: native C msgpack codec vs the pure-Python specification.

The C extension (zeebe_tpu/native/codec.c) must be byte-identical to
protocol/msgpack.py on every value and raise MsgPackError on the same
malformed inputs — it sits on the record hot path (append/replay/export/
transport), so a single divergent byte would break replay determinism.
"""

from __future__ import annotations

import math
import random

import pytest

from zeebe_tpu_torch.protocol import msgpack

pytestmark = pytest.mark.skipif(
    msgpack.packb is msgpack.py_packb, reason="native codec unavailable"
)


def _random_value(rng: random.Random, depth: int = 0):
    t = rng.randint(0, 9 if depth < 3 else 6)
    if t == 0:
        return None
    if t == 1:
        return rng.choice([True, False])
    if t == 2:
        return rng.randint(-(2**63), 2**64 - 1)
    if t == 3:
        return rng.random() * 1e9 - 5e8
    if t == 4:
        return "".join(chr(rng.randint(32, 0x10FF)) for _ in range(rng.randint(0, 40)))
    if t == 5:
        return bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 300)))
    if t == 6:
        return rng.randint(-128, 127)
    if t == 7:
        return [_random_value(rng, depth + 1) for _ in range(rng.randint(0, 8))]
    return {
        (_random_value(rng, 4) if rng.random() < 0.5 else f"k{i}"): _random_value(rng, depth + 1)
        for i in range(rng.randint(0, 8))
    }


def test_randomized_byte_parity():
    rng = random.Random(20260729)
    for _ in range(2000):
        obj = _random_value(rng)
        native = msgpack.packb(obj)
        pure = msgpack.py_packb(obj)
        assert native == pure
        assert msgpack.unpackb(native) == msgpack.py_unpackb(native)


def test_int_boundaries():
    for v in [0, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
              0x100000000, 2**64 - 1, -1, -32, -33, -0x80, -0x81, -0x8000,
              -0x8001, -0x80000000, -0x80000001, -(2**63)]:
        assert msgpack.packb(v) == msgpack.py_packb(v)
        assert msgpack.unpackb(msgpack.packb(v)) == v


def test_int_out_of_range():
    for v in (2**64, -(2**63) - 1):
        with pytest.raises(msgpack.MsgPackError):
            msgpack.packb(v)
        with pytest.raises(msgpack.MsgPackError):
            msgpack.py_packb(v)


def test_float_and_nan():
    for v in (0.0, -0.0, 1.5, math.inf, -math.inf):
        assert msgpack.packb(v) == msgpack.py_packb(v)
        assert msgpack.unpackb(msgpack.packb(v)) == v
    assert msgpack.packb(math.nan) == msgpack.py_packb(math.nan)
    assert math.isnan(msgpack.unpackb(msgpack.packb(math.nan)))


def test_float32_decodes():
    import struct

    blob = b"\xca" + struct.pack(">f", 1.5)
    assert msgpack.unpackb(blob) == msgpack.py_unpackb(blob) == 1.5


def test_malformed_inputs_raise_msgpack_error():
    cases = [b"", b"\xc1", b"\xa5ab", b"\x00\x00", b"\xd9", b"\xdc\x00",
             b"\x81\xa1a", b"\xa1\xff"]
    for bad in cases:
        with pytest.raises(msgpack.MsgPackError):
            msgpack.unpackb(bad)
        with pytest.raises(msgpack.MsgPackError):
            msgpack.py_unpackb(bad)


def test_unpackable_type_raises():
    with pytest.raises(msgpack.MsgPackError):
        msgpack.packb(object())


def test_deep_nesting_guard():
    deep = None
    for _ in range(300):
        deep = [deep]
    with pytest.raises(msgpack.MsgPackError):
        msgpack.packb(deep)
    with pytest.raises(msgpack.MsgPackError):
        msgpack.py_packb(deep)
    blob = b"\x91" * 300 + b"\xc0"
    with pytest.raises(msgpack.MsgPackError):
        msgpack.unpackb(blob)
    with pytest.raises(msgpack.MsgPackError):
        msgpack.py_unpackb(blob)


def test_dict_insertion_order_preserved():
    d = {"z": 1, "a": 2, "m": 3}
    assert msgpack.packb(d) == msgpack.py_packb(d)
    assert list(msgpack.unpackb(msgpack.packb(d))) == ["z", "a", "m"]


def test_memoryview_and_bytearray():
    raw = bytes(range(256))
    for obj in (bytearray(raw), memoryview(raw)):
        assert msgpack.packb(obj) == msgpack.py_packb(obj)
    assert msgpack.unpackb(memoryview(msgpack.packb(raw))) == raw


def test_huge_claimed_container_raises_not_memoryerror():
    # corrupt frames claiming billions of elements must fail fast as
    # MsgPackError (the consumer contract), never MemoryError
    for bad in (b"\xdd\x7f\xff\xff\xff", b"\xdf\x7f\xff\xff\xff",
                b"\xdc\xff\xff", b"\xde\xff\xff"):
        with pytest.raises(msgpack.MsgPackError):
            msgpack.unpackb(bad)
        with pytest.raises(msgpack.MsgPackError):
            msgpack.py_unpackb(bad)


def test_prefix_boundary_keys_visible_in_iterate():
    # keys whose suffix sorts above prefix+9*0xff must still be seen by
    # prefix iteration (committed and pending overlay alike)
    from zeebe_tpu_torch.state.db import ZbDb, ColumnFamilyCode

    db = ZbDb()
    cf = db.column_family(ColumnFamilyCode.VARIABLES)
    big = (1 << 63) - 1  # sign-flipped encoding is 8x 0xff
    with db.transaction():
        cf.put((big, "a"), 1)
    with db.transaction():
        cf.put((big, "b"), 2)
        keys = [k for k, _ in cf.items(())]
        assert len(keys) == 2


class TestNativeRecordFrameDecode:
    """decode_record_frame (native/codec.c): one C call parses header +
    reason + msgpack body; must agree with the pure-Python decoder on every
    frame, including edge shapes."""

    def _roundtrip_cases(self):
        from zeebe_tpu_torch.protocol import ValueType, command, event, rejection
        from zeebe_tpu_torch.protocol.enums import RejectionType
        from zeebe_tpu_torch.protocol.intent import JobIntent, ProcessInstanceIntent

        yield command(ValueType.JOB, JobIntent.COMPLETE,
                      {"variables": {"a": [1, 2.5, None, True, "s"]}}, key=7)
        yield event(ValueType.PROCESS_INSTANCE, ProcessInstanceIntent.ELEMENT_ACTIVATED,
                    {"elementId": "x" * 300, "nested": {"deep": [{"k": -1}]}},
                    key=(3 << 51) | 42)
        cmd = command(ValueType.JOB, JobIntent.FAIL, {}, key=1)
        yield rejection(cmd, RejectionType.INVALID_STATE, "рфé unicode ✓ reason")

    def test_parity_with_python_decoder(self):
        import pytest

        from zeebe_tpu_torch.protocol import record as R

        if R._decode_frame is R._py_decode_frame:
            pytest.skip("native codec unavailable")
        for rec in self._roundtrip_cases():
            data = rec.to_bytes()
            assert R._decode_frame(data) == R._py_decode_frame(data)

    def test_truncated_frame_raises(self):
        import pytest

        from zeebe_tpu_torch.protocol import Record
        from zeebe_tpu_torch.protocol import record as R

        rec = next(iter(self._roundtrip_cases()))
        data = rec.to_bytes()
        # the public wrapper always surfaces truncation as ValueError
        for cut in (0, 10, len(data) - 1):
            with pytest.raises(ValueError):
                Record.from_bytes(data[:cut])


class TestScanBatchHeaders:
    """Native scan_batch_headers vs the pure-Python mirror."""

    def _batch(self):
        from zeebe_tpu_torch.logstreams.log_stream import LogAppendEntry, _serialize_batch
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import JobIntent
        from zeebe_tpu_torch.protocol.record import command, event

        entries = [
            LogAppendEntry(command(ValueType.JOB, JobIntent.COMPLETE,
                                   {"variables": {"x": [1, "s"]}}, key=(1 << 51) + 3)),
            LogAppendEntry(event(ValueType.JOB, JobIntent.CREATED,
                                 {"type": "w"}, key=(1 << 51) + 4), processed=True),
            LogAppendEntry(command(ValueType.PROCESS_INSTANCE, JobIntent.COMPLETE,
                                   {}, key=-1)),
        ]
        return _serialize_batch(entries, 500, 77, 1_699_999_999_001)

    def test_parity_with_python_scanner(self):
        from zeebe_tpu_torch.logstreams.log_stream import _py_scan_batch_headers
        from zeebe_tpu_torch.native import load_codec

        codec = load_codec()
        assert codec is not None and hasattr(codec, "scan_batch_headers")
        payload = self._batch()
        py = _py_scan_batch_headers(payload)
        nat = codec.scan_batch_headers(payload)
        assert py[0] == nat[0] and py[1] == nat[1]
        assert [tuple(r) for r in py[2]] == [tuple(r) for r in nat[2]]

    def test_truncated_batch_raises_both_paths(self):
        from zeebe_tpu_torch.logstreams.log_stream import _py_scan_batch_headers
        from zeebe_tpu_torch.native import load_codec

        codec = load_codec()
        payload = self._batch()
        for scanner in (codec.scan_batch_headers, _py_scan_batch_headers):
            for cut in (3, 15, 25, len(payload) - 1):
                with pytest.raises(msgpack.MsgPackError):
                    scanner(payload[:cut])
            with pytest.raises(msgpack.MsgPackError):
                scanner(payload + b"\x00\x01\x02")  # trailing garbage

    def test_corrupt_count_rejected_without_allocation(self):
        import struct as _struct

        from zeebe_tpu_torch.logstreams.log_stream import _py_scan_batch_headers
        from zeebe_tpu_torch.native import load_codec

        codec = load_codec()
        payload = bytearray(self._batch())
        _struct.pack_into("<I", payload, 0, 0xFFFFFFF0)
        for scanner in (codec.scan_batch_headers, _py_scan_batch_headers):
            with pytest.raises(msgpack.MsgPackError):
                scanner(bytes(payload))


class TestPackFingerprint:
    """Native pack_fingerprint vs the pure-Python spec
    (kernel_backend._py_pack_fingerprint)."""

    FP = frozenset(("dueDate", "deadline"))

    def _impls(self):
        from zeebe_tpu_torch.engine.kernel_backend import (
            _native_pack_fingerprint,
            _py_pack_fingerprint,
        )

        assert _native_pack_fingerprint is not None
        return _py_pack_fingerprint, _native_pack_fingerprint

    def test_randomized_parity(self):
        py_fp, c_fp = self._impls()
        rng = random.Random(20260730)

        def rand_doc(depth=0):
            t = rng.randint(0, 8 if depth < 3 else 5)
            if t == 0:
                return None
            if t == 1:
                return rng.choice([True, False])
            if t == 2:
                return rng.choice([
                    rng.randint(-100, 100), rng.randint(2**32, 2**53),
                    (1 << 51) + rng.randint(0, 20),
                    1_700_000_000_000 + rng.randint(0, 10**9),
                ])
            if t == 3:
                return rng.random() * 1e6
            if t == 4:
                return rng.choice(["plain", "\x00evil", "\x00r", "x" * 40, ""])
            if t == 5:
                return rng.choice(["dueDate", "deadline", "elementId"])
            if t == 6:
                return [rand_doc(depth + 1) for _ in range(rng.randint(0, 5))]
            if t == 7:
                return tuple(rand_doc(depth + 1) for _ in range(rng.randint(0, 4)))
            return {
                rng.choice(["dueDate", "deadline", f"k{rng.randint(0, 5)}",
                            "\x00weird"]): rand_doc(depth + 1)
                for _ in range(rng.randint(0, 6))
            }

        for trial in range(800):
            docs = [rand_doc() for _ in range(rng.randint(1, 5))]
            roles = {}

            def collect(o):
                if isinstance(o, bool):
                    return
                if isinstance(o, int) and o >= 2**32 and rng.random() < 0.4:
                    roles[o] = rng.choice(["p", "k", "t0", "w1"])
                elif isinstance(o, dict):
                    for k, v in o.items():
                        collect(k)
                        collect(v)
                elif isinstance(o, (list, tuple)):
                    for v in o:
                        collect(v)

            collect(docs)
            a = py_fp(docs, roles, self.FP)
            b = c_fp(docs, roles, self.FP)
            assert a[0] == b[0], (trial, docs, roles)
            assert a[1] == list(b[1]), (trial, a[1], b[1])
            assert a[2] == set(b[2]), (trial, a[2], b[2])

    def test_role_int_as_dict_key(self):
        py_fp, c_fp = self._impls()
        docs = [{(1 << 51) + 7: "x", "dueDate": 1_700_000_000_500}]
        roles = {(1 << 51) + 7: "p"}
        a = py_fp(docs, roles, self.FP)
        b = c_fp(docs, roles, self.FP)
        assert a[0] == b[0] and a[1] == list(b[1])

    def test_pinned_elsewhere_not_extracted(self):
        py_fp, c_fp = self._impls()
        due = 1_700_000_000_999
        docs = [{"dueDate": due}, {"other": due}]  # pinned at "other"
        for fp in self._impls():
            payload, values, pinned = fp(docs, {}, self.FP)
            assert values == [] or list(values) == []
        assert py_fp(docs, {}, self.FP)[0] == c_fp(docs, {}, self.FP)[0]


class TestApplyPatchesAndStamp:
    def test_apply_patches_matches_python_loop(self):
        import struct as _struct

        from zeebe_tpu_torch.native import codec_fn

        apply_patches = codec_fn("apply_patches")
        assert apply_patches is not None
        base = bytes(range(200)) * 2
        plan = b"".join(
            _struct.pack("<IBB", off, fmt, idx)
            for off, fmt, idx in [(0, 0, 0), (16, 1, 1), (32, 2, 2), (48, 3, 2)]
        )
        values = [-7, 123456, (1 << 51) + 9]
        buf = bytearray(base)
        apply_patches(buf, plan, values)
        exp = bytearray(base)
        _struct.pack_into("<q", exp, 0, -7)
        _struct.pack_into("<i", exp, 16, 123456)
        _struct.pack_into(">Q", exp, 32, ((1 << 51) + 9) & 0xFFFFFFFFFFFFFFFF)
        _struct.pack_into(">Q", exp, 48, (((1 << 51) + 9) & 0xFFFFFFFFFFFFFFFF) ^ (1 << 63))
        assert bytes(buf) == bytes(exp)

    def test_stamp_batch_matches_python_loop(self):
        import struct as _struct

        from zeebe_tpu_torch.native import codec_fn

        stamp = codec_fn("stamp_batch")
        assert stamp is not None
        buf = bytearray(120)
        stamp(buf, [0, 8, 16], [40, 48], 1000, 1_700_000_000_001)
        exp = bytearray(120)
        for i, off in enumerate([0, 8, 16]):
            _struct.pack_into("<q", exp, off, 1000 + i)
        for off in [40, 48]:
            _struct.pack_into("<q", exp, off, 1_700_000_000_001)
        assert bytes(buf) == bytes(exp)

    def test_apply_patches_bounds_checked(self):
        import struct as _struct

        from zeebe_tpu_torch.native import codec_fn

        apply_patches = codec_fn("apply_patches")
        buf = bytearray(8)
        with pytest.raises(ValueError):
            apply_patches(buf, _struct.pack("<IBB", 4, 0, 0), [1])
        with pytest.raises(IndexError):
            apply_patches(buf, _struct.pack("<IBB", 0, 0, 3), [1])


class TestNativeEncodeKey:
    """codec.c encode_key vs the Python spec (state/db._encode_key_py):
    byte-equality over fuzzed key shapes and identical error behavior."""

    def test_fuzz_byte_equality(self):
        import random

        from zeebe_tpu_torch.state import db as D

        if D._encode_key_native is None:
            import pytest

            pytest.skip("native codec unavailable")
        rng = random.Random(11)
        cfs = list(D.ColumnFamilyCode)

        def rand_part(r):
            roll = r.random()
            if roll < 0.45:
                return r.choice([0, 1, -1, 2**31, -2**31, 2**63 - 1,
                                 -2**63, 2**64 + 5,
                                 r.randint(-10**18, 10**18)])
            if roll < 0.8:
                return "".join(r.choice("abcXYZ09_é中")
                               for _ in range(r.randint(0, 40)))
            # full byte range: 0x00 and 0xFF inside bytes parts are legal
            # and are exactly the values a C truncation bug would hide on
            return bytes(r.randrange(256)
                         for _ in range(r.randint(0, 64)))

        for _ in range(5000):
            cf = rng.choice(cfs)
            parts = tuple(rand_part(rng) for _ in range(rng.randint(0, 4)))
            assert D.encode_key(cf, parts) == D._encode_key_py(cf, parts), (
                cf, parts)

    def test_error_parity(self):
        import pytest

        from zeebe_tpu_torch.state import db as D

        if D._encode_key_native is None:
            pytest.skip("native codec unavailable")
        for bad, exc in (((True,), TypeError), (("x\x00y",), ValueError),
                         ((1.5,), TypeError)):
            with pytest.raises(exc):
                D.encode_key(D.ColumnFamilyCode.JOBS, bad)
            with pytest.raises(exc):
                D._encode_key_py(D.ColumnFamilyCode.JOBS, bad)
