"""MessagePack codec — the record value wire format.

Self-contained implementation of the msgpack spec subset Zeebe uses for record
values and variable documents (reference: msgpack-core/src/main/java/io/camunda/
zeebe/msgpack/spec/{MsgPackWriter,MsgPackReader}.java): nil, bool, int (up to
64-bit signed/unsigned), float64, str, bin, array, map.

Why not the C `msgpack` package: record codecs are part of the framework (the
reference implements its own zero-alloc reader/writer rather than depending on
msgpack-java), and this module is also the specification for the planned C++
hot-path codec. The pure-Python path is used for control-plane records; the bulk
data path (device arrays) never goes through msgpack at all — that is the point
of the TPU design. Tests cross-check this codec against the C msgpack package.
"""

from __future__ import annotations

import struct
from typing import Any

_pack_f64 = struct.Struct(">d").pack
_pack_u16 = struct.Struct(">H").pack
_pack_u32 = struct.Struct(">I").pack
_pack_u64 = struct.Struct(">Q").pack
_pack_i8 = struct.Struct(">b").pack
_pack_i16 = struct.Struct(">h").pack
_pack_i32 = struct.Struct(">i").pack
_pack_i64 = struct.Struct(">q").pack


class MsgPackError(Exception):
    pass


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` to msgpack bytes. Dict keys are serialized in insertion
    order (determinism: callers must present keys in a canonical order; record
    values do — see record.py)."""
    buf = bytearray()
    _pack(obj, buf)
    return bytes(buf)


def _pack(obj: Any, buf: bytearray, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise MsgPackError(f"msgpack nesting exceeds {_MAX_DEPTH}")
    if obj is None:
        buf.append(0xC0)
    elif obj is True:
        buf.append(0xC3)
    elif obj is False:
        buf.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, buf)
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
            _pack(item, buf, depth + 1)
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
            _pack(k, buf, depth + 1)
            _pack(v, buf, depth + 1)
    else:
        raise MsgPackError(f"cannot msgpack type {type(obj).__name__}")


def _pack_int(v: int, buf: bytearray) -> None:
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
        elif v < 0x10000000000000000:
            buf.append(0xCF)
            buf += _pack_u64(v)
        else:
            raise MsgPackError(f"int too large: {v}")
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
        elif v >= -0x8000000000000000:
            buf.append(0xD3)
            buf += _pack_i64(v)
        else:
            raise MsgPackError(f"int too small: {v}")


_MAX_DEPTH = 256


class _Reader:
    __slots__ = ("data", "pos", "depth")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.depth = 0

    def read(self) -> Any:
        data = self.data
        i = self.pos
        if i >= len(data):
            raise MsgPackError("truncated msgpack data")
        if self.depth > _MAX_DEPTH:
            raise MsgPackError(f"msgpack nesting exceeds {_MAX_DEPTH}")
        b = data[i]
        self.pos = i + 1
        if b < 0x80:  # positive fixint
            return b
        if b >= 0xE0:  # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._read_str(b & 0x1F)
        handler = _HANDLERS.get(b)
        if handler is None:
            raise MsgPackError(f"unsupported msgpack byte 0x{b:02x}")
        return handler(self)

    def _take(self, n: int) -> bytes:
        i = self.pos
        if i + n > len(self.data):
            raise MsgPackError("truncated msgpack data")
        self.pos = i + n
        return self.data[i : i + n]

    def _read_str(self, n: int) -> str:
        return self._take(n).decode("utf-8")

    def _read_array(self, n: int) -> list:
        self.depth += 1
        out = [self.read() for _ in range(n)]
        self.depth -= 1
        return out

    def _read_map(self, n: int) -> dict:
        self.depth += 1
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        self.depth -= 1
        return out

    def _u(self, fmt: str, n: int) -> int:
        return struct.unpack(fmt, self._take(n))[0]


_HANDLERS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r._take(r._u(">B", 1))),
    0xC5: lambda r: bytes(r._take(r._u(">H", 2))),
    0xC6: lambda r: bytes(r._take(r._u(">I", 4))),
    0xCA: lambda r: r._u(">f", 4),
    0xCB: lambda r: r._u(">d", 8),
    0xCC: lambda r: r._u(">B", 1),
    0xCD: lambda r: r._u(">H", 2),
    0xCE: lambda r: r._u(">I", 4),
    0xCF: lambda r: r._u(">Q", 8),
    0xD0: lambda r: r._u(">b", 1),
    0xD1: lambda r: r._u(">h", 2),
    0xD2: lambda r: r._u(">i", 4),
    0xD3: lambda r: r._u(">q", 8),
    0xD9: lambda r: r._read_str(r._u(">B", 1)),
    0xDA: lambda r: r._read_str(r._u(">H", 2)),
    0xDB: lambda r: r._read_str(r._u(">I", 4)),
    0xDC: lambda r: r._read_array(r._u(">H", 2)),
    0xDD: lambda r: r._read_array(r._u(">I", 4)),
    0xDE: lambda r: r._read_map(r._u(">H", 2)),
    0xDF: lambda r: r._read_map(r._u(">I", 4)),
}


def unpackb(data: bytes) -> Any:
    """Deserialize one msgpack value from ``data`` (must consume all bytes).

    All malformed-input failures surface as MsgPackError so corrupt-frame
    handling in stream consumers can catch one exception type.
    """
    r = _Reader(bytes(data))
    try:
        obj = r.read()
    except MsgPackError:
        raise
    except (UnicodeDecodeError, TypeError, struct.error) as exc:
        raise MsgPackError(f"malformed msgpack data: {exc}") from exc
    if r.pos != len(r.data):
        raise MsgPackError(f"trailing bytes after msgpack value: {len(r.data) - r.pos}")
    return obj


# keep the pure-Python implementations importable under stable names (the
# native parity tests and the ZEEBE_TPU_NO_NATIVE escape hatch use them)
py_packb = packb
py_unpackb = unpackb

from zeebe_tpu_torch import native as _native  # noqa: E402  (cycle-free leaf package)

_codec = _native.load_codec()
if _codec is not None:
    _codec.set_error_class(MsgPackError)
    packb = _codec.packb
    unpackb = _codec.unpackb
