"""A MessagePack encoder and decoder in pure Python.

The JAX package's native weight file, ``flax_model.msgpack``, is MessagePack
(https://github.com/msgpack/msgpack/blob/master/spec.md). The machines that
serve the port need not have the ``msgpack`` package, so the hub carries its
own codec, as it does for safetensors.

:func:`packb` writes the bytes ``msgpack.packb(obj, use_bin_type=True)``
writes: the shortest form of every int, str, bin, array, map and ext header,
floats as float64, tuples as arrays, and :class:`ExtType` as ext.
:func:`unpackb` reads every type of the spec: nil, bool, ints of every width,
float32 and float64, str, bin, array, map and ext (fixext 1-16, ext 8/16/32;
code -1 is handed to the hook like any other). Arrays come back as lists;
bin payloads and ext data come back as ``memoryview`` slices of the input,
so large payloads are not copied. Malformed input raises ``ValueError``
naming the offset: truncated data, an unknown type byte, a map key that is
not a str or bin, nesting deeper than 512, or trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, NamedTuple, Optional

MAX_DEPTH = 512


class ExtType(NamedTuple):
    """An ext object: a signed 8-bit type code and its payload."""

    code: int
    data: Any


# --- encoder ----------------------------------------------------------------


def _header(n: int, fix: Optional[tuple], widths: tuple) -> bytes:
    """The shortest header of a length ``n``: ``fix`` is (first byte, limit)."""
    if fix is not None and n <= fix[1]:
        return bytes((fix[0] | n,))
    for byte, fmt, limit in widths:
        if n <= limit:
            return struct.pack(fmt, byte, n)
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


_W8, _W16, _W32 = 0xFF, 0xFFFF, 0xFFFFFFFF
_STR = ((0xD9, ">BB", _W8), (0xDA, ">BH", _W16), (0xDB, ">BI", _W32))
_BIN = ((0xC4, ">BB", _W8), (0xC5, ">BH", _W16), (0xC6, ">BI", _W32))
_ARRAY = ((0xDC, ">BH", _W16), (0xDD, ">BI", _W32))
_MAP = ((0xDE, ">BH", _W16), (0xDF, ">BI", _W32))
_EXT = ((0xC7, ">BB", _W8), (0xC8, ">BH", _W16), (0xC9, ">BI", _W32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_INTS = (  # (low, high, format, first byte), in msgpack-python's order
    (0x80, 0xFF, ">BB", 0xCC),
    (-0x80, -1, ">Bb", 0xD0),
    (0x100, 0xFFFF, ">BH", 0xCD),
    (-0x8000, -0x81, ">Bh", 0xD1),
    (0x10000, 0xFFFFFFFF, ">BI", 0xCE),
    (-0x80000000, -0x8001, ">Bi", 0xD2),
    (0x100000000, 0xFFFFFFFFFFFFFFFF, ">BQ", 0xCF),
    (-0x8000000000000000, -0x80000001, ">Bq", 0xD3),
)


def _pack_int(obj: int) -> bytes:
    if 0 <= obj < 0x80:
        return bytes((obj,))
    if -0x20 <= obj < 0:
        return struct.pack("b", obj)
    for low, high, fmt, byte in _INTS:
        if low <= obj <= high:
            return struct.pack(fmt, byte, obj)
    raise OverflowError(f"msgpack: integer {obj} out of range")


def _pack(obj: Any, out: List, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError(f"msgpack: nesting deeper than {MAX_DEPTH}")
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, (bytes, bytearray)):
        out += (_header(len(obj), None, _BIN), obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += (_header(len(raw), (0xA0, 31), _STR), raw)
    elif isinstance(obj, memoryview):
        out += (_header(obj.nbytes, None, _BIN), obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, ExtType):
        n = memoryview(obj.data).nbytes
        head = bytes((_FIXEXT[n],)) if n in _FIXEXT else _header(n, None, _EXT)
        out += (head, struct.pack("b", obj.code), obj.data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), (0x90, 15), _ARRAY))
        for item in obj:
            _pack(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), (0x80, 15), _MAP))
        for key, value in obj.items():
            _pack(key, out, depth + 1)
            _pack(value, out, depth + 1)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack."""
    out: List = []
    _pack(obj, out, 0)
    return b"".join(out)


# --- decoder ----------------------------------------------------------------


class _Reader:
    def __init__(self, data, ext_hook: Optional[Callable]):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.ext_hook = ext_hook

    def need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise ValueError(
                f"msgpack: truncated at offset {self.pos}: {n} bytes wanted, "
                f"{len(self.buf) - self.pos} left"
            )

    def take(self, n: int) -> memoryview:
        self.need(n)
        self.pos += n
        return self.buf[self.pos - n : self.pos]

    def unpack(self, fmt: struct.Struct):
        self.need(fmt.size)
        value = fmt.unpack_from(self.buf, self.pos)[0]
        self.pos += fmt.size
        return value

    def ext(self, n: int):
        code = self.unpack(_CODE)
        data = self.take(n)
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code, data)

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            at = self.pos
            key = self.read(depth + 1)
            if isinstance(key, memoryview):
                key = bytes(key)
            elif not isinstance(key, str):
                raise ValueError(f"msgpack: map key of type {type(key).__name__} at offset {at}")
            out[key] = self.read(depth + 1)
        return out

    def text(self, n: int) -> str:
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: invalid UTF-8 in the str at offset {at}") from e

    def read(self, depth: int = 0) -> Any:
        if depth > MAX_DEPTH:
            raise ValueError(f"msgpack: nesting deeper than {MAX_DEPTH} at offset {self.pos}")
        at = self.pos
        self.need(1)
        b = self.buf[at]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if b <= 0x9F:
            return [self.read(depth + 1) for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.text(n)
            if kind == "ext":
                return self.ext(n)
            if kind == "array":
                return [self.read(depth + 1) for _ in range(n)]
            return self.map(n, depth)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {at}")


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_S = {fmt: struct.Struct(fmt) for fmt in (">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q",
                                          ">f", ">d")}
_CODE = _S[">b"]
_SCALARS = {
    0xCA: _S[">f"], 0xCB: _S[">d"],
    0xCC: _S[">B"], 0xCD: _S[">H"], 0xCE: _S[">I"], 0xCF: _S[">Q"],
    0xD0: _S[">b"], 0xD1: _S[">h"], 0xD2: _S[">i"], 0xD3: _S[">q"],
}
_FIXEXT_LEN = {byte: n for n, byte in _FIXEXT.items()}
_SIZED = {
    0xC4: ("bin", _S[">B"]), 0xC5: ("bin", _S[">H"]), 0xC6: ("bin", _S[">I"]),
    0xC7: ("ext", _S[">B"]), 0xC8: ("ext", _S[">H"]), 0xC9: ("ext", _S[">I"]),
    0xD9: ("str", _S[">B"]), 0xDA: ("str", _S[">H"]), 0xDB: ("str", _S[">I"]),
    0xDC: ("array", _S[">H"]), 0xDD: ("array", _S[">I"]),
    0xDE: ("map", _S[">H"]), 0xDF: ("map", _S[">I"]),
}


def unpackb(data, *, ext_hook: Optional[Callable[[int, memoryview], Any]] = None) -> Any:
    """The one object that ``data`` (any bytes-like object) encodes.

    ``ext_hook(code, data)`` turns each ext object into a value; without it
    an ext comes back as :class:`ExtType`.
    """
    reader = _Reader(data, ext_hook)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(
            f"msgpack: {len(reader.buf) - reader.pos} trailing bytes at offset {reader.pos}"
        )
    return obj
