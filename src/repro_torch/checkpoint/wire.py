# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The MessagePack subset the checkpoint container uses, without the
``msgpack`` package.

:func:`packb` writes maps, strings, bytes, ints, lists / tuples, floats,
booleans and ``None`` in the encodings ``msgpack.packb`` picks by default
(``use_bin_type=True``: the smallest form of each; a positive int in the
unsigned forms, a float as a float 64), so the same payload gives the same
bytes.  :func:`unpackb` reads every form of those types
(``msgpack.unpackb(raw=False)``'s view: strings as ``str``, bin as
``bytes``-like).  Bin values come back as ``memoryview`` slices of the
input, so a checkpoint's tensors are not copied while parsing.
"""
from __future__ import annotations

import struct
from typing import Any, List

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(x: int, out: List[bytes]) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(_U8.pack(x))
        elif x < 0x100:
            out.append(b"\xcc" + _U8.pack(x))
        elif x < 0x10000:
            out.append(b"\xcd" + _U16.pack(x))
        elif x < 0x100000000:
            out.append(b"\xce" + _U32.pack(x))
        elif x < 0x10000000000000000:
            out.append(b"\xcf" + _U64.pack(x))
        else:
            raise OverflowError(f"int {x} does not fit msgpack's 64 bits")
    elif x >= -32:
        out.append(_I8.pack(x))
    elif x >= -0x80:
        out.append(b"\xd0" + _I8.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _I16.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(x))
    else:
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, heads: tuple,
              out: List[bytes]) -> None:
    """A container or string header: the fix form below ``fix_max``, then
    the 8- (where the type has one), 16- and 32-bit forms."""
    if n < fix_max:
        out.append(_U8.pack(fix | n))
        return
    h8, h16, h32 = heads
    if h8 is not None and n < 0x100:
        out.append(h8 + _U8.pack(n))
    elif n < 0x10000:
        out.append(h16 + _U16.pack(n))
    elif n < 0x100000000:
        out.append(h32 + _U32.pack(n))
    else:
        raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        if n < 0x100:
            out.append(b"\xc4" + _U8.pack(n))
        elif n < 0x10000:
            out.append(b"\xc5" + _U16.pack(n))
        elif n < 0x100000000:
            out.append(b"\xc6" + _U32.pack(n))
        else:
            raise ValueError(f"bin of {n} bytes does not fit msgpack")
        out.append(bytes(obj) if isinstance(obj, memoryview) else obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj)``'s bytes)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data) -> None:
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def str_(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def obj(self) -> Any:
        b = self.unpack(_U8)
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0f)
        if b < 0xa0:
            return self.array(b & 0x0f)
        if b < 0xc0:
            return self.str_(b & 0x1f)
        handler = _HEADS.get(b)
        if handler is None:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        return handler(self)


_HEADS = {
    0xc0: lambda r: None,
    0xc2: lambda r: False,
    0xc3: lambda r: True,
    0xc4: lambda r: r.take(r.unpack(_U8)),
    0xc5: lambda r: r.take(r.unpack(_U16)),
    0xc6: lambda r: r.take(r.unpack(_U32)),
    0xca: lambda r: r.unpack(_F32),
    0xcb: lambda r: r.unpack(_F64),
    0xcc: lambda r: r.unpack(_U8),
    0xcd: lambda r: r.unpack(_U16),
    0xce: lambda r: r.unpack(_U32),
    0xcf: lambda r: r.unpack(_U64),
    0xd0: lambda r: r.unpack(_I8),
    0xd1: lambda r: r.unpack(_I16),
    0xd2: lambda r: r.unpack(_I32),
    0xd3: lambda r: r.unpack(_I64),
    0xd9: lambda r: r.str_(r.unpack(_U8)),
    0xda: lambda r: r.str_(r.unpack(_U16)),
    0xdb: lambda r: r.str_(r.unpack(_U32)),
    0xdc: lambda r: r.array(r.unpack(_U16)),
    0xdd: lambda r: r.array(r.unpack(_U32)),
    0xde: lambda r: r.map(r.unpack(_U16)),
    0xdf: lambda r: r.map(r.unpack(_U32)),
}


def unpackb(data) -> Any:
    """The one object MessagePack ``data`` holds; extra bytes raise."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return out
