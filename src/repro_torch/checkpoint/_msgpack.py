"""The msgpack subset the checkpoint format uses, written and read without
the ``msgpack`` package.

The encoder writes the bytes ``msgpack.packb(obj, use_bin_type=True)``
writes for: maps (fixmap, map16, map32) with ``str`` keys, ``str``
(fixstr, str8/16/32), ``bytes`` / ``bytearray`` / ``memoryview`` (bin8/16/32),
``int`` (positive and negative fixint, uint8-64, int8-64), ``list`` and
``tuple`` (fixarray, array16/32), ``None`` and ``bool`` — each in its
shortest form, as msgpack picks it.  Anything else raises ``TypeError``.
``pack_chunks`` yields the encoding as a list of buffers, large ``bin``
payloads as the caller's own memory, so a checkpoint is written to its
file without a second copy of its arrays.  The decoder reads the same
subset and returns ``bin`` payloads as zero-copy ``memoryview`` slices of
its input.
"""
from __future__ import annotations

import struct
from typing import Any, Union

Buffer = Union[bytes, bytearray, memoryview]


def _head(small_tag: int, small_max: int, tags: tuple, n: int) -> bytes:
    """A length header: the fix form below ``small_max``, else the 8-,
    16- or 32-bit form from ``tags`` (None where the family has none)."""
    if small_tag is not None and n < small_max:
        return bytes([small_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                (0xD2, ">i", 0x80000000),
                                (0xD3, ">q", 0x8000000000000000)):
            if -v <= limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(0xA0, 32, (0xD9, 0xDA, 0xDB), len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        view = memoryview(obj).cast("B")
        out.append(_head(None, 0, (0xC4, 0xC5, 0xC6), view.nbytes))
        out.append(view)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(0x90, 16, (None, 0xDC, 0xDD), len(obj)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_head(0x80, 16, (None, 0xDE, 0xDF), len(obj)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} in the "
                        f"checkpoint's msgpack subset")


def pack_chunks(obj: Any) -> list:
    """The encoding of ``obj`` as a list of buffers (headers as
    ``bytes``; ``bin`` payloads as views of the caller's memory)."""
    out: list = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    return b"".join(bytes(c) if isinstance(c, memoryview) else c
                    for c in pack_chunks(obj))


class _Reader:
    def __init__(self, data: Buffer):
        self.view = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.view.nbytes:
            raise ValueError("truncated msgpack data")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if tag & 0xF0 == 0x80:
            return self.map(tag & 0x0F)
        if tag & 0xF0 == 0x90:
            return self.array(tag & 0x0F)
        if tag & 0xE0 == 0xA0:
            return self.str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if tag in ints:
            return self.num(ints[tag])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if tag not in lengths:
            raise ValueError(f"msgpack type 0x{tag:02x} is outside the "
                             f"checkpoint's subset")
        n = self.num(lengths[tag])
        if tag <= 0xC6:
            return self.take(n)
        if tag <= 0xDB:
            return self.str(n)
        if tag <= 0xDD:
            return self.array(n)
        return self.map(n)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data: Buffer) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the subset, ``bin``
    payloads as ``memoryview`` slices of ``data``."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != reader.view.nbytes:
        raise ValueError("extra bytes after the msgpack object")
    return obj
