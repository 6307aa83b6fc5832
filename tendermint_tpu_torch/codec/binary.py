"""Deterministic length-prefixed binary encoding: the part of the JAX
package's ``codec/binary.py`` that the port's types use (the writer).
Unsigned LEB128 varints, fixed-width big-endian ints,
uvarint-length-prefixed bytes and strings."""

from __future__ import annotations

import io
import struct


class Writer:
    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = io.BytesIO()

    def bytes(self) -> bytes:
        return self._buf.getvalue()

    def write_uvarint(self, n: int) -> "Writer":
        if n < 0:
            raise ValueError("uvarint must be non-negative")
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self._buf.write(bytes([b | 0x80]))
            else:
                self._buf.write(bytes([b]))
                return self

    def write_u8(self, n: int) -> "Writer":
        self._buf.write(struct.pack(">B", n))
        return self

    def write_u32(self, n: int) -> "Writer":
        self._buf.write(struct.pack(">I", n))
        return self

    def write_u64(self, n: int) -> "Writer":
        self._buf.write(struct.pack(">Q", n))
        return self

    def write_i64(self, n: int) -> "Writer":
        self._buf.write(struct.pack(">q", n))
        return self

    def write_bytes(self, data: bytes) -> "Writer":
        self.write_uvarint(len(data))
        self._buf.write(data)
        return self

    def write_str(self, s: str) -> "Writer":
        return self.write_bytes(s.encode("utf-8"))
