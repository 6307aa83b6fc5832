"""Deterministic length-prefixed binary encoding: the part of the JAX
package's ``codec/binary.py`` that the port's types use (the writer, and
the reader that decoding a pubkey or an aggregated commit needs).
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


class DecodeError(Exception):
    pass


class Reader:
    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def done(self) -> bool:
        return self._pos >= len(self._data)

    def expect_done(self) -> None:
        if not self.done():
            raise DecodeError(f"{self.remaining()} trailing bytes")

    def _take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise DecodeError("unexpected EOF")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    def read_uvarint(self) -> int:
        shift, out = 0, 0
        while True:
            if shift > 70:
                raise DecodeError("uvarint overflow")
            b = self._take(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def read_u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def read_i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def read_bytes(self, max_len: int = 1 << 24) -> bytes:
        n = self.read_uvarint()
        if n > max_len:
            raise DecodeError(f"bytes length {n} exceeds max {max_len}")
        return self._take(n)

    def read_str(self, max_len: int = 1 << 20) -> str:
        try:
            return self.read_bytes(max_len).decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid utf-8 in string field: {e}") from e
