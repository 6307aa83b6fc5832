"""BitArray: fixed-width bit vector (reference libs/bits/bit_array.go:15).

The port's copy of the JAX package's ``utils/bits.py``: the part an
aggregated commit's signer bitmap needs (construction, setting a bit,
the count of set bits, the mask, the little-endian wire form).
numpy-backed, so a bitmap is a mask as it stands.
"""

from __future__ import annotations

import numpy as np


class BitArray:
    __slots__ = ("bits", "_elems")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self.bits = bits
        self._elems = np.zeros(bits, dtype=bool)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_numpy(cls, arr: np.ndarray) -> "BitArray":
        ba = cls(int(arr.shape[0]))
        ba._elems[:] = arr.astype(bool)
        return ba

    # -- access ------------------------------------------------------------

    def set_index(self, i: int, v: bool) -> bool:
        if i >= self.bits or i < 0:
            return False
        self._elems[i] = v
        return True

    def __len__(self) -> int:
        return self.bits

    def as_numpy(self) -> np.ndarray:
        return self._elems.copy()

    def num_true_bits(self) -> int:
        return int(self._elems.sum())

    # -- encoding ----------------------------------------------------------

    def to_bytes(self) -> bytes:
        return np.packbits(self._elems, bitorder="little").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, bits: int) -> "BitArray":
        arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
        return cls.from_numpy(arr[:bits])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and bool(np.array_equal(self._elems, other._elems))
        )

    def __repr__(self) -> str:
        s = "".join("x" if b else "_" for b in self._elems[:64])
        if self.bits > 64:
            s += "..."
        return f"BA{{{self.bits}:{s}}}"
