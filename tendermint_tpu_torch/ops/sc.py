"""Scalars mod the ed25519 group order L: the plain PyTorch version.

Counterpart of the JAX package's ``ops/sc.py`` (40 13-bit int32 limbs,
folded four times at bit 252). Here the 512-bit digest is cut into 24
limbs of 21 bits in int64 and reduced as ref10's ``sc_reduce`` does:
2^252 = -l0 (mod L), and -l0 in signed 21-bit digits is
OMEGA below, so limb i >= 12 folds into limbs i-12 .. i-7. The CUDA
kernel (``csrc/sc25519.cuh``) runs the same sequence on int64 registers.

- ``reduce512``: k = SHA512(R || A || M) mod L (Go's scReduce).
- ``is_canonical``: s < L (Go's scMinimal; s + L is rejected).
"""

from __future__ import annotations

from typing import List

import torch

L = 2**252 + 27742317777372353535851937790883648493
# -l0 = sum(OMEGA[j] * 2^(21 j)), l0 = L - 2^252
OMEGA = (666643, 470296, 654183, -997805, 136657, -683901)
_M21 = (1 << 21) - 1


def _fold(s: List[torch.Tensor], i: int) -> None:
    """s[i] * 2^(21 i) -> the same value mod L on limbs i-12 .. i-7."""
    for j, w in enumerate(OMEGA):
        s[i - 12 + j] = s[i - 12 + j] + s[i] * w
    s[i] = torch.zeros_like(s[i])


def _carry(s: List[torch.Tensor], i: int, rounded: bool) -> None:
    c = (s[i] + (1 << 20)) >> 21 if rounded else s[i] >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - (c << 21)


def _load21(b: torch.Tensor) -> List[torch.Tensor]:
    """(..., 64) uint8 -> 24 limbs of 21 bits; the last takes 29."""
    b = b.to(torch.int64)
    padded = torch.cat([b, torch.zeros_like(b[..., :4])], dim=-1)
    n = 24
    out = []
    for i in range(n):
        j, sh = divmod(21 * i, 8)
        word = (
            padded[..., j]
            | (padded[..., j + 1] << 8)
            | (padded[..., j + 2] << 16)
            | (padded[..., j + 3] << 24)
        )
        out.append((word >> sh) & (_M21 if i < n - 1 else (1 << 32) - 1))
    return out


def _store21(s: List[torch.Tensor]) -> torch.Tensor:
    """12 limbs in [0, 2^21) -> (..., 32) uint8."""
    out = []
    for j in range(32):
        v = torch.zeros_like(s[0])
        for i, limb in enumerate(s):
            o = 21 * i
            if o + 21 <= 8 * j or o >= 8 * j + 8:
                continue
            sh = o - 8 * j
            v = v | ((limb << sh) if sh >= 0 else (limb >> -sh))
        out.append(v & 0xFF)
    return torch.stack(out, dim=-1).to(torch.uint8)


def reduce512(digest: torch.Tensor) -> torch.Tensor:
    """(N, 64) little-endian digest bytes -> (N, 32) bytes of digest mod L."""
    s = _load21(digest)  # 24 limbs; s[23] holds 29 bits
    for i in range(23, 17, -1):
        _fold(s, i)
    for i in range(6, 17, 2):
        _carry(s, i, rounded=True)
    for i in range(7, 16, 2):
        _carry(s, i, rounded=True)
    for i in range(17, 11, -1):
        _fold(s, i)
    for i in range(0, 11, 2):
        _carry(s, i, rounded=True)
    for i in range(1, 12, 2):
        _carry(s, i, rounded=True)
    _fold(s, 12)
    for i in range(12):
        _carry(s, i, rounded=False)
    _fold(s, 12)
    for i in range(11):
        _carry(s, i, rounded=False)
    return _store21(s[:12])


_L_BYTES = list(L.to_bytes(32, "little"))


def is_canonical(s_bytes: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N,) bool: s < L, compared from the top byte."""
    s = s_bytes.to(torch.int64)
    lt = torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)
    eq = torch.ones_like(lt)
    for i in range(31, -1, -1):
        lt = lt | (eq & (s[..., i] < _L_BYTES[i]))
        eq = eq & (s[..., i] == _L_BYTES[i])
    return lt
