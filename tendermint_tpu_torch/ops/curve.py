"""Batched twisted-Edwards point operations for ed25519: the plain
PyTorch version.

Counterpart of the JAX package's ``ops/curve.py``. Curve
-x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19); points are extended
coordinates (X, Y, Z, T), each a (..., 10) limb tensor (``field``).

Every formula here is the JAX package's formula, step for step
(add-2008-hwcd-3, dbl-2008-hwcd, ref10's cached form, the signed 4-bit
Straus scan). For points on the curve any correct formula gives the same
encoding; for the garbage point a failed decompression leaves behind,
only the same formulas give the same coordinates, and the tests compare
those too. The CUDA kernels (``csrc/ge25519.cuh``) follow the same
sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ref_ed25519 as ref

D = ref.D
D2 = (2 * ref.D) % ref.P
SQRT_M1 = ref.SQRT_M1
TBL = 8  # the signed-window tables hold [1..8]Q


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class Cached(NamedTuple):
    """ref10's ge_cached: Y+X, Y-X, 2Z, 2dT."""

    ypx: torch.Tensor
    ymx: torch.Tensor
    z2: torch.Tensor
    t2d: torch.Tensor


def _c(x: int, like: torch.Tensor) -> torch.Tensor:
    return F.const(x, like.shape[:-1], like.device)


def identity(like: torch.Tensor) -> Point:
    zero = torch.zeros_like(like)
    one = _c(1, like)
    return Point(zero, one, one.clone(), zero.clone())


def add(p: Point, q: Point) -> Point:
    """Complete unified addition (add-2008-hwcd-3, a = -1)."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul(F.mul(p.t, _c(D2, p.t)), q.t)
    d = F.mul(p.z, F.add(q.z, q.z))
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(p: Point, want_t: bool = True) -> Point:
    """dbl-2008-hwcd, a = -1. Doubling never reads T, so T is computed
    only where an addition will read it."""
    a = F.square(p.x)
    b = F.square(p.y)
    c = F.square(p.z)
    c = F.add(c, c)
    d = F.neg(a)
    e = F.sub(F.sub(F.square(F.add(p.x, p.y)), a), b)
    g = F.add(d, b)
    f = F.sub(g, c)
    h = F.sub(d, b)
    t = F.mul(e, h) if want_t else torch.zeros_like(e)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def negate(p: Point) -> Point:
    return Point(F.neg(p.x), p.y, p.z, F.neg(p.t))


def to_cached(p: Point) -> Cached:
    return Cached(F.add(p.y, p.x), F.sub(p.y, p.x), F.add(p.z, p.z), F.mul(p.t, _c(D2, p.t)))


def add_cached(p: Point, q: Cached, want_t: bool = True) -> Point:
    """p + q with q cached (ref10 ge_add)."""
    a = F.mul(F.sub(p.y, p.x), q.ymx)
    b = F.mul(F.add(p.y, p.x), q.ypx)
    c = F.mul(p.t, q.t2d)
    d = F.mul(p.z, q.z2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    t = F.mul(e, h) if want_t else torch.zeros_like(e)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def encode(p: Point) -> torch.Tensor:
    """(..., 32) uint8: y with the sign of x in bit 255; one inversion a row."""
    zi = F.invert(p.z)
    x = F.mul(p.x, zi)
    y = F.mul(p.y, zi)
    out = F.to_bytes(y)
    sign = F.is_negative(x).to(torch.uint8)
    out[..., 31] = out[..., 31] | (sign << 7)
    return out


def decompress(data: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """(..., 32) uint8 -> (point, ok), with Go x/crypto's acceptance: bit
    255 is the sign and is masked from y, y >= p is taken mod p, and
    x = 0 with the sign bit set is accepted. ok is False where x^2 has no
    square root; the point is then the JAX package's garbage point."""
    sign = ((data[..., 31].to(torch.int64) >> 7) & 1) == 1
    y = F.from_bytes(data)
    one = _c(1, y)
    yy = F.square(y)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, _c(D, y)), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok_plus = F.eq(vxx, u)
    ok_minus = F.eq(vxx, F.neg(u))
    x = F.select(ok_plus, x, F.mul(x, _c(SQRT_M1, x)))
    ok = ok_plus | ok_minus
    flip = F.is_negative(x) != sign
    x = F.select(flip, F.neg(x), x)
    return Point(x, y, one, F.mul(x, y)), ok


def nibble_digits(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 little-endian -> (N, 64) base-16 digits, low first."""
    b = scalar_bytes.to(torch.int64)
    return torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1).reshape(*b.shape[:-1], 64)


def signed_digits(d: torch.Tensor) -> torch.Tensor:
    """Base-16 digits (N, 64) -> signed digits in [-8, 8): d >= 8 becomes
    d - 16 with a carry up. With s < L and k < L (both < 2^253), digit 63
    is below 8 and absorbs the last carry."""
    carry = torch.zeros_like(d[..., 0])
    out = []
    for i in range(64):
        v = d[..., i] + carry
        high = (v >= 8).to(torch.int64)
        out.append(v - 16 * high)
        carry = high
    return torch.stack(out, dim=-1)


def base_table_ints() -> list:
    """[1..8]B in cached form from the pure-Python oracle, as ints:
    8 rows of (y+x, y-x, 2, 2d xy) with (x, y) affine."""
    B = ref.pt_from_affine(*ref.BASE)
    rows, acc = [], B
    for _ in range(TBL):
        x, y = ref.pt_to_affine(acc)
        rows.append(((y + x) % ref.P, (y - x) % ref.P, 2, 2 * ref.D * x * y % ref.P))
        acc = ref.pt_add(acc, B)
    return rows


_BASE: dict = {}


def base_table(device) -> torch.Tensor:
    """(8, 4, 10) int64 limbs of base_table_ints()."""
    t = _BASE.get(device)
    if t is None:
        t = torch.tensor(
            [[F.to_limbs(c) for c in row] for row in base_table_ints()],
            dtype=torch.int64,
            device=device,
        )
        _BASE[device] = t
    return t


def _select(table: torch.Tensor, digit: torch.Tensor) -> Cached:
    """table (N, 8, 4, 10) or (8, 4, 10); digit (N,) in [-8, 8).
    |digit| picks row |digit| - 1; 0 gives the cached identity
    (1, 1, 2, 0); a negative digit swaps Y+X and Y-X and negates 2dT."""
    mag = digit.abs()
    idx = (mag - 1).clamp(min=0)
    if table.dim() == 3:
        sel = table[idx]
    else:
        sel = table[torch.arange(table.shape[0], device=table.device), idx]
    ypx, ymx, z2, t2d = sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3]
    zero = digit == 0
    ypx = F.select(zero, _c(1, ypx), ypx)
    ymx = F.select(zero, _c(1, ymx), ymx)
    z2 = F.select(zero, _c(2, z2), z2)
    t2d = F.select(zero, torch.zeros_like(t2d), t2d)
    neg = digit < 0
    ypx, ymx = F.select(neg, ymx, ypx), F.select(neg, ypx, ymx)
    t2d = F.select(neg, F.neg(t2d), t2d)
    return Cached(ypx, ymx, z2, t2d)


def double_scalar_mul_signed(sd: torch.Tensor, kd: torch.Tensor, q: Point) -> Point:
    """[s]B + [k]Q by Straus: sd, kd (N, 64) signed digits, 64 windows of
    four shared doublings, one cached-table addition from the constant
    [1..8]B table and one from the row's [1..8]Q table. The last
    addition of each window skips T (the next reader is a doubling)."""
    rows, acc = [], q
    for i in range(TBL):
        rows.append(torch.stack(list(to_cached(acc)), dim=1))
        if i < TBL - 1:
            acc = add(acc, q)
    q_table = torch.stack(rows, dim=1)  # (N, 8, 4, 10)
    b_table = base_table(q.x.device)
    acc = identity(q.x)
    for w in range(63, -1, -1):
        acc = double(double(double(acc, want_t=False), want_t=False), want_t=False)
        acc = double(acc)
        acc = add_cached(acc, _select(b_table, sd[:, w]))
        acc = add_cached(acc, _select(q_table, kd[:, w]), want_t=False)
    return acc
