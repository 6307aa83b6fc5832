"""Batched twisted-Edwards point operations for ed25519: the plain
PyTorch version.

Counterpart of the JAX package's ``ops/curve.py``. Curve
-x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19); points are extended
coordinates (X, Y, Z, T), each a (..., 10) limb tensor (``field``).

Every formula here is the JAX package's formula, step for step
(add-2008-hwcd-3, dbl-2008-hwcd, ref10's cached and affine-cached forms,
the signed 4-bit Straus scan, the per-key split tables and the 8-bit
base comb of the tabled scan). For points on the curve any correct formula gives the same
encoding; for the garbage point a failed decompression leaves behind,
only the same formulas give the same coordinates, and the tests compare
those too. The CUDA kernels (``csrc/ge25519.cuh``) follow the same
sequence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ref_ed25519 as ref

D = ref.D
D2 = (2 * ref.D) % ref.P
SQRT_M1 = ref.SQRT_M1
TBL = 8  # the signed-window tables hold [1..8]Q
# The tabled scan: the 64 nibbles of k in SPLITS groups of SPLIT_W, one
# table of [1..8][16^(SPLIT_W m)]Q per group, so 4 * SPLIT_W doublings
# (the JAX package's default of 16 splits; its TM_SPLITS override exists
# for TPU experiments and is not carried over).
SPLITS = 16
SPLIT_W = 64 // SPLITS
COMB = 128  # base comb entries per byte position: [1..128] 256^p B


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class AffineCached(NamedTuple):
    """ref10's ge_precomp: y+x, y-x, 2dxy of an affine point (Z = 1)."""

    ypx: torch.Tensor
    ymx: torch.Tensor
    t2d: torch.Tensor


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


def madd(p: Point, q: AffineCached, want_t: bool = True) -> Point:
    """p + q with q affine-cached (ref10 ge_madd)."""
    a = F.mul(F.sub(p.y, p.x), q.ymx)
    b = F.mul(F.add(p.y, p.x), q.ypx)
    c = F.mul(p.t, q.t2d)
    d = F.add(p.z, p.z)
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


# -- the per-valset tabled path ----------------------------------------------


def signed_digits_base256(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 little-endian -> (N, 32) signed base-256 digits in
    [-128, 128): a byte >= 128 becomes byte - 256 with a carry up. With
    s < L (< 2^253) digit 31 absorbs the last carry."""
    d = scalar_bytes.to(torch.int64)
    carry = torch.zeros_like(d[..., 0])
    out = []
    for i in range(32):
        v = d[..., i] + carry
        high = (v >= 128).to(torch.int64)
        out.append(v - 256 * high)
        carry = high
    return torch.stack(out, dim=-1)


@functools.lru_cache(maxsize=1)
def base_comb256_limbs() -> tuple:
    """The tabled scan's 8-bit base comb from the pure-Python oracle:
    [p][i] = affine-cached (y+x, y-x, 2dxy) of [(i + 1) 256^p]B, p < 32,
    i < 128, each coordinate as 10 canonical limbs (nested tuples)."""
    out = []
    win = ref.pt_from_affine(*ref.BASE)
    for _ in range(32):
        acc, row = win, []
        for i in range(COMB):
            x, y = ref.pt_to_affine(acc)
            row.append((F.to_limbs(y + x), F.to_limbs(y - x), F.to_limbs(2 * ref.D * x * y)))
            if i < COMB - 1:
                acc = ref.pt_add(acc, win)
        out.append(tuple(row))
        for _ in range(8):  # win = [256] win
            win = ref.pt_double(win)
    return tuple(out)


_COMB: dict = {}


def base_comb256(device) -> torch.Tensor:
    """(32, 128, 3, 10) int64 limbs of base_comb256_limbs()."""
    t = _COMB.get(device)
    if t is None:
        t = torch.tensor(base_comb256_limbs(), dtype=torch.int64, device=device)
        _COMB[device] = t
    return t


def _select_affine(table: torch.Tensor, digit: torch.Tensor) -> AffineCached:
    """table (N, E, 3, 10) (one table a row) or (E, 3, 10) (shared);
    digit (N,) with |digit| <= E. |digit| picks entry |digit| - 1, 0
    gives the affine identity (1, 1, 0), a negative digit swaps y+x and
    y-x and negates 2dxy. A plain gather: the JAX package's select tree
    and one-hot matmul exist to avoid gathers on the TPU."""
    idx = (digit.abs() - 1).clamp(min=0)
    if table.dim() == 3:
        sel = table[idx]
    else:
        sel = table[torch.arange(table.shape[0], device=table.device), idx]
    ypx, ymx, t2d = sel[:, 0], sel[:, 1], sel[:, 2]
    zero = digit == 0
    ypx = F.select(zero, _c(1, ypx), ypx)
    ymx = F.select(zero, _c(1, ymx), ymx)
    t2d = F.select(zero, torch.zeros_like(t2d), t2d)
    neg = digit < 0
    ypx, ymx = F.select(neg, ymx, ypx), F.select(neg, ypx, ymx)
    t2d = F.select(neg, F.neg(t2d), t2d)
    return AffineCached(ypx, ymx, t2d)


def build_split_tables(q: Point) -> torch.Tensor:
    """(V,) points q -> (V, SPLITS, 8, 3, 10) int64: affine-cached
    [i 16^(SPLIT_W m)]q, i = 1..8, m < SPLITS.

    The entries are built as the JAX program builds them (entry 1 is qm,
    each next one the unified sum of the previous and qm, q(m+1) sixteen
    doublings of qm), so a garbage point gives the same values too. The
    Z of a validator's 128 entries are inverted together (Montgomery's
    trick, as the kernel does): a Z that is 0 counts as 1 in the
    products and its inverse is 0, as in the JAX package's
    invert_blocked."""
    xs, ys, zs = [], [], []
    qm = q
    for m in range(SPLITS):
        acc = qm
        for i in range(TBL):
            xs.append(acc.x)
            ys.append(acc.y)
            zs.append(acc.z)
            if i < TBL - 1:
                acc = add(acc, qm)
        if m < SPLITS - 1:
            for j in range(4 * SPLIT_W):
                qm = double(qm, want_t=j == 4 * SPLIT_W - 1)
    zi = F.invert_rows(torch.stack(zs, dim=1))  # (V, 128, 10)
    x = F.mul(torch.stack(xs, dim=1), zi)
    y = F.mul(torch.stack(ys, dim=1), zi)
    t2d = F.mul(F.mul(x, y), _c(D2, x))
    tbl = torch.stack([F.add(y, x), F.sub(y, x), t2d], dim=2)  # (V, 128, 3, 10)
    return tbl.reshape(q.x.shape[0], SPLITS, TBL, 3, F.LIMBS)


def double_scalar_mul_tabled(sd8: torch.Tensor, kd: torch.Tensor, tables: torch.Tensor) -> Point:
    """[s]B + [k]Q from the row's split tables: sd8 (N, 32) signed
    base-256 digits of s, kd (N, 64) signed nibbles of k, tables
    (N, SPLITS, 8, 3, 10). SPLIT_W windows, most significant first, of
    four doublings and SPLITS mixed additions (digit SPLIT_W m + w
    selects from split m); then 32 mixed additions from the base comb,
    the last without T."""
    n = kd.shape[0]
    kdw = kd.reshape(n, SPLITS, SPLIT_W)
    acc = identity(tables[:, 0, 0, 0])
    for w in range(SPLIT_W - 1, -1, -1):
        acc = double(double(double(acc, want_t=False), want_t=False), want_t=False)
        acc = double(acc)
        for m in range(SPLITS):
            acc = madd(acc, _select_affine(tables[:, m], kdw[:, m, w]))
    comb = base_comb256(tables.device)
    for p in range(32):
        acc = madd(acc, _select_affine(comb[p], sd8[:, p]), want_t=p < 31)
    return acc
