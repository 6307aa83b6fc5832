"""GF(2^255 - 19) on batches of field elements: the plain PyTorch version.

Counterpart of the JAX package's ``ops/field.py``, which carries 20
13-bit int32 limbs because the TPU's vector unit has no 64-bit integers.
Here an element is 10 signed limbs in radix 2^25.5 (ref10's layout:
limb i sits at bit ceil(25.5 i), 26 bits wide for even i and 25 for odd
i), held in int64 tensors of shape (..., 10). The CUDA kernels
(``csrc/fe25519.cuh``) use the same layout in int32 with 64-bit products.
The two are compared only at byte seams (``to_bytes``), so their limbs
need not agree, only their values mod p.

Invariant: every stored element is "carried", each limb in
[-64, 2^26 + 64). Then a limb product times 38 stays below 2^58 and a
column of ten below 2^62, so no int64 ever overflows. ``mul`` carries
three times, ``add``/``sub``/``neg`` once. Right shifts on int64 are
arithmetic, which is what the signed (floor) carries here want.
"""

from __future__ import annotations

import torch

P = 2**255 - 19
LIMBS = 10
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)


def _coef_and_gather():
    """COEF (10, 10): the factor of f_i * g_j in output limb (i+j) % 10
    (2 when i and j are both odd, 19 when i+j wraps past 2^255).
    GATHER (10, 10): for output limb k, the flat indices i*10+j with
    (i+j) % 10 == k."""
    coef = [[0] * 10 for _ in range(10)]
    gather = [[] for _ in range(10)]
    for i in range(10):
        for j in range(10):
            c = 2 if (i & 1 and j & 1) else 1
            if i + j >= 10:
                c *= 19
            coef[i][j] = c
            gather[(i + j) % 10].append(i * 10 + j)
    return coef, gather


_COEF_LIST, _GATHER_LIST = _coef_and_gather()
_CACHE: dict = {}


def _consts(device: torch.device):
    c = _CACHE.get(device)
    if c is None:
        c = (
            torch.tensor(_COEF_LIST, dtype=torch.int64, device=device),
            torch.tensor(_GATHER_LIST, dtype=torch.int64, device=device),
            torch.tensor(WIDTHS, dtype=torch.int64, device=device),
            torch.tensor([(1 << w) - 1 for w in WIDTHS], dtype=torch.int64, device=device),
        )
        _CACHE[device] = c
    return c


def to_limbs(x: int) -> list:
    """Python int -> 10 canonical limbs (host side)."""
    x %= P
    return [(x >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS)]


def from_limbs(limbs) -> int:
    """Any limb vector (list or 1-D tensor) -> its value mod p."""
    return sum(int(v) << o for v, o in zip(limbs, OFFSETS)) % P


def const(x: int, shape, device) -> torch.Tensor:
    """A constant broadcast to (*shape, 10)."""
    t = torch.tensor(to_limbs(x), dtype=torch.int64, device=device)
    return t.expand(*shape, LIMBS).clone()


def carry(h: torch.Tensor) -> torch.Tensor:
    """One parallel signed carry pass; the carry out of limb 9 folds
    into limb 0 times 19 (2^255 = 19 mod p)."""
    _, _, widths, masks = _consts(h.device)
    c = h >> widths
    lo = h & masks
    return lo + torch.cat([19 * c[..., 9:], c[..., :9]], dim=-1)


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    coef, gather, _, _ = _consts(f.device)
    prod = (f.unsqueeze(-1) * g.unsqueeze(-2)) * coef
    flat = prod.flatten(-2)
    h = flat[..., gather].sum(dim=-1)
    return carry(carry(carry(h)))


def square(f: torch.Tensor) -> torch.Tensor:
    return mul(f, f)


def add(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return carry(f + g)


def sub(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return carry(f - g)


def neg(f: torch.Tensor) -> torch.Tensor:
    return carry(-f)


def nsquare(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = square(x)
    return x


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3) (ref10's addition chain)."""
    t0 = square(z)
    t1 = nsquare(t0, 2)
    t1 = mul(z, t1)
    t0 = mul(t0, t1)
    t0 = square(t0)
    t0 = mul(t1, t0)  # 2^5 - 1
    t1 = nsquare(t0, 5)
    t0 = mul(t1, t0)  # 2^10 - 1
    t1 = nsquare(t0, 10)
    t1 = mul(t1, t0)  # 2^20 - 1
    t2 = nsquare(t1, 20)
    t1 = mul(t2, t1)  # 2^40 - 1
    t1 = nsquare(t1, 10)
    t0 = mul(t1, t0)  # 2^50 - 1
    t1 = nsquare(t0, 50)
    t1 = mul(t1, t0)  # 2^100 - 1
    t2 = nsquare(t1, 100)
    t1 = mul(t2, t1)  # 2^200 - 1
    t1 = nsquare(t1, 50)
    t0 = mul(t1, t0)  # 2^250 - 1
    t0 = nsquare(t0, 2)
    return mul(t0, z)  # 2^252 - 3


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) = z^(2^255 - 21); 0 maps to 0."""
    t0 = square(z)  # 2
    t1 = nsquare(t0, 2)  # 8
    t1 = mul(z, t1)  # 9
    t0 = mul(t0, t1)  # 11
    t2 = square(t0)  # 22
    t1 = mul(t1, t2)  # 31 = 2^5 - 1
    t2 = nsquare(t1, 5)
    t1 = mul(t2, t1)  # 2^10 - 1
    t2 = nsquare(t1, 10)
    t2 = mul(t2, t1)  # 2^20 - 1
    t3 = nsquare(t2, 20)
    t2 = mul(t3, t2)  # 2^40 - 1
    t2 = nsquare(t2, 10)
    t1 = mul(t2, t1)  # 2^50 - 1
    t2 = nsquare(t1, 50)
    t2 = mul(t2, t1)  # 2^100 - 1
    t3 = nsquare(t2, 100)
    t2 = mul(t3, t2)  # 2^200 - 1
    t2 = nsquare(t2, 50)
    t1 = mul(t2, t1)  # 2^250 - 1
    t1 = nsquare(t1, 5)  # 2^255 - 32
    return mul(t1, t0)  # 2^255 - 21


def invert_rows(z: torch.Tensor) -> torch.Tensor:
    """(V, E, 10) -> the inverse of every element, each row's E
    inverted together by Montgomery's trick (one inversion a row, three
    multiplications an element), as the table-build kernel does. An
    element that is 0 counts as 1 in the products and its inverse is 0,
    so it cannot spoil the rest of its row."""
    zero = is_zero(z)
    one = const(1, z.shape[:1], z.device)
    zs = select(zero, const(1, z.shape[:2], z.device), z)
    pre, run = [], one
    for e in range(z.shape[1]):
        pre.append(run)
        run = mul(run, zs[:, e])
    inv = invert(run)
    out = [None] * z.shape[1]
    for e in range(z.shape[1] - 1, -1, -1):
        out[e] = mul(inv, pre[e])
        inv = mul(inv, zs[:, e])
    return select(zero, torch.zeros_like(z), torch.stack(out, dim=1))


def canonical(f: torch.Tensor) -> torch.Tensor:
    """The unique representative in [0, p), each limb in [0, 2^width).

    Three sequential floor-carry chains bring the value into [0, 2^255)
    with every limb in range; then V + 19 >= 2^255 tells whether V >= p,
    and in that case (V + 19) mod 2^255 = V - p is the answer."""
    h = [f[..., i] for i in range(LIMBS)]
    for _ in range(3):
        for i in range(LIMBS):
            c = h[i] >> WIDTHS[i]
            h[i] = h[i] - (c << WIDTHS[i])
            if i < LIMBS - 1:
                h[i + 1] = h[i + 1] + c
            else:
                h[0] = h[0] + 19 * c
    t = list(h)
    t[0] = t[0] + 19
    for i in range(LIMBS - 1):
        c = t[i] >> WIDTHS[i]
        t[i] = t[i] - (c << WIDTHS[i])
        t[i + 1] = t[i + 1] + c
    ge_p = (t[9] >> 25) != 0
    t[9] = t[9] & ((1 << 25) - 1)
    out = [torch.where(ge_p, t[i], h[i]) for i in range(LIMBS)]
    return torch.stack(out, dim=-1)


def to_bytes(f: torch.Tensor) -> torch.Tensor:
    """(..., 10) -> (..., 32) uint8, the canonical little-endian encoding."""
    h = canonical(f)
    out = []
    for j in range(32):
        lo_bit = 8 * j
        v = torch.zeros_like(h[..., 0])
        for i, (o, w) in enumerate(zip(OFFSETS, WIDTHS)):
            if o + w <= lo_bit or o >= lo_bit + 8:
                continue
            sh = o - lo_bit
            v = v | ((h[..., i] << sh) if sh >= 0 else (h[..., i] >> -sh))
        out.append(v & 0xFF)
    return torch.stack(out, dim=-1).to(torch.uint8)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 10) int64 limbs; bit 255 is masked, a
    value >= p is kept as it is (it is only ever used mod p)."""
    b = b.to(torch.int64)
    padded = torch.cat([b, torch.zeros_like(b[..., :3])], dim=-1)
    out = []
    for o, w in zip(OFFSETS, WIDTHS):
        j, sh = divmod(o, 8)
        word = (
            padded[..., j]
            | (padded[..., j + 1] << 8)
            | (padded[..., j + 2] << 16)
            | (padded[..., j + 3] << 24)
        )
        out.append((word >> sh) & ((1 << w) - 1))
    return torch.stack(out, dim=-1)


def eq(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return (canonical(f) == canonical(g)).all(dim=-1)


def is_zero(f: torch.Tensor) -> torch.Tensor:
    return (canonical(f) == 0).all(dim=-1)


def is_negative(f: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical value (the encoding's sign of x)."""
    return (canonical(f)[..., 0] & 1) == 1


def select(cond: torch.Tensor, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.unsqueeze(-1), f, g)
