"""Batched BLS12-381: three hand-written CUDA kernels
(``csrc/bls12_kernels.cu``) and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/bls12.py``. The wrappers:

- ``g1_aggregate(points, mask)``: points (V, 2, 48) affine G1 (x, y),
  mask (B, V) bool -> (B, 2, 48) affine sums and (B,) identity flags;
  the masked sum of the selected points, any V (the JAX program takes
  a power of two, with a point table per batch row);
- ``map_to_g2(u0, u1)``: two (N, 2, 48) Fp2 elements a row (the host's
  ``hash_to_field_fp2``) -> (N, 2, 2, 48) affine G2 (x, y) and (N,)
  identity flags: two SvdW maps, their sum, times the full G2 cofactor
  H2, normalised; the oracle's ``clear_cofactor_g2(map(u0) + map(u1))``;
- ``pairing_check_rows(pk, hm, sig)``: pk (N, 2, 48), hm and sig
  (N, 2, 2, 48) -> (N,) bool, e(pk, hm) e(-G1, sig) == 1, and the
  reduced Fp12 value of that product, (N, 2, 3, 2, 48);
- ``pairing_value(p, q)``: the reduced pairing e(p, q), (N, 2, 3, 2, 48),
  through the same kernel with one pair a row.

Every seam is canonical: a field element is 48 big-endian bytes of its
value below p, an Fp2 element (c0, c1), an Fp12 element in the JAX
package's coefficient order (over w, then v^0..v^2, then u). A reduced
pairing here, as in the JAX package, is the oracle's CUBED: the final
exponentiation runs the chain (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 =
3 (p^4 - p^2 + 1) / r, and the Miller loop runs over |x| without the
conjugation for the negative x. Verdicts are the oracle's.

Each wrapper checks device, dtype, shape and contiguity, runs the plain
version for a tensor on the CPU and launches its kernel for a tensor on
the card (or raises: there is no fallback from one to the other).
``<wrapper>.launches`` counts kernel launches and nothing else. The map
and pairing kernels work a row on a group of G lanes of one warp, or on
a block of warps; each kernel's G is compiled in (``lanes`` reads it).

The plain versions run on int64 tensors, vectorised over rows, in their
own representation (the kernels' is 12 x 32-bit Montgomery limbs, which
a CPU's int64 cannot multiply): 16 limbs of 26 bits of a plain residue,
signed, reduced lazily. A product is one outer product of the limbs,
its columns summed and carried, and the limbs above 2^390 folded back
with the table of 2^(26k) mod p; sums and differences are limb-wise and
free. Each stage stacks its independent products into one call, as the
JAX program does, so a pairing is tens of thousands of torch calls.
"""

from __future__ import annotations

import functools
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import ref_bls12 as ref
from tendermint_tpu_torch.ops.ed25519 import _check, _lib, _route, _stream

P = ref.P
FP_BYTES = 48

# -- host conversions ---------------------------------------------------------------


def fp_bytes(x: int) -> bytes:
    return (x % P).to_bytes(FP_BYTES, "big")


def _pack(buf: bytes, shape, device) -> torch.Tensor:
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def g1_tensor(points: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Affine G1 points (x, y) ints -> (N, 2, 48) uint8."""
    buf = b"".join(fp_bytes(x) + fp_bytes(y) for x, y in points)
    return _pack(buf, (len(points), 2, FP_BYTES), device)


def fp2_tensor(vals: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Fp2 elements (c0, c1) -> (N, 2, 48) uint8."""
    buf = b"".join(fp_bytes(a) + fp_bytes(b) for a, b in vals)
    return _pack(buf, (len(vals), 2, FP_BYTES), device)


def g2_tensor(points, device=None) -> torch.Tensor:
    """Affine G2 points ((x0, x1), (y0, y1)) -> (N, 2, 2, 48) uint8."""
    buf = b"".join(fp_bytes(x[0]) + fp_bytes(x[1]) + fp_bytes(y[0]) + fp_bytes(y[1]) for x, y in points)
    return _pack(buf, (len(points), 2, 2, FP_BYTES), device)


def ints(t: torch.Tensor):
    """(..., 48) canonical bytes -> nested lists of Python ints."""
    arr = t.cpu().numpy()
    flat = arr.reshape(-1, FP_BYTES)
    vals = [int.from_bytes(r.tobytes(), "big") for r in flat]
    shape = arr.shape[:-1]

    def nest(vs, dims):
        if not dims:
            return vs[0]
        step = len(vs) // dims[0]
        return [nest(vs[i * step:(i + 1) * step], dims[1:]) for i in range(dims[0])]

    return nest(vals, list(shape)) if shape else vals[0]


def g1_points(t: torch.Tensor, inf: torch.Tensor):
    """(N, 2, 48) and (N,) flags -> oracle points (None = identity)."""
    vals = ints(t)
    return [None if f else (x, y) for (x, y), f in zip(vals, inf.tolist())]


def g2_points(t: torch.Tensor, inf: torch.Tensor):
    vals = ints(t)
    return [None if f else ((x[0], x[1]), (y[0], y[1])) for (x, y), f in zip(vals, inf.tolist())]


def f12_value(t: torch.Tensor):
    """(2, 3, 2, 48) -> the oracle's nested Fp12 tuple."""
    v = ints(t)
    return tuple(tuple((c[0], c[1]) for c in half) for half in v)


# -- the plain field: 16 signed limbs of 26 bits --------------------------------------

W = 26
MASK = (1 << W) - 1
NLIMB = 16
LOW = 15            # limbs below 2^390; everything above is folded
FOLD_ROWS = 18      # limbs 15..32 of a carried product


def _limbs(x: int, n: int = NLIMB) -> List[int]:
    return [(x >> (W * i)) & MASK for i in range(n)]


@lru_cache(maxsize=None)
def _consts(device_str: str) -> dict:
    """The plain versions' constant tensors on one device."""
    dev = torch.device(device_str)

    def t(rows):
        return torch.tensor(rows, dtype=torch.int64, device=dev)

    def f2(v):
        return t([_limbs(v[0] % P), _limbs(v[1] % P)])

    kp = P * (-(-(1 << 413) // P))  # a multiple of p above 2^413
    c = {
        "fold": t([_limbs(pow(2, W * k, P), LOW) for k in range(LOW, LOW + FOLD_ROWS)]),
        "p": t(_limbs(P)),
        "p26": t(_limbs(P << W)),
        "kp": t(_limbs(kp)),
        "one": t(_limbs(1)),
        "b2": f2(ref.B2),
        "z": f2(ref.Z_SVDW),
        "c1": f2(ref._C1),
        "c2": f2(ref._C2),
        "c3": f2(ref._C3),
        "c4": f2(ref._C4),
        "inv2": t(_limbs(pow(2, P - 2, P))),
        "frob": torch.stack([f2(v) for v in ref._FROB_V] + [f2(ref.f2_mul(v, ref._FROB_W)) for v in ref._FROB_V]),
        "neg_g1": t([_limbs(ref.G1_GEN[0]), _limbs(-ref.G1_GEN[1] % P)]),
    }
    # bytes <-> limbs: limb i holds bits [26 i, 26 i + 26) of the
    # little-endian value; byte k (little-endian) bits [8 k, 8 k + 8)
    idx, shl = [], []
    for i in range(NLIMB):
        ks = [k for k in range(FP_BYTES) if 8 * k + 8 > W * i and 8 * k < W * i + W] or [0]
        ks = (ks + [ks[-1]] * 5)[:5]
        idx.append(ks)
        shl.append([8 * k - W * i if j < len(set(ks)) else 64 for j, k in enumerate(ks)])
    c["b2l_idx"] = t(idx)
    c["b2l_shift"] = t(shl)
    bidx, bsh = [], []
    for k in range(FP_BYTES):
        i = (8 * k) // W
        bidx.append([i, min(i + 1, NLIMB - 1)])
        bsh.append([(8 * k) % W, W - (8 * k) % W])
    c["l2b_idx"] = t(bidx)
    c["l2b_shift"] = t(bsh)
    return c


def _c(x: torch.Tensor) -> dict:
    return _consts(str(x.device))


@lru_cache(maxsize=None)
def _keep_mask(n: int, device_str: str) -> torch.Tensor:
    """For a pass over n limbs: keep the low 26 bits of every limb but
    the top, all of whose bits stay."""
    keep = torch.full((n,), MASK, dtype=torch.int64, device=torch.device(device_str))
    keep[-1] = -1
    return keep


def _pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: limbs below the top split into 26 bits
    (floor semantics, so signed values borrow), the top accumulates."""
    return (x & _keep_mask(x.shape[-1], str(x.device))) + torch.nn.functional.pad(x[..., :-1] >> W, (1, 0))


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """Any (..., n >= 16) limbs (|limb| < 2^61) -> 16 limbs of the same
    residue, limbs 0..14 within 2^26 + 2^5, the top signed, |value| <
    2^412: carry, fold every limb from 2^390 up, carry."""
    c = _c(x)
    x = _pass(_pass(x))
    hi = x[..., LOW:]
    fold = c["fold"][: hi.shape[-1]]
    # an int64 matrix product where the device has one (the CPU's), else
    # the same sum of products written out
    folded = hi @ fold if x.device.type == "cpu" else (hi.unsqueeze(-1) * fold).sum(-2)
    return _pass(_pass(torch.nn.functional.pad(x[..., :LOW] + folded, (0, 1))))


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns (..., 16) x (..., 16) -> (..., 33): the
    31 columns and two zero limbs for the carries."""
    a, b = torch.broadcast_tensors(a, b)
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 16, 16)
    n = NLIMB
    # skew row i right by i: pad to (n, 2n + 2), flatten, regroup by 2n + 1
    skew = torch.nn.functional.pad(outer, (0, n + 2)).flatten(-2)[..., : n * (2 * n + 1)]
    return skew.unflatten(-1, (n, 2 * n + 1)).sum(-2)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(_cols(a, b))


def _exact(x: torch.Tensor) -> torch.Tensor:
    """Sequential carry: limbs 0..14 exactly in [0, 2^26), the top signed."""
    cols = list(x.unbind(-1))
    for i in range(NLIMB - 1):
        cols[i + 1] = cols[i + 1] + (cols[i] >> W)
        cols[i] = cols[i] & MASK
    return torch.stack(cols, dim=-1)


def canon(x: torch.Tensor) -> torch.Tensor:
    """The residue's canonical limbs: exact 26-bit limbs of its value in
    [0, p)."""
    c = _c(x)
    v = _exact(_reduce(x) + c["kp"])  # in [0, 2^414)
    top = v[..., 15].double() * 2.0**W + v[..., 14].double() + v[..., 13].double() / 2.0**W
    q = torch.floor(top / (P / 2.0**364) - 2.0**-10).clamp(min=0).to(torch.int64)  # q or q - 1
    r = _exact(v - (q & MASK).unsqueeze(-1) * c["p"] - (q >> W).unsqueeze(-1) * c["p26"])
    d = _exact(r - c["p"])
    return torch.where((d[..., 15] < 0).unsqueeze(-1), r, d)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (canon(x) == 0).all(-1)


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (..., 48) uint8 big-endian canonical bytes."""
    c = _c(x)
    v = canon(x)
    lo = v[..., c["l2b_idx"][:, 0]] >> c["l2b_shift"][:, 0]
    hi = (v[..., c["l2b_idx"][:, 1]] << c["l2b_shift"][:, 1]) * (c["l2b_idx"][:, 1] != c["l2b_idx"][:, 0])
    return ((lo | hi) & 0xFF).to(torch.uint8).flip(-1)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 48) uint8 big-endian -> (..., 16) limbs."""
    c = _c(b)
    le = b.flip(-1).to(torch.int64)
    parts = le[..., c["b2l_idx"]]  # (..., 16, 5)
    sh = c["b2l_shift"]
    shifted = torch.where(sh >= 0, parts << sh.clamp(min=0, max=63), parts >> (-sh).clamp(min=0, max=63))
    shifted = torch.where(sh >= 64, torch.zeros_like(shifted), shifted)
    return shifted.sum(-1) & MASK


def _pow(a: torch.Tensor, e: int, mul) -> torch.Tensor:
    """a^e, LSB first, the square and the multiply of a bit stacked into
    one call of `mul` over (2, ...)."""
    out, base = None, a
    while e:
        if e & 1:
            if out is None:
                out = base
                base = mul(base, base)
            else:
                r = mul(torch.stack([out, base]), torch.stack([base, base]))
                out, base = r[0], r[1]
        else:
            base = mul(base, base)
        e >>= 1
    return out


def fp_pow(a, e: int):
    """a^e for e >= 1."""
    return _pow(a, e, fmul)


def fp_inv(a):
    """1/a by Fermat; 0 -> 0."""
    return fp_pow(a, P - 2)


def fp_is_square(a):
    """Euler's criterion; 0 counts as a square."""
    l = canon(fp_pow(a, (P - 1) // 2))
    return (l == _c(a)["one"]).all(-1) | is_zero(a)


def fp_sqrt_cand(a):
    return fp_pow(a, (P + 1) // 4)


# -- Fp2: (..., 2, 16) --------------------------------------------------------------


def f2_mul(a, b):
    """Karatsuba, the three products in one call, each output carried
    and folded once."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    cols = _cols(torch.stack([a0, a1, a0 + a1]), torch.stack([b0, b1, b0 + b1]))
    return _reduce(torch.stack([cols[0] - cols[1], cols[2] - cols[0] - cols[1]], dim=-2))


def f2_sqr(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    cols = _cols(torch.stack([a0 + a1, a0]), torch.stack([a0 - a1, a1]))
    return _reduce(torch.stack([cols[0], 2 * cols[1]], dim=-2))


def f2_mul_fp(a, s):
    """a (..., 2, 16) times s (..., 16) in Fp."""
    return fmul(a, s.unsqueeze(-2))


def f2_conj(a):
    return torch.stack([a[..., 0, :], -a[..., 1, :]], dim=-2)


def f2_mul_xi(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([a0 - a1, a0 + a1], dim=-2)


def f2_norm(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    cols = _cols(torch.stack([a0, a1]), torch.stack([a0, a1]))
    return _reduce(cols[0] + cols[1])


def f2_inv(a):
    ni = fp_inv(f2_norm(a))
    return f2_mul_fp(f2_conj(a), ni)


def f2_is_zero(a):
    return is_zero(a).all(-1)


def f2_is_square(a):
    return fp_is_square(f2_norm(a))


def f2_sqrt(a):
    """The oracle's root choice (ref_bls12.f2_sqrt), branch-free over
    rows; for a non-square the output is unspecified."""
    c = _c(a)
    c0, c1 = a[..., 0, :], a[..., 1, :]
    zero = torch.zeros_like(c0)
    # c1 == 0: sqrt(c0), or sqrt(-c0) u
    s = fp_sqrt_cand(torch.stack([c0, -c0]))
    fp_ok = is_zero(fmul(s[0], s[0]) - c0)
    pure = torch.where(fp_ok[..., None, None], torch.stack([s[0], zero], -2), torch.stack([zero, s[1]], -2))
    # general: with s = sqrt(norm), x0 = sqrt((c0 +- s) / 2), x1 = c1 / (2 x0)
    sn = fp_sqrt_cand(f2_norm(a))
    deltas = fmul(torch.stack([c0 + sn, c0 - sn]), c["inv2"])
    x0s = fp_sqrt_cand(deltas)
    ok1 = is_zero(fmul(x0s[0], x0s[0]) - deltas[0])
    x0 = torch.where(ok1.unsqueeze(-1), x0s[0], x0s[1])
    x1 = fmul(c1, fp_inv(x0 + x0))
    gen = torch.stack([x0, x1], dim=-2)
    return torch.where(is_zero(c1)[..., None, None], pure, gen)


def f2_sgn0(a):
    v = canon(a)
    c0, c1 = v[..., 0, :], v[..., 1, :]
    return torch.where((c0 == 0).all(-1), c1[..., 0] & 1, c0[..., 0] & 1)


def f2_one_like(a):
    one = torch.zeros_like(a)
    one[..., 0, 0] = 1
    return one


# -- Fp6 (..., 3, 2, 16) and Fp12 (..., 2, 3, 2, 16) ---------------------------------


def f6_mul(a, b):
    """Schoolbook with v^3 = xi; the nine Fp2 products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    pr = f2_mul(torch.stack([a0, a0, a1, a0, a1, a2, a1, a2, a2]), torch.stack([b0, b1, b0, b2, b1, b0, b2, b1, b2]))
    t01 = pr[1] + pr[2]
    t02 = pr[3] + pr[4] + pr[5]
    t03 = pr[6] + pr[7]
    return _reduce(torch.stack([pr[0] + f2_mul_xi(t03), t01 + f2_mul_xi(pr[8]), t02], dim=-3))


def f6_mul_by_v(a):
    return torch.stack([f2_mul_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], dim=-3)


def f6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    pr = f2_mul(torch.stack([a0, a1, a2, a1, a0, a0]), torch.stack([a0, a2, a2, a1, a1, a2]))
    sq0, m12, sq2, sq1, m01, m02 = pr.unbind(0)
    c0 = sq0 - f2_mul_xi(m12)
    c1 = f2_mul_xi(sq2) - m01
    c2 = sq1 - m02
    pr2 = f2_mul(torch.stack([a2, a1, a0]), torch.stack([c1, c2, c0]))
    t = _reduce(f2_mul_xi(pr2[0] + pr2[1]) + pr2[2])
    out = f2_mul(torch.stack([c0, c1, c2]), f2_inv(t))
    return torch.stack(out.unbind(0), dim=-3)


def f12_mul(a, b):
    """Karatsuba over Fp6 (w^2 = v); the three Fp6 products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = a[..., 0, :, :, :], a[..., 1, :, :, :], b[..., 0, :, :, :], b[..., 1, :, :, :]
    t0, t1, t2 = f6_mul(torch.stack([a0, a1, a0 + a1]), torch.stack([b0, b1, b0 + b1])).unbind(0)
    return _reduce(torch.stack([t0 + f6_mul_by_v(t1), t2 - t0 - t1], dim=-4))


def f12_conj(a):
    return torch.stack([a[..., 0, :, :, :], -a[..., 1, :, :, :]], dim=-4)


def f12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    sq = f6_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    t = f6_inv(_reduce(sq[0] - f6_mul_by_v(sq[1])))
    m = f6_mul(torch.stack([a0, a1]), t)
    return torch.stack([m[0], -m[1]], dim=-4)


def f12_frobenius(a):
    """a^p: each Fp2 coefficient conjugated, times the structure
    constants, the six products in one call."""
    c = _c(a)
    coeffs = torch.cat([f2_conj(a[..., 0, :, :, :]), f2_conj(a[..., 1, :, :, :])], dim=-3)  # (..., 6, 2, 16)
    out = f2_mul(coeffs, c["frob"])
    return out.unflatten(-3, (2, 3))


def f12_one(shape, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (2, 3, 2, NLIMB), dtype=torch.int64, device=device)
    out[..., 0, 0, 0, 0] = 1
    return out


def f12_pow(a, e: int):
    return _pow(a, e, f12_mul)


def f12_is_one(a):
    v = canon(a)
    one = torch.zeros_like(v)
    one[..., 0, 0, 0, 0] = 1
    return (v == one).flatten(-4).all(-1)


# -- curve points: complete addition (RCB15 algorithm 7, a = 0) --------------------


def _complete_add(mul, mul_b3, p1, p2):
    """(X1 : Y1 : Z1) + (X2 : Y2 : Z2) on y^2 z = x^3 + b z^3; `mul`
    multiplies stacks of field elements, `mul_b3` multiplies by 3b with
    additions (as the kernel does). The outputs are differences and sums
    of two products (within the bounds the next addition's products take)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0, t1, t2, m3, m4, my = mul(torch.stack([X1, Y1, Z1, X1 + Y1, Y1 + Z1, X1 + Z1]),
                                 torch.stack([X2, Y2, Z2, X2 + Y2, Y2 + Z2, X2 + Z2])).unbind(0)
    t3 = m3 - t0 - t1   # X1 Y2 + X2 Y1
    t4 = m4 - t1 - t2   # Y1 Z2 + Y2 Z1
    ty = my - t0 - t2   # X1 Z2 + X2 Z1
    t0 = 3 * t0
    t2b, y3b = _reduce(mul_b3(torch.stack([t2, ty]))).unbind(0)
    z3s = t1 + t2b
    t1s = t1 - t2b
    pa, pb, pc, pd, pe, pf = mul(torch.stack([t3, t4, t1s, y3b, z3s, t0]),
                                 torch.stack([t1s, y3b, z3s, t0, t4, t3])).unbind(0)
    return pa - pb, pc + pd, pe + pf


def g1_add(p1, p2):
    return _complete_add(fmul, lambda t: 12 * t, p1, p2)


def g2_add(p1, p2):
    return _complete_add(f2_mul, lambda t: 12 * f2_mul_xi(t), p1, p2)


# -- the plain versions ------------------------------------------------------------


def _plain(fn):
    """Run a plain version in inference mode (its tens of thousands of
    small torch calls skip the autograd bookkeeping: about twice as
    fast on a CPU) and hand back ordinary tensors."""
    @functools.wraps(fn)
    def run(*args):
        with torch.inference_mode():
            out = fn(*args)
        return tuple(t.clone() for t in out)

    return run


@_plain
def aggregate_plain(points: torch.Tensor, mask: torch.Tensor):
    """points (V, 2, 48) uint8, mask (B, V) bool -> (B, 2, 48), (B,)."""
    b, v = mask.shape
    xy = from_bytes(points)  # (V, 2, 16)
    m = mask.unsqueeze(-1)
    one = torch.zeros_like(xy[:, 0]).expand(b, v, NLIMB).clone()
    one[..., 0] = 1
    X = torch.where(m, xy[:, 0], torch.zeros_like(one))
    Y = torch.where(m, xy[:, 1], one)
    Z = torch.where(m, one, torch.zeros_like(one))
    z1 = torch.zeros((b, 1, NLIMB), dtype=torch.int64, device=points.device)
    o1 = z1.clone()
    o1[..., 0] = 1
    ident = (z1, o1, z1)
    while X.shape[1] > 1:
        if X.shape[1] % 2:
            X, Y, Z = (torch.cat([c, i], dim=1) for c, i in zip((X, Y, Z), ident))
        h = X.shape[1] // 2
        X, Y, Z = g1_add((X[:, :h], Y[:, :h], Z[:, :h]), (X[:, h:], Y[:, h:], Z[:, h:]))
    if X.shape[1] == 0:
        X, Y, Z = ident
    zi = fp_inv(Z[:, 0])
    xy = fmul(torch.stack([X[:, 0], Y[:, 0]], dim=1), zi.unsqueeze(1))
    return to_bytes(xy), is_zero(Z[:, 0])


def _g2_curve_g(x):
    return f2_mul(f2_sqr(x), x) + _c(x)["b2"]


def svdw_plain(u):
    """(..., 2, 16) -> affine (x, y) on E'(Fp2), ref_bls12.map_to_curve_svdw
    branch-free over rows."""
    c = _c(u)
    one = f2_one_like(u)
    tv1 = f2_mul(f2_sqr(u), c["c1"])
    tv2 = one + tv1
    tv1 = one - tv1
    tv3 = f2_inv(f2_mul(tv1, tv2))
    tv5 = f2_mul(f2_mul(f2_mul(u, tv1), tv3), c["c3"])
    x1 = c["c2"] - tv5
    x2 = c["c2"] + tv5
    x3 = c["z"] + f2_mul(c["c4"], f2_sqr(f2_mul(f2_sqr(tv2), tv3)))
    g12 = _g2_curve_g(torch.stack([x1, x2]))
    sq = f2_is_square(g12)
    x = torch.where(sq[0][..., None, None], x1, torch.where(sq[1][..., None, None], x2, x3))
    y = f2_sqrt(_g2_curve_g(x))
    flip = f2_sgn0(u) != f2_sgn0(y)
    return x, torch.where(flip[..., None, None], -y, y)


@_plain
def map_plain(u0: torch.Tensor, u1: torch.Tensor):
    """(N, 2, 48) x2 -> (N, 2, 2, 48), (N,): the two maps stacked, their
    sum, [H2] MSB first by complete additions, normalised."""
    u = from_bytes(torch.stack([u0, u1]))
    x, y = svdw_plain(u)
    one = f2_one_like(x[0])
    q = g2_add((x[0], y[0], one), (x[1], y[1], one))
    acc = (torch.zeros_like(one), one, torch.zeros_like(one))
    for bit in bin(ref.H2)[2:]:
        acc = g2_add(acc, acc)
        if bit == "1":
            acc = g2_add(acc, q)
    X, Y, Z = acc
    xy = f2_mul(torch.stack([X, Y], dim=1), f2_inv(Z).unsqueeze(1))
    return to_bytes(xy), f2_is_zero(Z)


def _line(s00, s11, s12):
    z = torch.zeros_like(s00)
    return torch.stack([torch.stack([s00, z, z], dim=-3), torch.stack([z, s11, s12], dim=-3)], dim=-4)


def miller_plain(qx, qy, px, py):
    """f_{|x|,Q}(P) with the JAX package's scaled lines (ops/bls12.py
    miller_rows): Q affine on E' (..., 2, 16), P affine in G1 (..., 16)."""
    one = f2_one_like(qx)
    X, Y, Z = qx, qy, one
    f = f12_one(px.shape[:-1], px.device)
    for bit in bin(-ref.X_PARAM)[3:]:
        xsq, ysq, zsq = f2_sqr(torch.stack([X, Y, Z])).unbind(0)
        m0, m1, m2, m3 = f2_mul(torch.stack([Y, xsq, ysq, xsq]), torch.stack([zsq, X, Z, Z])).unbind(0)
        s11 = _reduce(3 * m1 - 2 * m2)
        s00, s12 = fmul(torch.stack([f2_mul_xi(2 * m0), -3 * m3]), torch.stack([py, px]).unsqueeze(-2)).unbind(0)
        f = f12_mul(f12_mul(f, f), _line(s00, s11, s12))
        X, Y, Z = g2_add((X, Y, Z), (X, Y, Z))
        if bit == "1":
            qz = f2_mul(torch.stack([qx, qy]), torch.stack([Z, Z]))
            dx, dy = X - qz[0], Y - qz[1]
            dm = f2_mul(torch.stack([dy, dx]), torch.stack([qx, qy]))
            s11 = dm[0] - dm[1]
            s00, s12 = fmul(torch.stack([f2_mul_xi(dx), -dy]), torch.stack([py, px]).unsqueeze(-2)).unbind(0)
            f = f12_mul(f, _line(s00, s11, s12))
            X, Y, Z = g2_add((X, Y, Z), (qx, qy, one))
    return f


def final_exp_plain(f):
    """f^(3 (p^12 - 1) / r) (ops/bls12.py final_exponentiation)."""
    ax, axm1 = -ref.X_PARAM, -(ref.X_PARAM - 1)
    t = f12_mul(f12_conj(f), f12_inv(f))
    m = f12_mul(f12_frobenius(f12_frobenius(t)), t)
    t0 = f12_conj(f12_pow(m, axm1))
    t0 = f12_conj(f12_pow(t0, axm1))
    t1 = f12_mul(f12_conj(f12_pow(t0, ax)), f12_frobenius(t0))
    t2 = f12_conj(f12_pow(f12_conj(f12_pow(t1, ax)), ax))
    t2 = f12_mul(t2, f12_frobenius(f12_frobenius(t1)))
    t2 = f12_mul(t2, f12_conj(t1))
    return f12_mul(t2, f12_mul(f12_mul(m, m), m))


@_plain
def pairing_plain(pk: torch.Tensor, hm: torch.Tensor, sig=None):
    """pk (N, 2, 48), hm and sig (N, 2, 2, 48) -> (ok (N,), value (N, 2,
    3, 2, 48)); without sig, e(pk, hm) alone. The two Miller loops of a
    row are stacked into one."""
    c = _c(pk)
    p = from_bytes(pk)
    q = from_bytes(hm)
    if sig is not None:
        ng = c["neg_g1"].expand_as(p)
        p = torch.stack([p, ng])
        q = torch.stack([q, from_bytes(sig)])
    f = miller_plain(q[..., 0, :, :], q[..., 1, :, :], p[..., 0, :], p[..., 1, :])
    if sig is not None:
        f = f12_mul(f[0], f[1])
    v = final_exp_plain(f)
    return f12_is_one(v), to_bytes(v)


# -- the wrappers ----------------------------------------------------------------------


def g1_aggregate(points: torch.Tensor, mask: torch.Tensor):
    """points (V, 2, 48) uint8 affine G1 (x, y), mask (B, V) bool ->
    (B, 2, 48) uint8 affine sums and (B,) bool identity flags (an empty
    selection, or points that cancel; the sum's coordinates are then 0)."""
    dev = points.device
    _check(points, "points", (None, 2, FP_BYTES), torch.uint8, dev)
    v = points.shape[0]
    _check(mask, "mask", (None, v), torch.bool, dev)
    b = mask.shape[0]
    if not _route(dev):
        return aggregate_plain(points, mask)
    out = torch.empty((b, 2, FP_BYTES), dtype=torch.uint8, device=dev)
    inf = torch.empty((b,), dtype=torch.bool, device=dev)
    if b:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        # the blocks' partial sums and a counter a row, for this call only
        scratch = torch.empty(lib.tm_bls12_g1_aggregate_scratch(b, v), dtype=torch.uint8, device=dev)
        check(lib, lib.tm_bls12_g1_aggregate(points.data_ptr(), mask.data_ptr(), b, v, scratch.data_ptr(),
                                             out.data_ptr(), inf.data_ptr(), _stream(dev)), "bls12_g1_aggregate launch")
        g1_aggregate.launches += 1
    return out, inf


def lanes(device=None) -> dict:
    """The lanes G that work one row of the pairing and of the map kernel
    and one addition of the aggregate, and the aggregate's points a block
    ("bls12_g1_aggregate_chunk"), as compiled into the library (loads it
    on `device`, default cuda)."""
    import ctypes

    dev = torch.device("cuda" if device is None else device)
    lib = _lib(dev)
    pairing, mapped, agg, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.tm_bls12_lanes(ctypes.byref(pairing), ctypes.byref(mapped), ctypes.byref(agg), ctypes.byref(chunk))
    return {"bls12_pairing_check": pairing.value, "bls12_map_to_g2": mapped.value, "bls12_g1_aggregate": agg.value,
            "bls12_g1_aggregate_chunk": chunk.value}


def map_to_g2(u0: torch.Tensor, u1: torch.Tensor):
    """u0, u1 (N, 2, 48) uint8 Fp2 elements -> (N, 2, 2, 48) uint8 affine
    G2 (x, y) of clear_cofactor_g2(map(u0) + map(u1)) and (N,) bool
    identity flags."""
    dev = u0.device
    _check(u0, "u0", (None, 2, FP_BYTES), torch.uint8, dev)
    n = u0.shape[0]
    _check(u1, "u1", (n, 2, FP_BYTES), torch.uint8, dev)
    if not _route(dev):
        return map_plain(u0, u1)
    q = torch.empty((n, 2, 2, FP_BYTES), dtype=torch.uint8, device=dev)
    inf = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_bls12_map_to_g2(u0.data_ptr(), u1.data_ptr(), n, q.data_ptr(), inf.data_ptr(),
                                          _stream(dev)), "bls12_map_to_g2 launch")
        map_to_g2.launches += 1
    return q, inf


def _pairing(pk: torch.Tensor, hm: torch.Tensor, sig):
    """The pairing kernel's wrapper: with sig, the check of each row;
    without, e(pk, hm) alone."""
    dev = pk.device
    _check(pk, "pk", (None, 2, FP_BYTES), torch.uint8, dev)
    n = pk.shape[0]
    _check(hm, "hm", (n, 2, 2, FP_BYTES), torch.uint8, dev)
    if sig is not None:
        _check(sig, "sig", (n, 2, 2, FP_BYTES), torch.uint8, dev)
    if not _route(dev):
        return pairing_plain(pk, hm, sig)
    value = torch.empty((n, 2, 3, 2, FP_BYTES), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_bls12_pairing_check(pk.data_ptr(), hm.data_ptr(), 0 if sig is None else sig.data_ptr(),
                                              n, 1 if sig is None else 2, value.data_ptr(), ok.data_ptr(),
                                              _stream(dev)), "bls12_pairing_check launch")
        _pairing.launches += 1
    return ok, value


def pairing_check_rows(pk: torch.Tensor, hm: torch.Tensor, sig: torch.Tensor):
    """Per row e(pk, hm) e(-G1, sig) == 1: pk (N, 2, 48) G1, hm and sig
    (N, 2, 2, 48) G2, affine, valid curve points -> (ok (N,) bool, the
    reduced Fp12 value (N, 2, 3, 2, 48) uint8)."""
    return _pairing(pk, hm, sig)


def pairing_value(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The reduced pairing e(p, q) per row, (N, 2, 3, 2, 48): the
    oracle's pairing cubed."""
    return _pairing(p, q, None)[1]


KERNELS = {
    "bls12_pairing_check": _pairing,
    "bls12_map_to_g2": map_to_g2,
    "bls12_g1_aggregate": g1_aggregate,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# -- the kernels' constants ------------------------------------------------------------


def constants_blob() -> bytes:
    """csrc/fp381.cuh's Constants struct, packed from the oracle:
    Montgomery form with R = 2^384 where the struct says so."""
    import struct

    r = 1 << 384

    def words(x: int, n: int = 12) -> List[int]:
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]

    def mont(x: int) -> List[int]:
        return words(x % P * r % P)

    def mont2(v) -> List[int]:
        return mont(v[0]) + mont(v[1])

    out = words(P) + [(-pow(P, -1, 1 << 32)) % (1 << 32), 0, 0, 0]
    out += words(r * r % P) + mont(1) + words(P - 2) + words((P + 1) // 4) + words((P - 1) // 2)
    out += mont(pow(2, P - 2, P))
    out += mont2(ref.B2)
    for v in ref._FROB_V:
        out += mont2(v)
    for v in ref._FROB_V:
        out += mont2(ref.f2_mul(v, ref._FROB_W))
    for v in (ref.Z_SVDW, ref._C1, ref._C2, ref._C3, ref._C4):
        out += mont2(v)
    out += mont(ref.G1_GEN[0]) + mont(-ref.G1_GEN[1] % P)
    out += words(ref.H2, 16) + [ref.H2.bit_length(), 0, 0, 0]
    return struct.pack(f"<{len(out)}I", *out)
