"""Pure-Python BLS12-381 reference implementation (hashlib only).

The port's own copy of the JAX package's ``ops/ref_bls12.py`` (the port
imports nothing of that package): the oracle the plain PyTorch versions
and the CUDA kernels of ``ops/bls12.py`` are held against, and the host
side of the BLS provider (``crypto/bls.py``): keygen and signing, point
compression, subgroup checks, ``expand_message_xmd`` and
``hash_to_field_fp2``, and the constants the kernels are given (SvdW's Z
and C1-C4, the cofactor H2, the Frobenius constants).

Every derived parameter is COMPUTED from the BLS12 polynomial family at
import and asserted against the published constants, so a typo in any
hex literal fails the import instead of producing an almost-right
curve:

    r = x^4 - x^2 + 1                    (the G1/G2 subgroup order)
    p = (x-1)^2 * r / 3 + x              (the base field prime)
    h1 = (x-1)^2 / 3                     (G1 cofactor)
    h2 = (x^8-4x^7+5x^6-4x^4+6x^3-4x^2-4x+13)/9   (G2 cofactor)

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (1+u)),
Fp12 = Fp6[w]/(w^2 - v).  G1: y^2 = x^3 + 4 over Fp.  G2: y^2 = x^3 +
4(1+u) over Fp2 (the M-twist).  Elements are plain ints / nested
tuples.

Scheme: min-pk BLS signatures (pubkeys in G1, 48-byte compressed;
signatures in G2, 96-byte compressed), with proof-of-possession
registration against rogue-key attacks.

Hash-to-curve follows RFC 9380's expand_message_xmd / hash_to_field
exactly and maps to the curve with the section 6.6.1
Shallue-van de Woestijne map rather than the SSWU+3-isogeny
ciphersuite; the map is deterministic and uniform but NOT
wire-compatible with BLS12381G2_XMD:SHA-256_SSWU_RO_. Domain separation
tags are repo-scoped for the same reason.

Pairing: ate pairing via an affine Miller loop over |x| with
denominator elimination, final exponentiation by the full (p^12-1)/r
power -- correct by definition, and the yardstick the kernels'
structured easy/hard decomposition is held against.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

# -- parameters (derived, then pinned) --------------------------------------

X_PARAM = -0xD201000000010000  # the BLS12 family parameter (negative, even)

R = X_PARAM**4 - X_PARAM**2 + 1
P = ((X_PARAM - 1) ** 2 * R) // 3 + X_PARAM
H1 = (X_PARAM - 1) ** 2 // 3
H2 = (
    X_PARAM**8 - 4 * X_PARAM**7 + 5 * X_PARAM**6 - 4 * X_PARAM**4
    + 6 * X_PARAM**3 - 4 * X_PARAM**2 - 4 * X_PARAM + 13
) // 9

assert P == int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16
), "derived p does not match the published BLS12-381 prime"
assert R == int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16
), "derived r does not match the published subgroup order"
assert P % 4 == 3  # sqrt in Fp is a single (p+1)/4 power

# Final-exponentiation decomposition used by the kernels
# (ops/bls12.py): 3*(p^4-p^2+1)/r == (x-1)^2 (x+p) (x^2+p^2-1) + 3.
# Pinned here so the chain can never drift from the field it serves.
FINAL_EXP_HARD = (P**4 - P**2 + 1) // R
assert (
    3 * FINAL_EXP_HARD
    == (X_PARAM - 1) ** 2 * (X_PARAM + P) * (X_PARAM**2 + P**2 - 1) + 3
)

# -- Fp2 = Fp[u]/(u^2 + 1) --------------------------------------------------
#
# Elements are (c0, c1) int tuples meaning c0 + c1*u.

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # the Fp6 non-residue v^3 = 1 + u


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    # (c0+c1 u)^2 = (c0+c1)(c0-c1) + 2 c0 c1 u
    t = a[0] * a[1] % P
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def f2_muls(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    """1/a via the norm: a^-1 = conj(a) / (c0^2 + c1^2); (0,0) -> (0,0)
    (the inv0 convention RFC 9380's maps rely on)."""
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    if norm == 0:
        return F2_ZERO
    ni = pow(norm, P - 2, P)
    return (a[0] * ni % P, (-a[1]) * ni % P)


def f2_eq(a, b):
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def f2_is_zero(a):
    return a[0] % P == 0 and a[1] % P == 0


def f2_is_square(a) -> bool:
    """a is a QR in Fp2 iff its norm is a QR in Fp (norm map is
    surjective onto Fp* with square-compatible fibers)."""
    if f2_is_zero(a):
        return True
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return pow(norm, (P - 1) // 2, P) == 1


def fp_sqrt(a: int) -> Optional[int]:
    """sqrt in Fp (p = 3 mod 4): a^((p+1)/4), or None if a is not a QR."""
    a %= P
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def f2_sqrt(a) -> Optional[Tuple[int, int]]:
    """sqrt in Fp2 via the norm trick (p = 3 mod 4): with s = sqrt(norm),
    one of (c0 +- s)/2 is a QR delta; sqrt = sqrt(delta) + c1/(2 sqrt(delta)) u.
    Returns None when a is not a square."""
    c0, c1 = a[0] % P, a[1] % P
    if c1 == 0:
        s = fp_sqrt(c0)
        if s is not None:
            return (s, 0)
        s = fp_sqrt((-c0) % P)
        if s is None:
            return None
        return (0, s)  # (s*u)^2 = -s^2 = c0
    s = fp_sqrt((c0 * c0 + c1 * c1) % P)
    if s is None:
        return None
    inv2 = pow(2, P - 2, P)
    delta = (c0 + s) * inv2 % P
    x0 = fp_sqrt(delta)
    if x0 is None:
        delta = (c0 - s) * inv2 % P
        x0 = fp_sqrt(delta)
        if x0 is None:
            return None
    x1 = c1 * pow(2 * x0 % P, P - 2, P) % P
    out = (x0, x1)
    return out if f2_eq(f2_sqr(out), (c0, c1)) else None


def f2_sgn0(a) -> int:
    """RFC 9380 sgn0 for m=2: parity of c0, or of c1 when c0 == 0."""
    c0, c1 = a[0] % P, a[1] % P
    sign_0 = c0 % 2
    zero_0 = c0 == 0
    return sign_0 | (zero_0 and c1 % 2)


# -- Fp6 = Fp2[v]/(v^3 - xi) ------------------------------------------------
#
# Elements are 3-tuples of Fp2: (c0, c1, c2) = c0 + c1 v + c2 v^2.

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    """Schoolbook with v^3 = xi, v^4 = xi v folding."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    t00 = f2_mul(a0, b0)
    t01 = f2_add(f2_mul(a0, b1), f2_mul(a1, b0))
    t02 = f2_add(f2_add(f2_mul(a0, b2), f2_mul(a1, b1)), f2_mul(a2, b0))
    t03 = f2_add(f2_mul(a1, b2), f2_mul(a2, b1))
    t04 = f2_mul(a2, b2)
    return (
        f2_add(t00, f2_mul(XI, t03)),
        f2_add(t01, f2_mul(XI, t04)),
        t02,
    )


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_by_v(a):
    """a * v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_inv(a):
    """Standard Fp6 inversion (Itoh-Tsujii over the cubic extension)."""
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0)
    )
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


def f6_is_zero(a):
    return all(f2_is_zero(c) for c in a)


# -- Fp12 = Fp6[w]/(w^2 - v) ------------------------------------------------
#
# Elements are pairs of Fp6: (c0, c1) = c0 + c1 w.

F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c1 = f6_sub(
        f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), f6_add(t0, t1)
    )
    return (f6_add(t0, f6_mul_by_v(t1)), c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """Conjugation over Fp6 (= inverse on the cyclotomic subgroup)."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    t = f6_inv(f6_sub(f6_sqr(a[0]), f6_mul_by_v(f6_sqr(a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_pow(a, e: int):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sqr(a)
        e >>= 1
    return out


def f12_eq(a, b):
    return a == b or _f12_canon(a) == _f12_canon(b)


def _f12_canon(a):
    return tuple(
        tuple((c[0] % P, c[1] % P) for c in c6) for c6 in a
    )


def f12_is_one(a):
    return f12_eq(a, F12_ONE)


# -- curve points -----------------------------------------------------------
#
# Affine points as (x, y) tuples over the respective field; None is the
# point at infinity. b = 4 on G1, 4*(1+u) on G2.

B1 = 4
B2 = f2_muls(XI, 4)

G1_GEN = (
    int(
        "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
        "6c55e83ff97a1aeffb3af00adb22c6bb", 16
    ),
    int(
        "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
        "d03cc744a2888ae40caa232946c5e7e1", 16
    ),
)
G2_GEN = (
    (
        int(
            "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
            "0bac0326a805bbefd48056c8c121bdb8", 16
        ),
        int(
            "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
            "334cf11213945d57e5ac7d055d042b7e", 16
        ),
    ),
    (
        int(
            "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
            "923ac9cc3baca289e193548608b82801", 16
        ),
        int(
            "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
            "3f370d275cec1da1aaa9075ff05f79be", 16
        ),
    ),
)


class _FpOps:
    """Field namespace for the generic Weierstrass point arithmetic."""

    zero = 0
    one = 1
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    neg = staticmethod(lambda a: (-a) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sqr = staticmethod(lambda a: a * a % P)
    muls = staticmethod(lambda a, k: a * k % P)
    inv = staticmethod(lambda a: pow(a, P - 2, P))
    eq = staticmethod(lambda a, b: a % P == b % P)
    is_zero = staticmethod(lambda a: a % P == 0)


class _Fp2Ops:
    zero = F2_ZERO
    one = F2_ONE
    add = staticmethod(f2_add)
    sub = staticmethod(f2_sub)
    neg = staticmethod(f2_neg)
    mul = staticmethod(f2_mul)
    sqr = staticmethod(f2_sqr)
    muls = staticmethod(f2_muls)
    inv = staticmethod(f2_inv)
    eq = staticmethod(f2_eq)
    is_zero = staticmethod(f2_is_zero)


def _pt_add(F, b, pt, q):
    """Affine addition on y^2 = x^3 + b over field namespace F."""
    if pt is None:
        return q
    if q is None:
        return pt
    x1, y1 = pt
    x2, y2 = q
    if F.eq(x1, x2):
        if F.eq(y1, y2) and not F.is_zero(y1):
            return _pt_double(F, b, pt)
        return None  # P + (-P)
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    return (x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1))


def _pt_double(F, b, pt):
    if pt is None:
        return None
    x1, y1 = pt
    if F.is_zero(y1):
        return None
    lam = F.mul(F.muls(F.sqr(x1), 3), F.inv(F.muls(y1, 2)))
    x3 = F.sub(F.sqr(lam), F.muls(x1, 2))
    return (x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1))


def _pt_neg(F, pt):
    if pt is None:
        return None
    return (pt[0], F.neg(pt[1]))


def _pt_mul(F, b, k: int, pt):
    """Scalar multiplication via Jacobian double-and-add: one field
    inversion TOTAL (at the final affine conversion) instead of one per
    bit — the difference between ~1 s and ~20 ms per G2 cofactor clear
    on this oracle. Affine in, affine out; result identical to the
    affine ladder (pinned by the differential tests)."""
    if k < 0:
        return _pt_mul(F, b, -k, _pt_neg(F, pt))
    if k == 0 or pt is None:
        return None
    # Jacobian (X, Y, Z): x = X/Z^2, y = Y/Z^3; Z == zero is infinity.
    ax, ay = pt
    acc = None  # jacobian accumulator
    run = (ax, ay, F.one)
    while k:
        if k & 1:
            acc = _jac_add(F, acc, run)
        k >>= 1
        if k:
            run = _jac_double(F, run)
    if acc is None or F.is_zero(acc[2]):
        return None
    zi = F.inv(acc[2])
    zi2 = F.sqr(zi)
    return (F.mul(acc[0], zi2), F.mul(acc[1], F.mul(zi2, zi)))


def _jac_double(F, pt):
    """dbl-2009-l (a = 0)."""
    X1, Y1, Z1 = pt
    if F.is_zero(Z1) or F.is_zero(Y1):
        return (F.one, F.one, F.zero)
    A = F.sqr(X1)
    Bv = F.sqr(Y1)
    C = F.sqr(Bv)
    D = F.muls(F.sub(F.sub(F.sqr(F.add(X1, Bv)), A), C), 2)
    E = F.muls(A, 3)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.muls(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.muls(C, 8))
    Z3 = F.muls(F.mul(Y1, Z1), 2)
    return (X3, Y3, Z3)


def _jac_add(F, pt, q):
    """General Jacobian addition (handles identity and doubling)."""
    if pt is None or F.is_zero(pt[2]):
        return q
    if q is None or F.is_zero(q[2]):
        return pt
    X1, Y1, Z1 = pt
    X2, Y2, Z2 = q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    rr = F.sub(S2, S1)
    if F.is_zero(H):
        if F.is_zero(rr):
            return _jac_double(F, pt)
        return (F.one, F.one, F.zero)  # P + (-P)
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(rr), HHH), F.muls(V, 2))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(H, F.mul(Z1, Z2))
    return (X3, Y3, Z3)


def _pt_on_curve(F, b, pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return F.eq(F.sqr(y), F.add(F.mul(F.sqr(x), x), b))


# G1 wrappers
def g1_add(p1, p2):
    return _pt_add(_FpOps, B1, p1, p2)


def g1_double(p1):
    return _pt_double(_FpOps, B1, p1)


def g1_neg(p1):
    return _pt_neg(_FpOps, p1)


def g1_mul(k: int, p1):
    return _pt_mul(_FpOps, B1, k, p1)


def g1_on_curve(p1) -> bool:
    return _pt_on_curve(_FpOps, B1, p1)


def g1_in_subgroup(p1) -> bool:
    return g1_on_curve(p1) and g1_mul(R, p1) is None


# G2 wrappers
def g2_add(p1, p2):
    return _pt_add(_Fp2Ops, B2, p1, p2)


def g2_double(p1):
    return _pt_double(_Fp2Ops, B2, p1)


def g2_neg(p1):
    return _pt_neg(_Fp2Ops, p1)


def g2_mul(k: int, p1):
    return _pt_mul(_Fp2Ops, B2, k, p1)


def g2_on_curve(p1) -> bool:
    return _pt_on_curve(_Fp2Ops, B2, p1)


def g2_in_subgroup(p1) -> bool:
    return g2_on_curve(p1) and g2_mul(R, p1) is None


# -- point serialization (ZCash-style compressed encoding) -------------------
#
# G1: 48 bytes big-endian x; G2: 96 bytes x.c1 || x.c0. The three top
# bits of byte 0 are flags: bit7 = compressed (always set here), bit6 =
# infinity, bit5 = y is the lexicographically larger root.

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def _y_is_larger_fp(y: int) -> bool:
    return y > P - y


def _y_is_larger_fp2(y) -> bool:
    c0, c1 = y[0] % P, y[1] % P
    n0, n1 = (-c0) % P, (-c1) % P
    return (c1, c0) > (n1, n0)


def g1_compress(pt) -> bytes:
    if pt is None:
        out = bytearray(48)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_larger_fp(y):
        out[0] |= _FLAG_SIGN
    return bytes(out)


def g1_decompress(data: bytes):
    """48 bytes -> affine point / None (infinity). Raises ValueError on a
    malformed encoding (wrong length/flags, x >= p, x not on curve)."""
    if len(data) != 48:
        raise ValueError("G1 point must be 48 bytes")
    flags = data[0] >> 5
    if not flags & 4:
        raise ValueError("uncompressed G1 encoding not supported")
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if flags & 2:
        if x != 0 or flags & 1:
            raise ValueError("malformed G1 infinity encoding")
        return None
    if x >= P:
        raise ValueError("G1 x out of range")
    y = fp_sqrt((x * x % P * x + B1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if _y_is_larger_fp(y) != bool(flags & 1):
        y = (P - y) % P
    return (x, y)


def g2_compress(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_larger_fp2(y):
        out[0] |= _FLAG_SIGN
    return bytes(out)


def g2_decompress(data: bytes):
    """96 bytes -> affine point / None (infinity). Raises ValueError on a
    malformed encoding."""
    if len(data) != 96:
        raise ValueError("G2 point must be 96 bytes")
    flags = data[0] >> 5
    if not flags & 4:
        raise ValueError("uncompressed G2 encoding not supported")
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if flags & 2:
        if x0 != 0 or x1 != 0 or flags & 1:
            raise ValueError("malformed G2 infinity encoding")
        return None
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    if _y_is_larger_fp2(y) != bool(flags & 1):
        y = f2_neg(y)
    return (x, y)


# -- pairing ----------------------------------------------------------------
#
# Untwist E'(Fp2) -> E(Fp12): (x, y) -> (x * xi^-1 v^2, y * xi^-1 v w),
# derived from w^2 = v, v^3 = xi (both sides land on y^2 = x^3 + 4).

_XI_INV = f2_inv(XI)


def _untwist(q):
    x, y = q
    x12 = (
        (F2_ZERO, F2_ZERO, f2_mul(x, _XI_INV)),
        F6_ZERO,
    )
    y12 = (
        F6_ZERO,
        (F2_ZERO, f2_mul(y, _XI_INV), F2_ZERO),
    )
    return (x12, y12)


def _embed_g1(pt):
    x, y = pt
    return (
        ((( x, 0), F2_ZERO, F2_ZERO), F6_ZERO),
        ((( y, 0), F2_ZERO, F2_ZERO), F6_ZERO),
    )


def _f12_line(t, q, at):
    """The (non-vertical) line through t and q -- or the tangent when
    t == q -- evaluated at `at`; all points affine over Fp12. Vertical
    configurations return 1 (denominator elimination: those values lie
    in Fp6, which the final exponentiation kills)."""
    (xt, yt), (xq, yq) = t, q
    xa, ya = at
    if t != q:
        dx = _f12_sub(xq, xt)
        if _f12_iszero(dx):
            return F12_ONE  # vertical
        lam = f12_mul(_f12_sub(yq, yt), f12_inv(dx))
    else:
        if _f12_iszero(yt):
            return F12_ONE  # vertical tangent
        lam = f12_mul(
            _f12_muls(f12_sqr(xt), 3), f12_inv(_f12_muls(yt, 2))
        )
    return _f12_sub(_f12_sub(ya, yt), f12_mul(lam, _f12_sub(xa, xt)))


def _f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def _f12_muls(a, k: int):
    return (
        tuple(f2_muls(c, k) for c in a[0]),
        tuple(f2_muls(c, k) for c in a[1]),
    )


def _f12_iszero(a):
    return f6_is_zero(a[0]) and f6_is_zero(a[1])


def _f12_pt_add(pt, q):
    if pt is None:
        return q
    if q is None:
        return pt
    (x1, y1), (x2, y2) = pt, q
    if _f12_iszero(_f12_sub(x1, x2)):
        if _f12_iszero(_f12_sub(y1, y2)) and not _f12_iszero(y1):
            lam = f12_mul(_f12_muls(f12_sqr(x1), 3), f12_inv(_f12_muls(y1, 2)))
        else:
            return None
    else:
        lam = f12_mul(_f12_sub(y2, y1), f12_inv(_f12_sub(x2, x1)))
    x3 = _f12_sub(_f12_sub(f12_sqr(lam), x1), x2)
    return (x3, _f12_sub(f12_mul(lam, _f12_sub(x1, x3)), y1))


def miller_loop(q, p1):
    """f_{|x|, Q'}(P') with Q' = untwist(q), P' = embed(p1); affine
    double-and-add over the bits of |x| (MSB first)."""
    qq = _untwist(q)
    pp = _embed_g1(p1)
    t = qq
    f = F12_ONE
    bits = bin(-X_PARAM)[3:]  # skip the leading 1
    for bit in bits:
        f = f12_mul(f12_sqr(f), _f12_line(t, t, pp))
        t = _f12_pt_add(t, t)
        if bit == "1":
            f = f12_mul(f, _f12_line(t, qq, pp))
            t = _f12_pt_add(t, qq)
    return f


def f2_pow(a, e: int):
    out = F2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sqr(a)
        e >>= 1
    return out


# Frobenius structure constants: phi(v^j) = v^j * xi^(j(p-1)/3) and
# phi(w) = w * xi^((p-1)/6) (p = 1 mod 6), with phi acting as
# conjugation on Fp2 coefficients. Computed, not transcribed.
_FROB_V = tuple(f2_pow(XI, j * (P - 1) // 3) for j in range(3))
_FROB_W = f2_pow(XI, (P - 1) // 6)


def f12_frobenius(a):
    """a^p via coefficient conjugation + structure constants."""
    c0 = tuple(f2_mul(f2_conj(a[0][j]), _FROB_V[j]) for j in range(3))
    c1 = tuple(
        f2_mul(f2_mul(f2_conj(a[1][j]), _FROB_V[j]), _FROB_W)
        for j in range(3)
    )
    return (c0, c1)


def final_exponentiation(f):
    """f^((p^12-1)/r) -- the by-definition reduced pairing, computed as
    easy part (p^6-1)(p^2+1) via conjugation/Frobenius + hard part
    (p^4-p^2+1)/r by plain square-and-multiply. Exactly the full power
    (the import-time identity pins FINAL_EXP_HARD to p and r), so the
    structured route is value-identical to f12_pow(f, (p^12-1)//r)."""
    t = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    t = f12_mul(f12_frobenius(f12_frobenius(t)), t)  # ^(p^2 + 1)
    return f12_pow(t, FINAL_EXP_HARD)


def pairing(p1, q2):
    """Reduced ate-family pairing e(P, Q), P in G1, Q in G2 (both
    affine, neither infinity). Bilinear and non-degenerate; the Miller
    loop runs over |x| without the negative-x inversion, so values are
    a fixed power of the standard optimal-ate output -- every
    verification identity is unaffected (both sides use the same map).
    """
    return final_exponentiation(miller_loop(q2, p1))


def pairing_product_is_one(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(P_i, Q_i) == 1, sharing ONE final exponentiation across all
    Miller loops (the multi-pairing shape the kernels batch).
    Infinity on either side contributes the neutral factor."""
    f = F12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(q2, p1))
    return f12_is_one(final_exponentiation(f))


# -- RFC 9380 hashing -------------------------------------------------------

_H_OUT = 32  # sha256
_H_BLOCK = 64
_L = 64  # ceil((ceil(log2(p)) + k) / 8) with k = 128


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1, SHA-256 instantiation."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // _H_OUT)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd: requested output too long")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(_H_BLOCK)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [bi]
    for i in range(2, ell + 1):
        bi = hashlib.sha256(
            bytes(x ^ y for x, y in zip(b0, bi)) + bytes([i]) + dst_prime
        ).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int) -> List[Tuple[int, int]]:
    """RFC 9380 section 5.2: count Fp2 elements (m = 2, L = 64)."""
    ex = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = _L * (j + i * 2)
            coords.append(int.from_bytes(ex[off : off + _L], "big") % P)
        out.append((coords[0], coords[1]))
    return out


# -- Shallue-van de Woestijne map to E'(Fp2) (RFC 9380 section 6.6.1) -------


def _g2_g(x):
    """g(x) = x^3 + B2 on the twist."""
    return f2_add(f2_mul(f2_sqr(x), x), B2)


def _find_z_svdw():
    """Appendix H.1 procedure: the first Z (in a fixed small search
    order) such that g(Z) != 0, -(3Z^2)/(4g(Z)) is nonzero and square,
    and at least one of g(Z), g(-Z/2) is square (H.1 criterion 4,
    guaranteeing the map is well-defined for every input)."""
    cands = []
    for a in range(1, 9):
        for cand in ((a, 0), (P - a, 0), (0, a), (0, P - a), (a, a), (P - a, P - a)):
            cands.append(cand)
    for z in cands:
        gz = _g2_g(z)
        if f2_is_zero(gz):
            continue
        t = f2_muls(f2_sqr(z), 3)
        if f2_is_zero(t):
            continue
        ratio = f2_neg(f2_mul(t, f2_inv(f2_muls(gz, 4))))
        if f2_is_zero(ratio) or not f2_is_square(ratio):
            continue
        minus_z_half = f2_muls(f2_neg(z), pow(2, P - 2, P))
        if f2_is_square(gz) or f2_is_square(_g2_g(minus_z_half)):
            return z
    raise AssertionError("no SvdW Z found")  # pragma: no cover


Z_SVDW = _find_z_svdw()

# Map constants (straight-line form of section 6.6.1).
_C1 = _g2_g(Z_SVDW)  # g(Z)
_C2 = f2_muls(f2_neg(Z_SVDW), pow(2, P - 2, P))  # -Z/2
_c3_cand = f2_sqrt(f2_neg(f2_mul(_C1, f2_muls(f2_sqr(Z_SVDW), 3))))
assert _c3_cand is not None
if f2_sgn0(_c3_cand) == 1:  # sgn0(c3) MUST be 0
    _c3_cand = f2_neg(_c3_cand)
_C3 = _c3_cand  # sqrt(-g(Z) * 3Z^2)
_C4 = f2_mul(f2_muls(_C1, -4), f2_inv(f2_muls(f2_sqr(Z_SVDW), 3)))  # -4g(Z)/(3Z^2)


def map_to_curve_svdw(u) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """One Fp2 element -> a point on E'(Fp2) (not yet in the r-torsion
    subgroup). RFC 9380 section 6.6.1 straight-line implementation."""
    tv1 = f2_mul(f2_sqr(u), _C1)
    tv2 = f2_add(F2_ONE, tv1)
    tv1 = f2_sub(F2_ONE, tv1)
    tv3 = f2_inv(f2_mul(tv1, tv2))
    tv5 = f2_mul(f2_mul(f2_mul(u, tv1), tv3), _C3)
    x1 = f2_sub(_C2, tv5)
    x2 = f2_add(_C2, tv5)
    x3 = f2_add(
        Z_SVDW, f2_mul(_C4, f2_sqr(f2_mul(f2_sqr(tv2), tv3)))
    )
    if f2_is_square(_g2_g(x1)):
        x = x1
    elif f2_is_square(_g2_g(x2)):
        x = x2
    else:
        x = x3
    y = f2_sqrt(_g2_g(x))
    assert y is not None  # x3 is guaranteed square by construction
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    return (x, y)


def clear_cofactor_g2(pt):
    """Multiply by the G2 cofactor h2, landing in the r-torsion."""
    return g2_mul(H2, pt)


def hash_to_curve_g2(msg: bytes, dst: bytes):
    """RFC 9380 hash_to_curve shape: two field elements, two maps, add,
    clear cofactor. Deterministic; output is uniform in G2."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q = g2_add(map_to_curve_svdw(u0), map_to_curve_svdw(u1))
    return clear_cofactor_g2(q)


# -- min-pk BLS signatures --------------------------------------------------
#
# Repo-scoped DSTs: the SvdW map (see module docstring) makes this
# suite deliberately distinct from the RFC ciphersuite namespace.

DST_SIG = b"TENDERMINT-TPU-BLS12381G2-SVDW:SHA-256-SIG-"
DST_POP = b"TENDERMINT-TPU-BLS12381G2-SVDW:SHA-256-POP-"


def sk_from_bytes(data: bytes) -> int:
    """32 bytes -> scalar in [1, r-1] (keygen rejects 0 mod r)."""
    sk = int.from_bytes(data, "big") % R
    if sk == 0:
        raise ValueError("degenerate BLS secret key")
    return sk


def keygen(seed: bytes) -> int:
    """Deterministic scalar from seed material (HKDF-free simplification:
    expand_message_xmd drives the modular reduction with 128-bit
    headroom, the same uniformity argument as RFC 9380 hash_to_field)."""
    ex = expand_message_xmd(seed, b"TENDERMINT-TPU-BLS-KEYGEN-", 64)
    sk = int.from_bytes(ex, "big") % R
    if sk == 0:  # pragma: no cover - probability ~2^-255
        sk = 1
    return sk


def sk_to_pk(sk: int):
    return g1_mul(sk, G1_GEN)


def sign(sk: int, msg: bytes, dst: bytes = DST_SIG):
    return g2_mul(sk, hash_to_curve_g2(msg, dst))


def verify(pk, msg: bytes, sig, dst: bytes = DST_SIG) -> bool:
    """e(pk, H(msg)) == e(G1, sig), as the product
    e(pk, H(msg)) * e(-G1, sig) == 1 (one shared final exponentiation).
    pk/sig must be valid subgroup points (callers check at decode)."""
    if pk is None or sig is None:
        return False
    hm = hash_to_curve_g2(msg, dst)
    return pairing_product_is_one([(pk, hm), (g1_neg(G1_GEN), sig)])


def prove_possession(sk: int):
    """PoP over the compressed pubkey bytes (rogue-key defense: an
    aggregator admits only keys whose owner demonstrated knowledge of
    the secret, so adversarial key offsets cannot cancel)."""
    pk = sk_to_pk(sk)
    return sign(sk, g1_compress(pk), DST_POP)


def verify_possession(pk, pop) -> bool:
    return verify(pk, g1_compress(pk), pop, DST_POP)


def aggregate_sigs(sigs: Sequence[object]):
    acc = None
    for s in sigs:
        acc = g2_add(acc, s)
    return acc


def aggregate_pubkeys(pks: Sequence[object]):
    acc = None
    for pk in pks:
        acc = g1_add(acc, pk)
    return acc


def verify_aggregate_common(pks: Sequence[object], msg: bytes, agg_sig) -> bool:
    """All signers signed the SAME message: one pairing check against
    the aggregated pubkey (the one-signature-per-commit shape)."""
    if not pks or agg_sig is None:
        return False
    apk = aggregate_pubkeys(pks)
    if apk is None:
        return False
    return verify(apk, msg, agg_sig)
