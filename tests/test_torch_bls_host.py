"""The BLS kernels' formulas on the CPU: csrc/fp381.cuh and
csrc/bls12_curve.cuh built as host C++ (csrc/bls12_host.cc, g++), held
bit-identical to the oracle and to the port's plain versions.

Without nvcc the headers take their portable branches: fp_mul's u64 twin
of the PTX carry chains, and `par`, which runs a row's lanes in turn over
each stage. So a row here computes what a row of bls12_pairing_check or
bls12_map_to_g2 computes with G lanes; the lane groups 4, 8, 16, 32 and
64 (a row two warps) are run alike. The library is built once for the module into a
temporary directory.

Every value the kernels keep is canonical (< p), so fp_mul's inputs are
below p; its edge values are 0, 1, p - 1 and p - 2.
"""

import random
import shutil

import pytest
import torch

from tendermint_tpu.ops import ref_bls12 as B
from tendermint_tpu_torch.ops import bls12 as T
from tendermint_tpu_torch.ops.bls12_host import HostBLS

P = B.P
R = 1 << 384
RINV = pow(R, -1, P)
LANES = (4, 8, 16, 32, 64)
rng = random.Random(8181)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of the BLS headers needs a C++ compiler")
    return HostBLS(tmp_path_factory.mktemp("bls12_host"))


def _f12_bytes(v) -> bytes:
    return b"".join(T.fp_bytes(c) for half in v for f2 in half for c in f2)


def _f12(buf: bytes):
    ints = [int.from_bytes(buf[48 * i:48 * i + 48], "big") for i in range(12)]
    return tuple(tuple((ints[6 * h + 2 * j], ints[6 * h + 2 * j + 1]) for j in range(3)) for h in range(2))


def _rf2():
    return (rng.randrange(P), rng.randrange(P))


def _rf12():
    return tuple(tuple(_rf2() for _ in range(3)) for _ in range(2))


def _g1(p) -> bytes:
    return T.fp_bytes(p[0]) + T.fp_bytes(p[1])


def _g2(q) -> bytes:
    return T.fp_bytes(q[0][0]) + T.fp_bytes(q[0][1]) + T.fp_bytes(q[1][0]) + T.fp_bytes(q[1][1])


def test_fp_mul_twin_matches_python_ints(host):
    edges = [0, 1, P - 1, P - 2]
    pairs = [(a, b) for a in edges for b in edges] + [(rng.randrange(P), rng.randrange(P)) for _ in range(300)]
    pairs += [(rng.randrange(P), e) for e in edges for _ in range(5)]
    for a, b in pairs:
        assert host.fp_op(0, a, b) == a * b * RINV % P, (a, b)


def test_fp_add_sub_match_python_ints(host):
    edges = [0, 1, P - 1, P - 2]
    pairs = [(a, b) for a in edges for b in edges] + [(rng.randrange(P), rng.randrange(P)) for _ in range(200)]
    for a, b in pairs:
        assert host.fp_op(1, a, b) == (a + b) % P
        assert host.fp_op(2, a, b) == (a - b) % P


@pytest.mark.parametrize("lanes", LANES)
def test_sparse_line_product_equals_the_full_f12_mul(host, lanes):
    """line_mul on the slots 1, v w, v^2 w against the oracle's f12_mul by
    the line widened to a full Fp12."""
    z = (0, 0)
    for _ in range(3):
        f, s = _rf12(), (_rf2(), _rf2(), _rf2())
        line = ((s[0], z, z), (z, s[1], s[2]))
        got = host.f12_op(3, _f12_bytes(f), _f12_bytes(((s[0], s[1], s[2]), (z, z, z))), lanes)
        assert _f12(got) == B._f12_canon(B.f12_mul(f, line))


@pytest.mark.parametrize("lanes", LANES)
def test_cyclotomic_square_equals_f12_sqr_after_the_easy_part(host, lanes):
    for _ in range(2):
        a = _rf12()
        t = B.f12_mul(B.f12_conj(a), B.f12_inv(a))
        m = B.f12_mul(B.f12_frobenius(B.f12_frobenius(t)), t)
        got = host.f12_op(2, _f12_bytes(m), lanes=lanes)
        assert _f12(got) == B._f12_canon(B.f12_sqr(m))


@pytest.mark.parametrize("op", ["mul", "sqr", "frobenius", "inv"])
def test_f12_stages_match_the_oracle(host, op):
    a, b = _rf12(), _rf12()
    code, want = {"mul": (0, B.f12_mul(a, b)), "sqr": (1, B.f12_sqr(a)), "frobenius": (4, B.f12_frobenius(a)),
                  "inv": (5, B.f12_inv(a))}[op]
    assert _f12(host.f12_op(code, _f12_bytes(a), _f12_bytes(b))) == B._f12_canon(want)


@pytest.fixture(scope="module")
def pairing_rows():
    """tests/test_torch_bls.py's pairing rows, with the oracle's verdicts
    and cubed values and the port's plain values."""
    sks = [B.keygen(b"port-pc-%d" % i) for i in range(2)]
    pks = [B.sk_to_pk(s) for s in sks]
    hm = [B.hash_to_curve_g2(b"port-pm-%d" % i, B.DST_SIG) for i in range(2)]
    sigs = [B.g2_mul(sks[0], hm[0]), B.g2_mul(sks[1], hm[0]), B.g2_mul(1, hm[1])]
    rows = [(pks[0], hm[0], sigs[0]), (pks[1], hm[1], sigs[1]), (B.G1_GEN, hm[1], sigs[2])]
    verdicts = [B.pairing_product_is_one([(pk, h), (B.g1_neg(B.G1_GEN), s)]) for pk, h, s in rows]
    cubed = []
    for pk, h, s in rows:
        f = B.f12_mul(B.miller_loop(h, pk), B.miller_loop(s, B.g1_neg(B.G1_GEN)))
        cubed.append(B._f12_canon(B.f12_pow(B.final_exponentiation(f), 3)))
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain_ok, plain_value = T.pairing_plain(T.g1_tensor([r[0] for r in rows]), T.g2_tensor([r[1] for r in rows]),
                                                T.g2_tensor([r[2] for r in rows]))
        single = T.pairing_value(T.g1_tensor(pks), T.g2_tensor(hm))
    finally:
        torch.set_num_threads(saved)
    single_cubed = [B._f12_canon(B.f12_pow(B.pairing(pk, h), 3)) for pk, h in zip(pks, hm)]
    return rows, verdicts, cubed, plain_ok, plain_value, (pks, hm, single, single_cubed)


@pytest.mark.parametrize("lanes", LANES)
def test_pairing_row_equals_the_oracle_and_the_plain_version(host, pairing_rows, lanes):
    rows, verdicts, cubed, plain_ok, plain_value, _ = pairing_rows
    assert verdicts == [True, False, True]
    counts = []
    for i, (pk, h, s) in enumerate(rows):
        host.reset_count()
        ok, value = host.pairing_row(_g1(pk), _g2(h), _g2(s), lanes)
        counts.append(host.count())
        assert ok == verdicts[i] == bool(plain_ok[i])
        assert _f12(value) == cubed[i]
        assert value == plain_value[i].numpy().tobytes()
    assert len(set(counts)) == 1  # the same products whatever the row


@pytest.mark.parametrize("lanes", LANES)
def test_pairing_row_with_one_pair_is_pairing_value(host, pairing_rows, lanes):
    pks, hm, single, single_cubed = pairing_rows[-1]
    for i in range(2):
        ok, value = host.pairing_row(_g1(pks[i]), _g2(hm[i]), None, lanes)
        assert not ok
        assert value == single[i].numpy().tobytes()
        assert _f12(value) == single_cubed[i]


def _exceptional_u():
    inv = B.f2_inv(B._C1)
    for t in (B.f2_neg(inv), inv):
        r = B.f2_sqrt(t)
        if r is not None:
            return r
    raise AssertionError("no exceptional u")


@pytest.mark.parametrize("lanes", LANES)
def test_map_row_equals_the_oracle(host, lanes):
    us = [B.hash_to_field_fp2(b"port-map-%d" % i, B.DST_SIG, 2) for i in range(2)]
    us += [[(0, 0), (1, 0)], [(1, 0), (0, 0)], [_exceptional_u(), (0, 1)], [(0, 0), (0, 0)]]
    for u in us:
        x, y, inf = host.map_row(T.fp_bytes(u[0][0]) + T.fp_bytes(u[0][1]), T.fp_bytes(u[1][0]) + T.fp_bytes(u[1][1]),
                                 lanes)
        ints = [int.from_bytes(b[48 * i:48 * i + 48], "big") for b in (x, y) for i in range(2)]
        want = B.clear_cofactor_g2(B.g2_add(B.map_to_curve_svdw(u[0]), B.map_to_curve_svdw(u[1])))
        assert (None if inf else ((ints[0], ints[1]), (ints[2], ints[3]))) == want, u
        assert not inf or x + y == bytes(192)


def test_g1_sum_equals_the_oracle(host):
    """bls12_g1_aggregate's work for one batch row (its chunks, groups,
    trees and final combine, at the compiled chunk and lanes): a ragged
    selection, P + (-P), the empty selection."""
    pts = [B.g1_mul(i + 3, B.G1_GEN) for i in range(150)]
    pts[7] = B.g1_neg(pts[3])
    buf = b"".join(_g1(p) for p in pts)
    masks = [bytes(rng.random() < 0.5 for _ in pts), bytes(i in (3, 7) for i in range(len(pts))), bytes(len(pts))]
    for mask in masks:
        acc = None
        for p, m in zip(pts, mask):
            if m:
                acc = B.g1_add(acc, p)
        out, inf = host.g1_sum(buf, mask)
        got = None if inf else (int.from_bytes(out[:48], "big"), int.from_bytes(out[48:], "big"))
        assert got == acc


AGG_LANES = (2, 4, 8, 16)


def _proj(p, z: int) -> bytes:
    """The affine point p (None: the identity) as (X, Y, Z) = (x z, y z, z)."""
    if p is None:
        return T.fp_bytes(0) + T.fp_bytes(1) + T.fp_bytes(0)
    return T.fp_bytes(p[0] * z % P) + T.fp_bytes(p[1] * z % P) + T.fp_bytes(z)


def _affine(buf: bytes):
    x, y, z = (int.from_bytes(buf[48 * i:48 * i + 48], "big") for i in range(3))
    if z == 0:
        assert y != 0, "a projective point with Y = Z = 0"
        return None
    zi = pow(z, -1, P)
    return x * zi % P, y * zi % P


@pytest.mark.parametrize("lanes", AGG_LANES)
@pytest.mark.parametrize("case", ["random", "coincident", "negated", "identity"])
def test_g1_add_on_lanes_equals_the_oracle(host, lanes, case):
    """g1_add_stages (projective, and mixed with an affine q) against the
    oracle's g1_add: P + Q, P + P, P + (-P), and the identity on either
    side (the complete formulas, no special path)."""
    p = B.g1_mul(rng.randrange(1, B.R), B.G1_GEN)
    q = {"random": B.g1_mul(rng.randrange(1, B.R), B.G1_GEN), "coincident": p, "negated": B.g1_neg(p),
         "identity": None}[case]
    zp, zq = rng.randrange(1, P), rng.randrange(1, P)
    pairs = [(p, q), (q, p)]
    for a, b in pairs:
        want = B.g1_add(a, b)
        assert _affine(host.g1_add(_proj(a, zp), _proj(b, zq), lanes)) == want
        if b is not None:  # the mixed form: q affine
            assert _affine(host.g1_add(_proj(a, zp), _g1(b), lanes)) == want


def _mont(x: int) -> int:
    return x * R % P


@pytest.mark.parametrize("case", ["zero", "one", "p_minus_one", "powers_of_two", "random"])
def test_gcd_inverse_equals_fermat(host, case):
    """fp_inv_gcd against pow(a, p - 2, p) in Montgomery form (in: aR, out:
    a^-1 R), and against the kernels' Fermat fp_inv; 0 -> 0."""
    vals = {"zero": [0], "one": [1], "p_minus_one": [P - 1], "powers_of_two": [1 << k for k in range(381)],
            "random": [rng.randrange(P) for _ in range(300)]}[case]
    for a in vals:
        got, steps = host.fp_op_steps(4, _mont(a))
        assert got == (_mont(pow(a, P - 2, P)) if a else 0), a
        assert steps <= 37  # at most (49 * 381 + 80) // 17 = 1,102 divsteps (safegcd), 30 a batch
        if a in (0, 1, P - 1) or a == vals[-1]:
            assert got == host.fp_op(3, _mont(a))
    if case == "zero":
        assert host.fp_op_steps(4, 0) == (0, 0)


@pytest.fixture(scope="module")
def agg_points():
    """300 points P_i = (i + 3) G1, P_7 = -P_3, and the oracle's running
    sums of every selection below."""
    pts = [B.g1_mul(i + 3, B.G1_GEN) for i in range(300)]
    pts[7] = B.g1_neg(pts[3])
    return pts, b"".join(_g1(p) for p in pts)


@pytest.mark.parametrize("lanes", AGG_LANES)
@pytest.mark.parametrize("v", [0, 1, 7, 128, 300])
def test_chunked_g1_sum_equals_the_oracle(host, agg_points, lanes, v):
    """The aggregate's chunked sum and final combine over V points: chunks
    of 16 (many blocks, V = 300 leaving a short last chunk; P_3 and -P_3
    in different blocks), 64 and 128 (a chunk above V at small V), masks
    ragged, all, none and P + (-P)."""
    pts, buf = agg_points
    masks = [bytes(rng.random() < 0.5 for _ in range(v)), bytes([1] * v), bytes(v),
             bytes(i in (3, 7) for i in range(v))]
    for mask in masks:
        acc = None
        for p, m in zip(pts, mask):
            if m:
                acc = B.g1_add(acc, p)
        for chunk in (16, 64, 128):
            out, inf = host.g1_sum(buf[:96 * v], mask, chunk, lanes)
            got = None if inf else (int.from_bytes(out[:48], "big"), int.from_bytes(out[48:], "big"))
            assert got == acc, (chunk, mask.hex())
            assert not inf or out == bytes(96)
