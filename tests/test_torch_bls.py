"""The port's BLS12-381 plain versions (ops/bls12.py) on the CPU.

(a) The plain field, tower and curve layers against the JAX package's
light layers, called as tests/test_bls_device.py calls them in tier-1
(eagerly, or jitted where XLA:CPU compiles one program faster than the
eager ops; the JAX map_to_g2 and pairing_check_rows take about a
minute each to compile on XLA:CPU):
Montgomery products, sums, differences and
negations, inversion, square roots and Euler's criterion, the Fp2 and
Fp12 towers with the Frobenius map, complete addition with its edge
cases, and g1_aggregate. Values are compared canonically: the JAX
package's 33 x 12-bit Montgomery limbs and the port's 48-byte seams
both as integers below p.

(b) The three wrappers on CPU tensors (their plain versions) against the
pure-Python oracle the JAX programs are pinned to: map_to_g2 equal to
clear_cofactor_g2(map(u0) + map(u1)) (with u = 0, u = 1 and an
exceptional u), pairing_check_rows' verdicts, and pairing_value equal to
the oracle's pairing CUBED (the final exponentiation's 3 (p^12-1)/r).
Each batched call runs once, in a module-scoped fixture.

(c) One slow test runs the JAX map_to_g2 and pairing_check_rows
themselves (jitted) on the same rows and compares with the port.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import bls12 as D
from tendermint_tpu.ops import ref_bls12 as B
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.ops import bls12 as T

rng = random.Random(4321)
P = B.P


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions make tens of thousands of small torch calls; one
    intra-op thread serves them best, beside the other test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rint():
    return rng.randrange(P)


def _rf2():
    return (_rint(), _rint())


def jfp(vals):
    return jnp.asarray(np.stack([D.to_mont(x) for x in vals]))


def jf2(vals):
    return jnp.asarray(np.stack([D.f2_to_mont(v) for v in vals]))


def jints(arr):
    """JAX Montgomery limbs (..., 33) -> ints, through convert."""
    return T.ints(torch.from_numpy(convert.bls_from_jax(np.asarray(arr))))


def pfp(vals):
    """ints -> the port's plain limbs (..., 16)."""
    return T.from_bytes(torch.from_numpy(np.stack([np.frombuffer(T.fp_bytes(x), dtype=np.uint8) for x in vals])))


def pf2(vals):
    return T.from_bytes(T.fp2_tensor(vals))


def pints(limbs):
    return T.ints(T.to_bytes(limbs))


# -- (a) layers against the JAX package's ------------------------------------------


def test_convert_roundtrips_jax_limbs():
    a = [_rint() for _ in range(5)] + [0, 1, P - 1]
    seam = convert.bls_from_jax(np.stack([D.to_mont(x) for x in a]))
    assert T.ints(torch.from_numpy(seam)) == a
    back = convert.bls_to_jax(seam)
    assert [D.from_mont_int(r) for r in back] == a


def test_mont_mul_matches_jax():
    a = [_rint() for _ in range(6)] + [0, 1, P - 1]
    b = [_rint() for _ in range(6)] + [P - 1, P - 1, P - 1]
    want = jints(D.mont_mul(jfp(a), jfp(b)))
    assert pints(T.fmul(pfp(a), pfp(b))) == want == [x * y % P for x, y in zip(a, b)]
    # the canonical seam is the JAX canon_from_mont's value
    assert pints(pfp(a)) == [D.from_limbs(r) for r in np.asarray(D.canon_from_mont(jfp(a)))]


def test_add_sub_neg_chains_match_jax():
    a, b = [_rint() for _ in range(4)], [_rint() for _ in range(4)]
    ja, jb, one = jfp(a), jfp(b), jnp.asarray(D.ONE_MONT)
    pa, pb = pfp(a), pfp(b)
    assert pints(pa + pb) == jints(D.mont_mul(D.add(ja, jb), one))
    assert pints(pa - pb) == jints(D.mont_mul(D.sub(ja, jb), one))
    assert pints(-pa) == jints(D.mont_mul(D.neg(ja), one))
    # a chain of sums and differences feeding a product
    chain = T.fmul(pa - pb + pa, pb - pa - pa)
    jchain = D.mont_mul(D.add(D.sub(ja, jb), ja), D.sub(D.sub(jb, ja), ja))
    assert pints(chain) == jints(jchain)


def test_fp_inv_sqrt_issquare_match_jax():
    a = [_rint() for _ in range(4)] + [0]
    pa = pfp(a)
    assert pints(T.fp_inv(pa)) == jints(D.fp_inv(jfp(a))) == [pow(x, P - 2, P) for x in a]
    sq = [x * x % P for x in a]
    assert pints(T.fp_sqrt_cand(pfp(sq))) == jints(D.fp_sqrt_candidate(jfp(sq)))
    both = a + sq
    got = T.fp_is_square(pfp(both)).tolist()
    assert got == [bool(x) for x in np.asarray(D.fp_is_square(jfp(both)))]
    assert got[len(a):] == [True] * len(sq)


def test_f2_tower_matches_jax():
    a, b = [_rf2() for _ in range(3)] + [(0, 5)], [_rf2() for _ in range(3)] + [(7, 0)]
    ja, jb, pa, pb = jf2(a), jf2(b), pf2(a), pf2(b)
    jmul, jadd, jsub, jinv, jsgn = jax.jit(lambda x, y: (D.f2_mul(x, y), D.f2_add(x, y), D.f2_sub(x, y), D.f2_inv(x),
                                                         D.f2_sgn0(x)))(ja, jb)
    for pop, jout, rop in ((T.f2_mul, jmul, B.f2_mul), (lambda x, y: x + y, jadd, B.f2_add),
                           (lambda x, y: x - y, jsub, B.f2_sub)):
        got = [tuple(v) for v in pints(pop(pa, pb))]
        assert got == [D.f2_from_mont(r) for r in np.asarray(jout)] == [rop(x, y) for x, y in zip(a, b)]
    assert [tuple(v) for v in pints(T.f2_inv(pa))] == [D.f2_from_mont(r) for r in np.asarray(jinv)]
    # the same root as the JAX program and the oracle, c1 = 0 rows included
    sq = [B.f2_sqr(x) for x in a] + [(4, 0), (P - 4, 0)]
    got = [tuple(v) for v in pints(T.f2_sqrt(pf2(sq)))]
    assert got == [D.f2_from_mont(r) for r in np.asarray(D.f2_sqrt(jf2(sq)))] == [B.f2_sqrt(x) for x in sq]
    assert T.f2_sgn0(pa).tolist() == [int(x) for x in np.asarray(jsgn)] == [B.f2_sgn0(x) for x in a]
    assert T.f2_is_square(pf2(sq)).all()


def _rf12():
    return tuple(tuple(_rf2() for _ in range(3)) for _ in range(2))


def test_f12_tower_and_frobenius_match_jax():
    a, b = [_rf12() for _ in range(2)], [_rf12() for _ in range(2)]

    def j12(vals):
        return jnp.asarray(np.stack([np.stack([np.stack([D.f2_to_mont(c) for c in h]) for h in v]) for v in vals]))

    def p12(vals):
        return T.from_bytes(torch.stack([T.fp2_tensor([c for h in v for c in h]).reshape(2, 3, 2, 48) for v in vals]))

    def port_out(limbs):
        return [T.f12_value(x) for x in T.to_bytes(limbs)]

    def jax_out(arr):
        return [T.f12_value(torch.from_numpy(convert.bls_from_jax(x))) for x in np.asarray(arr)]

    ja, jb, pa, pb = j12(a), j12(b), p12(a), p12(b)
    assert port_out(T.f12_mul(pa, pb)) == jax_out(jax.jit(D.f12_mul)(ja, jb)) == [
        B._f12_canon(B.f12_mul(x, y)) for x, y in zip(a, b)]
    assert port_out(T.f12_inv(pa)) == jax_out(jax.jit(D.f12_inv)(ja)) == [B._f12_canon(B.f12_inv(x)) for x in a]
    assert port_out(T.f12_frobenius(pa)) == jax_out(D.f12_frobenius(ja)) == [
        B._f12_canon(B.f12_frobenius(x)) for x in a]


def test_complete_add_edges_match_jax():
    """Generic, doubling, identity and inverse rows through one
    branch-free complete addition, as the JAX g1_padd, and the oracle."""
    pts = [B.g1_mul(rng.randrange(1, B.R), B.G1_GEN) for _ in range(3)]
    nxt = pts[1:] + pts[:1]
    negs = [B.g1_neg(p) for p in pts]

    def port(ps):
        xy = pfp([c for p in ps for c in p]).reshape(len(ps), 2, T.NLIMB)
        one = torch.zeros_like(xy[:, 0])
        one[:, 0] = 1
        return xy[:, 0], xy[:, 1], one

    def jpt(ps):
        xs, ys = jfp([p[0] for p in ps]), jfp([p[1] for p in ps])
        return xs, ys, jnp.broadcast_to(jnp.asarray(D.ONE_MONT), xs.shape)

    ident_p = (torch.zeros(3, T.NLIMB, dtype=torch.int64), port(pts)[2], torch.zeros(3, T.NLIMB, dtype=torch.int64))
    jadd = jax.jit(lambda p, q: D.g1_normalize(D.g1_padd(p, q)))
    for q, jq, want in ((nxt, jpt(nxt), [B.g1_add(p, r) for p, r in zip(pts, nxt)]),
                        (pts, jpt(pts), [B.g1_double(p) for p in pts]),
                        (None, D.g1_proj_identity((3,)), pts),
                        (negs, jpt(negs), [None] * 3)):
        X, Y, Z = T.g1_add(port(pts), port(q) if q is not None else ident_p)
        zi = T.fp_inv(Z)
        got = [None if inf else (x, y) for x, y, inf in
               zip(pints(T.fmul(X, zi)), pints(T.fmul(Y, zi)), T.is_zero(Z).tolist())]
        jx, jy, jinf = jadd(jpt(pts), jq)
        jgot = [None if bool(f) else (x, y) for x, y, f in zip(jints(jx), jints(jy), np.asarray(jinf))]
        assert got == jgot == want


def test_g1_aggregate_matches_jax_and_takes_any_width():
    pts = [B.g1_mul(rng.randrange(1, B.R), B.G1_GEN) for _ in range(7)]
    pts.append(B.g1_neg(pts[0]))
    masks = np.zeros((5, 8), dtype=bool)
    masks[0, :5] = True
    masks[2, [0, 7]] = True  # P + (-P)
    masks[3, 1] = True  # one point
    masks[4, :] = True
    # row 1 stays empty: the identity
    xs = np.broadcast_to(np.stack([D.to_mont(p[0]) for p in pts]), (5, 8, D.LIMBS)).copy()
    ys = np.broadcast_to(np.stack([D.to_mont(p[1]) for p in pts]), (5, 8, D.LIMBS)).copy()
    jx, jy, jinf = jax.jit(D.g1_aggregate)(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(masks))
    jgot = [None if bool(f) else (D.from_limbs(x), D.from_limbs(y))
            for x, y, f in zip(np.asarray(jx), np.asarray(jy), np.asarray(jinf))]
    out, inf = T.g1_aggregate(T.g1_tensor(pts), torch.from_numpy(masks))
    want = [B.aggregate_pubkeys([p for p, m in zip(pts, row) if m]) for row in masks]
    assert T.g1_points(out, inf) == jgot == want
    assert want[1] is None and want[2] is None
    # widths the JAX program refuses (not a power of two), and P + P
    m7 = np.ones((2, 7), dtype=bool)
    m7[1] = False
    m7[1, 3] = True
    out7, inf7 = T.g1_aggregate(T.g1_tensor(pts[:7]), torch.from_numpy(m7))
    assert T.g1_points(out7, inf7) == [B.aggregate_pubkeys(pts[:7]), pts[3]]
    outd, infd = T.g1_aggregate(T.g1_tensor([pts[2], pts[2], pts[5]]), torch.tensor([[True, True, False]]))
    assert T.g1_points(outd, infd) == [B.g1_double(pts[2])]
    out0, inf0 = T.g1_aggregate(T.g1_tensor([]), torch.zeros((2, 0), dtype=torch.bool))
    assert inf0.tolist() == [True, True] and not out0.any()


# -- (b) the wrappers' plain versions against the oracle ---------------------------


def _exceptional_u():
    """An Fp2 u with u^2 C1 = -1 or 1 (tv1 tv2 = 0, the map's inv0 case)."""
    inv = B.f2_inv(B._C1)
    for t in (B.f2_neg(inv), inv):
        r = B.f2_sqrt(t)
        if r is not None:
            return r
    raise AssertionError("no exceptional u")


@pytest.fixture(scope="module")
def map_rows():
    us = [B.hash_to_field_fp2(b"port-map-%d" % i, B.DST_SIG, 2) for i in range(2)]
    us.append([(0, 0), (1, 0)])
    us.append([_exceptional_u(), (0, 1)])
    q, inf = T.map_to_g2(T.fp2_tensor([u[0] for u in us]), T.fp2_tensor([u[1] for u in us]))
    return us, q, inf


def test_map_to_g2_equals_the_oracle(map_rows):
    us, q, inf = map_rows
    assert q.dtype == torch.uint8 and tuple(q.shape) == (len(us), 2, 2, 48) and not inf.any()
    got = T.g2_points(q, inf)
    for i, u in enumerate(us):
        want = B.clear_cofactor_g2(B.g2_add(B.map_to_curve_svdw(u[0]), B.map_to_curve_svdw(u[1])))
        assert got[i] == want, i
        assert B.g2_in_subgroup(got[i])
    assert got[0] == B.hash_to_curve_g2(b"port-map-0", B.DST_SIG)


@pytest.fixture(scope="module")
def pairing_rows():
    sks = [B.keygen(b"port-pc-%d" % i) for i in range(2)]
    pks = [B.sk_to_pk(s) for s in sks]
    hm = [B.hash_to_curve_g2(b"port-pm-%d" % i, B.DST_SIG) for i in range(2)]
    sigs = [B.g2_mul(sks[0], hm[0]), B.g2_mul(sks[1], hm[0]), B.g2_mul(1, hm[1])]
    rows = [(pks[0], hm[0], sigs[0]),       # valid
            (pks[1], hm[1], sigs[1]),       # a signature over another message
            (B.G1_GEN, hm[1], sigs[2])]     # pk = G1 with sk = 1: valid
    ok, value = T.pairing_check_rows(T.g1_tensor([r[0] for r in rows]), T.g2_tensor([r[1] for r in rows]),
                                     T.g2_tensor([r[2] for r in rows]))
    single = T.pairing_value(T.g1_tensor(pks), T.g2_tensor(hm))
    return rows, ok, value, pks, hm, single


def test_pairing_check_rows_verdicts(pairing_rows):
    rows, ok, value, *_ = pairing_rows
    assert ok.dtype == torch.bool and tuple(value.shape) == (3, 2, 3, 2, 48)
    assert ok.tolist() == [True, False, True]
    assert ok.tolist() == [B.pairing_product_is_one([(pk, h), (B.g1_neg(B.G1_GEN), sig)]) for pk, h, sig in rows]
    one = B._f12_canon(B.F12_ONE)
    assert [T.f12_value(v) == one for v in value] == ok.tolist()


def test_pairing_value_is_the_oracle_cubed(pairing_rows):
    *_, pks, hm, single = pairing_rows
    for i in range(2):
        assert T.f12_value(single[i]) == B._f12_canon(B.f12_pow(B.pairing(pks[i], hm[i]), 3))


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        T.map_to_g2(torch.zeros((2, 2, 48), dtype=torch.uint8), torch.zeros((3, 2, 48), dtype=torch.uint8))
    with pytest.raises(TypeError):
        T.g1_aggregate(torch.zeros((2, 2, 48), dtype=torch.int32), torch.ones((1, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        T.g1_aggregate(torch.zeros((2, 2, 48), dtype=torch.uint8), torch.ones((1, 3), dtype=torch.bool))
    with pytest.raises(ValueError):
        T.pairing_check_rows(torch.zeros((1, 2, 48), dtype=torch.uint8), torch.zeros((1, 2, 2, 48), dtype=torch.uint8),
                             torch.zeros((2, 2, 2, 48), dtype=torch.uint8))


def test_constants_blob_matches_the_kernels_struct():
    """csrc/fp381.cuh's Constants: 420 little-endian words (checked in
    the kernel's set_bls_constants too)."""
    blob = T.constants_blob()
    assert len(blob) == 420 * 4
    words = np.frombuffer(blob, dtype="<u4")
    assert sum(int(w) << (32 * i) for i, w in enumerate(words[:12])) == P
    assert (int(words[12]) * P) % (1 << 32) == (1 << 32) - 1  # n0 = -p^-1 mod 2^32


@pytest.mark.cuda
def test_bls_kernels_match_their_plain_versions_on_card(map_rows, pairing_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    us, q, inf = map_rows
    dev = torch.device("cuda")
    qd, infd = T.map_to_g2(T.fp2_tensor([u[0] for u in us], dev), T.fp2_tensor([u[1] for u in us], dev))
    assert torch.equal(qd.cpu(), q) and torch.equal(infd.cpu(), inf)
    rows, ok, value, *_ = pairing_rows
    okd, valued = T.pairing_check_rows(*(t.to(dev) for t in (T.g1_tensor([r[0] for r in rows]),
                                                             T.g2_tensor([r[1] for r in rows]),
                                                             T.g2_tensor([r[2] for r in rows]))))
    assert torch.equal(okd.cpu(), ok) and torch.equal(valued.cpu(), value)


# -- (c) the JAX programs themselves (minutes of XLA:CPU compile) ------------------


@pytest.mark.slow
def test_jax_map_and_pairing_programs_equal_the_port(map_rows, pairing_rows):
    import jax

    us, q, inf = map_rows
    jx, jy, jinf = jax.jit(D.map_to_g2)(jf2([u[0] for u in us]), jf2([u[1] for u in us]))
    got = [None if bool(f) else ((D.from_limbs(x[0]), D.from_limbs(x[1])), (D.from_limbs(y[0]), D.from_limbs(y[1])))
           for x, y, f in zip(np.asarray(jx), np.asarray(jy), np.asarray(jinf))]
    assert got == T.g2_points(q, inf)
    rows, ok, *_ = pairing_rows
    jok = jax.jit(D.pairing_check_rows)(
        jfp([r[0][0] for r in rows]), jfp([r[0][1] for r in rows]), jf2([r[1][0] for r in rows]),
        jf2([r[1][1] for r in rows]), jf2([r[2][0] for r in rows]), jf2([r[2][1] for r in rows]))
    assert [bool(x) for x in np.asarray(jok)] == ok.tolist()
