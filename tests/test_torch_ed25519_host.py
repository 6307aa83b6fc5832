"""The ed25519 kernels' formulas on the CPU: csrc/fe25519.cuh,
csrc/ge25519.cuh and csrc/ge25519_lanes.cuh built as host C++
(csrc/ed25519_host.cc, g++), held against the port's plain versions and
the JAX package.

Without nvcc the lane-staged code takes its portable branch: `par` runs a
row's lanes in turn over each stage. So a row here computes what a row
of ed25519_scan (G = 2, 4, 8) or a validator of ed25519_build_tables
(G = 2, 4, 8, 16) computes on the card. Values are compared mod p (the
limbs of two versions may differ for the same value); the squaring is
compared limb for limb with the product it replaces, the binary GCD's
inverse with Fermat's. The library is built once for the module into
a temporary directory; the JAX programs run once for the module, the
scan, the decompression and the finish eagerly and the table build
jitted (the faster of the two for each, on this CPU).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import field as jfield
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops.ed25519_host import HostEd25519
from tendermint_tpu.ops import curve as jcurve
from tendermint_tpu_torch.ops import ref_ed25519 as ref
from tests.torch_port_helpers import adversarial_rows, stack

P = F.P
BOUND = 2**26 + 2**10  # fe25519.cuh's limb bound
SCAN_LANES = (2, 4, 8)
BUILD_LANES = (2, 4, 8, 16)
rng = np.random.default_rng(20261019)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of the ed25519 headers needs a C++ compiler")
    return HostEd25519(tmp_path_factory.mktemp("ed25519_host"))


@pytest.fixture(scope="module")
def batch():
    rows, _ = adversarial_rows(seed=20261017)
    pk, msg, sig = (torch.from_numpy(stack(rows, k)) for k in range(3))
    sd, kd, neg_a, a_ok, _ = ted.verify_stage_prepare(pk, msg, sig)
    assert not bool(a_ok[5]), "row 5's key does not decompress"
    return pk, sd, kd, neg_a


def _raw_limbs(x: int) -> np.ndarray:
    """x < 2^255 split into the 10 limbs without reduction mod p."""
    return np.array([(x >> o) & ((1 << w) - 1) for o, w in zip(F.OFFSETS, F.WIDTHS)], dtype=np.int32)


def _value(limbs) -> int:
    return F.from_limbs([int(v) for v in np.asarray(limbs).reshape(-1)])


def _values(a) -> np.ndarray:
    """(..., 10) limbs -> object array of their values mod p."""
    a = np.asarray(a)
    flat = a.reshape(-1, 10)
    return np.array([_value(r) for r in flat], dtype=object).reshape(a.shape[:-1])


def _jax_values(limbs) -> np.ndarray:
    a = np.asarray(limbs)
    flat = a.reshape(-1, a.shape[-1])
    return np.array([jfield.from_limbs(r) for r in flat], dtype=object).reshape(a.shape[:-1])


def test_fe_sq_is_fe_mul_limb_for_limb(host):
    edges = [_raw_limbs(x) for x in (0, 1, P - 1, P, 2**255 - 1)]
    edges += [np.full(10, BOUND, dtype=np.int32), np.full(10, -BOUND, dtype=np.int32),
              np.array([BOUND, -BOUND] * 5, dtype=np.int32), np.array([-BOUND, BOUND] * 5, dtype=np.int32)]
    rand = [rng.integers(-BOUND, BOUND + 1, 10).astype(np.int32) for _ in range(300)]
    rand += [np.array(F.to_limbs(int.from_bytes(rng.bytes(32), "little")), dtype=np.int32) for _ in range(100)]
    for a in edges + rand:
        sq = host.fe_op(1, a)
        np.testing.assert_array_equal(sq, host.fe_op(2, a), err_msg=str(a.tolist()))
        assert _value(sq) == _value(a) ** 2 % P
        assert np.abs(sq).max() <= BOUND
    a, b = rand[0], rand[1]
    assert _value(host.fe_op(0, a, b)) == _value(a) * _value(b) % P


def _points(batch):
    """The rows' -A as (N, 4, 10) int32 (the undecodable key's garbage
    point among them) and, from them, cached points."""
    neg_a = batch[3]
    q = curve.Point(*(neg_a[:, i].to(torch.int64) for i in range(4)))
    cached = torch.stack(list(curve.to_cached(curve.double(q))), dim=1).to(torch.int32)
    return neg_a.numpy(), cached.numpy()


@pytest.mark.parametrize("lanes", (2, 4, 8, 16))
def test_staged_double_and_add_match_plain(host, batch, lanes):
    pts, cached = _points(batch)
    p = curve.Point(*(torch.from_numpy(pts[:, i]).to(torch.int64) for i in range(4)))
    for want_t in (False, True):
        want = torch.stack(list(curve.double(p, want_t=want_t)), dim=1).numpy()
        got = np.stack([host.point_op(0, pts[r], want_t=want_t, lanes=lanes) for r in range(len(pts))])
        np.testing.assert_array_equal(_values(got), _values(want))
    digits = np.array([0, 1, -1, 3, -5, 8, -8, 2, 0, -3, 7, 4, -2, 6, -6, 5])
    table = torch.from_numpy(cached).to(torch.int64)[:, None].expand(-1, 8, -1, -1)  # entry |d| - 1 = the row's point
    for want_t in (False, True):
        sel = curve._select(table.contiguous(), torch.from_numpy(np.where(digits == 0, 0, np.sign(digits))))
        want = torch.stack(list(curve.add_cached(p, sel, want_t=want_t)), dim=1).numpy()
        got = np.stack([host.point_op(1, pts[r], cached[r], int(np.sign(digits[r])), want_t, lanes)
                        for r in range(len(pts))])
        np.testing.assert_array_equal(_values(got), _values(want))


@pytest.fixture(scope="module")
def scan_want(batch):
    """The rows' [s]B + [k](-A): the plain version's and the JAX stage's
    (eager, on the same digits and -A) values."""
    _pk, sd, kd, neg_a = batch
    plain = _values(ted.scan_plain(sd, kd, neg_a).numpy())
    nx, ny, nz, nt = (jnp.asarray(np.array([jfield.to_limbs(v) for v in _values(neg_a[:, i].numpy())]))
                      for i in range(4))
    jax_point = jed.verify_stage_scan(jnp.asarray(sd.numpy().astype(np.int32)),
                                      jnp.asarray(kd.numpy().astype(np.int32)), nx, ny, nz, nt)
    return plain, np.stack([_jax_values(c) for c in jax_point], axis=1)


@pytest.mark.parametrize("lanes", SCAN_LANES)
def test_scan_row_matches_plain_and_jax(host, batch, scan_want, lanes):
    _pk, sd, kd, neg_a = batch
    got = np.stack([host.scan_row(sd[r].numpy(), kd[r].numpy(), neg_a[r].numpy(), lanes) for r in range(sd.shape[0])])
    assert (got[:, 3] == 0).all()
    plain, jax_point = scan_want
    np.testing.assert_array_equal(_values(got), plain)
    np.testing.assert_array_equal(_values(got), jax_point)


@pytest.fixture(scope="module")
def build_want(batch):
    """The keys' tables as canonical bytes, and a_ok: the plain version's
    and the JAX program's (jitted once)."""
    pk = batch[0]
    tables, a_ok = ted.build_tables_plain(pk)
    jt, ja = jax.jit(jed.build_valset_tables)(jnp.asarray(pk.numpy()))
    jbytes = np.frombuffer(b"".join(jfield.from_limbs(r).to_bytes(32, "little")
                                    for r in np.asarray(jt).reshape(-1, 20)), dtype=np.uint8)
    return (F.to_bytes(tables.to(torch.int64)).numpy(), a_ok.numpy(),
            jbytes.reshape(pk.shape[0], 16, 8, 3, 32), np.asarray(ja))


@pytest.mark.parametrize("lanes", BUILD_LANES)
def test_build_row_matches_plain_and_jax(host, batch, build_want, lanes):
    pk = batch[0]
    rows = [host.build_row(bytes(pk[v].tolist()), lanes) for v in range(pk.shape[0])]
    got = F.to_bytes(torch.from_numpy(np.stack([t for t, _ in rows])).to(torch.int64)).numpy()
    ok = np.array([a for _, a in rows])
    plain, plain_ok, jax_bytes, jax_ok = build_want
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_bytes)
    np.testing.assert_array_equal(ok, plain_ok)
    np.testing.assert_array_equal(ok, jax_ok)
    assert not ok[5] and ok.sum() == pk.shape[0] - 1


TABLED_CASES = {
    # row r reads validator idx[r]'s tables; kd/sd8 edits make the digits
    "as_signed": lambda sd8, kd: None,
    "zero_digits": lambda sd8, kd: (kd[::2].zero_(), sd8[1::2].zero_(), kd[1, ::3].zero_()),
    "negative_digits": lambda sd8, kd: (kd.copy_(-kd.abs().clamp(min=1)), sd8.copy_(-sd8.abs().clamp(min=1)),
                                        sd8[0].fill_(-128), kd[0].fill_(-8)),
}
TABLED_IDX = [3, 3, 0, 15, 7, 5, 6, 2, 9, 9, 9, 12, 1, 5, 4, 13]  # repeats; 5's key does not decompress


@pytest.fixture(scope="module")
def tabled_batch(batch):
    """The batch's keys as a set (tables by the plain build) and its rows
    prepared against it through TABLED_IDX."""
    pk = batch[0]
    tables, a_ok = ted.build_tables_plain(pk)
    idx = torch.tensor(TABLED_IDX, dtype=torch.int32)
    rows, _ = adversarial_rows(seed=20261017)
    msg, sig = (torch.from_numpy(stack(rows, k)) for k in (1, 2))
    sd8, kd, _s_ok = ted.prepare_tabled_plain(pk, sig[idx.long()], idx=idx, msgs=msg[idx.long()])
    return tables, a_ok, idx, sd8, kd


@pytest.mark.parametrize("lanes", SCAN_LANES)
@pytest.mark.parametrize("case", sorted(TABLED_CASES))
def test_scan_tabled_row_matches_plain(host, tabled_batch, lanes, case):
    """A row of ed25519_scan_tabled on G lanes (the staged mixed addition
    reading each entry's fields by lane) against scan_tabled_plain: the
    prepared rows through repeated indices (the undecodable key's table
    among them), with digits zeroed or made negative; and a row whose
    index is out of range, which writes zeros."""
    tables, a_ok, idx, sd8, kd = tabled_batch
    sd8, kd = sd8.clone(), kd.clone()
    TABLED_CASES[case](sd8, kd)
    want, want_ok = ted.scan_tabled_plain(sd8, kd, tables, a_ok, idx)
    got = np.stack([host.scan_tabled_row(sd8[r].numpy(), kd[r].numpy(), tables[int(idx[r])].numpy(), lanes)
                    for r in range(len(idx))])
    assert (got[:, 3] == 0).all()
    np.testing.assert_array_equal(_values(got), _values(want.numpy()))
    assert not bool(want_ok[5]) and not bool(want_ok[13])  # the undecodable key's rows
    np.testing.assert_array_equal(host.scan_tabled_row(sd8[0].numpy(), kd[0].numpy(), None, lanes), 0)


# -- ed25519_prepare's decompression -------------------------------------------


def _undecodable(n, seed):
    r = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        pk = r.bytes(32)
        if ref.pt_decode(pk) is None:
            out.append(pk)
    return out


DECOMPRESS_CASES = {
    "valid": [ref.pubkey_from_seed(bytes([i]) * 32) for i in (1, 2, 3)],
    "undecodable": _undecodable(3, 20261020),
    # y >= p: p + 1, p + 2 with the sign bit, 2^255 - 1 (y = 18 mod p)
    "y_at_least_p": [(P + 1).to_bytes(32, "little"), ((P + 2) | (1 << 255)).to_bytes(32, "little"),
                     (2**255 - 1).to_bytes(32, "little")],
    # x = 0 with the sign set: y = 1, y = -1, y = p + 1
    "x_zero_sign_set": [(1 | (1 << 255)).to_bytes(32, "little"), ((P - 1) | (1 << 255)).to_bytes(32, "little"),
                        ((P + 1) | (1 << 255)).to_bytes(32, "little")],
}


@pytest.fixture(scope="module")
def decompress_want():
    """Every case's keys decompressed and negated as (values (N, 4),
    a_ok): the plain curve.decompress's and the JAX package's (eager)."""
    keys = [k for case in sorted(DECOMPRESS_CASES) for k in DECOMPRESS_CASES[case]]
    pk = torch.from_numpy(np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, 32).copy())
    a, ok = curve.decompress(pk)
    plain = _values(torch.stack(list(curve.negate(a)), dim=1).numpy())
    ja, jok = jcurve.decompress(jnp.asarray(pk.numpy()))
    jvals = np.stack([_jax_values(c) for c in (ja.x, ja.y, ja.z, ja.t)], axis=1)
    jneg = np.stack([(P - jvals[:, 0]) % P, jvals[:, 1], jvals[:, 2], (P - jvals[:, 3]) % P], axis=1)
    return dict(zip(keys, zip(plain, ok.numpy(), jneg, np.asarray(jok))))


@pytest.mark.parametrize("case", sorted(DECOMPRESS_CASES))
def test_decompression_matches_plain_and_jax(host, decompress_want, case):
    """ed25519_prepare's decompression gives -A and a_ok as the plain
    curve.decompress and the JAX package's do, the garbage point of an
    undecodable key included."""
    for pk in DECOMPRESS_CASES[case]:
        neg_a, ok = host.decompress(pk)
        plain, plain_ok, jax_vals, jax_ok = decompress_want[pk]
        np.testing.assert_array_equal(_values(neg_a), plain)
        np.testing.assert_array_equal(_values(neg_a), jax_vals)
        assert ok == bool(plain_ok) == bool(jax_ok)
        assert ok == (ref.pt_decode(pk) is not None)


# -- ed25519_finish's inversion and row -------------------------------------------

GCD_BATCHES = -(-((49 * 255 + 80) // 17) // 30)  # safegcd's bound for 255 bits: 739 divsteps, 25 batches
INVERT_CASES = {
    # 0, 1, 2, p - 1, and p, p + 1, 2^255 - 1 in non-canonical limbs
    "edges": [_raw_limbs(x) for x in (0, 1, 2, P - 1, P, P + 1, 2**255 - 1)],
    "powers_of_two": [_raw_limbs(2**k) for k in range(0, 255, 7)],
    "over_width": [np.full(10, BOUND, dtype=np.int32), np.full(10, -BOUND, dtype=np.int32)]
    + [rng.integers(-BOUND, BOUND + 1, 10).astype(np.int32) for _ in range(100)],
    "random": [np.array(F.to_limbs(int.from_bytes(rng.bytes(32), "little") % P), dtype=np.int32)
               for _ in range(100)],
}


@pytest.mark.parametrize("case", sorted(INVERT_CASES))
def test_fe_inv_gcd_matches_fermat(host, case):
    """fe_inv_gcd: 1 / a as fe_invert's value and pow(a, p - 2, p), in
    canonical limbs, 0 -> 0 with no batch run; the batches within
    safegcd's bound."""
    for a in INVERT_CASES[case]:
        got, steps = host.invert(a)
        fermat, _ = host.invert(a, gcd=False)
        assert _value(got) == _value(fermat) == pow(_value(a), P - 2, P), a.tolist()
        assert all(0 <= v < (1 << w) for v, w in zip(got.tolist(), F.WIDTHS))
        assert (steps == 0) == (_value(a) == 0)
        assert steps <= GCD_BATCHES


@pytest.fixture(scope="module")
def finish_batch():
    """The adversarial rows through the plain prepare and scan, with a row
    whose Z is 0 added; finish_plain's verdicts and encodings, and the
    JAX package's verify_stage_finish (eager) on the same points."""
    rows, _ = adversarial_rows(seed=20261021)
    pk, msg, sig = (torch.from_numpy(stack(rows, k)) for k in range(3))
    _sd, _kd, _neg_a, a_ok, s_ok = prep = ted.prepare_plain(pk, msg, sig)
    point = ted.scan_plain(*prep[:3])
    point = torch.cat([point, point[:1]])
    point[-1, 2] = 0
    sig = torch.cat([sig, sig[:1]])
    a_ok, s_ok = torch.cat([a_ok, a_ok[:1]]), torch.cat([s_ok, s_ok[:1]])
    ok = ted.finish_plain(point, sig, a_ok, s_ok)
    enc = curve.encode(curve.Point(*(point[:, i].to(torch.int64) for i in range(4))))
    coords = [jnp.asarray(np.array([jfield.to_limbs(v) for v in _values(point[:, i].numpy())])) for i in range(4)]
    jok = jed.verify_stage_finish(*coords, jnp.asarray(sig.numpy()), jnp.asarray(a_ok.numpy()),
                                  jnp.asarray(s_ok.numpy()))
    return point.numpy(), sig.numpy(), a_ok.numpy(), s_ok.numpy(), ok.numpy(), enc.numpy(), np.asarray(jok)


def test_finish_row_matches_plain_and_jax(host, finish_batch):
    """One ed25519_finish row, the encoding's inversion by the binary GCD:
    the encoding is curve.encode's, the verdict finish_plain's and the JAX
    package's verify_stage_finish's, for the adversarial rows and a row
    whose Z is 0 (encoded as (0, 0): 1 / 0 is 0)."""
    point, sig, a_ok, s_ok, want_ok, want_enc, jax_ok = finish_batch
    got = [host.finish_row(point[r], sig[r, :32].tobytes(), a_ok[r], s_ok[r]) for r in range(len(point))]
    np.testing.assert_array_equal(np.stack([e for _, e in got]), want_enc)
    np.testing.assert_array_equal([o for o, _ in got], want_ok)
    np.testing.assert_array_equal([o for o, _ in got], jax_ok)
    assert want_ok.any() and not want_ok.all()
    assert not got[-1][0] and not got[-1][1].any()
