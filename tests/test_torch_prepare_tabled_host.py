"""ed25519_prepare_tabled's own steps on the CPU: csrc/prepare_tabled.cuh,
sha512.cuh and sc25519.cuh built as host C++ (csrc/ed25519_host.cc, g++),
held against the port's plain version (ops/ed25519.py
prepare_tabled_plain), hashlib and Python integers.

The host build runs a block's threads in turn over each step of the
kernel and its blocks in turn, so it computes what the card computes: the
staged rows, the template words staged once a block, the timestamp
spliced into a row's words at every byte offset mod 8, one-, two- and
three-block preimages, more templates than rows a block (several passes),
rows whose key or template index is out of range, the word-input scalar
reduction and the packed digits. The library is built once for the
module; inputs come from numpy seeds.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.codec.signbytes import TIMESTAMP_OFFSET
from tendermint_tpu_torch.ops import curve, sc
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops.ed25519_host import HostEd25519

L = 2**252 + 27742317777372353535851937790883648493
ROWS = (32, 64, 128)  # the block sizes the kernel can be compiled with


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of the ed25519 headers needs a C++ compiler")
    return HostEd25519(tmp_path_factory.mktemp("prepare_host"))


def scalars(rng, n: int) -> np.ndarray:
    """(n, 32) scalars: most below L, and L - 1, L, L + 1, 2^253 - 1 and
    random 32-byte values (mostly above L)."""
    vals = [int(rng.integers(0, 2**62)) * (L // 2**62) % L for _ in range(n)]
    for i, v in enumerate((L - 1, L, L + 1, 2**253 - 1)):
        vals[(3 + 7 * i) % n] = v
    out = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in vals])
    out[1::5] = rng.integers(0, 256, (len(out[1::5]), 32), dtype=np.uint8)
    return out


def batch(seed: int, n: int = 77, v: int = 50, ntpl: int = 3, width: int = 160):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, (v, 32), dtype=np.uint8)
    sig = np.concatenate([rng.integers(0, 256, (n, 32), dtype=np.uint8), scalars(rng, n)], axis=1)
    return dict(pk_all=pk, sig=sig, idx=rng.integers(0, v, n).astype(np.int32),
                templates=rng.integers(0, 256, (ntpl, width), dtype=np.uint8),
                tmpl_idx=rng.integers(0, ntpl, n).astype(np.int32), ts8=rng.integers(0, 256, (n, 8), dtype=np.uint8))


def sign_bytes(b, ts_off=TIMESTAMP_OFFSET):
    """(N, W) rows: each row's template with its timestamp at byte ts_off."""
    rows = b["templates"][b["tmpl_idx"]].copy()
    rows[:, ts_off:ts_off + 8] = b["ts8"]
    return rows


def plain(b, msgs):
    """The plain version's outputs for the rows' messages `msgs`."""
    return [x.numpy() for x in ted.prepare_tabled_plain(
        torch.from_numpy(b["pk_all"]), torch.from_numpy(b["sig"]), torch.from_numpy(b["idx"]), torch.from_numpy(msgs))]


def check(got, want, b, msgs):
    """The kernel's outputs equal the plain version's, and each row's
    digest equals hashlib's SHA-512 of R || A || M."""
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    assert [d.tobytes() for d in got[3]] == [
        hashlib.sha512(b["sig"][r, :32].tobytes() + b["pk_all"][b["idx"][r]].tobytes() + msgs[r].tobytes()).digest()
        for r in range(len(msgs))]


@pytest.mark.parametrize("residue", range(8))
def test_templates_with_the_timestamp_at_every_offset(host, residue):
    b = batch(residue)
    ts_off = 88 + residue  # across the words that hold message bytes 88..103
    got = host.prepare_tabled(b["pk_all"], b["sig"], idx=b["idx"], templates=b["templates"], tmpl_idx=b["tmpl_idx"],
                              ts8=b["ts8"], ts_off=ts_off)
    msgs = sign_bytes(b, ts_off)
    check(got, plain(b, msgs), b, msgs)
    assert 0 < got[2].sum() < len(msgs), "the batch holds rows with s < L and rows without"


@pytest.mark.parametrize("rows", ROWS)
def test_more_templates_than_rows_a_block(host, rows):
    """ntpl past a block's rows: the block stages its templates in passes
    of `rows` and each row compresses in its template's pass."""
    b = batch(100 + rows, n=2 * rows + 9, ntpl=2 * rows + 5)
    got = host.prepare_tabled(b["pk_all"], b["sig"], idx=b["idx"], templates=b["templates"], tmpl_idx=b["tmpl_idx"],
                              ts8=b["ts8"], rows=rows)
    msgs = sign_bytes(b)
    check(got, plain(b, msgs), b, msgs)
    want = ted.prepare_tabled_plain(*(torch.from_numpy(b[k]) for k in ("pk_all", "sig", "idx")), None,
                                    *(torch.from_numpy(b[k]) for k in ("templates", "tmpl_idx", "ts8")))
    for g, w in zip(got[:3], want):  # the plain version's own template form
        np.testing.assert_array_equal(g, w.numpy().astype(g.dtype))


@pytest.mark.parametrize("width,blocks", [(24, 1), (47, 1), (160, 2), (175, 2), (176, 3), (240, 3), (303, 3)])
@pytest.mark.parametrize("form", ["templates", "matrix"])
def test_one_two_and_three_block_preimages(host, width, blocks, form):
    """The sign-bytes' 160 and widths at the block counts' edges (64 + M
    + 17 bytes padded to 128), 16-byte aligned and not (the staging's
    byte path)."""
    assert (64 + width + 17 + 127) // 128 == blocks
    b = batch(width, width=width)
    ts_off = min(TIMESTAMP_OFFSET, width - 8)
    if form == "templates":
        got = host.prepare_tabled(b["pk_all"], b["sig"], idx=b["idx"], templates=b["templates"],
                                  tmpl_idx=b["tmpl_idx"], ts8=b["ts8"], ts_off=ts_off)
        msgs = sign_bytes(b, ts_off)
    else:
        msgs = np.random.default_rng(width).integers(0, 256, (len(b["sig"]), width), dtype=np.uint8)
        got = host.prepare_tabled(b["pk_all"], b["sig"], idx=b["idx"], msgs=msgs)
    check(got, plain(b, msgs), b, msgs)


@pytest.mark.parametrize("form", ["templates", "matrix", "no_idx"])
def test_rows_whose_index_is_out_of_range(host, form):
    """A row whose key or template index is out of range reads nothing:
    zeros and s_ok 0; the other rows as the plain version gives them."""
    b = batch(7, n=70)
    v, ntpl = len(b["pk_all"]), len(b["templates"])
    bad_idx = {3: -1, 31: v, 32: v + 7, 69: -5}
    bad_tpl = {5: -1, 40: ntpl, 63: 1 << 30} if form == "templates" else {}
    if form == "no_idx":
        b["pk_all"] = np.concatenate([b["pk_all"], b["pk_all"]])[:70]
        b["idx"] = np.arange(70, dtype=np.int32)
        bad_idx = {}
    for r, i in bad_idx.items():
        b["idx"][r] = i
    for r, t in bad_tpl.items():
        b["tmpl_idx"][r] = t
    bad = sorted(set(bad_idx) | set(bad_tpl))
    good = np.ones(70, dtype=bool)
    good[bad] = False
    msgs = np.zeros((70, b["templates"].shape[1]), dtype=np.uint8)
    msgs[good] = sign_bytes(dict(templates=b["templates"], tmpl_idx=b["tmpl_idx"][good], ts8=b["ts8"][good]))
    src = dict(templates=b["templates"], tmpl_idx=b["tmpl_idx"], ts8=b["ts8"]) if form != "matrix" else dict(msgs=msgs)
    got = host.prepare_tabled(b["pk_all"], b["sig"], idx=None if form == "no_idx" else b["idx"], **src)
    assert not got[0][bad].any() and not got[1][bad].any() and not got[2][bad].any()
    sub = dict(pk_all=b["pk_all"], sig=b["sig"][good], idx=b["idx"][good])
    for g, w in zip(got[:3], plain(sub, msgs[good])):
        np.testing.assert_array_equal(g[good], w.astype(g.dtype))


def test_word_input_sc_reduce(host):
    """sc_reduce_words against Python integers and the plain reduce512, on
    random digests and the edges (0, L - 1, L, 2^512 - 1, 2^256 L)."""
    rng = np.random.default_rng(512)
    digests = [rng.bytes(64) for _ in range(200)]
    digests += [bytes(64), (L - 1).to_bytes(64, "little"), L.to_bytes(64, "little"), b"\xff" * 64,
                (L << 256).to_bytes(64, "little")]
    got = [host.sc_reduce(d) for d in digests]
    assert got == [(int.from_bytes(d, "little") % L).to_bytes(32, "little") for d in digests]
    want = sc.reduce512(torch.from_numpy(np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 64).copy()))
    assert got == [r.tobytes() for r in want.numpy()]


def test_packed_digits_and_s_below_l(host):
    """The packed nibble and base-256 digits and s < L against the plain
    versions' (curve.signed_digits, signed_digits_base256,
    sc.is_canonical)."""
    s = scalars(np.random.default_rng(256), 120)
    t = torch.from_numpy(s)
    want_nib = curve.signed_digits(curve.nibble_digits(t)).numpy()
    want_b256 = curve.signed_digits_base256(t).numpy()
    want_ok = sc.is_canonical(t).numpy()
    for i, row in enumerate(s):
        nib, b256, ok = host.scalar_digits(row.tobytes())
        np.testing.assert_array_equal(nib, want_nib[i])
        np.testing.assert_array_equal(b256, want_b256[i])
        assert ok == bool(want_ok[i]) == (int.from_bytes(row.tobytes(), "little") < L)
