"""The port's per-valset tabled path (tendermint_tpu_torch/ops) against
the JAX package's tabled programs, on the CPU.

One validator set of 16 keys and 16 signature rows, made from a numpy
seed with the adversarial cases (an undecodable key among them), their
messages two templates with per-row timestamps. Each JAX program is
``jax.jit``-ed once, at one shape: the table build, the sign-bytes
materialisation, the gathered tabled prepare, the tabled scan and the
blocked finish. The three index patterns (identity, reversed, repeats
with gaps) reuse those compilations with other ``idx`` values; the JAX
package's own tests hold its dense and sharded scans equal to the
gathered one. The port's wrappers get CPU tensors, so they run the plain
versions. This is integer arithmetic: every seam must match exactly,
compared as bytes of the canonical field values (all 16 x 16 x 8 table
entries, garbage key included), digits and flags as they are.
"""

import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import curve as jcurve
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import field as jfield
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ted
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ref_ed25519 as ref
from tendermint_tpu_torch.ops.ed25519_host import HostEd25519
from tests.torch_port_helpers import stack, templated_rows

N = 16
PATTERNS = {
    "identity": np.arange(N, dtype=np.int32),
    "reversed": np.arange(N, dtype=np.int32)[::-1].copy(),
    "repeats": np.array([3, 3, 0, 15, 7, 6, 6, 2, 9, 9, 9, 12, 1, 5, 4, 13], dtype=np.int32),
}


def _bytes_jax(limbs) -> np.ndarray:
    """(..., 20) JAX limbs -> (..., 32) uint8, the canonical encoding."""
    a = np.asarray(limbs)
    flat = a.reshape(-1, a.shape[-1])
    out = np.frombuffer(b"".join(jfield.from_limbs(r).to_bytes(32, "little") for r in flat), dtype=np.uint8)
    return out.reshape(*a.shape[:-1], 32)


def _bytes_port(limbs: torch.Tensor) -> np.ndarray:
    return F.to_bytes(limbs.to(torch.int64)).numpy()


def _port_limbs(jax_limbs) -> torch.Tensor:
    """JAX (..., 20) limbs -> the port's (..., 10) int32 limbs, same values."""
    a = np.asarray(jax_limbs)
    flat = [F.to_limbs(jfield.from_limbs(r)) for r in a.reshape(-1, a.shape[-1])]
    return torch.tensor(flat, dtype=torch.int32).reshape(*a.shape[:-1], 10)


@pytest.fixture(scope="module")
def data():
    rows, want, templates, tmpl_idx, ts8 = templated_rows(seed=4040)
    return dict(pk=stack(rows, 0), msg=stack(rows, 1), sig=stack(rows, 2), want=want,
                templates=templates, tmpl_idx=tmpl_idx, ts8=ts8)


@pytest.fixture(scope="module")
def jax_tables(data):
    tables, a_ok = jax.jit(jed.build_valset_tables)(data["pk"])
    return np.asarray(tables), np.asarray(a_ok)


@pytest.fixture(scope="module")
def port_tables(data):
    return ted.build_valset_tables(torch.from_numpy(data["pk"]))


@pytest.fixture(scope="module")
def jax_rows(data, jax_tables):
    """Per pattern: the JAX programs' outputs on rows idx (one compile
    each, shared by the patterns)."""
    mat = jax.jit(jed.materialize_sign_bytes)
    prep = jax.jit(jed.verify_stage_prepare_tabled_gathered)
    scan = jax.jit(jed.verify_stage_scan_tabled)
    fin = jax.jit(jed.verify_stage_finish_blocked)
    tables, a_ok = (jnp.asarray(t) for t in jax_tables)
    out = {}
    for name, idx in PATTERNS.items():
        msgs = mat(data["templates"], data["tmpl_idx"][idx], data["ts8"][idx])
        sigs = jnp.asarray(data["sig"][idx])
        sd8, kd, s_ok = prep(jnp.asarray(data["pk"]), jnp.asarray(idx), msgs, sigs)
        px, py, pz, pt, row_ok = scan(sd8, kd, tables, a_ok, jnp.asarray(idx))
        ok = fin(px, py, pz, pt, sigs, row_ok, s_ok)
        out[name] = {k: np.array(v) for k, v in dict(
            msgs=msgs, sd8=sd8, kd=kd, s_ok=s_ok, x=px, y=py, z=pz, row_ok=row_ok, ok=ok).items()}
    return out


def _port_source(data, idx, templated: bool):
    src = {"idx": torch.from_numpy(idx)}
    if templated:
        src.update(templates=torch.from_numpy(data["templates"]),
                   tmpl_idx=torch.from_numpy(data["tmpl_idx"][idx]), ts8=torch.from_numpy(data["ts8"][idx]))
    else:
        src["msgs"] = torch.from_numpy(data["msg"][idx])
    return src


def test_tables_match_jax(jax_tables, port_tables):
    """Every entry of every key's tables, the undecodable key's garbage
    point included, and a_ok."""
    tables, a_ok = jax_tables
    ptables, pa_ok = port_tables
    assert ptables.shape == (N, 16, 8, 3, 10) and ptables.dtype == torch.int32
    want = _bytes_jax(tables.reshape(N, 16, 8, 3, 20))
    np.testing.assert_array_equal(_bytes_port(ptables), want)
    np.testing.assert_array_equal(pa_ok.numpy(), a_ok)
    assert not a_ok[5] and a_ok.sum() == N - 1


def test_convert_valset_tables(jax_tables, port_tables):
    tables, a_ok = convert.valset_tables(*jax_tables)
    assert tables.shape == (N, 16, 8, 3, 10) and tables.dtype == torch.int32
    np.testing.assert_array_equal(_bytes_port(tables), _bytes_port(port_tables[0]))
    np.testing.assert_array_equal(a_ok.numpy(), port_tables[1].numpy())
    with pytest.raises(ValueError):
        convert.valset_tables(jax_tables[0][..., :59], jax_tables[1])


def test_materialize_sign_bytes_matches_jax(data, jax_rows):
    for name, idx in PATTERNS.items():
        got = ted.materialize_sign_bytes(torch.from_numpy(data["templates"]),
                                         torch.from_numpy(data["tmpl_idx"][idx]), torch.from_numpy(data["ts8"][idx]))
        np.testing.assert_array_equal(got.numpy(), jax_rows[name]["msgs"])
        np.testing.assert_array_equal(got.numpy(), data["msg"][idx])


@pytest.mark.parametrize("templated", [True, False], ids=["templates", "matrix"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_prepare_tabled_matches_jax(data, jax_rows, pattern, templated):
    idx = PATTERNS[pattern]
    sd8, kd, s_ok = ted.verify_stage_prepare_tabled(
        torch.from_numpy(data["pk"]), torch.from_numpy(data["sig"][idx]), **_port_source(data, idx, templated))
    want = jax_rows[pattern]
    assert sd8.dtype == torch.int8 and kd.dtype == torch.int8
    np.testing.assert_array_equal(sd8.numpy().astype(np.int32), want["sd8"])
    np.testing.assert_array_equal(kd.numpy().astype(np.int32), want["kd"])
    np.testing.assert_array_equal(s_ok.numpy(), want["s_ok"])


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_scan_tabled_matches_jax(jax_tables, port_tables, jax_rows, pattern):
    """The port's scan on the JAX prepare's digits, with its own tables and
    with the JAX tables carried across: the same projective point (X, Y,
    Z as field values; T is left zero by both) and a_ok of each row."""
    want = jax_rows[pattern]
    idx = torch.from_numpy(PATTERNS[pattern])
    sd8 = torch.from_numpy(want["sd8"].astype(np.int8))
    kd = torch.from_numpy(want["kd"].astype(np.int8))
    for tables, a_ok in (port_tables, convert.valset_tables(*jax_tables)):
        point, row_ok = ted.verify_stage_scan_tabled(sd8, kd, tables, a_ok, idx)
        for c, key in enumerate("xyz"):
            np.testing.assert_array_equal(_bytes_port(point[:, c]), _bytes_jax(want[key]))
        assert not point[:, 3].any()
        np.testing.assert_array_equal(row_ok.numpy(), want["row_ok"])


@pytest.fixture(scope="module")
def host():
    """The ed25519 kernels' headers built as host C++ (g++), once."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of the ed25519 headers needs a C++ compiler")
    with tempfile.TemporaryDirectory() as d:
        yield HostEd25519(d)


@pytest.mark.parametrize("lanes", (2, 4, 8))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_scan_tabled_row_on_lanes_matches_jax(jax_tables, jax_rows, host, lanes, pattern):
    """ed25519_scan_tabled's row on G lanes (the host build of its
    formulas, ge25519_lanes.cuh scan_tabled_row) against the JAX package's
    verify_stage_scan_tabled on the JAX prepare's digits and the JAX
    tables carried across: X, Y, Z as field values, T zero."""
    want = jax_rows[pattern]
    tables, _a_ok = convert.valset_tables(*jax_tables)
    idx = PATTERNS[pattern]
    got = np.stack([host.scan_tabled_row(want["sd8"][r].astype(np.int8), want["kd"][r].astype(np.int8),
                                         tables[int(idx[r])].numpy(), lanes) for r in range(N)])
    assert (got[:, 3] == 0).all()
    for c, key in enumerate("xyz"):
        np.testing.assert_array_equal(_bytes_port(torch.from_numpy(got[:, c])), _bytes_jax(want[key]))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_finish_matches_finish_blocked(data, jax_rows, pattern):
    """ed25519_finish's plain version on the JAX scan's point gives
    verify_stage_finish_blocked's verdicts, which are the oracle's."""
    want = jax_rows[pattern]
    idx = PATTERNS[pattern]
    point = torch.stack([_port_limbs(want[k]) for k in "xyz"] + [torch.zeros((N, 10), dtype=torch.int32)], dim=1)
    ok = ted.verify_stage_finish(point, torch.from_numpy(data["sig"][idx]), torch.from_numpy(want["row_ok"]),
                                 torch.from_numpy(want["s_ok"]))
    np.testing.assert_array_equal(ok.numpy(), want["ok"])
    assert ok.tolist() == [data["want"][i] for i in idx]


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_tabled_chain_matches_oracle(data, port_tables, pattern):
    idx = PATTERNS[pattern]
    pk = torch.from_numpy(data["pk"])
    ok = ted.verify_tabled(*port_tables, pk, torch.from_numpy(data["sig"][idx]), **_port_source(data, idx, True))
    assert ok.tolist() == [data["want"][i] for i in idx]
    if pattern == "identity":  # row r is validator r: no index at all
        src = _port_source(data, idx, True)
        del src["idx"]
        assert ted.verify_tabled(*port_tables, pk, torch.from_numpy(data["sig"]), **src).tolist() == data["want"]


def test_base_comb_matches_jax():
    """The port's comb (from its own oracle copy) against the JAX
    package's host-built comb, entry by entry."""
    want = jcurve.base_comb256()  # (32, 128, 3, 20)
    got = torch.tensor(curve.base_comb256_limbs(), dtype=torch.int32)
    np.testing.assert_array_equal(_bytes_port(got), _bytes_jax(want))


def test_signed_digits_base256_recompose():
    rng = np.random.default_rng(9)
    vals = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(30)] + [0, ref.L - 1, 2**252, 128, 255]
    b = torch.tensor([list(v.to_bytes(32, "little")) for v in vals], dtype=torch.uint8)
    d = curve.signed_digits_base256(b)
    assert int(d.min()) >= -128 and int(d.max()) < 128
    assert [sum(int(x) << (8 * i) for i, x in enumerate(row)) for row in d] == vals


def test_split_tables_zero_z_entry():
    """An entry whose Z is 0 (only a garbage point can give one) comes
    out as zeros and leaves the rest of its row's batch inversion intact:
    every entry equals the same formulas run on Python integers."""
    P = F.P
    x0, y0, t0 = 5, 7, 11
    q = curve.Point(*(torch.tensor([F.to_limbs(c)]) for c in (x0, y0, 0, t0)))
    got = curve.build_split_tables(q)[0]  # (16, 8, 3, 10)
    qm, want = (x0, y0, 0, t0), []
    for m in range(curve.SPLITS):
        acc = qm
        for i in range(curve.TBL):
            want.append(acc)
            acc = ref.pt_add(acc, qm)
        for _ in range(4 * curve.SPLIT_W):
            qm = ref.pt_double(qm)
    assert want[0][2] % P == 0 and all(e[2] % P for e in want[1:])
    for e, (X, Y, Z, _T) in enumerate(want):
        zi = pow(Z, P - 2, P)
        x, y = X * zi % P, Y * zi % P
        vals = [F.from_limbs(got[e // 8, e % 8, c]) for c in range(3)]
        assert vals == [(y + x) % P, (y - x) % P, 2 * ref.D * x * y % P], e
    assert not any(F.from_limbs(got[0, 0, c]) for c in range(3))


def test_tabled_wrappers_check_their_inputs(data, port_tables):
    before = ted.launches()
    pk = torch.from_numpy(data["pk"])
    sig = torch.from_numpy(data["sig"])
    tables, a_ok = port_tables
    with pytest.raises(TypeError):
        ted.build_valset_tables(pk.to(torch.int32))
    with pytest.raises(ValueError):  # neither source
        ted.verify_stage_prepare_tabled(pk, sig)
    with pytest.raises(ValueError):  # both sources
        ted.verify_stage_prepare_tabled(pk, sig, msgs=torch.from_numpy(data["msg"]),
                                        templates=torch.from_numpy(data["templates"]))
    with pytest.raises(ValueError):  # templates too narrow for the timestamp
        ted.verify_stage_prepare_tabled(pk, sig, templates=torch.zeros((2, 100), dtype=torch.uint8),
                                        tmpl_idx=torch.zeros(N, dtype=torch.int32), ts8=torch.zeros((N, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ted.verify_stage_prepare_tabled(pk, sig, msgs=torch.from_numpy(data["msg"]), idx=torch.zeros(N, dtype=torch.int64))
    with pytest.raises(ValueError):  # more rows than validators and no index
        ted.verify_stage_scan_tabled(torch.zeros((N + 1, 32), dtype=torch.int8), torch.zeros((N + 1, 64), dtype=torch.int8),
                                     tables, a_ok)
    with pytest.raises(ValueError):
        ted.verify_stage_scan_tabled(torch.zeros((N, 32), dtype=torch.int8), torch.zeros((N, 64), dtype=torch.int8),
                                     tables[:, :8].contiguous(), a_ok)
    assert ted.launches() == before  # a refused call launches nothing


@pytest.mark.cuda
def test_tabled_kernels_match_plain_versions_on_card(data):
    """Each tabled kernel against its plain version on the same inputs
    (the kernels have no CPU mode; chip_smoke.py does this at scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    pk = torch.from_numpy(data["pk"]).to(dev)
    tables, a_ok = ted.build_valset_tables(pk)
    pt, pa = ted.build_tables_plain(pk)
    assert torch.equal(F.to_bytes(tables.long()), F.to_bytes(pt.long())) and torch.equal(a_ok, pa)
    for name, idx in PATTERNS.items():
        sig = torch.from_numpy(data["sig"][idx]).to(dev)
        src = {k: v.to(dev) for k, v in _port_source(data, idx, True).items()}
        prep = ted.verify_stage_prepare_tabled(pk, sig, **src)
        plain = ted.prepare_tabled_plain(pk, sig, **src)
        assert all(torch.equal(a, b) for a, b in zip(prep, plain)), name
        point, row_ok = ted.verify_stage_scan_tabled(prep[0], prep[1], tables, a_ok, src["idx"])
        ppoint, prow_ok = ted.scan_tabled_plain(prep[0], prep[1], tables, a_ok, src["idx"])
        assert torch.equal(F.to_bytes(point.long()), F.to_bytes(ppoint.long())) and torch.equal(row_ok, prow_ok)
        ok = ted.verify_stage_finish(point, sig, row_ok, prep[2])
        assert ok.tolist() == [data["want"][i] for i in idx], name
