"""The port's ed25519 stages (tendermint_tpu_torch/ops) against the JAX
package's, on the CPU.

The same 16 rows, made from a numpy seed and including the adversarial
cases, go through ``jax.jit`` of each JAX stage (compiled once, at one
shape) and through the port's wrapper on CPU tensors, which runs the
plain PyTorch version. This is integer arithmetic, so every seam must
match exactly: the signed digits, a_ok and s_ok, the coordinates of -A
and of the scan's point (canonical values mod p), the verdicts and the
tally. The primitives are also held against Python integers and hashlib.
"""

import hashlib
import os
import subprocess
import sys

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
from tendermint_tpu_torch.ops import sc
from tendermint_tpu_torch.ops.sha512 import sha512
from tests.torch_port_helpers import adversarial_rows, stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values_jax(limbs) -> np.ndarray:
    """(..., 20) JAX limbs -> object array of their values mod p."""
    a = np.asarray(limbs)
    flat = a.reshape(-1, a.shape[-1])
    return np.array([jfield.from_limbs(r) for r in flat], dtype=object).reshape(a.shape[:-1])


def _values_port(limbs: torch.Tensor) -> np.ndarray:
    a = limbs.numpy()
    flat = a.reshape(-1, a.shape[-1])
    return np.array([F.from_limbs(r) for r in flat], dtype=object).reshape(a.shape[:-1])


def _encode_values(x, y, z) -> bytes:
    """The compressed encoding of (X : Y : Z), from Python integers."""
    zi = pow(int(z), F.P - 2, F.P)
    ax, ay = int(x) * zi % F.P, int(y) * zi % F.P
    return (ay | ((ax & 1) << 255)).to_bytes(32, "little")


def _port_limbs(values: np.ndarray) -> torch.Tensor:
    """Values mod p -> the port's (..., 10) int32 limbs."""
    flat = [F.to_limbs(int(v)) for v in values.reshape(-1)]
    return torch.tensor(flat, dtype=torch.int32).reshape(*values.shape, 10)


@pytest.fixture(scope="module")
def batch():
    rows, want = adversarial_rows(seed=20261017)
    return stack(rows, 0), stack(rows, 1), stack(rows, 2), want


@pytest.fixture(scope="module")
def jax_prepare(batch):
    pk, msg, sig, _ = batch
    return [np.array(x) for x in jax.jit(jed.verify_stage_prepare)(pk, msg, sig)]


@pytest.fixture(scope="module")
def port_prepare(batch):
    pk, msg, sig, _ = batch
    return ted.verify_stage_prepare(torch.from_numpy(pk), torch.from_numpy(msg), torch.from_numpy(sig))


@pytest.fixture(scope="module")
def jax_scan(jax_prepare):
    return [np.array(x) for x in jax.jit(jed.verify_stage_scan)(*jax_prepare[:6])]


def test_prepare_digits_and_checks_match_jax(jax_prepare, port_prepare, batch):
    sd, kd, _nx, _ny, _nz, _nt, a_ok, s_ok = jax_prepare
    psd, pkd, _neg_a, pa_ok, ps_ok = port_prepare
    np.testing.assert_array_equal(psd.numpy().astype(np.int32), sd)
    np.testing.assert_array_equal(pkd.numpy().astype(np.int32), kd)
    np.testing.assert_array_equal(pa_ok.numpy(), a_ok)
    np.testing.assert_array_equal(ps_ok.numpy(), s_ok)
    # the adversarial rows really are what they claim to be
    assert not a_ok[5] and not s_ok[4] and a_ok[6] and a_ok[7]


def test_prepare_neg_a_matches_jax(jax_prepare, port_prepare):
    """-A coordinate by coordinate, also where decompression failed (the
    same formulas leave the same garbage point)."""
    jax_coords = np.stack([_values_jax(c) for c in jax_prepare[2:6]], axis=1)
    np.testing.assert_array_equal(_values_port(port_prepare[2]), jax_coords)
    neg_a = port_prepare[2].to(torch.int64)
    enc = curve.encode(curve.Point(*(neg_a[:, i] for i in range(4))))
    assert [bytes(r.tolist()) for r in enc] == [_encode_values(*c[:3]) for c in jax_coords]


def test_scan_point_matches_jax(jax_prepare, jax_scan):
    """The port's scan on the JAX stage's own inputs gives the same
    projective point (X, Y, Z; T is left zero by both)."""
    neg_a = _port_limbs(np.stack([_values_jax(c) for c in jax_prepare[2:6]], axis=1))
    sd = torch.from_numpy(jax_prepare[0].astype(np.int8))
    kd = torch.from_numpy(jax_prepare[1].astype(np.int8))
    point = ted.verify_stage_scan(sd, kd, neg_a)
    want = np.stack([_values_jax(c) for c in jax_scan], axis=1)
    np.testing.assert_array_equal(_values_port(point), want)
    p64 = point.to(torch.int64)
    enc = curve.encode(curve.Point(*(p64[:, i] for i in range(4))))
    assert [bytes(r.tolist()) for r in enc] == [_encode_values(*c[:3]) for c in want]


def test_finish_verdicts_and_tally_match_jax(jax_prepare, jax_scan, batch):
    _pk, _msg, sig, want = batch
    n = sig.shape[0]
    rng = np.random.default_rng(5)
    powers = rng.integers(1, 1 << 40, n, dtype=np.int64)
    counted = rng.random(n) < 0.7
    a_ok, s_ok = jax_prepare[6], jax_prepare[7]
    ok, chunks = jax.jit(jed.verify_stage_finish_tally)(
        *jax_scan, sig, a_ok, s_ok, jnp.asarray(jed.split_powers(powers)), counted
    )
    point = _port_limbs(np.stack([_values_jax(c) for c in jax_scan], axis=1))
    pok, tally = ted.verify_stage_finish(
        point, torch.from_numpy(sig), torch.from_numpy(a_ok), torch.from_numpy(s_ok),
        tally=True, powers=torch.from_numpy(powers), counted=torch.from_numpy(counted),
    )
    np.testing.assert_array_equal(pok.numpy(), np.asarray(ok))
    assert int(tally) == jed.combine_power_chunks(np.asarray(chunks))
    assert pok.tolist() == want
    plain_ok = ted.verify_stage_finish(point, torch.from_numpy(sig), torch.from_numpy(a_ok), torch.from_numpy(s_ok))
    assert plain_ok.tolist() == want


def test_chained_stages_match_oracle(port_prepare, batch):
    _pk, _msg, sig, want = batch
    sd, kd, neg_a, a_ok, s_ok = port_prepare
    ok = ted.verify_stage_finish(ted.verify_stage_scan(sd, kd, neg_a), torch.from_numpy(sig), a_ok, s_ok)
    assert ok.tolist() == want


def test_rfc8032_vector_1():
    pk = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
    sig = bytes.fromhex(
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
    )
    pks = torch.tensor([list(pk)] * 2, dtype=torch.uint8)
    sigs = torch.tensor([list(sig), list(sig[:32] + bytes(32))], dtype=torch.uint8)
    ok = ted.verify(pks, torch.zeros((2, 0), dtype=torch.uint8), sigs)
    assert ok.tolist() == [True, False]


@pytest.mark.parametrize("length", [0, 111, 112, 224, 300])
def test_sha512_matches_hashlib(length):
    msgs = np.random.default_rng(length).integers(0, 256, (4, length), dtype=np.uint8)
    got = sha512(torch.from_numpy(msgs)).numpy()
    for row, digest in zip(msgs, got):
        assert digest.tobytes() == hashlib.sha512(row.tobytes()).digest()


def test_sc_reduce_and_canonical_match_ints():
    rng = np.random.default_rng(11)
    vals = [int.from_bytes(rng.bytes(64), "little") for _ in range(64)]
    vals += [0, sc.L, sc.L - 1, 2**512 - 1, sc.L * 2**259 - 1]
    digests = torch.tensor([list(v.to_bytes(64, "little")) for v in vals], dtype=torch.uint8)
    got = [int.from_bytes(bytes(r.tolist()), "little") for r in sc.reduce512(digests)]
    assert got == [v % sc.L for v in vals]
    ss = [0, sc.L - 1, sc.L, sc.L + 1, 2**256 - 1]
    ok = sc.is_canonical(torch.tensor([list(v.to_bytes(32, "little")) for v in ss], dtype=torch.uint8))
    assert ok.tolist() == [v < sc.L for v in ss]


def test_field_ops_match_ints():
    rng = np.random.default_rng(13)
    xs = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(24)] + [0, 1, F.P - 1, F.P - 19]
    ys = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(len(xs))]
    a = torch.tensor([F.to_limbs(x) for x in xs])
    b = torch.tensor([F.to_limbs(y) for y in ys])
    vals = lambda t: [F.from_limbs(r) for r in t]  # noqa: E731
    assert vals(F.mul(a, b)) == [x * y % F.P for x, y in zip(xs, ys)]
    assert vals(F.sub(a, b)) == [(x - y) % F.P for x, y in zip(xs, ys)]
    assert vals(F.invert(a)) == [pow(x, F.P - 2, F.P) for x in xs]
    enc = F.to_bytes(F.sub(a, b))
    assert [int.from_bytes(bytes(r.tolist()), "little") for r in enc] == [(x - y) % F.P for x, y in zip(xs, ys)]
    # unreduced inputs: y >= p and the masked top bit
    raw = [(F.P + 5).to_bytes(32, "little"), (2**256 - 1).to_bytes(32, "little")]
    fb = F.from_bytes(torch.tensor([list(r) for r in raw], dtype=torch.uint8))
    assert vals(fb) == [5, (2**255 - 1) % F.P]


def test_wrappers_check_their_inputs():
    before = ted.launches()
    pk = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        ted.verify_stage_prepare(pk.to(torch.int32), torch.zeros((2, 4), dtype=torch.uint8), torch.zeros((2, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ted.verify_stage_prepare(pk, torch.zeros((3, 4), dtype=torch.uint8), torch.zeros((2, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ted.verify_stage_scan(torch.zeros((64, 2), dtype=torch.int8).t(), torch.zeros((2, 64), dtype=torch.int8),
                              torch.zeros((2, 4, 10), dtype=torch.int32))
    ok = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        ted.verify_stage_finish(torch.zeros((2, 4, 10), dtype=torch.int32), torch.zeros((2, 64), dtype=torch.uint8),
                                ok, ok, powers=torch.zeros(2, dtype=torch.int64))
    assert ted.launches() == before  # a refused call launches nothing


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, tendermint_tpu_torch as t\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tendermint_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        t.resolve_device()\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "    else:\n"
        "        raise AssertionError('resolve_device() did not raise without CUDA')\n"
        "    assert t.resolve_device('cpu').type == 'cpu'\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(batch):
    """Each CUDA kernel against its plain version on the same inputs
    (the kernels have no CPU mode; chip_smoke.py does this at scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pk, msg, sig, want = batch
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev) for a in (pk, msg, sig)]
    prep = ted.verify_stage_prepare(*t)
    plain = ted.prepare_plain(*t)
    for a, b in zip(prep[:2] + prep[3:], plain[:2] + plain[3:]):
        assert torch.equal(a, b)
    assert torch.equal(F.to_bytes(prep[2].long()), F.to_bytes(plain[2].long()))
    point = ted.verify_stage_scan(*prep[:3])
    assert torch.equal(F.to_bytes(point.long()), F.to_bytes(ted.scan_plain(*prep[:3]).long()))
    ok = ted.verify_stage_finish(point, t[2], prep[3], prep[4])
    assert ok.tolist() == want
