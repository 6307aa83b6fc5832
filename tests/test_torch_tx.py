"""The port's block data hash and mempool tx keys against the JAX
package's, on the CPU.

- ``types/tx.py``: ``Txs.hash``, ``proof(i).validate``, ``keys`` and
  ``index`` against the JAX package's ``Txs`` on seeded ragged
  transactions (lengths at the one/two/three-block edges of a leaf with
  its 0x00 prefix and of a bare tx key: 54, 55, 56, 63, 64, 119, 120 and
  156 bytes, and the empty tx), before and after mutating a list whose
  root and proofs are cached; at the default merkle threshold (hashlib)
  and with it lowered to 2 on device="cpu" (every root through the plain
  versions of the leaf and tree kernels), and at the engine's 1,024-leaf
  threshold itself.
- ``Data``: encode / decode round trips, the bytes and the hash equal the
  JAX package's.
- ``ingest/hashing.py``: ``TxKeyHasher.keys`` / ``keys_or_host`` against
  ``host_keys`` and the JAX hasher's counters on the cases of
  tests/test_ingest.py (ragged and uniform rows, the threshold, a row over
  33 blocks), ``pack_msg_blocks`` against the JAX packer's rows, a
  router's split, and a failing launch that raises. The JAX hasher's
  programs are called eagerly (a jit of them compiles for minutes on a
  CPU). Its breaker and cold-bucket cases (tests/test_ingest.py
  ``test_txkey_hasher_runtime_failure_trips_breaker``,
  ``test_txkey_hasher_cold_bucket_falls_back``) have no counterpart: the
  port keeps no buckets, background compiles or breaker, and a failed
  launch raises instead of falling back to hashlib.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.ingest import hashing as jhashing
from tendermint_tpu.ops import sha256 as jsha
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import tx as jtx
from tendermint_tpu_torch import Data, DeviceTopology, MeshRouter, TxKeyHasher, Txs
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.ingest import hashing
from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.types import tx as ptx

EDGES = (0, 54, 55, 56, 63, 64, 119, 120, 156)


def ragged_txs(seed: int, n: int, lengths=EDGES):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.choice(lengths, n)]


@pytest.fixture
def engine(monkeypatch):
    """Every root of two or more txs through the MerkleHasher on the CPU."""
    monkeypatch.setattr(merkle, "DEVICE_THRESHOLD", 2)


@pytest.fixture
def eager_jax_hasher(monkeypatch):
    """The JAX TxKeyHasher with its programs called eagerly, not jitted."""
    monkeypatch.setattr(jhashing, "_jitted", (jsha.leaf_block_state, jsha.leaf_block_update))


def check_txs(items, device="cpu"):
    """The port's Txs against the JAX package's: root, every proof, keys."""
    port, ref = Txs(items), jtx.Txs(items)
    root = port.hash(device=device)
    assert root == ref.hash()
    for i in range(len(items)):
        p = port.proof(i, device=device)
        assert p.root_hash == root and p.validate(root) is None
        assert p.proof.aunts == ref.proof(i).proof.aunts
        assert p.validate(hashlib.sha256(b"other").digest()) == "proof matches different data hash"
    assert port.keys() == ref.keys() == [hashlib.sha256(t).digest() for t in items]
    assert [port.index(t) for t in items[:5]] == [ref.index(t) for t in items[:5]]
    return port, ref


@pytest.mark.parametrize("route", ["hashlib", "engine"])
@pytest.mark.parametrize("n", [1, 2, 9, 33])
def test_txs_match_jax(request, route, n):
    if route == "engine":
        request.getfixturevalue("engine")
    items = ragged_txs(n, n)
    items[: min(n, len(EDGES))] = [bytes([k % 251]) * k for k in EDGES[: min(n, len(EDGES))]]
    check_txs(items)


def test_mutation_after_caching(engine):
    items = ragged_txs(5, 12)
    port, ref = check_txs(items)
    for mutate in (lambda t: t.__setitem__(3, b"x" * 120), lambda t: t.reverse(), lambda t: t.sort(),
                   lambda t: t.insert(0, b""), lambda t: t.pop(), lambda t: t.remove(t[2]),
                   lambda t: t.__delitem__(1)):
        mutate(port)
        mutate(ref)
        assert port.hash(device="cpu") == ref.hash()
        assert port.proof(0, device="cpu").proof.aunts == ref.proof(0).proof.aunts
        assert port.keys() == ref.keys()
    assert Txs().hash() == jtx.Txs().hash() == hashlib.sha256(b"").digest()


@pytest.mark.parametrize("n", [1023, 1024])
def test_the_engine_threshold(n):
    """1,023 txs go to hashlib, 1,024 to the merkle engine (here its plain
    versions on the CPU): the same root and proofs as the JAX package's."""
    items = ragged_txs(n, n, lengths=(1, 55, 156, 300))
    port, ref = Txs(items), jtx.Txs(items)
    root = port.hash(device="cpu")
    assert root == ref.hash()
    for i in (0, 511, n - 1):
        p = port.proof(i, device="cpu")
        assert p.proof.aunts == ref.proof(i).proof.aunts and p.validate(root) is None


def test_tx_hash_and_proof_rejects_a_wrong_tx(engine):
    items = ragged_txs(3, 7)
    port = Txs(items)
    assert ptx.tx_hash(items[2]) == jtx.tx_hash(items[2])
    p = port.proof(4, device="cpu")
    p.data = p.data + b"!"
    assert p.validate(port.hash()) == "leaf hash mismatch"


@pytest.mark.parametrize("n", [0, 1, 3, 40])
def test_data_round_trip_and_hash(engine, n):
    items = ragged_txs(40 + n, n)
    port, ref = Data(txs=Txs(items)), jblock.Data(txs=jtx.Txs(items))
    enc = port.encode()
    assert enc == ref.encode()
    back = Data.decode(enc)
    assert list(back.txs) == items and isinstance(back.txs, Txs)
    assert port.hash(device="cpu") == ref.hash() == back.hash(device="cpu")


# -- the tx-key hasher ---------------------------------------------------------


@pytest.mark.parametrize("lengths", ["ragged", "uniform", "with_empty"])
def test_pack_msg_blocks_matches_jax(lengths):
    items = {"ragged": ragged_txs(1, 30, EDGES + (1000,)), "uniform": [b"\x07" * 156] * 9,
             "with_empty": [b"", b"", b"a" * 64]}[lengths]
    blocks, offsets, counts = hashing.pack_msg_blocks(items)
    nb = (max(map(len, items)) + 72) // 64
    jblocks, jcounts = jhashing.pack_msg_blocks(items, len(items), nb)
    np.testing.assert_array_equal(counts, jcounts)
    for r in range(len(items)):
        np.testing.assert_array_equal(blocks[offsets[r]:offsets[r] + counts[r]], jblocks[r, :counts[r]])
    assert blocks.shape[0] == counts.sum()


def test_keys_match_host_keys_and_jax_counters(eager_jax_hasher):
    """tests/test_ingest.py test_txkey_hasher_bit_identical_ragged on both
    hashers: ragged rows across every block edge up to 3 blocks, then the
    uniform payments shape."""
    import random

    rng = random.Random(7)
    items = [bytes(rng.randrange(256) for _ in range(rng.choice(EDGES[:1] + (1,) + EDGES[1:])))
             for _ in range(60)]
    uni = [bytes([i % 256]) * 156 for i in range(33)]
    port, ref = TxKeyHasher("cpu"), jhashing.TxKeyHasher(block_on_compile=True)
    for bundle in (items, uni, []):
        assert port.keys(bundle) == ref.keys(bundle) == jhashing.host_keys(bundle) == hashing.host_keys(bundle)
    assert port.stats() == ref.stats()
    assert port.stats()["hash_device_rows"] == 93 and port.stats()["hash_device_bundles"] == 2


def test_threshold_and_shape_routing_match_jax():
    """tests/test_ingest.py test_txkey_hasher_threshold_and_fallback: below
    the threshold to hashlib; rows over 33 blocks and bundles over 65,536
    rows declined by keys (counted as shape fallbacks), then hashlib."""
    port, ref = TxKeyHasher("cpu"), jhashing.TxKeyHasher(block_on_compile=True)
    small = [b"abc", b"def"]
    big = [b"x" * (64 * 40)] * 70
    for h in (port, ref):
        assert h.keys_or_host(small, threshold=64) == hashing.host_keys(small)
        assert h.keys(big) is None
        assert h.keys_or_host(big, threshold=1) == hashing.host_keys(big)
    assert port.stats() == ref.stats()
    assert port.stats()["hash_fallback_shape"] == 2 and port.stats()["hash_host_rows"] == 72
    edge = [b"y" * (33 * 64 - 9)]  # 33 blocks: the largest kept on the device
    assert port.keys(edge) == hashing.host_keys(edge) and port.keys([b"y" * (33 * 64 - 8)]) is None
    wide = [b""] * (hashing.MAX_BUCKET + 1)
    assert port.keys(wide) is None and port.stats()["hash_fallback_shape"] == 4


def test_keys_through_a_router():
    """With a router the bundle's rows split over its devices, a launch
    each slot; the keys equal hashlib's."""
    items = ragged_txs(21, 50, EDGES + (700,))
    r = MeshRouter(DeviceTopology(["cpu"] * 3), min_rows=2)
    h = TxKeyHasher("cpu", router=r)
    assert h.keys_or_host(items, threshold=1) == hashing.host_keys(items)
    st = r.stats()
    assert st["collective_bundles"] == 1 and st["shard_failures"] == 0 and sum(st["device_rows"]) == 50
    assert h.stats()["hash_device_rows"] == 50


def test_a_failed_launch_raises(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("sha256_leaf_blocks launch: CUDA error")

    monkeypatch.setattr(sha256, "leaf_block_states", fail)
    h = TxKeyHasher("cpu")
    with pytest.raises(RuntimeError):
        h.keys_or_host([b"a" * 10] * 20, threshold=1)
    assert h.stats()["hash_host_rows"] == 0
