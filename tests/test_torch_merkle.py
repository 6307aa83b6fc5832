"""The port's SHA-256 merkle engine against the JAX package's, on the CPU.

- The plain versions of the two kernels (``ops/sha256.py``) against the
  JAX SHA-256 programs, called eagerly (a jit of them compiles for
  minutes on a CPU), bit-identical at the (8, N) state seam; and the
  port's ``sha256`` against the JAX program of that name.
- Roots, proofs and aunts of the port's ``crypto/merkle.py``, with the
  device threshold lowered to 2 and device="cpu" (so every tree runs
  through the plain versions of the leaf and tree kernels), and at the
  default threshold (hashlib), against the JAX package's host path; the
  ``MerkleHasher``'s ``root`` and ``tree`` against it at widths around
  the tree kernel's chunks, one leaf and one tree call a root.
- ``ValidatorSet.hash`` and ``Commit.hash`` against the JAX objects'.

Inputs come from numpy seeds; the card-only test holds each kernel
against its plain version and skips without a GPU.
"""

import copy
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.codec.signbytes import PRECOMMIT_TYPE, canonical_sign_bytes
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto.keys import Ed25519PrivKey
from tendermint_tpu.ops import sha256 as jsha
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
)
from tendermint_tpu.types.validator import Validator
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.models import hasher
from tendermint_tpu_torch.ops import sha256


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the kernels' plain versions."""
    calls = {"leaf": 0, "tree": 0}
    leaf, tree = sha256.leaf_blocks_plain, sha256.merkle_tree_plain

    def count_leaf(*a):
        calls["leaf"] += 1
        return leaf(*a)

    def count_tree(*a):
        calls["tree"] += 1
        return tree(*a)

    monkeypatch.setattr(sha256, "leaf_blocks_plain", count_leaf)
    monkeypatch.setattr(sha256, "merkle_tree_plain", count_tree)
    return calls


@pytest.fixture
def engine(monkeypatch, counted):
    """Every tree of two or more leaves through the MerkleHasher, the
    leaves and the whole tree through the kernels' plain versions; counts
    those calls."""
    monkeypatch.setattr(merkle, "DEVICE_THRESHOLD", 2)
    return counted


def ragged_leaves(seed: int, n: int, max_blocks: int = 3):
    """n leaves of random lengths: one to `max_blocks` blocks each with
    the 0x00 prefix and 9 bytes of padding (k blocks hold 64 k - 10)."""
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, 64 * max_blocks - 9, n)]


# -- (a) the plain kernels against the JAX programs ------------------------------


@pytest.mark.parametrize("n", [16, 17])
def test_leaf_blocks_match_jax_leaf_block_state_and_update(n):
    items = ragged_leaves(n, n)
    # one block (the empty leaf), two (55 B: 65 with the prefix and 9
    # of padding) and three (119 B)
    items[:3] = [b"", bytes(55), bytes(119)]
    nb = sha256.leaf_blocks_needed(max(map(len, items)))
    blocks, counts = sha256.pack_leaf_blocks(items, n, nb)
    assert nb == 3 and set(counts.tolist()) == {1, 2, 3}
    st = jsha.leaf_block_state(jnp.asarray(blocks[:, 0]))
    for i in range(1, nb):
        st = jsha.leaf_block_update(st, jnp.asarray(blocks[:, i]), jnp.asarray(counts > i))
    want = np.asarray(st).view(np.int32)
    got = sha256.leaf_block_states(*sha256.dense_to_flat(torch.from_numpy(blocks), torch.from_numpy(counts)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, n)
    np.testing.assert_array_equal(got.numpy(), want)
    digests = sha256.state_to_digests(got.numpy())
    assert [d.tobytes() for d in digests] == [hashlib.sha256(b"\x00" + it).digest() for it in items]


@pytest.mark.parametrize("c,m", [(16, 16), (16, 15), (17, 17), (17, 13)])
def test_inner_level_matches_jax_inner_first_and_tail(c, m):
    rng = np.random.default_rng(100 + c + m)
    level = rng.integers(0, 1 << 32, (8, c), dtype=np.uint64).astype(np.uint32)
    mid = jsha.merkle_inner_first(jnp.asarray(level))
    want = np.asarray(jsha.merkle_inner_tail(mid, jnp.asarray(level), np.int32(m))).view(np.int32)
    flat = sha256.merkle_tree(torch.from_numpy(level.view(np.int32)), m, levels=True)
    assert tuple(flat.shape) == (8, sum(sha256.tree_widths(m)))
    np.testing.assert_array_equal(flat[:, :m].numpy(), level[:, :m].view(np.int32))
    np.testing.assert_array_equal(flat[:, m:m + (m + 1) // 2].numpy(), want[:, : (m + 1) // 2])
    # every level above, and the root alone
    digests = [d.tobytes() for d in sha256.state_to_digests(flat.numpy())]
    assert digests == [d for lv in hasher.host_levels(digests[:m]) for d in lv]
    root = sha256.merkle_tree(torch.from_numpy(level.view(np.int32)), m)
    assert tuple(root.shape) == (8, 1) and torch.equal(root, flat[:, -1:])


@pytest.mark.parametrize("length", [0, 55, 56, 100])
def test_sha256_matches_jax_sha256(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (5, length), dtype=np.uint8)
    want = np.asarray(jsha.sha256(jnp.asarray(msgs))).astype(np.uint8)
    got = sha256.sha256(torch.from_numpy(msgs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert [r.tobytes() for r in got.numpy()] == [hashlib.sha256(r.tobytes()).digest() for r in msgs]


@pytest.mark.parametrize("lengths", ["uniform", "ragged", "with_empty"])
def test_host_packers_match_jax(lengths):
    rng = np.random.default_rng(7)
    if lengths == "uniform":
        items = [rng.bytes(50) for _ in range(9)]
    elif lengths == "ragged":
        items = ragged_leaves(8, 9, max_blocks=5)
    else:
        items = [b""] + [rng.bytes(3) for _ in range(4)] + [b""]
    nb = sha256.leaf_blocks_needed(max(map(len, items)))
    assert nb == jsha.leaf_blocks_needed(max(map(len, items)))
    for prefix in (0, 1):
        for got, want in zip(sha256.pack_leaf_blocks(items, 12, nb, prefix),
                             jsha.pack_leaf_blocks(items, 12, nb, prefix)):
            np.testing.assert_array_equal(got, want)
    state = rng.integers(0, 1 << 32, (8, 6), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(sha256.state_to_digests(state), jsha.state_to_digests(state))
    np.testing.assert_array_equal(sha256.state_to_digests(state.view(np.int32)), jsha.state_to_digests(state))
    digests = jsha.state_to_digests(state)
    np.testing.assert_array_equal(sha256.digests_to_state(digests), jsha.digests_to_state(digests))


def test_leaf_over_sixteen_blocks():
    """The JAX engine sends leaves over 16 blocks to the host; the port's
    kernel takes them. A 40-block leaf beside one-block leaves."""
    rng = np.random.default_rng(40)
    items = [rng.bytes(40 * 64 - 73), b"", rng.bytes(54), rng.bytes(55)]
    nb = sha256.leaf_blocks_needed(max(map(len, items)))
    blocks, counts = sha256.pack_leaf_blocks(items, len(items), nb)
    assert nb == 40 and counts.tolist() == [40, 1, 1, 2]
    flat = sha256.dense_to_flat(torch.from_numpy(blocks), torch.from_numpy(counts))
    got = sha256.state_to_digests(sha256.leaf_block_states(*flat).numpy())
    assert [d.tobytes() for d in got] == [hashlib.sha256(b"\x00" + it).digest() for it in items]


def test_flat_leaf_packing_holds_the_leaves_bytes(engine):
    """One long leaf among short ones: the flat buffer holds each leaf's
    own blocks (the dense layout padded 1,023 x 32 B + 1 MiB to 1.07 GB),
    and the tree through it has the same root and aunts as the JAX
    package's host path. The plain leaf version compresses a long leaf
    block by block, so the tree is checked with a 64-block leaf and the
    packing at the full 1 MiB."""
    rng = np.random.default_rng(22)
    short = [rng.bytes(32) for _ in range(1023)]
    blocks, offsets, counts = sha256.pack_leaves(short + [rng.bytes(1 << 20)])
    leaf_bytes = 1023 * 32 + (1 << 20)
    assert blocks.nbytes <= 1.1 * leaf_bytes and counts.tolist()[-1] == 16385
    assert offsets.tolist()[:3] == [0, 1, 2] and offsets[-1] == 1023
    items = short[:200] + [rng.bytes(64 * 64 - 73)] + short[200:300]
    blocks, offsets, counts = sha256.pack_leaves(items)
    assert blocks.shape == (300 + 64, 64)
    root, proofs = merkle.proofs_from_byte_slices(items, device="cpu")
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert root == jroot and [p.aunts for p in proofs] == [p.aunts for p in jproofs]
    assert engine["leaf"] == 1


def test_wrappers_check_their_inputs():
    blocks = torch.zeros((2, 64), dtype=torch.uint8)
    offsets = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError):
        sha256.leaf_block_states(blocks, torch.ones(2, dtype=torch.int64), offsets)
    with pytest.raises(ValueError):
        sha256.leaf_block_states(blocks, torch.ones(3, dtype=torch.int32), offsets)
    with pytest.raises(ValueError):
        sha256.dense_to_flat(torch.zeros((2, 0, 64), dtype=torch.uint8), torch.ones(2, dtype=torch.int32))
    level = torch.zeros((8, 5), dtype=torch.int32)
    for m in (0, 6):
        with pytest.raises(ValueError):
            sha256.merkle_tree(level, m)
    with pytest.raises(TypeError):
        sha256.merkle_tree(level.to(torch.int64), 5)
    # a count past the blocks given is clamped, as in the kernel
    one = sha256.leaf_block_states(*sha256.dense_to_flat(blocks.view(2, 1, 64), torch.tensor([1, 9], dtype=torch.int32)))
    assert torch.equal(one[:, 0], one[:, 1])


# -- (b) roots, proofs and aunts against the JAX package's host path -------------

TREES = {f"n{n}": dict(n=n) for n in (0, 1, 2, 3, 5, 8, 9, 16, 17, 64)}
TREES.update(multi_block_9=dict(n=9, max_blocks=4), multi_block_33=dict(n=33, max_blocks=6),
             forty_block_leaf=dict(n=5, forty=True))


def tree_items(name):
    spec = TREES[name]
    items = ragged_leaves(spec["n"], spec["n"], spec.get("max_blocks", 1))
    if spec.get("forty"):
        items[2] = bytes(range(256)) * 9 + bytes(40 * 64 - 73 - 256 * 9)
    return items


def check_against_jax(items):
    """The port's root, proofs and aunts equal the JAX package's."""
    want_root = jmerkle.hash_from_byte_slices(items)
    want_proot, want_proofs = jmerkle.proofs_from_byte_slices(items)
    assert merkle.hash_from_byte_slices(items, device="cpu") == want_root
    root, proofs = merkle.proofs_from_byte_slices(items, device="cpu")
    assert root == want_proot == want_root
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in proofs] == [
        (p.total, p.index, p.leaf_hash, p.aunts) for p in want_proofs
    ]
    for i, p in enumerate(proofs):
        p.verify(root, items[i])
        assert p.compute_root() == root


@pytest.mark.parametrize("name", sorted(TREES))
def test_roots_proofs_and_aunts_match_jax(engine, name):
    items = tree_items(name)
    check_against_jax(items)
    # trees of two or more leaves ran through the engine: one leaf launch
    # and one tree launch, for the root and for the proofs
    assert engine == ({"leaf": 2, "tree": 2} if len(items) >= 2 else {"leaf": 0, "tree": 0})


@pytest.mark.parametrize("name", sorted(TREES))
def test_host_route_roots_proofs_and_aunts_match_jax(counted, name):
    """At the default threshold every tree below 1,024 leaves is built
    on the host: the same roots, proofs and aunts, and no kernel ran."""
    assert merkle.DEVICE_THRESHOLD == 1024
    check_against_jax(tree_items(name))
    assert counted == {"leaf": 0, "tree": 0}


# widths around the chunks the tree kernel can be compiled with (2B = 64
# to 512 leaves), and 16,385, above (2B)^2 for chunks of 128, where the
# card's top loops in global memory (tests/test_torch_merkle_tree_host.py
# runs that schedule itself at every chunk size, 512 included)
HASHER_N = (1, 2, 3, 5, 127, 128, 129, 1023, 1024, 1025, 16_385)


@pytest.mark.parametrize("n", HASHER_N)
def test_hasher_root_and_tree_match_jax(counted, n):
    """MerkleHasher.root and .tree on the plain versions against the JAX
    package's crypto/merkle.py (hashlib, no jit): the root, every level
    against its host recursion, and the aunts of every proof."""
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(k)) for k in rng.integers(0, 120, n)]
    h = hasher.MerkleHasher("cpu")
    levels = h.tree(items)
    want_root, want_proofs = jmerkle.proofs_from_byte_slices(items)
    assert h.root(items) == levels[-1][0] == want_root == jmerkle.hash_from_byte_slices(items)
    assert [len(lv) for lv in levels] == sha256.tree_widths(n)
    assert levels == hasher.host_levels([hashlib.sha256(b"\x00" + it).digest() for it in items])
    assert merkle._aunts_from_levels(levels) == [p.aunts for p in want_proofs]
    assert counted == {"leaf": 2, "tree": 2}


def test_a_root_at_10000_leaves_is_one_leaf_and_one_tree_call(counted):
    """The engine hashes a 10,000-leaf tree (ValidatorSet.hash's width)
    with one call of each kernel's plain version: no level is left to
    the host."""
    rng = np.random.default_rng(10_000)
    items = [rng.bytes(70) for _ in range(10_000)]
    assert hasher.MerkleHasher("cpu").root(items) == jmerkle.hash_from_byte_slices(items)
    assert counted == {"leaf": 1, "tree": 1}


def test_proof_verify_rejects_a_wrong_leaf(engine):
    items = ragged_leaves(3, 11, 2)
    root, proofs = merkle.proofs_from_byte_slices(items, device="cpu")
    proofs[4].verify(root, items[4])
    with pytest.raises(ValueError, match="leaf hash mismatch"):
        proofs[4].verify(root, items[5])
    with pytest.raises(ValueError, match="proof root mismatch"):
        proofs[4].verify(hashlib.sha256(b"another root").digest(), items[4])
    bad = merkle.SimpleProof(proofs[4].total, proofs[4].index, proofs[4].leaf_hash, proofs[4].aunts[:-1])
    with pytest.raises(ValueError):
        bad.verify(root, items[4])


@pytest.mark.parametrize("n", [1023, 1024])
def test_default_threshold_routes_as_jax(monkeypatch, n):
    """Below 1,024 leaves hashlib, at 1,024 the engine (here its plain
    versions), the same root either way; the engine hashes the whole
    tree in one tree call."""
    assert merkle.DEVICE_THRESHOLD == 1024
    calls = []
    monkeypatch.setattr(sha256, "merkle_tree_plain",
                        lambda lv, m, levels=False, f=sha256.merkle_tree_plain: calls.append(m) or f(lv, m, levels))
    rng = np.random.default_rng(n)
    items = [rng.bytes(50) for _ in range(n)]
    assert merkle.hash_from_byte_slices(items, device="cpu") == jmerkle.hash_from_byte_slices(items)
    assert calls == ([] if n < 1024 else [1024])


def test_no_card_no_fallback():
    """At the threshold, device=None means the card: without one it
    raises rather than answering from the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs the kernels")
    items = [bytes([i % 256, i // 256]) for i in range(merkle.DEVICE_THRESHOLD)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merkle.hash_from_byte_slices(items)
    assert merkle.hash_from_byte_slices(items[:-1]) == jmerkle.hash_from_byte_slices(items[:-1])


# -- (c) ValidatorSet.hash and Commit.hash -----------------------------------------

CHAIN = "merkle-chain"


@pytest.fixture(scope="module")
def jax_set_and_commit():
    rng = np.random.default_rng(64)
    privs = [Ed25519PrivKey.from_secret(f"merkle-val-{i}".encode()) for i in range(64)]
    vs = jvs.ValidatorSet([Validator(p.pub_key(), int(w)) for p, w in zip(privs, rng.integers(1, 1 << 40, 64))])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(rng.bytes(32), PartSetHeader(3, rng.bytes(32)))
    flags = rng.choice([BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL, BLOCK_ID_FLAG_ABSENT], 64, p=[0.7, 0.15, 0.15])
    sigs = []
    for i, (val, flag) in enumerate(zip(vs.validators, flags)):
        if flag == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
            continue
        vb = bid if flag == BLOCK_ID_FLAG_COMMIT else BlockID()
        ts = 1_700_000_000_000_000_000 + 37 * i
        msg = canonical_sign_bytes(PRECOMMIT_TYPE, 5, 0, vb.hash, vb.parts.total, vb.parts.hash, ts, CHAIN)
        sigs.append(CommitSig(int(flag), val.address, ts, by_addr[val.address].sign(msg)))
    return vs, Commit(5, 0, bid, sigs)


def port_objects(vs, commit):
    pubkeys = np.stack([np.frombuffer(v.pub_key.bytes(), dtype=np.uint8) for v in vs.validators])
    powers = np.asarray([v.voting_power for v in vs.validators], dtype=np.int64)
    bid = commit.block_id
    pc = convert.commit(commit.height, commit.round, bid.hash, bid.parts.total, bid.parts.hash, pubkeys,
                        np.asarray([cs.block_id_flag for cs in commit.signatures], dtype=np.uint8),
                        np.asarray([cs.timestamp_ns for cs in commit.signatures], dtype=np.int64),
                        [cs.signature for cs in commit.signatures])
    return convert.validator_set(pubkeys, powers), pc


@pytest.mark.parametrize("route", ["engine", "host"])
def test_valset_and_commit_hash_match_jax(jax_set_and_commit, request, route):
    vs, commit = jax_set_and_commit
    calls = request.getfixturevalue("engine") if route == "engine" else None
    flags = {cs.block_id_flag for cs in commit.signatures}
    assert flags == {BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL}
    pvs, pc = port_objects(vs, commit)
    assert [v.hash_bytes() for v in pvs.validators] == [v.hash_bytes() for v in vs.validators]
    assert [cs.encode() for cs in pc.signatures] == [cs.encode() for cs in commit.signatures]
    assert {len(cs.encode()) for cs in pc.signatures} == {95, 11}
    assert pvs.hash(device="cpu") == vs.hash()
    assert pc.hash(device="cpu") == commit.hash()
    if calls is not None:
        assert calls == {"leaf": 2, "tree": 2}  # 64 leaves: one leaf and one tree call each
    assert pvs.hash() == vs.hash() and pc.hash() == commit.hash()  # memoised: no device asked for again


def test_a_deep_copy_of_a_commit_carries_no_memo(jax_set_and_commit):
    """As in the JAX package: a commit's hash is memoised, and a deep
    copy (made to change it) hashes anew."""
    import copy

    vs, commit = jax_set_and_commit
    _pvs, pc = port_objects(vs, commit)
    root = pc.hash()
    changed, jchanged = copy.deepcopy(pc), copy.deepcopy(commit)
    for c in (changed, jchanged):
        c.signatures[3].timestamp_ns += 1
    assert changed.hash() == jchanged.hash() != root
    assert pc.hash() == root == commit.hash()


@pytest.mark.cuda
def test_sha256_kernels_match_their_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    items = ragged_leaves(11, 1025, 3) + [b"", bytes(54), bytes(55), bytes(40 * 64 - 73)]
    blocks, counts = sha256.pack_leaf_blocks(items, len(items), sha256.leaf_blocks_needed(max(map(len, items))))
    flat = sha256.dense_to_flat(torch.from_numpy(blocks).to(dev), torch.from_numpy(counts).to(dev))
    sha256.reset_launches()
    level = sha256.leaf_block_states(*flat)
    assert torch.equal(level.cpu(), sha256.leaf_blocks_plain(*flat).cpu())
    m = len(items)
    flat = sha256.merkle_tree(level, m, levels=True)
    assert torch.equal(flat.cpu(), sha256.merkle_tree_plain(level, m, levels=True).cpu())
    assert sha256.state_to_digests(flat[:, -1:].cpu().numpy())[0].tobytes() == jmerkle.hash_from_byte_slices(items)
    assert sha256.launches() == {"sha256_leaf_blocks": 1, "merkle_tree": 1}
