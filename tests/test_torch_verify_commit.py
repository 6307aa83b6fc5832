"""The port's ValidatorSet.verify_commit against the JAX package's, on
the CPU.

A 100-validator set and its commits are built with the JAX package's
own types and keys, carried across as numpy arrays by
``tendermint_tpu_torch.convert``, and verified by both:
the JAX package with its serial ``CPUBatchVerifier``, the port with
``device="cpu"`` (the plain versions of its three kernels). Each case
must end the same way on both sides: pass, or raise the same error class
with the same message.
"""

import copy

import numpy as np
import pytest

from tendermint_tpu.codec.signbytes import PRECOMMIT_TYPE, canonical_sign_bytes
from tendermint_tpu.crypto.batch import CPUBatchVerifier
from tendermint_tpu.crypto.keys import Ed25519PrivKey
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
from tendermint_tpu_torch.types import block as port_block

CHAIN = "port-chain"
HEIGHT = 7
N_VALS = 100


@pytest.fixture(scope="module")
def valset():
    rng = np.random.default_rng(100)
    privs = [Ed25519PrivKey.from_secret(f"port-val-{i}".encode()) for i in range(N_VALS)]
    powers = rng.integers(1, 1000, N_VALS)
    vs = jvs.ValidatorSet([Validator(p.pub_key(), int(w)) for p, w in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    return vs, by_addr


def _block_id():
    return BlockID(hash=b"\x42" * 32, parts=PartSetHeader(total=3, hash=b"\x43" * 32))


def make_commit(vs, by_addr, flags, bad=(), short=()):
    """flags[i] is validator i's BlockIDFlag; rows in `bad` get a corrupt
    signature, rows in `short` have their signature cut by one byte."""
    bid = _block_id()
    sigs = []
    for i, (val, flag) in enumerate(zip(vs.validators, flags)):
        if flag == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
            continue
        vote_bid = bid if flag == BLOCK_ID_FLAG_COMMIT else BlockID()
        ts = 1_700_000_000_000_000_000 + 1000 * i
        msg = canonical_sign_bytes(
            PRECOMMIT_TYPE, HEIGHT, 0, vote_bid.hash, vote_bid.parts.total, vote_bid.parts.hash, ts, CHAIN
        )
        sig = by_addr[val.address].sign(msg)
        if i in bad:
            sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]
        if i in short:
            sig = sig[:63]
        sigs.append(CommitSig(flag, val.address, ts, sig))
    return Commit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)


def carry_across(vs, commit):
    """Extract the arrays from the JAX package's objects and rebuild the
    port's ValidatorSet and Commit from them."""
    pubkeys = np.stack([np.frombuffer(v.pub_key.bytes(), dtype=np.uint8) for v in vs.validators])
    powers = np.asarray([v.voting_power for v in vs.validators], dtype=np.int64)
    port_vs = convert.validator_set(pubkeys, powers)
    bid = commit.block_id
    port_commit = convert.commit(
        commit.height, commit.round, bid.hash, bid.parts.total, bid.parts.hash, pubkeys,
        np.asarray([cs.block_id_flag for cs in commit.signatures], dtype=np.uint8),
        np.asarray([cs.timestamp_ns for cs in commit.signatures], dtype=np.int64),
        [cs.signature for cs in commit.signatures],
    )
    return port_vs, port_commit


def outcome(fn):
    try:
        fn()
    except Exception as e:  # the verdict under test is the exception itself
        return type(e).__name__, str(e)
    return "ok", ""


def both(vs, commit):
    port_vs, port_commit = carry_across(vs, commit)
    pbid = port_commit.block_id
    want = outcome(lambda: vs.verify_commit(CHAIN, _block_id(), HEIGHT, commit, provider=CPUBatchVerifier()))
    got = outcome(lambda: port_vs.verify_commit(CHAIN, pbid, HEIGHT, port_commit, device="cpu"))
    return want, got


def _flags(n_commit, n_nil, n_absent):
    flags = [BLOCK_ID_FLAG_COMMIT] * n_commit + [BLOCK_ID_FLAG_NIL] * n_nil
    flags += [BLOCK_ID_FLAG_ABSENT] * n_absent
    return flags


def test_valset_carries_across(valset):
    vs, _ = valset
    port_vs, _ = carry_across(vs, make_commit(vs, valset[1], _flags(N_VALS, 0, 0)))
    assert port_vs.total_voting_power() == vs.total_voting_power()
    assert [v.address for v in port_vs.validators] == [v.address for v in vs.validators]
    assert [v.proposer_priority for v in port_vs.validators] == [v.proposer_priority for v in vs.validators]
    assert port_vs.proposer.address == vs.proposer.address


CASES = {
    # ~90 % for the block, some nil and some absent rows
    "good": dict(flags=_flags(90, 6, 4)),
    "bad_row_before_quorum": dict(flags=_flags(90, 6, 4), bad=(3,)),
    "bad_row_after_quorum": dict(flags=_flags(90, 6, 4), bad=(88,)),
    "bad_nil_row_before_quorum": dict(flags=_flags(2, 90, 8), bad=(40,)),
    "too_little_power": dict(flags=_flags(55, 20, 25)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_matches_jax(valset, case):
    vs, by_addr = valset
    want, got = both(vs, make_commit(vs, by_addr, **CASES[case]))
    assert got == want
    expected = {
        "good": "ok",
        "bad_row_before_quorum": "ErrInvalidCommitSignature",
        "bad_row_after_quorum": "ok",
        "bad_nil_row_before_quorum": "ErrInvalidCommitSignature",
        "too_little_power": "ErrNotEnoughVotingPower",
    }[case]
    assert got[0] == expected


def test_structural_errors_match_jax(valset):
    vs, by_addr = valset
    commit = make_commit(vs, by_addr, _flags(90, 6, 4))
    port_vs, port_commit = carry_across(vs, commit)
    other = BlockID(hash=b"\x01" * 32, parts=PartSetHeader(total=3, hash=b"\x43" * 32))
    pother = port_block.BlockID(b"\x01" * 32, port_block.PartSetHeader(3, b"\x43" * 32))
    want = outcome(lambda: vs.verify_commit(CHAIN, other, HEIGHT, commit, provider=CPUBatchVerifier()))
    got = outcome(lambda: port_vs.verify_commit(CHAIN, pother, HEIGHT, port_commit, device="cpu"))
    assert got == want and got[0] == "ErrInvalidCommit"
    want = outcome(lambda: vs.verify_commit(CHAIN, _block_id(), HEIGHT + 1, commit, provider=CPUBatchVerifier()))
    got = outcome(lambda: port_vs.verify_commit(CHAIN, port_commit.block_id, HEIGHT + 1, port_commit, device="cpu"))
    assert got == want


def test_truncated_signature_is_rejected(valset):
    """A 63-byte signature is invalid in Go's serial verify. The JAX
    package pads it back to 64 bytes into its batch, so a signature whose
    last byte is zero, cut by that byte, verifies there (ROADMAP.md,
    faults against the reference). The port rejects it."""
    vs, by_addr = valset
    commit = make_commit(vs, by_addr, _flags(N_VALS, 0, 0))
    bid = _block_id()
    cs = commit.signatures[0]
    priv = by_addr[cs.validator_address]
    ts = cs.timestamp_ns
    while True:  # a timestamp whose signature ends in a zero byte
        ts += 1
        msg = canonical_sign_bytes(
            PRECOMMIT_TYPE, HEIGHT, 0, bid.hash, bid.parts.total, bid.parts.hash, ts, CHAIN
        )
        sig = priv.sign(msg)
        if sig[-1] == 0:
            break
    cut = copy.deepcopy(commit)
    cut.signatures[0] = CommitSig(BLOCK_ID_FLAG_COMMIT, cs.validator_address, ts, sig[:63])
    want, got = both(vs, cut)
    assert got == ("ErrInvalidCommitSignature", f"wrong signature #0 ({cs.validator_address.hex()})")
    assert want == ("ok", "")


@pytest.mark.parametrize("seed", range(4))
def test_replay_matches_jax_loop(valset, seed):
    """The port's closed-form replay against the JAX package's sequential
    loop on the same verdict vectors, with bad rows scattered before,
    around and after the quorum row."""
    vs, by_addr = valset
    commit = make_commit(vs, by_addr, _flags(60 + 5 * seed, 30 - 5 * seed, 10))
    port_vs, port_commit = carry_across(vs, commit)
    idxs = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    powers = np.asarray([vs.validators[i].voting_power for i in idxs], dtype=np.int64)
    counted = np.asarray([commit.signatures[i].for_block() for i in idxs], dtype=bool)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ok = rng.random(len(idxs)) > rng.choice([0.0, 0.01, 0.05, 0.3])
        talled = int(powers[ok & counted].sum())
        want = outcome(lambda: vs._replay_commit_full(commit, ok, idxs, powers, counted))
        got = outcome(lambda: port_vs._replay_commit_full(port_commit, ok, idxs, powers, counted, talled))
        assert got == want
