"""The port's commit verification on its per-valset tabled path against
the JAX package's, on the CPU: ``ValidatorSet.verify_commit`` and the
light client's ``verify_commit_trusting``.

A 64-validator set A, a set B that shares half of A's validators, and
commits of A are built with the JAX package's own types and keys and
carried across as numpy arrays (``tendermint_tpu_torch.convert``). The
JAX package verifies with its serial ``CPUBatchVerifier``; the port with
``device="cpu"``, which runs the plain versions of its tabled kernels
(a commit of A reads A's tables in row order minus the absent rows; B's
trusting check reads B's tables through the signers' addresses, a subset
with repeats). Each case must end the same way on both sides: pass, or
raise the same error class with the same message.
"""

import copy
from fractions import Fraction

import numpy as np
import pytest
import torch

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
from tendermint_tpu_torch import TorchBatchVerifier, convert
from tendermint_tpu_torch.ops import ed25519 as ted

CHAIN = "tabled-chain"
HEIGHT = 9
N_VALS = 64
THIRD = Fraction(1, 3)


@pytest.fixture(scope="module")
def sets():
    """A (64 validators), B (A's even-indexed half and 32 others), the
    keys by address and the port's copies of both sets."""
    rng = np.random.default_rng(64)
    privs = [Ed25519PrivKey.from_secret(f"tabled-val-{i}".encode()) for i in range(N_VALS + N_VALS // 2)]
    powers = rng.integers(1, 1000, len(privs))
    vals = [Validator(p.pub_key(), int(w)) for p, w in zip(privs, powers)]
    a = jvs.ValidatorSet(vals[:N_VALS])
    b = jvs.ValidatorSet([v for i, v in enumerate(vals[:N_VALS]) if i % 2 == 0] + vals[N_VALS:])
    by_addr = {p.pub_key().address(): p for p in privs}
    return a, b, by_addr, port_set(a), port_set(b)


def port_set(vs):
    pubkeys = np.stack([np.frombuffer(v.pub_key.bytes(), dtype=np.uint8) for v in vs.validators])
    powers = np.asarray([v.voting_power for v in vs.validators], dtype=np.int64)
    return convert.validator_set(pubkeys, powers)


def _block_id():
    return BlockID(hash=b"\x51" * 32, parts=PartSetHeader(total=2, hash=b"\x52" * 32))


def _flags(n_commit, n_nil, n_absent):
    return [BLOCK_ID_FLAG_COMMIT] * n_commit + [BLOCK_ID_FLAG_NIL] * n_nil + [BLOCK_ID_FLAG_ABSENT] * n_absent


def make_commit(vs, by_addr, flags, bad=(), short=(), dup=()):
    """A commit of `vs`: flags[i] is validator i's BlockIDFlag; rows in
    `bad` get a corrupt signature; rows in `short` get a signature (of a
    later timestamp) whose last byte is 0, cut to 63 bytes; each (i, j)
    in `dup` makes row j a copy of row i (the same signer twice)."""
    bid = _block_id()
    sigs = []
    for i, (val, flag) in enumerate(zip(vs.validators, flags)):
        if flag == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
            continue
        vote_bid = bid if flag == BLOCK_ID_FLAG_COMMIT else BlockID()
        ts = 1_700_000_000_000_000_000 + 7919 * i
        while True:
            msg = canonical_sign_bytes(
                PRECOMMIT_TYPE, HEIGHT, 0, vote_bid.hash, vote_bid.parts.total, vote_bid.parts.hash, ts, CHAIN
            )
            sig = by_addr[val.address].sign(msg)
            if i not in short or sig[-1] == 0:
                break
            ts += 1
        if i in bad:
            sig = sig[:7] + bytes([sig[7] ^ 0x20]) + sig[8:]
        if i in short:
            sig = sig[:63]
        sigs.append(CommitSig(flag, val.address, ts, sig))
    for i, j in dup:
        sigs[j] = copy.copy(sigs[i])
    return Commit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)


def port_commit(commit, by_addr):
    """The commit rebuilt on the port's side from numpy arrays; row i's
    key is that of its signer's address (absent rows: any key)."""
    anyone = next(iter(by_addr.values())).pub_key().bytes()
    pubkeys = np.stack([
        np.frombuffer(by_addr[cs.validator_address].pub_key().bytes() if not cs.absent_() else anyone, dtype=np.uint8)
        for cs in commit.signatures
    ])
    bid = commit.block_id
    return convert.commit(
        commit.height, commit.round, bid.hash, bid.parts.total, bid.parts.hash, pubkeys,
        np.asarray([cs.block_id_flag for cs in commit.signatures], dtype=np.uint8),
        np.asarray([cs.timestamp_ns for cs in commit.signatures], dtype=np.int64),
        [cs.signature for cs in commit.signatures],
    )


def outcome(fn):
    try:
        fn()
    except Exception as e:  # the verdict under test is the exception itself
        return type(e).__name__, str(e)
    return "ok", ""


class NoGeneric(TorchBatchVerifier):
    """The port's provider with the generic path disabled: a case that
    passes through it ran on the tabled path alone."""

    def verify_batch(self, *a, **k):
        raise AssertionError("the generic path ran")

    def verify_commit_batch(self, *a, **k):
        raise AssertionError("the generic path ran")


class GenericOnly(TorchBatchVerifier):
    """The port's provider with the tabled path unavailable (the base
    BatchVerifier's None), so that commits take the generic path."""

    def verify_rows_cached(self, *a, **k):
        return None

    def verify_rows_cached_templated(self, *a, **k):
        return None


@pytest.fixture(scope="module")
def provider():
    return NoGeneric("cpu")


FULL_CASES = {
    "good": dict(flags=_flags(58, 3, 3)),
    "bad_row_before_quorum": dict(flags=_flags(58, 3, 3), bad=(2,)),
    "bad_row_after_quorum": dict(flags=_flags(58, 3, 3), bad=(57,)),
    "too_little_power": dict(flags=_flags(30, 14, 20)),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_verify_commit_tabled_matches_jax(sets, provider, case):
    a, _b, by_addr, pa, _pb = sets
    commit = make_commit(a, by_addr, **FULL_CASES[case])
    pc = port_commit(commit, by_addr)
    want = outcome(lambda: a.verify_commit(CHAIN, _block_id(), HEIGHT, commit, provider=CPUBatchVerifier()))
    got = outcome(lambda: pa.verify_commit(CHAIN, pc.block_id, HEIGHT, pc, provider=provider))
    assert got == want
    assert got[0] == {"good": "ok", "bad_row_before_quorum": "ErrInvalidCommitSignature",
                      "bad_row_after_quorum": "ok", "too_little_power": "ErrNotEnoughVotingPower"}[case]
    key = (pa.batch_cache()[0], "cpu")
    assert key in provider.model._valset_tables  # the tabled path ran, on A's tables


GENERIC_CASES = dict(
    FULL_CASES,
    bad_nil_row_before_quorum=dict(flags=_flags(2, 56, 6), bad=(40,)),
    truncated_signature=dict(flags=_flags(N_VALS, 0, 0), short=(0,)),
)


@pytest.mark.parametrize("case", sorted(GENERIC_CASES))
def test_generic_path_gives_the_same_verdicts(sets, case):
    """The generic path (fused device tally, the sig_ok mask) keeps its
    slice-level check against the JAX package, now that verify_commit
    takes the tabled path by default."""
    a, _b, by_addr, pa, _pb = sets
    commit = make_commit(a, by_addr, **GENERIC_CASES[case])
    pc = port_commit(commit, by_addr)
    want = outcome(lambda: a.verify_commit(CHAIN, _block_id(), HEIGHT, commit, provider=CPUBatchVerifier()))
    generic = GenericOnly("cpu")
    got = outcome(lambda: pa.verify_commit(CHAIN, pc.block_id, HEIGHT, pc, provider=generic))
    if case == "truncated_signature":
        # Go's verdict; the JAX package accepts it (see the tabled test below)
        assert want == ("ok", "")
        assert got == ("ErrInvalidCommitSignature",
                       f"wrong signature #0 ({commit.signatures[0].validator_address.hex()})")
    else:
        assert got == want
        assert got[0] == {"good": "ok", "bad_row_before_quorum": "ErrInvalidCommitSignature",
                          "bad_row_after_quorum": "ok", "bad_nil_row_before_quorum": "ErrInvalidCommitSignature",
                          "too_little_power": "ErrNotEnoughVotingPower"}[case]
    assert not generic.model._valset_tables


def test_truncated_signature_is_rejected_on_the_tabled_path(sets, provider):
    """As on the generic path (test_torch_verify_commit.py): a 63-byte
    signature is invalid in Go's serial verify and in the port; the JAX
    package pads it back into its batch, so one whose cut byte was 0
    verifies there (ROADMAP.md, faults against the reference)."""
    a, _b, by_addr, pa, _pb = sets
    commit = make_commit(a, by_addr, _flags(N_VALS, 0, 0), short=(0,))
    pc = port_commit(commit, by_addr)
    want = outcome(lambda: a.verify_commit(CHAIN, _block_id(), HEIGHT, commit, provider=CPUBatchVerifier()))
    got = outcome(lambda: pa.verify_commit(CHAIN, pc.block_id, HEIGHT, pc, provider=provider))
    assert got == ("ErrInvalidCommitSignature",
                   f"wrong signature #0 ({commit.signatures[0].validator_address.hex()})")
    assert want == ("ok", "")


def _early_b_rows(b, commit, k):
    """The first k rows of `commit` whose signer is in B."""
    rows = [i for i, cs in enumerate(commit.signatures)
            if not cs.absent_() and b.get_by_address(cs.validator_address)[1] is not None]
    return rows[:k], rows[-1]


TRUST_CASES = ["good", "bad_row_before_quorum", "bad_row_after_quorum", "trust_level_one",
               "duplicate_before_quorum", "duplicate_after_quorum", "short_signature", "bad_trust_level"]


@pytest.mark.parametrize("case", TRUST_CASES)
def test_verify_commit_trusting_matches_jax(sets, provider, case):
    a, b, by_addr, _pa, pb = sets
    flags = _flags(58, 3, 3)
    probe = make_commit(a, by_addr, flags)
    (r0, r1, r2), last = _early_b_rows(b, probe, 3)
    kw, level = {}, THIRD
    if case == "bad_row_before_quorum":
        kw["bad"] = (r1,)
    elif case == "bad_row_after_quorum":
        kw["bad"] = (last,)
    elif case == "trust_level_one":
        level = Fraction(1, 1)
    elif case == "duplicate_before_quorum":
        kw["dup"] = ((r0, r2),)
    elif case == "duplicate_after_quorum":
        kw["dup"] = ((r0, last),)
    elif case == "short_signature":
        kw["short"] = (r0,)
    elif case == "bad_trust_level":
        level = Fraction(1, 4)
    commit = make_commit(a, by_addr, flags, **kw)
    pc = port_commit(commit, by_addr)
    want = outcome(lambda: b.verify_commit_trusting(CHAIN, _block_id(), HEIGHT, commit, level,
                                                    provider=CPUBatchVerifier()))
    got = outcome(lambda: pb.verify_commit_trusting(CHAIN, pc.block_id, HEIGHT, pc, level, provider=provider))
    expected = {
        "good": "ok", "bad_row_before_quorum": "ErrInvalidCommitSignature", "bad_row_after_quorum": "ok",
        "trust_level_one": "ErrNotEnoughVotingPower", "duplicate_before_quorum": "ErrInvalidCommit",
        "duplicate_after_quorum": "ok", "short_signature": "ErrInvalidCommitSignature",
        "bad_trust_level": "ValueError",
    }[case]
    assert got[0] == expected
    if case == "short_signature":
        # Go rejects the cut signature; the JAX package's batch pads it
        # back to 64 bytes and accepts it, so only the port's verdict is
        # Go's (ROADMAP.md, faults against the reference)
        assert want == ("ok", "")
    else:
        assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_trusting_replay_matches_jax_loop(sets, seed):
    """The port's closed-form trusting replay against the JAX package's
    sequential loop, on verdict vectors with bad rows and repeated
    validators scattered before, around and after the quorum row, and
    with the first bad or repeated row placed on each side of the row
    at which the tally first exceeds the trust level's share."""
    _a, b, _by, _pa, pb = sets
    rng = np.random.default_rng(seed)
    n = 40
    powers_all = np.asarray([v.voting_power for v in b.validators], dtype=np.int64)
    assert [v.voting_power for v in pb.validators] == powers_all.tolist()

    def check(ok, idxs, vals_idx, counted, level):
        powers = powers_all[vals_idx]
        want = outcome(lambda: b._replay_commit_trusting(ok, idxs, vals_idx, powers, counted, level))
        got = outcome(lambda: pb._replay_commit_trusting(ok, idxs, vals_idx, powers, counted, level))
        assert got == want
        return want[0]

    seen = set()
    for _ in range(60):
        vals_idx = rng.choice(len(b.validators), n, replace=rng.random() < 0.5).tolist()
        ok = rng.random(n) > rng.choice([0.0, 0.02, 0.1, 0.4])
        counted = rng.random(n) < 0.85
        idxs = sorted(rng.choice(200, n, replace=False).tolist())
        level = [THIRD, Fraction(1, 2), Fraction(2, 3)][int(rng.integers(0, 3))]
        seen.add(check(ok, idxs, vals_idx, counted, level))
        # the first rejected row just before, at and just after the row
        # whose tally before it first exceeds the share
        vals_idx = rng.choice(len(b.validators), n, replace=False).tolist()
        before = np.cumsum(np.where(counted, powers_all[vals_idx], 0))
        over = np.flatnonzero(before > b.total_voting_power() * level.numerator // level.denominator)
        if not over.size:
            continue
        cross = int(over[0]) + 1  # the first row the loop returns at
        for r in (cross - 1, cross, cross + 1):
            if 0 < r < n:
                bad = np.ones(n, dtype=bool)
                bad[r] = False
                seen.add(check(bad, idxs, vals_idx, counted, level))
                dup = list(vals_idx)
                dup[r] = dup[0]
                seen.add(check(np.ones(n, dtype=bool), idxs, dup, counted, level))
    assert seen == {"ok", "ErrInvalidCommit", "ErrInvalidCommitSignature", "ErrNotEnoughVotingPower"}


def test_sign_bytes_parts_match_jax(sets):
    a, _b, by_addr, _pa, _pb = sets
    commit = make_commit(a, by_addr, _flags(50, 7, 7))
    pc = port_commit(commit, by_addr)
    for got, want in zip(pc.sign_bytes_parts(CHAIN), commit.sign_bytes_parts(CHAIN)):
        np.testing.assert_array_equal(got, want)
    assert pc.sign_bytes_parts(CHAIN) is pc.sign_bytes_parts(CHAIN)  # memoised per chain id
    rows = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    np.testing.assert_array_equal(pc.sign_bytes_matrix(CHAIN, rows), commit.sign_bytes_matrix(CHAIN)[rows])
    assert pc.sign_bytes_matrix("other", rows).tobytes() != pc.sign_bytes_matrix(CHAIN, rows).tobytes()


def test_rows_cached_matrix_and_templated_agree(sets, provider):
    """The provider's two message sources (a sign-bytes matrix, or
    templates and timestamps) give the same verdicts on the same rows,
    repeated validators included."""
    a, _b, by_addr, pa, _pb = sets
    commit = make_commit(a, by_addr, _flags(58, 3, 3), bad=(4,))
    pc = port_commit(commit, by_addr)
    _i, vals_idx, sigs, _p, _c, _s, (templates, tmpl_idx, ts8) = pa._commit_batch_arrays(CHAIN, pc)
    sel = np.r_[:len(vals_idx), :5]  # every row, then the first five again
    rows, sigs, tmpl_idx, ts8 = vals_idx[sel], sigs[sel], tmpl_idx[sel], ts8[sel]
    key, all_pk = pa.batch_cache()
    tpl_ok = provider.verify_rows_cached_templated(key, all_pk, rows, templates, tmpl_idx, ts8, sigs)
    msgs = templates[tmpl_idx]
    msgs[:, 93:101] = ts8
    mat_ok = provider.verify_rows_cached(key, all_pk, rows, msgs, sigs)
    np.testing.assert_array_equal(tpl_ok, mat_ok)
    assert (~tpl_ok).nonzero()[0].tolist() == [4, len(vals_idx) + 4]
    with pytest.raises(IndexError):
        provider.verify_rows_cached(key, all_pk, np.array([N_VALS]), msgs[:1], sigs[:1])


def test_batch_cache_key_and_lru(sets):
    a, b, _by, pa, pb = sets
    assert pa.batch_cache()[0] == a.batch_cache()[0]
    model = TorchBatchVerifier("cpu").model
    key_a, pk_a = pa.batch_cache()
    key_b, pk_b = pb.batch_cache()
    ea = model.tables_entry(key_a, pk_a)
    assert model.tables_entry(key_a, pk_a) is ea  # built once
    model.tables_entry(key_b, pk_b)
    model.tables_entry(b"third", pk_b[:4])
    assert list(model._valset_tables) == [(key_b, "cpu"), (b"third", "cpu")]  # two sets, least recent out


@pytest.mark.cuda
def test_tabled_commit_path_launches_its_kernels_on_card(sets):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    a, b, by_addr, pa, pb = sets
    commit = make_commit(a, by_addr, _flags(58, 3, 3))
    pc = port_commit(commit, by_addr)
    ted.reset_launches()
    pa.verify_commit(CHAIN, pc.block_id, HEIGHT, pc)
    pb.verify_commit_trusting(CHAIN, pc.block_id, HEIGHT, pc, THIRD)
    n = ted.launches()
    assert n["ed25519_build_tables"] == 2 and n["ed25519_prepare_tabled"] == 2
    assert n["ed25519_scan_tabled"] == 2 and n["ed25519_finish"] == 2
    assert n["ed25519_prepare"] == 0 and n["ed25519_scan"] == 0
