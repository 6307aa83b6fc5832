"""The port's light-client header verification against the JAX package's,
on the CPU: ``light.verifier.verify`` (adjacent and non-adjacent),
``verify_chain`` and ``verify_backwards``.

A chain of signed headers is built with the JAX package's own types and
keys: sets A (10 validators), B (9 of A's and one other) and C (none of
A's); headers at heights 1-3 under A (h3 hands over to B), 5 under B,
and variants for the failing cases. The headers, commits and sets are
carried across to the port as plain values (``convert``). The JAX
package verifies with its serial ``CPUBatchVerifier``; the port with
device="cpu", its merkle threshold lowered to 2 so that every
validator-set and header hash runs through the SHA-256 kernels' plain
versions, and the ed25519 kernels' plain versions behind its provider.
Each case must end the same way on both sides: pass, or the same error
class with the same message.
"""

import copy
import hashlib
from fractions import Fraction

import numpy as np
import pytest

from tendermint_tpu.crypto.batch import CPUBatchVerifier
from tendermint_tpu.crypto.keys import Ed25519PrivKey
from tendermint_tpu.light import verifier as jver
from tendermint_tpu.light.types import SignedHeader as JSignedHeader
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from tendermint_tpu.types.validator import Validator
from tendermint_tpu.types.validator_set import ValidatorSet
from tendermint_tpu_torch import TorchBatchVerifier, convert
from tendermint_tpu_torch import Validator as PortValidator
from tendermint_tpu_torch import ValidatorSet as PortValidatorSet
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.light import verifier as pver
from tendermint_tpu_torch.light.types import SignedHeader
from tendermint_tpu_torch.types import validator_set as pvs

CHAIN = "light-chain"
T0 = 1_700_000_000 * 10**9
SEC = 10**9
PERIOD = 3600 * SEC
NOW = T0 + 600 * SEC


@pytest.fixture(autouse=True)
def engine(monkeypatch):
    """Every validator-set and header hash through the MerkleHasher, the
    whole tree through the tree kernel's plain version."""
    monkeypatch.setattr(merkle, "DEVICE_THRESHOLD", 2)


class Recording(TorchBatchVerifier):
    """The port's provider on the CPU, recording which entry point each
    commit batch took."""

    def __init__(self):
        super().__init__("cpu")
        self.calls = []

    def verify_batch(self, *a, **k):
        self.calls.append("verify_batch")
        return super().verify_batch(*a, **k)

    def verify_rows_cached_templated(self, *a, **k):
        self.calls.append("tabled")
        return super().verify_rows_cached_templated(*a, **k)


class NoGeneric(TorchBatchVerifier):
    """The port's provider with the generic path disabled."""

    def verify_batch(self, *a, **k):
        raise AssertionError("the generic path ran")

    def verify_commit_batch(self, *a, **k):
        raise AssertionError("the generic path ran")


def jheader(height, time_ns, vals, next_vals, last_bid=None, app=b"\x0a"):
    return Header(
        chain_id=CHAIN, height=height, time_ns=time_ns, last_block_id=last_bid or BlockID(),
        last_commit_hash=hashlib.sha256(b"lc%d" % height).digest(), data_hash=hashlib.sha256(b"").digest(),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=hashlib.sha256(b"params").digest(), app_hash=hashlib.sha256(app).digest(),
        proposer_address=vals.validators[0].address,
    )


def jsign(header, vals, keys, nil=()):
    """A commit of `vals` for `header`'s block: every row signed, rows in
    `nil` for nil."""
    bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(b"parts%d" % header.height).digest()))
    sigs = [CommitSig(BLOCK_ID_FLAG_NIL if i in nil else BLOCK_ID_FLAG_COMMIT, v.address,
                      header.time_ns + 1000 * (i + 1), b"") for i, v in enumerate(vals.validators)]
    commit = Commit(header.height, 0, bid, sigs)
    for i, cs in enumerate(sigs):
        cs.signature = keys[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN, i))
    return JSignedHeader(header, commit)


def corrupt(sh, row):
    c = copy.deepcopy(sh.commit)
    sig = c.signatures[row].signature
    c.signatures[row].signature = sig[:9] + bytes([sig[9] ^ 0x40]) + sig[10:]
    return JSignedHeader(sh.header, c)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(2026)
    privs = [Ed25519PrivKey.from_secret(f"light-val-{i}".encode()) for i in range(22)]
    keys = {p.pub_key().address(): p for p in privs}
    powers = rng.integers(10, 100, len(privs))
    val = lambda i, w=None: Validator(privs[i].pub_key(), int(powers[i] if w is None else w))  # noqa: E731
    a = ValidatorSet([val(i) for i in range(10)])
    b = ValidatorSet([val(i) for i in range(1, 11)])
    c = ValidatorSet([val(i) for i in range(12, 22)])
    a_mod = ValidatorSet([val(i, powers[i] + (i == 4)) for i in range(10)])
    h1 = jsign(jheader(1, T0, a, a), a, keys)
    bid1 = h1.commit.block_id
    h2 = jsign(jheader(2, T0 + 10 * SEC, a, a, bid1), a, keys, nil=(7,))
    h3 = jsign(jheader(3, T0 + 20 * SEC, a, b, h2.commit.block_id), a, keys)
    j = dict(
        a=a, b=b, c=c, a_mod=a_mod, h1=h1, h2=h2, h3=h3,
        h5=jsign(jheader(5, T0 + 40 * SEC, b, b), b, keys),
        hc=jsign(jheader(5, T0 + 40 * SEC, c, c), c, keys),
        h2b=jsign(jheader(2, T0 + 10 * SEC, b, b, bid1), b, keys),
        h2t=jsign(jheader(2, T0, a, a, bid1), a, keys),
        h2_bad=corrupt(h2, 0),
        h3_bad=corrupt(h3, 1),
        h1_other=jsign(jheader(1, T0, a, a, app=b"other"), a, keys),
        h1_late=jsign(jheader(1, T0 + 15 * SEC, a, a), a, keys),
    )
    port = {k: (port_set(v) if isinstance(v, ValidatorSet) else port_sh(v, keys)) for k, v in j.items()}
    return j, port


def port_set(vs):
    pubkeys = np.stack([np.frombuffer(v.pub_key.bytes(), dtype=np.uint8) for v in vs.validators])
    return convert.validator_set(pubkeys, np.asarray([v.voting_power for v in vs.validators], dtype=np.int64))


def port_sh(sh, keys):
    h, c = sh.header, sh.commit
    lb = h.last_block_id
    header = convert.header(
        h.chain_id, h.height, h.time_ns, (lb.hash, lb.parts.total, lb.parts.hash), h.last_commit_hash,
        h.data_hash, h.validators_hash, h.next_validators_hash, h.consensus_hash, h.app_hash,
        h.last_results_hash, h.evidence_hash, h.proposer_address, h.version_block, h.version_app,
    )
    pubkeys = np.stack([np.frombuffer(keys[cs.validator_address].pub_key().bytes(), dtype=np.uint8)
                        for cs in c.signatures])
    commit = convert.commit(
        c.height, c.round, c.block_id.hash, c.block_id.parts.total, c.block_id.parts.hash, pubkeys,
        np.asarray([cs.block_id_flag for cs in c.signatures], dtype=np.uint8),
        np.asarray([cs.timestamp_ns for cs in c.signatures], dtype=np.int64),
        [cs.signature for cs in c.signatures],
    )
    return SignedHeader(header, commit)


def outcome(fn):
    try:
        fn()
    except Exception as e:  # the verdict under test is the exception itself
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.fixture(scope="module")
def provider():
    return Recording()


def test_headers_and_sets_carry_across(world):
    j, p = world
    for name in ("a", "b", "c", "a_mod"):
        assert p[name].hash(device="cpu") == j[name].hash()
    for name in ("h1", "h2", "h5", "h2_bad"):
        assert p[name].hash(device="cpu") == j[name].hash()
        assert p[name].commit.hash(device="cpu") == j[name].commit.hash()
        assert p[name].validate_basic(CHAIN, device="cpu") is None


VERIFY_CASES = {
    # name: (trusted, trusted vals, untrusted, untrusted vals, now, expected class)
    "adjacent_ok": ("h1", "a", "h2", "a", NOW, "ok"),
    "non_adjacent_ok": ("h3", "a", "h5", "b", NOW, "ok"),
    "non_adjacent_same_set_ok": ("h1", "a", "h3", "a", NOW, "ok"),
    "validators_hash_mismatch": ("h1", "a", "h2", "a_mod", NOW, "ErrInvalidHeader"),
    "next_validators_mismatch": ("h1", "a", "h2b", "b", NOW, "ErrInvalidHeader"),
    "expired_trusted_header": ("h1", "a", "h2", "a", T0 + PERIOD, "ErrOldHeaderExpired"),
    "header_from_the_future": ("h1", "a", "h2", "a", T0 + 10 * SEC - jver.DEFAULT_CLOCK_DRIFT_NS, "ErrInvalidHeader"),
    "time_not_increasing": ("h1", "a", "h2t", "a", NOW, "ErrInvalidHeader"),
    "trust_check_fails": ("h3", "a", "hc", "c", NOW, "ErrNewValSetCantBeTrusted"),
    "bad_row_before_quorum": ("h1", "a", "h2_bad", "a", NOW, "ErrInvalidCommitSignature"),
    "wrong_chain_id_header": ("h1", "a", "h2", "a", NOW, "ErrInvalidHeader"),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_matches_jax(world, provider, case):
    j, p = world
    t, tv, u, uv, now, expected = VERIFY_CASES[case]
    chain = "another-chain" if case == "wrong_chain_id_header" else CHAIN
    want = outcome(lambda: jver.verify(chain, j[t], j[tv], j[u], j[uv], PERIOD, now_ns=now,
                                       provider=CPUBatchVerifier()))
    got = outcome(lambda: pver.verify(chain, p[t], p[tv], p[u], p[uv], PERIOD, now_ns=now,
                                      provider=provider, device="cpu"))
    assert got == want
    assert got[0] == expected


CHAIN_CASES = {
    # name: (links as (header, vals) names, expected class)
    "same_set_chain": ((("h2", "a"), ("h3", "a")), "ok"),
    "mixed_set_chain": ((("h2", "a"), ("h3", "a"), ("h5", "b")), "ok"),
    "link_1_cant_be_trusted": ((("h2", "a"), ("hc", "c")), "ErrNewValSetCantBeTrusted"),
    "link_1_bad_header": ((("h2", "a"), ("h3", "a_mod")), "ErrInvalidHeader"),
    "link_1_bad_row": ((("h2", "a"), ("h3_bad", "a")), "ErrInvalidCommitSignature"),
    "link_0_bad_row": ((("h2_bad", "a"), ("h3", "a")), "ErrInvalidCommitSignature"),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_verify_chain_matches_jax(world, case):
    j, p = world
    links, expected = CHAIN_CASES[case]
    provider = NoGeneric("cpu") if case == "same_set_chain" else Recording()
    want = outcome(lambda: jver.verify_chain(CHAIN, j["h1"], j["a"], [(j[h], j[v]) for h, v in links], PERIOD,
                                             now_ns=NOW, provider=CPUBatchVerifier()))
    got = outcome(lambda: pver.verify_chain(CHAIN, p["h1"], p["a"], [(p[h], p[v]) for h, v in links], PERIOD,
                                            now_ns=NOW, provider=provider, device="cpu"))
    assert got == want
    assert got[0] == expected
    if case == "link_1_cant_be_trusted":
        assert got[1].startswith("link 1: have ")
    if case == "same_set_chain":
        # both links' commits, of one set, in one tabled call
        assert list(provider.model._valset_tables) == [(p["a"].batch_cache()[0], "cpu")]
    elif case == "mixed_set_chain":
        # A's commits and B's in one generic call, no tabled one
        assert provider.calls == ["verify_batch"]
    elif case != "link_1_bad_header":
        assert len(provider.calls) == 1


BACKWARDS_CASES = {
    "ok": ("h1", "h2", "ok"),
    "not_the_parent": ("h1_other", "h2", "ErrInvalidHeader"),
    "older_header_not_older": ("h1_late", "h2", "ErrInvalidHeader"),
    "not_adjacent": ("h1", "h3", "ValueError"),
    "ok_2_3": ("h2", "h3", "ok"),
}


@pytest.mark.parametrize("case", sorted(BACKWARDS_CASES))
def test_verify_backwards_matches_jax(world, case):
    j, p = world
    u, t, expected = BACKWARDS_CASES[case]
    want = outcome(lambda: jver.verify_backwards(CHAIN, j[u], j[t]))
    got = outcome(lambda: pver.verify_backwards(CHAIN, p[u], p[t], device="cpu"))
    assert got == want
    assert got[0] == expected


def test_non_adjacent_link_needs_the_trusted_set(world):
    j, p = world
    want = outcome(lambda: jver.link_specs(CHAIN, j["h1"], None, j["h3"], j["a"], PERIOD, now_ns=NOW))
    got = outcome(lambda: pver.link_specs(CHAIN, p["h1"], None, p["h3"], p["a"], PERIOD, now_ns=NOW, device="cpu"))
    assert got == want == ("ValueError", "non-adjacent link requires the trusted valset")


def test_verify_commits_batched_matches_jax_spec_by_spec(world):
    """One batch of specs that end differently (accepted, a host check
    failing, a bad trust level, a bad row, too little trust): the same
    verdict for each spec on both sides, from one provider call."""
    from fractions import Fraction

    from tendermint_tpu.types import validator_set as jvs
    from tendermint_tpu_torch.types import validator_set as pvs

    j, p = world

    def specs(mod, w):
        full = lambda vs, sh, **k: mod.CommitVerifySpec(  # noqa: E731
            w[vs], CHAIN, w[sh].commit.block_id, k.get("height", w[sh].header.height), w[sh].commit)
        trust = lambda vs, sh, level: mod.CommitVerifySpec(  # noqa: E731
            w[vs], CHAIN, w[sh].commit.block_id, w[sh].header.height, w[sh].commit, "trusting", level)
        return [full("a", "h2"), full("a", "h3", height=4), trust("a", "h5", Fraction(1, 5)),
                full("a", "h2_bad"), trust("a", "h5", Fraction(1, 3)), trust("c", "h5", Fraction(1, 3))]

    want = [None if e is None else (type(e).__name__, str(e))
            for e in jvs.verify_commits_batched(specs(jvs, j), provider=CPUBatchVerifier())]
    provider = Recording()
    got = [None if e is None else (type(e).__name__, str(e))
           for e in pvs.verify_commits_batched(specs(pvs, p), provider=provider, device="cpu")]
    assert got == want
    assert [g and g[0] for g in got] == [None, "ErrInvalidCommit", "ValueError", "ErrInvalidCommitSignature", None,
                                         "ErrNotEnoughVotingPower"]
    assert provider.calls == ["verify_batch"]  # sets A and C: one generic call


def test_a_key_that_is_not_ed25519_raises(world):
    """A key of neither kernel's type (not ed25519, not BLS12-381) is
    verified through its own verify(), as the JAX package's
    _serial_fill_non_ed does; one whose verify raises rejects its row, so
    the check raises where the row is needed: here the commit's first
    signer's key replaced by such a key, on both packages."""
    j, p = world

    class OtherKey:
        def __init__(self, addr):
            self.addr = addr

        def address(self):
            return self.addr

        def bytes(self):
            return b"\x07" * 33

    first = next(cs for cs in p["h2"].commit.signatures if not cs.absent_())

    def other_set(vs, validator_cls):
        return [validator_cls(OtherKey(v.address), v.voting_power) if v.address == first.validator_address
                else validator_cls(v.pub_key, v.voting_power) for v in vs.validators]

    jset = jvs.ValidatorSet(other_set(j["a"], Validator))
    want = outcome(lambda: jset.verify_commit_trusting(CHAIN, j["h2"].commit.block_id, 2, j["h2"].commit,
                                                       pver.DEFAULT_TRUST_LEVEL, provider=CPUBatchVerifier()))
    pset = PortValidatorSet(other_set(p["a"], PortValidator))
    got = outcome(lambda: pset.verify_commit_trusting(CHAIN, p["h2"].commit.block_id, 2, p["h2"].commit,
                                                      pver.DEFAULT_TRUST_LEVEL, device="cpu"))
    assert got == want and got[0] == "ErrInvalidCommitSignature", (got, want)
