"""The port's BLS entry points (device="cpu": the kernels' plain
versions) against the JAX package's, with its host-only default BLS
provider, on the cases of tests/test_bls.py.

BLS validator sets and commits are built with the JAX package's keys and
types, carried across by ``tendermint_tpu_torch.convert`` (pubkeys as
their registry encodings, commits as arrays), and verified by both. Each
case must end the same way on both sides: pass, or raise the same error
class with the same message. Both packages' proof-of-possession
registries are filled from the same proofs.

Left out: test_bls_cache_invalidates_on_set_mutation (the port's sets are
immutable), and secp256k1 in the mixed set (the port has ed25519 and
bls12-381 keys).
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls as jbls
from tendermint_tpu.crypto.keys import Ed25519PrivKey
from tendermint_tpu.types.aggregate import AggregatedCommit, aggregate_commit_votes
from tendermint_tpu.types.block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, PartSetHeader
from tendermint_tpu.types.validator import Validator
from tendermint_tpu.types import validator_set as jvalset
from tendermint_tpu.types.validator_set import ValidatorSet
from tendermint_tpu.utils.bits import BitArray
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import bls as pbls
from tendermint_tpu_torch.crypto import keys as pkeys
from tendermint_tpu_torch.crypto.keys import encode_pubkey
from tendermint_tpu_torch.ops import bls12 as pops
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import validator_set as pvalset

CHAIN = "bls-test-chain"
BID = BlockID(hash=b"\x11" * 32, parts=PartSetHeader(total=1, hash=b"\x22" * 32))
TS = 1_700_000_000 * 10**9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions make tens of thousands of small torch calls; one
    intra-op thread serves them best, beside the other test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def outcome(fn):
    try:
        fn()
    except Exception as e:  # the verdict under test is the exception itself
        return type(e).__name__, str(e)
    return "ok"


def _privs(n, tag):
    return [jbls.BLSPrivKey.from_secret(tag + bytes([i])) for i in range(n)]


def _register(privs):
    """The same proofs into both registries."""
    for p in privs:
        pop = p.register_possession()
        assert pbls.register_possession(p.pub_key().bytes(), pop)


def port_set(vs):
    return convert.validator_set([encode_pubkey(v.pub_key) for v in vs.validators],
                                 np.asarray([v.voting_power for v in vs.validators]))


def port_commit(vs, c):
    return convert.commit(
        c.height, c.round, c.block_id.hash, c.block_id.parts.total, c.block_id.parts.hash,
        [encode_pubkey(v.pub_key) for v in vs.validators],
        np.asarray([cs.block_id_flag for cs in c.signatures]),
        np.asarray([cs.timestamp_ns for cs in c.signatures]), [cs.signature for cs in c.signatures])


def port_agg(a):
    return convert.aggregated_commit(a.height, a.round, a.block_id.hash, a.block_id.parts.total,
                                     a.block_id.parts.hash, a.timestamp_ns, a.signers.as_numpy(), a.agg_sig)


def both(vs, pvs, commit, height=5, bid=BID):
    """(JAX outcome, port outcome) of verify_commit on the same commit."""
    pc = port_agg(commit) if isinstance(commit, AggregatedCommit) else port_commit(vs, commit)
    pbid = pblock.BlockID(bid.hash, pblock.PartSetHeader(bid.parts.total, bid.parts.hash))
    return (outcome(lambda: vs.verify_commit(CHAIN, bid, height, commit)),
            outcome(lambda: pvs.verify_commit(CHAIN, pbid, height, pc, device="cpu")))


def _canonical_msg(height, size):
    return AggregatedCommit(height=height, round=0, block_id=BID, timestamp_ns=TS, signers=BitArray(size),
                            agg_sig=b"\x00" * 96).sign_bytes(CHAIN)


def _agg_commit(vs, by_addr, height=5, absent=(), corrupt=()):
    msg = _canonical_msg(height, len(vs.validators))
    sigs = []
    for i, val in enumerate(vs.validators):
        if i in absent:
            sigs.append(None)
            continue
        m = b"WRONG" + msg if i in corrupt else msg
        sigs.append(by_addr[val.address].sign(m))
    return aggregate_commit_votes(CHAIN, height, 0, BID, TS, len(vs.validators), sigs)


@pytest.fixture(scope="module")
def fleet():
    """Four BLS validators with registered proofs, on both sides."""
    privs = _privs(4, b"port-fleet")
    _register(privs)
    vs = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    return vs, port_set(vs), {p.pub_key().address(): p for p in privs}


# -- the provider --------------------------------------------------------------------


def test_batch_verifier_verdicts_match_serial():
    """The rows of tests/test_bls.py (a wrong message, ragged messages)
    and the same rows with a malformed pubkey in row 0, in one batch."""
    privs = _privs(4, b"t")
    msgs = [b"m%d" % i for i in range(4)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[2] = sigs[1]  # wrong message for key 2
    pk = np.stack([np.frombuffer(p.pub_key().bytes(), dtype=np.uint8) for p in privs])
    mg = np.zeros((4, 3), dtype=np.uint8)
    lens = np.zeros(4, dtype=np.int32)
    for i, m in enumerate(msgs):
        mg[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        lens[i] = len(m)
    sg = np.stack([np.frombuffer(s, dtype=np.uint8) for s in sigs])
    pk2 = pk.copy()
    pk2[0] = 0  # a malformed pubkey row can't abort the batch
    host = jbls.BLSBatchVerifier(use_device=False)
    want = list(host.verify_batch(pk, mg, sg, msg_lens=lens)) + list(host.verify_batch(pk2, mg, sg, msg_lens=lens))
    port = pbls.BLSBatchVerifier("cpu")
    got = port.verify_batch(np.concatenate([pk, pk2]), np.concatenate([mg, mg]), np.concatenate([sg, sg]),
                            msg_lens=np.concatenate([lens, lens]))
    assert list(got) == want == [True, True, False, True, False, True, False, True]
    assert port.counters["device_rows"] == 7 and port.counters["device_maps"] == 4 and port.engine.stats["device_maps"] == 1


# -- aggregated commits --------------------------------------------------------------


def test_aggregated_commit_accepts_and_roundtrips(fleet):
    vs, pvs, by_addr = fleet
    agg = _agg_commit(vs, by_addr)
    pagg = port_agg(agg)
    assert pagg.encode() == agg.encode() and pagg.hash() == agg.hash()
    rt = type(pagg).decode(pagg.encode())
    assert rt.encode() == agg.encode() and rt.wire_bytes() < 250
    pops.reset_launches()
    assert both(vs, pvs, AggregatedCommit.decode(agg.encode())) == ("ok", "ok")
    # the CPU runs the plain versions: no kernel launched
    assert pops.launches() == {"bls12_pairing_check": 0, "bls12_map_to_g2": 0, "bls12_g1_aggregate": 0}


def test_aggregated_commit_verdicts_match_per_sig_fleet(fleet):
    """Over the same vote fleets the aggregate path accepts exactly when
    per-signature verification of the equivalent Commit does, on both
    sides: full participation, one absent, sub-quorum, a corrupt signer."""
    vs, pvs, by_addr = fleet
    msg = _canonical_msg(5, 4)
    signed = {(v.address, m): by_addr[v.address].sign(m) for v in vs.validators for m in (msg, b"WRONG" + msg)}

    def fleet_sigs(absent, corrupt):
        return [None if i in absent else signed[(v.address, b"WRONG" + msg if i in corrupt else msg)]
                for i, v in enumerate(vs.validators)]

    def per_sig_commit(absent=(), corrupt=()):
        sigs = [CommitSig.absent() if sig is None else CommitSig(
            block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=v.address, timestamp_ns=TS, signature=sig)
            for v, sig in zip(vs.validators, fleet_sigs(absent, corrupt))]
        return Commit(height=5, round=0, block_id=BID, signatures=sigs)

    classes = []
    for absent, corrupt in [((), ()), ((3,), ()), ((1, 3), ()), ((), (0,))]:
        agg = both(vs, pvs, aggregate_commit_votes(CHAIN, 5, 0, BID, TS, 4, fleet_sigs(absent, corrupt)))
        per = both(vs, pvs, per_sig_commit(absent=absent, corrupt=corrupt))
        assert agg[0] == agg[1] and per[0] == per[1], (absent, corrupt, agg, per)
        assert (agg[1] == "ok") == (per[1] == "ok")
        classes.append(agg[1] if agg[1] == "ok" else agg[1][0])
    assert classes == ["ok", "ok", "ErrNotEnoughVotingPower", "ErrInvalidCommitSignature"]


def test_aggregated_commit_adversarial_rejections(fleet):
    vs, pvs, by_addr = fleet
    agg = _agg_commit(vs, by_addr, absent=(3,))
    flipped = AggregatedCommit.decode(agg.encode())
    flipped.signers.set_index(3, True)  # claims power the signature lacks
    cleared = AggregatedCommit.decode(agg.encode())
    cleared.signers.set_index(0, False)
    bad = AggregatedCommit.decode(agg.encode())
    bad.agg_sig = b"\x01" * 96
    short = AggregatedCommit(height=5, round=0, block_id=BID, timestamp_ns=TS,
                             signers=BitArray.from_bools([True] * 3), agg_sig=agg.agg_sig)
    cases = [(flipped, 5, BID, "ErrInvalidCommitSignature"), (cleared, 5, BID, "ErrNotEnoughVotingPower"),
             (bad, 5, BID, "ErrInvalidCommitSignature"), (agg, 6, BID, "ErrInvalidCommit"),
             (agg, 5, BlockID(hash=b"\x33" * 32, parts=BID.parts), "ErrInvalidCommit"),
             (short, 5, BID, "ErrInvalidCommit")]
    for commit, height, bid, cls in cases:
        want, got = both(vs, pvs, commit, height, bid)
        assert want == got and got[0] == cls, (want, got)


def test_aggregated_commit_requires_pop():
    privs = _privs(4, b"port-pop")
    vs = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    pvs = port_set(vs)
    by_addr = {p.pub_key().address(): p for p in privs}
    agg = _agg_commit(vs, by_addr)
    want, got = both(vs, pvs, agg)
    assert want == got and got[0] == "ErrInvalidCommit" and "proof-of-possession" in got[1]
    _register(privs)
    assert both(vs, pvs, agg) == ("ok", "ok")
    # a rogue key can never register: its "owner" has no secret for it
    atk = jbls.BLSPrivKey.from_secret(b"port-pop-atk")
    victim = pbls.decode_pubkey_point(privs[0].pub_key().bytes())
    ref = pops.ref
    rogue = ref.g1_compress(ref.g1_add(ref.sk_to_pk(atk._sk), ref.g1_neg(victim)))
    assert not pbls.register_possession(rogue, atk.prove_possession())
    assert not pbls.has_possession(rogue) and not jbls.has_possession(rogue)


def test_aggregated_commit_requires_bls_keys():
    bls = _privs(3, b"t")
    ed = Ed25519PrivKey.from_secret(b"ed")
    vs = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in bls]
                      + [Validator(pub_key=ed.pub_key(), voting_power=10)])
    signers = BitArray(4)
    for i in range(4):
        signers.set_index(i, True)
    agg = AggregatedCommit(height=5, round=0, block_id=BID, timestamp_ns=TS, signers=signers, agg_sig=b"\x01" * 96)
    want, got = both(vs, port_set(vs), agg)
    assert want == got == ("ErrInvalidCommit", "aggregated commit flags a validator without a BLS key")


# -- per-signature BLS commits -------------------------------------------------------


def test_per_sig_bls_commit_via_batch_provider():
    privs = _privs(3, b"p")
    vs = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    pvs = port_set(vs)
    by_addr = {p.pub_key().address(): p for p in privs}
    sigs = [CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=val.address, timestamp_ns=TS + i,
                      signature=b"") for i, val in enumerate(vs.validators)]
    commit = Commit(height=5, round=0, block_id=BID, signatures=sigs)
    for i, val in enumerate(vs.validators):
        commit.signatures[i].signature = by_addr[val.address].sign(commit.vote_sign_bytes(CHAIN, i))
    assert both(vs, pvs, commit) == ("ok", "ok")
    commit.signatures[1].signature = commit.signatures[0].signature
    want, got = both(vs, pvs, commit)
    assert want == got and got[0] == "ErrInvalidCommitSignature"


def test_mixed_key_valset_per_row_fallback():
    """A set of ed25519 and BLS keys: each row goes by its key type, and
    a corrupt signature in any row, or too little power, rejects; also
    through verify_commits_batched's mixed branch."""
    eds = [Ed25519PrivKey.from_secret(b"mixed-ed-%d" % i) for i in range(2)]
    bls = _privs(2, b"mixed-bls")
    signers = {k.pub_key().address(): k for k in eds + bls}
    vs = ValidatorSet([Validator(pub_key=k.pub_key(), voting_power=10) for k in eds + bls])
    pvs = port_set(vs)

    def build():
        sigs = [CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=val.address, timestamp_ns=TS + i,
                          signature=b"") for i, val in enumerate(vs.validators)]
        c = Commit(height=5, round=0, block_id=BID, signatures=sigs)
        for i, val in enumerate(vs.validators):
            c.signatures[i].signature = signers[val.address].sign(c.vote_sign_bytes(CHAIN, i))
        return c

    assert both(vs, pvs, build()) == ("ok", "ok")
    ed_row = next(i for i, v in enumerate(vs.validators) if len(v.pub_key.bytes()) == 32)
    bls_row = next(i for i, v in enumerate(vs.validators) if len(v.pub_key.bytes()) == 48)
    def corrupt(row):
        c = build()
        sig = bytearray(c.signatures[row].signature)
        sig[-1] ^= 1
        c.signatures[row].signature = bytes(sig)
        return c

    want, got = both(vs, pvs, corrupt(ed_row))
    assert want == got and got[0] == "ErrInvalidCommitSignature"
    # a corrupt BLS row through the mixed branch of verify_commits_batched,
    # beside a spec that fails its checks (a wrong height) and adds no rows
    c = corrupt(bls_row)
    pc = port_commit(vs, c)
    pbid = pblock.BlockID(BID.hash, pblock.PartSetHeader(BID.parts.total, BID.parts.hash))
    want = [None if e is None else (type(e).__name__, str(e)) for e in jvalset.verify_commits_batched(
        [jvalset.CommitVerifySpec(vs, CHAIN, BID, 5, c), jvalset.CommitVerifySpec(vs, CHAIN, BID, 6, c)])]
    got = [None if e is None else (type(e).__name__, str(e)) for e in pvalset.verify_commits_batched(
        [pvalset.CommitVerifySpec(pvs, CHAIN, pbid, 5, pc), pvalset.CommitVerifySpec(pvs, CHAIN, pbid, 6, pc)],
        device="cpu")]
    assert got == want and [g[0] for g in got] == ["ErrInvalidCommitSignature", "ErrInvalidCommit"]
    # a 64-byte signature on a BLS row (the other BLS row absent)
    other_bls = next(i for i, v in enumerate(vs.validators) if len(v.pub_key.bytes()) == 48 and i != bls_row)
    c = build()
    c.signatures[bls_row].signature = c.signatures[ed_row].signature
    c.signatures[other_bls] = CommitSig.absent()
    want, got = both(vs, pvs, c)
    assert want == got and got[0] == "ErrInvalidCommitSignature"
    # the BLS rows absent: the ed25519 rows alone are too little power
    c = build()
    for i in (bls_row, other_bls):
        c.signatures[i] = CommitSig.absent()
    want, got = both(vs, pvs, c)
    assert want == got and got[0] == "ErrNotEnoughVotingPower"


def test_commitsig_validate_accepts_96_byte_sigs():
    cs = pblock.CommitSig(BLOCK_ID_FLAG_COMMIT, b"\x01" * 20, TS, b"\x02" * 96)
    assert cs.validate_basic() is None
    cs.signature = b"\x02" * 97
    assert cs.validate_basic() == "signature too big"
    assert pblock.CommitSig.absent().validate_basic() is None
    assert BLOCK_ID_FLAG_ABSENT == pblock.BLOCK_ID_FLAG_ABSENT


def test_validator_leaf_bytes_match_jax():
    keys = [jbls.BLSPrivKey.from_secret(b"leaf").pub_key(), Ed25519PrivKey.from_secret(b"leaf").pub_key()]
    vs = ValidatorSet([Validator(pub_key=k, voting_power=7 + i) for i, k in enumerate(keys)])
    pvs = port_set(vs)
    assert [v.hash_bytes() for v in pvs.validators] == [v.hash_bytes() for v in vs.validators]
    assert pvs.hash(device="cpu") == vs.hash()


# -- the pubkey registry ---------------------------------------------------------------


def test_pubkey_registry_roundtrip_every_type():
    ed = pkeys.Ed25519PrivKey.from_secret(b"rt-ed").pub_key()
    bls = pbls.BLSPrivKey.from_secret(b"rt-bls").pub_key()
    samples = {"ed25519": ed, "bls12-381": bls}
    assert set(samples) <= set(pkeys.registered_pubkey_types())
    for name, pk in samples.items():
        enc = pkeys.encode_pubkey(pk)
        dec = pkeys.decode_pubkey(enc)
        assert dec.type_name == name == pk.type_name
        assert dec.bytes() == pk.bytes() and dec.address() == pk.address()
        assert pkeys.encode_pubkey(dec) == enc
    # the JAX package's encodings and keys are the same bytes
    from tendermint_tpu.crypto.keys import encode_pubkey as jenc

    assert jenc(jbls.BLSPrivKey.from_secret(b"rt-bls").pub_key()) == pkeys.encode_pubkey(bls)
    assert jenc(Ed25519PrivKey.from_secret(b"rt-ed").pub_key()) == pkeys.encode_pubkey(ed)


def test_pubkey_registry_typed_errors():
    enc = pkeys.encode_pubkey(pkeys.Ed25519PrivKey.from_secret(b"te").pub_key())
    with pytest.raises(pkeys.ErrUnknownPubKeyType):
        pkeys.decode_pubkey(b"\x08unknown!\x00")
    for bad in (enc[:5], enc[:-3], enc + b"xx", b"", b"\xff\xff"):
        with pytest.raises(pkeys.ErrMalformedPubKey):
            pkeys.decode_pubkey(bad)
    with pytest.raises(pkeys.ErrMalformedPubKey):
        pkeys.decode_pubkey(b"\x07ed25519\x05abcde")
    with pytest.raises(pkeys.ErrMalformedPubKey):
        pkeys.decode_pubkey(b"\x09bls12-381\x05abcde")
    assert issubclass(pkeys.ErrUnknownPubKeyType, ValueError)
    assert issubclass(pkeys.ErrMalformedPubKey, ValueError)
