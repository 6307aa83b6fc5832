"""ValidatorSet: the validators of a height, their merkle root, and
commit verification.

The port's copy of the JAX package's ``types/validator_set.py``:
construction (sorted by address, proposer priorities as the reference
initialises them), ``total_voting_power``, ``get_by_address``, ``hash``,
``verify_commit``, the light client's ``verify_commit_trusting``, and
``verify_commits_batched``, which checks many commits (of one set or of
several) in one device call.

Neither verifies signature by signature as the reference does
(types/validator_set.go:641-668, :754): they pack every present
signature into rectangular arrays, make one device call, and replay the
reference's sequential early-return over the verdicts, so they accept
exactly what the serial loop accepts. The device call is the provider's
per-valset tabled path (``verify_rows_cached_templated``: the set's
tables, built once, and the commit's sign-bytes as two templates and
per-row timestamps) and, where the provider has none, the generic path
(``verify_commit_batch``, with the voting-power tally fused into the
last kernel). On the tabled path the tally is summed on the host.

A set may hold BLS12-381 keys. In a set with any, the ed25519 rows take
the paths above and the BLS rows (a 96-byte signature each) go to the
BLS provider (``crypto/bls.py``) in one call: one launch maps their
messages to G2 and one checks their pairings. ``verify_commit`` of an
``AggregatedCommit`` (one aggregate signature and a signer bitmap) goes
to ``verify_aggregated_commit``: the proof-of-possession gate, the
quorum over the bitmap, then one aggregate, one map and one pairing
launch. ``device=`` reaches the BLS provider too. Not here yet: the
signature cache, and key types other than ed25519 and BLS12-381.
"""

from __future__ import annotations

import hashlib
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch.codec.signbytes import splice_timestamps
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.batch import BatchVerifier, default_provider
from tendermint_tpu_torch.crypto.keys import is_batch_ed25519
from tendermint_tpu_torch.types.block import MAX_SIGNATURE_SIZE, BlockID, Commit
from tendermint_tpu_torch.types.validator import Validator

MAX_TOTAL_VOTING_POWER = (1 << 63) // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


class ErrTotalVotingPowerOverflow(Exception):
    pass


class ErrNotEnoughVotingPower(Exception):
    pass


class ErrInvalidCommitSignature(Exception):
    pass


class ErrInvalidCommit(Exception):
    pass


def _safe_add(a: int, b: int) -> int:
    """int64 addition clipped like the reference's safeAdd."""
    c = a + b
    hi, lo = (1 << 63) - 1, -(1 << 63)
    return hi if c > hi else lo if c < lo else c


class ValidatorSet:
    def __init__(self, validators: Sequence[Validator]):
        vals = sorted((v.copy() for v in validators), key=lambda v: v.address)
        addrs = [v.address for v in vals]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        self.validators: List[Validator] = vals
        self._addr_index = {a: i for i, a in enumerate(addrs)}
        self.proposer: Optional[Validator] = None
        self._total_voting_power = self._sum_voting_power()
        self._arrays: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._ed: Optional[np.ndarray] = None
        self._bls: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._dev_key: Optional[bytes] = None
        self._hash: Optional[bytes] = None
        if vals:
            self._increment_proposer_priority()

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def get_by_address(self, addr: bytes) -> Tuple[int, Optional[Validator]]:
        i = self._addr_index.get(addr)
        if i is None:
            return -1, None
        return i, self.validators[i]

    def hash(self, device=None) -> bytes:
        """The merkle root of the validators' (pubkey, power) encodings
        (reference ValidatorSet.Hash, types/validator_set.go:307), on
        `device` above the merkle threshold. Memoised: the port's sets
        never change membership or power after construction, and
        proposer priorities are not part of the hash."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([v.hash_bytes() for v in self.validators], device=device)
        return self._hash

    def _sum_voting_power(self) -> int:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ErrTotalVotingPowerOverflow(total)
        return total

    # -- proposer priority at construction (reference :86-:189) -----------

    def _increment_proposer_priority(self) -> None:
        """IncrementProposerPriority(1): rescale, centre, one round."""
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self._total_voting_power
        ps = [v.proposer_priority for v in self.validators]
        diff = max(ps) - min(ps)
        if diff_max > 0 and diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                p = v.proposer_priority
                v.proposer_priority = -((-p) // ratio) if p < 0 else p // ratio
        avg = sum(v.proposer_priority for v in self.validators) // len(self.validators)
        for v in self.validators:
            v.proposer_priority = _safe_add(v.proposer_priority, -avg)
        for v in self.validators:
            v.proposer_priority = _safe_add(v.proposer_priority, v.voting_power)
        most = self.validators[0]
        for v in self.validators[1:]:
            most = most.compare_proposer_priority(v)
        most.proposer_priority = _safe_add(most.proposer_priority, -self._total_voting_power)
        self.proposer = most

    # -- commit verification -------------------------------------------------

    def _device_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(V, 32) uint8 ed25519 pubkeys (zero rows for other key types)
        and (V,) int64 powers, built once with one join."""
        if self._arrays is None:
            zero = bytes(32)
            raw = b"".join(v.pub_key.bytes() if ed else zero for v, ed in zip(self.validators, self._ed_mask()))
            pk = np.frombuffer(raw, dtype=np.uint8).reshape(len(self.validators), 32)
            powers = np.asarray([v.voting_power for v in self.validators], dtype=np.int64)
            self._arrays = (pk, powers)
        return self._arrays

    def _ed_mask(self) -> np.ndarray:
        """(V,) bool: the validators whose rows the ed25519 kernels take."""
        if self._ed is None:
            self._ed = np.asarray([is_batch_ed25519(v.pub_key) for v in self.validators], dtype=bool)
        return self._ed

    def bls_cache(self) -> Tuple[np.ndarray, np.ndarray]:
        """(V, 48) uint8 BLS pubkeys (zero rows for other key types) and
        the (V,) BLS mask, built once (the JAX package's bls_cache; the
        port's sets never change membership)."""
        if self._bls is None:
            from tendermint_tpu_torch.crypto.bls import is_batch_bls

            pk = np.zeros((len(self.validators), 48), dtype=np.uint8)
            mask = np.zeros(len(self.validators), dtype=bool)
            for i, v in enumerate(self.validators):
                if is_batch_bls(v.pub_key):
                    pk[i] = np.frombuffer(v.pub_key.bytes(), dtype=np.uint8)
                    mask[i] = True
            self._bls = (pk, mask)
        return self._bls

    def batch_cache(self) -> Tuple[bytes, np.ndarray]:
        """(key, pubkeys (V, 32)) for providers with per-valset tables:
        the key is the SHA-256 of the pubkey matrix, which is exactly
        what the tables depend on."""
        pk, _ = self._device_arrays()
        if self._dev_key is None:
            self._dev_key = hashlib.sha256(pk.tobytes()).digest()
        return self._dev_key, pk

    def _commit_batch_arrays(self, chain_id: str, commit: Commit, by_address: bool = False):
        """The present signatures as rectangular arrays: (idxs, vals_idx
        (N,), sigs (N,64), powers (N,), counted (N,), sig_ok (N,), tpl).
        Row r is signature idxs[r] of validator vals_idx[r]: with
        `by_address=False` signature i is validator i's (a commit of this
        set); with `by_address=True` each signer is looked up by address
        and unknown ones are skipped (a commit of another set). tpl is
        (templates (2,160), tmpl_idx (N,), ts8 (N,8)), the rows' templated
        sign-bytes (``Commit.sign_bytes_parts``).

        sig_ok is False for a signature that is not 64 bytes long: the
        reference's serial verify rejects those, so they must not be
        padded or cut into the batch where a prefix could verify."""
        idxs: List[int] = []
        vals: List[int] = []
        parts: List[bytes] = []
        sig_ok: List[bool] = []
        counted: List[bool] = []
        for i, cs in enumerate(commit.signatures):
            if cs.absent_():
                continue
            sig = cs.signature
            if len(sig) > MAX_SIGNATURE_SIZE:
                raise ErrInvalidCommit(f"signature #{i} too big ({len(sig)})")
            if by_address:
                vi = self._addr_index.get(cs.validator_address)
                if vi is None:
                    continue
            else:
                vi = i
            idxs.append(i)
            vals.append(vi)
            ok = len(sig) == 64
            sig_ok.append(ok)
            parts.append(sig if ok else sig[:64].ljust(64, b"\x00"))
            counted.append(cs.for_block())
        n = len(idxs)
        _, all_powers = self._device_arrays()
        vals_idx = np.asarray(vals, dtype=np.int64)
        rows = np.asarray(idxs, dtype=np.int64)
        templates, tmpl_idx, ts8 = commit.sign_bytes_parts(chain_id)
        sigs = np.frombuffer(b"".join(parts), dtype=np.uint8).reshape(n, 64)
        return (
            idxs, vals_idx, sigs, all_powers[vals_idx], np.asarray(counted, dtype=bool),
            np.asarray(sig_ok, dtype=bool), (templates, tmpl_idx[rows], ts8[rows]),
        )

    def _rows_cached(self, provider, vals_idx, sigs, tpl) -> Optional[np.ndarray]:
        """The provider's per-valset tabled path, with the rows'
        templated sign-bytes (12 message bytes a row go to the device
        instead of 160); None: use the generic path."""
        key, all_pk = self.batch_cache()
        out = provider.verify_rows_cached_templated(
            key, all_pk, np.asarray(vals_idx, dtype=np.int32), tpl[0], tpl[1], tpl[2], sigs)
        return None if out is None else np.asarray(out, dtype=bool)

    def _verify_commit_basic(self, commit: Commit, height: int, block_id: BlockID) -> None:
        """Structural validity, height and BlockID (reference
        verifyCommitBasic, types/validator_set.go:813)."""
        err = commit.validate_basic()
        if err:
            raise ErrInvalidCommit(err)
        if height != commit.height:
            raise ErrInvalidCommit(f"wrong height: {height} vs {commit.height}")
        if block_id != commit.block_id:
            raise ErrInvalidCommit(f"wrong block ID: {block_id} vs {commit.block_id}")

    def _check_commit_size(self, commit: Commit) -> None:
        if len(self.validators) != len(commit.signatures):
            raise ErrInvalidCommit(
                f"wrong set size: {len(self.validators)} vs {len(commit.signatures)}"
            )

    def verify_commit(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit,
        provider: Optional[BatchVerifier] = None,
        device=None,
    ) -> None:
        """Verify that +2/3 of this set signed `block_id` at `height`.

        Reference semantics (types/validator_set.go:629-668): signatures in
        order, fail on the first invalid one, succeed as soon as the tallied
        for-block power exceeds 2/3 of the total. `provider` defaults to the
        default provider of `device` (the card unless "cpu" is asked for):
        the one given to ``crypto.batch.set_default_provider``, else a
        shared TorchBatchVerifier; BLS rows go to the shared
        BLSBatchVerifier there. An
        AggregatedCommit goes to ``verify_aggregated_commit``.
        """
        from tendermint_tpu_torch.types.aggregate import AggregatedCommit

        if isinstance(commit, AggregatedCommit):
            return self.verify_aggregated_commit(chain_id, block_id, height, commit, device)
        self._check_commit_size(commit)
        self._verify_commit_basic(commit, height, block_id)
        idxs, vals_idx, sigs, powers, counted, sig_ok, tpl = self._commit_batch_arrays(chain_id, commit)
        v = provider if provider is not None else default_provider(device)
        ed_rows = self._ed_mask()[vals_idx]
        if not ed_rows.all():
            ok = self._verify_mixed(commit, idxs, vals_idx, sigs, sig_ok, tpl, ed_rows, v, device)
            talled = int(powers[ok & counted].sum())
        else:
            ok = self._rows_cached(v, vals_idx, sigs, tpl) if idxs else np.zeros(0, dtype=bool)
            if ok is not None:
                ok = ok & sig_ok
                talled = int(powers[ok & counted].sum())
            else:
                pk = self._device_arrays()[0][vals_idx]
                msgs = splice_timestamps(tpl[0][tpl[1]], tpl[2])
                ok, talled = v.verify_commit_batch(pk, msgs, sigs, powers, counted & sig_ok)
                ok = np.asarray(ok, dtype=bool) & sig_ok
        self._replay_commit_full(commit, ok, idxs, powers, counted, talled)

    def _verify_mixed(self, commit, idxs, vals_idx, sigs, sig_ok, tpl, ed_rows, provider, device) -> np.ndarray:
        """Verdicts of a commit's rows in a set that is not all ed25519:
        the ed25519 rows on the provider's tabled path (the generic one
        where it has none), the others by ``_fill_non_ed``."""
        ok = np.zeros(len(idxs), dtype=bool)
        sub = np.flatnonzero(ed_rows)
        if sub.size:
            sub_tpl = (tpl[0], tpl[1][sub], tpl[2][sub])
            got = self._rows_cached(provider, vals_idx[sub], sigs[sub], sub_tpl)
            if got is None:
                pk = self._device_arrays()[0][vals_idx[sub]]
                got = provider.verify_batch(pk, splice_timestamps(sub_tpl[0][sub_tpl[1]], sub_tpl[2]), sigs[sub])
            ok[sub] = np.asarray(got, dtype=bool) & sig_ok[sub]
        rest = np.flatnonzero(~ed_rows)
        msgs = splice_timestamps(tpl[0][tpl[1][rest]], tpl[2][rest])
        ok[rest] = self._fill_non_ed(commit, [idxs[r] for r in rest], vals_idx[rest], msgs, device)
        return ok

    def _fill_non_ed(self, commit, sig_idx, vals_idx, msgs, device) -> np.ndarray:
        """Verdicts of rows whose validator is not ed25519 (the JAX
        package's _serial_fill_non_ed): the BLS rows with a signature of
        exactly 96 bytes to the BLS provider in one call, every other row
        through its own key's serial verify (a BLS key rejects a signature
        of any other length; padding one into the batch could make a
        valid encoding of it). A key whose verify raises rejects its row."""
        from tendermint_tpu_torch.crypto.bls import BLS_SIGNATURE_SIZE, get_default_bls_provider, is_batch_bls

        n = len(sig_idx)
        ok = np.zeros(n, dtype=bool)
        batch, rest = [], []
        for j in range(n):
            v = self.validators[int(vals_idx[j])]
            sig = commit.signatures[sig_idx[j]].signature
            (batch if is_batch_bls(v.pub_key) and len(sig) == BLS_SIGNATURE_SIZE else rest).append(j)
        if batch:
            pk = np.stack([np.frombuffer(self.validators[int(vals_idx[j])].pub_key.bytes(), dtype=np.uint8)
                           for j in batch])
            sg = np.stack([np.frombuffer(commit.signatures[sig_idx[j]].signature, dtype=np.uint8) for j in batch])
            ok[batch] = np.asarray(get_default_bls_provider(device).verify_batch(pk, msgs[batch], sg), dtype=bool)
        for j in rest:
            v = self.validators[int(vals_idx[j])]
            try:
                ok[j] = bool(v.pub_key.verify(msgs[j].tobytes(), commit.signatures[sig_idx[j]].signature))
            except Exception:  # an invalid signature for that row, never an abort of the batch
                ok[j] = False
        return ok

    def verify_aggregated_commit(self, chain_id: str, block_id: BlockID, height: int, agg_commit,
                                 device=None) -> None:
        """Verify +2/3 of this set signed `block_id` at `height` as ONE
        aggregate BLS signature over the canonical commit message
        (types/aggregate.AggregatedCommit), with the JAX package's checks,
        error classes and messages: the quorum is tallied over the signer
        bitmap, every flagged signer must hold a BLS key with a verified
        proof of possession (the rogue-key defense), then one pairing check
        against the aggregated pubkey of the set bits."""
        from tendermint_tpu_torch.crypto.bls import get_default_bls_provider, has_possession

        err = agg_commit.validate_basic()
        if err:
            raise ErrInvalidCommit(err)
        if height != agg_commit.height:
            raise ErrInvalidCommit(f"wrong height: {height} vs {agg_commit.height}")
        if block_id != agg_commit.block_id:
            raise ErrInvalidCommit(f"wrong block ID: {block_id} vs {agg_commit.block_id}")
        if len(agg_commit.signers) != len(self.validators):
            raise ErrInvalidCommit(
                f"wrong signer bitmap size: {len(self.validators)} vs {len(agg_commit.signers)}")
        pk_table, bls_mask = self.bls_cache()
        mask = agg_commit.signers.as_numpy()
        if not bool(np.all(bls_mask[mask])):
            raise ErrInvalidCommit("aggregated commit flags a validator without a BLS key")
        for i in np.nonzero(mask)[0]:
            if not has_possession(pk_table[i].tobytes()):
                raise ErrInvalidCommit(
                    f"aggregated commit flags validator {int(i)} without a "
                    "verified proof-of-possession (rogue-key defense)")
        _, all_powers = self._device_arrays()
        talled = int(all_powers[mask].sum())
        needed = self.total_voting_power() * 2 // 3
        if talled <= needed:
            raise ErrNotEnoughVotingPower(f"have {talled}, need > {needed}")
        v = get_default_bls_provider(device)
        rows = [pk_table[i].tobytes() for i in range(len(self.validators))]
        if not v.verify_aggregate(rows, mask, agg_commit.sign_bytes(chain_id), agg_commit.agg_sig):
            raise ErrInvalidCommitSignature("aggregate signature does not verify against the signer set")

    def _replay_commit_full(self, commit: Commit, ok, idxs, powers, counted, talled: int) -> None:
        """The reference's sequential early-return acceptance (loop at
        types/validator_set.go:641-668) over the batched verdicts, in
        closed form. The loop returns as soon as the power tallied before
        a row exceeds 2/3, so it reaches the first bad row only if the
        tally before that row is still <= 2/3. With no bad row it ends
        with every counted row's power tallied: `talled`, the sum over
        the rows that are ok and counted."""
        needed = self.total_voting_power() * 2 // 3
        bad = np.flatnonzero(~ok)
        if bad.size:
            r = int(bad[0])
            if int(powers[:r][counted[:r]].sum()) > needed:
                return
            i = idxs[r]
            raise ErrInvalidCommitSignature(
                f"wrong signature #{i} ({commit.signatures[i].validator_address.hex()})"
            )
        if talled > needed:
            return
        raise ErrNotEnoughVotingPower(f"have {talled}, need > {needed}")

    @staticmethod
    def _validate_trust_level(trust_level) -> None:
        """Trust level must be in [1/3, 1] (reference ValidateTrustLevel)."""
        if (
            trust_level is None
            or trust_level.denominator == 0
            or trust_level.numerator * 3 < trust_level.denominator
            or trust_level.numerator > trust_level.denominator
        ):
            raise ValueError(f"trust level must be within [1/3, 1], got {trust_level}")

    def verify_commit_trusting(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit: Commit,
        trust_level: Fraction,
        provider: Optional[BatchVerifier] = None,
        device=None,
    ) -> None:
        """Verify that `trust_level` (e.g. 1/3) of THIS set signed the
        commit, looking signers up by address: the commit may come from
        another set (reference VerifyCommitTrusting,
        types/validator_set.go:754, with verifyCommitBasic; the light
        client's check). The rows read this set's tables through their
        validator index, which here is a subset of the set and may repeat
        a validator. A repeated validator is rejected in the replay,
        where the reference's loop meets it: one after quorum does not
        reject."""
        self._validate_trust_level(trust_level)
        self._verify_commit_basic(commit, height, block_id)
        idxs, vals_idx, sigs, powers, counted, sig_ok, tpl = self._commit_batch_arrays(
            chain_id, commit, by_address=True)
        v = provider if provider is not None else default_provider(device)
        ed_rows = self._ed_mask()[vals_idx]
        if not ed_rows.all():
            ok = self._verify_mixed(commit, idxs, vals_idx, sigs, sig_ok, tpl, ed_rows, v, device)
        else:
            ok = self._rows_cached(v, vals_idx, sigs, tpl) if idxs else np.zeros(0, dtype=bool)
            if ok is None:
                pk = self._device_arrays()[0][vals_idx]
                ok = np.asarray(v.verify_batch(pk, splice_timestamps(tpl[0][tpl[1]], tpl[2]), sigs), dtype=bool)
            ok = ok & sig_ok
        self._replay_commit_trusting(ok, idxs, vals_idx, powers, counted, trust_level)

    def _replay_commit_trusting(self, ok, idxs, vals_idx, powers, counted, trust_level: Fraction) -> None:
        """The reference's trusting loop (types/validator_set.go:754
        region) in closed form. At each row the loop first returns if
        the power tallied so far exceeds the trust level's share, then
        rejects a validator it has seen before, then a bad signature,
        then tallies the row. Every row before the first rejected one
        was tallied, so the loop returns early iff the tally before some
        row at or before that one exceeds the share."""
        needed = self.total_voting_power() * trust_level.numerator // trust_level.denominator
        vals = np.asarray(vals_idx, dtype=np.int64)
        n = vals.shape[0]
        contrib = np.where(np.asarray(counted, dtype=bool), np.asarray(powers, dtype=np.int64), 0)
        before = np.cumsum(contrib) - contrib
        first = np.zeros(n, dtype=bool)
        first[np.unique(vals, return_index=True)[1]] = True
        bad = np.flatnonzero(~first | ~np.asarray(ok, dtype=bool))
        r_bad = int(bad[0]) if bad.size else n
        if np.any(before[: r_bad + 1] > needed):
            return
        if r_bad < n:
            if not first[r_bad]:
                raise ErrInvalidCommit(f"double vote from validator index {int(vals[r_bad])}")
            raise ErrInvalidCommitSignature(f"wrong signature #{idxs[r_bad]}")
        talled = int(contrib.sum())
        if talled > needed:
            return
        raise ErrNotEnoughVotingPower(f"have {talled}, need > {needed}")


# -- many commits in one device call -------------------------------------------


class CommitVerifySpec:
    """One commit check inside a multi-commit batch: ``mode`` "full"
    (``verify_commit``) or "trusting" (``verify_commit_trusting``, with
    ``trust_level``)."""

    __slots__ = ("valset", "chain_id", "block_id", "height", "commit", "mode", "trust_level")

    def __init__(self, valset, chain_id, block_id, height, commit, mode="full", trust_level=None):
        self.valset = valset
        self.chain_id = chain_id
        self.block_id = block_id
        self.height = height
        self.commit = commit
        self.mode = mode
        self.trust_level = trust_level


def verify_commits_batched(
    specs: Sequence[CommitVerifySpec],
    provider: Optional[BatchVerifier] = None,
    device=None,
) -> List[Optional[Exception]]:
    """Verify many commits (typically of many heights) in one device
    call (the JAX package's ``verify_commits_batched``): one entry per
    spec, None where it is accepted, else the exception the direct
    method call would have raised. Each spec's host checks run first; a
    spec that fails them adds no rows. Each spec's acceptance is then
    replayed on its slice of the verdicts.

    When every spec checks against one validator set (the light client's
    sequential shape), the rows go to the provider's per-valset tabled
    path in one call, with each spec's two sign-bytes templates stacked;
    otherwise (or where the tabled path answers None) to the generic
    ``verify_batch`` in one call. A signature that is not 64 bytes long
    is rejected, as in ``verify_commit``. Where any row's validator is
    not ed25519, the ed25519 rows of all specs go to ``verify_batch`` in
    one call and each spec's other rows to ``_fill_non_ed`` (the JAX
    package's mixed branch)."""
    results: List[Optional[Exception]] = [None] * len(specs)
    segments = []  # (spec index, idxs, vals_idx, powers, counted, tpl)
    vals_parts, sig_parts, ok_parts, tpl_parts, tidx_parts, ts8_parts, pk_parts = [], [], [], [], [], [], []
    for si, s in enumerate(specs):
        try:
            if s.mode == "trusting":
                ValidatorSet._validate_trust_level(s.trust_level)
            else:
                s.valset._check_commit_size(s.commit)
            s.valset._verify_commit_basic(s.commit, s.height, s.block_id)
            idxs, vals_idx, sigs, powers, counted, sig_ok, tpl = s.valset._commit_batch_arrays(
                s.chain_id, s.commit, by_address=(s.mode == "trusting"))
        except Exception as e:  # the spec's verdict is the exception itself
            results[si] = e
            continue
        segments.append((si, idxs, vals_idx, powers, counted, tpl))
        vals_parts.append(vals_idx)
        sig_parts.append(sigs)
        ok_parts.append(sig_ok)
        tidx_parts.append(tpl[1] + 2 * len(tpl_parts))  # into the stacked (2S, 160) templates
        tpl_parts.append(tpl[0])
        ts8_parts.append(tpl[2])
        pk_parts.append(s.valset._device_arrays()[0][vals_idx])
    if not segments:
        return results
    sigs = np.concatenate(sig_parts)
    templates, tmpl_idx, ts8 = np.concatenate(tpl_parts), np.concatenate(tidx_parts), np.concatenate(ts8_parts)
    v = provider if provider is not None else default_provider(device)
    ok = None
    key0, all_pk0 = specs[segments[0][0]].valset.batch_cache()
    ed_rows = np.concatenate([specs[seg[0]].valset._ed_mask()[seg[2]] for seg in segments])
    if not ed_rows.all():
        ok = np.zeros(len(ed_rows), dtype=bool)
        sub = np.flatnonzero(ed_rows)
        if sub.size:
            ok[sub] = np.asarray(v.verify_batch(np.concatenate(pk_parts)[sub],
                                                splice_timestamps(templates[tmpl_idx[sub]], ts8[sub]), sigs[sub]),
                                 dtype=bool)
        off = 0
        for si, idxs, vals_idx, _p, _c, tpl in segments:
            n = len(idxs)
            rest = np.flatnonzero(~ed_rows[off:off + n])
            msgs = splice_timestamps(tpl[0][tpl[1][rest]], tpl[2][rest])
            ok[off + rest] = specs[si].valset._fill_non_ed(specs[si].commit, [idxs[r] for r in rest], vals_idx[rest],
                                                           msgs, device)
            off += n
    elif sigs.shape[0] == 0:
        ok = np.zeros(0, dtype=bool)
    elif all(specs[seg[0]].valset.batch_cache()[0] == key0 for seg in segments[1:]):
        all_idx = np.concatenate(vals_parts).astype(np.int32)
        ok = v.verify_rows_cached_templated(key0, all_pk0, all_idx, templates, tmpl_idx, ts8, sigs)
        if ok is None:
            ok = v.verify_rows_cached(key0, all_pk0, all_idx, splice_timestamps(templates[tmpl_idx], ts8), sigs)
    if ok is None:
        ok = v.verify_batch(np.concatenate(pk_parts), splice_timestamps(templates[tmpl_idx], ts8), sigs)
    ok = np.asarray(ok, dtype=bool) & (np.concatenate(ok_parts) | ~ed_rows)
    off = 0
    for si, idxs, vals_idx, powers, counted, _tpl in segments:
        s = specs[si]
        n = len(idxs)
        ok_slice = ok[off:off + n]
        off += n
        try:
            if s.mode == "trusting":
                s.valset._replay_commit_trusting(ok_slice, idxs, vals_idx, powers, counted, s.trust_level)
            else:
                talled = int(powers[ok_slice & counted].sum())
                s.valset._replay_commit_full(s.commit, ok_slice, idxs, powers, counted, talled)
        except Exception as e:  # the spec's verdict is the exception itself
            results[si] = e
    return results
