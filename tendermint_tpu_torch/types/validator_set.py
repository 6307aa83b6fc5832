"""ValidatorSet: the validators of a height, and commit verification.

The port's copy of the JAX package's ``types/validator_set.py``:
construction (sorted by address, proposer priorities as the reference
initialises them), ``total_voting_power`` and ``verify_commit``.

``verify_commit`` does not verify signature by signature as the reference
does (types/validator_set.go:641-668): it packs every present signature
into rectangular arrays, makes ONE ``BatchVerifier.verify_commit_batch``
call (the three ed25519 kernels with the voting-power tally fused into
the last), and replays the reference's sequential early-return over the
returned verdicts and tally, so it accepts exactly what the serial loop
accepts.
Not here yet: the signature cache, aggregated (BLS) commits, and the
per-valset tabled path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch.crypto.batch import BatchVerifier, TorchBatchVerifier
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
        self.proposer: Optional[Validator] = None
        self._total_voting_power = self._sum_voting_power()
        self._arrays: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if vals:
            self._increment_proposer_priority()

    def total_voting_power(self) -> int:
        return self._total_voting_power

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
        """(V, 32) uint8 pubkeys and (V,) int64 powers, built once."""
        if self._arrays is None:
            pk = np.frombuffer(b"".join(v.pub_key.bytes() for v in self.validators), dtype=np.uint8)
            powers = np.asarray([v.voting_power for v in self.validators], dtype=np.int64)
            self._arrays = (pk.reshape(len(self.validators), 32), powers)
        return self._arrays

    def _commit_batch_arrays(self, chain_id: str, commit: Commit):
        """The present signatures as rectangular arrays: (idxs, pubkeys
        (N,32), msgs (N,160), sigs (N,64), powers (N,), counted (N,),
        sig_ok (N,)). Row r is signature idxs[r] of validator idxs[r].

        sig_ok is False for a signature that is not 64 bytes long: the
        reference's serial verify rejects those, so they must not be
        padded or cut into the batch where a prefix could verify."""
        idxs: List[int] = []
        for i, cs in enumerate(commit.signatures):
            if cs.absent_():
                continue
            if len(cs.signature) > MAX_SIGNATURE_SIZE:
                raise ErrInvalidCommit(f"signature #{i} too big ({len(cs.signature)})")
            idxs.append(i)
        all_pk, all_powers = self._device_arrays()
        rows = np.asarray(idxs, dtype=np.int64)
        sig_ok = np.asarray([len(commit.signatures[i].signature) == 64 for i in idxs], dtype=bool)
        sigs = np.frombuffer(
            b"".join(commit.signatures[i].signature[:64].ljust(64, b"\x00") for i in idxs),
            dtype=np.uint8,
        ).reshape(len(idxs), 64)
        counted = np.asarray([commit.signatures[i].for_block() for i in idxs], dtype=bool)
        msgs = commit.sign_bytes_matrix(chain_id, idxs)
        return idxs, all_pk[rows], msgs, sigs, all_powers[rows], counted, sig_ok

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

    def verify_commit(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit: Commit,
        provider: Optional[BatchVerifier] = None,
        device=None,
    ) -> None:
        """Verify that +2/3 of this set signed `block_id` at `height`.

        Reference semantics (types/validator_set.go:629-668): signatures in
        order, fail on the first invalid one, succeed as soon as the tallied
        for-block power exceeds 2/3 of the total. `provider` defaults to a
        TorchBatchVerifier on `device` (the card unless "cpu" is asked for).
        """
        if len(self.validators) != len(commit.signatures):
            raise ErrInvalidCommit(
                f"wrong set size: {len(self.validators)} vs {len(commit.signatures)}"
            )
        self._verify_commit_basic(commit, height, block_id)
        idxs, pk, msgs, sigs, powers, counted, sig_ok = self._commit_batch_arrays(chain_id, commit)
        v = provider if provider is not None else TorchBatchVerifier(device)
        ok, talled = v.verify_commit_batch(pk, msgs, sigs, powers, counted & sig_ok)
        ok = np.asarray(ok, dtype=bool) & sig_ok
        self._replay_commit_full(commit, ok, idxs, powers, counted, talled)

    def _replay_commit_full(self, commit: Commit, ok, idxs, powers, counted, talled: int) -> None:
        """The reference's sequential early-return acceptance (loop at
        types/validator_set.go:641-668) over the batched verdicts, in
        closed form. The loop returns as soon as the power tallied before
        a row exceeds 2/3, so it reaches the first bad row only if the
        tally before that row is still <= 2/3. With no bad row it ends
        with every counted row's power tallied: `talled`, the device's sum
        over the rows that are ok and counted."""
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
