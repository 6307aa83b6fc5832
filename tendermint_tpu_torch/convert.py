"""Carry a validator set and a commit across from the JAX package.

The port imports nothing of the JAX package, so state crosses as numpy
arrays: the caller extracts them from its own objects (see the port's
tests) and these functions rebuild the port's ValidatorSet and Commit.

Validator set: pubkeys (V, 32) uint8, powers (V,) int64.
Commit: height, round, the BlockID (hash, parts total, parts hash), and
per row: flags (V,) uint8 (BlockIDFlag), timestamps (V,) int64 ns and
signatures, a list of V bytes objects (any length, b"" when absent).
Validator addresses are recomputed from the pubkeys.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_ABSENT, BlockID, Commit, CommitSig, PartSetHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet


def validator_set(pubkeys: np.ndarray, powers: np.ndarray) -> ValidatorSet:
    pubkeys = np.asarray(pubkeys, dtype=np.uint8)
    powers = np.asarray(powers, dtype=np.int64)
    if pubkeys.ndim != 2 or pubkeys.shape[1] != 32 or powers.shape != (pubkeys.shape[0],):
        raise ValueError("want pubkeys (V, 32) and powers (V,)")
    return ValidatorSet(
        [Validator(Ed25519PubKey(pk.tobytes()), int(p)) for pk, p in zip(pubkeys, powers)]
    )


def commit(
    height: int,
    round_: int,
    block_hash: bytes,
    parts_total: int,
    parts_hash: bytes,
    pubkeys: np.ndarray,
    flags: np.ndarray,
    timestamps: np.ndarray,
    signatures: Sequence[bytes],
) -> Commit:
    """Row i is the slot of the validator with pubkey pubkeys[i], in the
    commit's (address-sorted) order."""
    sigs = []
    for pk, flag, ts, sig in zip(np.asarray(pubkeys, dtype=np.uint8), flags, timestamps, signatures):
        if int(flag) == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
        else:
            addr = Ed25519PubKey(pk.tobytes()).address()
            sigs.append(CommitSig(int(flag), addr, int(ts), bytes(sig)))
    bid = BlockID(bytes(block_hash), PartSetHeader(int(parts_total), bytes(parts_hash)))
    return Commit(int(height), int(round_), bid, sigs)
