"""Carry a validator set and a commit across from the JAX package.

The port imports nothing of the JAX package, so state crosses as numpy
arrays: the caller extracts them from its own objects (see the port's
tests) and these functions rebuild the port's ValidatorSet and Commit.

Validator set: pubkeys (V, 32) uint8, powers (V,) int64.
Valset tables: the JAX package's build_valset_tables output, tables
(V, 16, 8, 60) int32 in 20 13-bit limbs a coordinate and a_ok (V,).
Commit: height, round, the BlockID (hash, parts total, parts hash), and
per row: flags (V,) uint8 (BlockIDFlag), timestamps (V,) int64 ns and
signatures, a list of V bytes objects (any length, b"" when absent).
Validator addresses are recomputed from the pubkeys.
Header: its field values (str, ints and bytes), the last BlockID as
(hash, parts total, parts hash).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_PROTOCOL,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
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


def valset_tables(tables: np.ndarray, a_ok: np.ndarray):
    """The JAX package's per-valset tables -> the port's: (tables
    (V, 16, 8, 3, 10) int32 in the port's limbs, a_ok (V,) bool), the
    same field values. A JAX coordinate is sum(l_i 2^(13 i)) with limbs
    in [0, 8800]; it is rebuilt as sum(l_i c_i) with c_i = 2^(13 i) mod p
    in the port's limbs (each product below 2^40, a sum below 2^45), then
    carried into the port's bounds."""
    from tendermint_tpu_torch.ops import field

    t = torch.from_numpy(np.asarray(tables, dtype=np.int64))
    if t.dim() != 4 or t.shape[3] != 60:
        raise ValueError(f"want JAX tables (V, SPLITS, 8, 60), got {tuple(t.shape)}")
    v, splits, entries, _ = t.shape
    limbs = t.reshape(v, splits, entries, 3, 20)
    if limbs.min() < 0 or limbs.max() >= 1 << 14:
        raise ValueError("JAX limbs outside [0, 2^14)")
    powers = torch.tensor([field.to_limbs(1 << (13 * i)) for i in range(20)], dtype=torch.int64)  # (20, 10)
    out = (limbs.unsqueeze(-1) * powers).sum(dim=-2)
    out = field.carry(field.carry(field.carry(out)))
    return out.to(torch.int32), torch.from_numpy(np.asarray(a_ok, dtype=bool).copy())


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


def header(
    chain_id: str,
    height: int,
    time_ns: int,
    last_block_id=(b"", 0, b""),
    last_commit_hash: bytes = b"",
    data_hash: bytes = b"",
    validators_hash: bytes = b"",
    next_validators_hash: bytes = b"",
    consensus_hash: bytes = b"",
    app_hash: bytes = b"",
    last_results_hash: bytes = b"",
    evidence_hash: bytes = b"",
    proposer_address: bytes = b"",
    version_block: int = BLOCK_PROTOCOL,
    version_app: int = 0,
) -> Header:
    """The port's Header from a header's field values; `last_block_id`
    is (hash, parts total, parts hash)."""
    lb_hash, lb_total, lb_parts = last_block_id
    return Header(
        chain_id=str(chain_id), height=int(height), time_ns=int(time_ns),
        last_block_id=BlockID(bytes(lb_hash), PartSetHeader(int(lb_total), bytes(lb_parts))),
        last_commit_hash=bytes(last_commit_hash), data_hash=bytes(data_hash),
        validators_hash=bytes(validators_hash), next_validators_hash=bytes(next_validators_hash),
        consensus_hash=bytes(consensus_hash), app_hash=bytes(app_hash),
        last_results_hash=bytes(last_results_hash), evidence_hash=bytes(evidence_hash),
        proposer_address=bytes(proposer_address), version_block=int(version_block),
        version_app=int(version_app),
    )
