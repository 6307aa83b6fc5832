"""Carry a validator set and a commit across from the JAX package.

The port imports nothing of the JAX package, so state crosses as numpy
arrays: the caller extracts them from its own objects (see the port's
tests) and these functions rebuild the port's ValidatorSet and Commit.

Validator set: pubkeys (V, 32) uint8, powers (V,) int64; or, for a set
of any registered key types (ed25519, bls12-381), the keys' registry
encodings (``encode_pubkey``), a list of V bytes objects.
Valset tables: the JAX package's build_valset_tables output, tables
(V, 16, 8, 60) int32 in 20 13-bit limbs a coordinate and a_ok (V,).
Commit: height, round, the BlockID (hash, parts total, parts hash), and
per row: flags (V,) uint8 (BlockIDFlag), timestamps (V,) int64 ns and
signatures, a list of V bytes objects (any length, b"" when absent).
Validator addresses are recomputed from the pubkeys.
Header: its field values (str, ints and bytes), the last BlockID as
(hash, parts total, parts hash).
Aggregated commit: its field values, the signer bitmap (V,) bool.
BLS12-381 field elements: the JAX package's (..., 33) int32 limbs of 12
bits in Montgomery form with R = 2^396, and the port's (..., 48) uint8
canonical big-endian bytes (``ops/bls12.py``'s seams).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tendermint_tpu_torch.crypto.keys import Ed25519PubKey, decode_pubkey
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


def _pub_key(pk):
    """A (32,) uint8 row (ed25519) or a registry encoding (bytes)."""
    if isinstance(pk, (bytes, bytearray)):
        import tendermint_tpu_torch.crypto.bls  # noqa: F401  (registers bls12-381)

        return decode_pubkey(bytes(pk))
    return Ed25519PubKey(np.asarray(pk, dtype=np.uint8).tobytes())


def validator_set(pubkeys, powers: np.ndarray) -> ValidatorSet:
    powers = np.asarray(powers, dtype=np.int64)
    if not isinstance(pubkeys, (list, tuple)):
        pubkeys = np.asarray(pubkeys, dtype=np.uint8)
        if pubkeys.ndim != 2 or pubkeys.shape[1] != 32:
            raise ValueError("want pubkeys (V, 32) or V registry encodings")
    if powers.shape != (len(pubkeys),):
        raise ValueError("want one power a pubkey")
    return ValidatorSet([Validator(_pub_key(pk), int(p)) for pk, p in zip(pubkeys, powers)])


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
    if not isinstance(pubkeys, (list, tuple)):
        pubkeys = np.asarray(pubkeys, dtype=np.uint8)
    for pk, flag, ts, sig in zip(pubkeys, flags, timestamps, signatures):
        if int(flag) == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
        else:
            addr = _pub_key(pk).address()
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


def aggregated_commit(height: int, round_: int, block_hash: bytes, parts_total: int, parts_hash: bytes,
                      timestamp_ns: int, signers: np.ndarray, agg_sig: bytes):
    from tendermint_tpu_torch.types.aggregate import AggregatedCommit
    from tendermint_tpu_torch.utils.bits import BitArray

    return AggregatedCommit(
        height=int(height), round=int(round_),
        block_id=BlockID(bytes(block_hash), PartSetHeader(int(parts_total), bytes(parts_hash))),
        timestamp_ns=int(timestamp_ns), signers=BitArray.from_numpy(np.asarray(signers, dtype=bool)),
        agg_sig=bytes(agg_sig),
    )


_BLS_P = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
             "1eabfffeb153ffffb9feffffffffaaab", 16)
_JAX_R = 1 << 396


def bls_from_jax(limbs: np.ndarray) -> np.ndarray:
    """JAX (..., 33) Montgomery limbs (any carry state) -> (..., 48) uint8."""
    arr = np.asarray(limbs, dtype=np.int64)
    flat = arr.reshape(-1, 33)
    r_inv = pow(_JAX_R, -1, _BLS_P)
    out = np.zeros((flat.shape[0], 48), dtype=np.uint8)
    for i, row in enumerate(flat):
        v = sum(int(x) << (12 * k) for k, x in enumerate(row)) * r_inv % _BLS_P
        out[i] = np.frombuffer(v.to_bytes(48, "big"), dtype=np.uint8)
    return out.reshape(arr.shape[:-1] + (48,))


def bls_to_jax(data: np.ndarray) -> np.ndarray:
    """(..., 48) uint8 canonical bytes -> JAX (..., 33) int32 Montgomery limbs."""
    arr = np.asarray(data, dtype=np.uint8)
    flat = arr.reshape(-1, 48)
    out = np.zeros((flat.shape[0], 33), dtype=np.int32)
    for i, row in enumerate(flat):
        v = int.from_bytes(row.tobytes(), "big") * _JAX_R % _BLS_P
        out[i] = [(v >> (12 * k)) & 0xFFF for k in range(33)]
    return out.reshape(arr.shape[:-1] + (33,))
