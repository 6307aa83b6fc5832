"""AggregatedCommit: one BLS signature and a signer bitmap per commit.

The port's copy of the JAX package's ``types/aggregate.py``. Where a
Commit carries one CommitSig per validator, an AggregatedCommit carries
the commit's metadata, ONE canonical timestamp, a V-bit signer bitmap
and a single 96-byte aggregate G2 signature, whatever the validator
count. Every aggregated signer signs the SAME canonical precommit
message (the commit's timestamp replaces the per-validator ones in the
sign bytes), which makes its verification one pairing check against
the aggregated pubkey (``ValidatorSet.verify_aggregated_commit``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.codec import signbytes
from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.codec.signbytes import PRECOMMIT_TYPE
from tendermint_tpu_torch.types.block import BlockID
from tendermint_tpu_torch.utils.bits import BitArray

BLS_AGG_SIG_SIZE = 96


@dataclass
class AggregatedCommit:
    """+2/3 precommit power as one aggregate signature (the Commit
    analogue; reference Commit is types/block.go:572)."""

    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    signers: BitArray
    agg_sig: bytes

    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def sign_bytes(self, chain_id: str) -> bytes:
        """THE canonical message every aggregated signer signed: the
        fixed-width precommit sign bytes with the commit's canonical
        timestamp (codec/signbytes.py layout, same as
        Commit.vote_sign_bytes except the shared timestamp)."""
        return signbytes.canonical_sign_bytes(
            msg_type=PRECOMMIT_TYPE,
            height=self.height,
            round_=self.round,
            block_hash=self.block_id.hash,
            parts_total=self.block_id.parts.total,
            parts_hash=self.block_id.parts.hash,
            timestamp_ns=self.timestamp_ns,
            chain_id=chain_id,
        )

    def validate_basic(self) -> Optional[str]:
        if self.height < 0:
            return "negative Height"
        if self.round < 0:
            return "negative Round"
        if self.height >= 1:
            if self.block_id.is_zero():
                return "commit cannot be for nil block"
            if len(self.signers) == 0:
                return "no signers in aggregated commit"
            if self.signers.num_true_bits() == 0:
                return "empty signer bitmap"
            if len(self.agg_sig) != BLS_AGG_SIG_SIZE:
                return "wrong aggregate signature size"
        return None

    def size(self) -> int:
        return len(self.signers)

    def is_commit(self) -> bool:
        return len(self.signers) > 0

    def wire_bytes(self) -> int:
        """Encoded size in bytes."""
        return len(self.encode())

    def encode(self) -> bytes:
        w = Writer()
        w.write_i64(self.height)
        w.write_u32(self.round)
        w.write_bytes(self.block_id.encode())
        w.write_i64(self.timestamp_ns)
        w.write_uvarint(len(self.signers))
        w.write_bytes(self.signers.to_bytes())
        w.write_bytes(self.agg_sig)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "AggregatedCommit":
        r = Reader(data)
        height = r.read_i64()
        round_ = r.read_u32()
        block_id = BlockID.decode(r.read_bytes())
        ts = r.read_i64()
        nbits = r.read_uvarint()
        signers = BitArray.from_bytes(r.read_bytes(), nbits)
        agg_sig = r.read_bytes()
        return cls(
            height=height, round=round_, block_id=block_id,
            timestamp_ns=ts, signers=signers, agg_sig=agg_sig,
        )

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = hashlib.sha256(self.encode()).digest()
        return self._hash

    def __repr__(self) -> str:
        return (
            f"AggregatedCommit{{H:{self.height} R:{self.round} "
            f"signers:{self.signers.num_true_bits()}/{len(self.signers)}}}"
        )


def aggregate_commit_votes(
    chain_id: str,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp_ns: int,
    valset_size: int,
    signatures: List[Optional[bytes]],
) -> AggregatedCommit:
    """Build an AggregatedCommit from per-validator BLS signatures over
    the canonical message (index i = validator i; None = absent).
    Raises ValueError when any present signature is malformed — an
    aggregator must not emit a commit it cannot itself verify."""
    from tendermint_tpu_torch.crypto.bls import aggregate_signatures

    if len(signatures) != valset_size:
        raise ValueError("one signature slot per validator required")
    signers = BitArray(valset_size)
    present = []
    for i, sig in enumerate(signatures):
        if sig is not None:
            signers.set_index(i, True)
            present.append(sig)
    agg = aggregate_signatures(present)
    if agg is None:
        raise ValueError("no valid signatures to aggregate")
    return AggregatedCommit(
        height=height, round=round_, block_id=block_id,
        timestamp_ns=timestamp_ns, signers=signers, agg_sig=agg,
    )
