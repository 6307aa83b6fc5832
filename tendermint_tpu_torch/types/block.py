"""PartSetHeader, BlockID, CommitSig and Commit: the port's copy of the
parts of the JAX package's ``types/block.py`` that commit verification
reads (reference types/block.go: Commit :572, CommitSig :468,
Commit.VoteSignBytes :637, BlockID :957 region), with the templated
sign-bytes (``Commit.sign_bytes_parts``) that the tabled path reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from tendermint_tpu_torch.codec import signbytes
from tendermint_tpu_torch.codec.binary import Writer
from tendermint_tpu_torch.codec.signbytes import PRECOMMIT_TYPE, splice_timestamps

# Widest signature of any registered key scheme in the JAX package (BLS
# G2 = 96 bytes); bounds CommitSig.validate_basic exactly as there.
MAX_SIGNATURE_SIZE = 96

# CommitSig BlockIDFlag (reference types/block.go:437-447)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self) -> bytes:
        return Writer().write_u32(self.total).write_bytes(self.hash).bytes()

    def __repr__(self) -> str:
        return f"{self.total}:{self.hash.hex()[:12]}"


@dataclass
class BlockID:
    hash: bytes = b""
    parts: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts.is_zero()

    def key(self) -> bytes:
        """Map key for vote tallies (reference BlockID.Key)."""
        return self.hash + self.parts.encode()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"{self.hash.hex()[:12]}:{self.parts}"


@dataclass
class CommitSig:
    """One validator's signature slot in a commit."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BLOCK_ID_FLAG_ABSENT)

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def absent_(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The vote's BlockID from the flag (reference CommitSig.BlockID)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> Optional[str]:
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
            return f"unknown BlockIDFlag: {self.block_id_flag}"
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                return "validator address is present for absent CommitSig"
            if self.signature:
                return "signature is present for absent CommitSig"
        else:
            if len(self.validator_address) != 20:
                return "expected ValidatorAddress size 20"
            if not self.signature:
                return "signature is missing"
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                return "signature too big"
        return None


@dataclass
class Commit:
    """+2/3 precommits for a block."""

    height: int
    round: int
    block_id: BlockID
    signatures: List[CommitSig]

    _parts_cache: Optional[tuple] = field(default=None, init=False, repr=False, compare=False)

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Canonical sign-bytes of signature `idx` (160 bytes)."""
        cs = self.signatures[idx]
        bid = cs.block_id(self.block_id)
        return signbytes.canonical_sign_bytes(
            msg_type=PRECOMMIT_TYPE,
            height=self.height,
            round_=self.round,
            block_hash=bid.hash,
            parts_total=bid.parts.total,
            parts_hash=bid.parts.hash,
            timestamp_ns=cs.timestamp_ns,
            chain_id=chain_id,
        )

    def sign_bytes_parts(self, chain_id: str):
        """The canonical sign-bytes of every signature as templates:
        (templates (2, 160) u8, row 0 for the block and row 1 nil;
        tmpl_idx (N,) int32; ts8 (N, 8) u8 big-endian timestamps). Row r
        is templates[tmpl_idx[r]] with ts8[r] at the timestamp offset:
        within one commit the sign-bytes differ only there. Absent rows
        get template 1; callers drop them.

        Memoised per chain id: a commit is verified several times (each
        validation pass of a height), and its signatures are not changed
        after it is assembled."""
        cached = self._parts_cache
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        template = np.frombuffer(
            signbytes.canonical_sign_bytes(
                msg_type=PRECOMMIT_TYPE,
                height=self.height,
                round_=self.round,
                block_hash=self.block_id.hash,
                parts_total=self.block_id.parts.total,
                parts_hash=self.block_id.parts.hash,
                timestamp_ns=0,
                chain_id=chain_id,
            ),
            dtype=np.uint8,
        )
        templates = np.stack([template, template])
        templates[1, signbytes.BLOCK_ID_OFFSET : signbytes.BLOCK_ID_END] = 0
        n = len(self.signatures)
        ts8 = np.asarray([cs.timestamp_ns for cs in self.signatures], dtype=">i8").view(np.uint8).reshape(n, 8)
        tmpl_idx = np.asarray([cs.block_id_flag != BLOCK_ID_FLAG_COMMIT for cs in self.signatures], dtype=np.int32)
        out = (templates, tmpl_idx, ts8)
        self._parts_cache = (chain_id, out)
        return out

    def sign_bytes_matrix(self, chain_id: str, rows) -> np.ndarray:
        """(len(rows), 160) uint8 sign-bytes of the signatures `rows`,
        materialised from sign_bytes_parts."""
        templates, tmpl_idx, ts8 = self.sign_bytes_parts(chain_id)
        rows = np.asarray(rows, dtype=np.int64)
        return splice_timestamps(templates[tmpl_idx[rows]], ts8[rows])

    def validate_basic(self) -> Optional[str]:
        if self.height < 0:
            return "negative Height"
        if self.round < 0:
            return "negative Round"
        if self.height >= 1:
            if self.block_id.is_zero():
                return "commit cannot be for nil block"
            if not self.signatures:
                return "no signatures in commit"
            for i, cs in enumerate(self.signatures):
                err = cs.validate_basic()
                if err:
                    return f"wrong CommitSig #{i}: {err}"
        return None

    def __repr__(self) -> str:
        return f"Commit{{h={self.height} r={self.round} bid={self.block_id} n={len(self.signatures)}}}"
