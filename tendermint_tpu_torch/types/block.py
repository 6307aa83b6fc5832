"""PartSetHeader, BlockID, CommitSig, Commit, Header and Data: the port's
copy of the parts of the JAX package's ``types/block.py`` that commit
verification and the light client read (reference types/block.go:
Header :282, Header.Hash :393, Commit :572, CommitSig :468,
Commit.VoteSignBytes :637, BlockID :957 region), with the templated
sign-bytes (``Commit.sign_bytes_parts``) that the tabled path reads, the
merkle roots ``Commit.hash`` and ``Header.hash``, and the block body
``Data`` (types/block.go Data) whose hash is its ``Txs``'s root."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from tendermint_tpu_torch.codec import signbytes
from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.codec.signbytes import PRECOMMIT_TYPE, splice_timestamps
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.types.tx import Txs

# Block protocol version (reference version/version.go BlockProtocol).
BLOCK_PROTOCOL = 10

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

    def validate_basic(self) -> Optional[str]:
        if self.total < 0:
            return "negative Total"
        if len(self.hash) not in (0, 32):
            return "wrong Hash size"
        return None

    def encode(self) -> bytes:
        return Writer().write_u32(self.total).write_bytes(self.hash).bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        r = Reader(data)
        return cls(total=r.read_u32(), hash=r.read_bytes())

    def __repr__(self) -> str:
        return f"{self.total}:{self.hash.hex()[:12]}"


@dataclass
class BlockID:
    hash: bytes = b""
    parts: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts.is_zero()

    def validate_basic(self) -> Optional[str]:
        if len(self.hash) not in (0, 32):
            return "wrong Hash"
        err = self.parts.validate_basic()
        if err:
            return f"wrong PartsHeader: {err}"
        return None

    def encode(self) -> bytes:
        return Writer().write_bytes(self.hash).write_bytes(self.parts.encode()).bytes()

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        r = Reader(data)
        h = r.read_bytes()
        return cls(hash=h, parts=PartSetHeader.decode(r.read_bytes()))

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

    def encode(self) -> bytes:
        """The commit-hash leaf: flag, address, timestamp, signature (95
        bytes for a signed ed25519 row, 11 for an absent one)."""
        return (
            Writer()
            .write_u8(self.block_id_flag)
            .write_bytes(self.validator_address)
            .write_i64(self.timestamp_ns)
            .write_bytes(self.signature)
            .bytes()
        )


@dataclass
class Commit:
    """+2/3 precommits for a block."""

    height: int
    round: int
    block_id: BlockID
    signatures: List[CommitSig]

    _parts_cache: Optional[tuple] = field(default=None, init=False, repr=False, compare=False)
    _hash: Optional[bytes] = field(default=None, init=False, repr=False, compare=False)

    def __deepcopy__(self, memo):
        """A deep copy carries no memo (sign-bytes parts, hash): the one
        reason to deep-copy a commit is to change it."""
        import copy

        return Commit(self.height, self.round, copy.deepcopy(self.block_id, memo),
                      copy.deepcopy(self.signatures, memo))

    def hash(self, device=None) -> bytes:
        """The merkle root of the CommitSig encodings (the next header's
        LastCommitHash), on `device` above the merkle threshold.
        Memoised: a commit is not changed after it is assembled."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([cs.encode() for cs in self.signatures], device=device)
        return self._hash

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


@dataclass
class Header:
    """Block header; its hash is the merkle root of the 14 field
    encodings (reference Header.Hash types/block.go:393)."""

    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    version_block: int = BLOCK_PROTOCOL
    version_app: int = 0

    def hash(self, device=None) -> Optional[bytes]:
        """None while ValidatorsHash is unset (the header is not
        complete), as in the reference. 14 leaves are below the merkle
        threshold, so `device` is read only where a caller lowered it."""
        if not self.validators_hash:
            return None
        fields = [
            Writer().write_u64(self.version_block).write_u64(self.version_app).bytes(),
            self.chain_id.encode("utf-8"),
            Writer().write_u64(self.height).bytes(),
            Writer().write_i64(self.time_ns).bytes(),
            self.last_block_id.encode(),
            self.last_commit_hash,
            self.data_hash,
            self.validators_hash,
            self.next_validators_hash,
            self.consensus_hash,
            self.app_hash,
            self.last_results_hash,
            self.evidence_hash,
            self.proposer_address,
        ]
        return merkle.hash_from_byte_slices(fields, device=device)

    def validate_basic(self) -> Optional[str]:
        if len(self.chain_id) > 50:
            return "chainID is too long"
        if self.height < 0:
            return "negative Height"
        if self.height == 0:
            return "zero Height"
        err = self.last_block_id.validate_basic()
        if err:
            return f"wrong LastBlockID: {err}"
        for name, h in (
            ("LastCommitHash", self.last_commit_hash),
            ("DataHash", self.data_hash),
            ("EvidenceHash", self.evidence_hash),
            ("ValidatorsHash", self.validators_hash),
            ("NextValidatorsHash", self.next_validators_hash),
            ("ConsensusHash", self.consensus_hash),
            ("LastResultsHash", self.last_results_hash),
        ):
            if len(h) not in (0, 32):
                return f"wrong {name}"
        if len(self.proposer_address) not in (0, 20):
            return "invalid ProposerAddress length"
        return None


@dataclass
class Data:
    """Block body: transactions (types/block.go Data)."""

    txs: Txs = field(default_factory=Txs)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def hash(self, device=None) -> bytes:
        """The block's data hash: the merkle root of its raw txs, on
        `device` at or above the merkle threshold. Memoised."""
        if self._hash is None:
            self._hash = self.txs.hash(device=device)
        return self._hash

    def encode(self) -> bytes:
        w = Writer()
        w.write_uvarint(len(self.txs))
        for tx in self.txs:
            w.write_bytes(bytes(tx))
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Data":
        r = Reader(data)
        n = r.read_uvarint()
        return cls(txs=Txs([r.read_bytes() for _ in range(n)]))
