"""Validator: address, pubkey, voting power and proposer priority (the
port's copy of the JAX package's ``types/validator.py``: the fields, the
tie-break that building a ValidatorSet reads, and the leaf encoding of
the validator-set hash). The pubkey is any registered type (ed25519 or
bls12-381)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from tendermint_tpu_torch.codec.binary import Writer
from tendermint_tpu_torch.crypto.keys import encode_pubkey


@dataclass
class Validator:
    pub_key: object
    voting_power: int
    proposer_priority: int = 0
    address: bytes = field(default=b"")
    _pk_enc: Optional[bytes] = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        v = Validator(self.pub_key, self.voting_power, self.proposer_priority, self.address)
        v._pk_enc = self._pk_enc
        return v

    def _pk_encoded(self) -> bytes:
        """The pubkey's registry encoding, memoised (the key is immutable)."""
        if self._pk_enc is None:
            self._pk_enc = encode_pubkey(self.pub_key)
        return self._pk_enc

    def hash_bytes(self) -> bytes:
        """The validator's leaf in the validator-set merkle root: the
        encoded pubkey and the voting power, not the priority (reference
        Validator.Bytes, types/validator.go:102). 50 bytes for ed25519, 68
        for bls12-381."""
        return Writer().write_bytes(self._pk_encoded()).write_i64(self.voting_power).bytes()

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """The validator with the higher priority; ties go to the lower
        address (reference types/validator.go:47-70)."""
        if self.proposer_priority != other.proposer_priority:
            return self if self.proposer_priority > other.proposer_priority else other
        if self.address != other.address:
            return self if self.address < other.address else other
        raise ValueError("same address in priority comparison")

    def __repr__(self) -> str:
        return f"Validator{{{self.address.hex()[:12]} VP:{self.voting_power} A:{self.proposer_priority}}}"
