"""Validator: address, pubkey, voting power and proposer priority (the
port's copy of the JAX package's ``types/validator.py``, the fields and
the tie-break that building a ValidatorSet reads)."""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto.keys import Ed25519PubKey


@dataclass
class Validator:
    pub_key: Ed25519PubKey
    voting_power: int
    proposer_priority: int = 0
    address: bytes = field(default=b"")

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.proposer_priority, self.address)

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
