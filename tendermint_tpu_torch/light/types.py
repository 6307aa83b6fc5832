"""Light-client data types: the port's copy of the JAX package's
``light/types.py`` (SignedHeader, reference types/block.go :569 region,
and the default trust level)."""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

from tendermint_tpu_torch.types.block import Commit, Header


@dataclass
class SignedHeader:
    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str, device=None) -> Optional[str]:
        """Reference SignedHeader.ValidateBasic types/block.go."""
        if self.header is None:
            return "missing header"
        if self.commit is None:
            return "missing commit"
        if self.header.chain_id != chain_id:
            return f"header belongs to another chain {self.header.chain_id!r}"
        if self.commit.height != self.header.height:
            return f"header and commit height mismatch: {self.header.height} vs {self.commit.height}"
        hhash = self.header.hash(device)
        if self.commit.block_id.hash != hhash:
            return (
                f"commit signs block {self.commit.block_id.hash.hex()[:12]}, "
                f"header is block {hhash.hex()[:12]}"
            )
        return None

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def time_ns(self) -> int:
        return self.header.time_ns

    def hash(self, device=None) -> bytes:
        return self.header.hash(device)


DEFAULT_TRUST_LEVEL = Fraction(1, 3)
