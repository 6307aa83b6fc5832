"""The device-backed commit-verification core of the light client: the
port's copy of the JAX package's ``lightserve/core.py``.

- ``full_spec`` / ``trusting_spec`` build the ``CommitVerifySpec``
  forms (types/validator_set.py);
- ``verify_specs`` checks a list of specs in one device call
  (``verify_commits_batched``);
- ``ensure_basic`` / ``ensure_valset_matches`` are the host checks,
  with typed errors the light client maps onto its own;
- ``verify_header`` / ``verify_header_trusting`` are the two
  whole-header shapes.

Not here yet: the branch that submits specs to a pipelined verifier
(``submit_commit``), which waits for the port's PipelinedVerifier, and
the lightserve aggregator and server.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Sequence

from tendermint_tpu_torch.crypto.batch import BatchVerifier
from tendermint_tpu_torch.types.validator_set import CommitVerifySpec, verify_commits_batched


class CoreVerifyError(Exception):
    """Base for the core's host-side check failures."""


class ErrBadHeader(CoreVerifyError):
    """SignedHeader.validate_basic failed."""


class ErrValsetMismatch(CoreVerifyError):
    """header.validators_hash != the supplied valset's hash."""


def full_spec(valset, chain_id: str, shdr) -> CommitVerifySpec:
    """+2/3 of `valset` signed `shdr`'s commit (verify_commit shape)."""
    return CommitVerifySpec(valset, chain_id, shdr.commit.block_id, shdr.header.height, shdr.commit)


def trusting_spec(valset, chain_id: str, shdr, trust_level: Fraction) -> CommitVerifySpec:
    """trust_level of `valset` signed `shdr`'s commit, signers matched by
    address (verify_commit_trusting shape)."""
    return CommitVerifySpec(valset, chain_id, shdr.commit.block_id, shdr.header.height, shdr.commit,
                            mode="trusting", trust_level=trust_level)


def ensure_basic(chain_id: str, shdr, device=None) -> None:
    err = shdr.validate_basic(chain_id, device)
    if err:
        raise ErrBadHeader(err)


def ensure_valset_matches(shdr, valset, device=None) -> None:
    vhash = valset.hash(device)
    if shdr.header.validators_hash != vhash:
        raise ErrValsetMismatch(
            f"header vhash {shdr.header.validators_hash.hex()} != valset hash {vhash.hex()}"
        )


def verify_specs(specs: Sequence[CommitVerifySpec], provider: Optional[BatchVerifier] = None,
                 device=None) -> List[Optional[Exception]]:
    """One entry per spec: None on acceptance, else the exception the
    direct ``verify_commit[_trusting]`` call would have raised; one
    device call for the whole list."""
    if not specs:
        return []
    return verify_commits_batched(list(specs), provider=provider, device=device)


def verify_one(spec: CommitVerifySpec, provider: Optional[BatchVerifier] = None, device=None) -> None:
    """Verify a single spec, raising what the direct call would raise."""
    err = verify_specs([spec], provider=provider, device=device)[0]
    if err is not None:
        raise err


def verify_header(chain_id: str, shdr, valset, provider: Optional[BatchVerifier] = None, device=None) -> None:
    """Basic validity, the header's validators_hash against `valset`,
    and +2/3 of `valset` signed the commit."""
    ensure_basic(chain_id, shdr, device)
    ensure_valset_matches(shdr, valset, device)
    verify_one(full_spec(valset, chain_id, shdr), provider=provider, device=device)


def verify_header_trusting(chain_id: str, valset, shdr, trust_level: Fraction,
                           provider: Optional[BatchVerifier] = None, device=None) -> None:
    """trust_level of `valset` signed `shdr`'s commit."""
    verify_one(trusting_spec(valset, chain_id, shdr, trust_level), provider=provider, device=device)
