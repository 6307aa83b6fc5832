"""Light-client header verification: the port's copy of the JAX package's
``light/verifier.py``.

Reference: lite2/verifier.go: VerifyAdjacent :96 (hash chain and the
untrusted VerifyCommit), VerifyNonAdjacent :32 (VerifyCommitTrusting of
the trusted set at 1/3 :60, and the untrusted VerifyCommit :76), Verify
:140, VerifyBackwards :228, and their shared checks
(verifyNewHeaderAndVals :167): basic validity, height and time order,
clock drift, the trusting period.

Every entry point takes ``provider=None`` (the default provider of
`device`, ``crypto.batch.get_default_provider``) and ``device=None`` (the card; "cpu" for the kernels' plain
versions), which reaches the validator-set hashes and the commit checks.
A link's commit checks, and a whole chain's, go through
``lightserve.core`` in one device call.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import List, Optional, Tuple

from tendermint_tpu_torch.light.types import DEFAULT_TRUST_LEVEL, SignedHeader
from tendermint_tpu_torch.lightserve import core
from tendermint_tpu_torch.types.validator_set import CommitVerifySpec, ValidatorSet

DEFAULT_CLOCK_DRIFT_NS = 10 * 10**9  # 10 s (reference defaultClockDrift)


class VerificationError(Exception):
    pass


class ErrOldHeaderExpired(VerificationError):
    pass


class ErrNewValSetCantBeTrusted(VerificationError):
    """The non-adjacent trust check failed: bisection should pivot."""


class ErrInvalidHeader(VerificationError):
    pass


def _now_ns(now_ns: Optional[int]) -> int:
    return time.time_ns() if now_ns is None else now_ns


def header_expired(h: SignedHeader, trusting_period_ns: int, now_ns: int) -> bool:
    """Reference HeaderExpired lite2/verifier.go:186."""
    return h.time_ns + trusting_period_ns <= now_ns


def _verify_new_header_and_vals(chain_id: str, untrusted: SignedHeader, untrusted_vals: ValidatorSet,
                                trusted: SignedHeader, now_ns: int, clock_drift_ns: int, device=None) -> None:
    """Reference verifyNewHeaderAndVals :167."""
    try:
        core.ensure_basic(chain_id, untrusted, device)
    except core.ErrBadHeader as e:
        raise ErrInvalidHeader(str(e)) from None
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(f"expected new header height {untrusted.height} > trusted {trusted.height}")
    if untrusted.time_ns <= trusted.time_ns:
        raise ErrInvalidHeader("expected new header time after old header time")
    if untrusted.time_ns >= now_ns + clock_drift_ns:
        raise ErrInvalidHeader("new header time is from the future")
    try:
        core.ensure_valset_matches(untrusted, untrusted_vals, device)
    except core.ErrValsetMismatch:
        raise ErrInvalidHeader("expected new header validators to match those supplied") from None


def link_specs(
    chain_id: str,
    trusted: SignedHeader,
    trusted_vals: Optional[ValidatorSet],
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    now_ns: Optional[int] = None,
    clock_drift_ns: int = DEFAULT_CLOCK_DRIFT_NS,
    device=None,
) -> List[Tuple[str, CommitVerifySpec]]:
    """The host checks of one trust link trusted -> untrusted, and the
    commit specs the device must confirm: ``[("full", spec)]`` for an
    adjacent link (after the hash-chain check), ``[("trusting", spec),
    ("full", spec)]`` for a skip link. Host failures raise here."""
    now = _now_ns(now_ns)
    if header_expired(trusted, trusting_period_ns, now):
        raise ErrOldHeaderExpired(f"old header expired at {trusted.time_ns + trusting_period_ns}")
    _verify_new_header_and_vals(chain_id, untrusted, untrusted_vals, trusted, now, clock_drift_ns, device)
    if untrusted.height == trusted.height + 1:
        # the hash-chain link: H+1's validators were committed to by H
        if untrusted.header.validators_hash != trusted.header.next_validators_hash:
            raise ErrInvalidHeader(
                f"expected old header next validators "
                f"({trusted.header.next_validators_hash.hex()[:12]}) to match "
                f"those from new header "
                f"({untrusted.header.validators_hash.hex()[:12]})"
            )
        return [("full", core.full_spec(untrusted_vals, chain_id, untrusted))]
    # Both checks share one device call; the reference runs them in
    # turn, and the trusting error still surfaces first.
    if trusted_vals is None:
        raise ValueError("non-adjacent link requires the trusted valset")
    return [
        ("trusting", core.trusting_spec(trusted_vals, chain_id, untrusted, trust_level)),
        ("full", core.full_spec(untrusted_vals, chain_id, untrusted)),
    ]


def _raise_link(kind: str, err: Exception, prefix: str = "") -> None:
    if kind == "trusting":
        raise ErrNewValSetCantBeTrusted(f"{prefix}{err}")
    raise err


def verify_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: Optional[int] = None,
    clock_drift_ns: int = DEFAULT_CLOCK_DRIFT_NS,
    provider=None,
    device=None,
) -> None:
    """Reference VerifyAdjacent :96: untrusted.height == trusted.height + 1."""
    if untrusted.height != trusted.height + 1:
        raise ValueError("headers must be adjacent in height")
    specs = link_specs(chain_id, trusted, None, untrusted, untrusted_vals, trusting_period_ns,
                       now_ns=now_ns, clock_drift_ns=clock_drift_ns, device=device)
    core.verify_one(specs[0][1], provider=provider, device=device)


def verify_non_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    now_ns: Optional[int] = None,
    clock_drift_ns: int = DEFAULT_CLOCK_DRIFT_NS,
    provider=None,
    device=None,
) -> None:
    """Reference VerifyNonAdjacent :32."""
    if untrusted.height == trusted.height + 1:
        raise ValueError("headers must be non-adjacent in height")
    specs = link_specs(chain_id, trusted, trusted_vals, untrusted, untrusted_vals, trusting_period_ns,
                       trust_level, now_ns, clock_drift_ns, device)
    res = core.verify_specs([s for _, s in specs], provider=provider, device=device)
    for (kind, _), err in zip(specs, res):
        if err is not None:
            _raise_link(kind, err)


def verify(
    chain_id: str,
    trusted: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    now_ns: Optional[int] = None,
    clock_drift_ns: int = DEFAULT_CLOCK_DRIFT_NS,
    provider=None,
    device=None,
) -> None:
    """Reference Verify :140: dispatch on adjacency."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(chain_id, trusted, trusted_vals, untrusted, untrusted_vals, trusting_period_ns,
                            trust_level, now_ns, clock_drift_ns, provider, device)
    else:
        verify_adjacent(chain_id, trusted, untrusted, untrusted_vals, trusting_period_ns, now_ns,
                        clock_drift_ns, provider, device)


def verify_chain(
    chain_id: str,
    trusted: SignedHeader,
    trusted_vals: ValidatorSet,
    chain,  # [(SignedHeader, ValidatorSet)], ascending heights
    trusting_period_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    now_ns: Optional[int] = None,
    clock_drift_ns: int = DEFAULT_CLOCK_DRIFT_NS,
    provider=None,
    device=None,
) -> None:
    """Verify a chain of headers with one device call for every link's
    commits (adjacent: one commit; non-adjacent: trusting and full). The
    host checks run link by link first; the per-link replay keeps the
    step-by-step semantics, so the first failing link raises what the
    step-by-step path would have raised."""
    now = _now_ns(now_ns)
    specs: List[CommitVerifySpec] = []
    spec_links: List[Tuple[int, str]] = []
    cur_sh, cur_vals = trusted, trusted_vals
    for li, (sh, vals) in enumerate(chain):
        try:
            link = link_specs(chain_id, cur_sh, cur_vals, sh, vals, trusting_period_ns, trust_level, now,
                              clock_drift_ns, device)
        except ErrInvalidHeader as e:
            raise ErrInvalidHeader(f"link {li}: {e}") from None
        for kind, s in link:
            specs.append(s)
            spec_links.append((li, kind))
        cur_sh, cur_vals = sh, vals
    results = core.verify_specs(specs, provider=provider, device=device)
    for (li, kind), err in zip(spec_links, results):
        if err is not None:
            _raise_link(kind, err, prefix=f"link {li}: " if kind == "trusting" else "")


def verify_backwards(chain_id: str, untrusted: SignedHeader, trusted: SignedHeader, device=None) -> None:
    """Reference VerifyBackwards :228: the hash chain only, no
    signatures; untrusted is the header just before trusted. `device`
    reaches the header hashes (14 leaves, below the merkle threshold)."""
    try:
        core.ensure_basic(chain_id, untrusted, device)
    except core.ErrBadHeader as e:
        raise ErrInvalidHeader(str(e)) from None
    if untrusted.height != trusted.height - 1:
        raise ValueError("headers must be adjacent (backwards)")
    if untrusted.time_ns >= trusted.time_ns:
        raise ErrInvalidHeader("expected older header time to be before newer")
    if trusted.header.last_block_id.hash != untrusted.hash(device):
        raise ErrInvalidHeader(
            f"trusted header's LastBlockID {trusted.header.last_block_id.hash.hex()[:12]} "
            f"does not match older header's hash {untrusted.hash(device).hex()[:12]}"
        )
