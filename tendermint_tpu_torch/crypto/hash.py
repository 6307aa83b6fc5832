"""SHA-256 and truncated addresses (the port's copy of the JAX package's
``crypto/hash.py``; reference crypto/tmhash: addresses are the first 20
bytes of sha256 of the pubkey bytes)."""

from __future__ import annotations

import hashlib

HASH_SIZE = 32
ADDRESS_SIZE = 20


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def address_hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:ADDRESS_SIZE]
