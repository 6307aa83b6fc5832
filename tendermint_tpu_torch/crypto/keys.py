"""Ed25519 keys on the host, in pure Python, and the pubkey registry.

The port's counterpart of the JAX package's ``crypto/keys.py``, which
signs and verifies through the ``cryptography`` package (OpenSSL). The
machine with the card has no such package, so here both go through the
port's copy of the pure-Python oracle (``ops/ref_ed25519.py``, hashlib
only), whose acceptance is Go x/crypto's. Host verification is the slow
path; batches go through ``crypto/batch.py``.

The registry (``register_pubkey_type``, ``encode_pubkey``,
``decode_pubkey`` with its typed errors) is the JAX package's; the port
registers ed25519 here and bls12-381 in ``crypto/bls.py``.
"""

from __future__ import annotations

import hashlib

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.crypto.hash import address_hash
from tendermint_tpu_torch.ops import ref_ed25519 as ref

ED25519_TYPE = "ed25519"
ED25519_PUBKEY_SIZE = 32
ED25519_PRIVKEY_SIZE = 64  # seed || pubkey, Go's layout
ED25519_SIGNATURE_SIZE = 64


class Ed25519PubKey:
    type_name = ED25519_TYPE
    __slots__ = ("_raw",)

    def __init__(self, raw: bytes):
        if len(raw) != ED25519_PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {ED25519_PUBKEY_SIZE} bytes")
        self._raw = bytes(raw)

    def address(self) -> bytes:
        return address_hash(self._raw)

    def bytes(self) -> bytes:
        return self._raw

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return len(sig) == ED25519_SIGNATURE_SIZE and ref.verify(self._raw, msg, sig)

    def __eq__(self, other) -> bool:
        return isinstance(other, Ed25519PubKey) and self._raw == other._raw

    def __hash__(self) -> int:
        return hash(self._raw)

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._raw.hex()[:16]}…}}"


class Ed25519PrivKey:
    type_name = ED25519_TYPE
    __slots__ = ("_seed", "_pub")

    def __init__(self, raw: bytes):
        """A 32-byte seed or Go's 64-byte seed || pubkey."""
        if len(raw) == ED25519_PRIVKEY_SIZE:
            seed = raw[:32]
        elif len(raw) == 32:
            seed = raw
        else:
            raise ValueError("ed25519 privkey must be 32 or 64 bytes")
        self._seed = bytes(seed)
        self._pub = Ed25519PubKey(ref.pubkey_from_seed(self._seed))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Ed25519PrivKey":
        """Deterministic key: the SHA-256 of `secret` as the seed (the
        JAX package's, after the reference's GenPrivKeyFromSecret)."""
        return cls(hashlib.sha256(secret).digest())

    def sign(self, msg: bytes) -> bytes:
        return ref.sign(self._seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return self._pub

    def __repr__(self) -> str:
        return "PrivKeyEd25519{…}"


class ErrUnknownPubKeyType(ValueError):
    """decode_pubkey met a type name no scheme registered."""


class ErrMalformedPubKey(ValueError):
    """decode_pubkey could not frame the payload (truncated or trailing
    bytes, or a payload the scheme's constructor rejects)."""


_PUBKEY_TYPES = {}


def register_pubkey_type(type_name: str, ctor) -> None:
    _PUBKEY_TYPES[type_name] = ctor


def registered_pubkey_types() -> tuple:
    """The registered type names, in registration order."""
    return tuple(_PUBKEY_TYPES)


register_pubkey_type(ED25519_TYPE, Ed25519PubKey)


def encode_pubkey(pk) -> bytes:
    """The registry's wire encoding: the type name, then the key bytes."""
    return Writer().write_str(pk.type_name).write_bytes(pk.bytes()).bytes()


def decode_pubkey(data: bytes):
    """The inverse of encode_pubkey: ErrUnknownPubKeyType for a type name
    nothing registered, ErrMalformedPubKey for truncated or trailing bytes
    or a payload the type rejects (both are ValueErrors)."""
    r = Reader(data)
    try:
        type_name = r.read_str()
        raw = r.read_bytes()
        r.expect_done()
    except Exception as e:
        raise ErrMalformedPubKey(f"malformed pubkey encoding: {e!r}") from e
    ctor = _PUBKEY_TYPES.get(type_name)
    if ctor is None:
        raise ErrUnknownPubKeyType(f"unknown pubkey type {type_name!r}")
    try:
        return ctor(raw)
    except Exception as e:
        raise ErrMalformedPubKey(f"invalid {type_name} pubkey payload: {e!r}") from e


def is_batch_ed25519(pub_key) -> bool:
    """True for a key the ed25519 kernels take."""
    return isinstance(pub_key, Ed25519PubKey)
