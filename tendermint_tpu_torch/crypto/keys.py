"""Ed25519 keys on the host, in pure Python.

The port's counterpart of the JAX package's ``crypto/keys.py``, which
signs and verifies through the ``cryptography`` package (OpenSSL). The
machine with the card has no such package, so here both go through the
port's copy of the pure-Python oracle (``ops/ref_ed25519.py``, hashlib
only), whose acceptance is Go x/crypto's. Host verification is the slow
path; batches go through ``crypto/batch.py``.
"""

from __future__ import annotations

from tendermint_tpu_torch.codec.binary import Writer
from tendermint_tpu_torch.crypto.hash import address_hash
from tendermint_tpu_torch.ops import ref_ed25519 as ref

ED25519_TYPE = "ed25519"
ED25519_PUBKEY_SIZE = 32
ED25519_PRIVKEY_SIZE = 64  # seed || pubkey, Go's layout
ED25519_SIGNATURE_SIZE = 64


class Ed25519PubKey:
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

    def sign(self, msg: bytes) -> bytes:
        return ref.sign(self._seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return self._pub

    def __repr__(self) -> str:
        return "PrivKeyEd25519{…}"


def encode_pubkey(pk: Ed25519PubKey) -> bytes:
    """The key registry's wire encoding: the type name, then the key
    bytes (the JAX package's ``crypto/keys.py`` encode_pubkey). The port
    has one key type."""
    return Writer().write_str(ED25519_TYPE).write_bytes(pk.bytes()).bytes()
