"""Transactions: the port's copy of the JAX package's ``types/tx.py``
(reference types/tx.go: Tx.Hash :31, Txs.Hash :41, Txs.Proof :61
region).

``Txs.hash`` is the merkle root whose leaves are the raw transactions
(v0.33's ``Txs.Hash`` hashes each tx itself, not its hash), through
``crypto/merkle.py``: ``hashlib`` below the device threshold, the merkle
engine (one ``sha256_leaf_blocks`` and one ``merkle_tree`` launch a
root) at 1,024 transactions or more, on the card unless the caller
passes device="cpu". ``proof`` builds every proof from the same tree.
``keys`` stays ``hashlib``, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.hash import sha256

Tx = bytes


class Txs(list):
    """List of raw txs with merkle hashing.

    The tx set of a proposed block is immutable once built (the
    reference reaps one list per proposal and never mutates it), so the
    raw-bytes leaves, the merkle root, and the per-tx proofs are computed
    once and cached on the instance. Caches invalidate on a length change
    and on every overridden in-place mutator below, so a same-length
    mutation (txs[i] = ..., sort, reverse) can never serve a stale
    root."""

    _leaves_cache: Optional[Tuple[int, List[bytes]]] = None
    _root_cache: Optional[Tuple[int, bytes]] = None
    _proofs_cache: Optional[Tuple[int, bytes, list]] = None
    _keys_cache: Optional[Tuple[int, List[bytes]]] = None

    def _invalidate(self) -> None:
        self._leaves_cache = None
        self._root_cache = None
        self._proofs_cache = None
        self._keys_cache = None

    def __setitem__(self, *a):
        self._invalidate()
        return super().__setitem__(*a)

    def __delitem__(self, *a):
        self._invalidate()
        return super().__delitem__(*a)

    def sort(self, *a, **kw):
        self._invalidate()
        return super().sort(*a, **kw)

    def reverse(self):
        self._invalidate()
        return super().reverse()

    def insert(self, *a):
        self._invalidate()
        return super().insert(*a)

    def pop(self, *a):
        self._invalidate()
        return super().pop(*a)

    def remove(self, *a):
        self._invalidate()
        return super().remove(*a)

    def _leaves(self) -> List[bytes]:
        cached = self._leaves_cache
        if cached is not None and cached[0] == len(self):
            return cached[1]
        leaves = [bytes(tx) for tx in self]
        self._leaves_cache = (len(self), leaves)
        return leaves

    def hash(self, device=None) -> bytes:
        """The merkle root of the raw txs (the block's data hash), on
        `device` at or above the merkle threshold."""
        cached = self._root_cache
        if cached is not None and cached[0] == len(self):
            return cached[1]
        proofs = self._proofs_cache
        if proofs is not None and proofs[0] == len(self):
            root = proofs[1]
        else:
            root = merkle.hash_from_byte_slices(self._leaves(), device=device)
        self._root_cache = (len(self), root)
        return root

    def keys(self) -> List[bytes]:
        """Per-tx sha256 digests (mempool tx_key / tx-index hash),
        computed once per block and cached like the leaves."""
        cached = self._keys_cache
        if cached is not None and cached[0] == len(self):
            return cached[1]
        keys = [sha256(leaf) for leaf in self._leaves()]
        self._keys_cache = (len(self), keys)
        return keys

    def index(self, tx: Tx) -> int:
        target = bytes(tx)
        for i, t in enumerate(self._leaves()):
            if t == target:
                return i
        return -1

    def proof(self, i: int, device=None) -> "TxProof":
        """Tx i's inclusion proof; every proof comes from one tree, built
        on `device` at or above the merkle threshold and cached."""
        cached = self._proofs_cache
        if cached is None or cached[0] != len(self):
            root, proofs = merkle.proofs_from_byte_slices(self._leaves(), device=device)
            cached = self._proofs_cache = (len(self), root, proofs)
            self._root_cache = (len(self), root)
        return TxProof(root_hash=cached[1], data=bytes(self[i]), proof=cached[2][i])


def tx_hash(tx: Tx) -> bytes:
    return sha256(bytes(tx))


class TxProof:
    def __init__(self, root_hash: bytes, data: bytes, proof: merkle.SimpleProof):
        self.root_hash = root_hash
        self.data = data
        self.proof = proof

    def leaf(self) -> bytes:
        return self.data

    def validate(self, data_hash: bytes) -> Optional[str]:
        if data_hash != self.root_hash:
            return "proof matches different data hash"
        try:
            self.proof.verify(self.root_hash, self.data)
        except ValueError as e:
            return str(e)
        return None
