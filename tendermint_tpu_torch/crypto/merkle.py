"""RFC-6962-style binary merkle tree and inclusion proofs (the port's copy
of the JAX package's ``crypto/merkle.py``, the simple tree and its
proofs).

Reference: crypto/merkle/simple_tree.go:9 (0x00 leaf / 0x01 inner
prefixes, split at the largest power of two strictly below n),
crypto/merkle/simple_proof.go:52 (SimpleProof and its aunts).

Routing, as in the JAX package: trees below ``DEVICE_THRESHOLD`` leaves
are hashed with ``hashlib``; trees at or above it go to a
``MerkleHasher`` (``models/hasher.py``) on the card unless the caller
passes device="cpu". Unlike the JAX package there is no switch that
keeps every tree on the host, and a device failure raises instead of
being answered from the host. ``configure_device(router=...)`` hands the
engine a ``parallel.topology.MeshRouter``, which splits the leaf stage of
a qualifying tree over its devices (the router part of the JAX
package's ``configure_device``); the engine's switches and counters are
not here yet.

Both routes build the tree level by level (``hasher.host_levels`` on the
host) and read every proof's aunts off the levels. The level-by-level
form computes the reference's recursion exactly: the left subtree of
every node covers a power-of-two-aligned prefix, so pairing adjacent
nodes and carrying an odd last node up never mixes across a split point
(induction on levels).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Sequence

from tendermint_tpu_torch.models.hasher import MerkleHasher, host_levels

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"

# Trees with at least this many leaves are hashed on the device. A
# module attribute, read at each call, so tests can lower it.
DEVICE_THRESHOLD = 1024

# The MeshRouter handed in by configure_device (None: one device).
_DEVICE_ROUTER = None


def configure_device(router=None) -> None:
    """Route the leaf stage of every device tree through `router` (a
    ``parallel.topology.MeshRouter``); None takes it off again."""
    global _DEVICE_ROUTER
    _DEVICE_ROUTER = router


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(_INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (simple_tree.go getSplitPoint)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes], device=None) -> bytes:
    """Merkle root; the empty tree hashes to sha256 of nothing
    (reference emptyHash)."""
    if not items:
        return _sha(b"")
    if len(items) >= DEVICE_THRESHOLD:
        return MerkleHasher(device, router=_DEVICE_ROUTER).root(items)
    return host_levels([leaf_hash(it) for it in items])[-1][0]


@dataclass
class SimpleProof:
    """Inclusion proof for item `index` of `total` (simple_proof.go:20)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def compute_root(self) -> bytes:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> None:
        if self.total < 0 or self.index < 0:
            raise ValueError("proof total/index must be non-negative")
        if leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("leaf hash mismatch")
        if self.compute_root() != root:
            raise ValueError("proof root mismatch")


def _compute_from_aunts(index: int, total: int, lh: bytes, aunts: List[bytes]) -> bytes:
    if index >= total or index < 0 or total <= 0:
        raise ValueError("bad index/total")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts")
        return lh
    if not aunts:
        raise ValueError("missing aunts")
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, lh, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, lh, aunts[:-1])
    return inner_hash(aunts[-1], right)


def _aunts_from_levels(levels: List[List[bytes]]) -> List[List[bytes]]:
    """Each leaf's aunts from the tree's levels (leaves first, root
    last): at level l the node at p = index >> l pairs with p ^ 1 when
    that sibling exists; a carried node has no aunt at that level."""
    aunts: List[List[bytes]] = []
    for i in range(len(levels[0])):
        path, p = [], i
        for lv in levels[:-1]:
            if p ^ 1 < len(lv):
                path.append(lv[p ^ 1])
            p >>= 1
        aunts.append(path)
    return aunts


def proofs_from_byte_slices(items: Sequence[bytes], device=None) -> tuple:
    """(root, [SimpleProof per item]) (simple_proof.go
    SimpleProofsFromByteSlices), routed as hash_from_byte_slices."""
    n = len(items)
    if n == 0:
        return _sha(b""), []
    if n >= DEVICE_THRESHOLD:
        levels = MerkleHasher(device, router=_DEVICE_ROUTER).tree(items)
    else:
        levels = host_levels([leaf_hash(it) for it in items])
    aunts = _aunts_from_levels(levels)
    return levels[-1][0], [SimpleProof(total=n, index=i, leaf_hash=levels[0][i], aunts=aunts[i]) for i in range(n)]
