"""MerkleHasher: an RFC-6962-style merkle tree's leaves and inner levels
through the SHA-256 kernels on one device.

Counterpart of the JAX package's ``models/hasher.py``. Every leaf is
hashed in one launch of ``sha256_leaf_blocks`` (leaves of different
block counts together, packed one after another into a flat buffer of
their own blocks, so one long leaf does not pad the others to its
length), then each inner level in one launch of
``merkle_inner_level``, while the level is wider than
``HOST_TAIL_WIDTH``; ``hashlib`` finishes the narrow top, where a
launch costs more than the few hashes it would do. Pairing adjacent
nodes and carrying an odd last one up is exactly the reference's
split-point recursion (crypto/merkle.py).

Not copied from the JAX module, which needs them for XLA's compiles:
the leaf-count buckets and their padding rows, the blocking and
background compiles, the cold-bucket and shape declines (the kernels
take any leaf count and any block count, so leaves above 16 blocks stay
on the device here), the compile breaker and the mesh router. A failed
launch raises; nothing answers from the host instead.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.utils.device import resolve_device

# Inner levels at or below this width are finished by hashlib on the
# host. A module attribute, read at each call, so tests can set it to 1
# to run every level through the kernel.
HOST_TAIL_WIDTH = 128


def host_levels(level: List[bytes]) -> List[List[bytes]]:
    """`level` and every level above it up to the root, pairing adjacent
    nodes and carrying an odd last one up, with hashlib: the whole tree
    of a small one (crypto/merkle.py) and the top of a large one."""
    levels = [level]
    while len(level) > 1:
        nxt = [hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        levels.append(nxt)
        level = nxt
    return levels


def _digests(state: torch.Tensor) -> List[bytes]:
    """(8, n) device states -> n 32-byte digests."""
    buf = sha256.state_to_digests(state.cpu().numpy()).tobytes()
    return [buf[i:i + 32] for i in range(0, len(buf), 32)]


class MerkleHasher:
    """``root(items)`` and ``tree(items)`` of a list of leaves (bytes) on
    `device` (None: the card; "cpu": the kernels' plain versions)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def pack(self, items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Leaves -> (blocks (T, 64) uint8, offsets (N,) int32, counts
        (N,) int32): each leaf's 0x00 prefix, bytes and padding in its own
        blocks (``sha256.pack_leaves``)."""
        return sha256.pack_leaves(items)

    def device_levels(self, blocks: np.ndarray, offsets: np.ndarray, counts: np.ndarray) -> List[torch.Tensor]:
        """Upload packed leaves and hash them: levels[l] the (8, width)
        int32 states of level l on the device, down to the first width
        <= HOST_TAIL_WIDTH (or one node)."""
        b, o, c = (torch.from_numpy(a) for a in (blocks, offsets, counts))
        if self.device.type == "cuda":
            b, o, c = b.to(self.device), o.to(self.device), c.to(self.device)
        levels = [sha256.leaf_block_states(b, c, o)]
        while levels[-1].shape[1] > max(HOST_TAIL_WIDTH, 1):
            levels.append(sha256.merkle_inner_level(levels[-1], levels[-1].shape[1]))
        return levels

    def root(self, items: Sequence[bytes]) -> bytes:
        """The merkle root of at least one leaf."""
        if not items:
            raise ValueError("MerkleHasher.root needs at least one leaf")
        return host_levels(_digests(self.device_levels(*self.pack(items))[-1]))[-1][0]

    def tree(self, items: Sequence[bytes]) -> List[List[bytes]]:
        """Every level as a list of digests, the leaves first and the root
        last: what the proofs' aunts are read from."""
        if not items:
            raise ValueError("MerkleHasher.tree needs at least one leaf")
        levels = [_digests(lv) for lv in self.device_levels(*self.pack(items))]
        return levels[:-1] + host_levels(levels[-1])
