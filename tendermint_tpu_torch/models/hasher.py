"""MerkleHasher: an RFC-6962-style merkle tree's leaves and inner levels
through the SHA-256 kernels on one device.

Counterpart of the JAX package's ``models/hasher.py``. Every leaf is
hashed in one launch of ``sha256_leaf_blocks`` (leaves of different
block counts together, packed one after another into a flat buffer of
their own blocks, so one long leaf does not pad the others to its
length), then the whole tree above them in one launch of
``merkle_tree``: two launches a root, whatever its width. ``root``
downloads the root's 32 bytes; ``tree`` downloads every level in one
flat buffer and splits it. Pairing adjacent nodes and carrying an odd
last one up is exactly the reference's split-point recursion
(crypto/merkle.py).

``leaf_states`` is the one leaf stage of the port's SHA-256 users: this
hasher's and the tx-key hasher's (``ingest/hashing.py``).

With a ``router`` (``parallel.topology.MeshRouter``) whose topology has
placement, the leaf stage of a tree the router plans as collective runs
per device (``_mesh_leaf_states``): slot [lo, hi) takes its leaves' own
blocks, with the offsets rebased to 0, in one ``sha256_leaf_blocks``
launch on its device; the (8, n) states are concatenated on the
hasher's device and the tree runs there, unrouted, as in the JAX
engine. A failed routed leaf stage is answered by the
single-device launch.

Not copied from the JAX module, which needs them for XLA's compiles:
the leaf-count buckets and their padding rows, the blocking and
background compiles, the cold-bucket and shape declines (the kernels
take any leaf count and any block count, so leaves above 16 blocks stay
on the device here), the compile breaker, and the host finish of the
narrow top (the tree kernel takes every level). A failed launch raises;
nothing answers from the host instead. ``host_levels`` builds the trees
below ``crypto/merkle.py``'s device threshold with hashlib.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.utils.device import on_device, resolve_device

def host_levels(level: List[bytes]) -> List[List[bytes]]:
    """`level` and every level above it up to the root, pairing adjacent
    nodes and carrying an odd last one up, with hashlib: the whole tree
    of one below crypto/merkle.py's device threshold."""
    levels = [level]
    while len(level) > 1:
        nxt = [hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        levels.append(nxt)
        level = nxt
    return levels


def _leaf_launch(blocks: np.ndarray, offsets: np.ndarray, counts: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload packed leaves to `dev` and launch the leaf kernel there:
    the (8, n) int32 states on `dev`."""
    b, o, c = (torch.from_numpy(np.ascontiguousarray(a)) for a in (blocks, offsets, counts))
    with on_device(dev):
        if dev.type == "cuda":
            b, o, c = b.to(dev), o.to(dev), c.to(dev)
        return sha256.leaf_block_states(b, c, o)


def _mesh_leaf_states(router, blocks: np.ndarray, offsets: np.ndarray, counts: np.ndarray, dev: torch.device):
    """The leaf level split over the router's devices: the (8, n) states
    on `dev`, or None to take the single-device leaf launch. Leaf digests
    are independent of each other, so the concatenation equals the single
    launch's states."""
    if router is None or not router.topology.has_placement:
        return None
    plan = router.plan(counts.shape[0])
    if not plan.collective:
        return None

    def dispatch(s):
        first = int(offsets[s.lo])
        nb = int(counts[s.lo:s.hi].sum())
        return _leaf_launch(blocks[first:first + nb], (offsets[s.lo:s.hi] - first).astype(np.int32),
                            counts[s.lo:s.hi], s.device)

    try:
        return router.run(plan, dispatch, lambda outs: torch.cat([o.to(dev) for o in outs], dim=1))
    except Exception:
        return None


def leaf_states(blocks: np.ndarray, offsets: np.ndarray, counts: np.ndarray, dev: torch.device,
                router=None) -> torch.Tensor:
    """Upload packed rows (``sha256.pack_leaves``) and hash them: the (8,
    n) int32 states on `dev`, in one leaf launch there, or one a device
    where `router` plans the rows as collective."""
    states = _mesh_leaf_states(router, blocks, offsets, counts, dev)
    return _leaf_launch(blocks, offsets, counts, dev) if states is None else states


class MerkleHasher:
    """``root(items)`` and ``tree(items)`` of a list of leaves (bytes) on
    `device` (None: the card; "cpu": the kernels' plain versions)."""

    def __init__(self, device=None, router=None):
        self.device = resolve_device(device)
        self.router = router

    def pack(self, items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Leaves -> (blocks (T, 64) uint8, offsets (N,) int32, counts
        (N,) int32): each leaf's 0x00 prefix, bytes and padding in its own
        blocks (``sha256.pack_leaves``)."""
        return sha256.pack_leaves(items)

    def leaf_states(self, blocks: np.ndarray, offsets: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        """Upload packed leaves and hash them: the (8, n) int32 leaf
        states on the hasher's device (routed per device where the router
        plans the tree as collective)."""
        return leaf_states(blocks, offsets, counts, self.device, self.router)

    def root(self, items: Sequence[bytes]) -> bytes:
        """The merkle root of at least one leaf."""
        if not items:
            raise ValueError("MerkleHasher.root needs at least one leaf")
        leaves = self.leaf_states(*self.pack(items))
        with on_device(self.device):
            return sha256.digest_list(sha256.merkle_tree(leaves, leaves.shape[1]))[0]

    def tree(self, items: Sequence[bytes]) -> List[List[bytes]]:
        """Every level as a list of digests, the leaves first and the root
        last: what the proofs' aunts are read from."""
        if not items:
            raise ValueError("MerkleHasher.tree needs at least one leaf")
        leaves = self.leaf_states(*self.pack(items))
        with on_device(self.device):
            flat = sha256.digest_list(sha256.merkle_tree(leaves, leaves.shape[1], levels=True))
        levels, off = [], 0
        for w in sha256.tree_widths(leaves.shape[1]):
            levels.append(flat[off:off + w])
            off += w
        return levels
