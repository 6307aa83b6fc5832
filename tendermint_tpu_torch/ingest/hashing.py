"""Batched tx keys for mempool admission: the port's copy of the JAX
package's ``ingest/hashing.py``.

``mempool.tx_key`` is plain ``sha256(tx)``, no merkle leaf prefix. So
the rows are packed without it (``pack_msg_blocks``: the flat packer
``ops/sha256.py`` ``pack_leaves`` with ``prefix_len=0``, each row's own
blocks) and go through the merkle engine's leaf stage
(``models/hasher.py`` ``leaf_states``: one ``sha256_leaf_blocks`` launch
a bundle, or one a device with a router); the (8, N) states come back as
digests.

Routing by size, the reference's own rule: a bundle under ``threshold``
rows (``keys_or_host``) is hashed with ``hashlib``; a bundle of more than
``MAX_BUCKET`` rows, or with a row of more than ``MAX_TX_BLOCKS`` blocks,
is declined by ``keys`` (None) and counted in ``hash_fallback_shape``,
and ``keys_or_host`` then hashes it with ``hashlib``. Not copied from the
JAX module, which needs them for XLA's compiles: the power-of-two buckets
and their padding rows, the background compiles, the cold-bucket
fallback and the compile breaker (the kernel takes any row and block
count). A launch that fails raises; nothing answers from ``hashlib``
instead. ``hash_fallback_cold`` stays in ``stats`` at 0, so the two
hashers' counters compare key for key.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch.models import hasher
from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.utils.device import on_device, resolve_device

# The reference's shape caps: above these a bundle goes to hashlib.
MAX_BUCKET = 1 << 16
MAX_TX_BLOCKS = 33  # ~2 KiB txs; longer rows go host


def host_keys(items: Sequence[bytes]) -> List[bytes]:
    """The reference path: per-tx hashlib (what mempool.tx_key does)."""
    return [hashlib.sha256(bytes(t)).digest() for t in items]


def pack_msg_blocks(items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain-sha256 packing, the merkle packer without its 0x00 leaf
    prefix: (blocks (T, 64) uint8, offsets (N,) int32, counts (N,)
    int32); row i is msg || 0x80 || zeros || its 64-bit big-endian bit
    length in its counts[i] blocks from block offsets[i] on."""
    return sha256.pack_leaves(items, prefix_len=0)


class TxKeyHasher:
    """``keys(items)``: the (N,) list of 32-byte sha256 digests of raw
    txs through the leaf kernel on `device` (None: the card; "cpu": its
    plain version), or None for a bundle over the shape caps (the caller
    then runs ``host_keys``). With a ``router``
    (``parallel.topology.MeshRouter``) the rows of a bundle it plans as
    collective split over its devices, as the merkle engine's leaves do."""

    def __init__(self, device=None, router=None):
        self.device = resolve_device(device)
        self.router = router
        self._lock = threading.Lock()
        self.device_bundles = 0
        self.device_rows = 0
        self.host_bundles = 0
        self.host_rows = 0
        self.fallback_shape = 0

    def keys(self, items: Sequence[bytes]) -> Optional[List[bytes]]:
        n = len(items)
        if n == 0:
            return []
        n_blocks = (max(len(t) for t in items) + 72) // 64
        if n > MAX_BUCKET or n_blocks > MAX_TX_BLOCKS:
            with self._lock:
                self.fallback_shape += 1
            return None
        states = hasher.leaf_states(*pack_msg_blocks(items), self.device, self.router)
        with on_device(self.device):
            keys = sha256.digest_list(states)
        with self._lock:
            self.device_bundles += 1
            self.device_rows += n
        return keys

    def keys_or_host(self, items: Sequence[bytes], threshold: int) -> List[bytes]:
        """The routing entry the batcher calls: the kernel when the bundle
        clears ``threshold`` rows and the shape caps, else hashlib;
        identical digests either way."""
        if len(items) >= max(1, threshold):
            out = self.keys(items)
            if out is not None:
                return out
        with self._lock:
            self.host_bundles += 1
            self.host_rows += len(items)
        return host_keys(items)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hash_device_bundles": self.device_bundles,
                "hash_device_rows": self.device_rows,
                "hash_host_bundles": self.host_bundles,
                "hash_host_rows": self.host_rows,
                "hash_fallback_cold": 0,
                "hash_fallback_shape": self.fallback_shape,
            }
