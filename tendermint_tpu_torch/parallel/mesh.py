"""The port's mesh: the devices one sharded call spans.

Counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` with one logical axis, ``BATCH_AXIS``, over which
the signature rows shard, and XLA inserts the tally's ``psum``. Here a
mesh is a tuple of ``torch.device``s: a sharded call splits its rows into
contiguous chunks, one a device, launches each chunk's kernels on its
device, and sums the per-device tallies on the host
(``models/verifier.py``). There is no ``NamedSharding``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

BATCH_AXIS = "batch"


def make_mesh(devices: Sequence) -> Tuple[torch.device, ...]:
    """The devices of one sharded call, in shard order. A device may
    appear more than once: its chunks then run one after another on it."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
