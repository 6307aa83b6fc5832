"""The SHA-256 engine's device code as host C++ (``csrc/sha256_host.cc``
over ``csrc/sha256.cuh``), built with ``g++`` and loaded with ctypes.

Not a path of the port: the kernels run on the card only. This build runs
the kernels' own steps on the CPU: sha256_leaf_blocks' thread step (the
clamps, the chain that copies the next block into a stage of its own
before the current one's rounds, here with memcpy) for every thread in
turn, and merkle_tree's steps, a block's threads in turn over each step
and the blocks in turn, the last of them finishing the tree. So the tests can hold them against the plain
versions and hashlib without a card, the tree at every chunk size the
kernel can be compiled with.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from tendermint_tpu_torch.ops.bls12_host import gxx
from tendermint_tpu_torch.ops.sha256 import tree_widths

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "sha256_host.cc"
CHUNKS = (64, 128, 256, 512)


class HostSHA256:
    """The host build in `build_dir`."""

    def __init__(self, build_dir) -> None:
        out = Path(build_dir) / "libsha256_host.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([gxx(), "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_CSRC), "-o", str(out), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(out))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sha_host_leaf_blocks.argtypes = [vp, vp, vp, i32, i32, vp]
        lib.sha_host_leaf_blocks.restype = None
        lib.sha_host_inner.argtypes = [vp, vp, vp]
        lib.sha_host_inner.restype = None
        lib.sha_host_tree_scratch.argtypes = [i32, i32]
        lib.sha_host_tree_scratch.restype = i32
        lib.sha_host_merkle_tree.argtypes = [vp, i32, i32, vp, i32, vp, i32, vp, i32, i32]
        lib.sha_host_merkle_tree.restype = i32
        self.lib = lib

    def leaf_blocks(self, blocks, offsets, counts, fill: int = 0) -> np.ndarray:
        """sha256_leaf_blocks' thread step on the flat leaf buffer: blocks
        (T, 64) uint8, offsets and counts (N,) int32 -> the (8, N) uint32
        states, over an output first filled with `fill` (a column no
        thread writes keeps it)."""
        b = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 64)
        o, c = (np.ascontiguousarray(x, dtype=np.int32) for x in (offsets, counts))
        n = c.shape[0]
        st = np.full((8, n), fill, dtype=np.uint32)
        self.lib.sha_host_leaf_blocks(b.ctypes.data, o.ctypes.data, c.ctypes.data, n, b.shape[0], st.ctypes.data)
        return st

    def inner(self, left, right) -> np.ndarray:
        """The (8,) uint32 state of sha256(0x01 || left || right) from the
        children's (8,) states."""
        lt, rt = (np.ascontiguousarray(x, dtype=np.uint32) for x in (left, right))
        st = np.zeros(8, dtype=np.uint32)
        self.lib.sha_host_inner(lt.ctypes.data, rt.ctypes.data, st.ctypes.data)
        return st

    def merkle_tree(self, leaves, m: int, chunk: int = 128, levels: bool = False) -> np.ndarray:
        """merkle_tree's steps with chunks of `chunk` leaves on leaf states
        (8, C) uint32 (or int32), the first m columns the leaves: the root
        (8, 1), or with levels=True every level, leaves first, (8, total)."""
        lv = np.ascontiguousarray(np.asarray(leaves).view(np.uint32))
        total = sum(tree_widths(m))
        flat = np.zeros((8, total), dtype=np.uint32) if levels else None
        root = np.zeros((8, 1), dtype=np.uint32)
        cols = self.lib.sha_host_tree_scratch(int(m), chunk)
        scratch = np.zeros((8, max(cols, 1)), dtype=np.uint32)
        code = self.lib.sha_host_merkle_tree(lv.ctypes.data, lv.shape[1], int(m),
                                             None if flat is None else flat.ctypes.data, total, scratch.ctypes.data,
                                             cols, root.ctypes.data, 1, chunk)
        if code != 0:
            raise ValueError(f"host merkle_tree refused chunk {chunk}, m {m}: {code}")
        return flat if levels else root
