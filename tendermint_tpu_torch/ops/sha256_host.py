"""The merkle engine's device code as host C++ (``csrc/sha256_host.cc``
over ``csrc/sha256.cuh``), built with ``g++`` and loaded with ctypes.

Not a path of the port: the kernels run on the card only. This build runs
merkle_tree's own steps on the CPU, a block's threads in turn over each
step and the blocks in turn, the last of them finishing the tree, so the
tests can hold the chunk and top schedule against the plain versions and
hashlib without a card, at every chunk size the kernel can be compiled
with.
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
        lib.sha_host_inner.argtypes = [vp, vp, vp]
        lib.sha_host_inner.restype = None
        lib.sha_host_tree_scratch.argtypes = [i32, i32]
        lib.sha_host_tree_scratch.restype = i32
        lib.sha_host_merkle_tree.argtypes = [vp, i32, i32, vp, i32, vp, i32, vp, i32, i32]
        lib.sha_host_merkle_tree.restype = i32
        self.lib = lib

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
