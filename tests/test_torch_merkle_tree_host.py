"""merkle_tree's own steps on the CPU: csrc/sha256.cuh built as host C++
(csrc/sha256_host.cc, g++), held against the port's plain version
(ops/sha256.py merkle_tree_plain) and hashlib.

The host build runs a block's threads in turn over each step of the
kernel, the blocks of a launch in turn, and the last of them through the
top, as the last ticket does on the card. So at each chunk size the kernel
can be compiled with (64, 128, 256 and 512 leaves a block) it runs the
card's schedule: one chunk, several chunks with a partial last one and odd
widths at every level, and chunk roots that outnumber one block's chunk,
so that the top loops in global memory. The library is built once for
the module; the leaf states come from numpy seeds.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.models.hasher import host_levels
from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.ops.sha256_host import CHUNKS, HostSHA256

WIDTHS = (1, 2, 3, 5, 127, 128, 129, 1023, 1024, 1025)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of sha256.cuh needs a C++ compiler")
    return HostSHA256(tmp_path_factory.mktemp("sha256_host"))


def states(seed: int, n: int, extra: int = 3) -> np.ndarray:
    """(8, n + extra) uint32 leaf states; the extra columns lie past the
    leaf count and must not be read."""
    return np.random.default_rng(seed).integers(0, 1 << 32, (8, n + extra), dtype=np.uint64).astype(np.uint32)


def digests(state: np.ndarray):
    return [d.tobytes() for d in sha256.state_to_digests(state)]


def test_inner_node_is_sha256_of_its_children(host):
    rng = np.random.default_rng(1)
    for _ in range(20):
        left, right = (rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32) for _ in range(2))
        want = hashlib.sha256(b"\x01" + digests(left[:, None])[0] + digests(right[:, None])[0]).digest()
        assert digests(host.inner(left, right)[:, None]) == [want]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", WIDTHS)
def test_tree_schedule_matches_hashlib(host, chunk, n):
    """Every level, leaves first, and the root alone, against hashlib's
    level recursion at every width and chunk."""
    leaves = states(n, n)
    want = host_levels(digests(leaves[:, :n]))
    flat = host.merkle_tree(leaves, n, chunk, levels=True)
    assert digests(flat) == [d for lv in want for d in lv]
    assert digests(host.merkle_tree(leaves, n, chunk)) == [want[-1][0]]


@pytest.mark.parametrize("n", [1, 129, 1025])
def test_tree_schedule_matches_the_plain_version(host, n):
    """The host build's flat levels equal merkle_tree_plain's, at the
    (8, N) int32 seam."""
    leaves = states(100 + n, n)
    want = sha256.merkle_tree_plain(torch.from_numpy(leaves.view(np.int32)), n, levels=True).numpy()
    for chunk in CHUNKS:
        np.testing.assert_array_equal(host.merkle_tree(leaves, n, chunk, levels=True).view(np.int32), want)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_top_loops_in_global_memory(host, chunk):
    """More chunk roots than one block's chunk, (2B)^2 < n: the last block
    reduces them a level at a time in the scratch before its last chunk."""
    n = chunk * chunk + 2 * chunk + 1
    assert (n + chunk - 1) // chunk > chunk
    leaves = states(chunk, n)
    want = host_levels(digests(leaves[:, :n]))
    assert digests(host.merkle_tree(leaves, n, chunk)) == [want[-1][0]]
    if chunk <= 128:
        assert digests(host.merkle_tree(leaves, n, chunk, levels=True)) == [d for lv in want for d in lv]
