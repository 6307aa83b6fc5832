"""sha256_leaf_blocks' own thread step on the CPU: csrc/sha256.cuh built as
host C++ (csrc/sha256_host.cc, g++), held against hashlib and the port's
plain version (ops/sha256.py leaf_blocks_plain).

The host build runs the kernel's step (leaf_thread) for every thread in
turn: thread i takes row i, clamps its offset and count to the buffer,
copies each next block into its other stage before the current one's
rounds and writes its state to column i. So every row's state must land in its own column, and
the edge cases of the clamps must match the plain version. The library is
built once for the module; the rows come from numpy seeds.
"""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.ops import sha256
from tendermint_tpu_torch.ops.sha256_host import HostSHA256


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the host build of sha256.cuh needs a C++ compiler")
    return HostSHA256(tmp_path_factory.mktemp("sha256_leaf_host"))


def ragged(seed: int, n: int, max_len: int = 700):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, max_len, n)]


def digests(state: np.ndarray):
    return [d.tobytes() for d in sha256.state_to_digests(state)]


def plain(blocks, offsets, counts) -> np.ndarray:
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (blocks, counts, offsets)]
    return sha256.leaf_blocks_plain(*t).numpy().view(np.uint32)


@pytest.mark.parametrize("max_len", [120, 700, 2048])
@pytest.mark.parametrize("prefix", [0, 1])
def test_states_equal_hashlib(host, max_len, prefix):
    """Merkle leaves (0x00 prefix) and tx keys (none) of 0 to max_len - 1
    bytes (1-3, 1-12 and 1-33 blocks a row), n not a multiple of a warp's
    32."""
    items = ragged(7 + prefix + max_len, 101, max_len)
    blocks, offsets, counts = sha256.pack_leaves(items, prefix_len=prefix)
    st = host.leaf_blocks(blocks, offsets, counts)
    assert digests(st) == [hashlib.sha256(bytes(prefix) + it).digest() for it in items]


@pytest.mark.parametrize("n", [1, 31, 33, 65])
def test_rows_not_a_multiple_of_a_warp(host, n):
    items = ragged(n, n, 200)
    blocks, offsets, counts = sha256.pack_leaves(items)
    assert digests(host.leaf_blocks(blocks, offsets, counts)) == [hashlib.sha256(b"\x00" + it).digest()
                                                                  for it in items]


@pytest.mark.parametrize("length", [0, 55, 100])
def test_all_rows_equal(host, length):
    """Rows of one length (one block, the last one-block length, two
    blocks): every column the same digest."""
    items = [bytes(range(length))] * 40
    blocks, offsets, counts = sha256.pack_leaves(items)
    assert len(set(counts.tolist())) == 1
    want = hashlib.sha256(b"\x00" + items[0]).digest()
    assert digests(host.leaf_blocks(blocks, offsets, counts)) == [want] * 40


def test_one_long_row_among_one_block_rows(host):
    """A 40-block row among 70 one-block rows: hashlib's digests and the
    plain version's states."""
    items = ragged(5, 70, 40)
    items[37] = bytes(range(256)) * 9 + bytes(40 * 64 - 73 - 256 * 9)
    blocks, offsets, counts = sha256.pack_leaves(items)
    assert counts[37] == 40 and int(np.delete(counts, 37).max()) == 1
    want = [hashlib.sha256(b"\x00" + it).digest() for it in items]
    ref = plain(blocks, offsets, counts)
    assert digests(ref) == want
    np.testing.assert_array_equal(host.leaf_blocks(blocks, offsets, counts), ref)


def test_clamped_offsets_and_counts(host):
    """Counts of 0 and below (the initial state), offsets at and past the
    buffer's end and below 0 (no block), counts past the buffer's end
    (clamped to the blocks left): the host build equals the plain
    version."""
    items = ragged(11, 12, 300)
    blocks, offsets, counts = sha256.pack_leaves(items)
    total = blocks.shape[0]
    offsets, counts = offsets.copy(), counts.copy()
    counts[0] = 0
    counts[1] = -3
    offsets[2], counts[2] = total, 2
    offsets[3], counts[3] = total + 5, 1
    offsets[4] = -1
    offsets[5], counts[5] = total - 2, 9  # two blocks left
    counts[6] = 1 << 30
    ref = plain(blocks, offsets, counts)
    iv = np.array(sha256.H0, dtype=np.uint32)
    for r in (0, 1, 2, 3, 4):
        np.testing.assert_array_equal(ref[:, r], iv)
    assert np.array_equal(ref[:, 5], plain(blocks, [total - 2], [2])[:, 0])
    np.testing.assert_array_equal(host.leaf_blocks(blocks, offsets, counts), ref)


def test_every_column_is_written(host):
    """Over an output filled with a sentinel, every column of every row,
    the clamped ones included, is written: no column keeps the fill."""
    items = ragged(17, 40, 300)
    blocks, offsets, counts = sha256.pack_leaves(items)
    counts = counts.copy()
    counts[::7] = 0
    st = host.leaf_blocks(blocks, offsets, counts, fill=0xDEADBEEF)
    np.testing.assert_array_equal(st, host.leaf_blocks(blocks, offsets, counts, fill=0))
    np.testing.assert_array_equal(st, plain(blocks, offsets, counts))


def test_wrapper_on_the_cpu_is_the_plain_version():
    """leaf_block_states on CPU tensors equals leaf_blocks_plain, and
    refuses a wrong dtype or shape."""
    items = ragged(19, 45, 400)
    blocks, offsets, counts = sha256.pack_leaves(items)
    ref = plain(blocks, offsets, counts)
    b, o, c = (torch.from_numpy(a) for a in (blocks, offsets, counts))
    np.testing.assert_array_equal(sha256.leaf_block_states(b, c, o).numpy().view(np.uint32), ref)
    with pytest.raises(TypeError):
        sha256.leaf_block_states(b, c.to(torch.int64), o)
    with pytest.raises(ValueError):
        sha256.leaf_block_states(b, c, o[:-1])


def test_dense_layout_through_the_thread_step(host):
    """The JAX package's dense (N, B, 64) layout (pack_leaf_blocks: every
    row padded to the longest, padding rows of count 0) turned flat by
    dense_to_flat gives the same states as the flat packer."""
    items = ragged(23, 30, 500)
    dense, dcounts = sha256.pack_leaf_blocks(items, 32, sha256.leaf_blocks_needed(max(map(len, items))))
    b, c, o = sha256.dense_to_flat(torch.from_numpy(dense), torch.from_numpy(dcounts))
    st = host.leaf_blocks(b.numpy(), o.numpy(), c.numpy())
    blocks, offsets, counts = sha256.pack_leaves(items)
    np.testing.assert_array_equal(st[:, :30], host.leaf_blocks(blocks, offsets, counts))
    np.testing.assert_array_equal(st[:, 30:], np.repeat(np.array(sha256.H0, dtype=np.uint32)[:, None], 2, axis=1))


def test_a_leaf_launch_takes_the_rows_as_packed(monkeypatch):
    """The merkle engine's leaf stage (models/hasher.py, the leaf stage of
    the roots and the tx keys) hands the kernel the packer's blocks,
    offsets and counts unchanged, in one launch, rows in packer order."""
    from tendermint_tpu_torch.models import hasher

    seen = []

    def launch(blocks, counts, offsets):
        seen.append((blocks.numpy().copy(), offsets.numpy().copy(), counts.numpy().copy()))
        return torch.zeros((8, counts.shape[0]), dtype=torch.int32)

    monkeypatch.setattr(sha256, "leaf_block_states", launch)
    items = ragged(29, 77, 900)
    blocks, offsets, counts = sha256.pack_leaves(items)
    out = hasher.leaf_states(blocks, offsets, counts, torch.device("cpu"))
    assert out.shape == (8, 77) and len(seen) == 1
    for got, want in zip(seen[0], (blocks, offsets, counts)):
        np.testing.assert_array_equal(got, want)
