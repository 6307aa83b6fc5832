"""Batched SHA-256 for merkle trees: two hand-written CUDA kernels
(``csrc/sha256_kernels.cu``) and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/sha256.py``. There, one
compression per jitted graph kept XLA:CPU inside its fusion budget, so a
leaf of k blocks took ``leaf_block_state`` and k - 1 calls of
``leaf_block_update``, and an inner level ``merkle_inner_first`` then
``merkle_inner_tail``, a level at a time. Here each is one kernel:

- ``leaf_block_states(blocks, counts, offsets)``: blocks (T, 64) uint8,
  the leaves pre-padded by ``pack_leaves`` one after another, offsets
  (N,) int32 each leaf's first block and counts (N,) int32 its blocks
  -> state (8, N); rows of one and of many blocks share a launch and the
  buffer holds each leaf's own blocks only. ``dense_to_flat`` turns the
  JAX package's dense (N, B, 64) layout (``pack_leaf_blocks``: every
  leaf padded to the longest) into this form;
- ``merkle_tree(level, m, levels=False)``: the leaf states (8, C) and
  the leaf count m <= C -> the root (8, 1), or with ``levels=True``
  every level, leaves first, in one flat (8, total) at the offsets
  ``tree_widths(m)`` gives, all in one launch. Node i of a level is
  sha256(0x01 || left || right) of nodes 2i and 2i+1 of the level below,
  or node 2i carried up unchanged when it is the last (the reference's
  split-point recursion is exactly this pairing, level by level; see
  crypto/merkle.py); ``inner_level_plain`` is one level of it;
- ``sha256(msgs)``: (N, L) uint8 -> (N, 32) uint8 digests of
  uniform-length messages, through the leaf kernel over prefix-free
  padding.

A state is (8, N) int32 holding the bits of the big-endian uint32 words,
word-major as in the JAX package's seam (word k of consecutive rows is
contiguous); torch has few operations on uint32, so the plain versions
carry words in int64 with masks and the seam type is int32.

Each wrapper checks device, dtype, shape and contiguity, runs the plain
version for a tensor on the CPU and launches its kernel for a tensor on
the card (or raises: there is no fallback from one to the other).
``<wrapper>.launches`` counts kernel launches and nothing else.

The numpy packers (``pack_leaf_blocks``, ``leaf_blocks_needed``,
``state_to_digests``, ``digests_to_state``) are the port's copies of the
JAX package's host helpers; ``pack_leaves`` is the flat packer the
merkle engine and the tx-key hasher use.
"""

from __future__ import annotations

import operator
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops.ed25519 import _check, _lib, _route, _stream

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

_M32 = 0xFFFFFFFF


# -- the plain versions ----------------------------------------------------------


def _rotr(x, n: int):
    """Rotate right of words in [0, 2^32) held in int64 tensors or ints."""
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(st: List[torch.Tensor], w: list) -> List[torch.Tensor]:
    """One block: st 8 words and w 16 words, each an (N,) int64 in
    [0, 2^32), or a python int for a schedule word that is constant."""
    w = list(w)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        if t >= 16:
            x1, x14 = w[(t + 1) % 16], w[(t + 14) % 16]
            s0 = _rotr(x1, 7) ^ _rotr(x1, 18) ^ (x1 >> 3)
            s1 = _rotr(x14, 17) ^ _rotr(x14, 19) ^ (x14 >> 10)
            w[t % 16] = (w[t % 16] + s0 + w[(t + 9) % 16] + s1) & _M32
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + K[t] + w[t % 16]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + s0 + maj) & _M32
    return [(o + n) & _M32 for o, n in zip(st, (a, b, c, d, e, f, g, h))]


def _initial(n: int, device) -> List[torch.Tensor]:
    return [torch.full((n,), h, dtype=torch.int64, device=device) for h in H0]


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _from_i32(state: torch.Tensor) -> torch.Tensor:
    return state.to(torch.int64) & _M32


def _words(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 blocks -> (..., 16) int64 big-endian words."""
    b = blocks.to(torch.int64).unflatten(-1, (16, 4))
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def dense_to_flat(blocks: torch.Tensor, counts: torch.Tensor):
    """The JAX package's dense (N, B, 64) leaves -> the flat form: (N B,
    64) blocks, row r's offset r B, its count clamped to [0, B]."""
    n, nb = blocks.shape[0], blocks.shape[1]
    if nb == 0:
        raise ValueError("blocks: a leaf has at least one block")
    offsets = torch.arange(n, dtype=torch.int32, device=blocks.device) * nb
    return blocks.reshape(n * nb, 64), counts.clamp(0, nb), offsets


def leaf_blocks_plain(blocks: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    n = counts.shape[0]
    st = _initial(n, blocks.device)
    total = blocks.shape[0]
    start = offsets.to(torch.int64)
    limit = torch.where((start >= 0) & (start <= total), total - start, torch.zeros_like(start))
    cnt = torch.minimum(counts.to(torch.int64).clamp(min=0), limit)
    words = _words(blocks)  # (T, 16)
    for j in range(int(cnt.max()) if n else 0):
        w = words[(start + j).clamp(0, max(total - 1, 0))]
        new = _compress(st, [w[:, t] for t in range(16)])
        st = [torch.where(cnt > j, nw, old) for nw, old in zip(new, st)]
    return _to_i32(torch.stack(st))


def inner_level_plain(level: torch.Tensor, m: int) -> torch.Tensor:
    half = m // 2
    lv = _from_i32(level[:, :m])
    left = [lv[k, 0:2 * half:2] for k in range(8)]
    right = [lv[k, 1:2 * half:2] for k in range(8)]
    # block 1: 0x01 || left || right[0:31], the children shifted by a byte
    w = [0x01000000 | (left[0] >> 8)]
    w += [((left[k - 1] << 24) & _M32) | (left[k] >> 8) for k in range(1, 8)]
    w += [((left[7] << 24) & _M32) | (right[0] >> 8)]
    w += [((right[k - 1] << 24) & _M32) | (right[k] >> 8) for k in range(1, 8)]
    st = _compress(_initial(half, level.device), w)
    # block 2: right[31] || 0x80 || zeros || the 520-bit length
    w2 = [((right[7] << 24) & _M32) | 0x00800000] + [0] * 14 + [65 * 8]
    out = torch.stack(_compress(st, w2))
    if m % 2:
        out = torch.cat([out, lv[:, m - 1:m]], dim=1)
    return _to_i32(out)


def tree_widths(m: int) -> List[int]:
    """The level widths of a tree of m >= 1 leaves, leaves first, up to
    the root: width_{l+1} = ceil(width_l / 2)."""
    widths = [int(m)]
    while widths[-1] > 1:
        widths.append((widths[-1] + 1) // 2)
    return widths


def merkle_tree_plain(level: torch.Tensor, m: int, levels: bool = False) -> torch.Tensor:
    lv = level[:, :m]
    out = [lv]
    while lv.shape[1] > 1:
        lv = inner_level_plain(lv, lv.shape[1])
        out.append(lv)
    return torch.cat(out, dim=1) if levels else lv.contiguous()


# -- the wrappers ------------------------------------------------------------------


def leaf_block_states(blocks: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Pre-padded leaf blocks -> (8, N) int32 state: row r's SHA-256
    state after its counts[r] blocks (its digest, for a fully padded
    leaf). blocks (T, 64) uint8 with offsets (N,) int32, row r's blocks
    from offsets[r] on (clamped to the buffer)."""
    dev = blocks.device
    n = counts.shape[0] if isinstance(counts, torch.Tensor) else -1
    _check(blocks, "blocks", (None, 64), torch.uint8, dev)
    _check(offsets, "offsets", (n,), torch.int32, dev)
    _check(counts, "counts", (n,), torch.int32, dev)
    if not _route(dev):
        return leaf_blocks_plain(blocks, counts, offsets)
    state = torch.empty((8, n), dtype=torch.int32, device=dev)
    if n:
        if blocks.data_ptr() % 16:
            raise ValueError("blocks: the kernel reads 16-byte words; the tensor must start 16-byte aligned")
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_sha256_leaf_blocks(
            blocks.data_ptr(), offsets.data_ptr(), counts.data_ptr(), n, blocks.shape[0], state.data_ptr(),
            _stream(dev)), "sha256_leaf_blocks launch")
        leaf_block_states.launches += 1
    return state


def merkle_tree(level: torch.Tensor, m: int, levels: bool = False) -> torch.Tensor:
    """level (8, C) int32 leaf states and the leaf count m (1 <= m <= C)
    -> the root's state (8, 1) int32, or with ``levels=True`` every level
    of the tree, leaves first, as one (8, sum(tree_widths(m))) int32:
    pairs hashed as sha256(0x01 || left || right) and an odd last node
    carried, level by level up to the root, in one launch."""
    dev = level.device
    _check(level, "level", (8, None), torch.int32, dev)
    c = level.shape[1]
    m = int(m)
    if not 1 <= m <= c:
        raise ValueError(f"leaf count {m} outside [1, {c}]")
    if not _route(dev):
        return merkle_tree_plain(level, m, levels)
    import ctypes

    from tendermint_tpu_torch.ops._build import check

    lib = _lib(dev)
    total = sum(tree_widths(m))
    out = torch.empty((8, total if levels else 1), dtype=torch.int32, device=dev)
    chunk = ctypes.c_int()
    cols = lib.tm_merkle_tree_layout(m, ctypes.byref(chunk))
    scratch = torch.empty((8, cols), dtype=torch.int32, device=dev)
    root = out.data_ptr() + 4 * (total - 1) if levels else out.data_ptr()
    check(lib, lib.tm_merkle_tree(level.data_ptr(), c, m, out.data_ptr() if levels else None, total,
                                  scratch.data_ptr(), cols, root, total if levels else 1, _stream(dev)),
          "merkle_tree launch")
    merkle_tree.launches += 1
    return out


def digest_list(state: torch.Tensor) -> List[bytes]:
    """(8, N) int32 states -> N 32-byte big-endian digests: the words
    turned to bytes on the state's device, then one download and one
    C-level split into bytes objects."""
    n = state.shape[1]
    d = state.t().contiguous().view(torch.uint8).view(n, 8, 4).flip(-1).contiguous().cpu().numpy()
    return d.reshape(n, 32).view("V32").ravel().tolist()


def state_bytes(state: torch.Tensor) -> torch.Tensor:
    """(8, N) int32 state -> (N, 32) uint8 big-endian digests, on the
    state's device."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=state.device)
    st = state.to(torch.int64).t().unsqueeze(-1)  # (N, 8, 1)
    return ((st >> shifts) & 0xFF).reshape(state.shape[1], 32).to(torch.uint8)


def pad(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 -> (N, nb, 64) uint8: each row || 0x80 || zeros ||
    its 64-bit big-endian bit length: nb = (L + 72) // 64 blocks."""
    n, length = msgs.shape
    nb = (length + 72) // 64
    tail = torch.zeros((n, 64 * nb - length), dtype=torch.uint8, device=msgs.device)
    tail[:, 0] = 0x80
    bits = 8 * length
    for j in range(8):
        tail[:, -1 - j] = (bits >> (8 * j)) & 0xFF
    return torch.cat([msgs, tail], dim=1).view(n, nb, 64)


def sha256(msgs: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 of uniform-length messages: (N, L) uint8 ->
    (N, 32) uint8 digests, through ``leaf_block_states`` (the JAX
    package's ``sha256`` program has no kernel of its own here)."""
    dev = msgs.device
    _check(msgs, "msgs", (None, None), torch.uint8, dev)
    blocks = pad(msgs).contiguous()
    counts = torch.full((msgs.shape[0],), blocks.shape[1], dtype=torch.int32, device=dev)
    return state_bytes(leaf_block_states(*dense_to_flat(blocks, counts)))


KERNELS = {
    "sha256_leaf_blocks": leaf_block_states,
    "merkle_tree": merkle_tree,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# -- host helpers (numpy; copies of the JAX package's) -----------------------------


def state_to_digests(state: np.ndarray) -> np.ndarray:
    """(8, N) uint32 (or int32) state words -> (N, 32) uint8 big-endian
    digests."""
    st = np.asarray(state).view(np.uint32)
    return st.byteswap().view(np.uint8).reshape(8, st.shape[1], 4).transpose(1, 0, 2).reshape(st.shape[1], 32)


def digests_to_state(digests: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (8, N) uint32 big-endian words (inverse of
    state_to_digests)."""
    d = np.ascontiguousarray(np.asarray(digests, dtype=np.uint8))
    return (
        d.reshape(d.shape[0], 8, 4).transpose(1, 0, 2).reshape(8, d.shape[0] * 4)
        .view(np.uint32).byteswap().reshape(8, d.shape[0])
    )


def pack_leaf_blocks(items: Sequence[bytes], n_pad: int, n_blocks: int,
                     prefix_len: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pack leaves into fully padded SHA-256 blocks: (n_pad, n_blocks, 64)
    uint8 and (n_pad,) int32 block counts. Row i is ``prefix_len`` zero
    bytes (the merkle 0x00 leaf prefix; 0 for plain messages) || leaf ||
    0x80 || zeros || the 64-bit big-endian bit length. Rows past
    len(items) get count 0 and zero blocks."""
    n = len(items)
    p = int(prefix_len)
    lens = np.fromiter((len(x) for x in items), dtype=np.int64, count=n)
    row = n_blocks * 64
    flat = np.zeros(n_pad * row, dtype=np.uint8)
    counts = np.zeros(n_pad, dtype=np.int32)
    if not n:
        return flat.reshape(n_pad, n_blocks, 64), counts
    if int(lens.min()) == int(lens.max()):
        # uniform leaves: one reshape-copy and constant padding
        length = int(lens[0])
        buf = flat.reshape(n_pad, row)
        if length:
            buf[:n, p:p + length] = np.frombuffer(b"".join(items), dtype=np.uint8).reshape(n, length)
        buf[:n, p + length] = 0x80
        nbi = (length + p + 72) // 64
        buf[:n, nbi * 64 - 8:nbi * 64] = np.frombuffer(((length + p) * 8).to_bytes(8, "big"), dtype=np.uint8)
        counts[:n] = nbi
        return flat.reshape(n_pad, n_blocks, 64), counts
    total = int(lens.sum())
    src = np.frombuffer(b"".join(items), dtype=np.uint8)
    row_base = np.arange(n, dtype=np.int64) * row + p
    if total:
        offs = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        flat[np.repeat(row_base - offs, lens) + np.arange(total, dtype=np.int64)] = src
    flat[row_base + lens] = 0x80
    nb = (lens + p + 72) // 64  # prefix + 1 terminator + 8 length bytes
    bits = (lens + p) * 8
    tail = np.arange(n, dtype=np.int64) * row + nb * 64
    for k in range(8):
        flat[tail - 1 - k] = (bits >> (8 * k)) & 0xFF
    counts[:n] = nb
    return flat.reshape(n_pad, n_blocks, 64), counts


def pack_leaves(items: Sequence[bytes], prefix_len: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Leaves -> (blocks (T, 64) uint8, offsets (N,) int32, counts (N,)
    int32): leaf i fully padded (``prefix_len`` zero bytes, the leaf,
    0x80, zeros, the 64-bit big-endian bit length) in its counts[i]
    blocks from block offsets[i] on, T the sum of the counts. The bytes
    are the leaves' own plus at most 73 a leaf, whatever their spread."""
    n = len(items)
    p = int(prefix_len)
    lens = np.fromiter(map(len, items), dtype=np.int64, count=n)
    nb = (lens + p + 72) // 64
    offs = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(nb[:-1], out=offs[1:])
    # one join of every row's prefix, bytes and padding, with one padding
    # object a distinct length picked out by C-level indexing: no Python
    # loop over the rows and no index array over their bytes (4-14x faster
    # than a scatter of every byte, 2-5x than a strided copy of uniform
    # rows)
    uniq, inv = np.unique(lens, return_inverse=True)
    pads = [b"\x80" + bytes(64 * ((m + p + 72) // 64) - m - p - 9) + ((m + p) * 8).to_bytes(8, "big")
            for m in uniq.tolist()]
    if len(pads) == 1:
        row_pads = pads * n
    elif n > 1:
        row_pads = operator.itemgetter(*inv.tolist())(pads)
    else:
        row_pads = [pads[i] for i in inv.tolist()]
    k = 3 if p else 2  # (prefix,) leaf, padding
    parts = [bytes(p)] * (k * n)
    parts[k - 2::k] = items
    parts[k - 1::k] = row_pads
    flat = np.frombuffer(bytearray().join(parts), dtype=np.uint8)
    return flat.reshape(int(nb.sum()), 64), offs.astype(np.int32), nb.astype(np.int32)


def leaf_blocks_needed(max_len: int) -> int:
    """Blocks for the longest leaf (prefix + terminator + length)."""
    return int((max_len + 73) // 64)
