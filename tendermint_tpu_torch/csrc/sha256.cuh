// SHA-256's compression function for one thread, the steps of
// sha256_leaf_blocks (a leaf's blocks a thread) and those of merkle_tree
// (sha256_kernels.cu), which hashes every inner level of a tree in one
// launch.
//
// The compression is the counterpart of the JAX package's ops/sha256.py
// _compress: 64 rounds of 32-bit adds, rotates and logic on eight live
// words, with the message schedule rolled through sixteen registers. A
// rotate is one funnel shift. The round constants are immediates of the
// unrolled rounds.
//
// merkle_tree's steps, for a block of B threads and chunks of 2B nodes
// (2B a power of two, so that an aligned chunk is a complete subtree under
// Tendermint's split-point recursion):
//
//   tree_chunk   2B nodes of a level into shared memory (coalesced), then
//                up to log2(2B) levels up there, a node a thread, the
//                active threads halving each level, the odd last node of a
//                level carried; each level's nodes also into the flat
//                output when the caller asks for the tree; the chunk's top
//                node to a column of `dst`.
//   tree_top     the last block's: the chunk roots a level at a time in
//                global memory while they are wider than 2B (a ping-pong
//                between two regions of the scratch), then one chunk in
//                shared memory up to the root.
//
// sha256_leaf_blocks' step, for thread i of a launch:
//
//   leaf_thread  row i: its offset and count clamped to the buffer, its
//                blocks compressed in a chain whose next block is copied
//                into a stage of its own before the current one's rounds
//                (leaf_chain), its state to column i.
//
// Everything here is static or inline, so each includer keeps its own
// copy. Without nvcc (csrc/sha256_host.cc, g++) the same functions
// compile as host C++, and `par` (lanes.cuh) runs a block's threads in
// turn over each step.
#pragma once
#include <stdint.h>

#include "lanes.cuh"

#if defined(__CUDACC__)
#define SHA_FN static __device__ __forceinline__
#define SHA_HD static __host__ __device__ __forceinline__
#else
#define SHA_FN static inline
#define SHA_HD static inline
#endif

namespace tmk {

SHA_FN uint32_t sha256_rotr(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

SHA_FN void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u;
  st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu;
  st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu;
  st[7] = 0x5be0cd19u;
}

// st += compress(st, w); w (the block's 16 big-endian words) is
// overwritten by the schedule.
SHA_FN void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  const uint32_t K[64] = {
      0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
      0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
      0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
      0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
      0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
      0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
      0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
  };
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t x1 = w[(t + 1) & 15], x14 = w[(t + 14) & 15];
      const uint32_t s0 = sha256_rotr(x1, 7) ^ sha256_rotr(x1, 18) ^ (x1 >> 3);
      const uint32_t s1 = sha256_rotr(x14, 17) ^ sha256_rotr(x14, 19) ^ (x14 >> 10);
      w[t & 15] += s0 + w[(t + 9) & 15] + s1;
    }
    const uint32_t big1 = sha256_rotr(e, 6) ^ sha256_rotr(e, 11) ^ sha256_rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + big1 + ch + K[t] + w[t & 15];
    const uint32_t big0 = sha256_rotr(a, 2) ^ sha256_rotr(a, 13) ^ sha256_rotr(a, 22);
    const uint32_t maj = (a & b) | (c & (a | b));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// -- sha256_leaf_blocks -----------------------------------------------------

// A call's arguments. Row r's counts[r] blocks start at block offsets[r]
// of the flat (total, 64) buffer; its state goes to column r of the (8,
// n) output, word k at k * n + r.
struct LeafArgs {
  const uint8_t* blocks;  // (total, 64), 16-byte aligned
  const int32_t* offsets;
  const int32_t* counts;
  int n;
  int total;
  uint32_t* state;
};

// A word of the host-written arrays, read once (the read-only path).
SHA_FN int32_t sha256_ld(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

SHA_FN uint32_t sha256_bswap(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// A thread's two stages of a block. `Stages` provides fetch(s, block):
// start copying the block's 64 bytes into stage s; commit(): close the
// copies started since the last commit into a group; wait_prev(): wait
// for every group but the newest; words(s, w): stage s as the block's 16
// big-endian words. The device's (sha256_kernels.cu SmemStages) copy into
// shared memory with cp.async, the host's (sha256_host.cc) with memcpy.
//
// st = the state after `count` blocks from `p`. Software-pipelined: block
// b + 1's copy starts before block b's 64 rounds, so its latency (several
// hundred cycles from device memory) runs under a compression instead of
// before it; only the first block's is exposed. The copy lands in shared
// memory, not in registers: no register holds the next block across the
// rounds, so ptxas has no reason to sink its loads towards their use (it
// sank a prefetch into 16 registers to the rounds' last sixth).
template <class Stages>
SHA_FN void leaf_chain(uint32_t st[8], const uint8_t* p, int count, Stages& s) {
  sha256_init(st);
  if (count > 0) s.fetch(0, p);
  s.commit();
  for (int b = 0; b < count; ++b) {
    if (b + 1 < count) s.fetch((b + 1) & 1, p + (size_t)(b + 1) * 64);
    s.commit();
    s.wait_prev();
    uint32_t w[16];
    s.words(b & 1, w);
    sha256_compress(st, w);
  }
}

// Row i. An offset outside [0, total] takes no block, a count is clamped
// to [0, the blocks left from the offset]; a row that takes none keeps the
// initial state.
template <class Stages>
SHA_FN void leaf_thread(const LeafArgs& a, int row, Stages& s) {
  const int start = sha256_ld(a.offsets + row);
  const int limit = start >= 0 && start <= a.total ? a.total - start : 0;
  int count = sha256_ld(a.counts + row);
  count = count < 0 ? 0 : (count > limit ? limit : count);
  uint32_t st[8];
  leaf_chain(st, a.blocks + (size_t)(count ? start : 0) * 64, count, s);
#pragma unroll
  for (int k = 0; k < 8; ++k) a.state[(size_t)k * a.n + row] = st[k];
}

// st = the state words of sha256(0x01 || left || right), the children
// given as theirs. Block 1 is 0x01 || left || right[0:31]: its words are
// the children's words shifted right by one byte. Block 2 is right[31] ||
// 0x80 || zeros || the 520-bit length: one varying word.
SHA_FN void sha256_inner(uint32_t st[8], const uint32_t left[8], const uint32_t right[8]) {
  uint32_t w[16];
  w[0] = 0x01000000u | (left[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[k] = (left[k - 1] << 24) | (left[k] >> 8);
  w[8] = (left[7] << 24) | (right[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[8 + k] = (right[k - 1] << 24) | (right[k] >> 8);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (right[7] << 24) | 0x00800000u;
#pragma unroll
  for (int k = 1; k < 15; ++k) w[k] = 0;
  w[15] = 65 * 8;
  sha256_compress(st, w);
}

// -- merkle_tree -------------------------------------------------------------

// Levels above n >= 1 leaves, level l's width (width_{l+1} =
// ceil(width_l / 2)) and its first column in the flat (8, total) output.
SHA_FN int tree_height(int n) {
  int h = 0;
  while ((1 << h) < n) ++h;
  return h;
}
SHA_FN int tree_width(int n, int l) { return ((n - 1) >> l) + 1; }
SHA_FN int tree_offset(int n, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += tree_width(n, i);
  return off;
}

// A call's arguments. Node i of a level is column i of an (8, stride)
// word-major array: word k at k * stride + i.
struct TreeArgs {
  const uint32_t* leaves;  // (8, stride): the n leaf states, stride >= n
  int stride;
  int n;
  uint32_t* flat;  // (8, total): every level, leaves first; null for the root alone
  int total;
  uint32_t* scratch;  // (8, sstride): the chunk roots, then the top's second region
  int sstride;
  uint32_t* root;  // (8, rstride): the root in column 0
  int rstride;
};

template <int B>
struct TreeSmem {
  alignas(16) uint32_t node[2][8][2 * B];  // a chunk's level and the next, word-major
};

// A node word written by another block: read through L2, not L1.
SHA_FN uint32_t tree_ld(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// st = the parent of `left` and `right` when they pair, else `left`
// carried up (the odd last node of a level).
SHA_FN void tree_node(uint32_t st[8], const uint32_t* left, const uint32_t* right, bool pair) {
  if (pair) {
    sha256_inner(st, left, right);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = left[k];
  }
}

// Chunk c of level l (`src`, column stride `sst`): `levels` levels up in
// shared memory; the chunk's top node to column c of `dst` (stride dstr).
template <int B>
SHA_FN void tree_chunk(const Lanes& L, TreeSmem<B>& S, const TreeArgs& a, const uint32_t* src, int sst, int l, int c,
                       int levels, uint32_t* dst, int dstr) {
  constexpr int C = 2 * B;
  const int lo = c * C;
  const int w = tree_width(a.n, l);
  int m = w - lo < C ? w - lo : C;
  const bool copy = a.flat != nullptr && l == 0;
  par(L, 8 * C, [&](int u) {
    const int k = u / C, i = u % C;
    if (i < m) {
      const uint32_t v = tree_ld(src + (size_t)k * sst + lo + i);
      S.node[0][k][i] = v;
      if (copy) a.flat[(size_t)k * a.total + lo + i] = v;
    }
  });
  int cur = 0;
  for (int j = 0; j < levels; ++j) {
    const int half = (m + 1) / 2;
    const int off = a.flat != nullptr ? tree_offset(a.n, l + j + 1) + (lo >> (j + 1)) : 0;
    par(L, half, [&](int i) {
      uint32_t left[8], right[8], st[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        left[k] = S.node[cur][k][2 * i];
        right[k] = S.node[cur][k][2 * i + 1];
      }
      tree_node(st, left, right, 2 * i + 1 < m);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        S.node[cur ^ 1][k][i] = st[k];
        if (a.flat != nullptr) a.flat[(size_t)k * a.total + off + i] = st[k];
      }
    });
    cur ^= 1;
    m = half;
  }
  par(L, 1, [&](int) {
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(size_t)k * dstr + c] = S.node[cur][k][0];
  });
}

// Block c's chunk of the leaves. Returns whether the tree has a top to
// finish: with one chunk the chunk's top node is the root.
template <int B>
SHA_FN bool tree_block(const Lanes& L, TreeSmem<B>& S, const TreeArgs& a, int c) {
  const int log_chunk = tree_height(2 * B);
  const int height = tree_height(a.n);
  if (a.n <= 2 * B) {
    tree_chunk<B>(L, S, a, a.leaves, a.stride, 0, 0, height, a.root, a.rstride);
    return false;
  }
  tree_chunk<B>(L, S, a, a.leaves, a.stride, 0, c, log_chunk, a.scratch, a.sstride);
  return true;
}

// The last block's: from the chunk roots (level log2(2B), the scratch's
// first region) to the root.
template <int B>
SHA_FN void tree_top(const Lanes& L, TreeSmem<B>& S, const TreeArgs& a) {
  int l = tree_height(2 * B);
  const int chunks = tree_width(a.n, l);
  uint32_t* src = a.scratch;
  uint32_t* dst = a.scratch + chunks;
  int w = chunks;
  while (w > 2 * B) {
    const int half = (w + 1) / 2;
    const int off = a.flat != nullptr ? tree_offset(a.n, l + 1) : 0;
    par(L, half, [&](int i) {
      uint32_t left[8], right[8], st[8];
      const bool pair = 2 * i + 1 < w;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        left[k] = tree_ld(src + (size_t)k * a.sstride + 2 * i);
        right[k] = pair ? tree_ld(src + (size_t)k * a.sstride + 2 * i + 1) : 0;
      }
      tree_node(st, left, right, pair);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dst[(size_t)k * a.sstride + i] = st[k];
        if (a.flat != nullptr) a.flat[(size_t)k * a.total + off + i] = st[k];
      }
    });
    uint32_t* t = src;
    src = dst;
    dst = t;
    w = half;
    ++l;
  }
  tree_chunk<B>(L, S, a, src, a.sstride, l, 0, tree_height(a.n) - l, a.root, a.rstride);
}

// Columns of scratch a tree of n leaves needs with chunks of 2B: the
// chunk roots and half as many again, none for a single chunk.
SHA_HD int tree_scratch(int n, int B) {
  const int chunks = (n + 2 * B - 1) / (2 * B);
  return chunks > 1 ? chunks + (chunks + 1) / 2 : 0;
}

}  // namespace tmk
