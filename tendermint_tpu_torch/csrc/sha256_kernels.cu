// The two kernels of the batched SHA-256 merkle engine, one thread per
// leaf or per inner node.
//
//   sha256_leaf_blocks  replaces ops/sha256.py leaf_block_state and
//                       leaf_block_update
//   merkle_inner_level  replaces ops/sha256.py merkle_inner_first and
//                       merkle_inner_tail
//
// (paths in the JAX package, tendermint_tpu/). The JAX package splits
// each function into one compression per jitted graph because XLA:CPU
// collapses past that (ops/sha256.py:8-19); on the card one kernel per
// function is the natural form: a leaf of any number of blocks, or both
// blocks of an inner node, is a loop inside one thread. The leaves come
// as one flat buffer of their blocks with a block offset a row, so a tree
// with one long leaf uploads its bytes and not every leaf padded to the
// longest (the JAX package's dense (N, B, 64) layout). The (8, N) state
// seam is the JAX package's: word k of consecutive rows is contiguous,
// so a warp's stores of one word coalesce.
//
// What bounds them: at 10,000 leaves a launch is about 10,000
// compressions (64 rounds of 14 instructions once ptxas merges 3-input
// logic into LOP3 and adds into IADD3, 48 schedule words of 10: ~0.8 us
// at the card's 32-bit integer rate) and under 1 MB of traffic
// (~0.3 us), both below the few microseconds a launch
// costs, so they are bound by launch latency; a validator-set hash runs
// one leaf launch and one inner launch per level down to the host tail
// (models/hasher.py). What the design does about it: nothing yet. The
// simple form first; fusing the levels of a tree into one launch is a
// later change.
#include <stdint.h>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace tmk {

constexpr int kShaBlock = 128;

static inline int sha_grid(int n) { return (n + kShaBlock - 1) / kShaBlock; }

// Leaves pre-padded by the host (0x00 prefix, 0x80, bit length) as
// 64-byte blocks, counts (N,) i32 -> state (8, N) u32. Row r compresses
// counts[r] blocks from block offsets[r] of the flat (total, 64) buffer,
// clamped to the buffer, so rows of different lengths share a launch and
// take only their own blocks. The buffer must start 16-byte aligned (the
// wrapper checks; blocks are 64-byte multiples): each block is read as
// four 16-byte loads and byte-swapped into big-endian words.
__global__ void __launch_bounds__(kShaBlock) sha256_leaf_blocks(
    const uint8_t* __restrict__ blocks, const int32_t* __restrict__ offsets, const int32_t* __restrict__ counts,
    int n, int total, uint32_t* __restrict__ state) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int start = offsets[row];
  const int limit = start >= 0 && start <= total ? total - start : 0;
  int count = counts[row];
  count = count < 0 ? 0 : (count > limit ? limit : count);
  const uint4* p = reinterpret_cast<const uint4*>(blocks + (size_t)(count ? start : 0) * 64);
  uint32_t st[8];
  sha256_init(st);
  for (int b = 0; b < count; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(p + 4 * b + q);
      w[4 * q + 0] = __byte_perm(v.x, 0, 0x0123);
      w[4 * q + 1] = __byte_perm(v.y, 0, 0x0123);
      w[4 * q + 2] = __byte_perm(v.z, 0, 0x0123);
      w[4 * q + 3] = __byte_perm(v.w, 0, 0x0123);
    }
    sha256_compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) state[(size_t)k * n + row] = st[k];
}

// level (8, c) u32 node states, m <= c the logical count -> out (8,
// out_c = ceil(m/2)). Node i is sha256(0x01 || left || right) of columns
// 2i and 2i+1 when 2i+1 < m, else (2i == m-1) column 2i carried up.
// Block 1 is 0x01 || left || right[0:31]: its words are the children's
// words shifted right by one byte. Block 2 is right[31] || 0x80 || zeros
// || the 520-bit length: one varying word.
__global__ void __launch_bounds__(kShaBlock) merkle_inner_level(
    const uint32_t* __restrict__ level, int c, int m, int out_c, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_c) return;
  const int l = 2 * i;
  if (l + 1 >= m) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[(size_t)k * out_c + i] = level[(size_t)k * c + l];
    return;
  }
  uint32_t left[8], right[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    left[k] = level[(size_t)k * c + l];
    right[k] = level[(size_t)k * c + l + 1];
  }
  uint32_t w[16];
  w[0] = 0x01000000u | (left[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[k] = (left[k - 1] << 24) | (left[k] >> 8);
  w[8] = (left[7] << 24) | (right[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[8 + k] = (right[k - 1] << 24) | (right[k] >> 8);
  uint32_t st[8];
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (right[7] << 24) | 0x00800000u;
#pragma unroll
  for (int k = 1; k < 15; ++k) w[k] = 0;
  w[15] = 65 * 8;
  sha256_compress(st, w);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[(size_t)k * out_c + i] = st[k];
}

cudaError_t launch_sha256_leaf_blocks(const uint8_t* blocks, const int32_t* offsets, const int32_t* counts, int n,
                                      int total, uint32_t* state, cudaStream_t stream) {
  sha256_leaf_blocks<<<sha_grid(n), kShaBlock, 0, stream>>>(blocks, offsets, counts, n, total, state);
  return cudaGetLastError();
}

cudaError_t launch_merkle_inner_level(const uint32_t* level, int c, int m, uint32_t* out, cudaStream_t stream) {
  const int out_c = (m + 1) / 2;
  merkle_inner_level<<<sha_grid(out_c), kShaBlock, 0, stream>>>(level, c, m, out_c, out);
  return cudaGetLastError();
}

}  // namespace tmk
