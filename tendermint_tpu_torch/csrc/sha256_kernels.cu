// The two kernels of the batched SHA-256 merkle engine: one thread per
// leaf, and a whole tree's inner levels in one launch.
//
//   sha256_leaf_blocks  replaces ops/sha256.py leaf_block_state and
//                       leaf_block_update
//   merkle_tree         replaces ops/sha256.py merkle_inner_first and
//                       merkle_inner_tail, applied level by level, and the
//                       JAX engine's host finish of the narrow top
//                       (models/hasher.py)
//
// (paths in the JAX package, tendermint_tpu/). The JAX package splits
// each function into one compression per jitted graph because XLA:CPU
// collapses past that (ops/sha256.py:8-19); on the card a leaf of any
// number of blocks, or both blocks of an inner node, is a loop inside one
// thread. The leaves come as one flat buffer of their blocks with a block
// offset a row, so a tree with one long leaf uploads its bytes and not
// every leaf padded to the longest (the JAX package's dense (N, B, 64)
// layout). The (8, N) state seam is the JAX package's: word k of
// consecutive rows is contiguous, so a warp's stores of one word coalesce.
//
// What bounds them: at 10,000 leaves the leaf launch is about 10,000
// compressions and the tree 9,999 inner nodes of two (64 rounds of 14
// instructions once ptxas merges 3-input logic into LOP3 and adds into
// IADD3, 48 schedule words of 10: ~0.8 us a level's worth at the card's
// 32-bit integer rate) and under 1 MB of traffic (~0.3 us). The tree's
// real floor is its critical path: 14 dependent levels of two
// compressions, each node one thread's chain of about 2,600 32-bit
// integer instructions, and a warp issues one of those every second
// cycle at best (16 INT32 lanes a scheduler): about 37 us at 1.98 GHz
// (scripts/prepare_tree_sweep.py measured 7 us for one node, launch
// included). A launch a level (the first form) paid a launch and the gap
// between dependent launches 7 times a root and left the top 7 levels to
// hashlib. What the design does about it: one launch for the whole tree.
// A block of B threads hashes an aligned chunk of 2B nodes up to its root
// in shared memory (sha256.cuh tree_chunk), and the last block to finish,
// elected by a ticket, takes the chunk roots up to the root (tree_top). B
// is compiled in (kTreeThreads, the fastest chunk of 64, 128, 256 and 512
// nodes at 10,000, 100,000 and 1,000,000 leaves:
// scripts/prepare_tree_sweep.py).
#include <stdint.h>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace tmk {

constexpr int kShaBlock = 128;
constexpr int kTreeThreads = 256;  // B of merkle_tree: chunks of 512 nodes

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

// The ticket that elects a launch's last block; that block puts it back
// to 0 for the next launch on the device, so launches of merkle_tree on
// one device must not overlap (the wrapper launches on the current
// stream).
__device__ unsigned int g_tree_ticket;

// leaves (8, stride) u32 node states, n <= stride the leaf count -> the
// root (8, rstride) column 0, and with `flat` every level, leaves first,
// at the offsets tree_offset gives (8, total). Node i of a level is
// sha256(0x01 || left || right) of nodes 2i and 2i + 1 of the level below,
// or node 2i carried up when it is the last. One block a chunk of 2B
// leaves; the chunk roots go to the scratch (8, sstride), and the block
// whose ticket is last reads them through L2 and finishes the tree.
template <int B>
__global__ void __launch_bounds__(B) merkle_tree(const TreeArgs a) {
  __shared__ TreeSmem<B> S;
  __shared__ bool last;
  const Lanes L{(int)threadIdx.x, B, 0xffffffffu};
  if (!tree_block<B>(L, S, a, (int)blockIdx.x)) return;
  __threadfence();  // this block's chunk root is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_tree_ticket, 1u) == gridDim.x - 1;
    if (last) atomicExch(&g_tree_ticket, 0u);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  tree_top<B>(L, S, a);
}

cudaError_t launch_sha256_leaf_blocks(const uint8_t* blocks, const int32_t* offsets, const int32_t* counts, int n,
                                      int total, uint32_t* state, cudaStream_t stream) {
  sha256_leaf_blocks<<<sha_grid(n), kShaBlock, 0, stream>>>(blocks, offsets, counts, n, total, state);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_merkle_tree_at(const TreeArgs& a, cudaStream_t stream) {
  const int chunks = (a.n + 2 * B - 1) / (2 * B);
  if (a.n < 1 || a.n > a.stride || (chunks > 1 && a.sstride < tree_scratch(a.n, B))) return cudaErrorInvalidValue;
  merkle_tree<B><<<chunks, B, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_merkle_tree(const uint32_t* leaves, int stride, int n, uint32_t* flat, int total,
                               uint32_t* scratch, int sstride, uint32_t* root, int rstride, cudaStream_t stream) {
  const TreeArgs a{leaves, stride, n, flat, total, scratch, sstride, root, rstride};
  return launch_merkle_tree_at<kTreeThreads>(a, stream);
}

// Columns of scratch merkle_tree needs for n leaves, and its chunk.
int merkle_tree_layout(int n, int* chunk) {
  *chunk = 2 * kTreeThreads;
  return tree_scratch(n, kTreeThreads);
}

}  // namespace tmk
