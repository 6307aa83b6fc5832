// The two kernels of the batched SHA-256 engine: a leaf's blocks a thread,
// and a whole tree's inner levels in one launch.
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
// sha256_leaf_blocks serves merkle leaves (a validator set's 10,000 of one
// block, a commit's of one or two), a block's transactions (Txs.hash: one
// to 33 blocks) and the mempool's tx keys (bundles of up to 65,536 rows of
// one to 33 blocks). One compression is about 1,384 32-bit integer
// instructions (below), so a launch of B blocks is bounded by B x 1,384
// instructions at the card's 32-bit integer rate, and each row is one
// thread's chain of count x 1,384, at best one instruction every second
// cycle (16 INT32 lanes a scheduler). What holds it back, and what the
// design does about each:
//   - A warp issues for all 32 lanes until its longest row ends: with
//     rows of 1-33 blocks in the packer's order a warp's longest is about
//     32 blocks against a mean of 17, about 1.9x the issue slots the work
//     needs once the card is throughput-bound. The rows stay in the
//     packer's order all the same: taking them longest first saves device
//     time only there, less than the host sort it needs before the launch
//     costs (PERF.md, scripts/leaf_sweep.py), and rows of one size (the
//     payments' 156 bytes) gain nothing from it.
//   - Block b's loads were issued after block b - 1's compression; with a
//     warp a scheduler nothing hid them. The next block is copied into
//     shared memory (cp.async) before the current one's rounds
//     (sha256.cuh leaf_chain, SmemStages below).
//   - The grid: kLeafThreads = 32 threads a block, compiled in: the
//     fastest of 32, 64 and 128 at all six shapes of
//     scripts/leaf_sweep.py, so 10,000 rows spread over 313 blocks on
//     every SM.
// A row of 33 blocks stays one thread's chain (about 0.046 ms at 1,980
// MHz): a lane of the same warp would share its issue slot.
//
// merkle_tree: at 10,000 leaves the tree is 9,999 inner nodes of two
// compressions (64 rounds of 14 instructions once ptxas merges 3-input
// logic into LOP3 and adds into IADD3, 48 schedule words of 10: ~0.8 us a
// level's worth at the card's 32-bit integer rate) and under 1 MB of
// traffic (~0.3 us). The tree's real floor is its critical path: 14
// dependent levels of two compressions, each node one thread's chain of
// about 2,600 32-bit integer instructions, and a warp issues one of those
// every second cycle at best: about 37 us at 1.98 GHz
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

constexpr int kLeafThreads = 32;  // threads a block of sha256_leaf_blocks
constexpr int kTreeThreads = 256;  // B of merkle_tree: chunks of 512 nodes

// A thread's two stages of a block in shared memory (sha256.cuh
// leaf_chain): 16-byte word q of thread t's stage s at buf[s][q][t], so a
// warp's copies and reads of one word touch 512 consecutive bytes, with
// no bank conflict. The copies are cp.async.ca: through L1, so the two
// 16-byte halves of a 32-byte sector, copied by two instructions, come
// from L2 once (.cg, L2 only, fetched such a sector twice and was slower
// where rows are short).
template <int T>
struct SmemStages {
  uint4 (*buf)[4][T];
  int t;
  __device__ __forceinline__ void fetch(int s, const uint8_t* block) {
    const uint4* p = reinterpret_cast<const uint4*>(block);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[s][q][t]);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p + q) : "memory");
    }
  }
  __device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
  __device__ __forceinline__ void wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
  __device__ __forceinline__ void words(int s, uint32_t w[16]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = buf[s][q][t];
      w[4 * q + 0] = sha256_bswap(v.x);
      w[4 * q + 1] = sha256_bswap(v.y);
      w[4 * q + 2] = sha256_bswap(v.z);
      w[4 * q + 3] = sha256_bswap(v.w);
    }
  }
};

// Pre-padded leaf blocks (ops/sha256.py pack_leaves: prefix, bytes, 0x80,
// bit length) -> the (8, n) states; thread i takes row i, sha256.cuh
// leaf_thread. The buffer must start 16-byte aligned (the wrapper checks;
// blocks are 64-byte multiples): each block is copied as four 16-byte
// words. A thread reads only the stages it copied, so the block needs no
// barrier.
template <int T>
__global__ void __launch_bounds__(T) sha256_leaf_blocks(const LeafArgs a) {
  __shared__ uint4 buf[2][4][T];
  const int i = blockIdx.x * T + threadIdx.x;
  if (i >= a.n) return;
  SmemStages<T> s{buf, (int)threadIdx.x};
  leaf_thread(a, i, s);
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

template <int T>
cudaError_t launch_leaf_blocks_at(const LeafArgs& a, cudaStream_t stream) {
  if (a.n < 0 || a.total < 0) return cudaErrorInvalidValue;
  if (a.n == 0) return cudaSuccess;
  sha256_leaf_blocks<T><<<(a.n + T - 1) / T, T, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_sha256_leaf_blocks(const uint8_t* blocks, const int32_t* offsets, const int32_t* counts, int n,
                                      int total, uint32_t* state, cudaStream_t stream) {
  const LeafArgs a{blocks, offsets, counts, n, total, state};
  return launch_leaf_blocks_at<kLeafThreads>(a, stream);
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
