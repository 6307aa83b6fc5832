// The three BLS12-381 kernels (fp381.cuh, bls12_curve.cuh hold the
// arithmetic):
//
//   bls12_pairing_check  replaces ops/bls12.py pairing_check_rows (with
//                        miller_rows and final_exponentiation); with one
//                        pair it also serves pairing_value
//   bls12_map_to_g2      replaces ops/bls12.py map_to_g2 (with
//                        map_to_curve_svdw and clear_cofactor_g2)
//   bls12_g1_aggregate   replaces ops/bls12.py g1_aggregate (g1_padd)
//
// (paths in the JAX package, tendermint_tpu/). Every seam is canonical:
// field elements as 48 big-endian bytes, the identity as a flag, the
// verdict as a byte and the reduced Fp12 value as (2, 3, 2, 48) bytes in
// the JAX package's coefficient order.
//
// What bounds them: operations, Fp products in long dependent chains. A
// pairing check needs some 19,000 Fp products a row by fast algorithms, a
// map some 19,000 (most of them the SvdW maps' Fermat powers, which are
// one chain each), an aggregate of V points about 11 V and one
// inversion. A commit check is one row, or about 120: far too few
// threads for the card if a row is one thread's chain. What the design
// does about it: a row is worked by G lanes, which take the independent
// products of each stage in turn (bls12_curve.cuh), with the row's state
// and the stage's operands in shared memory. G is compiled in, one value
// a kernel: 64 for both, a block of two warps a row, so that a stage's
// products issue from two of the SM's schedulers and a commit's 120 rows
// spread over 120 SMs (the fastest of G = 4 to 128 at those rows, though
// the map's stages hold only 2-7 products and G = 8 is within 3 % of it:
// scripts/bls_lane_sweep.py, PERF.md). The
// products themselves are PTX carry chains (fp381.cuh). The pairing runs
// one Miller loop for both pairs with sparse line products, cyclotomic
// squares in the final exponentiation; the map's cofactor clear runs over
// the NAF of H2.
//
// The aggregate (an aggregated commit's one launch: a row, up to 10,000
// points) spreads a row's points over blocks of kAggChunk, so that 10,000
// points fill the card: each block sums its chunk on groups of kAggLanes
// lanes (the complete addition in two stages of six products) and a tree
// of such additions, writes one partial sum, and the row's last block to
// finish adds up the partials and normalises through one inversion by a
// binary GCD (fp381.cuh fp_inv_gcd: some 25-28 batches of 30 divsteps,
// about 30 us on one thread, where Fermat's chain of about 455 products
// took 0.67 ms). kAggLanes and kAggChunk take the least time summed over
// 128, 4,096 and 10,000 points in scripts/bls_aggregate_sweep.py (G = 2,
// 4, 8; 32 to 256 points a block; PERF.md).
#include <stdint.h>
#include <cuda_runtime.h>

#include "bls12_curve.cuh"

namespace tmk {

constexpr int kWarp = 32;
constexpr int kMaxRowThreads = 128;  // the most lanes a row
constexpr int kAggLanes = 8;         // G of bls12_g1_aggregate
constexpr int kAggChunk = 64;        // points a block of bls12_g1_aggregate
constexpr int kFp12Bytes = 12 * bls::FP_BYTES;
constexpr int kPairingLanes = 64;  // G of bls12_pairing_check
constexpr int kMapLanes = 64;      // G of bls12_map_to_g2

// A row is G lanes: a group of a warp for G <= 32 (32 / G rows a block of
// one warp), else the whole block of G threads (one row a block).
__host__ __device__ constexpr int rows_per_block(int g) { return g > kWarp ? 1 : kWarp / g; }
__host__ __device__ constexpr int row_threads(int g) { return g > kWarp ? g : kWarp; }

// This thread's row within its block, and its lanes.
template <int G>
__device__ __forceinline__ int row_group() {
  return G > kWarp ? 0 : (int)threadIdx.x / G;
}

template <int G>
__device__ __forceinline__ bls::Lanes row_lanes() {
  static_assert((G >= 4 && G <= kWarp && kWarp % G == 0) || G == 2 * kWarp || G == kMaxRowThreads,
                "a row is 4, 8, 16 or 32 lanes of a warp, or a block of 64 or 128");
  const unsigned mask = G >= kWarp ? 0xffffffffu : ((1u << G) - 1) << (row_group<G>() * G);
  return bls::Lanes{G > kWarp ? (int)threadIdx.x : (int)threadIdx.x % G, G, mask};
}

// pk (N, 2, 48), hm and sig (N, 2, 2, 48) -> value (N, 2, 3, 2, 48),
// ok (N,). pairs = 1 reads no sig and returns e(pk, hm) alone. Rows of
// G lanes, each with its PairRow in shared memory.
template <int G>
__global__ void __launch_bounds__(kMaxRowThreads) bls12_pairing_check(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ hm, const uint8_t* __restrict__ sig, int n,
    int pairs, uint8_t* __restrict__ value, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = row_group<G>();
  const int row = blockIdx.x * rows_per_block(G) + group;
  if (row >= n) return;
  const bls::Lanes L = row_lanes<G>();
  bls::PairRow& R = reinterpret_cast<bls::PairRow*>(smem)[group];
  const uint8_t* s = pairs == 2 ? sig + (size_t)row * 4 * bls::FP_BYTES : nullptr;
  const bool one = bls::pairing_row(L, R, value + (size_t)row * kFp12Bytes, pk + (size_t)row * 2 * bls::FP_BYTES,
                                    hm + (size_t)row * 4 * bls::FP_BYTES, s, pairs);
  if (L.lane == 0) ok[row] = one ? 1 : 0;
}

// u0, u1 (N, 2, 48) -> q (N, 2, 2, 48) affine x, y, inf (N,).
template <int G>
__global__ void __launch_bounds__(kMaxRowThreads) bls12_map_to_g2(
    const uint8_t* __restrict__ u0, const uint8_t* __restrict__ u1, int n, uint8_t* __restrict__ q,
    uint8_t* __restrict__ inf) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = row_group<G>();
  const int row = blockIdx.x * rows_per_block(G) + group;
  if (row >= n) return;
  const bls::Lanes L = row_lanes<G>();
  bls::MapRow& R = reinterpret_cast<bls::MapRow*>(smem)[group];
  const size_t off = (size_t)row * 2 * bls::FP_BYTES;
  uint8_t* out = q + (size_t)row * 4 * bls::FP_BYTES;
  const bool is_inf = bls::map_to_g2_row(L, R, out, out + 2 * bls::FP_BYTES, u0 + off, u1 + off);
  if (L.lane == 0) inf[row] = is_inf ? 1 : 0;
}

// Replaces g1_aggregate (ops/bls12.py:771, with g1_padd :735). points
// (V, 2, 48) affine, mask (B, V) -> out (B, 2, 48) affine sums, inf (B,).
// nblk blocks a row, each a chunk of CHUNK points (AggBlock in dynamic
// shared memory, groups of G lanes): the block's sum goes to part (B, nblk,
// 36 words), and the last block of row b to finish (count[b], zeroed by
// the launch) adds up the row's partial sums and normalises. Any V (V = 0
// is one block that selects nothing) and any masks.
template <int G, int CHUNK>
__global__ void __launch_bounds__(bls::kAggThreads) bls12_g1_aggregate(
    const uint8_t* __restrict__ points, const uint8_t* __restrict__ mask, int v, int nblk, uint32_t* part,
    unsigned* count, uint8_t* __restrict__ out, uint8_t* __restrict__ inf) {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16, "a group is 2, 4, 8 or 16 lanes of a warp");
  constexpr int K = bls::kAggThreads / G;
  extern __shared__ __align__(16) uint8_t smem[];
  bls::AggBlock<K>& S = *reinterpret_cast<bls::AggBlock<K>*>(smem);
  const int b = blockIdx.x / nblk, blk = blockIdx.x % nblk;
  const int tid = threadIdx.x, k = tid / G, wl = tid % kWarp;
  const bls::Lanes L{tid % G, G, ((1u << G) - 1) << (wl / G * G)};
  const int lo = blk * CHUNK, hi = min(v, lo + CHUNK);
  bool have = false;
  for (int base = lo; base < hi; base += bls::kAggThreads) {
    // pack the round's selected points, in index order
    const int i = base + tid;
    const bool sel = i < hi && mask[(size_t)b * v + i];
    const unsigned bal = __ballot_sync(0xffffffffu, sel);
    if (wl == 0) S.wsel[tid / kWarp] = __popc(bal);
    __syncthreads();
    int off = __popc(bal & ((1u << wl) - 1)), n = 0;
    for (int w = 0; w < bls::kAggThreads / kWarp; ++w) {
      off += w < tid / kWarp ? S.wsel[w] : 0;
      n += S.wsel[w];
    }
    if (sel) {
      bls::fp_from_bytes(S.pts[off][0], points + (size_t)i * 2 * bls::FP_BYTES);
      bls::fp_from_bytes(S.pts[off][1], points + (size_t)i * 2 * bls::FP_BYTES + bls::FP_BYTES);
    }
    __syncthreads();
    bls::agg_sum_points(L, S.grp[k], S.pts, k, n, K, have);
    __syncthreads();
  }
  if (L.lane == 0) S.have[k] = have;
  __syncthreads();
  for (int s = K / 2; s > 0; s >>= 1) {
    bls::agg_tree_step(L, S.grp, S.have, k, s);
    __syncthreads();
  }
  if (tid < bls::kAggWords)
    part[((size_t)b * nblk + blk) * bls::kAggWords + tid] = bls::agg_partial_word(S.grp[0], S.have[0], tid);
  __threadfence();
  __syncthreads();
  if (tid == 0) S.last = atomicAdd(&count[b], 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!S.last) return;  // the block's own value: uniform
  // the last block: the row's partial sums
  have = false;
  bls::agg_sum_partials(L, S.grp[k], bls::agg_partial_slot(S, k), part + (size_t)b * nblk * bls::kAggWords, k, nblk,
                        K, have);
  if (L.lane == 0) S.have[k] = have;
  __syncthreads();
  for (int s = K / 2; s > 0; s >>= 1) {
    bls::agg_tree_step(L, S.grp, S.have, k, s);
    __syncthreads();
  }
  if (tid == 0) bls::agg_finish(out + (size_t)b * 2 * bls::FP_BYTES, inf + b, S.grp[0], S.have[0]);
}

// Blocks a row of the aggregate: one a chunk, at least one.
static int agg_blocks(int v, int chunk) { return v > chunk ? (v + chunk - 1) / chunk : 1; }

// The aggregate's dynamic shared memory (above 48 KB for G = 2).
template <int G, int CHUNK>
static cudaError_t allow_agg_smem() {
  return cudaFuncSetAttribute(bls12_g1_aggregate<G, CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(bls::AggBlock<bls::kAggThreads / G>));
}

// The dynamic shared memory of a row kernel of G lanes, its rows' state
// (above 48 KB by the function's opt-in, made once a device).
template <class Row, int G, class Kernel>
static cudaError_t allow_row_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(rows_per_block(G) * sizeof(Row)));
}

template <class Row, int G, class Kernel, class... Args>
static cudaError_t launch_rows(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  const int rows = rows_per_block(G);
  kernel<<<(n + rows - 1) / rows, row_threads(G), rows * sizeof(Row), stream>>>(args...);
  return cudaGetLastError();
}

// The constants, and the row kernels' shared-memory opt-in, on the
// current device.
cudaError_t set_bls_constants(const void* host, size_t bytes) {
  if (bytes != sizeof(bls::Constants)) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbol(bls::c_bls, host, bytes);
  if (e == cudaSuccess) e = allow_row_smem<bls::PairRow, kPairingLanes>(bls12_pairing_check<kPairingLanes>);
  if (e == cudaSuccess) e = allow_row_smem<bls::MapRow, kMapLanes>(bls12_map_to_g2<kMapLanes>);
  if (e == cudaSuccess) e = allow_agg_smem<kAggLanes, kAggChunk>();
  return e;
}

void bls12_lanes(int* pairing, int* map, int* aggregate, int* chunk) {
  *pairing = kPairingLanes;
  *map = kMapLanes;
  *aggregate = kAggLanes;
  *chunk = kAggChunk;
}

cudaError_t launch_bls12_pairing_check(const uint8_t* pk, const uint8_t* hm, const uint8_t* sig, int n, int pairs,
                                       uint8_t* value, uint8_t* ok, cudaStream_t stream) {
  return launch_rows<bls::PairRow, kPairingLanes>(bls12_pairing_check<kPairingLanes>, n, stream, pk, hm, sig, n,
                                                  pairs, value, ok);
}

cudaError_t launch_bls12_map_to_g2(const uint8_t* u0, const uint8_t* u1, int n, uint8_t* q, uint8_t* inf,
                                   cudaStream_t stream) {
  return launch_rows<bls::MapRow, kMapLanes>(bls12_map_to_g2<kMapLanes>, n, stream, u0, u1, n, q, inf);
}

// The aggregate's scratch: the partial sums (B, nblk, 36) and a counter a
// row, allocated by the caller for each call.
size_t bls12_g1_aggregate_scratch(int b, int v) {
  return (size_t)b * agg_blocks(v, kAggChunk) * bls::kAggWords * 4 + (size_t)b * 4;
}

template <int G, int CHUNK>
static cudaError_t launch_agg(const uint8_t* points, const uint8_t* mask, int b, int v, uint8_t* scratch,
                             uint8_t* out, uint8_t* inf, cudaStream_t stream) {
  const int nblk = agg_blocks(v, CHUNK);
  uint32_t* part = reinterpret_cast<uint32_t*>(scratch);
  unsigned* count = reinterpret_cast<unsigned*>(part + (size_t)b * nblk * bls::kAggWords);
  cudaError_t e = cudaMemsetAsync(count, 0, (size_t)b * sizeof(unsigned), stream);
  if (e != cudaSuccess) return e;
  bls12_g1_aggregate<G, CHUNK><<<b * nblk, bls::kAggThreads, sizeof(bls::AggBlock<bls::kAggThreads / G>), stream>>>(
      points, mask, v, nblk, part, count, out, inf);
  return cudaGetLastError();
}

cudaError_t launch_bls12_g1_aggregate(const uint8_t* points, const uint8_t* mask, int b, int v, uint8_t* scratch,
                                      uint8_t* out, uint8_t* inf, cudaStream_t stream) {
  return launch_agg<kAggLanes, kAggChunk>(points, mask, b, v, scratch, out, inf, stream);
}

}  // namespace tmk
