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
// the NAF of H2. The aggregate keeps one thread's complete additions over
// a strided share and a tree in shared memory.
#include <stdint.h>
#include <cuda_runtime.h>

#include "bls12_curve.cuh"

namespace tmk {

constexpr int kWarp = 32;
constexpr int kMaxRowThreads = 128;  // the most lanes a row
constexpr int kAggThreads = 128;
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

// One block per batch row b: the points (V, 2, 48) where mask (B, V) is
// set, summed by complete additions, each thread over a strided share,
// then a tree over shared memory; thread 0 normalises into out (B, 2, 48)
// and inf (B,). Any V.
__global__ void __launch_bounds__(kAggThreads) bls12_g1_aggregate(
    const uint8_t* __restrict__ points, const uint8_t* __restrict__ mask, int v, uint8_t* __restrict__ out,
    uint8_t* __restrict__ inf) {
  __shared__ bls::Proj<bls::Fp> part[kAggThreads];
  const int b = blockIdx.x;
  bls::Proj<bls::Fp> acc;
  bls::g1_identity(acc);
  for (int i = threadIdx.x; i < v; i += kAggThreads) {
    if (mask[(size_t)b * v + i]) {
      bls::Proj<bls::Fp> pt;
      bls::fp_from_bytes(pt.X, points + (size_t)i * 2 * bls::FP_BYTES);
      bls::fp_from_bytes(pt.Y, points + (size_t)i * 2 * bls::FP_BYTES + bls::FP_BYTES);
      bls::fp_one(pt.Z);
      bls::g1_add(acc, acc, pt);
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kAggThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      bls::g1_add(acc, part[threadIdx.x], part[threadIdx.x + s]);
      part[threadIdx.x] = acc;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    bls::Fp ax, ay;
    const bool is_inf = bls::g1_normalize(ax, ay, part[0]);
    bls::fp_to_bytes(out + (size_t)b * 2 * bls::FP_BYTES, ax);
    bls::fp_to_bytes(out + (size_t)b * 2 * bls::FP_BYTES + bls::FP_BYTES, ay);
    inf[b] = is_inf ? 1 : 0;
  }
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
  return e;
}

void bls12_lanes(int* pairing, int* map) {
  *pairing = kPairingLanes;
  *map = kMapLanes;
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

cudaError_t launch_bls12_g1_aggregate(const uint8_t* points, const uint8_t* mask, int b, int v, uint8_t* out,
                                      uint8_t* inf, cudaStream_t stream) {
  bls12_g1_aggregate<<<b, kAggThreads, 0, stream>>>(points, mask, v, out, inf);
  return cudaGetLastError();
}

}  // namespace tmk
