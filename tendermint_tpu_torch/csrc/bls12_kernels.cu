// The three BLS12-381 kernels, one row per thread (fp381.cuh,
// bls12_curve.cuh hold the arithmetic):
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
// What bounds them: operations. A pairing check is 58,733 Fp
// multiplications a row (two Miller loops and one final exponentiation;
// counted on the plain version, which runs the same formulas), a map
// 38,851 (two SvdW maps with their Fermat powers, then 507 doublings and
// 247 additions for [H2]), an aggregate of V points about 12 V plus the
// normalising inversion. One multiplication is 300 32-bit multiply-adds
// (CIOS, 12 limbs). With one thread a row and 128 rows a call, the card
// runs 128 threads: latency-bound, some 800x above the bound of the
// operations. What the design does about it: blocks of 32 threads, so
// that 128 rows spread over four SMs; the tower's wider functions are not
// inlined (__noinline__), which keeps compile time and registers bounded
// at the cost of stack traffic. Spreading a row over a warp, lazy
// reduction and cyclotomic squaring are later work.
#include <stdint.h>
#include <cuda_runtime.h>

#include "bls12_curve.cuh"

namespace tmk {

constexpr int kBlsRowBlock = 32;
constexpr int kAggThreads = 128;
constexpr int kFp12Bytes = 12 * bls::FP_BYTES;

static inline int bls_grid(int n) { return (n + kBlsRowBlock - 1) / kBlsRowBlock; }

// pk (N, 2, 48), hm and sig (N, 2, 2, 48) -> value (N, 2, 3, 2, 48),
// ok (N,). pairs = 1 reads no sig and returns e(pk, hm) alone.
__global__ void __launch_bounds__(kBlsRowBlock) bls12_pairing_check(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ hm, const uint8_t* __restrict__ sig, int n,
    int pairs, uint8_t* __restrict__ value, uint8_t* __restrict__ ok) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* s = pairs == 2 ? sig + (size_t)row * 4 * bls::FP_BYTES : nullptr;
  ok[row] = bls::pairing_row(value + (size_t)row * kFp12Bytes, pk + (size_t)row * 2 * bls::FP_BYTES,
                             hm + (size_t)row * 4 * bls::FP_BYTES, s, pairs)
                ? 1
                : 0;
}

// u0, u1 (N, 2, 48) -> q (N, 2, 2, 48) affine x, y, inf (N,).
__global__ void __launch_bounds__(kBlsRowBlock) bls12_map_to_g2(
    const uint8_t* __restrict__ u0, const uint8_t* __restrict__ u1, int n, uint8_t* __restrict__ q,
    uint8_t* __restrict__ inf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const size_t off = (size_t)row * 2 * bls::FP_BYTES;
  uint8_t* out = q + (size_t)row * 4 * bls::FP_BYTES;
  inf[row] = bls::map_to_g2_row(out, out + 2 * bls::FP_BYTES, u0 + off, u1 + off) ? 1 : 0;
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

cudaError_t set_bls_constants(const void* host, size_t bytes) {
  if (bytes != sizeof(bls::Constants)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(bls::c_bls, host, bytes);
}

cudaError_t launch_bls12_pairing_check(const uint8_t* pk, const uint8_t* hm, const uint8_t* sig, int n, int pairs,
                                       uint8_t* value, uint8_t* ok, cudaStream_t stream) {
  bls12_pairing_check<<<bls_grid(n), kBlsRowBlock, 0, stream>>>(pk, hm, sig, n, pairs, value, ok);
  return cudaGetLastError();
}

cudaError_t launch_bls12_map_to_g2(const uint8_t* u0, const uint8_t* u1, int n, uint8_t* q, uint8_t* inf,
                                   cudaStream_t stream) {
  bls12_map_to_g2<<<bls_grid(n), kBlsRowBlock, 0, stream>>>(u0, u1, n, q, inf);
  return cudaGetLastError();
}

cudaError_t launch_bls12_g1_aggregate(const uint8_t* points, const uint8_t* mask, int b, int v, uint8_t* out,
                                      uint8_t* inf, cudaStream_t stream) {
  bls12_g1_aggregate<<<b, kAggThreads, 0, stream>>>(points, mask, v, out, inf);
  return cudaGetLastError();
}

}  // namespace tmk
