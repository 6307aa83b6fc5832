// The three kernels of batched ed25519 verification (Go x/crypto's
// cofactorless acceptance).
//
//   ed25519_prepare  replaces ops/ed25519.py verify_stage_prepare
//   ed25519_scan     replaces ops/ed25519.py verify_stage_scan
//   ed25519_finish   replaces ops/ed25519.py verify_stage_finish and
//                    verify_stage_finish_tally
//
// (paths in the JAX package, tendermint_tpu/). The intermediates between
// them (signed digits, -A, the result point) stay on the card.
//
// What bounds them: 32-bit integer multiply-adds. A field multiplication
// is 100 IMAD.WIDE and a squaring 55 (fe25519.cuh); the scan does about
// 2,900 products a row, 1,024 of them squarings (256 doublings, 128 cached
// additions, the [1..8](-A) table), prepare about 270, nearly all
// squarings in one exponentiation (the square root in decompression), and
// finish one inversion. Every row's work is the same but the inversion's.
// Bytes are small: about 550 B a row in and out of prepare, under 450 B
// for the others.
//
// What the design does about it. Radix 2^25.5, so that every product is
// one IMAD.WIDE, and a dedicated squaring. The scan: a row on G lanes of a
// warp (ge25519_lanes.cuh), each group formula cut into stages of four
// independent products, one a lane, the row's point, its [1..8](-A) table
// (1,280 B) and its digits in shared memory; so a 10,000-row batch keeps
// some 9 warps on each SM instead of 2.4, and a doubling is two product
// latencies deep instead of eight; G is compiled in (kScanLanes, the
// fastest of 2, 4 and 8 at 9,510 and 28,500 rows:
// scripts/ed25519_lane_sweep.py, PERF.md). prepare: one thread a row for
// the decompression, whose square root is one chain of products, and the
// hash on a warp of its own a block. finish: one thread a row, the
// inversion by a binary GCD (fe_inv_gcd, Bernstein-Yang divsteps on
// 32-bit words) instead of Fermat's 265 products. The constant [1..8]B
// table and the curve constants sit in __constant__ memory, uploaded from
// the host's pure-Python oracle; the scan copies the table into each
// block's shared memory, where the rows' different entries do not
// serialise.
#include <stdint.h>
#include <cuda_runtime.h>

#include "fe25519.cuh"
#include "ge25519.cuh"
#include "ge25519_lanes.cuh"
#include "sc25519.cuh"
#include "sha512.cuh"

namespace tmk {

__constant__ TmConstants c_k;

constexpr int kBlock = 64;
constexpr int kWarp = 32;
constexpr int kScanLanes = 4;  // G of ed25519_scan

// A row of G lanes: 32 / G rows a block of one warp.
__host__ __device__ constexpr int scan_rows_per_block(int g) { return kWarp / g; }

// Replaces verify_stage_prepare (ops/ed25519.py:56): sha512 (ops/sha512.py:176),
// sc.reduce512 / sc.is_canonical (ops/sc.py:147, :165), curve.decompress
// (ops/curve.py:156), curve.negate, nibble_digits / signed_digits (:391-416).
// Bound: 275 field multiplications a row (262 of them the square root's
// exponentiation), 100 IMAD.WIDE each; SHA-512's two blocks are 64-bit
// adds and rotates. Inputs 256 B and outputs 290 B a row.
// pk (N,32) u8, msg (N,mlen) u8, sig (N,64) u8 ->
// sd, kd (N,64) i8, neg_a (N,4,10) i32, a_ok, s_ok (N,) u8
//
// A block of 64 rows: 64 threads decompress, a row each, and a warp of its
// own does the scalar work (s < L, the digits of s, SHA-512 of the
// preimage, its reduction and digits), a lane two rows, so that the hash
// runs while the other warps decompress.
constexpr int kPrepareThreads = kBlock + kWarp;

// s < L, the digits of s, k = SHA-512(R || A || M) mod L and its digits.
static __device__ void prepare_scalars(int row, const uint8_t* p, const uint8_t* m, const uint8_t* s, int mlen,
                                       int8_t* sd, int8_t* kd, uint8_t* s_ok) {
  uint64_t sw[4], st[8], k[4];
  uint32_t digits[16];
  sc_load_bytes(sw, s + 32);
  s_ok[row] = sc_is_canonical(sw);
  signed_digits(digits, sw);
  store_digits(sd + 64 * (size_t)row, digits, 16);
  tm_sha512_preimage(st, s, p, m, mlen);
  sc_reduce_words(k, st);
  signed_digits(digits, k);
  store_digits(kd + 64 * (size_t)row, digits, 16);
}

__global__ void __launch_bounds__(kPrepareThreads) ed25519_prepare(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ msg, const uint8_t* __restrict__ sig,
    int n, int mlen, int8_t* __restrict__ sd, int8_t* __restrict__ kd, int32_t* __restrict__ neg_a,
    uint8_t* __restrict__ a_ok, uint8_t* __restrict__ s_ok) {
  const int base = blockIdx.x * kBlock;
  if ((int)threadIdx.x >= kBlock) {  // the hash warp
#pragma unroll 1
    for (int row = base + (int)threadIdx.x - kBlock; row < base + kBlock && row < n; row += kWarp)
      prepare_scalars(row, pk + 32 * (size_t)row, msg + (size_t)mlen * row, sig + 64 * (size_t)row, mlen, sd, kd,
                      s_ok);
    return;
  }
  const int row = base + (int)threadIdx.x;
  if (row >= n) return;
  ge_p3 A;
  a_ok[row] = ge_decompress(A, pk + 32 * (size_t)row, c_k);
  fe_neg(A.X, A.X);
  fe_neg(A.T, A.T);
  int32_t* dst = neg_a + 40 * (size_t)row;
  store_fe(dst, A.X);
  store_fe(dst + 10, A.Y);
  store_fe(dst + 20, A.Z);
  store_fe(dst + 30, A.T);
}

// Replaces verify_stage_scan (ops/ed25519.py:79) ->
// curve.double_scalar_mul_signed (ops/curve.py:605-641).
// Bound: 2,887 field products a row, 1,024 of them squarings -- 71 for the
// [1..8](-A) table (7 additions at 9, 8 conversions at 1), then 64 windows
// of four shared doublings (4 squarings and 3 products, 4 on the last) and
// two cached additions (8, and 7 without T) -- about 232,000 IMAD.WIDE a
// row. Bytes (288 B in, 160 B out a row) are negligible beside that.
// sd, kd (N,64) i8, neg_a (N,4,10) i32 -> [s]B + [k](-A) as (N,4,10) i32.
// Rows of G lanes (scan_row, ge25519_lanes.cuh), each with its ScanRow in
// dynamic shared memory; the block's copy of [1..8]B in static.
template <int G>
__global__ void __launch_bounds__(kWarp) ed25519_scan(
    const int8_t* __restrict__ sd, const int8_t* __restrict__ kd, const int32_t* __restrict__ neg_a,
    int n, int32_t* __restrict__ out) {
  static_assert(G == 2 || G == 4 || G == 8, "a row is 2, 4 or 8 lanes of a warp");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ fe base[8][4];
  for (int k = threadIdx.x; k < 8 * 4 * 10; k += blockDim.x) (&base[0][0].v[0])[k] = (&c_k.base[0][0][0])[k];
  __syncthreads();
  const int group = (int)threadIdx.x / G;
  const int row = blockIdx.x * scan_rows_per_block(G) + group;
  if (row >= n) return;
  const Lanes L{(int)threadIdx.x % G, G, ((1u << G) - 1) << (group * G)};
  fe d2;
  fe_load_const(d2, c_k.d2);
  scan_row(L, reinterpret_cast<ScanRow*>(smem)[group], sd + 64 * (size_t)row, kd + 64 * (size_t)row,
           neg_a + 40 * (size_t)row, out + 40 * (size_t)row, base, d2);
}

// Replaces verify_stage_finish (ops/ed25519.py:85) and
// verify_stage_finish_tally (:92) with curve.encode (ops/curve.py:133).
// Bound: one inversion and two field multiplications a row; the tally is
// one block reduction and one 64-bit atomicAdd per block instead of the
// JAX package's four 16-bit chunk sums. One thread a row; the inversion
// (in ge_encode) by a binary GCD, at most 25 batches of 30 divsteps, short
// integer work, instead of Fermat's chain of 265 products.
// pt (N,4,10) i32, sig (N,64) u8, a_ok, s_ok (N,) u8 -> ok (N,) u8; with
// power != nullptr also *tally += sum of power where ok & counted.
__global__ void __launch_bounds__(kBlock) ed25519_finish(
    const int32_t* __restrict__ pt, const uint8_t* __restrict__ sig, const uint8_t* __restrict__ a_ok,
    const uint8_t* __restrict__ s_ok, const int64_t* __restrict__ power,
    const uint8_t* __restrict__ counted, int n, uint8_t* __restrict__ ok_out,
    unsigned long long* __restrict__ tally) {
  __shared__ unsigned long long part[kBlock];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long mine = 0;
  if (row < n) {
    ge_p3 p;
    const int32_t* src = pt + 40 * (size_t)row;
    load_fe(p.X, src);
    load_fe(p.Y, src + 10);
    load_fe(p.Z, src + 20);
    fe_set_small(p.T, 0);
    uint8_t enc[32];
    ge_encode(enc, p);
    const uint8_t* r = sig + 64 * (size_t)row;
    bool match = true;
#pragma unroll
    for (int i = 0; i < 32; i++) match &= enc[i] == r[i];
    const bool ok = match && a_ok[row] && s_ok[row];
    ok_out[row] = ok;
    if (power != nullptr && ok && counted[row]) mine = (unsigned long long)power[row];
  }
  if (power == nullptr) return;  // uniform across the block
  part[threadIdx.x] = mine;
  __syncthreads();
#pragma unroll
  for (int stride = kBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) part[threadIdx.x] += part[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0 && part[0] != 0) atomicAdd(tally, part[0]);
}

static inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

cudaError_t set_constants(const void* host, size_t bytes) {
  if (bytes != sizeof(TmConstants)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(c_k, host, bytes);
}

cudaError_t launch_prepare(const uint8_t* pk, const uint8_t* msg, const uint8_t* sig, int n, int mlen,
                           int8_t* sd, int8_t* kd, int32_t* neg_a, uint8_t* a_ok, uint8_t* s_ok,
                           cudaStream_t stream) {
  ed25519_prepare<<<grid_for(n), kPrepareThreads, 0, stream>>>(pk, msg, sig, n, mlen, sd, kd, neg_a, a_ok, s_ok);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_scan_at(const int8_t* sd, const int8_t* kd, const int32_t* neg_a, int n, int32_t* out,
                           cudaStream_t stream) {
  const int rows = scan_rows_per_block(G);
  ed25519_scan<G><<<(n + rows - 1) / rows, kWarp, rows * sizeof(ScanRow), stream>>>(sd, kd, neg_a, n, out);
  return cudaGetLastError();
}

cudaError_t launch_scan(const int8_t* sd, const int8_t* kd, const int32_t* neg_a, int n, int32_t* out,
                        cudaStream_t stream) {
  return launch_scan_at<kScanLanes>(sd, kd, neg_a, n, out, stream);
}

int scan_lanes() { return kScanLanes; }

cudaError_t launch_finish(const int32_t* pt, const uint8_t* sig, const uint8_t* a_ok, const uint8_t* s_ok,
                          const int64_t* power, const uint8_t* counted, int n, uint8_t* ok,
                          unsigned long long* tally, cudaStream_t stream) {
  ed25519_finish<<<grid_for(n), kBlock, 0, stream>>>(pt, sig, a_ok, s_ok, power, counted, n, ok, tally);
  return cudaGetLastError();
}

}  // namespace tmk
