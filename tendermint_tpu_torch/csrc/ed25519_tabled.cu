// The per-valset tabled path of batched ed25519 verification: G lanes a
// validator (the build) or a signature row (the scan), one thread a row
// (prepare).
//
//   ed25519_build_tables    replaces ops/ed25519.py build_valset_tables
//                           (curve.decompress, curve.build_split_tables,
//                           field.invert_blocked)
//   ed25519_prepare_tabled  replaces verify_stage_prepare_tabled,
//                           verify_stage_prepare_tabled_gathered and
//                           materialize_sign_bytes
//   ed25519_scan_tabled     replaces verify_stage_scan_tabled, _sharded
//                           and _dense (curve.double_scalar_mul_tabled)
//
// (paths in the JAX package, tendermint_tpu/). The last stage is the
// generic path's ed25519_finish (ed25519_kernels.cu): the JAX package's
// verify_stage_finish_blocked computes the same function, its blocked
// batch inversion having been a workaround for XLA's compile time.
//
// Tables: for each validator, -A's affine-cached multiples
// [i * 16^(4m)](-A), i = 1..8, m = 0..15, as (y+x, y-x, 2dxy) in the
// port's limbs: (V, 16, 8, 3, 10) int32, 15,360 B a validator.
//
// What bounds them: 32-bit integer multiply-adds, 100 to a field
// multiplication and 55 to a squaring (fe25519.cuh). The build does 3,631
// products a validator, 1,469 of them squarings (decompression 275,
// sixteen chunks of seven additions and sixteen doublings, a Montgomery
// batch inversion of the 128 entries' Z, 128 affine conversions); the
// scan about 790 a row (16 doublings, 64 mixed additions from the row's
// key table, 32 from the constant base comb); prepare is SHA-512 and
// scalar reduction, no field arithmetic. Bytes: the build
// writes 15,360 B a validator, the scan reads 64 table entries of 120 B a
// row (7.7 KB).
//
// What the design does about it. The build: a validator on G = 4 lanes
// of a warp (ge25519_lanes.cuh), 32 validators a block. The block's
// threads first decompress its 32 keys, one each (one warp's chains, the
// other warps idle); then each validator's lanes run the 240 doublings
// that make q_1..q_15 stage-parallel, four products a stage, and each
// lane adds up its four splits' entries and sweeps them forward
// (Montgomery's trick); one thread a validator then inverts the product
// of its lanes' products; and the lanes sweep back, converting their
// entries to affine-cached form in place. The entries are built in their
// own slots of the output, the kernel's working space: no scratch in
// device memory, and 1.8 KB of shared state a validator, so that all
// 10,000 validators of a set are on the card at once (three blocks an SM
// at 168 registers, which __launch_bounds__ holds). Kept in shared memory
// instead (15,360 B a validator) they fitted 12 validators on an SM, and
// the build ran in six waves and 2.7 times as long (PERF.md). G is
// compiled in (kBuildLanes, the fastest of 2, 4, 8 and 16 at 10,000
// validators: scripts/ed25519_lane_sweep.py).
//
// prepare: one thread a row in blocks of R rows that stage their inputs
// and the templates' words in shared memory (prepare_tabled.cuh): a row
// builds each 64-bit message word from one shared read, never byte by
// byte, and stores its digits 16 bytes at a time. The
// scan: a row on G = 4 lanes of a warp (kScanTabledLanes, the fastest of
// 2, 4 and 8 at 4,737 and 9,510 rows: scripts/ed25519_lane_sweep.py), as
// ed25519_scan does (ed25519_kernels.cu): each doubling and mixed addition is
// two stages of four independent products, so a row's 112 group
// operations are 224 product latencies deep instead of some 800, and 9,510
// rows keep about nine warps on each SM. The row's accumulator, a stage's
// products and its digits (424 B) sit in shared memory; the tables stay
// where the build wrote them: each lane loads the one field (40 B) of the
// entry its product needs, so a row's lanes read the 120-B entry together.
// An index only changes which table a row reads: no gathered copy of a
// table is ever made, so the JAX package's dense, gathered and sharded scan
// variants (which exist to keep XLA's gathers bounded) are one kernel.
// The base comb (32 x 128 entries, 491,520 B) is too large for
// __constant__ memory and each row selects a different entry, which
// would serialise the constant cache: it lives in a __device__ array
// (L2-resident), uploaded once per device from the pure-Python oracle.
#include <stdint.h>
#include <cuda_runtime.h>

#include "fe25519.cuh"
#include "ge25519.cuh"
#include "ge25519_lanes.cuh"
#include "prepare_tabled.cuh"

namespace tmk {

__constant__ TmConstants c_tab;  // this translation unit's copy of the constants

constexpr int kEntries = kBuildEntries;
constexpr int kTableInts = kBuildTableInts;
__device__ int32_t c_comb[kCombPositions][kCombEntries][3][10];

constexpr int kPrepRows = 64;         // rows a block of ed25519_prepare_tabled
constexpr int kScanTabledBlock = 32;  // threads a block of ed25519_scan_tabled: one warp
constexpr int kBuildLanes = 4;        // G of ed25519_build_tables
constexpr int kScanTabledLanes = 4;   // G of ed25519_scan_tabled

// Validators of G lanes a block: 32 in up to 128 threads (fewer for G
// above 4).
__host__ __device__ constexpr int build_rows_per_block(int g) { return g <= 4 ? 32 : 128 / g; }

__device__ __forceinline__ void load_precomp(ge_precomp& c, const int32_t* src) {
  load_fe(c.ypx, src);
  load_fe(c.ymx, src + 10);
  load_fe(c.t2d, src + 20);
}

// Replaces build_valset_tables (ops/ed25519.py:113): curve.decompress
// (ops/curve.py:156), curve.negate, curve.build_split_tables (:505) and
// field.invert_blocked (ops/field.py:273).
// Entries are built as the JAX program builds them -- [1]qm, then
// qm + qm, then each next one as (previous + qm) by the unified addition,
// and q(m+1) as sixteen doublings of qm -- so even an undecodable key's
// garbage point gives the same values. Their Z are inverted by Montgomery's
// trick, each lane over its share of the 128 entries: a Z that is 0 is
// taken as 1 in the products (it cannot poison the others) and its
// inverse comes out 0, as in invert_blocked.
// Bound: 3,631 field products a validator, 1,469 of them squarings (the
// kernel runs 128 more, to scale X and Y in the forward sweep); 15,393 B
// moved.
// pk (V,32) u8 -> tables (V,16,8,3,10) i32, a_ok (V,) u8. Validators of G
// lanes, each with its BuildRow in dynamic shared memory; the steps run a
// thread a validator and those on its lanes are separated by the block's
// barrier.
// Validator r's entries: its region of the tables.
__device__ __forceinline__ fe (*entries_of(int32_t* tables, int r))[3] {
  return reinterpret_cast<fe(*)[3]>(tables + (size_t)r * kTableInts);
}

template <int G>
__global__ void __launch_bounds__(128, 3) ed25519_build_tables(const uint8_t* __restrict__ pk, int v,
                                                            int32_t* __restrict__ tables,
                                                            uint8_t* __restrict__ a_ok) {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16, "a validator is 2, 4, 8 or 16 lanes of a warp");
  constexpr int kRows = build_rows_per_block(G);
  extern __shared__ __align__(16) uint8_t smem[];
  BuildRow<G>* R = reinterpret_cast<BuildRow<G>*>(smem);
  // Each step works out its own indices, so that nothing but the
  // parameters lives across a barrier: the one-thread steps use all of
  // the registers that __launch_bounds__ leaves them.
  {  // a thread a validator: decompression
    const int r = blockIdx.x * kRows + (int)threadIdx.x;
    if ((int)threadIdx.x < kRows && r < v)
      build_start(R[threadIdx.x], entries_of(tables, r), pk + 32 * (size_t)r, c_tab, a_ok + r);
  }
  __syncthreads();
  {  // G lanes a validator: the entries and the forward sweeps
    const int group = (int)threadIdx.x / G;
    const int r = blockIdx.x * kRows + group;
    if (r < v) {
      const Lanes L{(int)threadIdx.x % G, G, ((1u << G) - 1) << ((int)threadIdx.x % 32 / G * G)};
      fe d2;
      fe_load_const(d2, c_tab.d2);
      build_entries(L, R[group], entries_of(tables, r), d2);
    }
  }
  __syncthreads();
  {  // a thread a validator: the inversion
    const int r = blockIdx.x * kRows + (int)threadIdx.x;
    if ((int)threadIdx.x < kRows && r < v) build_invert(R[threadIdx.x]);
  }
  __syncthreads();
  {  // G lanes a validator: the backward sweeps
    const int group = (int)threadIdx.x / G;
    const int r = blockIdx.x * kRows + group;
    if (r < v) {
      const Lanes L{(int)threadIdx.x % G, G, ((1u << G) - 1) << ((int)threadIdx.x % 32 / G * G)};
      fe d2;
      fe_load_const(d2, c_tab.d2);
      build_finish(L, R[group], entries_of(tables, r), d2);
    }
  }
}

// Replaces verify_stage_prepare_tabled (ops/ed25519.py:123), its
// _gathered variant (:141) and materialize_sign_bytes (:170).
// The key is read by index from the valset's key matrix and the message
// from where it lives -- the rows of a message matrix, or the row's
// template with its 8 timestamp bytes spliced in at ts_off -- so neither a
// gathered key matrix nor a sign-bytes matrix is ever built.
// Bound: a row's SHA-512 blocks (two for 160-byte sign-bytes), its scalar
// reduction, s < L and the two digit recodings (64-bit adds, rotates and
// shifts, no field arithmetic); about 110 B in and 97 B out a row with
// templates. A row is one thread's chain of some 12,000 32-bit integer
// instructions, and a warp issues one of those every second cycle at
// best (16 INT32 lanes a scheduler), while a commit's 9,510 rows fill
// fewer warps than the card has schedulers: the chain, about 12 us at
// 1.98 GHz, not the card's rate, is the floor.
// A block of R rows, one thread a row, in the steps of prepare_tabled.cuh:
// the rows' inputs staged in shared memory with coalesced 16-byte loads,
// the templates' words staged once a block and compression block, each
// message word one shared read and a byte permute, the 80 rounds unrolled
// with immediate constants, the digest reduced from its state words and
// the digits stored packed, 16 bytes at a time. A row whose idx or
// tmpl_idx is out of range reads nothing and is rejected (s_ok 0, digits
// 0); the host checks its indices first. R is compiled in (kPrepRows: 32,
// 64 and 128 came within 3 % of each other at 4,737 and 9,510 rows, 64
// the fastest at 9,510: scripts/prepare_tree_sweep.py).
template <int R>
__global__ void __launch_bounds__(R) ed25519_prepare_tabled(const PrepArgs a) {
  __shared__ PrepStage<R> S;
  const int base = blockIdx.x * R, r = (int)threadIdx.x;
  prep_stage_rows<R>(S, a, base, r);
  uint64_t st[8];
  sha512_init(st);
  const int blocks = sha512_preimage_blocks(a.mlen);
  const int passes = a.tpl != nullptr ? (a.ntpl + R - 1) / R : 1;
#pragma unroll 1
  for (int cb = 0; cb < blocks; cb++) {
#pragma unroll 1
    for (int p = 0; p < passes; p++) {
      __syncthreads();  // the staged rows are in, and the last pass's words read
      prep_stage_msg<R>(S, a, base, cb, p * R, r);
      __syncthreads();
      prep_row_block<R>(S, a, cb, p * R, r, st);
    }
  }
  prep_row_finish<R>(S, a, base, r, st);
}

// Replaces verify_stage_scan_tabled (ops/ed25519.py:195), _sharded (:204)
// and _dense (:225): curve.double_scalar_mul_tabled (ops/curve.py:551)
// with madd (:225), _select_affine (:471) and _select_comb256 (:359).
// Bound: about 790 field multiplications a row; 7.8 KB of tables read.
// sd8 (N,32) i8, kd (N,64) i8, tables (V,16,8,3,10) i32, a_tab (V,) u8,
// idx (N,) i32 or null -> [s]B + [k](-A) as (N,4,10) i32 (T zero),
// a_ok (N,) u8 = a_tab[idx]. Rows of G lanes (scan_tabled_row,
// ge25519_lanes.cuh), each with its TabRow in dynamic shared memory; a
// row whose idx is out of range reads nothing and writes zeros and a_ok 0
// from all its lanes.
template <int G>
__global__ void __launch_bounds__(kScanTabledBlock) ed25519_scan_tabled(
    const int8_t* __restrict__ sd8, const int8_t* __restrict__ kd, const int32_t* __restrict__ tables,
    const uint8_t* __restrict__ a_tab, const int32_t* __restrict__ idx, int v, int n,
    int32_t* __restrict__ out, uint8_t* __restrict__ a_ok) {
  static_assert(G == 2 || G == 4 || G == 8, "a row is 2, 4 or 8 lanes of a warp");
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = (int)threadIdx.x / G;
  const int row = blockIdx.x * (kScanTabledBlock / G) + group;
  if (row >= n) return;
  const Lanes L{(int)threadIdx.x % G, G, ((1u << G) - 1) << (group * G)};
  const int vi = idx != nullptr ? idx[row] : row;
  const bool in = vi >= 0 && vi < v;
  scan_tabled_row(L, reinterpret_cast<TabRow*>(smem)[group], sd8 + 32 * (size_t)row, kd + 64 * (size_t)row,
                  in ? tables + (size_t)vi * kTableInts : nullptr, &c_comb[0][0][0][0], out + 40 * (size_t)row);
  if (L.lane == 0) a_ok[row] = in ? a_tab[vi] : 0;
}

cudaError_t set_comb(const void* host, size_t bytes) {
  if (bytes != sizeof(c_comb)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(c_comb, host, bytes);
}

template <int G>
cudaError_t allow_build_smem() {
  return cudaFuncSetAttribute(ed25519_build_tables<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(build_rows_per_block(G) * sizeof(BuildRow<G>)));
}

template <int G>
cudaError_t launch_build_tables_at(const uint8_t* pk, int v, int32_t* tables, uint8_t* a_ok, cudaStream_t stream) {
  const int rows = build_rows_per_block(G);
  ed25519_build_tables<G><<<(v + rows - 1) / rows, rows * G, rows * sizeof(BuildRow<G>), stream>>>(pk, v, tables,
                                                                                                  a_ok);
  return cudaGetLastError();
}

cudaError_t launch_build_tables(const uint8_t* pk, int v, int32_t* tables, uint8_t* a_ok, cudaStream_t stream) {
  return launch_build_tables_at<kBuildLanes>(pk, v, tables, a_ok, stream);
}

int build_lanes() { return kBuildLanes; }

// The constants, and the build's shared-memory opt-in, on the current
// device.
cudaError_t set_constants_tabled(const void* host, size_t bytes) {
  if (bytes != sizeof(TmConstants)) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbol(c_tab, host, bytes);
  if (e == cudaSuccess) e = allow_build_smem<kBuildLanes>();
  return e;
}

template <int R>
cudaError_t launch_prepare_tabled_at(const PrepArgs& a, cudaStream_t stream) {
  if (a.tpl != nullptr && (a.ts_off < 0 || a.ts_off + 8 > a.mlen)) return cudaErrorInvalidValue;
  ed25519_prepare_tabled<R><<<(a.n + R - 1) / R, R, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_prepare_tabled(const uint8_t* pk_all, const int32_t* idx, int v, const uint8_t* msg, int mlen,
                                  const uint8_t* tpl, int ntpl, const int32_t* tmpl_idx, const uint8_t* ts8,
                                  int ts_off, const uint8_t* sig, int n, int8_t* sd8, int8_t* kd, uint8_t* s_ok,
                                  cudaStream_t stream) {
  const PrepArgs a{pk_all, idx, v, msg, mlen, tpl, ntpl, tmpl_idx, ts8, ts_off, sig, n, sd8, kd, s_ok};
  return launch_prepare_tabled_at<kPrepRows>(a, stream);
}

template <int G>
cudaError_t launch_scan_tabled_at(const int8_t* sd8, const int8_t* kd, const int32_t* tables, const uint8_t* a_tab,
                                  const int32_t* idx, int v, int n, int32_t* out, uint8_t* a_ok, cudaStream_t stream) {
  constexpr int rows = kScanTabledBlock / G;
  ed25519_scan_tabled<G><<<(n + rows - 1) / rows, kScanTabledBlock, rows * sizeof(TabRow), stream>>>(
      sd8, kd, tables, a_tab, idx, v, n, out, a_ok);
  return cudaGetLastError();
}

cudaError_t launch_scan_tabled(const int8_t* sd8, const int8_t* kd, const int32_t* tables, const uint8_t* a_tab,
                               const int32_t* idx, int v, int n, int32_t* out, uint8_t* a_ok,
                               cudaStream_t stream) {
  return launch_scan_tabled_at<kScanTabledLanes>(sd8, kd, tables, a_tab, idx, v, n, out, a_ok, stream);
}

int scan_tabled_lanes() { return kScanTabledLanes; }

}  // namespace tmk
