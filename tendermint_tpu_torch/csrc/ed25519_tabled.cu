// The per-valset tabled path of batched ed25519 verification, one thread
// per validator (the build) or per signature row (prepare, scan).
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
// multiplication (fe25519.cuh). The build does about 4,100 a validator
// (decompression 275, sixteen chunks of seven additions and sixteen
// doublings, a Montgomery batch inversion of the 128 entries' Z, 128
// affine conversions); the scan about 790 a row (16 doublings, 64 mixed
// additions from the row's key table, 32 from the constant base comb);
// prepare is SHA-512 and scalar reduction, no field arithmetic. Bytes:
// the build writes 15,360 B a validator, the scan reads 64 table entries
// of 120 B a row (7.7 KB).
//
// What the design does about it: the simple form first, as in
// ed25519_kernels.cu. The table read is uncoalesced -- each thread reads
// its own validator's 120-B entries, 15 KB away from its neighbours' --
// and is the first thing for a later version to redesign. An index only
// changes which table a thread reads: no gathered copy of a table is
// ever made, so the JAX package's dense, gathered and sharded scan
// variants (which exist to keep XLA's gathers bounded) are one kernel.
// The base comb (32 x 128 entries, 491,520 B) is too large for
// __constant__ memory and each thread selects a different entry, which
// would serialise the constant cache: it lives in a __device__ array
// (L2-resident), uploaded once per device from the pure-Python oracle.
#include <stdint.h>
#include <cuda_runtime.h>

#include "fe25519.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"
#include "sha512.cuh"

namespace tmk {

__constant__ TmConstants c_tab;  // this translation unit's copy of the constants

constexpr int kSplits = 16;
constexpr int kSplitW = 4;
constexpr int kEntries = 8;
constexpr int kTableInts = kSplits * kEntries * 30;  // 3,840 int32 a validator
constexpr int kCombPos = 32;
constexpr int kCombEntries = 128;

__device__ int32_t c_comb[kCombPos][kCombEntries][3][10];

constexpr int kTabBlock = 64;

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
// garbage point gives the same values. Their Z are inverted with one
// Montgomery batch inversion over the validator's 128 entries: a Z that
// is 0 is taken as 1 in both sweeps (it cannot poison the others) and
// its inverse comes out 0, as in invert_blocked.
// Bound: about 4,100 field multiplications a validator; 15,392 B moved.
// pk (V,32) u8 -> tables (V,16,8,3,10) i32, a_ok (V,) u8; scratch
// (V,128,10) i32 holds the inversion's prefix products.
__global__ void __launch_bounds__(kTabBlock) ed25519_build_tables(
    const uint8_t* __restrict__ pk, int v, int32_t* __restrict__ tables, uint8_t* __restrict__ a_ok,
    int32_t* __restrict__ scratch) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= v) return;
  fe d2;
  fe_load_const(d2, c_tab.d2);
  ge_p3 qm;
  a_ok[row] = ge_decompress(qm, pk + 32 * (size_t)row, c_tab);
  fe_neg(qm.X, qm.X);
  fe_neg(qm.T, qm.T);

  int32_t* out = tables + (size_t)row * kTableInts;
  int32_t* pre = scratch + (size_t)row * kSplits * kEntries * 10;
  // projective X, Y, Z of every entry, in the entry's own slot
#pragma unroll 1
  for (int m = 0; m < kSplits; m++) {
    ge_p3 acc = qm;
#pragma unroll 1
    for (int i = 0; i < kEntries; i++) {
      int32_t* e = out + (m * kEntries + i) * 30;
      store_fe(e, acc.X);
      store_fe(e + 10, acc.Y);
      store_fe(e + 20, acc.Z);
      if (i < kEntries - 1) ge_add(acc, acc, qm, d2);
    }
    if (m < kSplits - 1) {
#pragma unroll 1
      for (int j = 0; j < 4 * kSplitW; j++) ge_double(qm, qm, j == 4 * kSplitW - 1);
    }
  }

  // forward sweep: pre[e] = product of the (nonzero) Z before entry e
  fe run, z;
  fe_set_small(run, 1);
#pragma unroll 1
  for (int e = 0; e < kSplits * kEntries; e++) {
    load_fe(z, out + e * 30 + 20);
    store_fe(pre + e * 10, run);
    if (!fe_iszero(z)) fe_mul(run, run, z);
  }
  fe inv;
  fe_invert(inv, run);
  // backward sweep: inv is 1 / (product of the Z up to entry e)
#pragma unroll 1
  for (int e = kSplits * kEntries - 1; e >= 0; e--) {
    int32_t* slot = out + e * 30;
    load_fe(z, slot + 20);
    const bool zero = fe_iszero(z);
    fe zi, p;
    load_fe(p, pre + e * 10);
    fe_mul(zi, inv, p);
    if (zero) fe_set_small(zi, 0); else fe_mul(inv, inv, z);
    fe X, Y, x, y, t;
    load_fe(X, slot);
    load_fe(Y, slot + 10);
    fe_mul(x, X, zi);
    fe_mul(y, Y, zi);
    fe_add(X, y, x);
    fe_sub(Y, y, x);
    fe_mul(t, x, y);
    fe_mul(t, t, d2);
    store_fe(slot, X);
    store_fe(slot + 10, Y);
    store_fe(slot + 20, t);
  }
}

// Replaces verify_stage_prepare_tabled (ops/ed25519.py:123), its
// _gathered variant (:141) and materialize_sign_bytes (:170).
// The key is read by index from the valset's key matrix and each
// message byte from where it lives -- the row of a message matrix, or
// the row's template with its 8 timestamp bytes at ts_off -- so neither
// a gathered key matrix nor a sign-bytes matrix is ever built.
// Bound: two SHA-512 blocks and one scalar reduction a row (64-bit adds
// and rotates, no field arithmetic); about 120 B in and 97 B out a row
// with templates.
// pk_all (V,32) u8, idx (N,) i32 or null (row r is validator r),
// messages: msg (N,mlen) u8, or tpl (T,mlen) u8 with tmpl_idx (N,) i32
// and ts8 (N,8) u8; sig (N,64) u8 -> sd8 (N,32) i8 signed base-256
// digits of s, kd (N,64) i8 signed nibbles of k, s_ok (N,) u8.
// A row whose idx or tmpl_idx is out of range reads nothing and is
// rejected (s_ok 0, digits 0); the host checks its indices first.
__global__ void __launch_bounds__(kTabBlock) ed25519_prepare_tabled(
    const uint8_t* __restrict__ pk_all, const int32_t* __restrict__ idx, int v,
    const uint8_t* __restrict__ msg, int mlen, const uint8_t* __restrict__ tpl, int ntpl,
    const int32_t* __restrict__ tmpl_idx, const uint8_t* __restrict__ ts8, int ts_off,
    const uint8_t* __restrict__ sig, int n, int8_t* __restrict__ sd8, int8_t* __restrict__ kd,
    uint8_t* __restrict__ s_ok) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int vi = idx != nullptr ? idx[row] : row;
  const int ti = tpl != nullptr ? tmpl_idx[row] : 0;
  if (vi < 0 || vi >= v || (tpl != nullptr && (ti < 0 || ti >= ntpl))) {
    s_ok[row] = 0;
    for (int i = 0; i < 32; i++) sd8[32 * (size_t)row + i] = 0;
    for (int i = 0; i < 64; i++) kd[64 * (size_t)row + i] = 0;
    return;
  }
  const uint8_t* p = pk_all + 32 * (size_t)vi;
  const uint8_t* s = sig + 64 * (size_t)row;

  uint8_t sb[32];
#pragma unroll
  for (int i = 0; i < 32; i++) sb[i] = s[32 + i];
  s_ok[row] = sc_is_canonical(sb);
  signed_digits256(sd8 + 32 * (size_t)row, sb);

  uint8_t h[64], k[32];
  if (tpl != nullptr) {
    const TplMsg m{tpl + (size_t)mlen * ti, ts8 + 8 * (size_t)row, ts_off};
    tm_sha512_preimage(h, s, p, m, mlen, c_tab.sha512_k);
  } else {
    tm_sha512_preimage(h, s, p, MatMsg{msg + (size_t)mlen * row}, mlen, c_tab.sha512_k);
  }
  sc_reduce(k, h);
  signed_digits(kd + 64 * (size_t)row, k);
}

// Replaces verify_stage_scan_tabled (ops/ed25519.py:195), _sharded (:204)
// and _dense (:225): curve.double_scalar_mul_tabled (ops/curve.py:551)
// with madd (:225), _select_affine (:471) and _select_comb256 (:359).
// Four windows, most significant first, of four doublings (T only on
// the last) and sixteen mixed additions from the row's key table (digit
// 4m + w selects split m), then 32 mixed additions from the base comb,
// the last without T (the point's reader, encode, never reads it).
// Bound: about 790 field multiplications a row; 7.8 KB of tables read.
// sd8 (N,32) i8, kd (N,64) i8, tables (V,16,8,3,10) i32, a_tab (V,) u8,
// idx (N,) i32 or null -> [s]B + [k](-A) as (N,4,10) i32 (T zero),
// a_ok (N,) u8 = a_tab[idx]. A row whose idx is out of range reads
// nothing and is rejected (a_ok 0).
__global__ void __launch_bounds__(kTabBlock) ed25519_scan_tabled(
    const int8_t* __restrict__ sd8, const int8_t* __restrict__ kd, const int32_t* __restrict__ tables,
    const uint8_t* __restrict__ a_tab, const int32_t* __restrict__ idx, int v, int n,
    int32_t* __restrict__ out, uint8_t* __restrict__ a_ok) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int vi = idx != nullptr ? idx[row] : row;
  int32_t* dst = out + 40 * (size_t)row;
  if (vi < 0 || vi >= v) {
    a_ok[row] = 0;
    for (int i = 0; i < 40; i++) dst[i] = 0;
    return;
  }
  const int32_t* tab = tables + (size_t)vi * kTableInts;
  const int8_t* k = kd + 64 * (size_t)row;
  const int8_t* s = sd8 + 32 * (size_t)row;

  ge_p3 acc;
  ge_identity(acc);
  ge_precomp c;
#pragma unroll 1
  for (int w = kSplitW - 1; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
#pragma unroll 1
    for (int m = 0; m < kSplits; m++) {
      const int dig = k[kSplitW * m + w];
      const int mag = dig < 0 ? -dig : dig;
      if (mag != 0) load_precomp(c, tab + (m * kEntries + mag - 1) * 30);
      ge_precomp_fix(c, dig);
      ge_madd(acc, acc, c, true);
    }
  }
#pragma unroll 1
  for (int p = 0; p < kCombPos; p++) {
    const int dig = s[p];
    const int mag = dig < 0 ? -dig : dig;
    if (mag != 0) load_precomp(c, &c_comb[p][mag - 1][0][0]);
    ge_precomp_fix(c, dig);
    ge_madd(acc, acc, c, p < kCombPos - 1);
  }
  store_fe(dst, acc.X);
  store_fe(dst + 10, acc.Y);
  store_fe(dst + 20, acc.Z);
  store_fe(dst + 30, acc.T);
  a_ok[row] = a_tab[vi];
}

static inline int grid_tab(int n) { return (n + kTabBlock - 1) / kTabBlock; }

cudaError_t set_constants_tabled(const void* host, size_t bytes) {
  if (bytes != sizeof(TmConstants)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(c_tab, host, bytes);
}

cudaError_t set_comb(const void* host, size_t bytes) {
  if (bytes != sizeof(c_comb)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(c_comb, host, bytes);
}

cudaError_t launch_build_tables(const uint8_t* pk, int v, int32_t* tables, uint8_t* a_ok, int32_t* scratch,
                                cudaStream_t stream) {
  ed25519_build_tables<<<grid_tab(v), kTabBlock, 0, stream>>>(pk, v, tables, a_ok, scratch);
  return cudaGetLastError();
}

cudaError_t launch_prepare_tabled(const uint8_t* pk_all, const int32_t* idx, int v, const uint8_t* msg, int mlen,
                                  const uint8_t* tpl, int ntpl, const int32_t* tmpl_idx, const uint8_t* ts8,
                                  int ts_off, const uint8_t* sig, int n, int8_t* sd8, int8_t* kd, uint8_t* s_ok,
                                  cudaStream_t stream) {
  ed25519_prepare_tabled<<<grid_tab(n), kTabBlock, 0, stream>>>(pk_all, idx, v, msg, mlen, tpl, ntpl, tmpl_idx,
                                                                ts8, ts_off, sig, n, sd8, kd, s_ok);
  return cudaGetLastError();
}

cudaError_t launch_scan_tabled(const int8_t* sd8, const int8_t* kd, const int32_t* tables, const uint8_t* a_tab,
                               const int32_t* idx, int v, int n, int32_t* out, uint8_t* a_ok,
                               cudaStream_t stream) {
  ed25519_scan_tabled<<<grid_tab(n), kTabBlock, 0, stream>>>(sd8, kd, tables, a_tab, idx, v, n, out, a_ok);
  return cudaGetLastError();
}

}  // namespace tmk
