// The steps of ed25519_prepare_tabled (ed25519_tabled.cu): a block of R
// rows, one thread a row, between the block's barriers.
//
//   1. prep_stage_rows   the rows' signatures, keys (gathered by index)
//                        and timestamps into shared memory, 16-byte loads
//                        (8-byte for the timestamps), neighbouring threads
//                        on neighbouring addresses; each row's slot.
//   2. prep_stage_msg    the message part of one compression block for up
//                        to R slots: the templates (the template form; all
//                        the rows of a commit share one to three), or the
//                        block's own message rows (the matrix form), with
//                        the 0x80 and the bit length folded in.
//   3. prep_row_block    a row's 16 message words, each from one 16-byte
//                        shared read of two words and a byte permute; in
//                        the template form the row's timestamp is spliced
//                        into the at most two words it overlaps with
//                        shifts at the byte offset ts_off; one compression.
//   4. prep_row_finish   s < L and the digits of s from the staged
//                        signature's words, k = digest mod L from the
//                        digest's state words, packed digits out as
//                        16-byte stores.
//
// Steps 2 and 3 run once a compression block, and once more for every R
// templates past the first R (a row compresses in the pass that staged
// its template). No step builds a word from single bytes, but the
// staging of a 16-byte piece that is not inside the message (the 0x80,
// the length) or whose source is not 16-byte aligned.
//
// Without nvcc (csrc/ed25519_host.cc, g++) the steps compile as host C++:
// the host runs a block's threads in turn over each step, and the blocks
// in turn, which computes what the card computes since no step reads what
// another thread writes in the same step.
#pragma once
#include <stdint.h>
#include <string.h>

#include "sc25519.cuh"
#include "sha512.cuh"

#if defined(__CUDACC__)
typedef uint4 tm_u128;
#else
struct alignas(16) tm_u128 {
  uint32_t x, y, z, w;
};
#endif

// 16 bytes at p, 16-byte aligned in global memory (read-only).
TM_FN tm_u128 tm_ldg16(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(reinterpret_cast<const uint4*>(p));
#else
  tm_u128 v;
  memcpy(&v, p, 16);
  return v;
#endif
}

// 16 bytes at p, 16-byte aligned in shared memory.
TM_FN tm_u128 tm_lds16(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return *reinterpret_cast<const uint4*>(p);
#else
  return tm_u128{p[0], p[1], p[2], p[3]};
#endif
}

TM_FN void tm_sts16(uint32_t* p, tm_u128 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}

// A call's arguments: pk_all (V,32) u8 read through idx (N,) i32 (null:
// row r is validator r); the messages as msg (N,mlen) u8, or as tpl
// (ntpl,mlen) u8 with tmpl_idx (N,) i32 and ts8 (N,8) u8 spliced in at
// byte ts_off; sig (N,64) u8 -> sd8 (N,32) i8, kd (N,64) i8, s_ok (N,) u8.
struct PrepArgs {
  const uint8_t* pk_all;
  const int32_t* idx;
  int v;
  const uint8_t* msg;
  int mlen;
  const uint8_t* tpl;
  int ntpl;
  const int32_t* tmpl_idx;
  const uint8_t* ts8;
  int ts_off;
  const uint8_t* sig;
  int n;
  int8_t* sd8;
  int8_t* kd;
  uint8_t* s_ok;
};

// A block's shared memory. The row strides in words (20, 12, 36) are four
// times an odd number, so the 16-byte reads of 8 neighbouring rows fall in
// distinct banks.
template <int R>
struct PrepStage {
  alignas(16) uint32_t sig[R][20];  // a row's 64-byte signature
  alignas(16) uint32_t pk[R][12];   // its 32-byte key
  alignas(16) uint32_t msg[R][36];  // 128 bytes of one compression block a slot
  alignas(16) uint32_t ts[R][2];    // its 8 timestamp bytes
  int32_t slot[R];                  // its template (the matrix form: the row), -1 if out of range
};

template <int R>
TM_FN void prep_stage_rows(PrepStage<R>& S, const PrepArgs& a, int base, int tid) {
  const int rows = a.n - base < R ? a.n - base : R;
  for (int u = tid; u < 4 * rows; u += R)
    tm_sts16(&S.sig[u >> 2][4 * (u & 3)], tm_ldg16(a.sig + 64 * (size_t)(base + (u >> 2)) + 16 * (u & 3)));
  for (int u = tid; u < 2 * rows; u += R) {
    const int row = base + (u >> 1);
    const int vi = a.idx != nullptr ? a.idx[row] : row;
    const tm_u128 zero = {0, 0, 0, 0};
    tm_sts16(&S.pk[u >> 1][4 * (u & 1)],
             vi >= 0 && vi < a.v ? tm_ldg16(a.pk_all + 32 * (size_t)vi + 16 * (u & 1)) : zero);
  }
  {
    const int r = tid, row = base + tid;
    int slot = -1;
    if (r < rows) {
      const int vi = a.idx != nullptr ? a.idx[row] : row;
      if (vi >= 0 && vi < a.v) {
        if (a.tpl == nullptr) {
          slot = r;
        } else {
          const int ti = a.tmpl_idx[row];
          if (ti >= 0 && ti < a.ntpl) slot = ti;
#if defined(__CUDA_ARCH__)
          const uint2 t = *reinterpret_cast<const uint2*>(a.ts8 + 8 * (size_t)row);
          S.ts[r][0] = t.x;
          S.ts[r][1] = t.y;
#else
          memcpy(S.ts[r], a.ts8 + 8 * (size_t)row, 8);
#endif
        }
      }
    }
    S.slot[r] = slot;
  }
}

// Byte `pos` of the padded preimage's message part and padding, the
// message's `m` at preimage byte 64; `total` the padded length.
TM_FN uint32_t prep_pad_byte(const uint8_t* m, int mlen, int pos, int total) {
  const int i = pos - 64;
  if (i < mlen) return m[i];
  if (i == mlen) return 0x80;
  if (pos >= total - 8) return (uint32_t)(((uint64_t)(64 + mlen) * 8 >> (8 * (total - 1 - pos))) & 0xff);
  return 0;
}

template <int R>
TM_FN void prep_stage_msg(PrepStage<R>& S, const PrepArgs& a, int base, int cb, int s0, int tid) {
  const bool tpl = a.tpl != nullptr;
  const int count = tpl ? (a.ntpl - s0 < R ? a.ntpl - s0 : R) : (a.n - base < R ? a.n - base : R);
  const uint8_t* src0 = tpl ? a.tpl + (size_t)a.mlen * s0 : a.msg + (size_t)a.mlen * base;
  const bool vec = ((uintptr_t)src0 & 15) == 0 && (a.mlen & 15) == 0;
  const int total = 128 * sha512_preimage_blocks(a.mlen);
  const int first = cb == 0 ? 4 : 0;  // block 0's bytes 0..63 are R and A
  for (int u = tid; u < 8 * count; u += R) {
    const int t = u >> 3, q = u & 7;
    if (q < first) continue;
    const int pos = 128 * cb + 16 * q;
    const uint8_t* m = src0 + (size_t)a.mlen * t;
    tm_u128 v;
    if (vec && pos - 64 + 16 <= a.mlen) {
      v = tm_ldg16(m + pos - 64);
    } else {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; j++) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; b++) x |= prep_pad_byte(m, a.mlen, pos + 4 * j + b, total) << (8 * b);
        wd[j] = x;
      }
      v = tm_u128{wd[0], wd[1], wd[2], wd[3]};
    }
    tm_sts16(&S.msg[t][4 * q], v);
  }
}

template <int R>
TM_FN void prep_row_block(PrepStage<R>& S, const PrepArgs& a, int cb, int s0, int r, uint64_t st[8]) {
  const int slot = S.slot[r];
  const bool tpl = a.tpl != nullptr;
  if (slot < 0 || (tpl && (slot < s0 || slot >= s0 + R))) return;
  const uint32_t* m = S.msg[tpl ? slot - s0 : r];
  uint64_t w[16];
#pragma unroll
  for (int k = 0; k < 16; k += 2) {
    const uint32_t* src = &m[2 * k];
    if (cb == 0 && k < 8) src = k < 4 ? &S.sig[r][2 * k] : &S.pk[r][2 * (k - 4)];
    const tm_u128 v = tm_lds16(src);
    w[k] = tm_be64(v.x, v.y);
    w[k + 1] = tm_be64(v.z, v.w);
  }
  if (tpl) {  // the timestamp's 8 bytes at message byte ts_off: preimage word q0 and, unaligned, q0 + 1
    const int q0 = 8 + (a.ts_off >> 3), sh = 8 * (a.ts_off & 7);
    const uint64_t ts = tm_be64(S.ts[r][0], S.ts[r][1]);
#pragma unroll
    for (int k = 0; k < 16; k++) {
      const int q = 16 * cb + k;
      if (q == q0)
        w[k] = (sh ? w[k] & (~0ull << (64 - sh)) : 0) | (ts >> sh);
      else if (sh && q == q0 + 1)
        w[k] = (w[k] & (~0ull >> sh)) | (ts << (64 - sh));
    }
  }
  sha512_compress(st, w);
}

template <int R>
TM_FN void prep_row_finish(const PrepStage<R>& S, const PrepArgs& a, int base, int r, const uint64_t st[8]) {
  const int row = base + r;
  if (row >= a.n) return;
  uint32_t sd[8] = {0, 0, 0, 0, 0, 0, 0, 0}, kd[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  bool ok = false;
  if (S.slot[r] >= 0) {
    uint64_t s[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; i++) s[i] = (uint64_t)S.sig[r][8 + 2 * i] | (uint64_t)S.sig[r][9 + 2 * i] << 32;
    ok = sc_is_canonical(s);
    signed_digits256(sd, s);
    sc_reduce_words(k, st);
    signed_digits(kd, k);
  }
  store_digits(a.sd8 + 32 * (size_t)row, sd, 8);
  store_digits(a.kd + 64 * (size_t)row, kd, 16);
  a.s_ok[row] = ok;
}
