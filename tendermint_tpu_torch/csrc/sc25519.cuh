// Scalars mod L = 2^252 + l0 for one row per thread, on 64-bit words.
//
// Counterpart of the JAX package's ops/sc.py (40 13-bit int32 limbs) and
// of the port's plain ops/sc.py. A scalar is four little-endian uint64
// limbs. The digest is taken as SHA-512's eight state words, byte-swapped
// into little-endian limbs and cut into 24 limbs of 21 bits in int64 with
// shifts, then reduced as ref10's sc_reduce does, folding limb i >= 12
// into limbs i-12 .. i-7 with -l0 in signed 21-bit digits. No byte array
// is built on the way: the digits come out packed four to a 32-bit word,
// ready for 16-byte stores.
//
// Without nvcc (csrc/ed25519_host.cc, g++) the same functions compile as
// host C++.
#pragma once
#include <stdint.h>
#include <string.h>

#include "sha512.cuh"  // TM_FN, tm_bswap32

TM_FN void sc_fold(int64_t* s, int i) {
  s[i - 12] += s[i] * 666643;
  s[i - 11] += s[i] * 470296;
  s[i - 10] += s[i] * 654183;
  s[i - 9] -= s[i] * 997805;
  s[i - 8] += s[i] * 136657;
  s[i - 7] -= s[i] * 683901;
  s[i] = 0;
}

TM_FN void sc_carry_round(int64_t* s, int i) {
  const int64_t c = (s[i] + (1 << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * ((int64_t)1 << 21);
}

TM_FN void sc_carry_floor(int64_t* s, int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] &= (1 << 21) - 1;
}

// out = h mod L (four little-endian limbs), h the 512-bit little-endian
// number whose 64 bytes are the SHA-512 digest with state words st.
TM_FN void sc_reduce_words(uint64_t out[4], const uint64_t st[8]) {
  uint64_t h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = tm_be64((uint32_t)st[i], (uint32_t)(st[i] >> 32));  // bswap64
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 24; i++) {
    const int a = (21 * i) >> 6, sh = (21 * i) & 63;
    uint64_t v = h[a] >> sh;
    if (sh > 64 - 21 && a + 1 < 8) v |= h[a + 1] << (64 - sh);
    s[i] = (int64_t)(i < 23 ? v & 0x1fffff : v);
  }
#pragma unroll
  for (int i = 23; i >= 18; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 17; i >= 12; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 12; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 11; i++) sc_carry_floor(s, i);
  // s[0..10] are 21-bit, s[11] the rest (the result is below L < 2^253)
#pragma unroll
  for (int i = 0; i < 4; i++) out[i] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const int a = (21 * i) >> 6, sh = (21 * i) & 63;
    const uint64_t v = (uint64_t)s[i];
    out[a] |= v << sh;
    if (sh > 64 - 22 && a + 1 < 4) out[a + 1] |= v >> (64 - sh);
  }
}

// s < L (Go's scMinimal), compared from the top limb.
TM_FN bool sc_is_canonical(const uint64_t s[4]) {
  const uint64_t Lw[4] = {0x5812631A5CF5D3EDull, 0x14DEF9DEA2F79CD6ull, 0, 0x1000000000000000ull};
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    lt |= eq && (s[i] < Lw[i]);
    eq &= s[i] == Lw[i];
  }
  return lt;
}

// Base-16 digits of a scalar recoded to signed digits in [-8, 8) (as
// curve.signed_digits; the carry out of digit 63 is dropped), packed four
// int8 to a little-endian word: digit i is byte i % 4 of out[i / 4].
TM_FN void signed_digits(uint32_t out[16], const uint64_t b[4]) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < 64; i++) {
    const int v = (int)((b[i >> 4] >> (4 * (i & 15))) & 15) + carry;
    carry = v >= 8;
    const uint32_t d = (uint32_t)(v - 16 * carry) & 0xff;
    out[i >> 2] = (i & 3) ? out[i >> 2] | (d << (8 * (i & 3))) : d;
  }
}

// The bytes of a scalar recoded to signed base-256 digits in [-128, 128)
// (as curve.signed_digits_base256): a byte >= 128 becomes byte - 256 with
// a carry up; scalars below 2^253 leave no final carry. Packed as above:
// digit i is byte i % 4 of out[i / 4].
TM_FN void signed_digits256(uint32_t out[8], const uint64_t b[4]) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) {
    const int v = (int)((b[i >> 3] >> (8 * (i & 7))) & 0xff) + carry;
    carry = v >= 128;
    const uint32_t d = (uint32_t)(v - 256 * carry) & 0xff;
    out[i >> 2] = (i & 3) ? out[i >> 2] | (d << (8 * (i & 3))) : d;
  }
}

// `words` packed digit words (a multiple of 4) to dst, 16-byte aligned,
// as 16-byte stores.
TM_FN void store_digits(int8_t* dst, const uint32_t* d, int words) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < words / 4; i++)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
#else
  memcpy(dst, d, 4 * (size_t)words);
#endif
}

// The four little-endian limbs of the 32 bytes at p, read a byte at a time.
TM_FN void sc_load_bytes(uint64_t s[4], const uint8_t* p) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) v = (v << 8) | p[8 * i + j];
    s[i] = v;
  }
}
