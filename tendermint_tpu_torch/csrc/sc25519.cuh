// Scalars mod L = 2^252 + l0 for one row per thread.
//
// Counterpart of the JAX package's ops/sc.py (40 13-bit int32 limbs) and
// of the port's plain ops/sc.py: the 64-byte digest is cut into 24 limbs
// of 21 bits in int64 and reduced as ref10's sc_reduce does, folding limb
// i >= 12 into limbs i-12 .. i-7 with -l0 in signed 21-bit digits.
#pragma once
#include <stdint.h>

__device__ __forceinline__ void sc_fold(int64_t* s, int i) {
  s[i - 12] += s[i] * 666643;
  s[i - 11] += s[i] * 470296;
  s[i - 10] += s[i] * 654183;
  s[i - 9] -= s[i] * 997805;
  s[i - 8] += s[i] * 136657;
  s[i - 7] -= s[i] * 683901;
  s[i] = 0;
}

__device__ __forceinline__ void sc_carry_round(int64_t* s, int i) {
  const int64_t c = (s[i] + (1 << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * ((int64_t)1 << 21);
}

__device__ __forceinline__ void sc_carry_floor(int64_t* s, int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] &= (1 << 21) - 1;
}

// out = in (64 bytes, little-endian) mod L, 32 bytes
static __device__ void sc_reduce(uint8_t out[32], const uint8_t in[64]) {
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 24; i++) {
    const int j = (21 * i) >> 3, sh = (21 * i) & 7;
    uint64_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; b++)
      if (j + b < 64) w |= (uint64_t)in[j + b] << (8 * b);
    s[i] = (int64_t)((w >> sh) & (i < 23 ? 0x1fffffull : 0xffffffffull));
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
  uint64_t acc = 0;
  int nbits = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    acc |= (uint64_t)s[i] << nbits;
    nbits += 21;
    while (nbits >= 8 && j < 32) {
      out[j++] = (uint8_t)(acc & 0xff);
      acc >>= 8;
      nbits -= 8;
    }
  }
  while (j < 32) {
    out[j++] = (uint8_t)(acc & 0xff);
    acc >>= 8;
  }
}

// s < L (Go's scMinimal), compared from the top byte
__device__ __forceinline__ bool sc_is_canonical(const uint8_t* s) {
  const uint8_t Lb[32] = {0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
                          0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
                          0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 31; i >= 0; i--) {
    lt |= eq && (s[i] < Lb[i]);
    eq &= s[i] == Lb[i];
  }
  return lt;
}

// Base-16 digits of a 32-byte scalar recoded to signed digits in [-8, 8)
// (as curve.signed_digits; the carry out of digit 63 is dropped).
__device__ __forceinline__ void signed_digits(int8_t* out, const uint8_t* b) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < 64; i++) {
    const int v = ((b[i >> 1] >> (4 * (i & 1))) & 15) + carry;
    carry = v >= 8;
    out[i] = (int8_t)(v - 16 * carry);
  }
}

// The bytes of a 32-byte scalar recoded to signed base-256 digits in
// [-128, 128) (as curve.signed_digits_base256): a byte >= 128 becomes
// byte - 256 with a carry up; scalars below 2^253 leave no final carry.
__device__ __forceinline__ void signed_digits256(int8_t* out, const uint8_t* b) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) {
    const int v = b[i] + carry;
    carry = v >= 128;
    out[i] = (int8_t)(v - 256 * carry);
  }
}
