// SHA-512 of the ed25519 challenge preimage R || A || M, one row a thread.
//
// Counterpart of the JAX package's ops/sha512.py, which carries each
// 64-bit word as a (hi, lo) uint32 pair because the TPU has no 64-bit
// integers. Here words are native uint64 (the card splits them into
// 32-bit halves itself). `sha512_compress` unrolls all 80 rounds, so each
// round constant is an immediate operand of its add and no round reads
// memory; the schedule rolls through sixteen registers.
//
// Two callers build the message words differently. The tabled prepare
// (ed25519_tabled.cu) builds them from words its block staged in shared
// memory. The generic prepare (ed25519_kernels.cu) reads byte i of the
// padded preimage straight from the signature, the key or the message
// row (`tm_sha512_preimage`), and the preimage is never materialised.
//
// Without nvcc (csrc/ed25519_host.cc, g++) the same functions compile as
// host C++.
#pragma once
#include <stdint.h>

#include "fe25519.cuh"  // TM_FN

TM_FN uint64_t tm_rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

TM_FN uint32_t tm_bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// The big-endian 64-bit word whose bytes are, in memory order, those of
// the little-endian 32-bit words lo then hi.
TM_FN uint64_t tm_be64(uint32_t lo, uint32_t hi) { return ((uint64_t)tm_bswap32(lo) << 32) | tm_bswap32(hi); }

TM_FN void sha512_init(uint64_t st[8]) {
  st[0] = 0x6A09E667F3BCC908ull;
  st[1] = 0xBB67AE8584CAA73Bull;
  st[2] = 0x3C6EF372FE94F82Bull;
  st[3] = 0xA54FF53A5F1D36F1ull;
  st[4] = 0x510E527FADE682D1ull;
  st[5] = 0x9B05688C2B3E6C1Full;
  st[6] = 0x1F83D9ABFB41BD6Bull;
  st[7] = 0x5BE0CD19137E2179ull;
}

// st += compress(st, w): w is the block's 16 big-endian words and is
// overwritten by the schedule.
TM_FN void sha512_compress(uint64_t st[8], uint64_t w[16]) {
  const uint64_t K[80] = {
      0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
      0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
      0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
      0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
      0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
      0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
      0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
      0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
      0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
      0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
      0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
      0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
      0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
      0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
      0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
      0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
      0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
      0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
      0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
      0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
  };
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {  // rolling 16-word schedule
      const uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint64_t s0 = tm_rotr64(w15, 1) ^ tm_rotr64(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = tm_rotr64(w2, 19) ^ tm_rotr64(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t + 9) & 15] + s1;
    }
    const uint64_t S1 = tm_rotr64(e, 14) ^ tm_rotr64(e, 18) ^ tm_rotr64(e, 41);
    const uint64_t ch = g ^ (e & (f ^ g));
    const uint64_t t1 = h + K[t] + w[t & 15] + S1 + ch;
    const uint64_t S0 = tm_rotr64(a, 28) ^ tm_rotr64(a, 34) ^ tm_rotr64(a, 39);
    const uint64_t maj = (a & b) | (c & (a | b));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// Blocks of the padded preimage R || A || M of an M of `mlen` bytes:
// 64 + mlen bytes, 0x80, zeros, and the 128-bit big-endian bit length.
TM_FN int sha512_preimage_blocks(int mlen) { return (64 + mlen + 17 + 127) / 128; }

// Byte `i` of pad(R || A || M), `total` the padded length.
TM_FN uint32_t tm_preimage_byte(int i, const uint8_t* sig, const uint8_t* pk, const uint8_t* m, int mlen, int total) {
  const int len = 64 + mlen;
  if (i < 32) return sig[i];
  if (i < 64) return pk[i - 32];
  if (i < len) return m[i - 64];
  if (i == len) return 0x80;
  if (i >= total - 8) {  // low 64 bits of the 128-bit big-endian bit length
    const uint64_t bits = (uint64_t)len * 8;
    return (uint32_t)((bits >> (8 * (total - 1 - i))) & 0xff);
  }
  return 0;
}

// st = SHA-512 state words of R || A || M, each message byte read where
// it lives (ed25519_prepare's hash warp).
TM_FN void tm_sha512_preimage(uint64_t st[8], const uint8_t* sig, const uint8_t* pk, const uint8_t* m, int mlen) {
  sha512_init(st);
  const int nblocks = sha512_preimage_blocks(mlen);
  const int total = 128 * nblocks;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; blk++) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      uint64_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; j++) v = (v << 8) | tm_preimage_byte(blk * 128 + t * 8 + j, sig, pk, m, mlen, total);
      w[t] = v;
    }
    sha512_compress(st, w);
  }
}
