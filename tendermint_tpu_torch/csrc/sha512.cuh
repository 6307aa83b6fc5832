// SHA-512 of one ed25519 challenge preimage R || A || M per thread.
//
// Counterpart of the JAX package's ops/sha512.py, which carries each
// 64-bit word as a (hi, lo) uint32 pair because the TPU has no 64-bit
// integers. Here words are native uint64 (the card splits them into
// 32-bit halves itself). The preimage is never materialised: byte i of
// the padded message is read straight from the signature, the key or the
// message row. The round constants come from the host (TmConstants).
//
// The message is read through an accessor, so a row can also be a
// template with a per-row timestamp spliced in (TplMsg): the tabled
// prepare never materialises the (N, 160) sign-bytes matrix.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint64_t tm_rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// A message row stored as it is.
struct MatMsg {
  const uint8_t* m;
  __device__ __forceinline__ uint32_t operator()(int i) const { return m[i]; }
};

// A message row that is a template with 8 timestamp bytes spliced in at
// `ts_off` (the canonical sign-bytes layout, codec/signbytes.py).
struct TplMsg {
  const uint8_t* tpl;
  const uint8_t* ts8;
  int ts_off;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return (i >= ts_off && i < ts_off + 8) ? ts8[i - ts_off] : tpl[i];
  }
};

// Byte `i` of pad(R || A || M), with M `mlen` bytes and `total` the
// padded length.
template <class Msg>
__device__ __forceinline__ uint32_t tm_preimage_byte(int i, const uint8_t* sig, const uint8_t* pk,
                                                      const Msg& msg, int mlen, int total) {
  const int len = 64 + mlen;
  if (i < 32) return sig[i];
  if (i < 64) return pk[i - 32];
  if (i < len) return msg(i - 64);
  if (i == len) return 0x80;
  if (i >= total - 8) {  // low 64 bits of the 128-bit big-endian bit length
    const uint64_t bits = (uint64_t)len * 8;
    return (uint32_t)((bits >> (8 * (total - 1 - i))) & 0xff);
  }
  return 0;
}

template <class Msg>
__device__ void tm_sha512_preimage(uint8_t out[64], const uint8_t* sig, const uint8_t* pk,
                                   const Msg& msg, int mlen, const uint64_t* K) {
  const uint64_t H0[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
                          0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                          0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  uint64_t st[8];
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = H0[i];
  const int nblocks = (64 + mlen + 17 + 127) / 128;
  const int total = 128 * nblocks;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; blk++) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      uint64_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; j++)
        v = (v << 8) | tm_preimage_byte(blk * 128 + t * 8 + j, sig, pk, msg, mlen, total);
      w[t] = v;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
    for (int r = 0; r < 80; r += 16) {
#pragma unroll
      for (int j = 0; j < 16; j++) {
        uint64_t wt;
        if (r == 0) {
          wt = w[j];
        } else {  // rolling 16-word schedule
          const uint64_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
          const uint64_t s0 = tm_rotr64(w15, 1) ^ tm_rotr64(w15, 8) ^ (w15 >> 7);
          const uint64_t s1 = tm_rotr64(w2, 19) ^ tm_rotr64(w2, 61) ^ (w2 >> 6);
          wt = w[j] + s0 + w[(j + 9) & 15] + s1;
          w[j] = wt;
        }
        const uint64_t S1 = tm_rotr64(e, 14) ^ tm_rotr64(e, 18) ^ tm_rotr64(e, 41);
        const uint64_t ch = (e & f) ^ (~e & g);
        const uint64_t t1 = h + S1 + ch + K[r + j] + wt;
        const uint64_t S0 = tm_rotr64(a, 28) ^ tm_rotr64(a, 34) ^ tm_rotr64(a, 39);
        const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        const uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
      }
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
#pragma unroll
  for (int i = 0; i < 8; i++)
#pragma unroll
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(st[i] >> (56 - 8 * j));
}
