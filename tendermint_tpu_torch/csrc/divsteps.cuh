// Bernstein and Yang's divsteps (safegcd, IACR ePrint 2019/266) on the
// low 32 bits of f and g, for an inversion by a binary GCD (fp381.cuh's
// fp_inv_gcd, fe25519.cuh's fe_inv_gcd). The original divstep, with eta =
// -delta starting at -1: with delta > 0 and g odd, (delta, f, g) <- (1 -
// delta, g, (g - f) / 2); else with g odd (1 + delta, f, (g + f) / 2);
// else (1 + delta, f, g / 2).
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define GCD_FN static __device__ __forceinline__
#else
#define GCD_FN static inline
#endif

constexpr int32_t M30 = (int32_t)((1u << 30) - 1);

// Trailing zeros of x != 0.
GCD_FN int ctz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// 30 divsteps from eta and the low bits of f (odd) and g: the matrix
// t = (u, v, q, r), [f', g'] = t [f, g] / 2^30; returns the new eta
// (= -delta).
GCD_FN int32_t divsteps30(int32_t eta, uint32_t f, uint32_t g, int32_t* t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    // the even steps at once (a sentinel bit stops the count at i)
    const int zeros = ctz32(g | (0xffffffffu << i));
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    // g odd: with eta < 0, (eta, f, g) <- (-eta, g, -f)
    if (eta < 0) {
      uint32_t tmp = f;
      eta = -eta;
      f = g;
      g = 0u - tmp;
      tmp = u;
      u = q;
      q = 0u - tmp;
      tmp = v;
      v = r;
      r = 0u - tmp;
    }
    // cancel up to min(eta + 1, i, 8) low bits of g by w f, w = -g / f
    const int limit = eta + 1 > i ? i : eta + 1;
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 255u;
    uint32_t fi = f * (2u - f * f);  // 1 / f mod 2^6, then mod 2^12
    fi *= 2u - f * fi;
    const uint32_t w = (g * (0u - fi)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}
