// BLS12-381 field tower for the BLS kernels: Fp, Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - (1 + u)), Fp12 = Fp6[w]/(w^2 - v), the tower of
// ops/ref_bls12.py.
//
// Fp is 12 little-endian 32-bit limbs in Montgomery form with R = 2^384,
// multiplied by CIOS with 32x32->64 multiply-adds in u64 accumulators.
// Every value is kept fully reduced (< p) after every operation: p has
// 381 bits, so the 3 spare bits are unused for now (lazy sums are later
// work). The JAX package's form (33 limbs of 12 bits, R = 2^396, a 16p
// subtraction offset, stacked products) was shaped by the TPU's int32
// lanes and XLA's compile times and is not carried over.
//
// The curve and field constants (p, -p^-1 mod 2^32, R^2, the exponents of
// inversion, square root and the Legendre symbol, SvdW's constants, the
// Frobenius constants, the cofactor H2) are computed on the host from the
// pure-Python oracle and copied into `c_bls` once per device
// (ops/_build.py). Exponents are walked as words of that struct; the
// Miller loop's parameter |x| is compiled in.
//
// The functions are written for the device but also compile as host C++
// (without nvcc), which is how their arithmetic can be exercised against
// the oracle on a machine without a card.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define BLS_FN static __device__ __forceinline__
#define BLS_NOINLINE static __device__ __noinline__
#else
#define BLS_FN static inline
#define BLS_NOINLINE static
#endif

namespace bls {

constexpr int NL = 12;            // 32-bit limbs of an Fp element
constexpr int FP_BYTES = 48;      // big-endian canonical encoding at the seams
constexpr uint64_t X_ABS = 0xd201000000010000ull;  // |x|, x = -0xd201000000010000

struct Fp { uint32_t v[NL]; };
struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

// The host-computed constants (ops/_build.py bls_constants_blob packs
// this struct field by field, in this order, as little-endian u32).
struct Constants {
  uint32_t p[NL];
  uint32_t n0;                 // -p^-1 mod 2^32
  uint32_t pad0[3];
  uint32_t r2[NL];             // R^2 mod p
  uint32_t one[NL];            // R mod p: Montgomery 1
  uint32_t e_inv[NL];          // p - 2
  uint32_t e_sqrt[NL];         // (p + 1) / 4
  uint32_t e_legendre[NL];     // (p - 1) / 2
  uint32_t inv2[NL];           // Montgomery 1/2
  uint32_t b2[2][NL];          // Montgomery 4(1 + u): the twist's b
  uint32_t frob_v[3][2][NL];   // xi^(j (p - 1) / 3)
  uint32_t frob_vw[3][2][NL];  // xi^(j (p - 1) / 3) * xi^((p - 1) / 6)
  uint32_t svdw_z[2][NL];      // SvdW's Z and C1 = g(Z), C2 = -Z/2,
  uint32_t svdw_c1[2][NL];     // C3 = sqrt(-g(Z) 3 Z^2) with sgn0 0,
  uint32_t svdw_c2[2][NL];     // C4 = -4 g(Z) / (3 Z^2)
  uint32_t svdw_c3[2][NL];
  uint32_t svdw_c4[2][NL];
  uint32_t neg_g1[2][NL];      // -G1: (x, -y)
  uint32_t h2[16];             // the G2 cofactor, little-endian words
  uint32_t h2_bits;
  uint32_t pad1[3];
};

// Defined here for the one source that includes this header
// (bls12_kernels.cu); a host build defines its own.
#if defined(__CUDACC__)
static __constant__ Constants c_bls;
#else
extern Constants c_bls;
#endif

// -- Fp ------------------------------------------------------------------------

BLS_FN void fp_copy(Fp& r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a[i];
}

BLS_FN void fp_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
}

BLS_FN void fp_one(Fp& r) { fp_copy(r, c_bls.one); }

BLS_FN bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.v[i];
  return acc == 0;
}

BLS_FN bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

BLS_FN bool fp_is_one(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= a.v[i] ^ c_bls.one[i];
  return acc == 0;
}

// r = a - p if a >= p (a < 2p), given the carry out of the limbs above.
BLS_FN void fp_reduce_once(Fp& r, const uint32_t* t, uint32_t top) {
  uint32_t d[NL];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int64_t s = (int64_t)t[i] - c_bls.p[i] + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;  // 0 or -1
  }
  const bool ge = top != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = ge ? d[i] : t[i];
}

BLS_FN void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, t, (uint32_t)c);
}

BLS_FN void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int64_t s = (int64_t)a.v[i] - b.v[i] + borrow;
    t[i] = (uint32_t)s;
    borrow = s >> 32;
  }
  // a - b < 0: add p back
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)t[i] + (c_bls.p[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

BLS_FN void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

BLS_FN void fp_dbl(Fp& r, const Fp& a) { fp_add(r, a, a); }

// CIOS Montgomery product: r = a b / R mod p, for a, b < p.
BLS_FN void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0;
  const uint32_t n0 = c_bls.n0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.v[i];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a.v[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * n0;
    c = (uint64_t)m * c_bls.p[0] + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * c_bls.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  fp_reduce_once(r, t, t[NL]);
}

BLS_FN void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }

// a^e for the exponent words e (little-endian), its top `bits` bits.
BLS_NOINLINE void fp_pow(Fp& r, const Fp& a, const uint32_t* e, int bits) {
  Fp acc;
  fp_one(acc);
  for (int i = bits - 1; i >= 0; --i) {
    fp_sqr(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1) fp_mul(acc, acc, a);
  }
  r = acc;
}

// 1/a by Fermat; 0 -> 0 (the inv0 convention the SvdW map relies on).
BLS_FN void fp_inv(Fp& r, const Fp& a) { fp_pow(r, a, c_bls.e_inv, 32 * NL); }

// a^((p+1)/4): the square root of a when a is a square (p = 3 mod 4).
BLS_FN void fp_sqrt_cand(Fp& r, const Fp& a) { fp_pow(r, a, c_bls.e_sqrt, 32 * NL); }

// Euler's criterion; 0 counts as a square.
BLS_FN bool fp_is_square(const Fp& a) {
  Fp l;
  fp_pow(l, a, c_bls.e_legendre, 32 * NL);
  return fp_is_one(l) || fp_is_zero(a);
}

// Canonical value (out of Montgomery form) as 48 big-endian bytes.
BLS_FN void fp_to_bytes(uint8_t* out, const Fp& a) {
  Fp one_plain, v;
  fp_zero(one_plain);
  one_plain.v[0] = 1;
  fp_mul(v, a, one_plain);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t w = v.v[i];
    out[FP_BYTES - 1 - 4 * i] = (uint8_t)w;
    out[FP_BYTES - 2 - 4 * i] = (uint8_t)(w >> 8);
    out[FP_BYTES - 3 - 4 * i] = (uint8_t)(w >> 16);
    out[FP_BYTES - 4 - 4 * i] = (uint8_t)(w >> 24);
  }
}

// 48 big-endian bytes of a value < p into Montgomery form.
BLS_FN void fp_from_bytes(Fp& r, const uint8_t* in) {
  Fp plain, r2;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    plain.v[i] = ((uint32_t)in[FP_BYTES - 4 - 4 * i] << 24) | ((uint32_t)in[FP_BYTES - 3 - 4 * i] << 16) |
                 ((uint32_t)in[FP_BYTES - 2 - 4 * i] << 8) | (uint32_t)in[FP_BYTES - 1 - 4 * i];
  }
  fp_copy(r2, c_bls.r2);
  fp_mul(r, plain, r2);
}

// The low bit of the canonical value (RFC 9380 sgn0 of an Fp element).
BLS_FN uint32_t fp_parity(const Fp& a) {
  Fp one_plain, v;
  fp_zero(one_plain);
  one_plain.v[0] = 1;
  fp_mul(v, a, one_plain);
  return v.v[0] & 1;
}

// -- Fp2 -----------------------------------------------------------------------

BLS_FN void f2_copy(Fp2& r, const uint32_t (*a)[NL]) {
  fp_copy(r.c0, a[0]);
  fp_copy(r.c1, a[1]);
}

BLS_FN void f2_zero(Fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

BLS_FN void f2_one(Fp2& r) {
  fp_one(r.c0);
  fp_zero(r.c1);
}

BLS_FN bool f2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }

BLS_FN void f2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

BLS_FN void f2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

BLS_FN void f2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

BLS_FN void f2_dbl(Fp2& r, const Fp2& a) { f2_add(r, a, a); }

BLS_FN void f2_conj(Fp2& r, const Fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

// Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0 b0 - a1 b1 + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
BLS_NOINLINE void f2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, s0, s1, t2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(t2, s0, s1);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

// (c0 + c1 u)^2 = (c0 + c1)(c0 - c1) + 2 c0 c1 u
BLS_NOINLINE void f2_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, t;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(t, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_dbl(r.c1, t);
}

// a * s for s in Fp
BLS_FN void f2_mul_fp(Fp2& r, const Fp2& a, const Fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

// a * (1 + u) = (c0 - c1) + (c0 + c1) u
BLS_FN void f2_mul_xi(Fp2& r, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

BLS_FN void f2_norm(Fp& r, const Fp2& a) {
  Fp t0, t1;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(r, t0, t1);
}

// conj(a) / norm(a); 0 -> 0
BLS_NOINLINE void f2_inv(Fp2& r, const Fp2& a) {
  Fp n, ni, t;
  f2_norm(n, a);
  fp_inv(ni, n);
  fp_mul(r.c0, a.c0, ni);
  fp_neg(t, a.c1);
  fp_mul(r.c1, t, ni);
}

BLS_FN bool f2_is_square(const Fp2& a) {
  Fp n;
  f2_norm(n, a);
  return fp_is_square(n);
}

// The oracle's square root (ref_bls12.f2_sqrt), the same root chosen,
// for a square a.
BLS_NOINLINE void f2_sqrt(Fp2& r, const Fp2& a) {
  Fp s, t;
  if (fp_is_zero(a.c1)) {
    fp_sqrt_cand(s, a.c0);
    fp_sqr(t, s);
    if (fp_eq(t, a.c0)) {
      r.c0 = s;
      fp_zero(r.c1);
    } else {
      fp_neg(t, a.c0);
      fp_sqrt_cand(s, t);
      fp_zero(r.c0);
      r.c1 = s;
    }
    return;
  }
  Fp n, inv2, delta, x0, x1;
  f2_norm(n, a);
  fp_sqrt_cand(s, n);
  fp_copy(inv2, c_bls.inv2);
  fp_add(t, a.c0, s);
  fp_mul(delta, t, inv2);
  fp_sqrt_cand(x0, delta);
  fp_sqr(t, x0);
  if (!fp_eq(t, delta)) {
    fp_sub(t, a.c0, s);
    fp_mul(delta, t, inv2);
    fp_sqrt_cand(x0, delta);
  }
  fp_dbl(t, x0);
  fp_inv(t, t);
  fp_mul(x1, a.c1, t);
  r.c0 = x0;
  r.c1 = x1;
}

// RFC 9380 sgn0 for m = 2 on canonical values.
BLS_FN uint32_t f2_sgn0(const Fp2& a) {
  const uint32_t s0 = fp_parity(a.c0);
  const uint32_t z0 = fp_is_zero(a.c0) ? 1u : 0u;
  return s0 | (z0 & fp_parity(a.c1));
}

// -- Fp6 -----------------------------------------------------------------------

BLS_FN void f6_add(Fp6& r, const Fp6& a, const Fp6& b) {
  f2_add(r.c0, a.c0, b.c0);
  f2_add(r.c1, a.c1, b.c1);
  f2_add(r.c2, a.c2, b.c2);
}

BLS_FN void f6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
  f2_sub(r.c0, a.c0, b.c0);
  f2_sub(r.c1, a.c1, b.c1);
  f2_sub(r.c2, a.c2, b.c2);
}

BLS_FN void f6_neg(Fp6& r, const Fp6& a) {
  f2_neg(r.c0, a.c0);
  f2_neg(r.c1, a.c1);
  f2_neg(r.c2, a.c2);
}

// Schoolbook with v^3 = xi (ref_bls12.f6_mul).
BLS_NOINLINE void f6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 t00, t01, t02, t03, t04, m;
  f2_mul(t00, a.c0, b.c0);
  f2_mul(t01, a.c0, b.c1);
  f2_mul(m, a.c1, b.c0);
  f2_add(t01, t01, m);
  f2_mul(t02, a.c0, b.c2);
  f2_mul(m, a.c1, b.c1);
  f2_add(t02, t02, m);
  f2_mul(m, a.c2, b.c0);
  f2_add(t02, t02, m);
  f2_mul(t03, a.c1, b.c2);
  f2_mul(m, a.c2, b.c1);
  f2_add(t03, t03, m);
  f2_mul(t04, a.c2, b.c2);
  f2_mul_xi(t03, t03);
  f2_mul_xi(t04, t04);
  f2_add(r.c0, t00, t03);
  f2_add(r.c1, t01, t04);
  r.c2 = t02;
}

// a v: (c0, c1, c2) -> (xi c2, c0, c1)
BLS_FN void f6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  f2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

BLS_NOINLINE void f6_inv(Fp6& r, const Fp6& a) {
  Fp2 c0, c1, c2, t, u;
  f2_sqr(c0, a.c0);
  f2_mul(t, a.c1, a.c2);
  f2_mul_xi(t, t);
  f2_sub(c0, c0, t);
  f2_sqr(c1, a.c2);
  f2_mul_xi(c1, c1);
  f2_mul(t, a.c0, a.c1);
  f2_sub(c1, c1, t);
  f2_sqr(c2, a.c1);
  f2_mul(t, a.c0, a.c2);
  f2_sub(c2, c2, t);
  f2_mul(t, a.c2, c1);
  f2_mul(u, a.c1, c2);
  f2_add(t, t, u);
  f2_mul_xi(t, t);
  f2_mul(u, a.c0, c0);
  f2_add(t, t, u);
  f2_inv(t, t);
  f2_mul(r.c0, c0, t);
  f2_mul(r.c1, c1, t);
  f2_mul(r.c2, c2, t);
}

// -- Fp12 ----------------------------------------------------------------------

BLS_FN void f12_one(Fp12& r) {
  f2_one(r.c0.c0);
  f2_zero(r.c0.c1);
  f2_zero(r.c0.c2);
  f2_zero(r.c1.c0);
  f2_zero(r.c1.c1);
  f2_zero(r.c1.c2);
}

// Karatsuba over Fp6 with w^2 = v.
BLS_NOINLINE void f12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 t0, t1, sa, sb, c1;
  f6_mul(t0, a.c0, b.c0);
  f6_mul(t1, a.c1, b.c1);
  f6_add(sa, a.c0, a.c1);
  f6_add(sb, b.c0, b.c1);
  f6_mul(c1, sa, sb);
  f6_sub(c1, c1, t0);
  f6_sub(r.c1, c1, t1);
  f6_mul_by_v(t1, t1);
  f6_add(r.c0, t0, t1);
}

BLS_FN void f12_sqr(Fp12& r, const Fp12& a) { f12_mul(r, a, a); }

BLS_FN void f12_conj(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  f6_neg(r.c1, a.c1);
}

BLS_NOINLINE void f12_inv(Fp12& r, const Fp12& a) {
  Fp6 s0, s1, t;
  f6_mul(s0, a.c0, a.c0);
  f6_mul(s1, a.c1, a.c1);
  f6_mul_by_v(s1, s1);
  f6_sub(t, s0, s1);
  f6_inv(t, t);
  f6_mul(r.c0, a.c0, t);
  f6_mul(s1, a.c1, t);
  f6_neg(r.c1, s1);
}

// a^p: conjugate each Fp2 coefficient, times the structure constants.
BLS_NOINLINE void f12_frobenius(Fp12& r, const Fp12& a) {
  const Fp2* in0 = &a.c0.c0;
  const Fp2* in1 = &a.c1.c0;
  Fp2* out0 = &r.c0.c0;
  Fp2* out1 = &r.c1.c0;
  for (int j = 0; j < 3; ++j) {
    Fp2 t, k;
    f2_conj(t, in0[j]);
    f2_copy(k, c_bls.frob_v[j]);
    f2_mul(out0[j], t, k);
    f2_conj(t, in1[j]);
    f2_copy(k, c_bls.frob_vw[j]);
    f2_mul(out1[j], t, k);
  }
}

BLS_FN bool f12_is_one(const Fp12& a) {
  return fp_is_one(a.c0.c0.c0) && fp_is_zero(a.c0.c0.c1) && f2_is_zero(a.c0.c1) && f2_is_zero(a.c0.c2) &&
         f2_is_zero(a.c1.c0) && f2_is_zero(a.c1.c1) && f2_is_zero(a.c1.c2);
}

// The 12 canonical coefficients as (2, 3, 2, 48) bytes: the JAX
// package's Fp12 layout (c0/c1 over w, then v^0..v^2, then c0/c1 over u).
BLS_FN void f12_to_bytes(uint8_t* out, const Fp12& a) {
  const Fp2* c = &a.c0.c0;
  for (int j = 0; j < 6; ++j) {
    fp_to_bytes(out + (2 * j) * FP_BYTES, c[j].c0);
    fp_to_bytes(out + (2 * j + 1) * FP_BYTES, c[j].c1);
  }
}

}  // namespace bls
