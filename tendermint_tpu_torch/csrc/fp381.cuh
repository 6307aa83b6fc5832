// BLS12-381 field arithmetic for the BLS kernels: Fp, and the Fp2 =
// Fp[u]/(u^2 + 1) operations that one lane runs on its own (the SvdW map,
// inversions, the G1 sum). Fp6 = Fp2[v]/(v^3 - (1 + u)) and Fp12 =
// Fp6[w]/(w^2 - v), the tower of ops/ref_bls12.py, are cut into stages of
// independent products in bls12_curve.cuh, where the lanes of a row share
// them.
//
// Fp is 12 little-endian 32-bit limbs in Montgomery form with R = 2^384.
// The product is CIOS: on the device each row of 12 limb products and each
// reduction row is one PTX carry chain (mad.lo.cc / madc.hi.cc / addc), so
// a carry costs no add of its own; on the host a portable twin with u64
// accumulators computes the same value (and counts the products, for the
// host build's Fp-product count of a row). Every value is kept canonical
// (< p) after every operation: sums and differences end with one
// conditional subtraction, also a carry chain on the device. p has 381
// bits, so a sum of two canonical values never carries out of 384 bits.
// The JAX package's form (33 limbs of 12 bits, R = 2^396, a 16p
// subtraction offset, stacked products) was shaped by the TPU's int32
// lanes and XLA's compile times and is not carried over.
//
// The curve and field constants (p, -p^-1 mod 2^32, R^2, the exponents of
// inversion, square root and the Legendre symbol (which no kernel reads),
// SvdW's constants, the Frobenius constants, the cofactor H2) are
// computed on the host from the pure-Python oracle and copied into `c_bls`
// once per device (ops/_build.py). Powers walk their exponent by a
// sliding window of 5 bits; the Miller loop's parameter |x| is compiled in.
//
// The functions are written for the device but also compile as host C++
// (without nvcc, see csrc/bls12_host.cc), which is how their arithmetic is
// held against the oracle on a machine without a card. Defining
// BLS_PORTABLE_FP compiles the portable twins for the device too, so that
// the two forms of the product can be compared on the card (chip_smoke.py's
// fp_mul probe, scripts/bls_fp_mul_bench.py); the kernels never define it.
#pragma once
#include <stdint.h>

#include "divsteps.cuh"

#if defined(__CUDACC__)
#define BLS_FN static __device__ __forceinline__
#define BLS_NOINLINE static __device__ __noinline__
#define BLS_UNROLL _Pragma("unroll")
#else
#define BLS_FN static inline
#define BLS_NOINLINE static
#define BLS_UNROLL
#endif

namespace bls {

constexpr int NL = 12;            // 32-bit limbs of an Fp element
constexpr int FP_BYTES = 48;      // big-endian canonical encoding at the seams
constexpr uint64_t X_ABS = 0xd201000000010000ull;  // |x|, x = -0xd201000000010000

struct alignas(16) Fp { uint32_t v[NL]; };
struct Fp2 { Fp c0, c1; };

// The host-computed constants (ops/bls12.py constants_blob packs this
// struct field by field, in this order, as little-endian u32).
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
// (bls12_kernels.cu); a host build defines its own, and the count of Fp
// products that only the host build keeps.
#if defined(__CUDACC__)
static __constant__ Constants c_bls;
#else
extern Constants c_bls;
extern uint64_t fp_mul_count;
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

#if defined(__CUDA_ARCH__) && !defined(BLS_PORTABLE_FP)
// The carry chains. Each step is its own volatile asm statement, kept in
// order, and nothing between two steps touches the carry flag.
#define BLS_ASM(...) asm volatile(__VA_ARGS__)

// r = t - p if t >= p (t < 2p fits 12 limbs).
BLS_FN void fp_reduce_once(Fp& r, const uint32_t* t) {
  uint32_t d[NL], bw;
  const uint32_t zero = 0;
  BLS_ASM("sub.cc.u32 %0, %1, %2;" : "=r"(d[0]) : "r"(t[0]), "r"(c_bls.p[0]));
#pragma unroll
  for (int i = 1; i < NL; ++i) BLS_ASM("subc.cc.u32 %0, %1, %2;" : "=r"(d[i]) : "r"(t[i]), "r"(c_bls.p[i]));
  BLS_ASM("subc.u32 %0, %1, %1;" : "=r"(bw) : "r"(zero));
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = bw ? t[i] : d[i];
}

BLS_FN void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL];
  BLS_ASM("add.cc.u32 %0, %1, %2;" : "=r"(t[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < NL; ++i) BLS_ASM("addc.cc.u32 %0, %1, %2;" : "=r"(t[i]) : "r"(a.v[i]), "r"(b.v[i]));
  fp_reduce_once(r, t);
}

BLS_FN void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL], bw;
  const uint32_t zero = 0;
  BLS_ASM("sub.cc.u32 %0, %1, %2;" : "=r"(t[0]) : "r"(a.v[0]), "r"(b.v[0]));
#pragma unroll
  for (int i = 1; i < NL; ++i) BLS_ASM("subc.cc.u32 %0, %1, %2;" : "=r"(t[i]) : "r"(a.v[i]), "r"(b.v[i]));
  BLS_ASM("subc.u32 %0, %1, %1;" : "=r"(bw) : "r"(zero));
  // a - b < 0: add p back
  uint32_t pm[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) pm[i] = c_bls.p[i] & bw;
  BLS_ASM("add.cc.u32 %0, %0, %1;" : "+r"(t[0]) : "r"(pm[0]));
#pragma unroll
  for (int i = 1; i < NL; ++i) BLS_ASM("addc.cc.u32 %0, %0, %1;" : "+r"(t[i]) : "r"(pm[i]));
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = t[i];
}

// CIOS Montgomery product: r = a b / R mod p, for a, b < p. t stays below
// 2p < 2^382 between rows, so t[12] never carries out.
BLS_FN void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL + 1];
#pragma unroll
  for (int i = 0; i < NL + 1; ++i) t[i] = 0;
  const uint32_t n0 = c_bls.n0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t bi = b.v[i];
    BLS_ASM("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(a.v[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < NL; ++j) BLS_ASM("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(a.v[j]), "r"(bi));
    BLS_ASM("addc.u32 %0, %0, 0;" : "+r"(t[NL]));
    BLS_ASM("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a.v[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < NL - 1; ++j)
      BLS_ASM("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(a.v[j]), "r"(bi));
    BLS_ASM("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[NL]) : "r"(a.v[NL - 1]), "r"(bi));
    const uint32_t m = t[0] * n0;
    BLS_ASM("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(m), "r"(c_bls.p[0]));
#pragma unroll
    for (int j = 1; j < NL; ++j) BLS_ASM("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(m), "r"(c_bls.p[j]));
    BLS_ASM("addc.u32 %0, %0, 0;" : "+r"(t[NL]));
    BLS_ASM("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(m), "r"(c_bls.p[0]));
#pragma unroll
    for (int j = 1; j < NL - 1; ++j)
      BLS_ASM("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(m), "r"(c_bls.p[j]));
    BLS_ASM("madc.hi.u32 %0, %1, %2, %0;" : "+r"(t[NL]) : "r"(m), "r"(c_bls.p[NL - 1]));
#pragma unroll
    for (int j = 0; j < NL; ++j) t[j] = t[j + 1];
    t[NL] = 0;
  }
  fp_reduce_once(r, t);
}
#undef BLS_ASM
#else
// The portable twins: the same values by u64 accumulators.

// r = t - p if t >= p (t < 2p), given the carry out of the limbs above.
BLS_FN void fp_reduce_once(Fp& r, const uint32_t* t, uint32_t top) {
  uint32_t d[NL];
  int64_t borrow = 0;
  BLS_UNROLL
  for (int i = 0; i < NL; ++i) {
    int64_t s = (int64_t)t[i] - c_bls.p[i] + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;  // 0 or -1
  }
  const bool ge = top != 0 || borrow == 0;
  BLS_UNROLL
  for (int i = 0; i < NL; ++i) r.v[i] = ge ? d[i] : t[i];
}

BLS_FN void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NL];
  uint64_t c = 0;
  BLS_UNROLL
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
  BLS_UNROLL
  for (int i = 0; i < NL; ++i) {
    int64_t s = (int64_t)a.v[i] - b.v[i] + borrow;
    t[i] = (uint32_t)s;
    borrow = s >> 32;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
  BLS_UNROLL
  for (int i = 0; i < NL; ++i) {
    c += (uint64_t)t[i] + (c_bls.p[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

BLS_FN void fp_mul(Fp& r, const Fp& a, const Fp& b) {
#if !defined(__CUDACC__)
  ++fp_mul_count;
#endif
  uint32_t t[NL + 2] = {0};
  const uint32_t n0 = c_bls.n0;
  BLS_UNROLL
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.v[i];
    BLS_UNROLL
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
    BLS_UNROLL
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
#endif

BLS_FN void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

BLS_FN void fp_dbl(Fp& r, const Fp& a) { fp_add(r, a, a); }

BLS_FN void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }

BLS_FN bool exp_bit(const uint32_t* e, int i) { return (e[i >> 5] >> (i & 31)) & 1; }

// a^e for the exponent words e (little-endian) below bit `bits`, by a
// left-to-right sliding window of 5 bits over the odd powers a, a^3, ...,
// a^31. 0^e = 0.
BLS_NOINLINE void fp_pow(Fp& r, const Fp& a, const uint32_t* e, int bits) {
  constexpr int W = 5;
  Fp odd[1 << (W - 1)], a2;
  odd[0] = a;
  fp_sqr(a2, a);
  for (int k = 1; k < (1 << (W - 1)); ++k) fp_mul(odd[k], odd[k - 1], a2);
  int i = bits - 1;
  while (i >= 0 && !exp_bit(e, i)) --i;
  Fp acc;
  fp_one(acc);
  bool first = true;
  while (i >= 0) {
    if (!exp_bit(e, i)) {
      fp_sqr(acc, acc);
      --i;
      continue;
    }
    int j = i - W + 1 > 0 ? i - W + 1 : 0;
    while (!exp_bit(e, j)) ++j;
    uint32_t w = 0;
    for (int k = i; k >= j; --k) w = (w << 1) | (exp_bit(e, k) ? 1u : 0u);
    if (first) {
      acc = odd[w >> 1];
      first = false;
    } else {
      for (int k = i; k >= j; --k) fp_sqr(acc, acc);
      fp_mul(acc, acc, odd[w >> 1]);
    }
    i = j - 1;
  }
  r = acc;
}

// 1/a by Fermat; 0 -> 0 (the inv0 convention the SvdW map relies on).
BLS_FN void fp_inv(Fp& r, const Fp& a) { fp_pow(r, a, c_bls.e_inv, 32 * NL); }

// a^((p+1)/4): the square root of a when a is a square (p = 3 mod 4).
BLS_FN void fp_sqrt_cand(Fp& r, const Fp& a) { fp_pow(r, a, c_bls.e_sqrt, 32 * NL); }

// -- inversion by a binary GCD (the G1 aggregate's normalisation) ----------------
//
// Bernstein and Yang's safegcd (IACR ePrint 2019/266) in its variable-time
// form (as libsecp256k1's modinv32_var): batches of 30 divsteps, each
// batch computed on the low 32 bits of f and g alone (a divstep reads only
// g's parity and the sign of eta), the even steps in bulk by counting
// trailing zeros and up to eight low bits of g cancelled at once by a
// multiple of f, collected in a 2x2 matrix of factors below 2^30; the
// matrix then updates the full f, g (13 signed limbs of 30 bits: the
// division by 2^30 is a shift by one limb) and the cofactors d, e mod p
// (the multiple of p that clears the low limb added first). The loop runs
// until g = 0, some 25-30 batches for a 381-bit p; f is then +-1 and d
// +-1 / y. Every index is a constant after unrolling, so the values stay
// in registers. Variable time: the value is public where this is used
// (the aggregate of validators' keys).
//
// Montgomery form in and out: started from e = R^2 instead of 1, the
// invariants d y = R^2 f, e y = R^2 g (mod p) end with d = +-R^2 / y, the
// Montgomery form of the inverse of y's value (y = aR gives R / a). 0 maps
// to 0: g = 0 ends the loop at once with d = 0.

constexpr int GL = 13;  // 30-bit limbs of the GCD's values (390 bits)

// 12 x 32-bit limbs -> 13 x 30-bit limbs (a value below 2^384).
BLS_FN void to_limbs30(int32_t* r, const uint32_t* a) {
  BLS_UNROLL
  for (int i = 0; i < GL; ++i) {
    const int w = 30 * i / 32, off = 30 * i % 32;
    uint64_t x = a[w] >> off;
    if (w + 1 < NL) x |= (uint64_t)a[w + 1] << (32 - off);
    r[i] = (int32_t)(x & M30);
  }
}

// 13 x 30-bit limbs of a value in [0, 2^384) -> 12 x 32-bit limbs.
BLS_FN void from_limbs30(uint32_t* r, const int32_t* a) {
  BLS_UNROLL
  for (int j = 0; j < NL; ++j) {
    const int i = 32 * j / 30, off = 32 * j % 30;
    uint64_t x = (uint64_t)(uint32_t)a[i] >> off;
    if (i + 1 < GL) x |= (uint64_t)(uint32_t)a[i + 1] << (30 - off);
    if (i + 2 < GL) x |= (uint64_t)(uint32_t)a[i + 2] << (60 - off);
    r[j] = (uint32_t)x;
  }
}

// [f, g] <- t [f, g] / 2^30 (exact): limbs 0..11 in [0, 2^30), 12 signed.
BLS_FN void gcd_update_fg(int32_t* f, int32_t* g, const int32_t* t) {
  int64_t cf = ((int64_t)t[0] * f[0] + (int64_t)t[1] * g[0]) >> 30;
  int64_t cg = ((int64_t)t[2] * f[0] + (int64_t)t[3] * g[0]) >> 30;
  BLS_UNROLL
  for (int i = 1; i < GL; ++i) {
    const int32_t fi = f[i], gi = g[i];
    cf += (int64_t)t[0] * fi + (int64_t)t[1] * gi;
    cg += (int64_t)t[2] * fi + (int64_t)t[3] * gi;
    f[i - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g[i - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f[GL - 1] = (int32_t)cf;
  g[GL - 1] = (int32_t)cg;
}

// [d, e] <- (t [d, e] + p [md, me]) / 2^30 for d, e in (-2p, p), md and me
// chosen to clear the low 30 bits; the results stay in (-2p, p).
BLS_FN void gcd_update_de(int32_t* d, int32_t* e, const int32_t* t, const int32_t* p, uint32_t pinv30) {
  const int32_t sd = d[GL - 1] >> 31, se = e[GL - 1] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  int64_t cd = (int64_t)t[0] * d[0] + (int64_t)t[1] * e[0];
  int64_t ce = (int64_t)t[2] * d[0] + (int64_t)t[3] * e[0];
  md -= (int32_t)((pinv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((pinv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd = (cd + (int64_t)p[0] * md) >> 30;
  ce = (ce + (int64_t)p[0] * me) >> 30;
  BLS_UNROLL
  for (int i = 1; i < GL; ++i) {
    const int32_t di = d[i], ei = e[i];
    cd += (int64_t)t[0] * di + (int64_t)t[1] * ei + (int64_t)p[i] * md;
    ce += (int64_t)t[2] * di + (int64_t)t[3] * ei + (int64_t)p[i] * me;
    d[i - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e[i - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d[GL - 1] = (int32_t)cd;
  e[GL - 1] = (int32_t)ce;
}

// d in (-2p, p), negated when sign < 0, into [0, p).
BLS_FN void gcd_normalize(int32_t* d, int32_t sign, const int32_t* p) {
  int32_t c = d[GL - 1] >> 31;
  BLS_UNROLL
  for (int i = 0; i < GL; ++i) d[i] += p[i] & c;
  c = sign >> 31;
  BLS_UNROLL
  for (int i = 0; i < GL; ++i) d[i] = (d[i] ^ c) - c;
  BLS_UNROLL
  for (int i = 0; i < GL - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
  c = d[GL - 1] >> 31;
  BLS_UNROLL
  for (int i = 0; i < GL; ++i) d[i] += p[i] & c;
  BLS_UNROLL
  for (int i = 0; i < GL - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
}

// r = 1 / a in Montgomery form; 0 -> 0. Returns the batches run.
BLS_NOINLINE int fp_inv_gcd(Fp& r, const Fp& a) {
  int32_t d[GL], e[GL], f[GL], g[GL], p[GL], t[4];
  to_limbs30(p, c_bls.p);
  to_limbs30(g, a.v);
  to_limbs30(e, c_bls.r2);
  BLS_UNROLL
  for (int i = 0; i < GL; ++i) {
    f[i] = p[i];
    d[i] = 0;
  }
  // p^-1 mod 2^30 by Newton's iteration (p odd: p is its own inverse mod 8)
  uint32_t pinv = c_bls.p[0];
  for (int i = 0; i < 4; ++i) pinv *= 2u - c_bls.p[0] * pinv;
  int32_t eta = -1;
  int steps = 0;
  for (;;) {
    int32_t any = 0;
    BLS_UNROLL
    for (int i = 0; i < GL; ++i) any |= g[i];
    if (any == 0) break;
    ++steps;
    eta = divsteps30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    gcd_update_de(d, e, t, p, pinv);
    gcd_update_fg(f, g, t);
  }
  // f = +-1 unless a = 0 (then f = p and d = 0)
  gcd_normalize(d, f[GL - 1], p);
  from_limbs30(r.v, d);
  return steps;
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

// conj(a) * s, for s = 1 / norm(a): the inverse of a; 0 -> 0
BLS_FN void f2_conj_scale(Fp2& r, const Fp2& a, const Fp& s) {
  Fp t;
  fp_mul(r.c0, a.c0, s);
  fp_neg(t, a.c1);
  fp_mul(r.c1, t, s);
}

// conj(a) / norm(a); 0 -> 0
BLS_NOINLINE void f2_inv(Fp2& r, const Fp2& a) {
  Fp n, ni;
  f2_norm(n, a);
  fp_inv(ni, n);
  f2_conj_scale(r, a, ni);
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

}  // namespace bls
