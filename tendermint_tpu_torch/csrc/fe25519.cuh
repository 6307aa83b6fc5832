// GF(2^255 - 19) for one element per thread.
//
// Counterpart of the JAX package's ops/field.py (20 limbs of 13 bits in
// int32, because the TPU's vector unit has no 64-bit integers) and of the
// port's plain ops/field.py. Layout: ref10's 10 signed limbs in radix
// 2^25.5 (limb i at bit ceil(25.5 i), 26 bits for even i, 25 for odd i),
// stored as int32.
//
// Why radix 2^25.5 and not 2^51: the card's integer multiplier is 32 bits
// wide. A 32x32->64 product with a 64-bit accumulate is one IMAD.WIDE, so
// a field multiplication is 100 of them and a column sum never leaves the
// register pair. Five 51-bit limbs would need 25 64x64->128 products,
// each built from four 32-bit multiplies plus the carries between them
// (__umul64hi or unsigned __int128), with no saving.
//
// Bounds: every stored limb is within +-(2^26 + 2^10). A product of a
// limb (doubled for odd*odd) and 19 times a limb is below 2^57.3, a column
// of ten below 2^61, so int64 columns never overflow; 19 * limb fits
// int32. fe_mul leaves limbs within that bound, and fe_add / fe_sub /
// fe_neg run one floor-carry pass (fe_weak), so sums never pile up across
// a formula.
//
// Squaring: ref10's 55 products (fe_sq). A square's column k is
// fe_mul(f, f)'s column k with the two equal terms f_i f_j and f_j f_i
// (i != j) taken once at twice the weight. Every term is an exact int64,
// and a partial sum never exceeds the sum of the absolute values of the
// column's terms in fe_mul, which is below 2^61 for limbs within the bound
// above; so the ten column sums are the same integers as fe_mul(f, f)'s,
// and the same carry chain turns them into the same limbs, for every input
// within the bound. A term's weight (1, 2 or 4 for the pair and the odd x
// odd factor, times 19 past 2^255) is split over its int32 operands as
// (1, 2 or 4) f_i times (1 or 19) f_j: 4 (2^26 + 2^10) and 19 (2^26 + 2^10)
// both fit int32.
//
// Inversion: Fermat's power z^(p-2) (fe_invert, 265 products in one
// chain) or a binary GCD (fe_inv_gcd, Bernstein-Yang divsteps on 30-bit
// limbs, at the end of this file).
//
// The kernel sources include these headers and every function is static,
// so each source keeps its own copy. Without nvcc (csrc/ed25519_host.cc,
// built with g++ for the tests) the same functions compile as host C++.
#pragma once
#include <stdint.h>

#include "divsteps.cuh"

#if defined(__CUDACC__)
#define TM_FN static __device__ __forceinline__
#define TM_CALL static __device__
#else
#define TM_FN static inline
#define TM_CALL static
#endif

struct alignas(8) fe {
  int32_t v[10];
};

TM_FN int fe_width(int i) { return (i & 1) ? 25 : 26; }

TM_FN void fe_set_small(fe& h, int32_t x) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = 0;
  h.v[0] = x;
}

TM_FN void fe_load_const(fe& h, const int32_t* c) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

// One sequential floor-carry pass on int32 limbs; the carry out of limb
// 9 re-enters limb 0 times 19 (2^255 = 19 mod p).
TM_FN void fe_weak(fe& h) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = fe_width(i);
    const int32_t c = h.v[i] >> w;
    h.v[i] &= (1 << w) - 1;
    h.v[i + 1] += c;
  }
  const int32_t c = h.v[9] >> 25;
  h.v[9] &= (1 << 25) - 1;
  h.v[0] += 19 * c;
}

TM_FN void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
  fe_weak(h);
}

TM_FN void fe_sub(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
  fe_weak(h);
}

TM_FN void fe_neg(fe& h, const fe& f) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = -f.v[i];
  fe_weak(h);
}

// Column sums -> limbs: floor carries in ref10's interleaved order (two
// chains for ILP).
TM_FN void fe_carry_columns(fe& h, int64_t t[10]) {
#define TM_CARRY(i)                                  \
  {                                                  \
    const int w = fe_width(i);                       \
    const int64_t c = t[i] >> w;                     \
    t[i] &= ((int64_t)1 << w) - 1;                   \
    if ((i) == 9) t[0] += 19 * c; else t[(i) + 1] += c; \
  }
  TM_CARRY(0) TM_CARRY(4) TM_CARRY(1) TM_CARRY(5) TM_CARRY(2) TM_CARRY(6)
  TM_CARRY(3) TM_CARRY(7) TM_CARRY(4) TM_CARRY(8) TM_CARRY(9) TM_CARRY(0)
#undef TM_CARRY
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = (int32_t)t[i];
}

// h = f * g. Column k sums f_i g_j over i + j = k (mod 10), times 2 when
// i and j are both odd and times 19 when i + j wraps past 10.
TM_FN void fe_mul(fe& h, const fe& f, const fe& g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    int64_t s = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int j = k - i;
      const int jj = j < 0 ? j + 10 : j;
      const int32_t gv = j < 0 ? g19[jj] : g.v[jj];
      const int32_t fv = (jj & 1) ? f2[i] : f.v[i];
      s += (int64_t)fv * (int64_t)gv;
    }
    t[k] = s;
  }
  fe_carry_columns(h, t);
}

// h = f^2 in 55 products, limb for limb fe_mul(h, f, f) (see the top).
TM_FN void fe_sq(fe& h, const fe& f) {
  int32_t f2[10], f4[10], f19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f4[i] = 4 * f.v[i];
    f19[i] = 19 * f.v[i];
  }
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int w = (i != j ? 2 : 1) * ((i & 1) && (j & 1) ? 2 : 1);
      const int32_t fl = w == 1 ? f.v[i] : (w == 2 ? f2[i] : f4[i]);
      const int32_t fr = i + j >= 10 ? f19[j] : f.v[j];
      t[(i + j) % 10] += (int64_t)fl * (int64_t)fr;
    }
  }
  fe_carry_columns(h, t);
}

TM_FN void fe_nsq(fe& h, const fe& f, int n) {
  h = f;
#pragma unroll 1
  for (int i = 0; i < n; i++) fe_sq(h, h);
}

// z^((p-5)/8) = z^(2^252 - 3), ref10's chain.
TM_CALL void fe_pow22523(fe& out, const fe& z) {
  fe t0, t1, t2;
  fe_sq(t0, z);
  fe_nsq(t1, t0, 2);
  fe_mul(t1, z, t1);
  fe_mul(t0, t0, t1);
  fe_sq(t0, t0);
  fe_mul(t0, t1, t0);
  fe_nsq(t1, t0, 5);
  fe_mul(t0, t1, t0);
  fe_nsq(t1, t0, 10);
  fe_mul(t1, t1, t0);
  fe_nsq(t2, t1, 20);
  fe_mul(t1, t2, t1);
  fe_nsq(t1, t1, 10);
  fe_mul(t0, t1, t0);
  fe_nsq(t1, t0, 50);
  fe_mul(t1, t1, t0);
  fe_nsq(t2, t1, 100);
  fe_mul(t1, t2, t1);
  fe_nsq(t1, t1, 50);
  fe_mul(t0, t1, t0);
  fe_nsq(t0, t0, 2);
  fe_mul(out, t0, z);
}

// z^(p-2) = z^(2^255 - 21); 0 maps to 0.
TM_CALL void fe_invert(fe& out, const fe& z) {
  fe t0, t1, t2, t3;
  fe_sq(t0, z);
  fe_nsq(t1, t0, 2);
  fe_mul(t1, z, t1);
  fe_mul(t0, t0, t1);
  fe_sq(t2, t0);
  fe_mul(t1, t1, t2);
  fe_nsq(t2, t1, 5);
  fe_mul(t1, t2, t1);
  fe_nsq(t2, t1, 10);
  fe_mul(t2, t2, t1);
  fe_nsq(t3, t2, 20);
  fe_mul(t2, t3, t2);
  fe_nsq(t2, t2, 10);
  fe_mul(t1, t2, t1);
  fe_nsq(t2, t1, 50);
  fe_mul(t2, t2, t1);
  fe_nsq(t3, t2, 100);
  fe_mul(t2, t3, t2);
  fe_nsq(t2, t2, 50);
  fe_mul(t1, t2, t1);
  fe_nsq(t1, t1, 5);
  fe_mul(out, t1, t0);
}

// The representative in [0, p), every limb in [0, 2^width): three
// sequential floor-carry chains bring the value into [0, 2^255), then
// V + 19 >= 2^255 says V >= p, and (V + 19) mod 2^255 = V - p.
TM_FN void fe_canonical(fe& h, const fe& f) {
  h = f;
#pragma unroll
  for (int r = 0; r < 3; r++) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int w = fe_width(i);
      const int32_t c = h.v[i] >> w;
      h.v[i] &= (1 << w) - 1;
      if (i < 9) h.v[i + 1] += c; else h.v[0] += 19 * c;
    }
  }
  fe t = h;
  t.v[0] += 19;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = fe_width(i);
    const int32_t c = t.v[i] >> w;
    t.v[i] &= (1 << w) - 1;
    t.v[i + 1] += c;
  }
  const bool ge_p = (t.v[9] >> 25) != 0;
  t.v[9] &= (1 << 25) - 1;
  if (ge_p) h = t;
}

TM_FN void fe_tobytes(uint8_t s[32], const fe& f) {
  fe h;
  fe_canonical(h, f);
  uint64_t acc = 0;  // bit buffer, low bits first
  int nbits = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)(uint32_t)h.v[i] << nbits;
    nbits += fe_width(i);
    while (nbits >= 8) {
      s[j++] = (uint8_t)(acc & 0xff);
      acc >>= 8;
      nbits -= 8;
    }
  }
  // 255 bits: the last 7 leave one partial byte
  s[31] = (uint8_t)(acc & 0xff);
}

// 32 little-endian bytes; bit 255 is masked, y >= p is kept (used mod p).
TM_FN void fe_frombytes(fe& h, const uint8_t* s) {
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int j = off[i] >> 3, sh = off[i] & 7;
    uint32_t w = (uint32_t)s[j] | ((uint32_t)s[j + 1] << 8) | ((uint32_t)s[j + 2] << 16);
    if (j + 3 < 32) w |= (uint32_t)s[j + 3] << 24;
    h.v[i] = (int32_t)((w >> sh) & ((1u << fe_width(i)) - 1));
  }
}

TM_FN bool fe_eq(const fe& f, const fe& g) {
  fe a, b;
  fe_canonical(a, f);
  fe_canonical(b, g);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 10; i++) eq &= a.v[i] == b.v[i];
  return eq;
}

TM_FN bool fe_iszero(const fe& f) {
  fe a;
  fe_canonical(a, f);
  bool z = true;
#pragma unroll
  for (int i = 0; i < 10; i++) z &= a.v[i] == 0;
  return z;
}

TM_FN bool fe_isneg(const fe& f) {
  fe a;
  fe_canonical(a, f);
  return a.v[0] & 1;
}

TM_FN void fe_cmov(fe& h, const fe& g, bool b) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = b ? g.v[i] : h.v[i];
}

TM_FN void store_fe(int32_t* dst, const fe& f) {
#pragma unroll
  for (int i = 0; i < 10; i++) dst[i] = f.v[i];
}

TM_FN void load_fe(fe& f, const int32_t* src) {
#pragma unroll
  for (int i = 0; i < 10; i++) f.v[i] = src[i];
}

// -- inversion by a binary GCD -------------------------------------------------
//
// Bernstein and Yang's safegcd for p = 2^255 - 19, as fp381.cuh's
// fp_inv_gcd is for the BLS field: batches of 30 divsteps on the low 32
// bits of f and g (divsteps.cuh), each batch's 2x2 matrix then applied to
// the full f, g and to the cofactors d, e mod p, all as 9 signed limbs of
// 30 bits (270 bits: the division by 2^30 is a shift by one limb). Started
// from f = p, g = y, d = 0, e = 1, the invariants d y = f, e y = g (mod p)
// end, when g = 0, with f = +-1 and d = +-1 / y. No Montgomery factor: the
// ed25519 limbs have none. 0 maps to 0 (g = 0 from the start leaves d = 0),
// as fe_invert and the plain field.invert map it. y comes in through
// fe_canonical, so non-canonical limbs (y >= p, limbs over their width)
// are taken mod p; the inverse goes out canonical.
//
// The loop runs in variable time (divsteps30) until g = 0: a point's
// encoding is public (a function of the key, the message and the
// signature). safegcd's bound for the original divstep, floor((49 * 255 +
// 80) / 17) = 739 divsteps, caps it at 25 batches.

constexpr int FL = 9;                      // 30-bit limbs of the GCD's values
constexpr uint32_t kPinv30 = 0x179435e5u;  // p^-1 mod 2^30

// Limb i of p in 30-bit limbs: 2^30 - 19, seven 2^30 - 1, then 2^15 - 1.
TM_FN int32_t fe_p30(int i) { return i == 0 ? M30 - 18 : (i == FL - 1 ? 0x7fff : M30); }

// A canonical value (fe_canonical's limbs) -> 9 x 30-bit limbs.
TM_FN void fe_to_limbs30(int32_t* r, const fe& h) {
  uint64_t acc = 0;
  int nbits = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)(uint32_t)h.v[i] << nbits;
    nbits += fe_width(i);
    if (nbits >= 30) {
      r[j++] = (int32_t)(acc & M30);
      acc >>= 30;
      nbits -= 30;
    }
  }
  r[FL - 1] = (int32_t)acc;  // the top 15 bits
}

// 9 x 30-bit limbs of a value in [0, 2^255) -> canonical limbs.
TM_FN void fe_from_limbs30(fe& h, const int32_t* r) {
  uint64_t acc = 0;
  int nbits = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int w = fe_width(i);
    if (nbits < w) {
      acc |= (uint64_t)(uint32_t)r[j++] << nbits;
      nbits += 30;
    }
    h.v[i] = (int32_t)(acc & ((1u << w) - 1));
    acc >>= w;
    nbits -= w;
  }
}

// [f, g] <- t [f, g] / 2^30 (exact): limbs 0..7 in [0, 2^30), 8 signed.
TM_FN void fe_gcd_update_fg(int32_t* f, int32_t* g, const int32_t* t) {
  int64_t cf = ((int64_t)t[0] * f[0] + (int64_t)t[1] * g[0]) >> 30;
  int64_t cg = ((int64_t)t[2] * f[0] + (int64_t)t[3] * g[0]) >> 30;
#pragma unroll
  for (int i = 1; i < FL; ++i) {
    const int32_t fi = f[i], gi = g[i];
    cf += (int64_t)t[0] * fi + (int64_t)t[1] * gi;
    cg += (int64_t)t[2] * fi + (int64_t)t[3] * gi;
    f[i - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g[i - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f[FL - 1] = (int32_t)cf;
  g[FL - 1] = (int32_t)cg;
}

// [d, e] <- (t [d, e] + p [md, me]) / 2^30 for d, e in (-2p, p), md and me
// chosen to clear the low 30 bits; the results stay in (-2p, p).
TM_FN void fe_gcd_update_de(int32_t* d, int32_t* e, const int32_t* t) {
  const int32_t sd = d[FL - 1] >> 31, se = e[FL - 1] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  int64_t cd = (int64_t)t[0] * d[0] + (int64_t)t[1] * e[0];
  int64_t ce = (int64_t)t[2] * d[0] + (int64_t)t[3] * e[0];
  md -= (int32_t)((kPinv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((kPinv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd = (cd + (int64_t)fe_p30(0) * md) >> 30;
  ce = (ce + (int64_t)fe_p30(0) * me) >> 30;
#pragma unroll
  for (int i = 1; i < FL; ++i) {
    const int32_t di = d[i], ei = e[i];
    cd += (int64_t)t[0] * di + (int64_t)t[1] * ei + (int64_t)fe_p30(i) * md;
    ce += (int64_t)t[2] * di + (int64_t)t[3] * ei + (int64_t)fe_p30(i) * me;
    d[i - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e[i - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d[FL - 1] = (int32_t)cd;
  e[FL - 1] = (int32_t)ce;
}

// d in (-2p, p), negated when sign < 0, into [0, p).
TM_FN void fe_gcd_normalize(int32_t* d, int32_t sign) {
  int32_t c = d[FL - 1] >> 31;
#pragma unroll
  for (int i = 0; i < FL; ++i) d[i] += fe_p30(i) & c;
  c = sign >> 31;
#pragma unroll
  for (int i = 0; i < FL; ++i) d[i] = (d[i] ^ c) - c;
#pragma unroll
  for (int i = 0; i < FL - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
  c = d[FL - 1] >> 31;
#pragma unroll
  for (int i = 0; i < FL; ++i) d[i] += fe_p30(i) & c;
#pragma unroll
  for (int i = 0; i < FL - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
}

// out = 1 / z, canonical; 0 -> 0. Returns the batches run.
TM_CALL int fe_inv_gcd(fe& out, const fe& z) {
  fe c;
  fe_canonical(c, z);
  int32_t d[FL], e[FL], f[FL], g[FL], t[4];
  fe_to_limbs30(g, c);
#pragma unroll
  for (int i = 0; i < FL; ++i) {
    f[i] = fe_p30(i);
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t eta = -1;
  int steps = 0;
#pragma unroll 1
  for (;;) {
    int32_t any = 0;
#pragma unroll
    for (int i = 0; i < FL; ++i) any |= g[i];
    if (any == 0) break;
    ++steps;
    eta = divsteps30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    fe_gcd_update_de(d, e, t);
    fe_gcd_update_fg(f, g, t);
  }
  // f = +-1 unless z = 0 (then f = p and d = 0)
  fe_gcd_normalize(d, f[FL - 1]);
  fe_from_limbs30(out, d);
  return steps;
}
