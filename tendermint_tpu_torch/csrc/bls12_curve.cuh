// BLS12-381 curve arithmetic for the BLS kernels (bls12_kernels.cu):
// complete addition on G1 and G2, the SvdW map and the cofactor clear of
// hash-to-G2, the Miller loop and the final exponentiation of the pairing.
// One thread computes one row; each function below is that row's work.
//
// Points are homogeneous projective (X : Y : Z) on y^2 z = x^3 + b z^3,
// the identity (0 : 1 : 0), added by Renes-Costello-Batina 2015's
// complete formula (algorithm 7, a = 0), so identity, doubling and
// inverse inputs take the same straight line.
//
// The pairing is the JAX package's (ops/bls12.py), which fixes its value:
// the Miller loop is f_{|x|,Q}(P) over |x| = 0xd201000000010000 WITHOUT
// the conjugation other libraries apply for the negative x, with its
// lines scaled by Fp2 factors that the final exponentiation kills; the
// final exponentiation raises to 3 (p^12 - 1) / r through the chain
// (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 after the easy part, so a reduced
// pairing here is the oracle's cubed. The cofactor is the oracle's H2,
// the full G2 cofactor (not RFC 9380's h_eff).
#pragma once
#include "fp381.cuh"

namespace bls {

// -- field overloads, so that one complete addition serves G1 and G2 ----------

BLS_FN void fadd(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
BLS_FN void fadd(Fp2& r, const Fp2& a, const Fp2& b) { f2_add(r, a, b); }
BLS_FN void fsub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
BLS_FN void fsub(Fp2& r, const Fp2& a, const Fp2& b) { f2_sub(r, a, b); }
BLS_FN void fmul(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
BLS_FN void fmul(Fp2& r, const Fp2& a, const Fp2& b) { f2_mul(r, a, b); }

// 3b times a, by additions: 12 a on G1 (b = 4), 12 (1 + u) a on G2
// (b = 4 (1 + u)).
BLS_FN void mul_b3(Fp& r, const Fp& a) {
  Fp t4;
  fp_dbl(t4, a);
  fp_dbl(t4, t4);
  fp_dbl(r, t4);
  fp_add(r, r, t4);
}
BLS_FN void mul_b3(Fp2& r, const Fp2& a) {
  Fp2 t;
  f2_mul_xi(t, a);
  mul_b3(r.c0, t.c0);
  mul_b3(r.c1, t.c1);
}

template <class F>
struct Proj { F X, Y, Z; };

// (X1 : Y1 : Z1) + (X2 : Y2 : Z2) (RCB15 algorithm 7), 12 multiplications.
template <class F>
BLS_FN void complete_add(Proj<F>& r, const Proj<F>& p, const Proj<F>& q) {
  F t0, t1, t2, t3, t4, ty, s, u;
  fmul(t0, p.X, q.X);
  fmul(t1, p.Y, q.Y);
  fmul(t2, p.Z, q.Z);
  fadd(s, p.X, p.Y);
  fadd(u, q.X, q.Y);
  fmul(t3, s, u);
  fadd(s, t0, t1);
  fsub(t3, t3, s);  // X1 Y2 + X2 Y1
  fadd(s, p.Y, p.Z);
  fadd(u, q.Y, q.Z);
  fmul(t4, s, u);
  fadd(s, t1, t2);
  fsub(t4, t4, s);  // Y1 Z2 + Y2 Z1
  fadd(s, p.X, p.Z);
  fadd(u, q.X, q.Z);
  fmul(ty, s, u);
  fadd(s, t0, t2);
  fsub(ty, ty, s);  // X1 Z2 + X2 Z1
  fadd(s, t0, t0);
  fadd(t0, s, t0);  // 3 X1 X2
  mul_b3(t2, t2);
  mul_b3(ty, ty);
  F z3s, t1s;
  fadd(z3s, t1, t2);
  fsub(t1s, t1, t2);
  fmul(s, t3, t1s);
  fmul(u, t4, ty);
  fsub(r.X, s, u);
  fmul(s, t1s, z3s);
  fmul(u, ty, t0);
  fadd(r.Y, s, u);
  fmul(s, z3s, t4);
  fmul(u, t0, t3);
  fadd(r.Z, s, u);
}

BLS_NOINLINE void g1_add(Proj<Fp>& r, const Proj<Fp>& p, const Proj<Fp>& q) { complete_add(r, p, q); }

BLS_NOINLINE void g2_add(Proj<Fp2>& r, const Proj<Fp2>& p, const Proj<Fp2>& q) { complete_add(r, p, q); }

BLS_FN void g1_identity(Proj<Fp>& r) {
  fp_zero(r.X);
  fp_one(r.Y);
  fp_zero(r.Z);
}

BLS_FN void g2_identity(Proj<Fp2>& r) {
  f2_zero(r.X);
  f2_one(r.Y);
  f2_zero(r.Z);
}

// (X : Y : Z) -> affine (X/Z, Y/Z); true for the identity (Z = 0).
BLS_FN bool g1_normalize(Fp& x, Fp& y, const Proj<Fp>& p) {
  Fp zi;
  fp_inv(zi, p.Z);
  fp_mul(x, p.X, zi);
  fp_mul(y, p.Y, zi);
  return fp_is_zero(p.Z);
}

BLS_FN bool g2_normalize(Fp2& x, Fp2& y, const Proj<Fp2>& p) {
  Fp2 zi;
  f2_inv(zi, p.Z);
  f2_mul(x, p.X, zi);
  f2_mul(y, p.Y, zi);
  return f2_is_zero(p.Z);
}

// -- hash-to-G2: the SvdW map (RFC 9380 section 6.6.1) and [H2] ----------------

// g(x) = x^3 + 4(1 + u) on the twist
BLS_FN void g2_curve_g(Fp2& r, const Fp2& x) {
  Fp2 t, b;
  f2_sqr(t, x);
  f2_mul(t, t, x);
  f2_copy(b, c_bls.b2);
  f2_add(r, t, b);
}

// u -> a point of E'(Fp2), the straight line of ref_bls12.map_to_curve_svdw.
BLS_NOINLINE void svdw_map(Fp2& x, Fp2& y, const Fp2& u) {
  Fp2 c1, c2, c3, c4, z, one, tv1, tv2, tv3, tv5, t, x1, x2, x3, gx;
  f2_copy(c1, c_bls.svdw_c1);
  f2_copy(c2, c_bls.svdw_c2);
  f2_copy(c3, c_bls.svdw_c3);
  f2_copy(c4, c_bls.svdw_c4);
  f2_copy(z, c_bls.svdw_z);
  f2_one(one);
  f2_sqr(tv1, u);
  f2_mul(tv1, tv1, c1);
  f2_add(tv2, one, tv1);
  f2_sub(tv1, one, tv1);
  f2_mul(t, tv1, tv2);
  f2_inv(tv3, t);  // inv0: 0 -> 0 at the exceptional u
  f2_mul(tv5, u, tv1);
  f2_mul(tv5, tv5, tv3);
  f2_mul(tv5, tv5, c3);
  f2_sub(x1, c2, tv5);
  f2_add(x2, c2, tv5);
  f2_sqr(t, tv2);
  f2_mul(t, t, tv3);
  f2_sqr(t, t);
  f2_mul(t, t, c4);
  f2_add(x3, z, t);
  g2_curve_g(gx, x1);
  if (f2_is_square(gx)) {
    x = x1;
  } else {
    g2_curve_g(gx, x2);
    if (f2_is_square(gx)) {
      x = x2;
    } else {
      x = x3;
      g2_curve_g(gx, x3);
    }
  }
  f2_sqrt(y, gx);
  if (f2_sgn0(u) != f2_sgn0(y)) f2_neg(y, y);
}

// The whole tail of hash_to_curve_g2 for one row: two maps, their sum,
// times H2 (MSB first, complete additions), normalised. u0, u1, x, y
// are (2, 48) canonical bytes (c0 then c1); returns the identity flag.
BLS_NOINLINE bool map_to_g2_row(uint8_t* xo, uint8_t* yo, const uint8_t* u0b, const uint8_t* u1b) {
  Fp2 u, mx, my;
  Proj<Fp2> q, m1, acc;
  fp_from_bytes(u.c0, u0b);
  fp_from_bytes(u.c1, u0b + FP_BYTES);
  svdw_map(q.X, q.Y, u);
  f2_one(q.Z);
  fp_from_bytes(u.c0, u1b);
  fp_from_bytes(u.c1, u1b + FP_BYTES);
  svdw_map(m1.X, m1.Y, u);
  f2_one(m1.Z);
  g2_add(q, q, m1);
  g2_identity(acc);
  for (int i = (int)c_bls.h2_bits - 1; i >= 0; --i) {
    g2_add(acc, acc, acc);
    if ((c_bls.h2[i >> 5] >> (i & 31)) & 1) g2_add(acc, acc, q);
  }
  const bool inf = g2_normalize(mx, my, acc);
  fp_to_bytes(xo, mx.c0);
  fp_to_bytes(xo + FP_BYTES, mx.c1);
  fp_to_bytes(yo, my.c0);
  fp_to_bytes(yo + FP_BYTES, my.c1);
  return inf;
}

// -- the pairing ---------------------------------------------------------------

// The 3-sparse line (slots 1, v w and v^2 w of the Fp12 basis) as Fp12.
BLS_FN void line_to_f12(Fp12& l, const Fp2& s00, const Fp2& s11, const Fp2& s12) {
  f12_one(l);
  l.c0.c0 = s00;
  l.c1.c1 = s11;
  l.c1.c2 = s12;
}

// f_{|x|,Q}(P) over the twisted coordinates, with the tangent at T
//   [1] 2 Y Z^2 xi yP,  [v w] 3 X^3 - 2 Y^2 Z,  [v^2 w] -3 X^2 Z xP
// and the chord through T and Q (dx = X - xQ Z, dy = Y - yQ Z)
//   [1] xi dx yP,  [v w] dy xQ - dx yQ,  [v^2 w] -dy xP
// (ops/bls12.py miller_rows; both scaled by Fp2 factors).
BLS_NOINLINE void miller_loop(Fp12& f, const Fp2& qx, const Fp2& qy, const Fp& px, const Fp& py) {
  Proj<Fp2> T, Q;
  T.X = qx;
  T.Y = qy;
  f2_one(T.Z);
  Q = T;
  f12_one(f);
  Fp12 l;
  for (int i = 62; i >= 0; --i) {
    Fp2 xsq, ysq, zsq, m0, m1, m2, m3, s00, s11, s12, t;
    f2_sqr(xsq, T.X);
    f2_sqr(ysq, T.Y);
    f2_sqr(zsq, T.Z);
    f2_mul(m0, T.Y, zsq);
    f2_mul(m1, xsq, T.X);
    f2_mul(m2, ysq, T.Z);
    f2_mul(m3, xsq, T.Z);
    f2_dbl(t, m1);
    f2_add(s11, t, m1);
    f2_dbl(t, m2);
    f2_sub(s11, s11, t);  // 3 X^3 - 2 Y^2 Z
    f2_dbl(t, m0);
    f2_mul_xi(t, t);
    f2_mul_fp(s00, t, py);  // 2 Y Z^2 xi yP
    f2_dbl(t, m3);
    f2_add(t, t, m3);
    f2_neg(t, t);
    f2_mul_fp(s12, t, px);  // -3 X^2 Z xP
    line_to_f12(l, s00, s11, s12);
    f12_sqr(f, f);
    f12_mul(f, f, l);
    g2_add(T, T, T);
    if ((X_ABS >> i) & 1) {
      Fp2 dx, dy, u;
      f2_mul(t, qx, T.Z);
      f2_sub(dx, T.X, t);
      f2_mul(t, qy, T.Z);
      f2_sub(dy, T.Y, t);
      f2_mul(t, dy, qx);
      f2_mul(u, dx, qy);
      f2_sub(s11, t, u);
      f2_mul_xi(t, dx);
      f2_mul_fp(s00, t, py);
      f2_neg(t, dy);
      f2_mul_fp(s12, t, px);
      line_to_f12(l, s00, s11, s12);
      f12_mul(f, f, l);
      g2_add(T, T, Q);
    }
  }
}

// a^e for a 64-bit e with its top bit at `top` (MSB first).
BLS_NOINLINE void f12_pow_u64(Fp12& r, const Fp12& a, uint64_t e, int top) {
  Fp12 acc = a;
  for (int i = top - 1; i >= 0; --i) {
    f12_sqr(acc, acc);
    if ((e >> i) & 1) f12_mul(acc, acc, a);
  }
  r = acc;
}

// a^(-|e|) for a in the cyclotomic subgroup: the power, conjugated.
BLS_FN void cyc_pow_neg(Fp12& r, const Fp12& a, uint64_t e) {
  f12_pow_u64(r, a, e, 63);
  f12_conj(r, r);
}

// f^(3 (p^12 - 1) / r): the easy part (p^6 - 1)(p^2 + 1), then
// (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 (ops/bls12.py final_exponentiation).
BLS_NOINLINE void final_exponentiation(Fp12& r, const Fp12& f) {
  const uint64_t xm1 = X_ABS + 1;  // |x - 1|
  Fp12 t, m, t0, t1, t2, u;
  f12_conj(t, f);
  f12_inv(u, f);
  f12_mul(t, t, u);  // f^(p^6 - 1)
  f12_frobenius(u, t);
  f12_frobenius(u, u);
  f12_mul(m, u, t);  // ^(p^2 + 1)
  cyc_pow_neg(t0, m, xm1);   // m^(x - 1)
  cyc_pow_neg(t0, t0, xm1);  // m^((x - 1)^2)
  cyc_pow_neg(t1, t0, X_ABS);
  f12_frobenius(u, t0);
  f12_mul(t1, t1, u);        // ^(x + p)
  cyc_pow_neg(t2, t1, X_ABS);
  cyc_pow_neg(t2, t2, X_ABS);  // ^(x^2)
  f12_frobenius(u, t1);
  f12_frobenius(u, u);
  f12_mul(t2, t2, u);        // ^(+ p^2)
  f12_conj(u, t1);
  f12_mul(t2, t2, u);        // ^(- 1)
  f12_sqr(u, m);
  f12_mul(u, u, m);          // m^3
  f12_mul(r, t2, u);
}

// One row of the pairing check: e(pk, hm) e(-G1, sig) == 1, or with
// pairs == 1 the reduced pairing e(pk, hm) alone. pk (2, 48) bytes x, y;
// hm and sig (2, 2, 48) bytes x, y each c0, c1. Writes the reduced Fp12
// value as (2, 3, 2, 48) bytes and returns whether it is 1.
BLS_NOINLINE bool pairing_row(uint8_t* value, const uint8_t* pk, const uint8_t* hm, const uint8_t* sig, int pairs) {
  Fp px, py;
  Fp2 qx, qy;
  Fp12 f, g;
  fp_from_bytes(px, pk);
  fp_from_bytes(py, pk + FP_BYTES);
  fp_from_bytes(qx.c0, hm);
  fp_from_bytes(qx.c1, hm + FP_BYTES);
  fp_from_bytes(qy.c0, hm + 2 * FP_BYTES);
  fp_from_bytes(qy.c1, hm + 3 * FP_BYTES);
  miller_loop(f, qx, qy, px, py);
  if (pairs == 2) {
    fp_copy(px, c_bls.neg_g1[0]);
    fp_copy(py, c_bls.neg_g1[1]);
    fp_from_bytes(qx.c0, sig);
    fp_from_bytes(qx.c1, sig + FP_BYTES);
    fp_from_bytes(qy.c0, sig + 2 * FP_BYTES);
    fp_from_bytes(qy.c1, sig + 3 * FP_BYTES);
    miller_loop(g, qx, qy, px, py);
    f12_mul(f, f, g);
  }
  final_exponentiation(g, f);
  f12_to_bytes(value, g);
  return f12_is_one(g);
}

}  // namespace bls
