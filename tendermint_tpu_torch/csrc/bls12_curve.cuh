// BLS12-381 curve arithmetic for the BLS kernels (bls12_kernels.cu).
//
// A row (one pairing check, or one hash-to-G2 tail) is worked by G lanes:
// a group of one warp, or a block of warps. Each tower operation is cut
// into the independent Fp products it contains; a stage writes their
// operands into the row's shared buffers (oa, ob), the lanes take the
// products in turn (mul_stage: one fp_mul a product, 12 limbs in
// registers), and the next stage combines them. `par` runs one stage: on
// the device each lane its share of the items, then the row's sync
// (__syncwarp over its lanes, or __syncthreads); on the host
// (csrc/bls12_host.cc) every lane's share in turn, which computes the same
// values because no item of a stage reads what another item of it writes.
// Control flow is the row's own and the same on all its lanes (every
// branch reads shared values after a stage's sync).
//
// The pairing is the JAX package's (ops/bls12.py), which fixes its value:
// the Miller loop is f_{|x|,Q}(P) over |x| = 0xd201000000010000 WITHOUT
// the conjugation other libraries apply for the negative x, with its
// lines scaled by Fp2 factors that the final exponentiation kills; the
// final exponentiation raises to 3 (p^12 - 1) / r through the chain
// (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 after the easy part, so a reduced
// pairing here is the oracle's cubed. What this file does differently,
// with the same reduced value: one Miller loop shared by the two pairs of
// a check (f squared once, then each pair's line); projective doubling
// and mixed addition steps (Aranha et al., Eurocrypt 2011; the tangent
// is the JAX package's divided by Z); each line multiplied into f as a
// sparse product on the slots it fills (1, v w, v^2 w); f squared by the
// complex method; after the easy part, Granger-Scott cyclotomic squares.
//
// hash-to-G2's tail is the oracle's clear_cofactor_g2(map(u0) + map(u1))
// with the full cofactor H2 (not RFC 9380's h_eff): the two SvdW maps one
// a lane (their powers on up to six lanes), their sum, then [H2] over its
// non-adjacent form by Jacobian doublings and mixed additions (exceptional
// sums handled, so the result is the complete formula's), normalised to
// affine: three inversions or roots in sequence and one inversion.
//
// The G1 sum of bls12_g1_aggregate: complete additions (Renes-Costello-
// Batina 2015, algorithms 7 and 8, a = 0) in two stages of six products on
// a group of lanes, a row's points spread over blocks, one inversion by a
// binary GCD (fp381.cuh) at the end.
#pragma once
#include "fp381.cuh"
#include "lanes.cuh"

namespace bls {

// -- a row's lanes (lanes.cuh) -----------------------------------------------------

using ::Lanes;
using ::par;

// -- G1: the aggregate's sum on a group of lanes -----------------------------------
//
// Complete additions (Renes-Costello-Batina 2015, algorithm 7, a = 0) on
// homogeneous projective points, the identity (0 : 1 : 0), cut into two
// stages of six independent products with additions between them, on a
// group of G lanes (as a pairing row's stages). Affine operands take the
// mixed form (algorithm 8, Z2 = 1: 11 products), the same values as
// algorithm 7 with Z2 = 1. Complete: coincident points, a point and its
// negation and the identity take no special path.

// 3b times a, by additions: 12 a (b = 4).
BLS_FN void mul_b3(Fp& r, const Fp& a) {
  Fp t4;
  fp_dbl(t4, a);
  fp_dbl(t4, t4);
  fp_dbl(r, t4);
  fp_add(r, r, t4);
}

template <class F>
struct Proj { F X, Y, Z; };

// A group's state in shared memory: its running sum, each stage's products.
struct G1Group {
  Proj<Fp> acc;
  Fp s[6];  // stage one: X1 X2, Y1 Y2, Z1 Z2 and the three cross products
  Fp u[6];  // stage two
};

// g.acc <- g.acc + q, q = (X, Y, Z) at q[0..2]; `mixed`: q affine (q[2] is
// not read). Three stages: the six products of the inputs (five and a
// copy when mixed), the six products of their sums, X3 Y3 Z3. No item of
// a stage reads what another writes: stage two reads s (and, mixed, X1
// Y1 of acc), stage three reads u and writes acc.
BLS_NOINLINE void g1_add_stages(const Lanes& L, G1Group& g, const Fp* q, bool mixed) {
  const Fp* P = &g.acc.X;
  par(L, 6, [&](int i) {
    Fp a, b;
    if (i < 3) {
      if (mixed && i == 2) {  // Z1 Z2 = Z1
        g.s[2] = P[2];
        return;
      }
      a = P[i];
      b = q[i];
    } else if (i == 3) {  // (X1 + Y1)(X2 + Y2)
      fp_add(a, P[0], P[1]);
      fp_add(b, q[0], q[1]);
    } else {  // i = 4: (Y1 + Z1)(Y2 + Z2) or Z1 Y2; i = 5: (X1 + Z1)(X2 + Z2) or Z1 X2
      const int c = i == 4 ? 1 : 0;
      if (mixed) {
        a = P[2];
        b = q[c];
      } else {
        fp_add(a, P[c], P[2]);
        fp_add(b, q[c], q[2]);
      }
    }
    Fp r;
    fp_mul(r, a, b);
    g.s[i] = r;
  });
  // the sums: t3 = X1 Y2 + X2 Y1, t4 = Y1 Z2 + Y2 Z1, ty = X1 Z2 + X2 Z1,
  // then 3 t0, 3b t2, 3b ty; item k of stage two multiplies terms
  // (t3, t1 - 3b t2), (t4, 3b ty), (t1 - 3b t2, t1 + 3b t2), (3b ty, 3 t0),
  // (t1 + 3b t2, t4), (3 t0, t3)
  par(L, 6, [&](int i) {
    auto term = [&](int k, Fp& r) {
      Fp t, w;
      switch (k) {
        case 0:  // t3
          fp_add(t, g.s[0], g.s[1]);
          fp_sub(r, g.s[3], t);
          break;
        case 1:  // t4
          if (mixed) {
            fp_add(r, g.s[4], P[1]);
          } else {
            fp_add(t, g.s[1], g.s[2]);
            fp_sub(r, g.s[4], t);
          }
          break;
        case 2:  // 3b ty
          if (mixed) {
            fp_add(t, g.s[5], P[0]);
          } else {
            fp_add(w, g.s[0], g.s[2]);
            fp_sub(t, g.s[5], w);
          }
          mul_b3(r, t);
          break;
        case 3:  // 3 t0
          fp_dbl(t, g.s[0]);
          fp_add(r, t, g.s[0]);
          break;
        case 4:  // t1 - 3b t2
          mul_b3(t, g.s[2]);
          fp_sub(r, g.s[1], t);
          break;
        default:  // t1 + 3b t2
          mul_b3(t, g.s[2]);
          fp_add(r, g.s[1], t);
          break;
      }
    };
    Fp a, b, r;
    term((0x352410 >> (4 * i)) & 15, a);  // 0, 1, 4, 2, 5, 3
    term((0x013524 >> (4 * i)) & 15, b);  // 4, 2, 5, 3, 1, 0
    fp_mul(r, a, b);
    g.u[i] = r;
  });
  // X3 = t3 (t1 - 3b t2) - t4 3b ty, Y3 = (t1 - 3b t2)(t1 + 3b t2) + 3b ty 3 t0,
  // Z3 = (t1 + 3b t2) t4 + 3 t0 t3
  par(L, 3, [&](int i) {
    Fp r;
    if (i == 0)
      fp_sub(r, g.u[0], g.u[1]);
    else
      fp_add(r, g.u[2 * i], g.u[2 * i + 1]);
    (&g.acc.X)[i] = r;
  });
}

// g.acc <- q (Z = 1 when `affine`).
BLS_FN void g1_set(const Lanes& L, G1Group& g, const Fp* q, bool affine) {
  par(L, 3, [&](int i) {
    if (affine && i == 2)
      fp_one(g.acc.Z);
    else
      (&g.acc.X)[i] = q[i];
  });
}

// -- the aggregate's work, step by step (bls12_g1_aggregate) -----------------------
//
// A batch row's points are cut into chunks of CHUNK, a block of 128
// threads a chunk, G lanes a group (K = 128 / G groups). A block packs a
// round of up to 128 selected points (affine, Montgomery form) into shared
// memory, one a thread; group k adds up points k, k + K, ... of the
// round into its running sum (the first one taken as it is); the groups'
// sums are added in a tree; the block's sum goes to its slot of the
// scratch (36 words, the identity if it selected nothing). The last block
// of the row to finish (a counter per row) adds up the row's partial sums
// the same way and normalises: x = X / Z, y = Y / Z by one inversion
// (fp_inv_gcd); the identity (Z = 0) gives zeros and its flag. Each step
// runs a group at a time, between the block's barriers; the host build
// (bls12_host.cc) runs the groups in turn.

constexpr int kAggThreads = 128;
constexpr int kAggWords = 3 * NL;  // a projective partial sum

template <int K>
struct AggBlock {
  G1Group grp[K];
  Fp pts[kAggThreads][2];  // a round's points; then each group's loaded partial
  int have[K];             // whether group k's sum holds a point
  int wsel[kAggThreads / 32];
  int last;
};

template <int K>
BLS_FN Proj<Fp>& agg_partial_slot(AggBlock<K>& S, int k) {
  static_assert(K * sizeof(Proj<Fp>) <= sizeof(S.pts), "the partials' slots fit the points' room");
  return reinterpret_cast<Proj<Fp>*>(&S.pts[0][0])[k];
}

// Group k's share of a round of n packed points.
BLS_FN void agg_sum_points(const Lanes& L, G1Group& g, const Fp (*pts)[2], int k, int n, int stride, bool& have) {
  for (int j = k; j < n; j += stride) {
    if (have) {
      g1_add_stages(L, g, pts[j], true);
    } else {
      g1_set(L, g, pts[j], true);
      have = true;
    }
  }
}

BLS_FN uint32_t agg_load(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);  // another block's write: read it from L2
#else
  return *p;
#endif
}

// Group k's share of the row's n partial sums (36 words each), through
// its slot q.
BLS_FN void agg_sum_partials(const Lanes& L, G1Group& g, Proj<Fp>& q, const uint32_t* part, int k, int n,
                             int stride, bool& have) {
  for (int j = k; j < n; j += stride) {
    par(L, kAggWords, [&](int w) { (&q.X)[w / NL].v[w % NL] = agg_load(part + (size_t)kAggWords * j + w); });
    if (fp_is_zero(q.Z)) continue;  // an identity partial
    if (have) {
      g1_add_stages(L, g, &q.X, false);
    } else {
      g1_set(L, g, &q.X, false);
      have = true;
    }
  }
}

// One level of the tree: group k < s adds group k + s's sum into its own.
BLS_FN void agg_tree_step(const Lanes& L, G1Group* grp, int* have, int k, int s) {
  if (k >= s || !have[k + s]) return;
  if (have[k])
    g1_add_stages(L, grp[k], &grp[k + s].acc.X, false);
  else
    g1_set(L, grp[k], &grp[k + s].acc.X, false);
  if (L.lane == 0) have[k] = 1;
}

// Word w of a block's partial: group 0's sum, or the identity.
BLS_FN uint32_t agg_partial_word(const G1Group& g, bool have, int w) {
  if (have) return (&g.acc.X)[w / NL].v[w % NL];
  return w / NL == 1 ? c_bls.one[w % NL] : 0u;
}

// The row's sum in affine form: out (2, 48), *inf; one thread.
BLS_FN void agg_finish(uint8_t* out, uint8_t* inf, const G1Group& g, bool have) {
  Fp zi, x, y;
  if (have) {
    fp_inv_gcd(zi, g.acc.Z);
    fp_mul(x, g.acc.X, zi);
    fp_mul(y, g.acc.Y, zi);
  } else {
    fp_zero(x);
    fp_zero(y);
  }
  fp_to_bytes(out, x);
  fp_to_bytes(out + FP_BYTES, y);
  *inf = !have || fp_is_zero(g.acc.Z) ? 1 : 0;
}

// oa[i] = oa[i] * ob[i] for i < n: the only Fp products of a stage.
BLS_NOINLINE void mul_stage(const Lanes& L, Fp* oa, const Fp* ob, int n) {
  par(L, n, [&](int i) {
    const Fp a = oa[i], b = ob[i];
    Fp r;
    fp_mul(r, a, b);
    oa[i] = r;
  });
}

// An Fp2 product as Fp products in the slots o.. of (oa, ob): x y takes
// three (Karatsuba), x^2 two, x s (s in Fp) two.
BLS_FN void put_mul(Fp* oa, Fp* ob, int o, const Fp2& x, const Fp2& y) {
  oa[o] = x.c0;
  ob[o] = y.c0;
  oa[o + 1] = x.c1;
  ob[o + 1] = y.c1;
  fp_add(oa[o + 2], x.c0, x.c1);
  fp_add(ob[o + 2], y.c0, y.c1);
}

BLS_FN void put_sqr(Fp* oa, Fp* ob, int o, const Fp2& x) {
  fp_add(oa[o], x.c0, x.c1);
  fp_sub(ob[o], x.c0, x.c1);
  oa[o + 1] = x.c0;
  ob[o + 1] = x.c1;
}

BLS_FN void put_fp(Fp* oa, Fp* ob, int o, const Fp2& x, const Fp& s) {
  oa[o] = x.c0;
  ob[o] = s;
  oa[o + 1] = x.c1;
  ob[o + 1] = s;
}

BLS_FN void get_mul(Fp2& r, const Fp* P, int o) {
  Fp t;
  fp_add(t, P[o], P[o + 1]);
  fp_sub(r.c0, P[o], P[o + 1]);
  fp_sub(r.c1, P[o + 2], t);
}

BLS_FN void get_sqr(Fp2& r, const Fp* P, int o) {
  r.c0 = P[o];
  fp_dbl(r.c1, P[o + 1]);
}

BLS_FN void get_fp(Fp2& r, const Fp* P, int o) {
  r.c0 = P[o];
  r.c1 = P[o + 1];
}

BLS_FN void f2_scale3(Fp2& r, const Fp2& a) {
  Fp2 t;
  f2_dbl(t, a);
  f2_add(r, t, a);
}

// n Fp2 products x_j y_j, op(j, x, y) giving the operands: three stages;
// the products land in ((Fp2*)ob)[j].
template <class Op>
BLS_FN void f2_products(const Lanes& L, Fp* oa, Fp* ob, int n, Op op) {
  par(L, n, [&](int j) {
    Fp2 x, y;
    op(j, x, y);
    put_mul(oa, ob, 3 * j, x, y);
  });
  mul_stage(L, oa, ob, 3 * n);
  par(L, n, [&](int j) {
    Fp2 r;
    get_mul(r, oa, 3 * j);
    reinterpret_cast<Fp2*>(ob)[j] = r;
  });
}

// Karatsuba term t of an Fp6 operand (coefficients through get(i, v)):
// c0, c1, c2, c1 + c2, c0 + c2, c0 + c1.
template <class Get>
BLS_FN void k6_term(Fp2& x, int t, Get get) {
  if (t < 3) {
    get(t, x);
    return;
  }
  Fp2 a, b;
  get(t == 3 ? 1 : 0, a);
  get(t == 5 ? 1 : 2, b);
  f2_add(x, a, b);
}

// Coefficient i of an Fp6 Karatsuba product from its six Fp2 products
// (ref_bls12.f6_mul's value).
BLS_FN void k6_out(Fp2& r, const Fp2* P, int i) {
  Fp2 t;
  if (i == 0) {  // a0 b0 + xi (a1 b2 + a2 b1)
    f2_sub(t, P[3], P[1]);
    f2_sub(t, t, P[2]);
    f2_mul_xi(t, t);
    f2_add(r, t, P[0]);
  } else if (i == 1) {  // a0 b1 + a1 b0 + xi a2 b2
    f2_sub(t, P[5], P[0]);
    f2_sub(t, t, P[1]);
    Fp2 c;
    f2_mul_xi(c, P[2]);
    f2_add(r, t, c);
  } else {  // a0 b2 + a1 b1 + a2 b0
    f2_sub(t, P[4], P[0]);
    f2_add(t, t, P[1]);
    f2_sub(r, t, P[2]);
  }
}

// k Fp6 products, op(q, t, x, y) giving Karatsuba term t of product q;
// the products land in ((Fp2*)oa)[3q + i].
template <class Op>
BLS_FN void f6_products(const Lanes& L, Fp* oa, Fp* ob, int k, Op op) {
  f2_products(L, oa, ob, 6 * k, [&](int j, Fp2& x, Fp2& y) { op(j / 6, j % 6, x, y); });
  par(L, 3 * k, [&](int j) {
    Fp2 r;
    k6_out(r, reinterpret_cast<const Fp2*>(ob) + 6 * (j / 3), j % 3);
    reinterpret_cast<Fp2*>(oa)[j] = r;
  });
}

// -- Fp12 on a row's lanes (an Fp12 is 6 Fp2: c0 over v^0..v^2, then c1) ----------

// (v y)[i] for an Fp6 y: v (y0, y1, y2) = (xi y2, y0, y1)
BLS_FN void v_coeff(Fp2& r, const Fp2* y, int i) {
  if (i == 0)
    f2_mul_xi(r, y[2]);
  else
    r = y[i - 1];
}

// r = a b (Karatsuba over Fp6); r may be a or b.
BLS_NOINLINE void f12_mul(const Lanes& L, Fp* oa, Fp* ob, Fp2* r, const Fp2* a, const Fp2* b) {
  f6_products(L, oa, ob, 3, [&](int q, int t, Fp2& x, Fp2& y) {
    k6_term(x, t, [&](int i, Fp2& v) {
      if (q < 2)
        v = a[3 * q + i];
      else
        f2_add(v, a[i], a[3 + i]);
    });
    k6_term(y, t, [&](int i, Fp2& v) {
      if (q < 2)
        v = b[3 * q + i];
      else
        f2_add(v, b[i], b[3 + i]);
    });
  });
  const Fp2* R = reinterpret_cast<const Fp2*>(oa);  // a0 b0, a1 b1, (a0 + a1)(b0 + b1)
  par(L, 6, [&](int c) {
    const int i = c % 3;
    Fp2 v, t;
    if (c < 3) {  // a0 b0 + v a1 b1
      v_coeff(t, R + 3, i);
      f2_add(v, R[i], t);
    } else {
      f2_sub(v, R[6 + i], R[i]);
      f2_sub(v, v, R[3 + i]);
    }
    r[c] = v;
  });
}

// r = a^2 by the complex method: c0' = (c0 + c1)(c0 + v c1) - t - v t,
// c1' = 2 t, t = c0 c1.
BLS_NOINLINE void f12_sqr(const Lanes& L, Fp* oa, Fp* ob, Fp2* r, const Fp2* a) {
  f6_products(L, oa, ob, 2, [&](int q, int t, Fp2& x, Fp2& y) {
    k6_term(x, t, [&](int i, Fp2& v) {
      if (q == 0)
        v = a[i];
      else
        f2_add(v, a[i], a[3 + i]);
    });
    k6_term(y, t, [&](int i, Fp2& v) {
      if (q == 0) {
        v = a[3 + i];
      } else {
        Fp2 s;
        v_coeff(s, a + 3, i);
        f2_add(v, a[i], s);
      }
    });
  });
  const Fp2* R = reinterpret_cast<const Fp2*>(oa);  // t, then (c0 + c1)(c0 + v c1)
  par(L, 6, [&](int c) {
    const int i = c % 3;
    Fp2 v, s;
    if (c < 3) {
      f2_sub(v, R[3 + i], R[i]);
      v_coeff(s, R, i);
      f2_sub(v, v, s);
    } else {
      f2_dbl(v, R[i]);
    }
    r[c] = v;
  });
}

// r = a^2 for a in the cyclotomic subgroup (Granger-Scott): three Fp4
// squares of the pairs (a0, a4), (a3, a2), (a1, a5), 9 Fp2 squares.
BLS_NOINLINE void cyc_sqr(const Lanes& L, Fp* oa, Fp* ob, Fp2* r, const Fp2* a) {
  // the pair s of output c, and of square j
  auto first = [](int s) { return s == 0 ? 0 : (s == 1 ? 3 : 1); };
  auto second = [](int s) { return s == 0 ? 4 : (s == 1 ? 2 : 5); };
  par(L, 9, [&](int j) {
    const int s = j / 3, k = j % 3;
    Fp2 x;
    if (k == 0)
      x = a[first(s)];
    else if (k == 1)
      x = a[second(s)];
    else
      f2_add(x, a[first(s)], a[second(s)]);
    put_sqr(oa, ob, 2 * j, x);
  });
  mul_stage(L, oa, ob, 18);
  par(L, 6, [&](int c) {
    const int s = (c == 0 || c == 4) ? 0 : ((c == 1 || c == 5) ? 1 : 2);
    Fp2 t0, t1, v;
    get_sqr(t0, oa, 6 * s);
    get_sqr(t1, oa, 6 * s + 2);
    if (c < 3) {  // 3 (t0 + xi t1) - 2 z
      f2_mul_xi(v, t1);
      f2_add(v, v, t0);
    } else {  // 3 ((x + y)^2 - t0 - t1) + 2 z, times xi for z2
      get_sqr(v, oa, 6 * s + 4);
      f2_sub(v, v, t0);
      f2_sub(v, v, t1);
      if (c == 3) f2_mul_xi(v, v);
    }
    Fp2 z2;
    f2_scale3(v, v);
    f2_dbl(z2, a[c]);
    if (c < 3)
      f2_sub(v, v, z2);
    else
      f2_add(v, v, z2);
    r[c] = v;
  });
}

// r = a^p: conjugate each Fp2 coefficient, times the structure constants
// (the first is 1).
BLS_NOINLINE void f12_frobenius(const Lanes& L, Fp* oa, Fp* ob, Fp2* r, const Fp2* a) {
  f2_products(L, oa, ob, 5, [&](int j, Fp2& x, Fp2& y) {
    const int c = j + 1;
    f2_conj(x, a[c]);
    f2_copy(y, c < 3 ? c_bls.frob_v[c] : c_bls.frob_vw[c - 3]);
  });
  const Fp2* P = reinterpret_cast<const Fp2*>(ob);
  par(L, 6, [&](int c) {
    Fp2 v;
    if (c == 0)
      f2_conj(v, a[0]);
    else
      v = P[c - 1];
    r[c] = v;
  });
}

BLS_NOINLINE void f12_conj(const Lanes& L, Fp2* r, const Fp2* a) {
  par(L, 6, [&](int c) {
    Fp2 v;
    if (c < 3)
      v = a[c];
    else
      f2_neg(v, a[c]);
    r[c] = v;
  });
}

// -- the pairing --------------------------------------------------------------------

constexpr int MAXP = 54;  // Fp products in one stage of a pairing row

struct MillerState {
  Fp2 T[2][3];   // X, Y, Z of each pair's point
  Fp2 Q[2][2];   // each pair's affine Q
  Fp P[2][2];    // each pair's affine P
  Fp2 l[2][3];   // each pair's line: slots 1, v w, v^2 w
  Fp2 d[2][8];   // a step's intermediates
};

struct FinalState {
  Fp2 t[6], m[6], t0[6], t1[6], t2[6], u[6], x[6], acc[6], base[6];
  Fp2 d[3], c[3], e;
};

struct PairRow {
  Fp2 f[6];
  union {
    MillerState ml;
    FinalState fe;
  };
  Fp oa[MAXP], ob[MAXP];
};

// The tangent at each T, and T doubled (homogeneous projective, scaled
// by 4): with A = X Y, B = Y^2, C = Z^2, J = X^2, H = 2 Y Z, E = 3 b' C,
// F = 3 E: X' = 2 A (B - F), Y' = (B + F)^2 - 12 E^2, Z' = 4 B H, and the
// line [1] xi H yP, [v w] B - E, [v^2 w] -3 J xP (the JAX package's
// tangent divided by Z).
BLS_NOINLINE void dbl_step(const Lanes& L, PairRow& R, int np) {
  MillerState& S = R.ml;
  par(L, 5 * np, [&](int j) {
    const int k = j / 5, w = j % 5, o = 11 * k;
    const Fp2* T = S.T[k];
    if (w == 0) {
      put_mul(R.oa, R.ob, o, T[0], T[1]);
    } else if (w < 4) {
      put_sqr(R.oa, R.ob, o + 1 + 2 * w, T[w == 1 ? 1 : (w == 2 ? 2 : 0)]);
    } else {
      Fp2 s;
      f2_add(s, T[1], T[2]);
      put_sqr(R.oa, R.ob, o + 9, s);
    }
  });
  mul_stage(L, R.oa, R.ob, 11 * np);
  par(L, 5 * np, [&](int j) {  // d: A, B, C, J, (Y + Z)^2
    const int k = j / 5, w = j % 5, o = 11 * k;
    Fp2 v;
    if (w == 0)
      get_mul(v, R.oa, o);
    else
      get_sqr(v, R.oa, o + 1 + 2 * w);
    S.d[k][w] = v;
  });
  // E = 12 xi C (b' = 4 xi), F = 3 E, H = (Y + Z)^2 - B - C
  auto efh = [&](int k, Fp2& e, Fp2& f, Fp2& h) {
    const Fp2* d = S.d[k];
    f2_mul_xi(e, d[2]);
    f2_scale3(e, e);
    f2_dbl(e, e);
    f2_dbl(e, e);
    f2_scale3(f, e);
    f2_sub(h, d[4], d[1]);
    f2_sub(h, h, d[2]);
  };
  par(L, 6 * np, [&](int j) {
    const int k = j / 6, w = j % 6, o = 14 * k;
    const Fp2* d = S.d[k];
    Fp2 e, f, h, s;
    efh(k, e, f, h);
    switch (w) {
      case 0: f2_sub(s, d[1], f); put_mul(R.oa, R.ob, o, d[0], s); break;
      case 1: put_mul(R.oa, R.ob, o + 3, d[1], h); break;
      case 2: f2_add(s, d[1], f); put_sqr(R.oa, R.ob, o + 6, s); break;
      case 3: put_sqr(R.oa, R.ob, o + 8, e); break;
      case 4: put_fp(R.oa, R.ob, o + 10, h, S.P[k][1]); break;
      default: put_fp(R.oa, R.ob, o + 12, d[3], S.P[k][0]); break;
    }
  });
  mul_stage(L, R.oa, R.ob, 14 * np);
  par(L, 6 * np, [&](int j) {
    const int k = j / 6, w = j % 6, o = 14 * k;
    Fp2 v, t;
    switch (w) {
      case 0: get_mul(v, R.oa, o); f2_dbl(v, v); S.T[k][0] = v; break;
      case 1: get_mul(v, R.oa, o + 3); f2_dbl(v, v); f2_dbl(v, v); S.T[k][2] = v; break;
      case 2:
        get_sqr(t, R.oa, o + 8);  // 12 E^2
        f2_scale3(t, t);
        f2_dbl(t, t);
        f2_dbl(t, t);
        get_sqr(v, R.oa, o + 6);
        f2_sub(v, v, t);
        S.T[k][1] = v;
        break;
      case 3: get_fp(v, R.oa, o + 10); f2_mul_xi(v, v); S.l[k][0] = v; break;
      case 4: {
        Fp2 e, f, h;
        efh(k, e, f, h);
        f2_sub(v, S.d[k][1], e);
        S.l[k][1] = v;
        break;
      }
      default: get_fp(v, R.oa, o + 12); f2_scale3(v, v); f2_neg(v, v); S.l[k][2] = v; break;
    }
  });
}

// The chord through each T and Q, and T + Q (Q affine; T never equals
// +-Q in the loop): with dy = Y - yQ Z, dx = X - xQ Z, C = dy^2, D = dx^2,
// E = dx D, G = X D, H = E + Z C - 2 G: X' = dx H, Y' = dy (G - H) - Y E,
// Z' = Z E, and the line [1] xi dx yP, [v w] dy xQ - dx yQ, [v^2 w]
// -dy xP (the JAX package's chord).
BLS_NOINLINE void add_step(const Lanes& L, PairRow& R, int np) {
  MillerState& S = R.ml;
  f2_products(L, R.oa, R.ob, 2 * np, [&](int j, Fp2& x, Fp2& y) {  // yQ Z, xQ Z
    const int k = j / 2;
    x = S.Q[k][1 - j % 2];
    y = S.T[k][2];
  });
  par(L, 2 * np, [&](int j) {  // d: dy, dx
    const int k = j / 2, w = j % 2;
    Fp2 v;
    f2_sub(v, S.T[k][1 - w], reinterpret_cast<const Fp2*>(R.ob)[j]);
    S.d[k][w] = v;
  });
  par(L, 6 * np, [&](int j) {
    const int k = j / 6, w = j % 6, o = 14 * k;
    const Fp2* d = S.d[k];
    Fp2 s;
    switch (w) {
      case 0: put_sqr(R.oa, R.ob, o, d[0]); break;
      case 1: put_sqr(R.oa, R.ob, o + 2, d[1]); break;
      case 2: put_mul(R.oa, R.ob, o + 4, d[0], S.Q[k][0]); break;
      case 3: put_mul(R.oa, R.ob, o + 7, d[1], S.Q[k][1]); break;
      case 4: f2_mul_xi(s, d[1]); put_fp(R.oa, R.ob, o + 10, s, S.P[k][1]); break;
      default: put_fp(R.oa, R.ob, o + 12, d[0], S.P[k][0]); break;
    }
  });
  mul_stage(L, R.oa, R.ob, 14 * np);
  par(L, 5 * np, [&](int j) {  // d: C, D; the line
    const int k = j / 5, w = j % 5, o = 14 * k;
    Fp2 v, t;
    switch (w) {
      case 0: get_sqr(v, R.oa, o); S.d[k][2] = v; break;
      case 1: get_sqr(v, R.oa, o + 2); S.d[k][3] = v; break;
      case 2: get_fp(v, R.oa, o + 10); S.l[k][0] = v; break;
      case 3: get_mul(v, R.oa, o + 4); get_mul(t, R.oa, o + 7); f2_sub(v, v, t); S.l[k][1] = v; break;
      default: get_fp(v, R.oa, o + 12); f2_neg(v, v); S.l[k][2] = v; break;
    }
  });
  f2_products(L, R.oa, R.ob, 3 * np, [&](int j, Fp2& x, Fp2& y) {  // E = dx D, Z C, G = X D
    const int k = j / 3, w = j % 3;
    const Fp2* d = S.d[k];
    x = w == 0 ? d[1] : S.T[k][w == 1 ? 2 : 0];
    y = w == 1 ? d[2] : d[3];
  });
  par(L, 3 * np, [&](int j) {  // d: E, G, H
    const int k = j / 3, w = j % 3;
    const Fp2* P = reinterpret_cast<const Fp2*>(R.ob) + 3 * k;
    Fp2 v;
    if (w < 2) {
      v = P[w == 0 ? 0 : 2];
    } else {
      f2_add(v, P[0], P[1]);
      Fp2 g2;
      f2_dbl(g2, P[2]);
      f2_sub(v, v, g2);
    }
    S.d[k][4 + w] = v;
  });
  f2_products(L, R.oa, R.ob, 4 * np, [&](int j, Fp2& x, Fp2& y) {  // dx H, dy (G - H), Y E, Z E
    const int k = j / 4, w = j % 4;
    const Fp2* d = S.d[k];
    switch (w) {
      case 0: x = d[1]; y = d[6]; break;
      case 1: x = d[0]; f2_sub(y, d[5], d[6]); break;
      case 2: x = S.T[k][1]; y = d[4]; break;
      default: x = S.T[k][2]; y = d[4]; break;
    }
  });
  par(L, 3 * np, [&](int j) {
    const int k = j / 3, w = j % 3;
    const Fp2* P = reinterpret_cast<const Fp2*>(R.ob) + 4 * k;
    Fp2 v;
    if (w == 0)
      v = P[0];
    else if (w == 1)
      f2_sub(v, P[1], P[2]);
    else
      v = P[3];
    S.T[k][w] = v;
  });
}

// f = f l for the line l = s00 + s11 v w + s12 v^2 w, schoolbook on its
// three slots: 18 Fp2 products, three a coefficient of f l (term 0 is
// f_c s00; terms 1 and 2 below, some times xi).
BLS_FN void line_term(int c, int k, int& fi, int& si, bool& xi) {
  // nibble c of each word, c = 0..5: term 1's f and s, term 2's f and s
  constexpr uint32_t f1 = 0x001343, s1 = 0x212122, f2 = 0x122554, s2 = 0x121211;
  if (k == 0) {
    fi = c;
    si = 0;
    xi = false;
  } else {
    fi = ((k == 1 ? f1 : f2) >> (4 * c)) & 15;
    si = ((k == 1 ? s1 : s2) >> (4 * c)) & 15;
    xi = k == 1 ? (c == 0 || c == 1 || c == 3) : c != 5;
  }
}

BLS_NOINLINE void line_mul(const Lanes& L, PairRow& R, const Fp2* l) {
  f2_products(L, R.oa, R.ob, 18, [&](int j, Fp2& x, Fp2& y) {
    int fi, si;
    bool xi;
    line_term(j / 3, j % 3, fi, si, xi);
    x = R.f[fi];
    y = l[si];
  });
  const Fp2* P = reinterpret_cast<const Fp2*>(R.ob);
  par(L, 6, [&](int c) {
    Fp2 v = P[3 * c];
    for (int k = 1; k < 3; ++k) {
      int fi, si;
      bool xi;
      line_term(c, k, fi, si, xi);
      Fp2 t;
      if (xi)
        f2_mul_xi(t, P[3 * c + k]);
      else
        t = P[3 * c + k];
      f2_add(v, v, t);
    }
    R.f[c] = v;
  });
}

// f = the product of the pairs' Miller values, one loop over |x|.
BLS_NOINLINE void miller_loop(const Lanes& L, PairRow& R, int np) {
  MillerState& S = R.ml;
  par(L, 6 + 3 * np, [&](int j) {
    if (j < 6) {
      if (j == 0)
        f2_one(R.f[0]);
      else
        f2_zero(R.f[j]);
    } else {
      const int k = (j - 6) / 3, w = (j - 6) % 3;
      if (w < 2)
        S.T[k][w] = S.Q[k][w];
      else
        f2_one(S.T[k][2]);
    }
  });
  for (int i = 62; i >= 0; --i) {
    if (i < 62) f12_sqr(L, R.oa, R.ob, R.f, R.f);
    dbl_step(L, R, np);
    for (int k = 0; k < np; ++k) line_mul(L, R, S.l[k]);
    if ((X_ABS >> i) & 1) {
      add_step(L, R, np);
      for (int k = 0; k < np; ++k) line_mul(L, R, S.l[k]);
    }
  }
}

// r = a^-1 through the Fp6 norm a0^2 - v a1^2 and its inverse.
BLS_NOINLINE void f12_inv(const Lanes& L, PairRow& R, Fp2* r, const Fp2* a) {
  FinalState& S = R.fe;
  const Fp2* R2 = reinterpret_cast<const Fp2*>(R.oa);
  const Fp2* P = reinterpret_cast<const Fp2*>(R.ob);
  f6_products(L, R.oa, R.ob, 2, [&](int q, int t, Fp2& x, Fp2& y) {
    k6_term(x, t, [&](int i, Fp2& v) { v = a[3 * q + i]; });
    y = x;
  });
  par(L, 3, [&](int i) {  // d = a0^2 - v a1^2
    Fp2 s, v;
    v_coeff(s, R2 + 3, i);
    f2_sub(v, R2[i], s);
    S.d[i] = v;
  });
  // the Fp6 inverse of d: c0 = d0^2 - xi d1 d2, c1 = xi d2^2 - d0 d1,
  // c2 = d1^2 - d0 d2, over e = xi (d2 c1 + d1 c2) + d0 c0
  f2_products(L, R.oa, R.ob, 6, [&](int j, Fp2& x, Fp2& y) {
    // d0 d0, d1 d2, d2 d2, d0 d1, d1 d1, d0 d2 (nibble j)
    x = S.d[(0x010210u >> (4 * j)) & 15];
    y = S.d[(0x211220u >> (4 * j)) & 15];
  });
  par(L, 3, [&](int i) {
    Fp2 v, t;
    if (i == 0) {
      f2_mul_xi(t, P[1]);
      f2_sub(v, P[0], t);
    } else if (i == 1) {
      f2_mul_xi(t, P[2]);
      f2_sub(v, t, P[3]);
    } else {
      f2_sub(v, P[4], P[5]);
    }
    S.c[i] = v;
  });
  f2_products(L, R.oa, R.ob, 3, [&](int j, Fp2& x, Fp2& y) {
    x = S.d[2 - j];
    y = S.c[j == 0 ? 1 : (j == 1 ? 2 : 0)];
  });
  par(L, 1, [&](int) {  // one lane: e and its inverse
    Fp2 e, t;
    f2_add(t, P[0], P[1]);
    f2_mul_xi(t, t);
    f2_add(e, t, P[2]);
    f2_inv(t, e);
    S.e = t;
  });
  f2_products(L, R.oa, R.ob, 3, [&](int j, Fp2& x, Fp2& y) {
    x = S.c[j];
    y = S.e;
  });
  par(L, 3, [&](int i) { S.c[i] = P[i]; });  // d^-1
  f6_products(L, R.oa, R.ob, 2, [&](int q, int t, Fp2& x, Fp2& y) {
    k6_term(x, t, [&](int i, Fp2& v) { v = a[3 * q + i]; });
    k6_term(y, t, [&](int i, Fp2& v) { v = S.c[i]; });
  });
  par(L, 6, [&](int c) {
    Fp2 v;
    if (c < 3)
      v = R2[c];
    else
      f2_neg(v, R2[c]);
    r[c] = v;
  });
}

// r = a^(-|e|) for a in the cyclotomic subgroup: the power (MSB first,
// top bit 63), conjugated.
BLS_NOINLINE void cyc_pow_neg(const Lanes& L, PairRow& R, Fp2* r, const Fp2* a, uint64_t e) {
  FinalState& S = R.fe;
  par(L, 6, [&](int c) {
    S.base[c] = a[c];
    S.acc[c] = a[c];
  });
  for (int i = 62; i >= 0; --i) {
    cyc_sqr(L, R.oa, R.ob, S.acc, S.acc);
    if ((e >> i) & 1) f12_mul(L, R.oa, R.ob, S.acc, S.acc, S.base);
  }
  f12_conj(L, r, S.acc);
}

// f = f^(3 (p^12 - 1) / r): the easy part (p^6 - 1)(p^2 + 1), then
// (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 (ops/bls12.py final_exponentiation).
BLS_NOINLINE void final_exponentiation(const Lanes& L, PairRow& R) {
  FinalState& S = R.fe;
  Fp* oa = R.oa;
  Fp* ob = R.ob;
  const uint64_t xm1 = X_ABS + 1;  // |x - 1|
  f12_conj(L, S.t, R.f);
  f12_inv(L, R, S.x, R.f);
  f12_mul(L, oa, ob, S.t, S.t, S.x);  // f^(p^6 - 1)
  f12_frobenius(L, oa, ob, S.u, S.t);
  f12_frobenius(L, oa, ob, S.u, S.u);
  f12_mul(L, oa, ob, S.m, S.u, S.t);  // ^(p^2 + 1)
  cyc_pow_neg(L, R, S.t0, S.m, xm1);   // m^(x - 1)
  cyc_pow_neg(L, R, S.t0, S.t0, xm1);  // m^((x - 1)^2)
  cyc_pow_neg(L, R, S.t1, S.t0, X_ABS);
  f12_frobenius(L, oa, ob, S.u, S.t0);
  f12_mul(L, oa, ob, S.t1, S.t1, S.u);  // ^(x + p)
  cyc_pow_neg(L, R, S.t2, S.t1, X_ABS);
  cyc_pow_neg(L, R, S.t2, S.t2, X_ABS);  // ^(x^2)
  f12_frobenius(L, oa, ob, S.u, S.t1);
  f12_frobenius(L, oa, ob, S.u, S.u);
  f12_mul(L, oa, ob, S.t2, S.t2, S.u);  // ^(+ p^2)
  f12_conj(L, S.u, S.t1);
  f12_mul(L, oa, ob, S.t2, S.t2, S.u);  // ^(- 1)
  cyc_sqr(L, oa, ob, S.u, S.m);
  f12_mul(L, oa, ob, S.u, S.u, S.m);  // m^3
  f12_mul(L, oa, ob, R.f, S.t2, S.u);
}

BLS_FN bool f12_is_one(const Fp2* a) {
  bool one = fp_is_one(a[0].c0) && fp_is_zero(a[0].c1);
  for (int c = 1; c < 6; ++c) one = one && f2_is_zero(a[c]);
  return one;
}

// One row of the pairing check: e(pk, hm) e(-G1, sig) == 1, or with
// pairs == 1 the reduced pairing e(pk, hm) alone. pk (2, 48) bytes x, y;
// hm and sig (2, 2, 48) bytes x, y each c0, c1. Writes the reduced Fp12
// value as (2, 3, 2, 48) bytes (the JAX package's coefficient order: over
// w, then v^0..v^2, then u) and returns whether it is 1.
BLS_NOINLINE bool pairing_row(const Lanes& L, PairRow& R, uint8_t* value, const uint8_t* pk, const uint8_t* hm,
                              const uint8_t* sig, int pairs) {
  MillerState& S = R.ml;
  par(L, 6 * pairs, [&](int j) {
    const int k = j / 6, w = j % 6;
    if (w < 2) {
      if (k == 0)
        fp_from_bytes(S.P[0][w], pk + w * FP_BYTES);
      else
        fp_copy(S.P[1][w], c_bls.neg_g1[w]);
    } else {
      const uint8_t* q = (k == 0 ? hm : sig) + (w - 2) * FP_BYTES;
      Fp2& c = S.Q[k][(w - 2) / 2];
      fp_from_bytes(w % 2 == 0 ? c.c0 : c.c1, q);
    }
  });
  miller_loop(L, R, pairs);
  final_exponentiation(L, R);
  par(L, 12, [&](int j) {
    const Fp2& c = R.f[j / 2];
    fp_to_bytes(value + j * FP_BYTES, j % 2 == 0 ? c.c0 : c.c1);
  });
  return f12_is_one(R.f);
}

// -- hash-to-G2's tail -----------------------------------------------------------------

constexpr int MAP_MAXP = 8;  // Fp products in one stage of a map row

struct MapRow {
  Fp2 u[2], tv1[2], tv2[2], t[2], x[2][3], gx[2][3], y[2];
  Fp n[2], N[2][3], s[2][3], delta[2][2], c[2][2];
  uint32_t sq[2][3];
  Fp2 qx, qy[2];     // the base: affine on the accumulator's curve; qy[1] = -qy[0]
  Fp2 X, Y, Z;       // the Jacobian accumulator
  Fp2 zq;            // the base's Z on the twist (see map_to_g2_row)
  Fp2 d[8];
  uint32_t inf;
  Fp oa[MAP_MAXP], ob[MAP_MAXP];
};

// g(x) = x^3 + 4(1 + u) on the twist
BLS_FN void g2_curve_g(Fp2& r, const Fp2& x) {
  Fp2 t, b;
  f2_sqr(t, x);
  f2_mul(t, t, x);
  f2_copy(b, c_bls.b2);
  f2_add(r, t, b);
}

// Two SvdW maps (RFC 9380 section 6.6.1, the straight line of
// ref_bls12.map_to_curve_svdw), one a lane: (x, y) of u[m] into x[m][0],
// y[m]. Three powers in sequence, each on several lanes at once: the
// inversion; s = N^((p+1)/4) for the norm N of each g(x_k), whose square
// is N exactly when g(x_k) is a square in Fp2 (the oracle's criterion);
// then y = sqrt(g(x)) from s: of delta = (g0 +- s) / 2 one is a square,
// and c = delta^((p-3)/4) gives both its root c delta and the root's
// inverse c. The root's sign is then fixed by sgn0(u), so y is the
// oracle's whichever root a square root algorithm returns.
BLS_NOINLINE void svdw_maps(const Lanes& L, MapRow& R) {
  par(L, 2, [&](int m) {
    Fp2 c1, one, tv1, tv2, t;
    f2_copy(c1, c_bls.svdw_c1);
    f2_one(one);
    f2_sqr(tv1, R.u[m]);
    f2_mul(tv1, tv1, c1);
    f2_add(tv2, one, tv1);
    f2_sub(tv1, one, tv1);
    f2_mul(t, tv1, tv2);
    R.tv1[m] = tv1;
    R.tv2[m] = tv2;
    R.t[m] = t;
    f2_norm(R.n[m], t);
  });
  par(L, 2, [&](int m) {  // the inversion, inv0 at the exceptional u
    Fp ni;
    fp_inv(ni, R.n[m]);
    R.n[m] = ni;
  });
  par(L, 2, [&](int m) {
    Fp2 c2, c3, c4, z, tv3, tv5, t;
    f2_copy(c2, c_bls.svdw_c2);
    f2_copy(c3, c_bls.svdw_c3);
    f2_copy(c4, c_bls.svdw_c4);
    f2_copy(z, c_bls.svdw_z);
    f2_conj_scale(tv3, R.t[m], R.n[m]);
    f2_mul(tv5, R.u[m], R.tv1[m]);
    f2_mul(tv5, tv5, tv3);
    f2_mul(tv5, tv5, c3);
    f2_sub(R.x[m][0], c2, tv5);
    f2_add(R.x[m][1], c2, tv5);
    f2_sqr(t, R.tv2[m]);
    f2_mul(t, t, tv3);
    f2_sqr(t, t);
    f2_mul(t, t, c4);
    f2_add(R.x[m][2], z, t);
    for (int k = 0; k < 3; ++k) {
      g2_curve_g(R.gx[m][k], R.x[m][k]);
      f2_norm(R.N[m][k], R.gx[m][k]);
    }
  });
  par(L, 6, [&](int j) {  // s = N^((p+1)/4); g(x_k) is a square iff s^2 = N
    const int m = j / 3, k = j % 3;
    Fp s, t;
    fp_sqrt_cand(s, R.N[m][k]);
    fp_sqr(t, s);
    R.s[m][k] = s;
    R.sq[m][k] = fp_eq(t, R.N[m][k]) ? 1u : 0u;
  });
  par(L, 2, [&](int m) {  // x = x1 if g(x1) is a square, else x2 if g(x2) is, else x3; delta
    const int k = R.sq[m][0] ? 0 : (R.sq[m][1] ? 1 : 2);
    R.x[m][0] = R.x[m][k];
    R.gx[m][0] = R.gx[m][k];
    Fp inv2, t;
    fp_copy(inv2, c_bls.inv2);
    fp_add(t, R.gx[m][k].c0, R.s[m][k]);
    fp_mul(R.delta[m][0], t, inv2);
    fp_sub(t, R.gx[m][k].c0, R.s[m][k]);
    fp_mul(R.delta[m][1], t, inv2);
  });
  par(L, 4, [&](int j) {  // c = delta^((p-3)/4) for both deltas
    const int m = j / 2, k = j % 2;
    uint32_t e[NL];
    for (int i = 0; i < NL; ++i) e[i] = c_bls.e_sqrt[i];
    e[0] -= 1;  // (p+1)/4 - 1; its low word is not 0
    fp_pow(R.c[m][k], R.delta[m][k], e, 32 * NL);
  });
  par(L, 2, [&](int m) {
    const Fp2& a = R.gx[m][0];
    Fp2 y;
    if (fp_is_zero(a.c1)) {  // g(x) in Fp: the oracle's root of it
      f2_sqrt(y, a);
    } else {  // the delta with c^2 delta = 1: y = (c delta, g1 c / 2)
      Fp t, inv2;
      fp_sqr(t, R.c[m][0]);
      fp_mul(t, t, R.delta[m][0]);
      const int k = fp_is_one(t) ? 0 : 1;
      fp_mul(y.c0, R.c[m][k], R.delta[m][k]);
      fp_copy(inv2, c_bls.inv2);
      fp_mul(t, a.c1, R.c[m][k]);
      fp_mul(y.c1, t, inv2);
    }
    if (f2_sgn0(R.u[m]) != f2_sgn0(y)) f2_neg(y, y);
    R.y[m] = y;
  });
}

// acc = 2 acc (Jacobian, a = 0: dbl-2009-l), 2 m2 + 5 s2.
BLS_NOINLINE void jac_dbl(const Lanes& L, MapRow& R) {
  par(L, 3, [&](int j) {  // X^2, Y^2, Y Z
    if (j == 0)
      put_sqr(R.oa, R.ob, 0, R.X);
    else if (j == 1)
      put_sqr(R.oa, R.ob, 2, R.Y);
    else
      put_mul(R.oa, R.ob, 4, R.Y, R.Z);
  });
  mul_stage(L, R.oa, R.ob, 7);
  par(L, 3, [&](int j) {  // d: A, B; Z' = 2 Y Z
    Fp2 v;
    if (j < 2) {
      get_sqr(v, R.oa, 2 * j);
      R.d[j] = v;
    } else {
      get_mul(v, R.oa, 4);
      f2_dbl(R.Z, v);
    }
  });
  par(L, 3, [&](int j) {  // C = B^2, (X + B)^2, F = (3 A)^2
    Fp2 v;
    if (j == 0)
      v = R.d[1];
    else if (j == 1)
      f2_add(v, R.X, R.d[1]);
    else
      f2_scale3(v, R.d[0]);
    put_sqr(R.oa, R.ob, 2 * j, v);
  });
  mul_stage(L, R.oa, R.ob, 6);
  par(L, 2, [&](int j) {  // D = 2 ((X + B)^2 - A - C); X' = F - 2 D; d: C, D
    Fp2 c, v, dd;
    get_sqr(c, R.oa, 0);
    get_sqr(v, R.oa, 2);
    f2_sub(v, v, R.d[0]);
    f2_sub(v, v, c);
    f2_dbl(dd, v);
    if (j == 0) {
      get_sqr(v, R.oa, 4);
      Fp2 d2;
      f2_dbl(d2, dd);
      f2_sub(R.X, v, d2);
    } else {
      R.d[2] = c;
      R.d[3] = dd;
    }
  });
  f2_products(L, R.oa, R.ob, 1, [&](int, Fp2& x, Fp2& y) {  // E (D - X')
    f2_scale3(x, R.d[0]);
    f2_sub(y, R.d[3], R.X);
  });
  par(L, 1, [&](int) {  // Y' = E (D - X') - 8 C
    Fp2 c8;
    f2_dbl(c8, R.d[2]);
    f2_dbl(c8, c8);
    f2_dbl(c8, c8);
    f2_sub(R.Y, reinterpret_cast<const Fp2*>(R.ob)[0], c8);
  });
}

// acc = acc + (qx, qy[neg]) (madd-2007-bl), 7 m2 + 4 s2; the identity,
// equal and opposite points handled as the complete formula would.
BLS_NOINLINE void jac_madd(const Lanes& L, MapRow& R, int neg) {
  if (f2_is_zero(R.Z)) {
    par(L, 3, [&](int j) {
      if (j == 0)
        R.X = R.qx;
      else if (j == 1)
        R.Y = R.qy[neg];
      else
        f2_one(R.Z);
    });
    return;
  }
  par(L, 2, [&](int j) {  // Z^2, y2 Z
    if (j == 0)
      put_sqr(R.oa, R.ob, 0, R.Z);
    else
      put_mul(R.oa, R.ob, 2, R.qy[neg], R.Z);
  });
  mul_stage(L, R.oa, R.ob, 5);
  par(L, 2, [&](int j) {  // d: ZZ, y2 Z
    Fp2 v;
    if (j == 0)
      get_sqr(v, R.oa, 0);
    else
      get_mul(v, R.oa, 2);
    R.d[j] = v;
  });
  f2_products(L, R.oa, R.ob, 2, [&](int j, Fp2& x, Fp2& y) {  // U2 = x2 ZZ, S2 = y2 Z ZZ
    x = j == 0 ? R.qx : R.d[1];
    y = R.d[0];
  });
  par(L, 2, [&](int j) {  // d: H = U2 - X, r = 2 (S2 - Y)
    const Fp2* P = reinterpret_cast<const Fp2*>(R.ob);
    Fp2 v;
    if (j == 0) {
      f2_sub(v, P[0], R.X);
    } else {
      f2_sub(v, P[1], R.Y);
      f2_dbl(v, v);
    }
    R.d[2 + j] = v;
  });
  if (f2_is_zero(R.d[2])) {
    if (f2_is_zero(R.d[3])) {
      jac_dbl(L, R);
    } else {
      par(L, 1, [&](int) {
        f2_one(R.X);
        f2_one(R.Y);
        f2_zero(R.Z);
      });
    }
    return;
  }
  par(L, 3, [&](int j) {  // H^2, (Z + H)^2, r^2
    Fp2 v;
    if (j == 0)
      v = R.d[2];
    else if (j == 1)
      f2_add(v, R.Z, R.d[2]);
    else
      v = R.d[3];
    put_sqr(R.oa, R.ob, 2 * j, v);
  });
  mul_stage(L, R.oa, R.ob, 6);
  par(L, 3, [&](int j) {  // d: I = 4 HH, r^2; Z' = (Z + H)^2 - ZZ - HH
    Fp2 hh, v;
    get_sqr(hh, R.oa, 0);
    if (j == 0) {
      f2_dbl(v, hh);
      f2_dbl(R.d[4], v);
    } else if (j == 1) {
      get_sqr(v, R.oa, 2);
      f2_sub(v, v, R.d[0]);
      f2_sub(R.Z, v, hh);
    } else {
      get_sqr(R.d[5], R.oa, 4);
    }
  });
  f2_products(L, R.oa, R.ob, 2, [&](int j, Fp2& x, Fp2& y) {  // J = H I, V = X I
    x = j == 0 ? R.d[2] : R.X;
    y = R.d[4];
  });
  par(L, 2, [&](int j) {  // X' = r^2 - J - 2 V; d: J, V
    const Fp2* P = reinterpret_cast<const Fp2*>(R.ob);
    if (j == 0) {
      Fp2 v, v2;
      f2_sub(v, R.d[5], P[0]);
      f2_dbl(v2, P[1]);
      f2_sub(R.X, v, v2);
    } else {
      R.d[6] = P[0];
      R.d[7] = P[1];
    }
  });
  f2_products(L, R.oa, R.ob, 2, [&](int j, Fp2& x, Fp2& y) {  // r (V - X'), Y J
    if (j == 0) {
      x = R.d[3];
      f2_sub(y, R.d[7], R.X);
    } else {
      x = R.Y;
      y = R.d[6];
    }
  });
  par(L, 1, [&](int) {  // Y' = r (V - X') - 2 Y J
    const Fp2* P = reinterpret_cast<const Fp2*>(R.ob);
    Fp2 t;
    f2_dbl(t, P[1]);
    f2_sub(R.Y, P[0], t);
  });
}

// The whole tail of hash_to_curve_g2 for one row: two maps, their sum,
// times H2 over its NAF, normalised. u0, u1, x, y are (2, 48) canonical
// bytes (c0 then c1); returns the identity flag.
BLS_NOINLINE bool map_to_g2_row(const Lanes& L, MapRow& R, uint8_t* xo, uint8_t* yo, const uint8_t* u0b,
                                const uint8_t* u1b) {
  par(L, 4, [&](int j) {
    Fp2& u = R.u[j / 2];
    fp_from_bytes(j % 2 == 0 ? u.c0 : u.c1, (j < 2 ? u0b : u1b) + (j % 2) * FP_BYTES);
  });
  svdw_maps(L, R);
  // Q = map(u0) + map(u1) in Jacobian coordinates (X : Y : Z), by the
  // accumulator's mixed addition (its exceptional cases included). For
  // Z != 0 the ladder then runs on y^2 = x^3 + b' Z^6, where Q is the
  // affine (X, Y) ((x, y) -> (Z^2 x, Z^3 y) is an isomorphism; the
  // formulas do not read b'), and its result is brought back by Z.
  par(L, 1, [&](int) {
    R.X = R.x[0][0];
    R.Y = R.y[0];
    f2_one(R.Z);
    R.qx = R.x[1][0];
    R.qy[0] = R.y[1];
  });
  jac_madd(L, R, 0);
  par(L, 1, [&](int) {
    R.inf = f2_is_zero(R.Z) ? 1u : 0u;
    R.zq = R.Z;
    R.qx = R.X;
    R.qy[0] = R.Y;
    f2_neg(R.qy[1], R.Y);
    f2_one(R.Z);
  });
  if (!R.inf) {
    // H2 = pos - neg, the NAF's digits as two masks (xh = H2 / 2, x3 = H2 + xh,
    // c = xh ^ x3: pos = x3 & c, neg = xh & c); the top digit is +1
    constexpr int W = 17;
    uint32_t pos[W], neg[W];
    uint32_t carry = 0;
    for (int i = 0; i < W; ++i) {
      const uint32_t x = i < 16 ? c_bls.h2[i] : 0;
      const uint32_t xn = i + 1 < 16 ? c_bls.h2[i + 1] : 0;
      const uint32_t xh = (x >> 1) | (xn << 31);
      const uint64_t s = (uint64_t)x + xh + carry;
      const uint32_t x3 = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
      pos[i] = x3 & (xh ^ x3);
      neg[i] = xh & (xh ^ x3);
    }
    int top = 32 * W - 1;
    while (!((pos[top >> 5] >> (top & 31)) & 1)) --top;
    for (int i = top - 1; i >= 0; --i) {
      jac_dbl(L, R);
      if ((pos[i >> 5] >> (i & 31)) & 1) jac_madd(L, R, 0);
      if ((neg[i >> 5] >> (i & 31)) & 1) jac_madd(L, R, 1);
    }
    par(L, 1, [&](int) {  // affine (X / (Z zq)^2, Y / (Z zq)^3) on the twist
      if (f2_is_zero(R.Z)) {
        R.inf = 1;
        return;
      }
      Fp2 zi, z2;
      f2_mul(zi, R.Z, R.zq);
      f2_inv(zi, zi);
      f2_sqr(z2, zi);
      f2_mul(R.d[0], R.X, z2);
      f2_mul(z2, z2, zi);
      f2_mul(R.d[1], R.Y, z2);
    });
  }
  if (R.inf) {
    par(L, 1, [&](int) {
      f2_zero(R.d[0]);
      f2_zero(R.d[1]);
    });
  }
  par(L, 4, [&](int j) {
    const Fp2& c = R.d[j / 2];
    fp_to_bytes((j < 2 ? xo : yo) + (j % 2) * FP_BYTES, j % 2 == 0 ? c.c0 : c.c1);
  });
  return R.inf != 0;
}

}  // namespace bls
