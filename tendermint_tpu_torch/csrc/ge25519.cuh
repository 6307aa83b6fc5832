// Twisted-Edwards point arithmetic for ed25519, one point per thread.
//
// Counterpart of the JAX package's ops/curve.py and of the port's plain
// ops/curve.py, formula for formula (dbl-2008-hwcd with a = -1, ref10's
// cached and affine-cached additions; the unified add-2008-hwcd-3 is
// ge_add_cached of q's cached form, with the same values), so that even
// the garbage point left by a failed decompression maps to the same
// coordinates as in the other two.
#pragma once
#include "fe25519.cuh"

struct ge_p3 {
  fe X, Y, Z, T;
};

// ref10's ge_cached: Y+X, Y-X, 2Z, 2dT
struct ge_cached {
  fe ypx, ymx, z2, t2d;
};

// ref10's ge_precomp, the JAX package's AffineCached: y+x, y-x, 2dxy of
// an affine point (Z = 1), one multiplication cheaper to add than
// ge_cached. The per-valset tables and the base comb hold these.
struct ge_precomp {
  fe ypx, ymx, t2d;
};

// Curve constants, uploaded once from the host (ops/_build.py) so that
// every constant has one source: the pure-Python oracle.
struct TmConstants {
  int32_t d[10];
  int32_t d2[10];
  int32_t sqrtm1[10];
  int32_t base[8][4][10];  // [1..8]B in cached form, from affine points
};

TM_FN void ge_identity(ge_p3& p) {
  fe_set_small(p.X, 0);
  fe_set_small(p.Y, 1);
  fe_set_small(p.Z, 1);
  fe_set_small(p.T, 0);
}

// dbl-2008-hwcd with a = -1, as curve.double; T only when asked for
TM_FN void ge_double(ge_p3& r, const ge_p3& p, bool want_t) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_neg(d, a);
  fe_add(t, p.X, p.Y);
  fe_sq(t, t);
  fe_sub(e, t, a);
  fe_sub(e, e, b);
  fe_add(g, d, b);
  fe_sub(f, g, c);
  fe_sub(h, d, b);
  if (want_t) fe_mul(r.T, e, h); else fe_set_small(r.T, 0);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
}

TM_FN void ge_to_cached(ge_cached& c, const ge_p3& p, const fe& d2) {
  fe_add(c.ypx, p.Y, p.X);
  fe_sub(c.ymx, p.Y, p.X);
  fe_add(c.z2, p.Z, p.Z);
  fe_mul(c.t2d, p.T, d2);
}

// p + q with q cached (ref10 ge_add), as curve.add_cached
TM_FN void ge_add_cached(ge_p3& r, const ge_p3& p, const ge_cached& q, bool want_t) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul(d, p.Z, q.z2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  if (want_t) fe_mul(r.T, e, h); else fe_set_small(r.T, 0);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
}

// p + q with q affine-cached (ref10 ge_madd), as curve.madd
TM_FN void ge_madd(ge_p3& r, const ge_p3& p, const ge_precomp& q, bool want_t) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.ymx);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  if (want_t) fe_mul(r.T, e, h); else fe_set_small(r.T, 0);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
}

// Signed-window select on an affine-cached entry: digit 0 gives the
// affine identity (1, 1, 0), a negative digit swaps y+x with y-x and
// negates 2dxy (as curve._select_affine).
TM_FN void ge_precomp_fix(ge_precomp& c, int digit) {
  if (digit == 0) {
    fe_set_small(c.ypx, 1);
    fe_set_small(c.ymx, 1);
    fe_set_small(c.t2d, 0);
  } else if (digit < 0) {
    const fe t = c.ypx;
    c.ypx = c.ymx;
    c.ymx = t;
    fe_neg(c.t2d, c.t2d);
  }
}

// y with the sign of x in bit 255; one inversion, by a binary GCD
TM_FN void ge_encode(uint8_t s[32], const ge_p3& p) {
  fe zi, x, y;
  fe_inv_gcd(zi, p.Z);
  fe_mul(x, p.X, zi);
  fe_mul(y, p.Y, zi);
  fe_tobytes(s, y);
  s[31] |= (uint8_t)(fe_isneg(x) ? 0x80 : 0);
}

// Go x/crypto's decompression, as curve.decompress: bit 255 is the sign,
// y >= p is used mod p, x = 0 with the sign set is accepted. Returns
// false when x^2 has no root; p then holds the same garbage point as the
// other two versions.
TM_FN bool ge_decompress(ge_p3& p, const uint8_t* s, const TmConstants& k) {
  const bool sign = (s[31] >> 7) & 1;
  fe one, d, sqrtm1, yy, u, v, v3, v7, t, x, vxx, nu;
  fe_set_small(one, 1);
  fe_load_const(d, k.d);
  fe_load_const(sqrtm1, k.sqrtm1);
  fe_frombytes(p.Y, s);
  fe_sq(yy, p.Y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, d);
  fe_add(v, v, one);
  fe_sq(v3, v);
  fe_mul(v3, v3, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(vxx, x);
  fe_mul(vxx, v, vxx);
  const bool ok_plus = fe_eq(vxx, u);
  fe_neg(nu, u);
  const bool ok_minus = fe_eq(vxx, nu);
  fe_mul(t, x, sqrtm1);
  if (!ok_plus) x = t;
  if (fe_isneg(x) != sign) fe_neg(x, x);
  p.X = x;
  fe_set_small(p.Z, 1);
  fe_mul(p.T, x, p.Y);
  return ok_plus || ok_minus;
}
