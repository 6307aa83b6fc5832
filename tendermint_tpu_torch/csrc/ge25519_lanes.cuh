// ed25519 group operations on a row's lanes: the work of ed25519_scan and
// ed25519_scan_tabled (a signature row) and ed25519_build_tables (a
// validator), G lanes of one warp a row.
//
// The one-thread formulas of ge25519.cuh are cut into stages of
// independent field products. A doubling is 4 squarings (X^2, Y^2, Z^2,
// (X + Y)^2), then 3 or 4 products (X, Y, Z and, when asked for, T); a
// cached addition is 4 products (the a, b, c, d of ge_add_cached), then 3
// or 4; a mixed addition (ge_madd) 3 and a copy, then 3 or 4. Each stage's operands are read from the row's shared slots (the
// point `p`, the stage results `s`), each lane forms its item's operands
// (a sum of at most four slots with small coefficients, one floor-carry
// pass) and runs one product, and the results go back to shared slots.
// `par` (lanes.cuh) runs one stage: on the device each lane its share of
// the items, then __syncwarp over the row's lanes; on the host
// (csrc/ed25519_host.cc) every lane's share in turn, which computes the
// same values because no item of a stage reads what another item of it
// writes. Control flow is the row's own and the same on all its lanes:
// branches read only shared values or digits after a stage's sync, and
// code outside `par` runs on every lane alike (on the host, once).
//
// What each row computes is what the one-thread kernels computed, group
// operation for group operation and formula for formula, so every
// coordinate has the same value mod p (its limbs may differ: a linear
// combination is carried once instead of after every addend, and a
// product of three factors is taken in another order, as the unified
// addition's c = T1 (2d T2) against curve.add's (T1 2d) T2). The
// outputs, compared as canonical bytes, are identical to the plain
// versions' and to the JAX package's, for the garbage point of an
// undecodable key too.
#pragma once
#include "ge25519.cuh"
#include "lanes.cuh"

// One floor-carry pass with every limb's carry taken at once, so that
// its latency is one step where fe_weak's is ten; the carry out of limb 9
// re-enters limb 0 times 19. For limbs below 2^28.1 in absolute value, as
// every sum of this file is, a carry is at most 9 in absolute value and
// the result within fe25519.cuh's limb bound. Only products read what it
// leaves (no comparison or encoding does).
TM_FN void fe_carry(fe& h) {
  int32_t c[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    c[i] = h.v[i] >> fe_width(i);
    h.v[i] &= (1 << fe_width(i)) - 1;
  }
  h.v[0] += 19 * c[9];
#pragma unroll
  for (int i = 1; i < 10; i++) h.v[i] += c[i - 1];
}

// r = c0 s0 + c1 s1 + c2 s2 + c3 s3, one carry pass. The coefficients'
// absolute values sum to 4 at most, so the sums stay within int32.
TM_FN void fe_comb(fe& r, const fe* s, int c0, int c1, int c2, int c3) {
#pragma unroll
  for (int k = 0; k < 10; k++) r.v[k] = c0 * s[0].v[k] + c1 * s[1].v[k] + c2 * s[2].v[k] + c3 * s[3].v[k];
  fe_carry(r);
}

// The second stage of both formulas: X = e f, Y = g h, Z = f g and, with
// want_t, T = e h (else T = 0), each of e, f, g, h (kinds 0-3) being
// comb(s, coef(kind)). Item i multiplies kinds (0, 1), (2, 3), (1, 2),
// (0, 3).
template <class Coef>
TM_FN void efgh_stage(const Lanes& L, fe* p, const fe* s, bool want_t, Coef coef) {
  par(L, 4, [&](int i) {
    if (i == 3 && !want_t) {
      fe_set_small(p[3], 0);
      return;
    }
    const int ka = i == 1 ? 2 : (i == 2 ? 1 : 0);
    const int kb = i == 0 ? 1 : (i == 2 ? 2 : 3);
    int c[4];
    fe a, b;
    coef(ka, c);
    fe_comb(a, s, c[0], c[1], c[2], c[3]);
    coef(kb, c);
    fe_comb(b, s, c[0], c[1], c[2], c[3]);
    fe r;
    fe_mul(r, a, b);
    p[i] = r;
  });
}

// p <- 2p (dbl-2008-hwcd, a = -1, as ge_double); s is scratch.
TM_FN void dbl_stages(const Lanes& L, fe* p, fe* s, bool want_t) {
  // a = X^2, b = Y^2, c = Z^2, t = (X + Y)^2
  par(L, 4, [&](int i) {
    fe x;
    const fe* q = p + (i == 3 ? 0 : i);
#pragma unroll
    for (int k = 0; k < 10; k++) x.v[k] = q->v[k] + (i == 3 ? p[1].v[k] : 0);
    if (i == 3) fe_carry(x);
    fe r;
    fe_sq(r, x);
    s[i] = r;
  });
  // e = t - a - b, f = (b - a) - 2c, g = b - a, h = -a - b
  efgh_stage(L, p, s, want_t, [](int kind, int* c) {
    c[0] = -1;
    c[1] = (kind == 0 || kind == 3) ? -1 : 1;
    c[2] = kind == 1 ? -2 : 0;
    c[3] = kind == 0 ? 1 : 0;
  });
}

// p <- p + q for q cached (ref10's ge_add, as ge_add_cached), q's fields
// in the order (Y+X, Y-X, 2Z, 2dT), read through the row's signed digit as
// curve._select reads them: 0 is the cached identity (1, 1, 2, 0), a
// negative digit swaps Y+X with Y-X and negates 2dT. s is scratch.
TM_FN void add_stages(const Lanes& L, fe* p, fe* s, const fe* q, int digit, bool want_t) {
  // a = (Y - X)(Y-X)_q, b = (Y + X)(Y+X)_q, c = T (2dT)_q, d = Z (2Z)_q
  par(L, 4, [&](int i) {
    const int src = i == 0 || i == 1 ? 1 : (i == 2 ? 3 : 2);  // Y, Y, T, Z
    const int sx = i == 0 ? -1 : (i == 1 ? 1 : 0);
    fe a, b;
#pragma unroll
    for (int k = 0; k < 10; k++) a.v[k] = p[src].v[k] + sx * p[0].v[k];
    fe_carry(a);
    const bool neg = digit < 0;
    const int field = i == 0 ? (neg ? 0 : 1) : (i == 1 ? (neg ? 1 : 0) : (i == 2 ? 3 : 2));
    const int sign = neg && i == 2 ? -1 : 1;
    const int32_t ident = i == 2 ? 0 : (i == 3 ? 2 : 1);
#pragma unroll
    for (int k = 0; k < 10; k++) b.v[k] = digit != 0 ? sign * q[field].v[k] : (k == 0 ? ident : 0);
    fe r;
    fe_mul(r, a, b);
    s[i] = r;
  });
  // e = b - a, f = d - c, g = d + c, h = b + a
  efgh_stage(L, p, s, want_t, [](int kind, int* c) {
    const bool bd = kind == 0 || kind == 3;  // e, h: from a and b
    c[0] = bd ? (kind == 0 ? -1 : 1) : 0;
    c[1] = bd ? 1 : 0;
    c[2] = bd ? 0 : (kind == 1 ? -1 : 1);
    c[3] = bd ? 0 : 1;
  });
}

// q <- p in cached form (Y+X, Y-X, 2Z, 2dT), as ge_to_cached.
TM_FN void cached_stage(const Lanes& L, fe* q, const fe* p, const fe& d2) {
  par(L, 4, [&](int i) {
    fe r;
    if (i == 3) {
      fe_mul(r, p[3], d2);
    } else {
      const int src = i == 2 ? 2 : 1;
      const int sx = i == 0 ? 1 : (i == 1 ? -1 : 1);
      const fe& o = i == 2 ? p[2] : p[0];
#pragma unroll
      for (int k = 0; k < 10; k++) r.v[k] = p[src].v[k] + sx * o.v[k];
      fe_carry(r);
    }
    q[i] = r;
  });
}

// Row copies over the row's lanes (neighbouring lanes on neighbouring
// words).
template <class W>
TM_FN void copy_words(const Lanes& L, W* dst, const W* src, int n) {
  par(L, n, [&](int k) { dst[k] = src[k]; });
}

// -- ed25519_scan: [s]B + [k](-A) by Straus, a row on G lanes ----------------------

// A row's shared state; the stride (1,736 B) is an odd number of 8-byte
// words, so the rows of a warp fall on different banks.
struct ScanRow {
  fe p[4];        // the accumulator X, Y, Z, T
  fe s[4];        // a stage's products
  fe tbl[8][4];    // [1..8](-A), cached
  int32_t sd[16];  // the signed digits of s, as words
  int32_t kd[16];  // and of k
  int32_t pad[2];
};

// curve.double_scalar_mul_signed on one row: sd, kd (64,) int8, neg_a (4,
// 10) int32 -> out (4, 10) int32 with T zero. `base` is the constant
// [1..8]B table, cached (TmConstants.base).
TM_FN void scan_row(const Lanes& L, ScanRow& R, const int8_t* sd, const int8_t* kd, const int32_t* neg_a,
                    int32_t* out, const fe (*base)[4], const fe& d2) {
  copy_words(L, &R.p[0].v[0], neg_a, 40);
  copy_words(L, R.sd, reinterpret_cast<const int32_t*>(sd), 16);
  copy_words(L, R.kd, reinterpret_cast<const int32_t*>(kd), 16);
  // the digits are read as bytes of the words they were copied as (a
  // char type may read any object; an int8_t array written as words may
  // not be read back as bytes)
  const int8_t* sd_b = reinterpret_cast<const int8_t*>(R.sd);
  const int8_t* kd_b = reinterpret_cast<const int8_t*>(R.kd);
  // [1..8]q: entry 1 is q, each next one (previous + q) by the unified
  // addition (here with q's cached form, the same values)
  cached_stage(L, R.tbl[0], R.p, d2);
#pragma unroll 1
  for (int i = 1; i < 8; i++) {
    add_stages(L, R.p, R.s, R.tbl[0], 1, true);
    cached_stage(L, R.tbl[i], R.p, d2);
  }
  par(L, 4, [&](int i) { fe_set_small(R.p[i], i == 1 || i == 2 ? 1 : 0); });
#pragma unroll 1
  for (int w = 63; w >= 0; w--) {
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, true);
    const int sdig = sd_b[w];
    const int smag = sdig < 0 ? -sdig : sdig;
    add_stages(L, R.p, R.s, base[smag > 0 ? smag - 1 : 0], sdig, true);
    const int kdig = kd_b[w];
    const int kmag = kdig < 0 ? -kdig : kdig;
    add_stages(L, R.p, R.s, R.tbl[kmag > 0 ? kmag - 1 : 0], kdig, false);
  }
  copy_words(L, out, &R.p[0].v[0], 40);
}

// -- ed25519_build_tables: a validator's split tables on G lanes -------------------

constexpr int kBuildSplits = 16;
constexpr int kBuildEntries = 8;
constexpr int kBuildTableInts = kBuildSplits * kBuildEntries * 30;  // 3,840 int32 a validator

// A validator's shared state on G lanes. Its 128 entries are built in
// their own slots of the output, projective (X, Y, Z) while they are
// built and inverted, then affine-cached (y+x, y-x, 2dxy): the output is
// the working space (see ed25519_tabled.cu for why not shared memory).
// Here: q_m's T, the doubling chain's point, a stage's products, each
// lane's split point in cached form, its product of Z and its zero flags,
// and the inverse of the lanes' product. The stride is an odd number of
// 8-byte words for G = 2 to 16, so the validators of a warp fall on
// different banks.
template <int G>
struct BuildRow {
  fe qT[kBuildSplits];  // T of q_m (entry 8m is q_m's X, Y, Z)
  fe p[4];              // the doubling chain's point
  fe s[4];              // a stage's products
  ge_cached qc[G];      // each lane's q_m, cached, while it adds up split m
  fe lp[G];             // each lane's product of its nonzero Z
  fe inv;               // 1 / (the product of lp)
  uint64_t zero[G];     // each lane's zero-Z flags, an entry a bit
};

// The work of one validator, in four steps (curve.build_split_tables):
// q_0 = -A; split m's entry 1 is q_m and each next one (previous + q_m) by
// the unified addition; q_(m+1) is sixteen doublings of q_m, T only on
// the last; the 128 Z are inverted as in field.invert_rows (a Z that is 0
// counts as 1 and its inverse is 0), Montgomery's trick over each lane's
// share with one inversion of the lanes' products. build_start and
// build_invert are each one chain of products for one thread; the kernel
// runs them a thread a validator, the other two steps on its G lanes.

// q_0 by decompression; *a_ok.
template <int G>
TM_FN void build_start(BuildRow<G>& R, fe (*ent)[3], const uint8_t* pk, const TmConstants& k, uint8_t* a_ok) {
  ge_p3 q;
  *a_ok = ge_decompress(q, pk, k) ? 1 : 0;
  fe_neg(q.X, q.X);
  fe_neg(q.T, q.T);
  R.p[0] = ent[0][0] = q.X;
  R.p[1] = ent[0][1] = q.Y;
  R.p[2] = ent[0][2] = q.Z;
  R.p[3] = R.qT[0] = q.T;
}

// Every entry: q_1 .. q_15 stage-parallel; then each lane, for its
// splits l, l + G, ..., the seven additions, with Montgomery's forward
// sweep over the entries as they come: X and Y times the product of the
// (nonzero) Z before them, Z as it is; the lane's product into lp[l].
template <int G>
TM_FN void build_entries(const Lanes& L, BuildRow<G>& R, fe (*ent)[3], const fe& d2) {
#pragma unroll 1
  for (int m = 1; m < kBuildSplits; m++) {
#pragma unroll 1
    for (int j = 0; j < 16; j++) dbl_stages(L, R.p, R.s, j == 15);
    par(L, 4, [&](int i) {
      if (i < 3)
        ent[m * kBuildEntries][i] = R.p[i];
      else
        R.qT[m] = R.p[3];
    });
  }
  par(L, G, [&](int l) {
    // the lane's running product and zero flags stay in its shared state,
    // its split point's cached form too: the addition needs the registers
    fe& run = R.lp[l];
    uint64_t& zero = R.zero[l];
    fe_set_small(run, 1);
    zero = 0;
    int j = 0;
#pragma unroll 1
    for (int m = l; m < kBuildSplits; m += G) {
      fe(*e)[3] = ent + m * kBuildEntries;
      ge_p3 acc;
      acc.X = e[0][0];
      acc.Y = e[0][1];
      acc.Z = e[0][2];
      acc.T = R.qT[m];
      ge_to_cached(R.qc[l], acc, d2);
#pragma unroll 1
      for (int i = 0; i < kBuildEntries; i++, j++) {
        if (i > 0) ge_add_cached(acc, acc, R.qc[l], i < kBuildEntries - 1);
        const bool is0 = fe_iszero(acc.Z);
        zero |= (uint64_t)is0 << j;
        fe x, y;
        fe_mul(x, acc.X, run);
        fe_mul(y, acc.Y, run);
        if (is0) {
          fe_set_small(x, 0);
          fe_set_small(y, 0);
        } else {
          fe r;
          fe_mul(r, run, acc.Z);
          run = r;
        }
        e[i][0] = x;
        e[i][1] = y;
        e[i][2] = acc.Z;
      }
    }
  });
}

// inv = 1 / (the product of the G lanes' products).
template <int G>
TM_FN void build_invert(BuildRow<G>& R) {
  fe t = R.lp[0];
#pragma unroll 1
  for (int l = 1; l < G; l++) fe_mul(t, t, R.lp[l]);
  fe_invert(R.inv, t);
}

// Each lane's backward sweep over its entries: its inverse is inv times
// the other lanes' products; x = X' / (the product up to Z), then
// (y + x, y - x, 2d x y) in place.
template <int G>
TM_FN void build_finish(const Lanes& L, BuildRow<G>& R, fe (*ent)[3], const fe& d2) {
  par(L, L.g, [&](int l) {
    fe inv = R.inv;
#pragma unroll 1
    for (int k = 0; k < L.g; k++)
      if (k != l) fe_mul(inv, inv, R.lp[k]);
    const uint64_t zero = R.zero[l];
    int j = (kBuildSplits / L.g) * kBuildEntries - 1;
#pragma unroll 1
    for (int m = l + (kBuildSplits / L.g - 1) * L.g; m >= 0; m -= L.g) {
#pragma unroll 1
      for (int i = kBuildEntries - 1; i >= 0; i--, j--) {
        fe* e = ent[m * kBuildEntries + i];
        fe x, y, t, r;
        fe_mul(x, e[0], inv);
        fe_mul(y, e[1], inv);
        fe_mul(r, inv, e[2]);
        if (!((zero >> j) & 1)) inv = r;
        fe_mul(t, x, y);
        fe_add(e[0], y, x);
        fe_sub(e[1], y, x);
        fe_mul(e[2], t, d2);
      }
    }
  });
}

// build_valset_tables on one validator, its steps in turn (the host
// build's form of the kernel): pk (32,) -> out (16, 8, 3, 10) int32, *a_ok.
template <int G>
TM_FN void build_row(const Lanes& L, BuildRow<G>& R, const uint8_t* pk, const TmConstants& k, int32_t* out,
                     uint8_t* a_ok) {
  fe d2;
  fe_load_const(d2, k.d2);
  fe(*ent)[3] = reinterpret_cast<fe(*)[3]>(out);
  build_start(R, ent, pk, k, a_ok);
  build_entries(L, R, ent, d2);
  build_invert(R);
  build_finish(L, R, ent, d2);
}

// -- ed25519_scan_tabled: a tabled row on G lanes ----------------------------------

// p <- p + q for q affine-cached (y+x, y-x, 2dxy: 30 int32 at q, a table
// entry in device memory), as ge_madd, read through the row's signed
// digit as ge_precomp_fix reads it: 0 is the identity (1, 1, 0), a
// negative digit swaps y+x with y-x and negates 2dxy. a = (Y - X)(y-x),
// b = (Y + X)(y+x), c = T 2dxy; d = 2Z needs no product: s[3] holds Z and
// the second stage's sums take it twice (f = 2Z - c, g = 2Z + c). Each
// lane loads the one field its product needs, so the row's lanes read
// the entry's 120 B together. s is scratch.
TM_FN void madd_stages(const Lanes& L, fe* p, fe* s, const int32_t* q, int digit, bool want_t) {
  par(L, 4, [&](int i) {
    if (i == 3) {
      s[3] = p[2];
      return;
    }
    const bool neg = digit < 0;
    const int src = i == 2 ? 3 : 1;  // T, or Y
    const int sx = i == 0 ? -1 : (i == 1 ? 1 : 0);
    const int field = i == 0 ? (neg ? 0 : 1) : (i == 1 ? (neg ? 1 : 0) : 2);
    const int sign = neg && i == 2 ? -1 : 1;
    fe a, b;
#pragma unroll
    for (int k = 0; k < 10; k++) a.v[k] = p[src].v[k] + sx * p[0].v[k];
    fe_carry(a);
    if (digit != 0) {
#pragma unroll
      for (int k = 0; k < 10; k++) b.v[k] = sign * q[10 * field + k];
    } else {
      fe_set_small(b, i == 2 ? 0 : 1);
    }
    fe r;
    fe_mul(r, a, b);
    s[i] = r;
  });
  // e = b - a, f = 2Z - c, g = 2Z + c, h = b + a
  efgh_stage(L, p, s, want_t, [](int kind, int* c) {
    const bool bd = kind == 0 || kind == 3;  // e, h: from a and b
    c[0] = bd ? (kind == 0 ? -1 : 1) : 0;
    c[1] = bd ? 1 : 0;
    c[2] = bd ? 0 : (kind == 1 ? -1 : 1);
    c[3] = bd ? 0 : 2;
  });
}

constexpr int kTabWindows = 4;  // windows of the key's digits (SPLIT_W)
constexpr int kCombPositions = 32;
constexpr int kCombEntries = 128;

// A tabled row's shared state: no copy of the key's tables (they are
// read where ed25519_build_tables wrote them). The stride (424 B) is an
// odd number of 8-byte words, so the rows of a warp fall on different
// banks.
struct TabRow {
  fe p[4];        // the accumulator X, Y, Z, T
  fe s[4];        // a stage's products
  int32_t sd[8];  // the signed base-256 digits of s, as words
  int32_t kd[16]; // the signed nibbles of k, as words
  int32_t pad[2];
};

constexpr int kTabAdds = kTabWindows * kBuildSplits + kCombPositions;  // 96 mixed additions a row

// curve.double_scalar_mul_tabled on one row: sd8 (32,), kd (64,) int8,
// tab the row's validator's tables (16, 8, 3, 10) int32, comb the base
// comb (32, 128, 3, 10) -> out (4, 10) int32 with T zero. Four windows,
// most significant first, of four doublings (T on the last) and sixteen
// mixed additions from the key's tables (digit 4m + w selects split m),
// then 32 from the comb, the last without T. tab null (the row's index out of range): the row writes zeros, every
// lane alike.
TM_FN void scan_tabled_row(const Lanes& L, TabRow& R, const int8_t* sd8, const int8_t* kd, const int32_t* tab,
                           const int32_t* comb, int32_t* out) {
  if (tab == nullptr) {
    par(L, 40, [&](int k) { out[k] = 0; });
    return;
  }
  copy_words(L, R.sd, reinterpret_cast<const int32_t*>(sd8), 8);
  copy_words(L, R.kd, reinterpret_cast<const int32_t*>(kd), 16);
  par(L, 4, [&](int i) { fe_set_small(R.p[i], i == 1 || i == 2 ? 1 : 0); });
  const int8_t* sd_b = reinterpret_cast<const int8_t*>(R.sd);  // as in scan_row
  const int8_t* kd_b = reinterpret_cast<const int8_t*>(R.kd);
  // addition j's digit, and its entry (null for digit 0)
  auto digit = [&](int j) {
    return j < kTabWindows * kBuildSplits ? (int)kd_b[kTabWindows * (j % kBuildSplits) + kTabWindows - 1 -
                                                      j / kBuildSplits]
                                          : (int)sd_b[j - kTabWindows * kBuildSplits];
  };
  auto entry = [&](int j) -> const int32_t* {
    const int dig = digit(j);
    const int mag = dig < 0 ? -dig : dig;
    if (mag == 0) return nullptr;
    if (j < kTabWindows * kBuildSplits) return tab + ((j % kBuildSplits) * kBuildEntries + mag - 1) * 30;
    return comb + ((j - kTabWindows * kBuildSplits) * kCombEntries + mag - 1) * 30;
  };
  auto madd = [&](int j) { madd_stages(L, R.p, R.s, entry(j), digit(j), j < kTabAdds - 1); };
  int j = 0;
#pragma unroll 1
  for (int w = 0; w < kTabWindows; w++) {
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, false);
    dbl_stages(L, R.p, R.s, true);
#pragma unroll 1
    for (int m = 0; m < kBuildSplits; m++) madd(j++);
  }
#pragma unroll 1
  for (; j < kTabAdds; j++) madd(j);
  copy_words(L, out, &R.p[0].v[0], 40);
}
