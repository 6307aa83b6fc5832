// The BLS kernels' arithmetic (fp381.cuh, bls12_curve.cuh) built as host
// C++ with a plain C interface, for the tests and for counting the Fp
// products a row runs: ops/bls12_host.py compiles it with g++ and loads it
// with ctypes. Without nvcc the headers take their portable branches: the
// u64 twin of the PTX product, which also counts, and `par`, which runs a
// row's lanes in turn over each stage. Nothing here is part of the
// kernels' build (ops/_build.py).
//
// Seams as the kernels': canonical big-endian 48-byte field elements, an
// Fp12 as (2, 3, 2, 48). `lanes` is the row's lane group G.
#include <string.h>

#include <memory>
#include <vector>

#include "bls12_curve.cuh"

namespace bls {
Constants c_bls;
uint64_t fp_mul_count = 0;
}  // namespace bls

using namespace bls;

namespace {

Lanes host_lanes(int g) { return Lanes{0, g, 0}; }

void f12_from(Fp2* r, const uint8_t* in) {
  for (int j = 0; j < 6; ++j) {
    fp_from_bytes(r[j].c0, in + 2 * j * FP_BYTES);
    fp_from_bytes(r[j].c1, in + (2 * j + 1) * FP_BYTES);
  }
}

void f12_to(uint8_t* out, const Fp2* a) {
  for (int j = 0; j < 6; ++j) {
    fp_to_bytes(out + 2 * j * FP_BYTES, a[j].c0);
    fp_to_bytes(out + (2 * j + 1) * FP_BYTES, a[j].c1);
  }
}

}  // namespace

namespace {

// bls12_g1_aggregate's work for one batch row, its blocks and each block's
// groups in turn, as the kernel's steps run them between barriers.
template <int G>
int host_g1_sum(uint8_t* out, const uint8_t* points, const uint8_t* mask, int v, int chunk) {
  constexpr int K = kAggThreads / G;
  auto S = std::make_unique<AggBlock<K>>();
  const Lanes L = host_lanes(G);
  const int nblk = v > chunk ? (v + chunk - 1) / chunk : 1;
  std::vector<uint32_t> part((size_t)nblk * kAggWords);
  bool have[K];
  auto tree = [&]() {
    for (int k = 0; k < K; ++k) S->have[k] = have[k];
    for (int s = K / 2; s > 0; s >>= 1)
      for (int k = 0; k < K; ++k) agg_tree_step(L, S->grp, S->have, k, s);
  };
  for (int blk = 0; blk < nblk; ++blk) {
    for (int k = 0; k < K; ++k) have[k] = false;
    const int lo = blk * chunk, hi = lo + chunk < v ? lo + chunk : v;
    for (int base = lo; base < hi; base += kAggThreads) {
      int n = 0;
      for (int i = base; i < hi && i < base + kAggThreads; ++i) {
        if (!mask[i]) continue;
        fp_from_bytes(S->pts[n][0], points + (size_t)i * 2 * FP_BYTES);
        fp_from_bytes(S->pts[n][1], points + (size_t)i * 2 * FP_BYTES + FP_BYTES);
        ++n;
      }
      for (int k = 0; k < K; ++k) agg_sum_points(L, S->grp[k], S->pts, k, n, K, have[k]);
    }
    tree();
    for (int w = 0; w < kAggWords; ++w)
      part[(size_t)blk * kAggWords + w] = agg_partial_word(S->grp[0], S->have[0], w);
  }
  for (int k = 0; k < K; ++k) {
    have[k] = false;
    agg_sum_partials(L, S->grp[k], agg_partial_slot(*S, k), part.data(), k, nblk, K, have[k]);
  }
  tree();
  uint8_t inf = 0;
  agg_finish(out, &inf, S->grp[0], S->have[0]);
  return inf;
}

}  // namespace

extern "C" {

int bls_host_set_constants(const void* blob, size_t bytes) {
  if (bytes != sizeof(Constants)) return -1;
  memcpy(&c_bls, blob, bytes);
  return 0;
}

void bls_host_count_reset() { fp_mul_count = 0; }

uint64_t bls_host_count() { return fp_mul_count; }

// op 0: r = a b, 1: r = a + b, 2: r = a - b, 3: r = 1 / a by Fermat
// (fp_inv), 4: r = 1 / a by the binary GCD (fp_inv_gcd), on Montgomery words
// (12 little-endian u32 each). Returns the GCD's outer steps for op 4, else 0.
int bls_host_fp_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* r) {
  Fp x, y, z;
  int steps = 0;
  memcpy(x.v, a, sizeof(x.v));
  memcpy(y.v, b, sizeof(y.v));
  if (op == 0)
    fp_mul(z, x, y);
  else if (op == 1)
    fp_add(z, x, y);
  else if (op == 2)
    fp_sub(z, x, y);
  else if (op == 3)
    fp_inv(z, x);
  else
    steps = fp_inv_gcd(z, x);
  memcpy(r, z.v, sizeof(z.v));
  return steps;
}

// The Fp12 stages on one row's lanes: op 0: a b (f12_mul), 1: a^2
// (f12_sqr, the complex method), 2: a^2 (cyc_sqr, for a cyclotomic a),
// 3: a l with l = the first three Fp2 of b (line_mul's slots 1, v w,
// v^2 w), 4: a^p (f12_frobenius), 5: a^-1 (f12_inv).
int bls_host_f12_op(int op, uint8_t* out, const uint8_t* a, const uint8_t* b, int lanes) {
  auto R = std::make_unique<PairRow>();
  const Lanes L = host_lanes(lanes);
  FinalState& S = R->fe;
  f12_from(S.t, a);
  f12_from(S.m, b);
  switch (op) {
    case 0: f12_mul(L, R->oa, R->ob, S.u, S.t, S.m); break;
    case 1: f12_sqr(L, R->oa, R->ob, S.u, S.t); break;
    case 2: cyc_sqr(L, R->oa, R->ob, S.u, S.t); break;
    case 3: {
      Fp2 l[3] = {S.m[0], S.m[1], S.m[2]};
      for (int c = 0; c < 6; ++c) R->f[c] = S.t[c];
      line_mul(L, *R, l);
      for (int c = 0; c < 6; ++c) S.u[c] = R->f[c];
      break;
    }
    case 4: f12_frobenius(L, R->oa, R->ob, S.u, S.t); break;
    case 5: {
      for (int c = 0; c < 6; ++c) R->f[c] = S.t[c];
      f12_inv(L, *R, S.u, R->f);
      break;
    }
    default: return -1;
  }
  f12_to(out, S.u);
  return 0;
}

// One pairing row (bls12_pairing_check's): returns whether the value is 1.
int bls_host_pairing_row(uint8_t* value, const uint8_t* pk, const uint8_t* hm, const uint8_t* sig, int pairs,
                         int lanes) {
  auto R = std::make_unique<PairRow>();
  return pairing_row(host_lanes(lanes), *R, value, pk, hm, sig, pairs) ? 1 : 0;
}

// One staged addition on a group of `lanes`: p (3, 48) projective X, Y,
// Z; q the same, or affine (2, 48) when `mixed` -> out (3, 48) projective.
void bls_host_g1_add(uint8_t* out, const uint8_t* p, const uint8_t* q, int mixed, int lanes) {
  auto g = std::make_unique<G1Group>();
  Fp qq[3];
  for (int i = 0; i < 3; ++i) {
    fp_from_bytes((&g->acc.X)[i], p + i * FP_BYTES);
    if (i < 2 || !mixed) fp_from_bytes(qq[i], q + i * FP_BYTES);
  }
  g1_add_stages(host_lanes(lanes), *g, qq, mixed != 0);
  for (int i = 0; i < 3; ++i) fp_to_bytes(out + i * FP_BYTES, (&g->acc.X)[i]);
}

// bls12_g1_aggregate's work for one batch row: points (V, 2, 48), mask
// (V,) -> out (2, 48); returns the identity flag, or -1 for a lane group
// other than 2, 4, 8 and 16. `chunk`: points a block, `lanes`: G.
int bls_host_g1_sum(uint8_t* out, const uint8_t* points, const uint8_t* mask, int v, int chunk, int lanes) {
  switch (lanes) {
    case 2: return host_g1_sum<2>(out, points, mask, v, chunk);
    case 4: return host_g1_sum<4>(out, points, mask, v, chunk);
    case 8: return host_g1_sum<8>(out, points, mask, v, chunk);
    case 16: return host_g1_sum<16>(out, points, mask, v, chunk);
  }
  return -1;
}

// One map row (bls12_map_to_g2's): returns the identity flag.
int bls_host_map_row(uint8_t* xo, uint8_t* yo, const uint8_t* u0, const uint8_t* u1, int lanes) {
  auto R = std::make_unique<MapRow>();
  return map_to_g2_row(host_lanes(lanes), *R, xo, yo, u0, u1) ? 1 : 0;
}

}  // extern "C"
