// The ed25519 kernels' arithmetic (fe25519.cuh, ge25519.cuh,
// ge25519_lanes.cuh) and the tabled prepare's steps (prepare_tabled.cuh,
// sha512.cuh, sc25519.cuh) built as host C++ with a plain C interface, for the
// tests: ops/ed25519_host.py compiles it with g++ and loads it with
// ctypes. Without nvcc the headers take their portable branches: `par`
// runs a row's lanes in turn over each stage. Nothing here is part of the
// kernels' build (ops/_build.py).
//
// Seams as the kernels': field elements as 10 int32 limbs, points as
// (4, 10) int32 (X, Y, Z, T), cached points as (4, 10) (Y+X, Y-X, 2Z, 2dT).
// `lanes` is the row's lane group G.
#include <string.h>

#include <memory>
#include <vector>

#include "ge25519_lanes.cuh"
#include "prepare_tabled.cuh"

namespace {

TmConstants host_k;
std::vector<int32_t> host_comb;  // the tabled scan's base comb (32, 128, 3, 10)

Lanes host_lanes(int g) { return Lanes{0, g, 0}; }

void load_d2(fe& d2) { fe_load_const(d2, host_k.d2); }

template <int G>
int host_build_row(int32_t* out, const uint8_t* pk) {
  auto R = std::make_unique<BuildRow<G>>();
  uint8_t ok = 0;
  build_row(host_lanes(G), *R, pk, host_k, out, &ok);
  return ok;
}

// ed25519_prepare_tabled with blocks of R rows: the blocks in turn, and in
// each the threads in turn over every step of the kernel
// (prepare_tabled.cuh); digest (N, 64), when not null, gets each row's
// SHA-512 digest.
template <int R>
void host_prepare_tabled(const PrepArgs& a, uint8_t* digest) {
  auto S = std::make_unique<PrepStage<R>>();
  std::vector<uint64_t> st(8 * R);
  const int blocks = sha512_preimage_blocks(a.mlen);
  const int passes = a.tpl != nullptr ? (a.ntpl + R - 1) / R : 1;
  for (int base = 0; base < a.n; base += R) {
    for (int t = 0; t < R; t++) {
      prep_stage_rows<R>(*S, a, base, t);
      sha512_init(&st[8 * t]);
    }
    for (int cb = 0; cb < blocks; cb++)
      for (int p = 0; p < passes; p++) {
        for (int t = 0; t < R; t++) prep_stage_msg<R>(*S, a, base, cb, p * R, t);
        for (int t = 0; t < R; t++) prep_row_block<R>(*S, a, cb, p * R, t, &st[8 * t]);
      }
    for (int t = 0; t < R && base + t < a.n; t++) {
      if (digest != nullptr)
        for (int i = 0; i < 64; i++) digest[64 * (size_t)(base + t) + i] = (uint8_t)(st[8 * t + i / 8] >> (56 - 8 * (i % 8)));
      prep_row_finish<R>(*S, a, base, t, &st[8 * t]);
    }
  }
}

}  // namespace

extern "C" {

int ed_host_set_constants(const void* blob, size_t bytes) {
  if (bytes != sizeof(TmConstants)) return -1;
  memcpy(&host_k, blob, bytes);
  return 0;
}

// op 0: r = a b (fe_mul), 1: r = a^2 (fe_sq), 2: r = a a (fe_mul(a, a))
int ed_host_fe_op(int op, const int32_t* a, const int32_t* b, int32_t* r) {
  fe x, y, z;
  load_fe(x, a);
  load_fe(y, b);
  switch (op) {
    case 0: fe_mul(z, x, y); break;
    case 1: fe_sq(z, x); break;
    case 2: fe_mul(z, x, x); break;
    default: return -1;
  }
  store_fe(r, z);
  return 0;
}

// ed25519_prepare's decompression of a key: pk (32,) -> -A (4, 10) int32;
// returns a_ok.
int ed_host_decompress(int32_t* neg_a, const uint8_t* pk) {
  ge_p3 A;
  const int ok = ge_decompress(A, pk, host_k);
  fe_neg(A.X, A.X);
  fe_neg(A.T, A.T);
  store_fe(neg_a, A.X);
  store_fe(neg_a + 10, A.Y);
  store_fe(neg_a + 20, A.Z);
  store_fe(neg_a + 30, A.T);
  return ok;
}

// r = 1 / a (10 int32 limbs, canonical) by the binary GCD (fe_inv_gcd),
// returning its batches; gcd 0: by Fermat's power (fe_invert), returning 0.
int ed_host_invert(const int32_t* a, int32_t* r, int gcd) {
  fe z, zi;
  load_fe(z, a);
  int steps = 0;
  if (gcd)
    steps = fe_inv_gcd(zi, z);
  else
    fe_invert(zi, z);
  store_fe(r, zi);
  return steps;
}

// One ed25519_finish row: pt (4, 10) int32, r the signature's R (32 B),
// the two checks -> ok; enc (32 B) gets the point's encoding.
int ed_host_finish_row(const int32_t* pt, const uint8_t* r, int a_ok, int s_ok, uint8_t* enc) {
  ge_p3 p;
  load_fe(p.X, pt);
  load_fe(p.Y, pt + 10);
  load_fe(p.Z, pt + 20);
  fe_set_small(p.T, 0);
  ge_encode(enc, p);
  bool match = true;
  for (int i = 0; i < 32; i++) match &= enc[i] == r[i];
  return match && a_ok && s_ok;
}

// One lane-staged group operation on (4, 10) points: op 0: p <- 2p
// (dbl_stages), 1: p <- p + q for q cached read through `digit`
// (add_stages). want_t: whether T is computed.
int ed_host_point_op(int op, int32_t* p, const int32_t* q, int digit, int want_t, int lanes) {
  fe P[4], S[4], Q[4];
  for (int i = 0; i < 4; i++) {
    load_fe(P[i], p + 10 * i);
    load_fe(Q[i], q + 10 * i);
  }
  const Lanes L = host_lanes(lanes);
  if (op == 0)
    dbl_stages(L, P, S, want_t != 0);
  else if (op == 1)
    add_stages(L, P, S, Q, digit, want_t != 0);
  else
    return -1;
  for (int i = 0; i < 4; i++) store_fe(p + 10 * i, P[i]);
  return 0;
}

// One ed25519_scan row: sd, kd (64,) int8, neg_a (4, 10) -> out (4, 10).
void ed_host_scan_row(int32_t* out, const int8_t* sd, const int8_t* kd, const int32_t* neg_a, int lanes) {
  auto R = std::make_unique<ScanRow>();
  fe base[8][4], d2;
  memcpy(base, host_k.base, sizeof(base));
  load_d2(d2);
  scan_row(host_lanes(lanes), *R, sd, kd, neg_a, out, base, d2);
}

// The tabled scan's base comb, (32, 128, 3, 10) int32 (_build.comb_blob).
int ed_host_set_comb(const void* blob, size_t bytes) {
  if (bytes != sizeof(int32_t) * kCombPositions * kCombEntries * 30) return -1;
  host_comb.resize(bytes / sizeof(int32_t));
  memcpy(host_comb.data(), blob, bytes);
  return 0;
}

// One ed25519_scan_tabled row: sd8 (32,), kd (64,) int8, tab the row's
// validator's tables (16, 8, 3, 10), or null for an index out of range ->
// out (4, 10).
void ed_host_scan_tabled_row(int32_t* out, const int8_t* sd8, const int8_t* kd, const int32_t* tab, int lanes) {
  auto R = std::make_unique<TabRow>();
  scan_tabled_row(host_lanes(lanes), *R, sd8, kd, tab, host_comb.data(), out);
}

// ed25519_prepare_tabled on the host with blocks of `rows` (32, 64 or
// 128): the kernel's arguments (msg null for the template form, tpl null
// for the matrix form); digest (N, 64) or null. Returns -1 for another
// block size.
int ed_host_prepare_tabled(const uint8_t* pk_all, const int32_t* idx, int v, const uint8_t* msg, int mlen,
                           const uint8_t* tpl, int ntpl, const int32_t* tmpl_idx, const uint8_t* ts8, int ts_off,
                           const uint8_t* sig, int n, int8_t* sd8, int8_t* kd, uint8_t* s_ok, uint8_t* digest,
                           int rows) {
  const PrepArgs a{pk_all, idx, v, msg, mlen, tpl, ntpl, tmpl_idx, ts8, ts_off, sig, n, sd8, kd, s_ok};
  switch (rows) {
    case 32: host_prepare_tabled<32>(a, digest); return 0;
    case 64: host_prepare_tabled<64>(a, digest); return 0;
    case 128: host_prepare_tabled<128>(a, digest); return 0;
  }
  return -1;
}

// sc_reduce_words of a 64-byte digest (its state words read big-endian)
// -> out (32,) little-endian.
void ed_host_sc_reduce(const uint8_t* digest, uint8_t* out) {
  uint64_t st[8], k[4];
  for (int i = 0; i < 8; i++) {
    uint64_t v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | digest[8 * i + j];
    st[i] = v;
  }
  sc_reduce_words(k, st);
  for (int i = 0; i < 32; i++) out[i] = (uint8_t)(k[i / 8] >> (8 * (i % 8)));
}

// A 32-byte scalar's packed digits: nibbles (64,) as signed_digits and
// bytes (32,) as signed_digits256 give them, unpacked; returns s < L.
int ed_host_scalar_digits(const uint8_t* s, int8_t* nibbles, int8_t* bytes) {
  uint64_t w[4];
  uint32_t nd[16], bd[8];
  sc_load_bytes(w, s);
  signed_digits(nd, w);
  signed_digits256(bd, w);
  for (int i = 0; i < 64; i++) nibbles[i] = (int8_t)(nd[i / 4] >> (8 * (i % 4)));
  for (int i = 0; i < 32; i++) bytes[i] = (int8_t)(bd[i / 4] >> (8 * (i % 4)));
  return sc_is_canonical(w);
}

// One ed25519_build_tables validator on 2, 4, 8 or 16 lanes: pk (32,) ->
// out (16, 8, 3, 10); returns a_ok (-1 for another lane count).
int ed_host_build_row(int32_t* out, const uint8_t* pk, int lanes) {
  switch (lanes) {
    case 2: return host_build_row<2>(out, pk);
    case 4: return host_build_row<4>(out, pk);
    case 8: return host_build_row<8>(out, pk);
    case 16: return host_build_row<16>(out, pk);
  }
  return -1;
}

}  // extern "C"
