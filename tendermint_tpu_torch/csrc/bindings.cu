// Plain C entry points of the ed25519, SHA-256 and BLS12-381 kernels, loaded with ctypes by
// ops/_build.py. Each returns the cudaError_t of its launch (0 = launched);
// the Python wrapper raises on anything else. Pointers are device
// pointers from torch tensors, `stream` is PyTorch's current stream.
#include <stdint.h>
#include <cuda_runtime.h>

namespace tmk {
cudaError_t set_constants(const void* host, size_t bytes);
cudaError_t launch_prepare(const uint8_t*, const uint8_t*, const uint8_t*, int, int, int8_t*, int8_t*,
                           int32_t*, uint8_t*, uint8_t*, cudaStream_t);
cudaError_t launch_scan(const int8_t*, const int8_t*, const int32_t*, int, int32_t*, cudaStream_t);
cudaError_t launch_finish(const int32_t*, const uint8_t*, const uint8_t*, const uint8_t*, const int64_t*,
                          const uint8_t*, int, uint8_t*, unsigned long long*, cudaStream_t);
cudaError_t set_constants_tabled(const void* host, size_t bytes);
cudaError_t set_comb(const void* host, size_t bytes);
cudaError_t launch_build_tables(const uint8_t*, int, int32_t*, uint8_t*, cudaStream_t);
int scan_lanes();
int build_lanes();
int scan_tabled_lanes();
cudaError_t launch_prepare_tabled(const uint8_t*, const int32_t*, int, const uint8_t*, int, const uint8_t*, int,
                                  const int32_t*, const uint8_t*, int, const uint8_t*, int, int8_t*, int8_t*,
                                  uint8_t*, cudaStream_t);
cudaError_t launch_scan_tabled(const int8_t*, const int8_t*, const int32_t*, const uint8_t*, const int32_t*, int,
                               int, int32_t*, uint8_t*, cudaStream_t);
cudaError_t launch_sha256_leaf_blocks(const uint8_t*, const int32_t*, const int32_t*, int, int, uint32_t*, cudaStream_t);
cudaError_t launch_merkle_tree(const uint32_t*, int, int, uint32_t*, int, uint32_t*, int, uint32_t*, int, cudaStream_t);
int merkle_tree_layout(int n, int* chunk);
cudaError_t set_bls_constants(const void* host, size_t bytes);
void bls12_lanes(int* pairing, int* map, int* aggregate, int* chunk);
cudaError_t launch_bls12_pairing_check(const uint8_t*, const uint8_t*, const uint8_t*, int, int, uint8_t*, uint8_t*,
                                       cudaStream_t);
cudaError_t launch_bls12_map_to_g2(const uint8_t*, const uint8_t*, int, uint8_t*, uint8_t*, cudaStream_t);
size_t bls12_g1_aggregate_scratch(int b, int v);
cudaError_t launch_bls12_g1_aggregate(const uint8_t*, const uint8_t*, int, int, uint8_t*, uint8_t*, uint8_t*,
                                      cudaStream_t);
}  // namespace tmk

extern "C" {

// Each kernel source holds its own __constant__ copy; both get the blob.
int tm_set_constants(int device, const void* host, size_t bytes) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = tmk::set_constants(host, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)tmk::set_constants_tabled(host, bytes);
}

// The 8-bit base comb of the tabled scan, (32, 128, 3, 10) int32.
int tm_set_comb(int device, const void* host, size_t bytes) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)tmk::set_comb(host, bytes);
}

const char* tm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int tm_ed25519_prepare(const void* pk, const void* msg, const void* sig, int n, int mlen, void* sd, void* kd,
                       void* neg_a, void* a_ok, void* s_ok, void* stream) {
  return (int)tmk::launch_prepare((const uint8_t*)pk, (const uint8_t*)msg, (const uint8_t*)sig, n, mlen,
                                 (int8_t*)sd, (int8_t*)kd, (int32_t*)neg_a, (uint8_t*)a_ok,
                                 (uint8_t*)s_ok, (cudaStream_t)stream);
}

int tm_ed25519_scan(const void* sd, const void* kd, const void* neg_a, int n, void* out, void* stream) {
  return (int)tmk::launch_scan((const int8_t*)sd, (const int8_t*)kd, (const int32_t*)neg_a, n,
                              (int32_t*)out, (cudaStream_t)stream);
}

int tm_ed25519_finish(const void* pt, const void* sig, const void* a_ok, const void* s_ok, const void* power,
                      const void* counted, int n, void* ok, void* tally, void* stream) {
  return (int)tmk::launch_finish((const int32_t*)pt, (const uint8_t*)sig, (const uint8_t*)a_ok,
                                (const uint8_t*)s_ok, (const int64_t*)power, (const uint8_t*)counted, n,
                                (uint8_t*)ok, (unsigned long long*)tally, (cudaStream_t)stream);
}

int tm_ed25519_build_tables(const void* pk, int v, void* tables, void* a_ok, void* stream) {
  return (int)tmk::launch_build_tables((const uint8_t*)pk, v, (int32_t*)tables, (uint8_t*)a_ok, (cudaStream_t)stream);
}

// The lanes that work one row of ed25519_scan, one validator of
// ed25519_build_tables and one row of ed25519_scan_tabled (G, compiled in).
void tm_ed25519_lanes(int* scan, int* build, int* scan_tabled) {
  *scan = tmk::scan_lanes();
  *build = tmk::build_lanes();
  *scan_tabled = tmk::scan_tabled_lanes();
}

int tm_ed25519_prepare_tabled(const void* pk_all, const void* idx, int v, const void* msg, int mlen,
                              const void* tpl, int ntpl, const void* tmpl_idx, const void* ts8, int ts_off,
                              const void* sig, int n, void* sd8, void* kd, void* s_ok, void* stream) {
  return (int)tmk::launch_prepare_tabled((const uint8_t*)pk_all, (const int32_t*)idx, v, (const uint8_t*)msg,
                                        mlen, (const uint8_t*)tpl, ntpl, (const int32_t*)tmpl_idx,
                                        (const uint8_t*)ts8, ts_off, (const uint8_t*)sig, n, (int8_t*)sd8,
                                        (int8_t*)kd, (uint8_t*)s_ok, (cudaStream_t)stream);
}

int tm_ed25519_scan_tabled(const void* sd8, const void* kd, const void* tables, const void* a_tab, const void* idx,
                           int v, int n, void* out, void* a_ok, void* stream) {
  return (int)tmk::launch_scan_tabled((const int8_t*)sd8, (const int8_t*)kd, (const int32_t*)tables,
                                     (const uint8_t*)a_tab, (const int32_t*)idx, v, n, (int32_t*)out,
                                     (uint8_t*)a_ok, (cudaStream_t)stream);
}

int tm_sha256_leaf_blocks(const void* blocks, const void* offsets, const void* counts, int n, int total, void* state,
                          void* stream) {
  return (int)tmk::launch_sha256_leaf_blocks((const uint8_t*)blocks, (const int32_t*)offsets, (const int32_t*)counts, n,
                                            total, (uint32_t*)state, (cudaStream_t)stream);
}

// The leaf states (8, stride) of n leaves -> the root in column 0 of (8,
// rstride), and with flat (8, total) non-null every level, leaves first.
int tm_merkle_tree(const void* leaves, int stride, int n, void* flat, int total, void* scratch, int sstride,
                   void* root, int rstride, void* stream) {
  return (int)tmk::launch_merkle_tree((const uint32_t*)leaves, stride, n, (uint32_t*)flat, total, (uint32_t*)scratch,
                                     sstride, (uint32_t*)root, rstride, (cudaStream_t)stream);
}

// Columns of scratch a tree of n leaves needs; *chunk its leaves a block.
int tm_merkle_tree_layout(int n, int* chunk) { return tmk::merkle_tree_layout(n, chunk); }

// The BLS12-381 constants struct (csrc/fp381.cuh), packed by ops/bls12.py.
int tm_set_bls_constants(int device, const void* host, size_t bytes) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)tmk::set_bls_constants(host, bytes);
}

// The lanes that work one row of the pairing and of the map kernel, one
// addition of the aggregate (G, compiled in), and the aggregate's points a
// block.
void tm_bls12_lanes(int* pairing, int* map, int* aggregate, int* chunk) {
  tmk::bls12_lanes(pairing, map, aggregate, chunk);
}

int tm_bls12_pairing_check(const void* pk, const void* hm, const void* sig, int n, int pairs, void* value, void* ok,
                           void* stream) {
  return (int)tmk::launch_bls12_pairing_check((const uint8_t*)pk, (const uint8_t*)hm, (const uint8_t*)sig, n, pairs,
                                             (uint8_t*)value, (uint8_t*)ok, (cudaStream_t)stream);
}

int tm_bls12_map_to_g2(const void* u0, const void* u1, int n, void* q, void* inf, void* stream) {
  return (int)tmk::launch_bls12_map_to_g2((const uint8_t*)u0, (const uint8_t*)u1, n, (uint8_t*)q, (uint8_t*)inf,
                                         (cudaStream_t)stream);
}

// Bytes of the scratch a call of B rows over V points needs.
size_t tm_bls12_g1_aggregate_scratch(int b, int v) { return tmk::bls12_g1_aggregate_scratch(b, v); }

int tm_bls12_g1_aggregate(const void* points, const void* mask, int b, int v, void* scratch, void* out, void* inf,
                          void* stream) {
  return (int)tmk::launch_bls12_g1_aggregate((const uint8_t*)points, (const uint8_t*)mask, b, v,
                                            (uint8_t*)scratch, (uint8_t*)out,
                                            (uint8_t*)inf, (cudaStream_t)stream);
}

}  // extern "C"
