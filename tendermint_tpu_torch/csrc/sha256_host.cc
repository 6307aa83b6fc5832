// The SHA-256 engine's device code (sha256.cuh: the compression, the leaf
// step, the inner node, merkle_tree's steps) built as host C++ with a
// plain C interface, for the tests: ops/sha256_host.py compiles it with g++
// and loads it with ctypes. sha256_leaf_blocks' threads run in turn, each
// through the kernel's own step (leaf_thread: the clamps, the pipelined
// chain), its stages copied with memcpy. Without nvcc `par` (lanes.cuh) runs a block's threads
// in turn over each step; the blocks of a launch run in turn too, and the
// last of them finishes the tree, as the last ticket does on the card.
// Nothing here is part of the kernels' build (ops/_build.py).
#include <cstring>
#include <memory>

#include "sha256.cuh"

using namespace tmk;

namespace {

// A thread's two stages (leaf_chain), copied at once.
struct HostStages {
  uint32_t raw[2][16];
  void fetch(int s, const uint8_t* block) { memcpy(raw[s], block, 64); }
  void commit() {}
  void wait_prev() {}
  void words(int s, uint32_t w[16]) const {
    for (int k = 0; k < 16; ++k) w[k] = sha256_bswap(raw[s][k]);
  }
};

template <int B>
void host_tree(const TreeArgs& a) {
  auto S = std::make_unique<TreeSmem<B>>();
  const Lanes L{0, B, 0};
  const int chunks = (a.n + 2 * B - 1) / (2 * B);
  bool top = false;
  for (int c = 0; c < chunks; ++c) top = tree_block<B>(L, *S, a, c);
  if (top) tree_top<B>(L, *S, a);
}

}  // namespace

extern "C" {

// sha256_leaf_blocks' arguments: every thread's step, threads in turn.
void sha_host_leaf_blocks(const uint8_t* blocks, const int32_t* offsets, const int32_t* counts, int n, int total,
                          uint32_t* state) {
  const LeafArgs a{blocks, offsets, counts, n, total, state};
  for (int i = 0; i < n; ++i) {
    HostStages s;
    leaf_thread(a, i, s);
  }
}

// The state words of sha256(0x01 || left || right) from the children's.
void sha_host_inner(const uint32_t* left, const uint32_t* right, uint32_t* st) { sha256_inner(st, left, right); }

// Columns of scratch merkle_tree needs for n leaves with chunks of 2B.
int sha_host_tree_scratch(int n, int chunk) { return tree_scratch(n, chunk / 2); }

// merkle_tree with chunks of `chunk` (64, 128, 256 or 512) leaves: the
// kernel's arguments (flat null for the root alone). Returns -1 for
// another chunk, -2 for a scratch too small.
int sha_host_merkle_tree(const uint32_t* leaves, int stride, int n, uint32_t* flat, int total, uint32_t* scratch,
                         int sstride, uint32_t* root, int rstride, int chunk) {
  const TreeArgs a{leaves, stride, n, flat, total, scratch, sstride, root, rstride};
  if (n < 1 || n > stride || sstride < tree_scratch(n, chunk / 2)) return -2;
  switch (chunk) {
    case 64: host_tree<32>(a); return 0;
    case 128: host_tree<64>(a); return 0;
    case 256: host_tree<128>(a); return 0;
    case 512: host_tree<256>(a); return 0;
  }
  return -1;
}

}  // extern "C"
