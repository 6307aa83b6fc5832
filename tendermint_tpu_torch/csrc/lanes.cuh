// A row's lanes: the group of threads that works one row of a
// lane-staged kernel (the BLS pairing check and map, bls12_curve.cuh;
// the ed25519 scan and table build, ge25519_lanes.cuh), and `par`, which
// runs one stage of a row's work over them.
//
// On the device each lane takes the items lane, lane + G, ... of a
// stage, then the row syncs: __syncwarp over its lanes, or
// __syncthreads where a row is a block of several warps. On the host
// (the g++ builds of the headers, csrc/*_host.cc) every lane's share runs
// in turn, which computes the same values as long as no item of a stage
// reads what another item of it writes.
#pragma once

struct Lanes {
  int lane;       // this lane within the row's group (device)
  int g;          // lanes a row: a divisor of 32, or a block of several warps
  unsigned mask;  // the group's lanes in the warp (device, g <= 32)
};

// One stage: items 0..n-1 over the row's lanes, then the row's sync.
template <class F>
#if defined(__CUDACC__)
static __device__ __forceinline__
#else
static inline
#endif
void par(const Lanes& L, int n, F f) {
#if defined(__CUDA_ARCH__)
  for (int i = L.lane; i < n; i += L.g) f(i);
  if (L.g > 32)
    __syncthreads();
  else
    __syncwarp(L.mask);
#else
  for (int lane = 0; lane < L.g; ++lane)
    for (int i = lane; i < n; i += L.g) f(i);
#endif
}
