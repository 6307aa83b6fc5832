"""Time the BLS pairing and map kernels (csrc/bls12_kernels.cu) at every
lane group G a row can have, at a commit check's 120 rows, and hold each
G's outputs identical to the plain versions (ops/bls12.py pairing_plain,
map_plain).

    python3 scripts/bls_lane_sweep.py

The kernel library compiles each kernel at one G (kPairingLanes,
kMapLanes). This script builds a library of its own from
bls12_kernels.cu with both kernels instantiated at G = 4, 8, 16, 32 (a
group of one warp), 64 and 128 (a block of warps). The pairing rows are
valid signatures (pk = a G1, H(m) = b G2, sig = ab G2), the map's inputs
hash_to_field of random messages, all from a fixed seed. Prints one JSON
line of device times (ms a launch, CUDA events, the median of five runs
of 5 launches each after a warm one), then the card's name and power
limit. Needs the CUDA toolkit and one GPU; builds into
build/torch_kernels/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANE_GROUPS = (4, 8, 16, 32, 64, 128)
ROWS = 120

SOURCE = r"""
#include "bls12_kernels.cu"

namespace {

template <int G>
int pairing_at(const void* pk, const void* hm, const void* sig, int n, void* value, void* ok, void* stream) {
  cudaError_t e = tmk::allow_row_smem<bls::PairRow, G>(tmk::bls12_pairing_check<G>);
  if (e == cudaSuccess)
    e = tmk::launch_rows<bls::PairRow, G>(tmk::bls12_pairing_check<G>, n, (cudaStream_t)stream,
                                          (const uint8_t*)pk, (const uint8_t*)hm, (const uint8_t*)sig, n, 2,
                                          (uint8_t*)value, (uint8_t*)ok);
  return (int)e;
}

template <int G>
int map_at(const void* u0, const void* u1, int n, void* q, void* inf, void* stream) {
  cudaError_t e = tmk::allow_row_smem<bls::MapRow, G>(tmk::bls12_map_to_g2<G>);
  if (e == cudaSuccess)
    e = tmk::launch_rows<bls::MapRow, G>(tmk::bls12_map_to_g2<G>, n, (cudaStream_t)stream, (const uint8_t*)u0,
                                         (const uint8_t*)u1, n, (uint8_t*)q, (uint8_t*)inf);
  return (int)e;
}

}  // namespace

extern "C" int sweep_set_constants(const void* host, size_t bytes) {
  return (int)tmk::set_bls_constants(host, bytes);
}

extern "C" int sweep_pairing(int g, const void* pk, const void* hm, const void* sig, int n, void* value, void* ok,
                             void* stream) {
  switch (g) {
#define CALL(G) pairing_at<G>(pk, hm, sig, n, value, ok, stream)
    case 4: return CALL(4);
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
#undef CALL
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sweep_map(int g, const void* u0, const void* u1, int n, void* q, void* inf, void* stream) {
  switch (g) {
#define CALL(G) map_at<G>(u0, u1, n, q, inf, stream)
    case 4: return CALL(4);
    case 8: return CALL(8);
    case 16: return CALL(16);
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
#undef CALL
  }
  return (int)cudaErrorInvalidValue;
}
"""


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import device_ms, nvidia_smi
    from tendermint_tpu_torch.ops import _build, bls12
    from tendermint_tpu_torch.ops import ref_bls12 as ref

    if not torch.cuda.is_available():
        print("bls_lane_sweep: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "lane_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "bls_lane_sweep.cu"
    src.write_text(SOURCE)
    lib_path = out_dir / "libbls_lane_sweep.so"
    subprocess.run([_build.nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I",
                    str(_build._CSRC), "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=900)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sweep_set_constants.argtypes = [vp, ctypes.c_size_t]
    lib.sweep_pairing.argtypes = [i32, vp, vp, vp, i32, vp, vp, vp]
    lib.sweep_map.argtypes = [i32, vp, vp, i32, vp, vp, vp]
    blob = bls12.constants_blob()
    if lib.sweep_set_constants(blob, len(blob)) != 0:
        raise RuntimeError("constants upload failed")

    rng = np.random.default_rng(20261018)
    dev = torch.device("cuda")
    a = [int(x) for x in rng.integers(1, 1 << 62, ROWS)]
    b = [int(x) for x in rng.integers(1, 1 << 62, ROWS)]
    pk = bls12.g1_tensor([ref.g1_mul(x, ref.G1_GEN) for x in a], dev)
    hm = bls12.g2_tensor([ref.g2_mul(y, ref.G2_GEN) for y in b], dev)
    sg = bls12.g2_tensor([ref.g2_mul(x * y, ref.G2_GEN) for x, y in zip(a, b)], dev)
    us = [ref.hash_to_field_fp2(rng.bytes(40), ref.DST_SIG, 2) for _ in range(ROWS)]
    u0 = bls12.fp2_tensor([u[0] for u in us], dev)
    u1 = bls12.fp2_tensor([u[1] for u in us], dev)
    pref, mref = bls12.pairing_plain(pk, hm, sg), bls12.map_plain(u0, u1)
    if not bool(pref[0].all()):
        raise RuntimeError("the plain version rejects a valid row")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def pairing(g):
        ok = torch.empty((ROWS,), dtype=torch.bool, device=dev)
        value = torch.empty((ROWS, 2, 3, 2, bls12.FP_BYTES), dtype=torch.uint8, device=dev)
        code = lib.sweep_pairing(g, pk.data_ptr(), hm.data_ptr(), sg.data_ptr(), ROWS, value.data_ptr(),
                                 ok.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"pairing launch at G = {g}: CUDA error {code}")
        return ok, value

    def mapped(g):
        q = torch.empty((ROWS, 2, 2, bls12.FP_BYTES), dtype=torch.uint8, device=dev)
        inf = torch.empty((ROWS,), dtype=torch.bool, device=dev)
        code = lib.sweep_map(g, u0.data_ptr(), u1.data_ptr(), ROWS, q.data_ptr(), inf.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"map launch at G = {g}: CUDA error {code}")
        return q, inf

    report = {"bls12_pairing_check": {}, "bls12_map_to_g2": {}}
    for g in LANE_GROUPS:
        if not all(torch.equal(x, y) for x, y in zip(pairing(g) + mapped(g), pref + mref)):
            raise RuntimeError(f"the kernels at G = {g} differ from the plain versions")
        report["bls12_pairing_check"][g] = device_ms(lambda: pairing(g), reps=5)
        report["bls12_map_to_g2"][g] = device_ms(lambda: mapped(g), reps=5)
    print(json.dumps({"rows": ROWS, "ms_device_only_by_lanes": report, "identical_to_plain": True}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
