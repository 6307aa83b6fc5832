"""Time one BLS12-381 Fp product on the card, in the two forms that
csrc/fp381.cuh holds, and hold them equal: the kernels' fp_mul (CIOS in
PTX carry chains) and its portable twin (u64 accumulators, compiled for
the device with BLS_PORTABLE_FP).

    python3 scripts/bls_fp_mul_bench.py

For each form: the latency of one product (one warp, each thread a chain
of dependent products), the throughput of many warps (independent
chains on every SM), and the static sm_90a SASS instruction count of one
product (chip_smoke.py's fp_mul probe). Prints one JSON line, then the
card's name and power limit. Needs the CUDA toolkit and one GPU; builds
into build/torch_kernels/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "fp381.cuh"
using namespace bls;

// Each thread: x = x * y, n times.
__global__ void chain(const Fp* a, const Fp* b, Fp* out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  Fp x = a[t], y = b[t];
  for (int i = 0; i < n; ++i) fp_mul(x, x, y);
  out[t] = x;
}

extern "C" int set_constants(const void* host, size_t bytes) {
  if (bytes != sizeof(Constants)) return -1;
  return (int)cudaMemcpyToSymbol(c_bls, host, bytes);
}

extern "C" int launch(const void* a, const void* b, void* out, int blocks, int threads, int n) {
  chain<<<blocks, threads>>>((const Fp*)a, (const Fp*)b, (Fp*)out, n);
  return (int)cudaGetLastError();
}
"""

LATENCY_CHAIN = 20_000
THROUGHPUT_CHAIN = 2_000
THROUGHPUT_BLOCKS, THROUGHPUT_THREADS = 132 * 16, 128


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import FP_MUL_FORMS, fp_mul_instructions, nvidia_smi
    from tendermint_tpu_torch.ops import _build, bls12

    if not torch.cuda.is_available():
        print("bls_fp_mul_bench: no CUDA device", file=sys.stderr)
        return 2
    nvcc = Path(_build.nvcc_path())
    out_dir = _build.BUILD_DIR / "fp_mul_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fp_mul_bench.cu"
    src.write_text(SOURCE)
    blob = bls12.constants_blob()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for form, defines in FP_MUL_FORMS.items():
        lib_path = out_dir / f"libfp_mul_bench_{form}.so"
        subprocess.run([str(nvcc), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *defines, "-I",
                        str(_build._CSRC), "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(lib_path))
        lib.set_constants.argtypes = [vp, ctypes.c_size_t]
        lib.launch.argtypes = [vp, vp, vp, i32, i32, i32]
        if lib.set_constants(blob, len(blob)) != 0:
            raise RuntimeError("constants upload failed")
        libs[form] = lib
    sass = fp_mul_instructions()

    p, r = bls12.P, 1 << 384
    rng = np.random.default_rng(20261018)
    total = THROUGHPUT_BLOCKS * THROUGHPUT_THREADS

    def limbs(count):  # random values below p as (count, 12) little-endian uint32 words
        w = rng.integers(0, 1 << 32, (count, 12), dtype=np.uint64).astype(np.uint32)
        w[:, 11] %= np.uint32(p >> 352)
        return w

    a = torch.from_numpy(limbs(total).view(np.int32)).cuda()
    b = torch.from_numpy(limbs(total).view(np.int32)).cuda()
    outs = {form: torch.empty_like(a) for form in libs}

    def run(form, blocks, threads, n):
        code = libs[form].launch(a.data_ptr(), b.data_ptr(), outs[form].data_ptr(), blocks, threads, n)
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")

    def timed(form, blocks, threads, n, repeats=5):
        run(form, blocks, threads, n)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(repeats):
            start.record()
            run(form, blocks, threads, n)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    report = {}
    for form in libs:
        lat_ms = timed(form, 1, 32, LATENCY_CHAIN)
        thr_ms = timed(form, THROUGHPUT_BLOCKS, THROUGHPUT_THREADS, THROUGHPUT_CHAIN)
        report[form] = {
            "latency_ns_per_product_one_warp": 1e6 * lat_ms / LATENCY_CHAIN,
            "products_per_s_all_sms": total * THROUGHPUT_CHAIN / (1e-3 * thr_ms),
            "sass_instructions": None if sass is None else sass[form][0],
            "sass": None if sass is None else sass[form][1],
        }
    for form in libs:
        run(form, THROUGHPUT_BLOCKS, THROUGHPUT_THREADS, 64)
    torch.cuda.synchronize()
    same = bool(torch.equal(outs["kernels"], outs["portable_u64"]))
    # one chain checked against Python integers
    x = int.from_bytes(a[0].cpu().numpy().astype(np.uint32).tobytes(), "little")
    y = int.from_bytes(b[0].cpu().numpy().astype(np.uint32).tobytes(), "little")
    rinv = pow(r, -1, p)
    for _ in range(64):
        x = x * y * rinv % p
    got = int.from_bytes(outs["kernels"][0].cpu().numpy().astype(np.uint32).tobytes(), "little")
    if not same or got != x:
        raise RuntimeError(f"the two forms disagree ({same}) or differ from Python integers ({got == x})")
    report.update(identical_on_random_chains=total, chain_lengths={"latency": LATENCY_CHAIN,
                                                                   "throughput": THROUGHPUT_CHAIN},
                  throughput_grid=[THROUGHPUT_BLOCKS, THROUGHPUT_THREADS])
    print(json.dumps({"fp_mul": report}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
