"""Time the G1 aggregate kernel (csrc/bls12_kernels.cu bls12_g1_aggregate)
at every lane group G an addition can have and several chunk sizes (the
points a block sums), at 128, 4,096 and 10,000 points, and hold each
instance's outputs identical to the plain version (ops/bls12.py
aggregate_plain).

    python3 scripts/bls_aggregate_sweep.py

The kernel library compiles the aggregate at one G and one chunk
(kAggLanes, kAggChunk). This script builds libraries of its own from
bls12_kernels.cu, one a G (2, 4, 8: their nvcc runs started together),
each with the aggregate instantiated at chunks of 32, 64, 128 and 256
points, and prints what -Xptxas -v said of each instance. The points are
P_i = P_0 + i G1 from a seeded P_0; the timed mask selects all of them
(an aggregated commit's one row), and a second mask of about half of
them, with P and -P in different chunks, is held against the plain
version too. Prints one JSON line of device times (ms a launch, CUDA
events, the median of five runs after a warm one, a sleep kernel holding
the stream while the host enqueues), then the card's name and power
limit. Needs the CUDA toolkit and one GPU; builds into
build/torch_kernels/.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANE_GROUPS = (2, 4, 8)
CHUNKS = (32, 64, 128, 256)
POINTS = (128, 4_096, 10_000)
WORDS = 36  # a partial sum: X, Y, Z of 12 words

SOURCE = r"""
#include "bls12_kernels.cu"

extern "C" int sweep_set_constants(const void* host, size_t bytes) {
  cudaError_t e = tmk::set_bls_constants(host, bytes);
#define ALLOW(C) if (e == cudaSuccess) e = tmk::allow_agg_smem<LANES, C>();
  ALLOW(32) ALLOW(64) ALLOW(128) ALLOW(256)
#undef ALLOW
  return (int)e;
}

extern "C" int sweep_aggregate(int chunk, const void* points, const void* mask, int b, int v, void* scratch,
                               void* out, void* inf, void* stream) {
  const uint8_t* p = (const uint8_t*)points;
  const uint8_t* m = (const uint8_t*)mask;
  switch (chunk) {
#define CALL(C) (int)tmk::launch_agg<LANES, C>(p, m, b, v, (uint8_t*)scratch, (uint8_t*)out, (uint8_t*)inf, \
                                               (cudaStream_t)stream)
    case 32: return CALL(32);
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 256: return CALL(256);
#undef CALL
  }
  return (int)cudaErrorInvalidValue;
}
"""


def ptxas_lines(log: str) -> dict:
    """{aggregate instance: its -Xptxas -v usage line(s)}."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if "bls12_g1_aggregate" in m.group(1) else None
            continue
        if entry and ("registers" in line or "spill" in line or "stack frame" in line):
            out.setdefault(entry, []).append(line.strip().removeprefix("ptxas info    : "))
    return out


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import device_ms, nvidia_smi
    from tendermint_tpu_torch.ops import _build, bls12
    from tendermint_tpu_torch.ops import ref_bls12 as ref

    if not torch.cuda.is_available():
        print("bls_aggregate_sweep: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "lane_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "bls_aggregate_sweep.cu"
    src.write_text(SOURCE)
    procs = {}
    for g in LANE_GROUPS:
        lib_path = out_dir / f"libbls_aggregate_sweep_{g}.so"
        cmd = [_build.nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", f"-DLANES={g}",
               "-I", str(_build._CSRC), "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib_path),
               str(src)]
        procs[g] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, {}
    for g, (lib_path, proc) in procs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at G = {g}:\n{log}")
        usage.update(ptxas_lines(log))
        lib = ctypes.CDLL(str(lib_path))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sweep_set_constants.argtypes = [vp, ctypes.c_size_t]
        lib.sweep_aggregate.argtypes = [i32, vp, vp, i32, i32, vp, vp, vp, vp]
        blob = bls12.constants_blob()
        if lib.sweep_set_constants(blob, len(blob)) != 0:
            raise RuntimeError(f"constants upload failed at G = {g}")
        libs[g] = lib
    for name, lines in sorted(usage.items()):
        print(f"  {name}: " + "; ".join(lines))

    rng = np.random.default_rng(20261020)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = [ref.g1_mul(int(rng.integers(1, 1 << 62)), ref.G1_GEN)]
    for _ in range(POINTS[-1] - 1):
        table.append(ref.g1_add(table[-1], ref.G1_GEN))

    def aggregate(g, chunk, pts, mask):
        b, v = mask.shape
        nblk = max(1, -(-v // chunk))
        scratch = torch.empty(b * nblk * WORDS * 4 + b * 4, dtype=torch.uint8, device=dev)
        out = torch.empty((b, 2, bls12.FP_BYTES), dtype=torch.uint8, device=dev)
        inf = torch.empty((b,), dtype=torch.bool, device=dev)
        code = libs[g].sweep_aggregate(chunk, pts.data_ptr(), mask.data_ptr(), b, v, scratch.data_ptr(),
                                       out.data_ptr(), inf.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"aggregate launch at G = {g}, chunk {chunk}: CUDA error {code}")
        return out, inf

    report = {}
    for v in POINTS:
        pts = table[:v]
        pts[v // 2] = ref.g1_neg(pts[1])  # P_1 and -P_1 in different chunks
        pt = bls12.g1_tensor(pts, dev)
        masks = np.ones((2, v), dtype=bool)
        masks[1] = rng.random(v) < 0.5
        masks[1, [1, v // 2]] = True
        mk = torch.from_numpy(masks).to(dev)
        want = bls12.aggregate_plain(pt, mk)
        timed = mk[:1].contiguous()
        report[v] = {}
        for g in LANE_GROUPS:
            for chunk in CHUNKS:
                if not all(torch.equal(x, y) for x, y in zip(aggregate(g, chunk, pt, mk), want)):
                    raise RuntimeError(f"the aggregate at G = {g}, chunk {chunk}, {v} points differs from the "
                                       "plain version")
                report[v][f"G{g}_chunk{chunk}"] = device_ms(lambda: aggregate(g, chunk, pt, timed), reps=10)
    print(json.dumps({"ms_device_only": report, "ptxas": usage, "identical_to_plain": True}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
