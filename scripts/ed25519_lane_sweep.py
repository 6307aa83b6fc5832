"""Time ed25519_scan, ed25519_build_tables and ed25519_scan_tabled
(csrc/ed25519_kernels.cu, csrc/ed25519_tabled.cu) at every lane group G a
row or validator can have, and hold each G's outputs identical to the
plain versions (ops/ed25519.py scan_plain, build_tables_plain,
scan_tabled_plain).

    python3 scripts/ed25519_lane_sweep.py [--kernels scan,build,scan_tabled]

The kernel library compiles each kernel at one G (kScanLanes,
kBuildLanes, kScanTabledLanes). This script builds a library of its own
from both sources with the two scans instantiated at G = 2, 4, 8 and the
build at G = 2, 4, 8, 16, and prints what -Xptxas -v said of each
instance (registers, spills). The scan runs at 9,510 rows (a
10,000-validator commit's present rows) and 28,500 (a light client's
verify_chain over two such sets), its inputs from the port's prepare
kernel on rows of random keys, messages and signatures; the build at
10,000 validators of random keys (about half of them undecodable, whose
garbage points are tabulated too); the tabled scan over those tables at
4,737 rows (verify_commit_trusting's) and 9,510 (verify_commit's), each
row a distinct validator in index order, its digits from the tabled
prepare kernel; all from a fixed seed. Prints one JSON line of device times (ms a launch, CUDA
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

SCAN_LANES = (2, 4, 8)
BUILD_LANES = (2, 4, 8, 16)
SCAN_ROWS = (9_510, 28_500)
VALIDATORS = 10_000
TABLED_ROWS = (4_737, 9_510)
KERNELS = ("scan", "build", "scan_tabled")

SOURCE = r"""
#include "ed25519_kernels.cu"
#include "ed25519_tabled.cu"

extern "C" int sweep_set_constants(const void* host, size_t bytes) {
  cudaError_t e = tmk::set_constants(host, bytes);
  if (e == cudaSuccess) e = tmk::set_constants_tabled(host, bytes);
  if (e == cudaSuccess) e = tmk::allow_build_smem<2>();
  if (e == cudaSuccess) e = tmk::allow_build_smem<4>();
  if (e == cudaSuccess) e = tmk::allow_build_smem<8>();
  if (e == cudaSuccess) e = tmk::allow_build_smem<16>();
  return (int)e;
}

extern "C" int sweep_scan(int g, const void* sd, const void* kd, const void* neg_a, int n, void* out, void* stream) {
  const int8_t* s = (const int8_t*)sd;
  const int8_t* k = (const int8_t*)kd;
  const int32_t* a = (const int32_t*)neg_a;
  int32_t* o = (int32_t*)out;
  switch (g) {
    case 2: return (int)tmk::launch_scan_at<2>(s, k, a, n, o, (cudaStream_t)stream);
    case 4: return (int)tmk::launch_scan_at<4>(s, k, a, n, o, (cudaStream_t)stream);
    case 8: return (int)tmk::launch_scan_at<8>(s, k, a, n, o, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sweep_scan_tabled(int g, const void* sd8, const void* kd, const void* tables, const void* a_tab,
                                 const void* idx, int v, int n, void* out, void* a_ok, void* stream) {
  const int8_t* s = (const int8_t*)sd8;
  const int8_t* k = (const int8_t*)kd;
  const int32_t* t = (const int32_t*)tables;
  const uint8_t* a = (const uint8_t*)a_tab;
  const int32_t* i = (const int32_t*)idx;
  switch (g) {
#define CALL(G) (int)tmk::launch_scan_tabled_at<G>(s, k, t, a, i, v, n, (int32_t*)out, (uint8_t*)a_ok, \
                                                   (cudaStream_t)stream)
    case 2: return CALL(2);
    case 4: return CALL(4);
    case 8: return CALL(8);
#undef CALL
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sweep_set_comb(const void* host, size_t bytes) { return (int)tmk::set_comb(host, bytes); }

extern "C" int sweep_build(int g, const void* pk, int v, void* tables, void* a_ok, void* stream) {
  const uint8_t* p = (const uint8_t*)pk;
  int32_t* t = (int32_t*)tables;
  uint8_t* a = (uint8_t*)a_ok;
  switch (g) {
    case 2: return (int)tmk::launch_build_tables_at<2>(p, v, t, a, (cudaStream_t)stream);
    case 4: return (int)tmk::launch_build_tables_at<4>(p, v, t, a, (cudaStream_t)stream);
    case 8: return (int)tmk::launch_build_tables_at<8>(p, v, t, a, (cudaStream_t)stream);
    case 16: return (int)tmk::launch_build_tables_at<16>(p, v, t, a, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def ptxas_lines(log: str) -> dict:
    """{kernel instance: its -Xptxas -v usage line(s)} for the three kernels."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if re.search(r"ed25519_scan(_tabled)?I|ed25519_build_tablesI", m.group(1)) else None
            continue
        if entry and ("registers" in line or "spill" in line or "stack frame" in line):
            out.setdefault(entry, []).append(line.strip().removeprefix("ptxas info    : "))
    return out


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from chip_smoke import device_ms, nvidia_smi
    from tendermint_tpu_torch.ops import _build, field
    from tendermint_tpu_torch.ops import ed25519 as ed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS), help="a comma-separated subset of " + ", ".join(KERNELS))
    kernels = set(ap.parse_args().kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(kernels - set(KERNELS))}")
    if not torch.cuda.is_available():
        print("ed25519_lane_sweep: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "lane_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "ed25519_lane_sweep.cu"
    src.write_text(SOURCE)
    lib_path = out_dir / "libed25519_lane_sweep.so"
    res = subprocess.run([_build.nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I",
                          str(_build._CSRC), "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib_path),
                          str(src)], capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    usage = ptxas_lines(res.stdout + res.stderr)
    for name, lines in sorted(usage.items()):
        print(f"  {name}: " + "; ".join(lines))
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sweep_set_constants.argtypes = [vp, ctypes.c_size_t]
    lib.sweep_scan.argtypes = [i32, vp, vp, vp, i32, vp, vp]
    lib.sweep_build.argtypes = [i32, vp, i32, vp, vp, vp]
    lib.sweep_scan_tabled.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32, vp, vp, vp]
    lib.sweep_set_comb.argtypes = [vp, ctypes.c_size_t]
    blob = _build.constants_blob()
    if lib.sweep_set_constants(blob, len(blob)) != 0:
        raise RuntimeError("constants upload failed")
    blob = _build.comb_blob()
    if lib.sweep_set_comb(blob, len(blob)) != 0:
        raise RuntimeError("base comb upload failed")

    rng = np.random.default_rng(20261019)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rand = lambda *shape: torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)  # noqa: E731
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731

    def scan(g, sd, kd, neg_a):
        out = torch.empty((sd.shape[0], 4, 10), dtype=torch.int32, device=dev)
        code = lib.sweep_scan(g, sd.data_ptr(), kd.data_ptr(), neg_a.data_ptr(), sd.shape[0], out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"scan launch at G = {g}: CUDA error {code}")
        return out

    def build(g, pk):
        tables = torch.empty((pk.shape[0], 16, 8, 3, 10), dtype=torch.int32, device=dev)
        a_ok = torch.empty((pk.shape[0],), dtype=torch.bool, device=dev)
        code = lib.sweep_build(g, pk.data_ptr(), pk.shape[0], tables.data_ptr(), a_ok.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"build launch at G = {g}: CUDA error {code}")
        return tables, a_ok

    def scan_tabled(g, sd8, kd, tables, a_ok, idx):
        n = sd8.shape[0]
        out = torch.empty((n, 4, 10), dtype=torch.int32, device=dev)
        row_ok = torch.empty((n,), dtype=torch.bool, device=dev)
        code = lib.sweep_scan_tabled(g, sd8.data_ptr(), kd.data_ptr(), tables.data_ptr(), a_ok.data_ptr(),
                                     idx.data_ptr(), tables.shape[0], n, out.data_ptr(), row_ok.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"tabled scan launch at G = {g}: CUDA error {code}")
        return out, row_ok

    report = {}
    if "scan" in kernels:
        report["ed25519_scan"] = {}
        for n in SCAN_ROWS:
            sd, kd, neg_a, _a_ok, _s_ok = ed.verify_stage_prepare(rand(n, 32), rand(n, 160), rand(n, 64))
            want = fb(ed.scan_plain(sd, kd, neg_a))
            for g in SCAN_LANES:
                if not torch.equal(fb(scan(g, sd, kd, neg_a)), want):
                    raise RuntimeError(f"ed25519_scan at G = {g}, {n} rows, differs from the plain version")
            report["ed25519_scan"][n] = {g: device_ms(lambda: scan(g, sd, kd, neg_a), reps=10) for g in SCAN_LANES}
    pk = rand(VALIDATORS, 32)
    if "build" in kernels:
        want = [ed.build_tables_plain(pk[o:o + 1024]) for o in range(0, VALIDATORS, 1024)]
        want_t = torch.cat([fb(t) for t, _ in want])
        want_ok = torch.cat([a for _, a in want])
        report["undecodable_keys"] = int((~want_ok).sum())
        for g in BUILD_LANES:
            tables, a_ok = build(g, pk)
            if not (torch.equal(fb(tables), want_t) and torch.equal(a_ok, want_ok)):
                raise RuntimeError(f"ed25519_build_tables at G = {g} differs from the plain version")
        report["ed25519_build_tables"] = {VALIDATORS: {g: device_ms(lambda: build(g, pk), reps=5)
                                                       for g in BUILD_LANES}}
    if "scan_tabled" in kernels:
        report["ed25519_scan_tabled"] = {}
        tables, a_ok = ed.build_valset_tables(pk)
        for n in TABLED_ROWS:
            idx = torch.from_numpy(np.sort(rng.choice(VALIDATORS, n, replace=False)).astype(np.int32)).to(dev)
            sd8, kd, _s_ok = ed.verify_stage_prepare_tabled(pk, rand(n, 64), idx=idx, msgs=rand(n, 160))
            point, row_ok = ed.scan_tabled_plain(sd8, kd, tables, a_ok, idx)
            for g in SCAN_LANES:
                got, got_ok = scan_tabled(g, sd8, kd, tables, a_ok, idx)
                if not (torch.equal(fb(got), fb(point)) and torch.equal(got_ok, row_ok)):
                    raise RuntimeError(f"ed25519_scan_tabled at G = {g}, {n} rows, differs from the plain version")
            report["ed25519_scan_tabled"][n] = {g: device_ms(lambda: scan_tabled(g, sd8, kd, tables, a_ok, idx),
                                                             reps=10) for g in SCAN_LANES}
    undecodable = report.pop("undecodable_keys", None)
    print(json.dumps({"ms_device_only_by_lanes": report, "undecodable_keys": undecodable, "ptxas": usage,
                      "identical_to_plain": True}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
