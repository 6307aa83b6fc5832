"""Time ed25519_prepare_tabled (csrc/ed25519_tabled.cu) at every block
size it can be compiled with and merkle_tree (csrc/sha256_kernels.cu) at
every chunk size, each form held identical to its plain version
(ops/ed25519.py prepare_tabled_plain, ops/sha256.py merkle_tree_plain).

    python3 scripts/prepare_tree_sweep.py [--parent DIR] [--rounds 3]

The kernel library compiles each kernel at one size (kPrepRows,
kTreeThreads). This script builds a library of its own from both sources
with the tabled prepare instantiated at 32, 64 and 128 rows a block and
the tree at 32, 64, 128 and 256 threads a block (chunks of 64, 128, 256
and 512 leaves), and prints what -Xptxas -v said of each instance
(registers, stack frame, spills). With --parent, a checkout of the
commit before the redesign (its tendermint_tpu_torch/csrc), it also
builds that commit's ed25519_prepare_tabled (one thread a row, bytes
read one at a time) and merkle_inner_level (a launch a level) and times
them in the same turns: the prepare as it was, the inner levels as the
engine ran them (down to the first width <= 128, the rest on the host)
and all of them up to the root.

The prepare runs on a 10,000-validator set's keys at 9,510 rows (a
commit's present rows) and 4,737 (verify_commit_trusting's), each row a
distinct validator in index order with one of three 160-byte templates
and its timestamp at byte 93 (the sign-bytes' layout), each block size
also checked at 9,510 rows with the timestamp at bytes 88-95 (every
offset mod 8) against the plain version; the tree on random
leaf states of 2 (one inner node: a level's latency), 10,000, 100,000 and
1,000,000 leaves; all from a fixed seed. Every form is timed in each of
--rounds turns, the order of the forms reversed every other turn; a time
is the device alone (chip_smoke.device_ms: a sleep kernel holding the
stream while the host enqueues, the median of five runs after a warm
one). Prints one JSON line of the medians over the turns and every
turn's time, then the card's name and power limit. Needs the CUDA
toolkit and one GPU; builds into build/torch_kernels/.
"""

from __future__ import annotations

import ctypes
import json
import re
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PREP_ROWS = (32, 64, 128)
TREE_THREADS = (32, 64, 128, 256)
PREP_N = (4_737, 9_510)
TREE_N = (2, 10_000, 100_000, 1_000_000)
VALIDATORS = 10_000
HOST_TAIL_WIDTH = 128  # the parent's engine finished levels this narrow on the host

SOURCE = r"""
#include "ed25519_tabled.cu"
#include "sha256_kernels.cu"

extern "C" int sweep_set_constants(const void* host, size_t bytes) {
  return (int)tmk::set_constants_tabled(host, bytes);
}

extern "C" int sweep_prepare(int rows, const void* pk_all, const void* idx, int v, const void* tpl, int mlen, int ntpl,
                             const void* tmpl_idx, const void* ts8, int ts_off, const void* sig, int n, void* sd8,
                             void* kd, void* s_ok, void* stream) {
  const PrepArgs a{(const uint8_t*)pk_all, (const int32_t*)idx, v, nullptr, mlen, (const uint8_t*)tpl, ntpl,
                    (const int32_t*)tmpl_idx, (const uint8_t*)ts8, ts_off, (const uint8_t*)sig, n, (int8_t*)sd8,
                    (int8_t*)kd, (uint8_t*)s_ok};
  switch (rows) {
    case 32: return (int)tmk::launch_prepare_tabled_at<32>(a, (cudaStream_t)stream);
    case 64: return (int)tmk::launch_prepare_tabled_at<64>(a, (cudaStream_t)stream);
    case 128: return (int)tmk::launch_prepare_tabled_at<128>(a, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sweep_tree_scratch(int threads, int n) { return tmk::tree_scratch(n, threads); }

extern "C" int sweep_tree(int threads, const void* leaves, int n, void* scratch, int sstride, void* root,
                          void* stream) {
  const tmk::TreeArgs a{(const uint32_t*)leaves, n, n, nullptr, 0, (uint32_t*)scratch, sstride, (uint32_t*)root, 1};
  switch (threads) {
    case 32: return (int)tmk::launch_merkle_tree_at<32>(a, (cudaStream_t)stream);
    case 64: return (int)tmk::launch_merkle_tree_at<64>(a, (cudaStream_t)stream);
    case 128: return (int)tmk::launch_merkle_tree_at<128>(a, (cudaStream_t)stream);
    case 256: return (int)tmk::launch_merkle_tree_at<256>(a, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""

# The parent commit's kernels through their own launch functions.
PARENT_SOURCE = r"""
#include "ed25519_tabled.cu"
#include "sha256_kernels.cu"

extern "C" int parent_set_constants(const void* host, size_t bytes) {
  return (int)tmk::set_constants_tabled(host, bytes);
}

extern "C" int parent_prepare(const void* pk_all, const void* idx, int v, const void* tpl, int mlen, int ntpl,
                              const void* tmpl_idx, const void* ts8, int ts_off, const void* sig, int n, void* sd8,
                              void* kd, void* s_ok, void* stream) {
  return (int)tmk::launch_prepare_tabled((const uint8_t*)pk_all, (const int32_t*)idx, v, nullptr, mlen,
                                        (const uint8_t*)tpl, ntpl, (const int32_t*)tmpl_idx, (const uint8_t*)ts8,
                                        ts_off, (const uint8_t*)sig, n, (int8_t*)sd8, (int8_t*)kd, (uint8_t*)s_ok,
                                        (cudaStream_t)stream);
}

extern "C" int parent_inner_level(const void* level, int c, int m, void* out, void* stream) {
  return (int)tmk::launch_merkle_inner_level((const uint32_t*)level, c, m, (uint32_t*)out, (cudaStream_t)stream);
}
"""


def ptxas_lines(log: str, pattern: str) -> dict:
    """{kernel instance: its -Xptxas -v usage line(s)} for the entries
    whose mangled name matches `pattern`."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if entry and ("registers" in line or "spill" in line or "stack frame" in line):
            out.setdefault(entry, []).append(line.strip().removeprefix("ptxas info    : "))
    return out


def build(source: str, csrc: Path, name: str):
    """Compile `source` against the headers in `csrc` into a library of
    build/torch_kernels/sweep/: (its ctypes handle, its -Xptxas -v log)."""
    from tendermint_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    lib_path = out_dir / f"lib{name}.so"
    res = subprocess.run([_build.nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I",
                          str(csrc), "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib_path),
                          str(src)], capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib_path)), res.stdout + res.stderr


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from chip_smoke import device_ms, nvidia_smi
    from tendermint_tpu_torch.codec.signbytes import SIGN_BYTES_LEN, TIMESTAMP_OFFSET
    from tendermint_tpu_torch.ops import _build, sha512
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import sha256 as sha

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the commit before the redesign")
    ap.add_argument("--rounds", type=int, default=3, help="turns of every form")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prepare_tree_sweep: no CUDA device", file=sys.stderr)
        return 2
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib, log = build(SOURCE, _build._CSRC, "prepare_tree_sweep")
    usage = ptxas_lines(log, r"ed25519_prepare_tabledI|merkle_treeI")
    lib.sweep_set_constants.argtypes = [vp, ctypes.c_size_t]
    lib.sweep_prepare.argtypes = [i32, vp, vp, i32, vp, i32, i32, vp, vp, i32, vp, i32, vp, vp, vp, vp]
    lib.sweep_tree_scratch.argtypes = [i32, i32]
    lib.sweep_tree.argtypes = [i32, vp, i32, vp, i32, vp, vp]
    blob = _build.constants_blob()
    if lib.sweep_set_constants(blob, len(blob)) != 0:
        raise RuntimeError("constants upload failed")
    parent = None
    if args.parent is not None:
        parent, plog = build(PARENT_SOURCE, args.parent / "tendermint_tpu_torch" / "csrc", "parent_sweep")
        usage.update({f"parent {k}": v for k, v in
                      ptxas_lines(plog, r"ed25519_prepare_tabled|merkle_inner_level").items()})
        parent.parent_set_constants.argtypes = [vp, ctypes.c_size_t]
        parent.parent_prepare.argtypes = [vp, vp, i32, vp, i32, i32, vp, vp, i32, vp, i32, vp, vp, vp, vp]
        parent.parent_inner_level.argtypes = [vp, i32, i32, vp, vp]
        # the parent's constants struct ended with SHA-512's round constants
        pblob = blob + struct.pack("<80Q", *sha512.K)
        if parent.parent_set_constants(pblob, len(pblob)) != 0:
            raise RuntimeError("the parent's constants upload failed")
    for name, lines in sorted(usage.items()):
        print(f"  {name}: " + "; ".join(lines))

    rng = np.random.default_rng(20261019)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rand = lambda *shape: torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)  # noqa: E731

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def prepare(call, pk, src, sig, ts_off=TIMESTAMP_OFFSET):
        n = sig.shape[0]
        sd8 = torch.empty((n, 32), dtype=torch.int8, device=dev)
        kd = torch.empty((n, 64), dtype=torch.int8, device=dev)
        s_ok = torch.empty(n, dtype=torch.bool, device=dev)
        tpl = src["templates"]
        check(call(pk.data_ptr(), src["idx"].data_ptr(), pk.shape[0], tpl.data_ptr(), tpl.shape[1], tpl.shape[0],
                   src["tmpl_idx"].data_ptr(), src["ts8"].data_ptr(), ts_off, sig.data_ptr(), n,
                   sd8.data_ptr(), kd.data_ptr(), s_ok.data_ptr(), stream), "prepare launch")
        return sd8, kd, s_ok

    def tree(threads, leaves):
        n = leaves.shape[1]
        cols = lib.sweep_tree_scratch(threads, n)
        scratch = torch.empty((8, cols), dtype=torch.int32, device=dev)
        root = torch.empty((8, 1), dtype=torch.int32, device=dev)
        check(lib.sweep_tree(threads, leaves.data_ptr(), n, scratch.data_ptr(), cols, root.data_ptr(), stream),
              f"tree launch at {threads} threads")
        return root

    def inner_levels(level, down_to):
        m = level.shape[1]
        while m > down_to:
            out = torch.empty((8, (m + 1) // 2), dtype=torch.int32, device=dev)
            check(parent.parent_inner_level(level.data_ptr(), level.shape[1], m, out.data_ptr(), stream),
                  "inner level launch")
            level, m = out, (m + 1) // 2
        return level

    forms = {}  # (kernel, n) -> {form: fn}
    pk = rand(VALIDATORS, 32)
    templates = rand(3, SIGN_BYTES_LEN)
    for n in PREP_N:
        src = {"idx": torch.from_numpy(np.sort(rng.choice(VALIDATORS, n, replace=False)).astype(np.int32)).to(dev),
               "templates": templates,
               "tmpl_idx": torch.from_numpy(rng.choice(3, n, p=[0.9, 0.05, 0.05]).astype(np.int32)).to(dev),
               "ts8": rand(n, 8)}
        sig = rand(n, 64)
        want = ed.prepare_tabled_plain(pk, sig, **src)
        fns = {f"rows {r}": (lambda r=r, src=src, sig=sig: prepare(
            lambda *a: lib.sweep_prepare(r, *a), pk, src, sig)) for r in PREP_ROWS}
        if parent is not None:
            fns["parent"] = lambda src=src, sig=sig: prepare(parent.parent_prepare, pk, src, sig)
        for form, fn in fns.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise RuntimeError(f"ed25519_prepare_tabled ({form}) at {n} rows differs from the plain version")
        forms[("ed25519_prepare_tabled", n)] = fns
    # the timestamp at every byte offset mod 8, every block size, against
    # the plain version on the rows' sign-bytes spliced at that offset
    for ts_off in range(88, 96):
        rows = src["templates"][src["tmpl_idx"].long()].clone()
        rows[:, ts_off:ts_off + 8] = src["ts8"]
        want = ed.prepare_tabled_plain(pk, sig, idx=src["idx"], msgs=rows)
        for r in PREP_ROWS:
            got = prepare(lambda *a: lib.sweep_prepare(r, *a), pk, src, sig, ts_off)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"ed25519_prepare_tabled ({r} rows a block) with the timestamp at byte {ts_off} "
                                   f"differs from the plain version")
    for n in TREE_N:
        leaves = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, n), dtype=np.int64).astype(np.int32)).to(dev)
        want = sha.merkle_tree_plain(leaves, n)
        fns = {f"chunk {2 * t}": (lambda t=t, leaves=leaves: tree(t, leaves)) for t in TREE_THREADS}
        if parent is not None and n > 2:
            fns["parent, to width 128"] = lambda leaves=leaves: inner_levels(leaves, HOST_TAIL_WIDTH)
            fns["parent, to the root"] = lambda leaves=leaves: inner_levels(leaves, 1)
            if not torch.equal(inner_levels(leaves, 1), want):
                raise RuntimeError(f"the parent's inner levels at {n} leaves differ from the plain version")
        for form, fn in fns.items():
            if form.startswith("chunk") and not torch.equal(fn(), want):
                raise RuntimeError(f"merkle_tree ({form}) at {n} leaves differs from the plain version")
        forms[("merkle_tree", n)] = fns

    turns = {key: {form: [] for form in fns} for key, fns in forms.items()}
    for r in range(args.rounds):
        for key, fns in forms.items():
            order = list(fns) if r % 2 == 0 else list(reversed(fns))
            for form in order:
                turns[key][form].append(device_ms(fns[form], reps=10))
    report = {}
    for (kernel, n), by_form in turns.items():
        report.setdefault(kernel, {})[n] = {form: {"median": float(np.median(t)), "turns": t}
                                           for form, t in by_form.items()}
    print(json.dumps({"ms_device_only": report, "ptxas": usage, "identical_to_plain": True,
                      "parent": None if args.parent is None else str(args.parent)}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
