"""Time sha256_leaf_blocks (csrc/sha256_kernels.cu) at every block size it
can be compiled with, at the six shapes of chip_smoke.py's phase 6, each
form held identical to the plain version (ops/sha256.py
leaf_blocks_plain).

    python3 scripts/leaf_sweep.py [--parent DIR] [--rounds 3] [--clock]

The kernel library compiles the kernel at one block size (kLeafThreads).
This script builds a library of its own from the source with the kernel
instantiated at 32, 64 and 128 threads a block, and prints what
-Xptxas -v said of each instance (registers, stack frame, spills). With
--parent, a checkout of the commit before the redesign (its
tendermint_tpu_torch/csrc), it also builds that commit's
sha256_leaf_blocks (one thread a row in the packer's order, 128 threads a
block, each block's loads issued after the previous block's rounds) and
times it in the same turns.

The shapes (chip_smoke.leaf_shapes, from a fixed seed): 10,000 merkle
leaves of a validator set (one block each) and of a commit (one or two),
a block's 10,000 transactions as merkle leaves (Txs.hash: 156-byte
payments transfers, three blocks, or 1-2,047 bytes, 1-33 blocks) and a
mempool bundle of 65,536 tx keys (the same two kinds, no prefix).

At the shapes whose rows differ in length, the form "longest first" is
the kernel at the compiled block size on the same rows packed by
descending block count (a stable sort), each warp's lanes then ending
together: the most a launch order could save on the device. Beside it,
host_sort_ms is what that order costs on the host before the launch,
numpy's stable argsort of the block counts (8-bit keys), the median of
20. The port takes the rows in the packer's order (PERF.md).

Every form is timed in each of --rounds turns, the order of the forms
reversed every other turn; a time is the device alone
(chip_smoke.device_ms: a sleep kernel holding the stream while the host
enqueues, the median of five runs after a warm one). With --clock,
nvidia-smi's SM clock and power draw sampled while the kernel runs back
to back at the last shape (65,536 ragged tx keys). Prints one JSON line of the medians over the turns and every turn's time, each
shape's bound and chain floor, then the card's name and power limit.
Needs the CUDA toolkit and one GPU; builds into build/torch_kernels/.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LEAF_THREADS = (32, 64, 128)

SOURCE = r"""
#include "sha256_kernels.cu"

extern "C" int sweep_leaf(int threads, const void* blocks, const void* offsets, const void* counts, int n, int total,
                          void* state, void* stream) {
  const tmk::LeafArgs a{(const uint8_t*)blocks, (const int32_t*)offsets, (const int32_t*)counts, n, total,
                        (uint32_t*)state};
  switch (threads) {
    case 32: return (int)tmk::launch_leaf_blocks_at<32>(a, (cudaStream_t)stream);
    case 64: return (int)tmk::launch_leaf_blocks_at<64>(a, (cudaStream_t)stream);
    case 128: return (int)tmk::launch_leaf_blocks_at<128>(a, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""

# The parent commit's kernel through its own launch function.
PARENT_SOURCE = r"""
#include "sha256_kernels.cu"

extern "C" int parent_leaf(const void* blocks, const void* offsets, const void* counts, int n, int total, void* state,
                           void* stream) {
  return (int)tmk::launch_sha256_leaf_blocks((const uint8_t*)blocks, (const int32_t*)offsets, (const int32_t*)counts, n,
                                            total, (uint32_t*)state, (cudaStream_t)stream);
}
"""


def sample_clock(fn, seconds: float = 3.0) -> list:
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled while `fn`
    runs back to back for `seconds` (the kernel keeps the card busy in
    batches of 200 launches)."""
    import subprocess
    import threading
    import time

    import torch

    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
            samples.append([float(x) for x in out.split(",")])
            time.sleep(0.2)

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t = threading.Thread(target=sample)
    end = time.perf_counter() + seconds
    t.start()
    while time.perf_counter() < end:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    done.set()
    t.join(timeout=60)
    return samples


def main() -> int:
    import argparse
    import re
    import time

    import numpy as np
    import torch

    from chip_smoke import device_ms, leaf_bound, leaf_shapes, nvidia_smi
    from scripts.prepare_tree_sweep import build, ptxas_lines
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import sha256 as sha

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the commit before the redesign")
    ap.add_argument("--rounds", type=int, default=3, help="turns of every form")
    ap.add_argument("--clock", action="store_true",
                    help="sample the SM clock and power while the kernel runs at the last shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("leaf_sweep: no CUDA device", file=sys.stderr)
        return 2
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib, log = build(SOURCE, _build._CSRC, "leaf_sweep")
    usage = ptxas_lines(log, r"sha256_leaf_blocksI")
    lib.sweep_leaf.argtypes = [i32, vp, vp, vp, i32, i32, vp, vp]
    parent = None
    if args.parent is not None:
        parent, plog = build(PARENT_SOURCE, args.parent / "tendermint_tpu_torch" / "csrc", "parent_leaf_sweep")
        usage.update({f"parent {k}": v for k, v in ptxas_lines(plog, r"sha256_leaf_blocks").items()})
        parent.parent_leaf.argtypes = [vp, vp, vp, i32, i32, vp, vp]
    for name, lines in sorted(usage.items()):
        print(f"  {name}: " + "; ".join(lines))

    rng = np.random.default_rng(20261019)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def leaf(call, b, o, c):
        state = torch.empty((8, c.shape[0]), dtype=torch.int32, device=dev)
        check(call(b.data_ptr(), o.data_ptr(), c.data_ptr(), c.shape[0], b.shape[0], state.data_ptr(), stream),
              "leaf launch")
        return state

    # the block size the kernel library compiles in
    threads = int(re.search(r"constexpr int kLeafThreads = (\d+);",
                            (_build._CSRC / "sha256_kernels.cu").read_text()).group(1))
    compiled = lambda *a: lib.sweep_leaf(threads, *a)  # noqa: E731
    forms, bounds, host_sort = {}, {}, {}
    for name, (items, prefix) in leaf_shapes(rng).items():
        blocks, offsets, counts = sha.pack_leaves(items, prefix_len=prefix)
        b, o, c = (torch.from_numpy(a).to(dev) for a in (blocks, offsets, counts))
        want = {"packed": sha.leaf_blocks_plain(b, c, o)}
        fns, rows_of = {}, {}
        for t in LEAF_THREADS:
            call = lambda *a, t=t: lib.sweep_leaf(t, *a)  # noqa: E731
            fns[f"threads {t}"] = lambda call=call, b=b, o=o, c=c: leaf(call, b, o, c)
            rows_of[f"threads {t}"] = "packed"
        if int(counts.min()) != int(counts.max()):
            def longest_first(counts=counts):
                return np.argsort((int(counts.max()) - counts).astype(np.uint8), kind="stable")

            sb, so, sc = (torch.from_numpy(a).to(dev)
                          for a in sha.pack_leaves([items[i] for i in longest_first().tolist()], prefix_len=prefix))
            want["sorted"] = sha.leaf_blocks_plain(sb, sc, so)
            fns["longest first"] = lambda sb=sb, so=so, sc=sc: leaf(compiled, sb, so, sc)
            rows_of["longest first"] = "sorted"
            ts = []
            for _ in range(20):
                t0 = time.perf_counter()
                longest_first()
                ts.append(1e3 * (time.perf_counter() - t0))
            host_sort[name] = float(np.median(ts))
        if parent is not None:
            fns["parent"] = lambda b=b, o=o, c=c: leaf(parent.parent_leaf, b, o, c)
            rows_of["parent"] = "packed"
        for form, fn in fns.items():
            if not torch.equal(fn(), want[rows_of[form]]):
                raise RuntimeError(f"sha256_leaf_blocks ({form}) at {name} differs from the plain version")
        forms[name] = fns
        bounds[name] = leaf_bound(counts)
        print(f"  {name}: {bounds[name]['blocks']} blocks in {bounds[name]['rows']} rows, every form identical to "
              f"the plain version")

    turns = {key: {form: [] for form in fns} for key, fns in forms.items()}
    for r in range(args.rounds):
        for key, fns in forms.items():
            order = list(fns) if r % 2 == 0 else list(reversed(fns))
            for form in order:
                turns[key][form].append(device_ms(fns[form], reps=10))
    report = {key: {form: {"median": float(np.median(t)), "turns": t} for form, t in by_form.items()}
              for key, by_form in turns.items()}
    clock = None
    if args.clock:
        clock = sample_clock(list(forms.values())[-1][f"threads {threads}"])
        print(f"  SM clock and power while the last shape runs: {clock}")
    print(json.dumps({"ms_device_only": report, "host_sort_ms": host_sort, "bounds": bounds, "ptxas": usage,
                      "identical_to_plain": True,
                      "clock_under_load": clock, "parent": None if args.parent is None else str(args.parent)}))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
