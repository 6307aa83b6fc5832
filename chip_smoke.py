"""Chip smoke test of the PyTorch/CUDA port (tendermint_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit):

1. Print the card's name and power limit (nvidia-smi), build the eleven
   kernels (six ed25519, two SHA-256, three BLS12-381) from
   tendermint_tpu_torch/csrc (nvcc, sm_90a), with each kernel's registers,
   spills and stack frame (-Xptxas -v).
2. Hold each kernel against its plain PyTorch version, on the card, on
   one 1,024-row batch of honest and adversarial rows (s + L, flipped R,
   s and message bits, an undecodable key, a non-canonical A.y, small-order
   A and R), exactly at the byte seams; hold the verdicts against the
   pure-Python oracle; and RFC 8032 vector 1 (empty message). Then on
   batches whose rows are not a multiple of a warp's 32, with an
   undecodable key in the last row of a warp and in the last row.
   ed25519_finish also gets its points with Z set to 0 in the first, the
   middle and the last row (1 / 0 is 0: y = 0).
3. The generic path: a 10,000-validator ValidatorSet and a signed commit
   (about 90 % for the block, some nil and absent rows) through
   ValidatorSet.verify_commit with a TorchBatchVerifier whose tabled
   entry points answer None ("not available"), as past the tabled path's
   size limit. The
   kernels' launch counts are set to 0 just before and read just after;
   each generic kernel must have moved. A bad signature before quorum
   must raise ErrInvalidCommitSignature, 60 % of the power
   ErrNotEnoughVotingPower.
4. At that path's shapes (the commit's present rows): each generic kernel
   against its plain version again, exactly at the byte seams; then
   timing with CUDA events: verify_commit p50/p99 over 30 warm runs on a
   fresh copy of the commit each (a new commit, whose sign-bytes parts
   are built in the call) and over 30 on the same, memoised commit; the
   host clock split of a fresh commit's call (sign_bytes_parts apart);
   each kernel's median and each plain version's time.
5. The per-valset tabled path, which verify_commit takes by default: the
   same commit through ValidatorSet.verify_commit with
   TorchBatchVerifier(), whose first call builds the set's tables (build
   time and peak device memory printed, and the build's own peak beside
   its outputs); counts set to 0 just before
   and read just after, the tabled kernels and ed25519_finish must have
   moved. The same negative cases, during which the generic prepare and
   scan must not launch. verify_commit_trusting of the commit against a
   second set that shares half the validators, and its duplicate-signer
   case. Each tabled kernel against its plain version, exactly at the
   byte seams, at the main path's shapes (all 10,000 validators' tables,
   the 9,510 present rows read through their validator index, templated
   sign-bytes) and on the 1,024-row adversarial batch with its keys as
   the set (row r is validator r, a message matrix); the tabled scan also
   on a batch whose rows are not a multiple of a block's, with indices
   out of range in the last group of a warp and in the last row (zeros
   and a_ok 0). ed25519_prepare_tabled also at verify_commit_trusting's
   4,737 rows (the second set's keys and templates), and with key and
   template indices out of range in a block's first, last and middle
   rows (zeros and s_ok 0). Timing as in 4, the
   tabled prepare also at 4,737 rows. The lane group G that ed25519_scan,
   ed25519_build_tables and ed25519_scan_tabled were compiled with (the
   other G are timed by scripts/ed25519_lane_sweep.py), and those three
   kernels' and ed25519_prepare's, ed25519_prepare_tabled's and
   ed25519_finish's registers, spill stores and loads and stack frame,
   and the tabled prepare's local-memory instructions in its SASS.
6. The merkle kernels (sha256_leaf_blocks, merkle_tree) against their
   plain versions, exactly at the (8, N) state seams, every level of the
   tree (levels=True) and the root alone: on the 10,000 validators'
   leaves, on the 10,000-signature commit's ragged leaves (95 and 11
   bytes), on an adversarial set (m in 2, 3, 5, 127-129, 1023-1025
   leaves with the empty leaf, 54- and 55-byte leaves at the one/two-block
   edge and a 40-block leaf; sha256 of 55- and 56-byte messages), on
   100,001 such leaves, and on 1,000,000 random leaf states (more chunk
   roots than a block's chunk: the top loops in global memory). Roots
   and every proof's aunts against a hashlib recursion of simple_tree.go.
   1,023 leaves of 32 B and one of 1 MiB: the flat leaf buffer holds
   about the leaves' bytes (the dense layout would pad all to 16,385
   blocks), root and aunts against hashlib on the card.
   ValidatorSet.hash() and Commit.hash() at 10,000: the counts set to 0
   just before and read just after (one leaf launch, one tree launch),
   CUDA events p50/p99 of 30 calls on fresh objects, the host clock
   split, and hashlib alone beside it; merkle_tree's registers, stack
   frame and SASS. sha256_leaf_blocks at its six shapes (leaf_shapes:
   the set's and the commit's own leaves, 10,000 transactions as merkle
   leaves and 65,536 tx keys, each of 156 bytes or of 1-2,047), against
   the plain version and hashlib; its time on the device alone as the
   path launches it; bound and chain floor; its threads a block (from
   the compiled instance's name), registers and stack frame.
7. The light client at 10,000 validators: a trusted header h1, h2
   adjacent under the set S of phases 3-5, h4 two heights on under S'
   (S with three validators replaced), both signed here. verify(h1 ->
   h2) must move the merkle and the tabled ed25519 kernels and not the
   generic prepare/scan; verify_chain(h1, [h2, h4]), whose commits span
   S and S', the generic ones in one call. The negative cases: a power
   changed in the untrusted set (ErrInvalidHeader), a skip link from a
   set of fresh keys (ErrNewValSetCantBeTrusted), a bad signature before
   quorum in h2 (ErrInvalidCommitSignature out of verify_chain), each
   with the JAX package's class and message. Timing: p50 of verify
   (adjacent) and of verify_chain over warm runs on fresh objects, and
   the validator-set hash's share of an adjacent step; ed25519_prepare,
   ed25519_scan and ed25519_finish alone on the device at the rows of
   verify_chain's generic batch (about 28,500), each held against its
   plain version there.

8. BLS12-381 at 128 validators (keys from seeds, each proof of
   possession made and registered through the port's
   register_possession). The three BLS kernels against their plain
   versions on the card, exactly at the byte seams, and against the
   oracle: pairing_check_rows on 128 rows (a commit's rows, a wrong
   message, a wrong key, another key's signature, pk = G1, duplicates;
   verdicts, and the adversarial rows' reduced Fp12 values against the
   oracle's cubed), pairing_value on 2 pairs (the oracle's cubed),
   map_to_g2 on 128 pairs (u = 0, u = 1, an exceptional u), g1_aggregate
   at 128, 4,096 and 10,000 points with ragged masks (empty, one point,
   P + (-P), P + P, all, random), and where a row's blocks meet: three
   rows at 10,000 points (a chunk's sum S and -S in another block, whose
   partial sums cancel; 90 % of the points; the first and last block's
   points) and V below one chunk. A per-signature commit (about 90 % for
   the block, 5 % nil, 5 % absent) through ValidatorSet.verify_commit:
   one map and one pairing launch a call; a corrupted signature, a
   malformed 96-byte one and a 64-byte one, each with the JAX package's
   class and message; CUDA events p50/p99 of warm calls on fresh commits
   and the host split (decode, hash-to-field, map, pairing, the rest).
   An AggregatedCommit over the same set: one aggregate, one map and one
   pairing launch; a signer without a proof of possession, a non-BLS
   signer, a wrong aggregate signature, too little power; times and
   split. A mixed set of 64 ed25519 and 64 BLS validators: the tabled
   ed25519 kernels and the BLS map and pairing in one verify_commit.
   The kernels' rows at the commit's 120 rows: the lane group G that
   each of the map and pairing kernels was compiled with (the other G are
   timed by scripts/bls_lane_sweep.py), the aggregate's G, points a block
   and blocks a row (other values: scripts/bls_aggregate_sweep.py), each
   kernel's registers and stack frame, the SASS of fp_mul in both of its forms, the Fp products one
   row runs, counted on the host build of the kernels' headers (g++,
   which must compute the kernels' values on the same row).
9. The mesh runtime (tendermint_tpu_torch/parallel). DeviceTopology.
   discover() lists every CUDA device; with one, no plan is collective
   and each routed engine gives its unrouted results: verify_commit at
   10,000 on the tabled path (a routed TorchBatchVerifier set as the
   default provider) and on the generic path (9,510 rows),
   verify_commit_trusting, BLSEngine.verify_rows on phase 8's pairing
   rows, MerkleHasher.root of the 10,000 validator leaves (and
   merkle_tree on the routed leaf states against its plain version, every
   level). The same calls
   over two placed lanes of cuda:0 (MeshRouter(DeviceTopology([cuda:0] *
   2))), and over the real devices (up to 4) when there are several:
   verdicts, tallies, roots and errors identical to the unrouted calls
   (the negative cases of phase 5 with the bad signature in the second
   lane's chunk), each routed kernel launched once a slot and
   ed25519_build_tables once a distinct device and set, the router's
   stats (no shard failure, device_rows summing to the rows its
   collective plans sent). Logical lanes: MeshRoutedVerifier over four
   host lanes under verify_commit, tabled and generic, four launches of
   each kernel. A lane whose inner call raises: the answer recomputed by
   the kernels, one shard failure, that lane's breaker open and the next
   plan without it. Timing of two lanes on one card: the cost of
   splitting a bundle, not a multi-GPU figure (verify_commit p50/p99 of
   30 fresh commits beside phases 4 and 5; one device and two lanes in
   turns: verify_commit, the BLS rows, the merkle root; the kernels alone
   on the device, one launch a stage against one a lane). A JSON line
   {"mesh": ...} holds the phase's counts, stats and times.
10. A block's transactions and the mempool's tx keys: Txs.hash and every
   Txs.proof at 10,000 payments-sized (156 B) and ragged (1-2,047 B)
   transactions, root and aunts against a hashlib recursion, one leaf
   and one tree launch a root; TxKeyHasher.keys_or_host at 65,536 of each,
   against hashlib, one leaf launch a bundle and every row counted in
   hash_device_rows. CUDA events p50/p99 and the host clock p50 on fresh
   Txs and bundles, the host split (pack, upload, kernels, download) and hashlib alone; a JSON line {"transactions":
   ...}.

Before the last line it prints one JSON object with a row per kernel
(launches, max_abs_err, ms, plain_ms, bound_ms, ...; launches_mesh_two_lanes
from phase 9's two-lane calls; for ed25519 the field products and
squarings a row, a squaring counted at 55 multiply-adds and a product at
100, and the -Xptxas -v registers and spills; lanes for the kernels whose
row is G lanes; for ed25519_finish its bound with one inversion a row
beside the one counted, by a binary GCD and by Fermat's chain,
bound_ms_gcd_inversion_a_row and bound_ms_fermat_inversion_a_row),
then the nvidia-smi line. In every row `ms` is the median time a call of
back-to-back calls, the wrapper's host cost of a launch included, and
`ms_device_only` the device alone (a sleep kernel holds the stream
while the host enqueues the calls); the last line is {"ok": true, "device": {...}}. Every
launch count in a row is read from a run of its path, the eleven
kernels' alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

# Peak rates used for the bounds. HBM bandwidth: NVIDIA's H100 SXM data
# sheet. 32-bit integer multiply-adds: the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table gives 64 results per clock per
# SM at compute capability 9.0, half the 128 of float32 FMA, so half the
# data sheet's 67e12 float32 operations/s (one multiply-add = 2
# operations). A limb product is one IMAD.WIDE (32x32 -> 64 bits); should
# that issue as two multiply-adds, the bound would be twice as high.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_OPS_PER_S = 67e12 / 2
OPS_PER_FIELD_MUL = 2 * 100  # 100 limb products, each a 32x32->64 multiply-add
OPS_PER_FIELD_SQUARE = 2 * 55  # a squaring needs 55 (ref10's fe_sq; csrc/fe25519.cuh)
# An inversion mod 2^255 - 19 by a binary GCD, counted as GCD_INV_OPS
# (phase 8) counts the BLS one: 2 len(p) - 1 = 509 divsteps, each at least
# six 32-bit instructions, and for each batch of 30 ten products of a
# 9-limb number by a 30-bit factor, 9 multiply-adds each; 2 operations an
# instruction. ed25519_finish needs one 1 / Z a row, and the least work for
# a batch of them is Montgomery's batch inversion: three products a row
# and one inversion a launch (this GCD, fewer operations than Fermat's 265
# products), whatever the kernel runs.
ED_GCD_DIVSTEPS = 2 * 255 - 1
ED_GCD_INV_OPS = 2 * (6 * ED_GCD_DIVSTEPS + -(-ED_GCD_DIVSTEPS // 30) * 10 * 9)
BATCH_INV_MULS_PER_ROW = 3
# SHA-512 on 32-bit lanes: one compression is 80 rounds of about 23
# 64-bit operations (three rotates and two XORs in each sigma, choice,
# majority, five additions) and 64 schedule words of about 13, each
# 64-bit operation two 32-bit instructions, which the same table gives
# at the multiply-add's rate (64 a clock per SM): counted as 2
# operations each, like a multiply-add.
OPS_PER_SHA512_BLOCK = 2 * 2 * (80 * 23 + 64 * 13)
# The tabled prepare's scalar work a row, in 32-bit instructions at the
# same rate, 2 operations each. sc_reduce (csrc/sc25519.cuh): the digest's
# eight words byte-swapped (2 each) and cut into 24 21-bit limbs (3 each),
# 14 folds of six limb products (an int64 product by a constant and its
# accumulation, 2 each), 46 carries (a 64-bit bias, shift, add and
# subtract: 8 each), the 12 limbs packed into four words (3 each): 660.
# s < L: four 64-bit compares (4 each): 16. The digits: 64 nibbles of k
# and 32 bytes of s, each extracted, its carry added, compared, reduced
# and packed (5 each): 480. The message words' shared reads and byte
# swaps are not counted (nor are the SHA-256 kernels' byte swaps).
SC_REDUCE_INSTR = 8 * 2 + 24 * 3 + 14 * 6 * 2 + 46 * 8 + 12 * 3
PREPARE_TABLED_SCALAR_INSTR = SC_REDUCE_INSTR + 4 * 4 + (64 + 32) * 5
# SHA-256 on its native 32-bit words, counted in the instructions sm_90a
# needs for it, each at the same table's 32-bit integer rate (64 a clock
# per SM for the 3-input LOP3 and IADD3 and the funnel shift SHF alike)
# and counted as 2 operations, like a multiply-add. A round: Sigma1 and
# Sigma0 three rotates (SHF) and one LOP3 each, Ch and Maj one LOP3
# each, and its seven additions as four IADD3 (e = d + T1 and a = T1 +
# Sigma0 + Maj share h + Sigma1 + Ch): 14. A schedule word: sigma0 and
# sigma1 two rotates, a shift and a LOP3 each, its three additions two
# IADD3: 10. The feed-forward: 8 additions. Constant message words fold
# (sha256_block_instructions), and the first round of a hash, whose
# state is the constant IV, folds to two additions. The byte swaps and
# one-byte shifts that assemble the blocks are not counted.
SHA256_ROUND_INSTR, SHA256_SCHEDULE_WORD_INSTR, SHA256_FEED_FORWARD_INSTR = 14, 10, 8
SHA256_FIRST_ROUND_FOLD = 12

N_BATCH = 1024
N_VALS = 10_000
CHAIN = "smoke-chain"
HEIGHT = 12
SEED = 20261017
MERKLE_M = (2, 3, 5, 127, 128, 129, 1023, 1024, 1025)
LIGHT_T0 = 1_760_000_100 * 10**9
LIGHT_NOW = LIGHT_T0 + 60 * 10**9
TRUSTING_PERIOD = 14 * 24 * 3600 * 10**9


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# A warp issues a 32-bit integer instruction at best every second cycle
# (16 INT32 lanes a scheduler, the 64 a clock per SM above), so one
# thread's chain of n such instructions takes at least 2 n cycles however
# idle the card is: the floor of a kernel whose rows or levels are
# sequential chains at under one warp a scheduler.
CYCLES_PER_WARP_INT32_INSTR = 2


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def chain_floor_ms(instructions: int) -> float:
    """The least time of one thread's chain of `instructions` 32-bit
    integer instructions at the card's maximum SM clock."""
    return 1e3 * CYCLES_PER_WARP_INT32_INSTR * instructions / sm_clock_hz()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    return float(np.median([cuda_ms(fn, reps) for _ in range(repeats)]))


SLEEP_CYCLES = 50_000_000  # about 25 ms of a sleep kernel at the H100's clock


def device_ms(fn, reps: int, repeats: int = 5) -> float:
    """Median milliseconds per call of `fn` on the device alone. A sleep
    kernel first holds the stream while the host enqueues all `reps`
    calls behind it, so the events time the kernels back to back, not
    the host's cost of a launch (a wrapper's checks, allocation and the
    ctypes call: tens of microseconds, more than a small kernel runs).
    Fails if the host did not finish enqueueing inside the sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    out = []
    for _ in range(repeats):
        torch.cuda._sleep(SLEEP_CYCLES)
        t = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        require(enqueue_ms < 0.8 * sleep_ms, f"host enqueued {reps} calls in {enqueue_ms:.2f} ms, inside the "
                                             f"{sleep_ms:.2f} ms sleep")
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def field_muls_per_row(stage) -> dict:
    """The field multiplications and squarings a row costs, counted by
    running the plain version on one CPU row ({"products": ...,
    "squarings": ...}, products without the squarings); the kernels run
    the same formulas and every row does the same work."""
    from tendermint_tpu_torch.ops import field

    count = {"products": 0, "squarings": 0}
    mul, square = field.mul, field.square

    def counting_mul(f, g):
        count["products"] += 1
        return mul(f, g)

    def counting_square(f):
        count["squarings"] += 1
        return mul(f, f)

    field.mul, field.square = counting_mul, counting_square
    try:
        stage()
    finally:
        field.mul, field.square = mul, square
    return count


def field_ops(counts: dict) -> int:
    """Operations of a row's field arithmetic: a product 100 multiply-adds,
    a squaring 55, each 2 operations."""
    return counts["products"] * OPS_PER_FIELD_MUL + counts["squarings"] * OPS_PER_FIELD_SQUARE


def adversarial_batch(rng, n: int):
    """n signature rows (pubkey, msg, sig) of 160-byte messages: honest
    rows with a tenth or so of each adversarial kind mixed in."""
    from tendermint_tpu_torch.ops import ref_ed25519 as ref

    rows = []
    for i in range(n):
        seed = rng.bytes(32)
        msg = rng.bytes(160)
        pk, sig = ref.pubkey_from_seed(seed), ref.sign(seed, msg)
        kind = i % 16
        if kind == 1:  # s + L: the same point, rejected by s < L
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 2:  # a flipped R bit
            sig = bytes([sig[0] ^ 0x02]) + sig[1:]
        elif kind == 3:  # a flipped message byte
            msg = msg[:77] + bytes([msg[77] ^ 0x80]) + msg[78:]
        elif kind == 4:  # a flipped s bit (s stays < L)
            sig = sig[:33] + bytes([sig[33] ^ 0x01]) + sig[34:]
        elif kind == 5:  # a pubkey that does not decompress
            while True:
                pk = rng.bytes(32)
                if ref.pt_decode(pk) is None:
                    break
        elif kind == 6:  # non-canonical A.y (y = p + 1, x = 0, sign set): valid
            r = int(rng.integers(1, 2**62))
            pk = ((ref.P + 1) | (1 << 255)).to_bytes(32, "little")
            sig = ref.pt_encode(ref.pt_mul_base(r)) + r.to_bytes(32, "little")
        elif kind == 7:  # small-order A (0, -1) and R = identity, s = 0
            pk = (ref.P - 1).to_bytes(32, "little")
            sig = (1).to_bytes(32, "little") + bytes(32)
        elif kind == 8:  # the sign bit of A flipped: -A, decompresses, fails
            pk = pk[:31] + bytes([pk[31] ^ 0x80])
        rows.append((pk, msg, sig))
    return rows


RAGGED_ROWS = (37, 259)  # batches whose rows are not a multiple of a warp's


def ragged_batch(rng, n: int):
    """adversarial_batch(n) with an undecodable key in the last row of the
    first warps (rows 31, 63, ...) and in the last row, where the
    kernels' last warp has rows past n."""
    from tendermint_tpu_torch.ops import ref_ed25519 as ref

    rows = adversarial_batch(rng, n)
    for r in list(range(31, n, 32))[:4] + [n - 1]:
        while True:
            pk = rng.bytes(32)
            if ref.pt_decode(pk) is None:
                break
        rows[r] = (pk, rows[r][1], rows[r][2])
    return rows


def to_dev(rows, k: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.frombuffer(r[k], dtype=np.uint8) for r in rows])).cuda()


def seam_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"seam shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def compare_kernels(ed, field, pk, msg, sig, powers, counted):
    """Each kernel against its plain version on the same inputs; returns
    the largest difference at each kernel's byte seams (0 = identical)."""
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731
    prep = ed.verify_stage_prepare(pk, msg, sig)
    plain = ed.prepare_plain(pk, msg, sig)
    err_prep = max(
        seam_err(prep[0], plain[0]), seam_err(prep[1], plain[1]), seam_err(fb(prep[2]), fb(plain[2])),
        seam_err(prep[3], plain[3]), seam_err(prep[4], plain[4]),
    )
    point = ed.verify_stage_scan(*prep[:3])
    err_scan = seam_err(fb(point), fb(ed.scan_plain(*prep[:3])))
    ok, tally = ed.verify_stage_finish(point, sig, prep[3], prep[4], tally=True, powers=powers, counted=counted)
    pok, ptally = ed.finish_plain(point, sig, prep[3], prep[4], powers, counted)
    err_fin = max(seam_err(ok, pok), seam_err(tally, ptally))
    ok_untallied = ed.verify_stage_finish(point, sig, prep[3], prep[4])
    err_fin = max(err_fin, seam_err(ok_untallied, ok))
    # points whose Z is 0 (the inversion's 0 -> 0) in the first, middle and last row
    zero_z = point.clone()
    zero_z[[0, zero_z.shape[0] // 2, -1], 2] = 0
    zk, zt = ed.verify_stage_finish(zero_z, sig, prep[3], prep[4], tally=True, powers=powers, counted=counted)
    zp, zpt = ed.finish_plain(zero_z, sig, prep[3], prep[4], powers, counted)
    err_fin = max(err_fin, seam_err(zk, zp), seam_err(zt, zpt))
    torch.cuda.synchronize()
    return {"ed25519_prepare": err_prep, "ed25519_scan": err_scan, "ed25519_finish": err_fin}, ok


def compare_tables(ed, field, pk, tables, a_ok, chunk: int = 1024):
    """ed25519_build_tables's output against its plain version, `chunk`
    validators at a time (that bounds the plain version's memory);
    returns (largest difference at the byte seams, plain version's ms)."""
    err, plain_ms = 0, 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for off in range(0, pk.shape[0], chunk):
        start.record()
        pt, pa = ed.build_tables_plain(pk[off:off + chunk])
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        err = max(err, seam_err(field.to_bytes(tables[off:off + chunk].long()), field.to_bytes(pt.long())),
                  seam_err(a_ok[off:off + chunk], pa))
    return err, plain_ms


def tabled_edges_err(ed, field, tables, a_ok, sd8, kd, idx) -> int:
    """ed25519_scan_tabled where its rows of G lanes meet their edges: a
    batch whose row count is not a multiple of the rows a block (32 / G),
    with indices out of range (-1, V, V + 7) in the last group of a warp
    and in the last row. The in-range rows against the plain version, the
    others zeros with a_ok 0; returns the largest seam difference."""
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731
    per_block = 32 // ed.lanes()["ed25519_scan_tabled"]
    m = max(per_block, kd.shape[0] // per_block - 1) * per_block + 3
    m = min(m, kd.shape[0])
    rows = torch.arange(m, device=kd.device)
    e_idx = (rows.to(torch.int32) % tables.shape[0]) if idx is None else idx[:m].clone()
    bad = torch.tensor([per_block - 1, 2 * per_block - 1, m - 1], device=kd.device)
    bad = bad[bad < m]
    e_idx[bad] = torch.tensor([-1, tables.shape[0], tables.shape[0] + 7], dtype=torch.int32,
                              device=kd.device)[:bad.numel()]
    point, row_ok = ed.verify_stage_scan_tabled(sd8[:m].contiguous(), kd[:m].contiguous(), tables, a_ok, e_idx)
    good = torch.ones(m, dtype=torch.bool, device=kd.device)
    good[bad] = False
    ppoint, prow_ok = ed.scan_tabled_plain(sd8[:m][good], kd[:m][good], tables, a_ok, e_idx[good])
    torch.cuda.synchronize()
    return max(seam_err(fb(point[good]), fb(ppoint)), seam_err(row_ok[good], prow_ok),
               int(point[bad].abs().max().item()), int(row_ok[bad].any().item()))


def compare_tabled(ed, field, tables, a_ok, pk_all, sig, src):
    """ed25519_prepare_tabled and ed25519_scan_tabled against their plain
    versions on the same inputs (`src`: idx, and msgs or templates,
    tmpl_idx, ts8), the scan also at its edges (tabled_edges_err);
    returns ({kernel: largest seam difference}, ok)."""
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731
    prep = ed.verify_stage_prepare_tabled(pk_all, sig, **src)
    plain = ed.prepare_tabled_plain(pk_all, sig, **src)
    err_prep = max(seam_err(a, b) for a, b in zip(prep, plain))
    idx = src.get("idx")
    point, row_ok = ed.verify_stage_scan_tabled(prep[0], prep[1], tables, a_ok, idx)
    ppoint, prow_ok = ed.scan_tabled_plain(prep[0], prep[1], tables, a_ok, idx)
    err_scan = max(seam_err(fb(point), fb(ppoint)), seam_err(row_ok, prow_ok),
                   tabled_edges_err(ed, field, tables, a_ok, prep[0], prep[1], idx))
    ok = ed.verify_stage_finish(point, sig, row_ok, prep[2])
    torch.cuda.synchronize()
    return {"ed25519_prepare_tabled": err_prep, "ed25519_scan_tabled": err_scan}, ok


def prepare_tabled_err(ed, pk_all, sig, src) -> int:
    """ed25519_prepare_tabled against its plain version on the same
    inputs: the largest difference at its seams (sd8, kd, s_ok)."""
    got = ed.verify_stage_prepare_tabled(pk_all, sig, **src)
    want = ed.prepare_tabled_plain(pk_all, sig, **src)
    torch.cuda.synchronize()
    return max(seam_err(a, b) for a, b in zip(got, want))


def prepare_tabled_edges_err(ed, pk_all, sig, src) -> int:
    """ed25519_prepare_tabled on the main path's templated inputs with
    rows whose key index (the first and last of a block of 64, the first
    of the next) or template index (a middle and the last row) is out of
    range: those must come out zeros with s_ok 0, the others equal to the
    plain version. Returns the largest difference. (The timestamp at
    every byte offset mod 8: scripts/prepare_tree_sweep.py on the card,
    tests/test_torch_prepare_tabled_host.py on the host build.)"""
    n, dev = sig.shape[0], sig.device
    bad = torch.tensor([0, 63, 64, n // 2, n - 1], device=dev)
    idx, tmpl = src["idx"].clone(), src["tmpl_idx"].clone()
    v, ntpl = pk_all.shape[0], src["templates"].shape[0]
    idx[bad[:3]] = torch.tensor([-1, v, v + 7], dtype=torch.int32, device=dev)
    tmpl[bad[3:]] = torch.tensor([ntpl, -1], dtype=torch.int32, device=dev)
    got = ed.verify_stage_prepare_tabled(pk_all, sig, **dict(src, idx=idx, tmpl_idx=tmpl))
    good = torch.ones(n, dtype=torch.bool, device=dev)
    good[bad] = False
    want = ed.prepare_tabled_plain(pk_all, sig[good], idx=idx[good], templates=src["templates"],
                                   tmpl_idx=tmpl[good], ts8=src["ts8"][good])
    torch.cuda.synchronize()
    return max([seam_err(a[good], b) for a, b in zip(got, want)]
               + [int(a[bad].to(torch.int64).abs().max().item()) for a in got])


def negative_cases(vs, commit, bid, provider, bad_pos: int = 5, quiet: bool = False) -> list:
    """A bad signature before quorum (in the commit's present row
    `bad_pos`) and a commit with 60 % of the power must both be refused.
    Returns the two errors as (class, message)."""
    from tendermint_tpu_torch import Commit, ErrInvalidCommitSignature, ErrNotEnoughVotingPower
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_ABSENT, CommitSig

    rows_present = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    cs = commit.signatures[rows_present[bad_pos]]
    bad_commit = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    bad_commit.signatures[rows_present[bad_pos]] = dataclasses.replace(
        cs, signature=bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    errors = []
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad_commit, provider=provider)
    except ErrInvalidCommitSignature as e:
        errors.append((type(e).__name__, str(e)))
        if not quiet:
            print(f"  bad signature before quorum: ErrInvalidCommitSignature ({e})")
    else:
        raise RuntimeError("a bad signature before quorum was accepted")
    total = vs.total_voting_power()
    low = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    talled = 0
    for i, cs in enumerate(low.signatures):
        if talled >= 0.6 * total or not cs.for_block():
            low.signatures[i] = CommitSig(BLOCK_ID_FLAG_ABSENT)
        else:
            talled += vs.validators[i].voting_power
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, low, provider=provider)
    except ErrNotEnoughVotingPower as e:
        errors.append((type(e).__name__, str(e)))
        if not quiet:
            print(f"  {100 * talled / total:.1f} % of the power: ErrNotEnoughVotingPower ({e})")
    else:
        raise RuntimeError("a commit with 60 % of the power was accepted")
    return errors


def fresh(commit):
    """A copy of `commit` without its memoised sign-bytes parts, as a
    node holds each new commit it receives."""
    return dataclasses.replace(commit)


def time_verify_commit(vs, commit, bid, provider, cold: bool, reps: int = 30):
    """p50 and p99 of CUDA events around warm verify_commit calls, and
    the host clock's p50: with `cold`, each call on a fresh copy of the
    commit (made outside the timed span), else on `commit` itself."""
    walls, events = [], []
    for _ in range(reps):
        c = fresh(commit) if cold else commit
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        vs.verify_commit(CHAIN, bid, HEIGHT, c, provider=provider)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        events.append(start.elapsed_time(end))
    return float(np.percentile(events, 50)), float(np.percentile(events, 99)), float(np.percentile(walls, 50))


def second_set(vs, rng):
    """A set sharing every other validator of `vs` (their keys and
    powers) with as many others: seeded random 32-byte keys, which need
    not decompress (they sign nothing here), and seeded powers."""
    from tendermint_tpu_torch import Ed25519PubKey, Validator, ValidatorSet

    shared = [v for i, v in enumerate(vs.validators) if i % 2 == 0]
    others = [Validator(Ed25519PubKey(rng.bytes(32)), int(w)) for w in rng.integers(1, 1 << 40, len(shared))]
    return ValidatorSet(shared + others)


def signed_commit(vs, by_addr, bid, height: int, t0: int, rng):
    """A commit of `vs` for `bid` at `height`, signed with the keys
    `by_addr`: ~90 % of the rows for the block, ~5 % nil, ~5 % absent;
    row i's timestamp t0 + i."""
    from tendermint_tpu_torch import Commit, CommitSig
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL

    draw = rng.random(len(vs.validators))
    flags = np.where(draw < 0.90, BLOCK_ID_FLAG_COMMIT, np.where(draw < 0.95, BLOCK_ID_FLAG_NIL, BLOCK_ID_FLAG_ABSENT))
    sigs = []
    for i, val in enumerate(vs.validators):
        if flags[i] == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
        else:
            sigs.append(CommitSig(int(flags[i]), val.address, t0 + i, b""))
    commit = Commit(height, 0, bid, sigs)
    for i, cs in enumerate(sigs):
        if not cs.absent_():
            cs.signature = by_addr[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN, i))
    return commit


def build_commit(rng):
    """A 10,000-validator set (seeded keys and powers), a commit signed
    by it, its BlockID and the keys by address."""
    from tendermint_tpu_torch import Ed25519PrivKey, Validator, ValidatorSet
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import MAX_TOTAL_VOTING_POWER

    privs = [Ed25519PrivKey(rng.bytes(32)) for _ in range(N_VALS)]
    powers = rng.integers(1, 1 << 40, N_VALS)
    require(int(powers.sum()) <= MAX_TOTAL_VOTING_POWER, "total power within MAX_TOTAL_VOTING_POWER")
    vs = ValidatorSet([Validator(p.pub_key(), int(w)) for p, w in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(rng.bytes(32), PartSetHeader(4, rng.bytes(32)))
    return vs, signed_commit(vs, by_addr, bid, HEIGHT, 1_760_000_000_000_000_000, rng), bid, by_addr


def sha256_block_instructions(words) -> int:
    """Instructions of one SHA-256 compression whose 16 message words are
    `words`: None where a word depends on the data, else its constant
    value. A schedule word made of constants alone folds away; otherwise
    each sigma of a data word costs 4 and its data terms, with one folded
    constant where that is not zero, are summed by 3-input IADD3s."""
    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF

    sigma = (lambda x: rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3), lambda x: rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10))
    w, n = list(words), 0
    for t in range(16, 64):
        data, const = 0, 0
        for x, f in ((w[t - 2], sigma[1]), (w[t - 7], None), (w[t - 15], sigma[0]), (w[t - 16], None)):
            if x is None:
                data += 1
                n += 4 if f else 0
            else:
                const = (const + (f(x) if f else x)) & 0xFFFFFFFF
        n += (data + (const != 0)) // 2 if data else 0
        w.append(None if data else const)
    return 64 * SHA256_ROUND_INSTR + n + SHA256_FEED_FORWARD_INSTR


# A block of a leaf: all 16 words are data (the kernel reads whatever the
# packer wrote). An inner node: block 1 is data, block 2 is right[31] ||
# 0x80 || zeros || the 520-bit length, one data word.
SHA256_DATA_BLOCK_INSTR = sha256_block_instructions([None] * 16)
SHA256_INNER_NODE_INSTR = (SHA256_DATA_BLOCK_INSTR + sha256_block_instructions([None] + [0] * 14 + [520])
                           - SHA256_FIRST_ROUND_FOLD)


def sha256_leaf_ops(blocks: int, rows: int) -> int:
    """Operations of `rows` leaves of `blocks` blocks in all."""
    return 2 * (blocks * SHA256_DATA_BLOCK_INSTR - rows * SHA256_FIRST_ROUND_FOLD)


def sass_opcodes(kernel: str, binary=None):
    """Opcode counts of `kernel` in the SASS of `binary` (the built
    library by default), read with the toolkit's cuobjdump (static: a
    loop's body once), or None where the toolkit has no cuobjdump."""
    import re
    from collections import Counter
    from pathlib import Path

    from tendermint_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    binary = _build.build() if binary is None else binary
    sass = subprocess.run([str(tool), "-sass", str(binary)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts)


def kernel_row(name, source, launches, err, ms, plain_ms, io_bytes, ops, rows, muls) -> dict:
    """One kernel's entry of the JSON line; the bound is the larger of the
    bytes over the memory rate and the operations over their peak rate."""
    bytes_s = io_bytes / HBM_BYTES_PER_S
    ops_s = ops / INT32_MAD_OPS_PER_S
    return {
        "name": name,
        "route": "cuda",
        "source": f"tendermint_tpu_torch/csrc/{source}",
        "replaces": {
            "ed25519_prepare": "tendermint_tpu/ops/ed25519.py:56",
            "ed25519_scan": "tendermint_tpu/ops/ed25519.py:79",
            "ed25519_finish": "tendermint_tpu/ops/ed25519.py:85",
        }.get(name),
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s > ops_s else "operations",
        "library_ms": None,
        "rows": rows,
        "field_muls_per_row": muls,
        "bytes": io_bytes,
        "ops": ops,
    }


def bound_at(row, n: int):
    """(bound ms, "bytes" or "operations") of a kernel row's work scaled
    to n rows: its bytes and operations a row times n, plus the
    operations it counts once a launch (ops_per_launch)."""
    fixed = row.get("ops_per_launch", 0)
    bytes_s = row["bytes"] / row["rows"] * n / HBM_BYTES_PER_S
    ops_s = ((row["ops"] - fixed) / row["rows"] * n + fixed) / INT32_MAD_OPS_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s > ops_s else "operations"


# -- phases 6 and 7: merkle roots and the light client ------------------------


def host_root(items):
    """Independent reference: the simple_tree.go recursion, verbatim."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return hashlib.sha256(b"\x00" + items[0]).digest()
    k = 1
    while k * 2 < n:
        k *= 2
    return hashlib.sha256(b"\x01" + host_root(items[:k]) + host_root(items[k:])).digest()


def host_tree(items):
    """(root, aunts of every leaf, leaf level first) by the same
    recursion (simple_proof.go): a leaf's aunts in the left subtree gain
    the right subtree's root, and the other way round."""
    if len(items) == 1:
        return hashlib.sha256(b"\x00" + items[0]).digest(), [[]]
    k = 1
    while k * 2 < len(items):
        k *= 2
    left, la = host_tree(items[:k])
    right, ra = host_tree(items[k:])
    return hashlib.sha256(b"\x01" + left + right).digest(), [a + [right] for a in la] + [a + [left] for a in ra]


def merkle_seams(sha, hasher, items):
    """Both kernels of one tree against their plain versions on the card:
    (leaf seam error, tree seam error over every level and the root
    alone, root)."""
    blocks, offsets, counts = hasher.MerkleHasher().pack(items)
    b, o, c = (torch.from_numpy(a).cuda() for a in (blocks, offsets, counts))
    st = sha.leaf_block_states(b, c, o)
    e_leaf = seam_err(st, sha.leaf_blocks_plain(b, c, o))
    return (e_leaf, *tree_seams(sha, st))


def tree_seams(sha, st):
    """merkle_tree on the (8, n) leaf states `st` against
    merkle_tree_plain, every level (levels=True) and the root alone:
    (largest seam difference, root)."""
    n = st.shape[1]
    flat = sha.merkle_tree(st, n, levels=True)
    root = sha.merkle_tree(st, n)
    err = max(seam_err(flat, sha.merkle_tree_plain(st, n, levels=True)), seam_err(root, flat[:, -1:]),
              seam_err(root, sha.merkle_tree_plain(st, n)))
    torch.cuda.synchronize()
    return err, sha.state_to_digests(root.cpu().numpy())[0].tobytes()


def check_proofs(merkle, items, what: str) -> None:
    """The port's root and every proof's aunts against host_tree."""
    root, aunts = host_tree(items)
    got_root, proofs = merkle.proofs_from_byte_slices(items)
    require(got_root == root and merkle.hash_from_byte_slices(items) == root, f"{what}: root equals hashlib's")
    require([p.aunts for p in proofs] == aunts and all(p.index == i and p.total == len(items)
                                                       for i, p in enumerate(proofs)),
            f"{what}: every proof's aunts equal hashlib's")


def adversarial_leaves(rng, m: int):
    """m leaves of 0-299 random bytes with the edge cases spread over
    them: the empty leaf, 54 and 55 bytes (one block and two with the
    0x00 prefix) and a 40-block leaf."""
    items = [rng.bytes(int(k)) for k in rng.integers(0, 300, m)]
    for j, leaf in enumerate((b"", rng.bytes(54), rng.bytes(55), rng.bytes(40 * 64 - 73))):
        items[j * m // 4] = leaf
    return items


def fresh_set(vs, change_power_of: int = -1):
    """A new ValidatorSet of the same validators (nothing memoised: its
    hash and the pubkey encodings are computed anew, as for a set a
    light client has just received); with `change_power_of`, that
    validator's power plus one."""
    from tendermint_tpu_torch import Validator, ValidatorSet

    return ValidatorSet([Validator(v.pub_key, v.voting_power + (i == change_power_of))
                         for i, v in enumerate(vs.validators)])


def events_and_wall(fn, make, reps: int):
    """p50 and p99 of CUDA events and p50 of the host clock around
    fn(make()) over `reps` calls; make() runs outside the timed span."""
    walls, events = [], []
    for _ in range(reps):
        arg = make()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        events.append(start.elapsed_time(end))
    return float(np.percentile(events, 50)), float(np.percentile(events, 99)), float(np.percentile(walls, 50))


def root_split(sha, merkle, hasher, leaves_of, obj_of, reps: int = 10):
    """The host clock split of a root at 10,000 leaves: the leaves'
    encodings, packing, the upload with the two launches and the root's
    32-byte download; and the same root by hashlib alone."""
    parts = {"encode": [], "pack": [], "upload_kernels_download": [], "hashlib_alone": []}
    h = hasher.MerkleHasher()
    for _ in range(reps):
        obj = obj_of()
        t = time.perf_counter()
        leaves = leaves_of(obj)
        t1 = time.perf_counter()
        packed = h.pack(leaves)
        t2 = time.perf_counter()
        st = h.leaf_states(*packed)
        root = sha.state_to_digests(sha.merkle_tree(st, st.shape[1]).cpu().numpy())[0].tobytes()
        t3 = time.perf_counter()
        saved = merkle.DEVICE_THRESHOLD
        merkle.DEVICE_THRESHOLD = len(leaves) + 1
        try:
            alone = merkle.hash_from_byte_slices(leaves)
        finally:
            merkle.DEVICE_THRESHOLD = saved
        t4 = time.perf_counter()
        require(root == alone, "the split's root equals hashlib's")
        for key, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(1e3 * dt)
    return {key: float(np.median(v)) for key, v in parts.items()}


def tree_bound(n: int):
    """(bytes, operations) of merkle_tree's root of n leaves: the leaf
    states read once and the root written once; its n - 1 inner nodes of
    two compressions."""
    return 32 * n + 32, (n - 1) * 2 * SHA256_INNER_NODE_INSTR


# sha256_leaf_blocks' six shapes (phase 6, phase 10, scripts/leaf_sweep.py):
# the merkle leaves of a 10,000-validator set and of its commit, a block's
# 10,000 transactions (Txs.hash, each tx a leaf) and a mempool bundle of
# 65,536 (MAX_BUCKET) tx keys, the transactions payments transfers
# (TX_LEN = 156 bytes, tendermint_tpu/abci/examples/payments.py:36) or
# uniform in [1, 2,047] bytes (2,047: the longest tx the JAX tx-key hasher
# keeps on its device, 33 blocks).
N_TXS = 10_000
N_TX_KEYS = 65_536
TX_LEN = 156
MAX_DEVICE_TX = 2047
VALIDATOR_LEAF_LEN = 50  # Validator.hash_bytes
COMMIT_LEAF_LENS = (95, 11)  # CommitSig.encode: a signature for the block or nil, an absent one


def tx_bundle(rng, n: int, ragged: bool):
    """n transactions of TX_LEN bytes, or of [1, MAX_DEVICE_TX] bytes,
    sliced from one random buffer."""
    lens = rng.integers(1, MAX_DEVICE_TX + 1, n) if ragged else np.full(n, TX_LEN)
    buf = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens).tolist()
    return [buf[e - k:e] for e, k in zip(ends, lens.tolist())]


def leaf_shapes(rng, valset_leaves=None, commit_leaves=None) -> dict:
    """name -> (items, prefix length) of the six shapes. The merkle leaves
    are the given ones, or random ones of their lengths (commit leaves for
    the block, nil and absent at 90 / 5 / 5 %)."""
    if valset_leaves is None:
        valset_leaves = [rng.bytes(VALIDATOR_LEAF_LEN) for _ in range(N_VALS)]
    if commit_leaves is None:
        commit_leaves = [rng.bytes(COMMIT_LEAF_LENS[int(d >= 0.95)]) for d in rng.random(N_VALS)]
    return {
        "merkle_valset_10000x1": (valset_leaves, 1),
        "merkle_commit_10000x1-2": (commit_leaves, 1),
        "txs_hash_10000x156B": (tx_bundle(rng, N_TXS, False), 1),
        "txs_hash_10000xU[1,2047]B": (tx_bundle(rng, N_TXS, True), 1),
        "tx_keys_65536x156B": (tx_bundle(rng, N_TX_KEYS, False), 0),
        "tx_keys_65536xU[1,2047]B": (tx_bundle(rng, N_TX_KEYS, True), 0),
    }


def leaf_bound(counts: np.ndarray) -> dict:
    """sha256_leaf_blocks' bound and chain floor for rows of `counts`
    blocks: the blocks, offsets and counts read once and the states
    written once, the compressions' instructions at the 32-bit integer
    rate; the longest row's chain at two cycles an instruction."""
    rows, blocks = int(counts.shape[0]), int(counts.sum())
    io = blocks * 64 + rows * (4 + 4 + 32)
    ops = sha256_leaf_ops(blocks, rows)
    bytes_s, ops_s = io / HBM_BYTES_PER_S, ops / INT32_MAD_OPS_PER_S
    longest = int(counts.max())
    return {"rows": rows, "blocks": blocks, "longest_row_blocks": longest, "bytes": io, "ops": ops,
            "bound_ms": 1e3 * max(bytes_s, ops_s), "bound_by": "bytes" if bytes_s > ops_s else "operations",
            "chain_floor_ms": chain_floor_ms(longest * SHA256_DATA_BLOCK_INSTR - SHA256_FIRST_ROUND_FOLD)}


def leaf_shape_checks(sha, shapes: dict) -> dict:
    """sha256_leaf_blocks at each shape: the kernel against the plain
    version, exactly at the (8, N) seam, and its digests against hashlib;
    its time on the device alone; the bound and chain floor."""
    out = {}
    for name, (items, prefix) in shapes.items():
        t0 = time.perf_counter()
        blocks, offsets, counts = sha.pack_leaves(items, prefix_len=prefix)
        b, o, c = (torch.from_numpy(a).cuda() for a in (blocks, offsets, counts))
        want = sha.leaf_blocks_plain(b, c, o)
        got = sha.leaf_block_states(b, c, o)
        err = seam_err(got, want)
        digests = sha.state_to_digests(got.cpu().numpy())
        pre = bytes(prefix)
        require(err == 0 and all(d.tobytes() == hashlib.sha256(pre + it).digest() for d, it in zip(digests, items)),
                f"sha256_leaf_blocks at {name}: identical to the plain version ({err}), digests = hashlib's")
        row = leaf_bound(counts)
        row.update(max_abs_err=err, ms_device_only=device_ms(lambda: sha.leaf_block_states(b, c, o), reps=10))
        out[name] = row
        print(f"  sha256_leaf_blocks {name}: {row['blocks']} blocks in {row['rows']} rows (longest "
              f"{row['longest_row_blocks']}), identical to the plain version, digests = hashlib; "
              f"{row['ms_device_only']:.4f} ms on the device alone"
              + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']}, chain floor {row['chain_floor_ms']:.4f} ms "
              f"({time.perf_counter() - t0:.1f} s)")
    return out


def phase6(vs, commit, card):
    """The merkle kernels: seams, roots and aunts, launch counts and
    times. Returns the two kernels' rows of the JSON line."""
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.models import hasher
    from tendermint_tpu_torch.ops import sha256 as sha

    rng = np.random.default_rng(SEED + 6)
    t0 = time.perf_counter()
    errs = {"sha256_leaf_blocks": {}, "merkle_tree": {}}
    saved = merkle.DEVICE_THRESHOLD
    merkle.DEVICE_THRESHOLD = 2
    try:
        adv_leaf = adv_tree = 0
        for m in MERKLE_M:
            items = adversarial_leaves(rng, m)
            e_leaf, e_tree, root = merkle_seams(sha, hasher, items)
            adv_leaf, adv_tree = max(adv_leaf, e_leaf), max(adv_tree, e_tree)
            require(root == host_root(items), f"{m} adversarial leaves: the kernels' root equals hashlib's")
            check_proofs(merkle, items, f"{m} adversarial leaves, every tree on the card")
    finally:
        merkle.DEVICE_THRESHOLD = saved
    for length in (55, 56):
        msgs = rng.integers(0, 256, (257, length), dtype=np.uint8)
        dev = torch.from_numpy(msgs).cuda()
        got = sha.sha256(dev).cpu().numpy()
        require([r.tobytes() for r in got] == [hashlib.sha256(r.tobytes()).digest() for r in msgs],
                 f"sha256 of {length}-byte messages equals hashlib's")
        blocks = sha.pad(dev).contiguous()
        counts = torch.full((257,), blocks.shape[1], dtype=torch.int32, device=blocks.device)
        flat = sha.dense_to_flat(blocks, counts)
        adv_leaf = max(adv_leaf, seam_err(sha.leaf_block_states(*flat), sha.leaf_blocks_plain(*flat)))
    errs["sha256_leaf_blocks"]["adversarial"], errs["merkle_tree"]["adversarial"] = adv_leaf, adv_tree
    print(f"phase 6: adversarial trees m = {MERKLE_M} (empty, 54-, 55-byte and 40-block leaves), every tree on "
          f"the card: seams identical to the plain versions (leaf {adv_leaf}, tree {adv_tree}), roots and aunts "
          f"= hashlib; sha256 of 55- and 56-byte messages = hashlib ({time.perf_counter() - t0:.1f} s)")
    # wide trees: 100,001 leaves through both kernels, roots and aunts
    # against hashlib; 1,000,000 leaf states (its chunk roots outnumber a
    # block's chunk, so the top loops in global memory) against the plain
    # version and hashlib's levels
    t1 = time.perf_counter()
    items = adversarial_leaves(rng, 100_001)
    e_leaf, e_tree, root = merkle_seams(sha, hasher, items)
    require(e_leaf == 0 and e_tree == 0 and root == host_root(items),
            f"100,001 leaves: seams identical (leaf {e_leaf}, tree {e_tree}), root = hashlib's")
    saved = merkle.DEVICE_THRESHOLD
    merkle.DEVICE_THRESHOLD = 2
    try:
        check_proofs(merkle, items, "100,001 leaves")
    finally:
        merkle.DEVICE_THRESHOLD = saved
    big = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, 1_000_000), dtype=np.int64).astype(np.int32)).cuda()
    e_big, root_big = tree_seams(sha, big)
    want_big = hasher.host_levels([d.tobytes() for d in sha.state_to_digests(big.cpu().numpy())])[-1][0]
    require(e_big == 0 and root_big == want_big, f"1,000,000 leaf states: tree identical to the plain version "
                                                 f"({e_big}), root = hashlib's")
    errs["sha256_leaf_blocks"]["100001_leaves"], errs["merkle_tree"]["100001_leaves"] = e_leaf, e_tree
    errs["merkle_tree"]["1000000_states"] = e_big
    print(f"  100,001 leaves: seams identical, root and aunts = hashlib; 1,000,000 leaf states: every level "
          f"identical to the plain version, root = hashlib's ({time.perf_counter() - t1:.1f} s)")
    # one long leaf among short ones: the flat layout holds each leaf's own
    # blocks (the dense one padded all 1,024 to 16,385 blocks: 1.07 GB)
    t1 = time.perf_counter()
    items = [rng.bytes(32) for _ in range(1023)] + [rng.bytes(1 << 20)]
    blocks, offsets, counts = hasher.MerkleHasher().pack(items)
    leaf_bytes = sum(map(len, items))
    require(blocks.nbytes <= 1.1 * leaf_bytes, f"flat packing of 1,023 x 32 B + 1 MiB: {blocks.nbytes} B for "
                                               f"{leaf_bytes} B of leaves")
    sha.reset_launches()
    check_proofs(merkle, items, "1,023 x 32 B + 1 MiB, on the card")
    require(sha.launches() == {"sha256_leaf_blocks": 2, "merkle_tree": 2},
            f"the long-leaf tree ran a leaf and a tree launch for its root and for its proofs: {sha.launches()}")
    print(f"  1,023 x 32 B + one 1 MiB leaf: {blocks.nbytes} B packed for {leaf_bytes} B of leaves "
          f"({blocks.nbytes / leaf_bytes:.3f}x; dense: {len(items) * int(counts.max()) * 64} B), root and aunts = "
          f"hashlib ({time.perf_counter() - t1:.1f} s)")

    trees = {
        "ValidatorSet.hash": (lambda: fresh_set(vs), lambda o: [v.hash_bytes() for v in o.validators],
                              lambda o: o.hash()),
        "Commit.hash": (lambda: fresh(commit), lambda o: [cs.encode() for cs in o.signatures], lambda o: o.hash()),
    }
    out, tree_leaves = {}, {}
    for name, (make, leaves_of, run) in trees.items():
        obj = make()
        leaves = tree_leaves[name] = leaves_of(obj)
        root, aunts = host_tree(leaves)
        sha.reset_launches()
        got = run(obj)
        torch.cuda.synchronize()
        n_launch = sha.launches()
        require(got == root, f"{name} at {N_VALS}: root equals hashlib's")
        require(n_launch == {"sha256_leaf_blocks": 1, "merkle_tree": 1},
                f"{name} at {N_VALS}: one leaf launch and one tree launch: {n_launch}")
        check_proofs(merkle, leaves, f"{name} leaves")
        e_leaf, e_tree, seam_root = merkle_seams(sha, hasher, leaves)
        require(seam_root == root, f"{name}: the kernels give hashlib's root")
        errs["sha256_leaf_blocks"][name], errs["merkle_tree"][name] = e_leaf, e_tree
        p50, p99, wall = events_and_wall(run, make, reps=30)
        split = root_split(sha, merkle, hasher, leaves_of, make)
        blocks, offsets, counts = hasher.MerkleHasher().pack(leaves)
        b, o, c = (torch.from_numpy(a).cuda() for a in (blocks, offsets, counts))
        state = sha.leaf_block_states(b, c, o)
        m = len(leaves)
        out[name] = dict(
            launches=n_launch, p50=p50, p99=p99, wall=wall, split=split, rows=m, blocks=int(counts.sum()),
            leaf_ms=device_ms(lambda: sha.leaf_block_states(b, c, o), reps=20),
            leaf_call_ms=median_ms(lambda: sha.leaf_block_states(b, c, o), reps=20, repeats=5),
            leaf_plain_ms=median_ms(lambda: sha.leaf_blocks_plain(b, c, o), reps=1, repeats=3),
            tree_ms=device_ms(lambda: sha.merkle_tree(state, m), reps=20),
            tree_call_ms=median_ms(lambda: sha.merkle_tree(state, m), reps=20, repeats=5),
            tree_plain_ms=median_ms(lambda: sha.merkle_tree_plain(state, m), reps=1, repeats=3),
            tree_levels_ms=device_ms(lambda: sha.merkle_tree(state, m, levels=True), reps=20),
        )
        print(f"  {name} @{N_VALS} ({out[name]['blocks']} blocks in {m} leaves): root and aunts = hashlib, seams "
              f"identical (leaf {e_leaf}, tree {e_tree}), launches {n_launch}; 30 calls on fresh objects, CUDA "
              f"events p50 {p50:.3f} ms p99 {p99:.3f} ms, host clock p50 {wall:.3f} ms ({card})")
        print("    host clock split (medians of 10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
        print(f"    kernels on the device alone: leaf {out[name]['leaf_ms']:.4f} ms, the tree's "
              f"{len(sha.tree_widths(m)) - 1} levels {out[name]['tree_ms']:.4f} ms (every level out: "
              f"{out[name]['tree_levels_ms']:.4f} ms); back-to-back calls with the host's launch cost: leaf "
              f"{out[name]['leaf_call_ms']:.4f} ms, tree {out[name]['tree_call_ms']:.4f} ms")

    # sha256_leaf_blocks at its six shapes, the set's and commit's own
    # leaves first
    t1 = time.perf_counter()
    shapes = leaf_shape_checks(sha, leaf_shapes(rng, tree_leaves["ValidatorSet.hash"], tree_leaves["Commit.hash"]))
    print(f"  sha256_leaf_blocks at its six shapes ({time.perf_counter() - t1:.1f} s)")
    vsh, ch = out["ValidatorSet.hash"], out["Commit.hash"]
    rows = {}
    for name, key, replaces, also in (
        ("sha256_leaf_blocks", "leaf", "tendermint_tpu/ops/sha256.py:131",
         "tendermint_tpu/ops/sha256.py:140 (leaf_block_update)"),
        ("merkle_tree", "tree", "tendermint_tpu/ops/sha256.py:159",
         "tendermint_tpu/ops/sha256.py:218 (merkle_inner_tail), level by level, and the host finish of "
         "tendermint_tpu/models/hasher.py"),
    ):
        ms_key, plain_key, call_key = f"{key}_ms", f"{key}_plain_ms", f"{key}_call_ms"
        per = {}
        for tree, o in (("valset", vsh), ("commit", ch)):
            if name == "sha256_leaf_blocks":
                io, ops = o["blocks"] * 64 + o["rows"] * (4 + 4 + 32), sha256_leaf_ops(o["blocks"], o["rows"])
            else:
                io, ops = tree_bound(o["rows"])
            per[tree] = (io, ops)
        io, ops = per["valset"]
        row = kernel_row(name, "sha256_kernels.cu", None, max(errs[name].values()), vsh[call_key],
                         vsh[plain_key], io, ops, vsh["rows"], None)
        cio, cops = per["commit"]
        sass = sass_opcodes(name)
        row.update(
            replaces=replaces, replaces_also=also, max_abs_err_by_input=errs[name],
            shape=("10,000 one-block leaves (ValidatorSet.hash), one launch" if name == "sha256_leaf_blocks"
                   else f"the whole tree of ValidatorSet.hash's {vsh['rows']} leaves, widths "
                        f"{sha.tree_widths(vsh['rows'])}, the root out, one launch"),
            ms_device_only=vsh[ms_key],
            launches_valset_hash=vsh["launches"][name], launches_commit_hash=ch["launches"][name],
            commit_hash_ms=ch[call_key], commit_hash_ms_device_only=ch[ms_key],
            commit_hash_plain_ms=ch[plain_key],
            commit_hash_bound_ms=1e3 * max(cio / HBM_BYTES_PER_S, cops / INT32_MAD_OPS_PER_S),
            commit_hash_blocks=ch["blocks"],
            instructions_counted=(SHA256_DATA_BLOCK_INSTR if name == "sha256_leaf_blocks"
                                  else SHA256_INNER_NODE_INSTR),
            sass_static_opcodes=sass,
        )
        if name == "sha256_leaf_blocks":
            row.update(shapes=shapes, chain_floor_ms=shapes["merkle_valset_10000x1"]["chain_floor_ms"],
                       max_abs_err=max(row["max_abs_err"], *(v["max_abs_err"] for v in shapes.values())),
                       max_abs_err_by_input={**errs[name], **{k: v["max_abs_err"] for k, v in shapes.items()}},
                       **ptxas_usage(name))
            # the kernel is compiled at one block size, its instance's
            # template argument: sha256_leaf_blocks<T> mangles as ...ILiTE...
            t = re.search(r"ILi(\d+)E", row.get("entry", ""))
            row["threads_a_block"] = int(t.group(1)) if t else None
        if name == "merkle_tree":
            levels = len(sha.tree_widths(vsh["rows"])) - 1
            row.update(ms_device_only_every_level=vsh["tree_levels_ms"], commit_hash_rows=ch["rows"],
                       latency_floor={"dependent_levels": levels, "dependent_compressions": 2 * levels,
                                      "dependent_rounds": 128 * levels},
                       chain_floor_ms=chain_floor_ms(levels * SHA256_INNER_NODE_INSTR),
                       **ptxas_usage(name))
        rows[name] = row
        if sass is not None:
            top = sorted(sass.items(), key=lambda kv: -kv[1])[:6]
            local = {k: sass.get(k, 0) for k in ("LDL", "STL")}
            print(f"  {name}: the bound counts {row['instructions_counted']} instructions a "
                  f"{'block' if name == 'sha256_leaf_blocks' else 'node'}; its SASS holds {sum(sass.values())} "
                  f"(static; " + ", ".join(f"{k} {v}" for k, v in top) + f"; local memory {local})")
        else:
            print(f"  {name}: no cuobjdump in the toolkit, SASS not counted")
    lr = rows["sha256_leaf_blocks"]
    print(f"  sha256_leaf_blocks: {lr['threads_a_block']} threads a block, {lr.get('registers')} registers, "
          f"{lr.get('stack_frame')} bytes of stack frame, {lr.get('spill_stores')} / {lr.get('spill_loads')} bytes "
          f"of spill stores / loads ({card})")
    tr = rows["merkle_tree"]
    print(f"  merkle_tree: {tr.get('registers')} registers, {tr.get('stack_frame')} bytes of stack frame, "
          f"{tr.get('spill_stores')} / {tr.get('spill_loads')} bytes of spill stores / loads; bound "
          f"{tr['bound_ms']:.5f} ms by {tr['bound_by']} (all {vsh['rows'] - 1} inner nodes), its critical path "
          f"{tr['latency_floor']['dependent_compressions']} dependent compressions, at least "
          f"{tr['chain_floor_ms']:.4f} ms at the card's maximum SM clock; {tr['ms_device_only']:.4f} ms on the "
          f"device alone ({card})")
    return rows


def phase7(vs, by_addr, rng, card, kernels):
    """The light client at 10,000 validators; fills in the launch counts
    of `kernels` (the JSON rows) from its runs."""
    from tendermint_tpu_torch import Ed25519PrivKey, Ed25519PubKey, Validator, ValidatorSet
    from tendermint_tpu_torch.light import verifier as lv
    from tendermint_tpu_torch.light.types import SignedHeader
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import sha256 as sha
    from tendermint_tpu_torch.types.block import BlockID, Commit, Header, PartSetHeader

    t0 = time.perf_counter()
    new_privs = [Ed25519PrivKey(rng.bytes(32)) for _ in range(3)]
    keys = dict(by_addr)
    keys.update({p.pub_key().address(): p for p in new_privs})
    kept = [v for i, v in enumerate(vs.validators) if i not in (11, 4444, 9999)]
    s2 = ValidatorSet(kept + [Validator(p.pub_key(), int(w)) for p, w in zip(new_privs, rng.integers(1, 1 << 40, 3))])
    strangers = ValidatorSet([Validator(Ed25519PubKey(rng.bytes(32)), int(w)) for w in rng.integers(1, 1 << 40, N_VALS)])
    h1 = Header(CHAIN, 20, LIGHT_T0, validators_hash=vs.hash(), next_validators_hash=vs.hash(),
                app_hash=rng.bytes(32), proposer_address=vs.validators[0].address)
    bid1 = BlockID(h1.hash(), PartSetHeader(1, rng.bytes(32)))
    sh1 = SignedHeader(h1, Commit(20, 0, bid1, []))  # trusted: its commit is not read
    h2 = Header(CHAIN, 21, LIGHT_T0 + 5 * 10**9, last_block_id=bid1, validators_hash=vs.hash(),
                next_validators_hash=s2.hash(), app_hash=rng.bytes(32), proposer_address=vs.validators[1].address)
    sh2 = SignedHeader(h2, signed_commit(vs, keys, BlockID(h2.hash(), PartSetHeader(1, rng.bytes(32))), 21,
                                         h2.time_ns, rng))
    h4 = Header(CHAIN, 23, LIGHT_T0 + 15 * 10**9, validators_hash=s2.hash(), next_validators_hash=s2.hash(),
                app_hash=rng.bytes(32), proposer_address=s2.validators[0].address)
    sh4 = SignedHeader(h4, signed_commit(s2, keys, BlockID(h4.hash(), PartSetHeader(1, rng.bytes(32))), 23,
                                         h4.time_ns, rng))
    print(f"phase 7: light chain h1 (trusted), h2 under S, h4 under S' (S with 3 validators replaced); the two "
          f"{N_VALS}-validator commits signed in {time.perf_counter() - t0:.1f} s")
    fresh_sh = lambda sh: SignedHeader(sh.header, fresh(sh.commit))  # noqa: E731
    args = dict(now_ns=LIGHT_NOW)

    def counted(fn):
        ed.reset_launches()
        sha.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {**ed.launches(), **sha.launches()}

    adj = counted(lambda: lv.verify(CHAIN, sh1, vs, fresh_sh(sh2), fresh_set(vs), TRUSTING_PERIOD, **args))
    require(adj["sha256_leaf_blocks"] == 1 and adj["merkle_tree"] == 1,
            f"verify (adjacent) hashed the untrusted set through the merkle kernels: {adj}")
    require(all(adj[k] > 0 for k in ("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish")),
            f"verify (adjacent) ran the tabled ed25519 kernels: {adj}")
    require(adj["ed25519_prepare"] == 0 and adj["ed25519_scan"] == 0,
            f"verify (adjacent) did not run the generic prepare and scan: {adj}")
    print(f"  verify(h1 -> h2) passed: launches {adj}")
    chain = counted(lambda: lv.verify_chain(CHAIN, sh1, vs, [(fresh_sh(sh2), fresh_set(vs)),
                                                             (fresh_sh(sh4), fresh_set(s2))], TRUSTING_PERIOD, **args))
    require(chain["ed25519_prepare"] == 1 and chain["ed25519_scan"] == 1 and chain["ed25519_finish"] == 1,
            f"verify_chain over S and S' ran the generic kernels once, in one verify_batch call: {chain}")
    require(chain["sha256_leaf_blocks"] == 2 and chain["merkle_tree"] == 2,
            f"verify_chain hashed S and S' through the merkle kernels: {chain}")
    require(chain["ed25519_prepare_tabled"] == 0 and chain["ed25519_scan_tabled"] == 0,
            f"verify_chain over two sets took the generic path alone: {chain}")
    print(f"  verify_chain(h1, [h2, h4]) passed: launches {chain}")

    # the generic kernels alone at the rows of verify_chain's one generic
    # batch (h2's commit under S, h4's under S'), held against their plain
    # versions
    from tendermint_tpu_torch.models.verifier import VerifierModel
    from tendermint_tpu_torch.ops import field

    seen, model_verify = [], VerifierModel.verify
    VerifierModel.verify = lambda self, *a: (seen.append(a), model_verify(self, *a))[1]
    try:
        lv.verify_chain(CHAIN, sh1, vs, [(fresh_sh(sh2), fresh_set(vs)), (fresh_sh(sh4), fresh_set(s2))],
                        TRUSTING_PERIOD, **args)
    finally:
        VerifierModel.verify = model_verify
    require(len(seen) == 1, f"verify_chain made one generic batch: {len(seen)}")
    rows_c = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).cuda() for a in seen[0]]
    n_c = rows_c[0].shape[0]
    prep_c = ed.verify_stage_prepare(*rows_c)
    plain_c = ed.prepare_plain(*rows_c)
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731
    point_c = ed.verify_stage_scan(*prep_c[:3])
    pw_c = torch.ones(n_c, dtype=torch.int64, device="cuda")
    cnt_c = torch.ones(n_c, dtype=torch.bool, device="cuda")
    fin_c = ed.verify_stage_finish(point_c, rows_c[2], prep_c[3], prep_c[4], tally=True, powers=pw_c, counted=cnt_c)
    fin_p = ed.finish_plain(point_c, rows_c[2], prep_c[3], prep_c[4], pw_c, cnt_c)
    errs_c = {
        "ed25519_prepare": max([seam_err(prep_c[i], plain_c[i]) for i in (0, 1, 3, 4)]
                               + [seam_err(fb(prep_c[2]), fb(plain_c[2]))]),
        "ed25519_scan": seam_err(fb(point_c), fb(ed.scan_plain(*prep_c[:3]))),
        "ed25519_finish": max(seam_err(fin_c[0], fin_p[0]), seam_err(fin_c[1], fin_p[1])),
    }
    require(all(e == 0 for e in errs_c.values()), f"generic kernels identical to their plain versions at "
                                                  f"verify_chain's rows: {errs_c}")
    require(bool(fin_c[0].all()), "every row of verify_chain's batch verifies")
    runs_c = {
        "ed25519_prepare": lambda: ed.verify_stage_prepare(*rows_c),
        "ed25519_scan": lambda: ed.verify_stage_scan(*prep_c[:3]),
        "ed25519_finish": lambda: ed.verify_stage_finish(point_c, rows_c[2], prep_c[3], prep_c[4], tally=True,
                                                         powers=pw_c, counted=cnt_c),
    }
    for name, run in runs_c.items():
        ms_c = device_ms(run, reps=10)
        row = kernels[name]
        bound_c, by_c = bound_at(row, n_c)
        row.update(rows_verify_chain=n_c, ms_device_only_verify_chain=ms_c, bound_ms_verify_chain=bound_c,
                   max_abs_err_verify_chain=errs_c[name])
        print(f"  {name} at verify_chain's {n_c} rows: {ms_c:.4f} ms on the device alone (bound "
              f"{bound_c:.4f} ms by {by_c}), identical to its plain version ({card})")

    def expect(fn, cls: str, message: str, what: str) -> None:
        try:
            fn()
        except Exception as e:  # the verdict under test is the exception itself
            require(type(e).__name__ == cls and str(e) == message, f"{what}: {type(e).__name__}: {e}")
            print(f"  {what}: {cls} ({e})")
            return
        raise RuntimeError(f"{what} was accepted")

    expect(lambda: lv.verify(CHAIN, sh1, vs, fresh_sh(sh2), fresh_set(vs, change_power_of=77), TRUSTING_PERIOD,
                             **args),
           "ErrInvalidHeader", "expected new header validators to match those supplied",
           "one power changed in the untrusted set")
    expect(lambda: lv.verify(CHAIN, sh2, strangers, fresh_sh(sh4), fresh_set(s2), TRUSTING_PERIOD, **args),
           "ErrNewValSetCantBeTrusted", f"have 0, need > {strangers.total_voting_power() // 3}",
           "skip link from a set of fresh keys")
    bad = fresh(sh2.commit)
    bad.signatures = list(bad.signatures)
    row = next(i for i, cs in enumerate(bad.signatures) if cs.for_block())
    cs = bad.signatures[row]
    bad.signatures[row] = dataclasses.replace(cs, signature=bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    expect(lambda: lv.verify_chain(CHAIN, sh1, vs, [(SignedHeader(h2, bad), fresh_set(vs)),
                                                    (fresh_sh(sh4), fresh_set(s2))], TRUSTING_PERIOD, **args),
           "ErrInvalidCommitSignature", f"wrong signature #{row} ({cs.validator_address.hex()})",
           "a bad signature before quorum in h2, out of verify_chain")

    a50, a99, awall = events_and_wall(lambda a: lv.verify(CHAIN, sh1, vs, a[0], a[1], TRUSTING_PERIOD, **args),
                                      lambda: (fresh_sh(sh2), fresh_set(vs)), reps=30)
    c50, c99, cwall = events_and_wall(
        lambda a: lv.verify_chain(CHAIN, sh1, vs, [(a[0], a[1]), (a[2], a[3])], TRUSTING_PERIOD, **args),
        lambda: (fresh_sh(sh2), fresh_set(vs), fresh_sh(sh4), fresh_set(s2)), reps=10)
    hash_ms, pk_ms, rest_ms = [], [], []
    for _ in range(10):
        fs, fh = fresh_set(vs), fresh_sh(sh2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fs.hash()
        t1 = time.perf_counter()
        fs.batch_cache()  # the set's (V, 32) pubkey matrix and its key
        t2 = time.perf_counter()
        lv.verify(CHAIN, sh1, vs, fh, fs, TRUSTING_PERIOD, **args)  # the hash and matrix are memoised now
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        hash_ms.append(1e3 * (t1 - t))
        pk_ms.append(1e3 * (t2 - t1))
        rest_ms.append(1e3 * (t3 - t2))
    hm, pm, rm = float(np.median(hash_ms)), float(np.median(pk_ms)), float(np.median(rest_ms))
    print(f"  verify (adjacent) @{N_VALS}: 30 warm runs on fresh objects, CUDA events p50 {a50:.3f} ms p99 {a99:.3f} "
          f"ms, host clock p50 {awall:.3f} ms; verify_chain (h2 and h4, 3 commit checks over 2 sets): 10 runs, "
          f"p50 {c50:.3f} ms p99 {c99:.3f} ms, host clock p50 {cwall:.3f} ms ({card})")
    print(f"  split of an adjacent step (medians of 10, host clock): the untrusted set's hash {hm:.3f} ms, "
          f"its pubkey matrix {pm:.3f} ms, the rest {rm:.3f} ms: the hash {100 * hm / (hm + pm + rm):.1f} % of "
          f"the step")
    for name, row in kernels.items():
        row["launches_light_verify_adjacent"] = adj[name]
        row["launches_light_verify_chain"] = chain[name]
    for name in ("sha256_leaf_blocks", "merkle_tree"):
        kernels[name]["launches"] = adj[name]


# -- phase 8: BLS12-381 commits ------------------------------------------------

N_BLS = 128
N_AGG = (128, 4096, 10_000)
# The bounds count the Fp multiplications the functions need, by
# standard fast algorithms rather than the kernels' own formulas
# (squarings as multiplications; additions and products by small
# constants free): Karatsuba Fp2 (a product 3, a square 2); Fp6 6 Fp2
# products, its square 2 products and 3 squares; Fp12 18 Fp2 products,
# its square 12 (the complex method) and, once cyclotomic, 9 Fp2 squares
# (Granger-Scott); one Miller loop shared by the two pairs, projective
# doubling and mixed addition steps with their lines (3 m2 + 6 s2 + 4 m
# and 11 m2 + 2 s2 + 4 m) and sparse line products (13 m2), as in Aranha
# et al., Eurocrypt 2011; the final exponent's easy part and the x-chain
# of its hard part (ops/bls12.py's final_exp_plain, with cyclotomic
# squares); powers of Fp by the best sliding window (inversion by
# Fermat, the square root and Legendre symbol by their exponents, an Fp2
# root as two Fp powers); SvdW as RFC 9380's straight line; [H2] over its
# NAF in Jacobian coordinates (a doubling 2 m2 + 5 s2, a mixed addition
# 7 m2 + 4 s2) from an affine base; a G1 sum by complete mixed additions
# (RCB15 algorithm 8: 11) and its normalisation, two products and one
# inversion by a binary GCD (GCD_INV_OPS; Fermat's window chain, the
# bound before the aggregate's redesign, is kept beside it). What the
# kernels run is counted on the host build of their own headers
# (csrc/bls12_host.cc, whose portable fp_mul counts): one row's Fp
# products, `kernel_fp_muls`.
# An inversion mod p by a binary GCD, the fewest divsteps of the forms
# known (Pornin's optimised binary GCD; the kernel runs Bernstein and
# Yang's, which may take more): 2 len(p) - 1 = 761 divsteps, each at
# least a compare, a subtraction and a shift of a 64-bit approximation
# (six 32-bit instructions), and for each batch of 30 the 2x2 matrix
# applied to a and b and, mod p, to u and v: ten products of a 13-limb
# number by a 30-bit factor (the last two Montgomery corrections), 13
# multiply-adds each. Counted as 2 operations an instruction, like a
# multiply-add.
GCD_DIVSTEPS = 2 * 381 - 1
GCD_INV_OPS = 2 * (6 * GCD_DIVSTEPS + -(-GCD_DIVSTEPS // 30) * 10 * 13)
FP_MUL_PROBE = r"""
#include "fp381.cuh"
using namespace bls;
extern "C" __global__ void fp_mul_probe_1(const Fp* a, const Fp* b, Fp* r) {
  Fp t;
  fp_mul(t, a[0], b[0]);
  r[0] = t;
}
extern "C" __global__ void fp_mul_probe_2(const Fp* a, const Fp* b, Fp* r) {
  Fp t, u;
  fp_mul(t, a[0], b[0]);
  fp_mul(u, t, b[0]);
  r[0] = u;
}
"""
# Where the toolkit has no cuobjdump, a fixed model of a CIOS product,
# independent of either form: a limb product as IMAD.WIDE and a 64-bit
# carry add (IADD3, IADD3.X), 288 of them, and the m_i.
FP381_MUL_INSTR_MODEL = 3 * (144 + 144) + 12
FP_MUL_FORMS = {"kernels": (), "portable_u64": ("-DBLS_PORTABLE_FP",)}


def fp_mul_instructions():
    """{form: (instructions, opcode counts)} of one Fp multiplication in
    sm_90a SASS, in both forms fp381.cuh holds: the kernels' own (CIOS in
    PTX carry chains and its final subtraction) and its portable twin
    (u64 accumulators, compiled for the device with BLS_PORTABLE_FP). A
    probe kernel of two chained products less one of one, both fully
    unrolled, so the static count is what a product issues (NOPs aside).
    None where the toolkit has no cuobjdump."""
    from pathlib import Path

    from tendermint_tpu_torch.ops import _build

    nvcc = Path(_build.nvcc_path())
    if not nvcc.with_name("cuobjdump").exists():
        return None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fp_mul_probe.cu"
    src.write_text(FP_MUL_PROBE)
    out = {}
    for form, defines in FP_MUL_FORMS.items():
        cubin = _build.BUILD_DIR / f"fp_mul_probe_{form}.cubin"
        subprocess.run([str(nvcc), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin", *defines,
                        "-I", str(_build._CSRC), "-o", str(cubin), str(src)],
                       capture_output=True, timeout=300, check=True)
        one, two = (sass_opcodes(f"fp_mul_probe_{k}", cubin) for k in (1, 2))
        diff = {op: two.get(op, 0) - one.get(op, 0) for op in set(one) | set(two) if op != "NOP"}
        diff = {op: n for op, n in sorted(diff.items(), key=lambda kv: -kv[1]) if n}
        out[form] = (sum(diff.values()), diff)
    return out


def window_pow_muls(e: int) -> int:
    """Fp multiplications of a^e by a left-to-right sliding window of the
    best width: the squarings, the window products, the odd powers."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 8):
        i, windows = 0, 0
        while i < len(bits):
            if bits[i] == "0":
                i += 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            windows += 1
            i = j
        cost = len(bits) - 1 + windows - 1 + (2 ** (w - 1) if w > 1 else 0)
        best = cost if best is None else min(best, cost)
    return best


def naf_digits(k: int) -> list:
    out = []
    while k:
        d = (2 - k % 4) if k & 1 else 0
        out.append(d)
        k = (k - d) // 2
    return out


def bls_needed_fp_muls(ref) -> dict:
    """Fp multiplications a row needs (the model above): the pairing
    check, the map, and a G1 sum of k points as (per point, fixed)."""
    m2, s2 = 3, 2
    inv = window_pow_muls(ref.P - 2)
    f2_inv = 2 * s2 + inv
    f6_mul, f6_sqr = 6 * m2, 2 * m2 + 3 * s2
    f6_inv = 3 * (s2 + m2) + 3 * m2 + f2_inv + 3 * m2
    f12_mul, f12_sqr, cyc_sqr = 3 * f6_mul, 2 * f6_mul, 9 * s2
    f12_inv = 2 * f6_sqr + f6_inv + 2 * f6_mul
    frob_p, frob_p2 = 5 * m2, 5 * 2  # p^2's constants lie in Fp

    def cyc_pow(e: int) -> int:
        return (e.bit_length() - 1) * cyc_sqr + (bin(e).count("1") - 1) * f12_mul

    x = -ref.X_PARAM
    steps, adds = x.bit_length() - 1, bin(x).count("1") - 1
    line_dbl, line_add, sparse = 3 * m2 + 6 * s2 + 4, 11 * m2 + 2 * s2 + 4, 13 * m2
    miller = (steps - 1) * f12_sqr + 2 * steps * (line_dbl + sparse) + 2 * adds * (line_add + sparse)
    easy = f12_inv + 2 * f12_mul + frob_p2
    hard = 2 * cyc_pow(x + 1) + 3 * cyc_pow(x) + frob_p + frob_p2 + 5 * f12_mul + cyc_sqr
    p = ref.P
    f2_sqrt = 5 + window_pow_muls((p + 1) // 4) + window_pow_muls((p - 3) // 4)
    f2_is_square = 2 + window_pow_muls((p - 1) // 2)
    svdw = 10 * m2 + 6 * s2 + f2_inv + 2 * f2_is_square + f2_sqrt
    g2_dbl, g2_madd = 2 * m2 + 5 * s2, 7 * m2 + 4 * s2
    to_affine = f2_inv + s2 + 3 * m2
    naf = naf_digits(ref.H2)
    h2 = (len(naf) - 1) * g2_dbl + (sum(1 for d in naf if d) - 1) * g2_madd
    return {"bls12_pairing_check": miller + easy + hard,
            "bls12_map_to_g2": 2 * svdw + g2_madd + to_affine + h2 + to_affine,
            "bls12_g1_aggregate": (11, 2 - 11), "bls12_g1_aggregate_fermat_inversion": inv}


def kernel_fp_muls(host, stage) -> int:
    """Fp multiplications (squarings included) one row runs in the
    kernels' formulas: `stage` runs the row on the host build of the
    kernels' headers (ops/bls12_host.py), whose fp_mul counts; the lanes'
    products are the same whatever their number."""
    host.reset_count()
    stage()
    return host.count()


def ptxas_usage(kernel: str) -> dict:
    """Registers, stack frame, spill stores and loads and cumulative stack
    (bytes) of `kernel` as -Xptxas -v reported them for the current build,
    and the mangled name of the instance (its first: each kernel is
    compiled at one G)."""
    import re

    from tendermint_tpu_torch.ops import _build

    # the mangled name holds the kernel's name after its length, then a
    # template's arguments (I) or the end of the name (E)
    name = re.compile(rf"{len(kernel)}{kernel}[IE]")
    out, entry = {}, None
    for line in _build.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if name.search(m.group(1)) and "registers" not in out else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "stack_frame" not in out:
            out["stack_frame"], out["spill_stores"], out["spill_loads"] = (int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stack = re.search(r"(\d+) bytes cumulative stack size", line)
            out["registers"], out["cumulative_stack"] = int(m.group(1)), int(stack.group(1)) if stack else 0
            out["entry"] = entry
            entry = None
    return out


def exceptional_u(ref):
    """An Fp2 u with u^2 C1 = -1 or 1 (tv1 tv2 = 0: the SvdW map's inv0 case)."""
    inv = ref.f2_inv(ref._C1)
    for t in (ref.f2_neg(inv), inv):
        r = ref.f2_sqrt(t)
        if r is not None:
            return r
    raise RuntimeError("no exceptional u")


def expect_error(fn, cls: str, message: str, what: str) -> None:
    try:
        fn()
    except Exception as e:  # the verdict under test is the exception itself
        require(type(e).__name__ == cls and str(e) == message, f"{what}: {type(e).__name__}: {e}")
        print(f"  {what}: {cls} ({e})")
        return
    raise RuntimeError(f"{what} was accepted")


def bls_kernel_seams(bls, ref, rng, vs, commit, card):
    """The three BLS kernels against their plain versions on the card and
    against the oracle: returns ({kernel: largest seam difference}, the
    pairing rows' tensors)."""
    from tendermint_tpu_torch.crypto.bls import decode_pubkey_point, decode_signature

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    errs = {}
    # pairing_check_rows on 128 rows: the commit's rows (their H(m) by the
    # oracle) and adversarial ones
    rows = []
    for i, cs in enumerate(commit.signatures):
        if cs.absent_():
            continue
        pk = decode_pubkey_point(vs.validators[i].pub_key.bytes())
        rows.append((pk, commit.vote_sign_bytes(CHAIN, i), decode_signature(cs.signature)))
        if len(rows) == N_BLS - 8:
            break
    hms = [ref.hash_to_curve_g2(m, ref.DST_SIG) for _pk, m, _s in rows]
    trip = [(pk, hm, sg) for (pk, _m, sg), hm in zip(rows, hms)]
    want = [True] * len(trip)
    adversarial = [
        (trip[0][0], trip[1][1], trip[0][2], False),   # a wrong message
        (trip[1][0], trip[0][1], trip[0][2], False),   # a wrong key
        (trip[2][0], trip[2][1], trip[3][2], False),   # the signature of another key
        (ref.G1_GEN, trip[4][1], trip[4][1], True),    # pk = G1 (sk = 1): the signature is H(m)
        (ref.G1_GEN, trip[4][1], trip[5][1], False),
        trip[0] + (True,), trip[0] + (True,),          # duplicate rows
        (trip[6][0], trip[6][1], ref.g2_neg(trip[6][2]), False),
    ]
    trip += [a[:3] for a in adversarial]
    want += [a[3] for a in adversarial]
    pk = bls.g1_tensor([r[0] for r in trip], dev)
    hm = bls.g2_tensor([r[1] for r in trip], dev)
    sg = bls.g2_tensor([r[2] for r in trip], dev)
    ok, value = bls.pairing_check_rows(pk, hm, sg)
    pok, pvalue = bls.pairing_plain(pk, hm, sg)
    errs["bls12_pairing_check"] = max(seam_err(ok, pok), seam_err(value, pvalue))
    require(ok.tolist() == want, f"pairing verdicts: {ok.tolist()} vs {want}")
    one = ref._f12_canon(ref.F12_ONE)
    for j in range(len(trip) - 8, len(trip)):  # the adversarial rows' reduced values against the oracle, cubed
        pk_j, hm_j, sg_j = trip[j]
        f = ref.f12_mul(ref.miller_loop(hm_j, pk_j), ref.miller_loop(sg_j, ref.g1_neg(ref.G1_GEN)))
        want_v = ref._f12_canon(ref.f12_pow(ref.final_exponentiation(f), 3))
        require(bls.f12_value(value[j]) == want_v, f"row {j}: the reduced value is the oracle's cubed")
    require(all(bls.f12_value(value[j]) == one for j in range(len(trip)) if want[j]), "valid rows reduce to 1")
    # pairing_value on 2 pairs
    pv = bls.pairing_value(bls.g1_tensor([trip[0][0], ref.G1_GEN], dev), bls.g2_tensor([trip[0][1], ref.G2_GEN], dev))
    ppv = bls.pairing_plain(bls.g1_tensor([trip[0][0], ref.G1_GEN], dev), bls.g2_tensor([trip[0][1], ref.G2_GEN], dev))[1]
    errs["bls12_pairing_check"] = max(errs["bls12_pairing_check"], seam_err(pv, ppv))
    for j, (p_, q_) in enumerate(((trip[0][0], trip[0][1]), (ref.G1_GEN, ref.G2_GEN))):
        require(bls.f12_value(pv[j]) == ref._f12_canon(ref.f12_pow(ref.pairing(p_, q_), 3)),
                "pairing_value is the oracle's pairing cubed")
    print(f"phase 8: pairing_check_rows on {len(trip)} rows ({sum(want)} valid; wrong message, wrong key, another "
          f"key's signature, pk = G1, duplicates): verdicts as built, seams identical to the plain version, the "
          f"adversarial rows' values = the oracle's cubed; pairing_value on 2 pairs = the oracle's cubed "
          f"({time.perf_counter() - t0:.1f} s)")
    # map_to_g2 on 128 (u0, u1) pairs with u = 0, u = 1 and an exceptional u
    t1 = time.perf_counter()
    us = [ref.hash_to_field_fp2(rng.bytes(40), ref.DST_SIG, 2) for _ in range(N_BLS - 3)]
    us += [[(0, 0), (1, 0)], [(1, 0), (0, 0)], [exceptional_u(ref), (0, 1)]]
    u0 = bls.fp2_tensor([u[0] for u in us], dev)
    u1 = bls.fp2_tensor([u[1] for u in us], dev)
    q, qinf = bls.map_to_g2(u0, u1)
    pq, pqinf = bls.map_plain(u0, u1)
    errs["bls12_map_to_g2"] = max(seam_err(q, pq), seam_err(qinf, pqinf))
    want_q = [ref.clear_cofactor_g2(ref.g2_add(ref.map_to_curve_svdw(u[0]), ref.map_to_curve_svdw(u[1]))) for u in us]
    require(bls.g2_points(q, qinf) == want_q, "map_to_g2 = the oracle's clear_cofactor_g2(map(u0) + map(u1))")
    print(f"  map_to_g2 on {len(us)} pairs (u = 0, u = 1, an exceptional u): = the oracle, seams identical to the "
          f"plain version ({time.perf_counter() - t1:.1f} s)")
    # g1_aggregate at 128, 4,096 and 10,000 points, pk_i = pk_{i-1} + G1
    t1 = time.perf_counter()
    base = rows[0][0]
    table = [base]
    for _ in range(N_AGG[-1] - 1):
        table.append(ref.g1_add(table[-1], ref.G1_GEN))
    errs["bls12_g1_aggregate"] = 0
    agg_inputs = {}
    for v in N_AGG:
        pts = table[:v - 2] + [ref.g1_neg(table[1]), table[2]]  # -P and a second copy of a point
        masks = np.zeros((6, v), dtype=bool)
        masks[1, 5] = True                        # a single point
        masks[2, [1, v - 2]] = True               # P + (-P)
        masks[3, [2, v - 1]] = True               # P + P
        masks[4, :] = True
        masks[5] = rng.random(v) < 0.5            # ragged; row 0 stays empty: the identity
        pt = bls.g1_tensor(pts, dev)
        mk = torch.from_numpy(masks).to(dev)
        out, inf = bls.g1_aggregate(pt, mk)
        pout, pinf = bls.aggregate_plain(pt, mk)
        errs["bls12_g1_aggregate"] = max(errs["bls12_g1_aggregate"], seam_err(out, pout), seam_err(inf, pinf))
        got = bls.g1_points(out, inf)
        # expected sums: table[i] = base + i G1, so a selection sums to
        # |S| base + (sum of i) G1, the -P and duplicate entries aside
        for r in range(6):
            sel = np.flatnonzero(masks[r])
            idx = [int(i) for i in sel if i < v - 2]
            acc = ref.g1_add(ref.g1_mul(len(idx), base) if idx else None, ref.g1_mul(sum(idx), ref.G1_GEN) if sum(idx) else None)
            if masks[r, v - 2]:
                acc = ref.g1_add(acc, ref.g1_neg(table[1]))
            if masks[r, v - 1]:
                acc = ref.g1_add(acc, table[2])
            require(got[r] == acc, f"g1_aggregate at {v}, mask row {r}: = the oracle")
        require(got[0] is None and got[2] is None, "the empty mask and P + (-P) are the identity")
        agg_inputs[v] = (pt, mk)
    # where a row's blocks meet: B = 3 rows at 10,000 points, one whose
    # first chunk sums to S with -S in another chunk (the two blocks'
    # partial sums cancel); and V below one chunk
    chunk = bls.lanes()["bls12_g1_aggregate_chunk"]
    v = N_AGG[-1]
    s_idx = list(range(chunk))
    neg_s = ref.g1_neg(ref.g1_add(ref.g1_mul(len(s_idx), base), ref.g1_mul(sum(s_idx), ref.G1_GEN)))
    at = v // 2 + 1
    pts = table[:v]
    pts[at] = neg_s
    masks = np.zeros((3, v), dtype=bool)
    masks[0, s_idx + [at]] = True          # S + (-S): partial sums that cancel
    masks[1] = rng.random(v) < 0.9         # a commit's signers
    masks[1, at] = False
    masks[2, [3, v - 1]] = True            # two points, first and last block
    edge_cases = [(pts, masks)]
    small = chunk // 2 - 1
    sm = np.zeros((3, small), dtype=bool)
    sm[0] = True
    sm[1] = rng.random(small) < 0.5
    edge_cases.append((table[:small], sm))
    for pts_e, masks_e in edge_cases:
        pt = bls.g1_tensor(pts_e, dev)
        mk = torch.from_numpy(masks_e).to(dev)
        out, inf = bls.g1_aggregate(pt, mk)
        pout, pinf = bls.aggregate_plain(pt, mk)
        errs["bls12_g1_aggregate"] = max(errs["bls12_g1_aggregate"], seam_err(out, pout), seam_err(inf, pinf))
        got = bls.g1_points(out, inf)
        for r in range(masks_e.shape[0]):
            acc = None
            for i in np.flatnonzero(masks_e[r]):
                acc = ref.g1_add(acc, neg_s if (len(pts_e) == v and i == at) else table[int(i)])
            require(got[r] == acc, f"g1_aggregate at {len(pts_e)} points (chunk {chunk}), row {r}: = the oracle")
    require(bls.g1_points(*bls.g1_aggregate(bls.g1_tensor(pts, dev), torch.from_numpy(masks[:1]).to(dev)))[0]
            is None, "partial sums that cancel across blocks give the identity")
    print(f"  g1_aggregate at V = {N_AGG} (empty mask, one point, P + (-P), P + P, all, ragged), B = 3 at {v} "
          f"(a chunk's sum S and -S in another block, 90 % of the points, the first and last block) and V = "
          f"{small} (below one chunk of {chunk}): = the oracle, seams identical to the plain version "
          f"({time.perf_counter() - t1:.1f} s)")
    require(all(e == 0 for e in errs.values()), f"BLS kernels identical to their plain versions: {errs}")
    return errs, (pk, hm, sg), agg_inputs


def field_pairs(bls, ref, msgs):
    """hash_to_field of each message on the host -> u0, u1 (N, 2, 48) on the card."""
    us = [ref.hash_to_field_fp2(m, ref.DST_SIG, 2) for m in msgs]
    return bls.fp2_tensor([u[0] for u in us], "cuda"), bls.fp2_tensor([u[1] for u in us], "cuda")


def bls_split(provider, vs, commit, reps: int = 5):
    """The host clock split of a per-signature BLS verify_commit: checks and
    packing, host decoding, hash-to-field, the map, the pairing, the replay."""
    from tendermint_tpu_torch.codec.signbytes import splice_timestamps
    from tendermint_tpu_torch.ops import bls12 as bls
    from tendermint_tpu_torch.ops import ref_bls12 as ref

    parts = {"checks_packing": [], "decode": [], "hash_to_field": [], "map": [], "pairing": [], "replay": []}
    for _ in range(reps):
        c = fresh(commit)
        t = time.perf_counter()
        vs._check_commit_size(c)
        vs._verify_commit_basic(c, HEIGHT, c.block_id)
        idxs, vals_idx, _s, powers, counted, _ok, tpl = vs._commit_batch_arrays(CHAIN, c)
        msgs = splice_timestamps(tpl[0][tpl[1]], tpl[2])
        pkm = np.stack([np.frombuffer(vs.validators[int(v)].pub_key.bytes(), dtype=np.uint8) for v in vals_idx])
        sgm = np.stack([np.frombuffer(c.signatures[i].signature, dtype=np.uint8) for i in idxs])
        t1 = time.perf_counter()
        rows = provider.decode_rows(pkm, msgs, sgm)
        t2 = time.perf_counter()
        u0, u1 = field_pairs(bls, ref, [r[2] for r in rows])
        t3 = time.perf_counter()
        hm, _inf = bls.map_to_g2(u0, u1)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        ok, _v = bls.pairing_check_rows(bls.g1_tensor([r[1] for r in rows], "cuda"), hm,
                                        bls.g2_tensor([r[3] for r in rows], "cuda"))
        ok = ok.cpu().numpy()
        t5 = time.perf_counter()
        vs._replay_commit_full(c, ok, idxs, powers, counted, int(powers[ok & counted].sum()))
        t6 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5)):
            parts[key].append(1e3 * dt)
    return {key: float(np.median(v)) for key, v in parts.items()}


def phase8(card, kernels):
    """BLS12-381 commits at 128 validators: the kernels' seams, the
    per-signature and aggregated commits, a mixed set. Returns the three
    BLS kernels' rows of the JSON line."""
    from tendermint_tpu_torch import (AggregatedCommit, BLSPrivKey, Ed25519PrivKey, Validator, ValidatorSet,
                                      aggregate_commit_votes, get_default_bls_provider)
    from tendermint_tpu_torch.crypto.bls import decode_signature, has_possession, register_possession
    from tendermint_tpu_torch.ops import bls12 as bls
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import ref_bls12 as ref
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.utils.bits import BitArray

    rng = np.random.default_rng(SEED + 8)
    t0 = time.perf_counter()
    privs = [BLSPrivKey.from_secret(rng.bytes(32)) for _ in range(N_BLS)]
    t1 = time.perf_counter()
    for p in privs:  # the proofs of possession, checked on the host by the oracle as they register
        require(register_possession(p.pub_key().bytes(), p.prove_possession()), "a proof of possession registers")
    t2 = time.perf_counter()
    powers = rng.integers(1, 1 << 40, N_BLS)
    vs = ValidatorSet([Validator(p.pub_key(), int(w)) for p, w in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    commit = signed_commit(vs, by_addr, bid, HEIGHT, 1_760_000_300_000_000_000, rng)
    t3 = time.perf_counter()
    rows_present = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    print(f"phase 8: {N_BLS} BLS validators: keys {t1 - t0:.1f} s, {N_BLS} proofs of possession made and registered "
          f"{t2 - t1:.1f} s, the commit ({len(rows_present)} rows) signed {t3 - t2:.1f} s")
    errs, pair_inputs, agg_inputs = bls_kernel_seams(bls, ref, rng, vs, commit, card)

    # -- the per-signature commit through verify_commit
    def launches_of(fn):
        bls.reset_launches()
        ed.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {**bls.launches(), **ed.launches()}

    n_sig = launches_of(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, fresh(commit)))
    require(n_sig["bls12_map_to_g2"] == 1 and n_sig["bls12_pairing_check"] == 1 and n_sig["bls12_g1_aggregate"] == 0,
            f"a per-signature BLS verify_commit: one map and one pairing launch: {n_sig}")
    print(f"  per-signature verify_commit @{N_BLS} ({len(rows_present)} rows) passed: launches "
          f"{ {k: v for k, v in n_sig.items() if k.startswith('bls')} }")
    r0 = rows_present[0]
    addr = commit.signatures[r0].validator_address.hex()
    for what, sig in (("a corrupted signature before quorum", commit.signatures[r0].signature[:95]
                       + bytes([commit.signatures[r0].signature[95] ^ 1])),
                      ("a malformed 96-byte signature", bytes(96)),
                      ("a 64-byte signature on a BLS row", commit.signatures[r0].signature[:64])):
        bad = fresh(commit)
        bad.signatures = list(bad.signatures)
        bad.signatures[r0] = dataclasses.replace(commit.signatures[r0], signature=sig)
        expect_error(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, bad), "ErrInvalidCommitSignature",
                     f"wrong signature #{r0} ({addr})", what)
    s50, s99, swall = events_and_wall(lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c), lambda: fresh(commit),
                                      reps=10)
    provider = get_default_bls_provider()
    ssplit = bls_split(provider, vs, commit)
    print(f"  per-signature verify_commit: 10 warm runs on fresh commits, CUDA events p50 {s50:.3f} ms p99 "
          f"{s99:.3f} ms, host clock p50 {swall:.3f} ms ({card})")
    print("    host clock split (medians of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ssplit.items()))

    # -- the aggregated commit over the same set
    t1 = time.perf_counter()
    ts = 1_760_000_400_000_000_000
    msg = AggregatedCommit(HEIGHT, 0, bid, ts, BitArray(N_BLS), bytes(96)).sign_bytes(CHAIN)
    present = rng.random(N_BLS) < 0.9
    agg = aggregate_commit_votes(CHAIN, HEIGHT, 0, bid, ts, N_BLS,
                                 [by_addr[v.address].sign(msg) if present[i] else None
                                  for i, v in enumerate(vs.validators)])
    print(f"  AggregatedCommit of {int(present.sum())} signers built in {time.perf_counter() - t1:.1f} s "
          f"({agg.wire_bytes()} B on the wire)")
    n_agg = launches_of(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, agg))
    require(n_agg["bls12_g1_aggregate"] == 1 and n_agg["bls12_map_to_g2"] == 1 and n_agg["bls12_pairing_check"] == 1,
            f"an aggregated verify_commit: one launch each of aggregate, map and pairing: {n_agg}")
    print(f"  aggregated verify_commit passed: launches { {k: v for k, v in n_agg.items() if k.startswith('bls')} }")
    stranger = BLSPrivKey.from_secret(rng.bytes(32))
    vs_x = ValidatorSet(list(vs.validators) + [Validator(stranger.pub_key(), 1 << 30)])
    ix = vs_x.get_by_address(stranger.pub_key().address())[0]
    sx = BitArray(N_BLS + 1)
    sx.set_index(ix, True)
    expect_error(lambda: vs_x.verify_commit(CHAIN, bid, HEIGHT, AggregatedCommit(HEIGHT, 0, bid, ts, sx, agg.agg_sig)),
                 "ErrInvalidCommit", f"aggregated commit flags validator {ix} without a verified proof-of-possession "
                 "(rogue-key defense)", "a flagged signer without a proof of possession")
    eds = [Ed25519PrivKey(rng.bytes(32)) for _ in range(N_BLS // 2)]
    mixed = ValidatorSet([Validator(k.pub_key(), int(w)) for k, w in zip(eds + privs[: N_BLS // 2], powers)])
    flag_ed = BitArray(N_BLS)
    for i, v in enumerate(mixed.validators):
        flag_ed.set_index(i, True)
    expect_error(lambda: mixed.verify_commit(CHAIN, bid, HEIGHT, AggregatedCommit(HEIGHT, 0, bid, ts, flag_ed,
                                                                                   agg.agg_sig)),
                 "ErrInvalidCommit", "aggregated commit flags a validator without a BLS key",
                 "a flagged non-BLS validator")
    wrong = AggregatedCommit(HEIGHT, 0, bid, ts, agg.signers, commit.signatures[r0].signature)
    expect_error(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, wrong), "ErrInvalidCommitSignature",
                 "aggregate signature does not verify against the signer set", "a wrong aggregate signature")
    low = BitArray(N_BLS)
    talled, needed = 0, vs.total_voting_power() * 2 // 3
    for i, v in enumerate(vs.validators):
        if talled + v.voting_power <= needed and present[i]:
            low.set_index(i, True)
            talled += v.voting_power
    expect_error(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, AggregatedCommit(HEIGHT, 0, bid, ts, low, agg.agg_sig)),
                 "ErrNotEnoughVotingPower", f"have {talled}, need > {needed}", "too little power")
    a50, a99, awall = events_and_wall(lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c),
                                      lambda: AggregatedCommit.decode(agg.encode()), reps=20)
    aparts = {"checks_bitmap_pop": [], "aggregate": [], "decode_sig": [], "hash_to_field": [], "map": [],
              "pairing": []}
    pk_table, _mask = vs.bls_cache()
    table = [pk_table[i].tobytes() for i in range(N_BLS)]
    for _ in range(5):
        c = AggregatedCommit.decode(agg.encode())
        t = time.perf_counter()
        mask = c.signers.as_numpy()
        require(all(has_possession(pk_table[i].tobytes()) for i in np.flatnonzero(mask)), "proofs registered")
        m = c.sign_bytes(CHAIN)
        t1 = time.perf_counter()
        apk = provider.aggregate_pubkey(table, mask)
        t2 = time.perf_counter()
        spt = decode_signature(c.agg_sig)
        t3 = time.perf_counter()
        u0, u1 = field_pairs(bls, ref, [m])
        t4 = time.perf_counter()
        hm, _inf = bls.map_to_g2(u0, u1)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        okv, _v = bls.pairing_check_rows(bls.g1_tensor([apk], "cuda"), hm, bls.g2_tensor([spt], "cuda"))
        require(bool(okv.cpu()[0]), "the aggregate verifies")
        t6 = time.perf_counter()
        for key, dt in zip(aparts, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5)):
            aparts[key].append(1e3 * dt)
    asplit = {k: float(np.median(v)) for k, v in aparts.items()}
    print(f"  aggregated verify_commit: 20 warm runs on fresh copies, CUDA events p50 {a50:.3f} ms p99 {a99:.3f} ms, "
          f"host clock p50 {awall:.3f} ms ({card})")
    print("    host clock split (medians of 5): " + ", ".join(f"{k} {v:.3f} ms" for k, v in asplit.items()))

    # -- a mixed set: 64 ed25519 and 64 BLS validators
    by_mixed = {k.pub_key().address(): k for k in eds + privs[: N_BLS // 2]}
    mcommit = signed_commit(mixed, by_mixed, bid, HEIGHT, 1_760_000_500_000_000_000, rng)
    n_mix = launches_of(lambda: mixed.verify_commit(CHAIN, bid, HEIGHT, fresh(mcommit)))
    require(n_mix["bls12_map_to_g2"] == 1 and n_mix["bls12_pairing_check"] == 1
            and all(n_mix[k] > 0 for k in ("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish"))
            and n_mix["ed25519_prepare"] == 0 and n_mix["ed25519_scan"] == 0,
            f"a mixed set's verify_commit ran the tabled ed25519 kernels and the BLS map and pairing: {n_mix}")
    ed_rows = [i for i, cs in enumerate(mcommit.signatures) if not cs.absent_() and len(cs.signature) == 64]
    bls_rows = [i for i, cs in enumerate(mcommit.signatures) if not cs.absent_() and len(cs.signature) == 96]
    for what, row in (("a corrupted ed25519 row", ed_rows[0]), ("a corrupted BLS row", bls_rows[0])):
        bad = fresh(mcommit)
        bad.signatures = list(bad.signatures)
        cs = mcommit.signatures[row]
        bad.signatures[row] = dataclasses.replace(cs, signature=bytes([cs.signature[0] ^ 4]) + cs.signature[1:])
        before = sum(mixed.validators[i].voting_power for i, c in enumerate(mcommit.signatures[:row]) if c.for_block())
        require(before <= mixed.total_voting_power() * 2 // 3, f"{what}: row {row} is read before quorum")
        expect_error(lambda: mixed.verify_commit(CHAIN, bid, HEIGHT, bad), "ErrInvalidCommitSignature",
                     f"wrong signature #{row} ({cs.validator_address.hex()})", f"mixed set, {what}")
    m50, m99, mwall = events_and_wall(lambda c: mixed.verify_commit(CHAIN, bid, HEIGHT, c), lambda: fresh(mcommit),
                                      reps=10)
    print(f"  mixed set ({N_BLS // 2} ed25519, {N_BLS // 2} BLS) verify_commit passed: launches {n_mix}; 10 warm runs "
          f"on fresh commits, "
          f"CUDA events p50 {m50:.3f} ms p99 {m99:.3f} ms, host clock p50 {mwall:.3f} ms ({card})")

    # -- the kernels' rows: times at the main path's shapes, bounds
    n_rows = len([i for i in rows_present if len(commit.signatures[i].signature) == 96])
    pk_t, hm_t, sg_t = (x[:n_rows].contiguous() for x in pair_inputs)
    u0, u1 = field_pairs(bls, ref, [rng.bytes(40) for _ in range(n_rows)])
    pts_v, mask1 = agg_inputs[N_AGG[0]][0], agg_inputs[N_AGG[0]][1][4:5].contiguous()
    # the Fp products one row runs, on the host build of the kernels'
    # headers, which computes the kernels' values: row 0 of each
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops.bls12_host import AGG_CHUNK, AGG_LANES, HostBLS

    host = HostBLS(_build.BUILD_DIR / "bls12_host")
    raw = lambda t: t.cpu().numpy().tobytes()  # noqa: E731
    ok0, v0 = bls.pairing_check_rows(pk_t[:1], hm_t[:1], sg_t[:1])
    q0, inf0 = bls.map_to_g2(u0[:1], u1[:1])
    s0, sinf0 = bls.g1_aggregate(pts_v, mask1)
    run_muls, host_out = {}, {}
    run_muls["bls12_pairing_check"] = kernel_fp_muls(
        host, lambda: host_out.update(pairing=host.pairing_row(raw(pk_t[0]), raw(hm_t[0]), raw(sg_t[0]))))
    run_muls["bls12_map_to_g2"] = kernel_fp_muls(host, lambda: host_out.update(map=host.map_row(raw(u0[0]), raw(u1[0]))))
    agg_run = {}
    compiled = bls.lanes()
    require((compiled["bls12_g1_aggregate_chunk"], compiled["bls12_g1_aggregate"]) == (AGG_CHUNK, AGG_LANES),
            f"ops/bls12_host.py's AGG_CHUNK, AGG_LANES are the compiled values: {compiled}")
    for v in N_AGG:
        pv_, mv_ = agg_inputs[v]
        agg_run[v] = kernel_fp_muls(host, lambda: host_out.update({v: host.g1_sum(
            raw(pv_), raw(mv_[4]), compiled["bls12_g1_aggregate_chunk"], compiled["bls12_g1_aggregate"])}))
    run_muls["bls12_g1_aggregate"] = agg_run[N_AGG[0]]
    require(host_out["pairing"] == (bool(ok0[0]), raw(v0[0])) and host_out["map"] == (raw(q0[0, 0]), raw(q0[0, 1]),
                                                                                      bool(inf0[0]))
            and host_out[N_AGG[0]] == (raw(s0[0]), bool(sinf0[0])),
            "the host build of the kernels' headers computes the kernels' values")
    needed = bls_needed_fp_muls(ref)
    per_point, fixed = needed.pop("bls12_g1_aggregate")
    fermat_inv = needed.pop("bls12_g1_aggregate_fermat_inversion")
    agg_muls = {v: per_point * int(agg_inputs[v][1][4].sum()) + fixed for v in N_AGG}
    muls = {**needed, "bls12_g1_aggregate": agg_muls[N_AGG[0]]}
    forms = fp_mul_instructions()
    # the bound's product: the cheapest form of fp_mul the repo has, so a
    # bound does not grow with the kernels' own product
    mul_instr = FP381_MUL_INSTR_MODEL if forms is None else min(n for n, _ops in forms.values())
    ops_per_fp_mul = 2 * mul_instr  # each at the 32-bit integer rate, 2 operations (as SHA-256's)
    fp_mul_sass = None if forms is None else {form: n for form, (n, _ops) in forms.items()}
    print(f"  the bounds: an Fp multiplication {mul_instr} sm_90a instructions, "
          + ("the model (no cuobjdump)" if forms is None else
             "the fewer of fp_mul's two forms, SASS: " + "; ".join(f"{form} {n} {ops}"
                                                                  for form, (n, ops) in forms.items()))
          + "; Fp multiplications a row needed / run by the kernels (counted on their host build): "
          + ", ".join(f"{k} {muls[k]} / {run_muls[k]}" for k in muls)
          + f"; the aggregate at {N_AGG}: " + " / ".join(f"{agg_muls[v]} / {agg_run[v]}" for v in N_AGG))
    usage = {name: ptxas_usage(name) for name in bls.KERNELS}
    print("  registers, stack frame and cumulative stack (bytes) by -Xptxas -v: "
          + "; ".join(f"{k} {u.get('registers')} / {u.get('stack_frame')} / {u.get('cumulative_stack')}"
                      for k, u in usage.items()))
    kept = bls.lanes()
    agg_chunk = kept.pop("bls12_g1_aggregate_chunk")
    agg_blocks = {v: max(1, -(-v // agg_chunk)) for v in N_AGG}
    print("  lanes a row, an addition of the aggregate (G, compiled in): "
          + ", ".join(f"{k} {g}" for k, g in kept.items())
          + f"; the aggregate's points a block {agg_chunk}, blocks a row "
          + ", ".join(f"{b} at {v}" for v, b in agg_blocks.items()))
    runs = {
        "bls12_pairing_check": (lambda: bls.pairing_check_rows(pk_t, hm_t, sg_t),
                                lambda: bls.pairing_plain(pk_t, hm_t, sg_t), n_rows, 5),
        "bls12_map_to_g2": (lambda: bls.map_to_g2(u0, u1), lambda: bls.map_plain(u0, u1), n_rows, 5),
        "bls12_g1_aggregate": (lambda: bls.g1_aggregate(pts_v, mask1), lambda: bls.aggregate_plain(pts_v, mask1),
                               1, 50),
    }
    io = {"bls12_pairing_check": n_rows * (96 + 192 + 192) + n_rows * (576 + 1),
          "bls12_map_to_g2": n_rows * (96 + 96) + n_rows * (192 + 1),
          "bls12_g1_aggregate": N_AGG[0] * 97 + 96 + 1}
    replaces = {"bls12_pairing_check": "tendermint_tpu/ops/bls12.py:979",
                "bls12_map_to_g2": "tendermint_tpu/ops/bls12.py:842",
                "bls12_g1_aggregate": "tendermint_tpu/ops/bls12.py:771"}
    also = {"bls12_pairing_check": "tendermint_tpu/ops/bls12.py:994 (pairing_value, one pair a row)",
            "bls12_map_to_g2": None, "bls12_g1_aggregate": None}
    rows_out = {}
    for name, (kern, plain, nrows, reps) in runs.items():
        ops = nrows * muls[name] * ops_per_fp_mul + (GCD_INV_OPS if name == "bls12_g1_aggregate" else 0)
        row = kernel_row(name, "bls12_kernels.cu", n_sig[name] if name != "bls12_g1_aggregate" else n_agg[name],
                         errs[name], median_ms(kern, reps=reps, repeats=3), median_ms(plain, reps=1, repeats=2),
                         io[name], ops, nrows, muls[name])
        row.update(replaces=replaces[name], replaces_also=also[name], ms_device_only=device_ms(kern, reps=reps),
                   launches_aggregated_commit=n_agg[name], launches_mixed_set=n_mix[name],
                   ops_per_fp_mul=ops_per_fp_mul, fp_mul_sass_instructions=fp_mul_sass,
                   fp_muls_per_row_run=run_muls[name], **usage[name])
        if name in kept:
            row["lanes"] = kept[name]
        rows_out[name] = row
    agg_row = rows_out["bls12_g1_aggregate"]
    agg_row.update(chunk=agg_chunk, blocks_per_row={v: agg_blocks[v] for v in N_AGG}, inversion_ops=GCD_INV_OPS)
    for v in N_AGG:
        agg_row[f"bound_ms_fermat_inversion_at_{v}"] = (1e3 * (agg_muls[v] + fermat_inv) * ops_per_fp_mul
                                                         / INT32_MAD_OPS_PER_S)
        if v == N_AGG[0]:
            continue
        pv_, mv_ = agg_inputs[v]
        m1 = mv_[4:5].contiguous()
        agg_row[f"ms_at_{v}"] = median_ms(lambda: bls.g1_aggregate(pv_, m1), reps=10, repeats=3)
        agg_row[f"ms_device_only_at_{v}"] = device_ms(lambda: bls.g1_aggregate(pv_, m1), reps=10)
        agg_row[f"bound_ms_at_{v}"] = 1e3 * (agg_muls[v] * ops_per_fp_mul + GCD_INV_OPS) / INT32_MAD_OPS_PER_S
        agg_row[f"fp_muls_run_at_{v}"] = agg_run[v]
    for k in kernels.values():
        k["launches_bls_commit"] = n_sig.get(k["name"], 0)
        k["launches_bls_mixed_set"] = n_mix.get(k["name"], 0)
    rows_out["bls12_pairing_check"]["verify_commit_ms"] = {"per_signature": [s50, s99, swall],
                                                           "aggregated": [a50, a99, awall], "mixed": [m50, m99, mwall]}
    rows_out["bls12_pairing_check"]["host_split_ms"] = {"per_signature": ssplit, "aggregated": asplit}
    # the pairing rows as oracle points (the commit's decoded rows, then the
    # adversarial ones), for the routed engine of phase 9
    flags = torch.zeros(pair_inputs[0].shape[0], dtype=torch.bool)
    bls_rows = list(zip(bls.g1_points(pair_inputs[0], flags), bls.g2_points(pair_inputs[1], flags),
                        bls.g2_points(pair_inputs[2], flags)))
    return rows_out, bls_rows


# -- phase 9: the mesh runtime ------------------------------------------------


def all_launches() -> dict:
    from tendermint_tpu_torch.ops import bls12, ed25519, sha256

    return {**ed25519.launches(), **sha256.launches(), **bls12.launches()}


def reset_all_launches() -> None:
    from tendermint_tpu_torch.ops import bls12, ed25519, sha256

    ed25519.reset_launches()
    sha256.reset_launches()
    bls12.reset_launches()


def counted_run(fn):
    """The launch counts of one call of `fn`: set to 0 just before, read
    just after. Returns (counts, fn's value)."""
    reset_all_launches()
    out = fn()
    torch.cuda.synchronize()
    return {k: v for k, v in all_launches().items() if v}, out


def plan_recorder(router):
    """Record the rows of every plan `router` makes, and whether it was
    collective: the rows the engines sent through it."""
    seen = []
    plan = router.plan

    def recording(n, min_rows=None):
        p = plan(n, min_rows)
        seen.append((int(n), p.collective))
        return p

    router.plan = recording
    return seen


def check_router(router, seen, what: str, collective: bool, before=None) -> dict:
    """The router's stats after the calls that `seen` recorded (since the
    stats `before`, if given)."""
    st = router.stats()
    sent = sum(n for n, c in seen if c)
    rows = sum(st["device_rows"]) - (sum(before["device_rows"]) if before else 0)
    require(st["shard_failures"] == 0, f"{what}: no shard failed: {st}")
    require(rows == sent, f"{what}: device_rows sum to the {sent} rows of its collective plans: {st}")
    if collective:
        require(st["collective_bundles"] >= 1, f"{what}: collective bundles ran: {st}")
    else:
        require(st["collective_bundles"] == 0, f"{what}: a one-device topology is never collective: {st}")
    return {k: st[k] for k in ("devices", "admitted", "collective_bundles", "single_bundles", "shard_failures",
                               "sheds", "device_rows")}


def routed_engines(vs, vs_b, commit, bid, router, verifier_t, verifier_g, bls_rows, want):
    """The four routed calls (tabled and generic verify_commit, the BLS
    engine, the merkle root) and verify_commit_trusting through `router`,
    each held bit-identical to its unrouted result in `want`. Returns
    {call: launch counts}."""
    from tendermint_tpu_torch import BLSEngine, MerkleHasher, TorchBatchVerifier, get_default_provider, \
        set_default_provider
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.ops import sha256 as sha

    key, all_pk = vs.batch_cache()
    _i, vals_idx, csig, cpow, ccnt, _s, tpl = vs._commit_batch_arrays(CHAIN, commit)
    key_b, pk_b = vs_b.batch_cache()
    _ib, b_vals, b_sig, _pb, _cb, _sb, b_tpl = vs_b._commit_batch_arrays(CHAIN, commit, by_address=True)
    routed_t = TorchBatchVerifier(router=router)
    routed_g = type(verifier_g)(router=router)
    counts = {}
    prev = get_default_provider()
    set_default_provider(routed_t)
    try:
        counts["verify_commit (tabled, default provider)"], _ = counted_run(
            lambda: vs.verify_commit(CHAIN, bid, HEIGHT, fresh(commit)))
    finally:
        set_default_provider(prev)
    ok_t = routed_t.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig)
    require(np.array_equal(ok_t, want["ok_t"]), "routed tabled verdicts equal the unrouted ones")
    counts["verify_commit (generic)"], _ = counted_run(
        lambda: vs.verify_commit(CHAIN, bid, HEIGHT, fresh(commit), provider=routed_g))
    ok_g, tally_g = routed_g.verify_commit_batch(all_pk[vals_idx], splice_ts(tpl), csig, cpow, ccnt)
    require(np.array_equal(ok_g, want["ok_g"]) and tally_g == want["tally_g"],
            f"routed generic verdicts and tally equal the unrouted ones ({tally_g} vs {want['tally_g']})")
    counts["verify_commit_trusting"], _ = counted_run(
        lambda: vs_b.verify_commit_trusting(CHAIN, bid, HEIGHT, fresh(commit), Fraction(1, 3), provider=routed_t))
    ok_b = routed_t.verify_rows_cached_templated(key_b, pk_b, b_vals, *b_tpl, b_sig)
    require(np.array_equal(ok_b, want["ok_b"]), "routed trusting verdicts equal the unrouted ones")
    counts["BLSEngine.verify_rows"], ok_bls = counted_run(
        lambda: BLSEngine(router=router).verify_rows(bls_rows))
    require(np.array_equal(ok_bls, want["ok_bls"]), "routed BLS verdicts equal the unrouted ones")
    counts["MerkleHasher.root"], root = counted_run(lambda: MerkleHasher(router=router).root(want["leaves"]))
    routed = MerkleHasher(router=router)
    err, routed_root = tree_seams(sha, routed.leaf_states(*routed.pack(want["leaves"])))
    require(err == 0 and routed_root == want["root"],
            f"merkle_tree on the routed leaf states is identical to its plain version ({err})")
    merkle.configure_device(router=router)
    try:
        seam_root = merkle.hash_from_byte_slices(want["leaves"])
    finally:
        merkle.configure_device(router=None)
    require(root == seam_root == want["root"], "routed merkle roots equal the unrouted one")
    return counts


def paired_ms(call_a, call_b, make, reps: int):
    """CUDA events p50 and p99 of `call_a(make())` and `call_b(make())`,
    called in turns (the order alternating), each on a fresh `make()`
    made outside the timed span: (a50, a99, b50, b99)."""
    times = ([], [])
    for i in range(reps):
        for which in ((0, 1) if i % 2 == 0 else (1, 0)):
            arg = make()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            (call_a, call_b)[which](arg)
            end.record()
            torch.cuda.synchronize()
            times[which].append(start.elapsed_time(end))
    return tuple(float(np.percentile(t, q)) for t in times for q in (50, 99))


def splice_ts(tpl):
    from tendermint_tpu_torch.codec.signbytes import splice_timestamps

    return splice_timestamps(tpl[0][tpl[1]], tpl[2])


def phase9(vs, vs_b, commit, bid, card, kernels, bls_rows, verifier_t, verifier_g, unrouted_ms):
    """The mesh runtime (parallel/): the real topology, placed lanes on
    this card (and the real devices when there are several), logical
    lanes, a lane that fails, and the cost of splitting a bundle."""
    from tendermint_tpu_torch import (BLSEngine, DeviceTopology, MerkleHasher, MeshRoutedVerifier, MeshRouter,
                                      TorchBatchVerifier, get_default_provider, set_default_provider)
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.utils.watchdog import CircuitBreaker

    t_phase = time.perf_counter()
    key, all_pk = vs.batch_cache()
    _i, vals_idx, csig, cpow, ccnt, _s, tpl = vs._commit_batch_arrays(CHAIN, commit)
    key_b, pk_b = vs_b.batch_cache()
    _ib, b_vals, b_sig, _pb, _cb, _sb, b_tpl = vs_b._commit_batch_arrays(CHAIN, commit, by_address=True)
    n = len(vals_idx)
    ok_g, tally_g = verifier_g.verify_commit_batch(all_pk[vals_idx], splice_ts(tpl), csig, cpow, ccnt)
    leaves = [v.hash_bytes() for v in vs.validators]
    want = {"ok_t": verifier_t.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig),
            "ok_g": ok_g, "tally_g": tally_g,
            "ok_b": verifier_t.verify_rows_cached_templated(key_b, pk_b, b_vals, *b_tpl, b_sig),
            "ok_bls": BLSEngine().verify_rows(bls_rows), "leaves": leaves, "root": MerkleHasher().root(leaves)}
    require(bool(want["ok_t"].all()) and not want["ok_bls"].all() and want["ok_bls"][:N_BLS - 8].all(),
            "the unrouted references: every commit row verifies; the BLS rows hold rejected adversarial rows")
    report = {}

    # 1. the real topology
    topo = DeviceTopology.discover()
    require(topo is not None and len(topo) == torch.cuda.device_count(),
            f"discover() lists every CUDA device: {None if topo is None else topo.devices}")
    real = MeshRouter(topo, min_rows=256)
    if len(topo) == 1:
        plans = [real.plan(m) for m in (1, 255, 256, n, 100_000)]
        require(not any(p.collective for p in plans), "one device: no plan is collective")
    seen = plan_recorder(real)
    counts = routed_engines(vs, vs_b, commit, bid, real, verifier_t, verifier_g, bls_rows, want)
    report["real topology"] = {"devices": [str(d) for d in topo.devices], "launches": counts,
                               "router": check_router(real, seen, "the real topology", len(topo) > 1)}
    print(f"phase 9: DeviceTopology.discover() = {[str(d) for d in topo.devices]} (platform {topo.platform}); "
          f"routed calls identical to the unrouted ones; router {report['real topology']['router']}")

    # 2. placed lanes: two lanes of this card, then the real devices
    placed = [("two lanes of cuda:0", DeviceTopology([torch.device("cuda", 0)] * 2))]
    if torch.cuda.device_count() >= 2:
        placed.append((f"{min(4, torch.cuda.device_count())} devices", DeviceTopology.discover(max_devices=4)))
    else:
        print("  the placed path over several real devices was not run: torch.cuda.device_count() is 1 on this "
              "machine")
    lanes_two = None
    for what, topo_p in placed:
        router = MeshRouter(topo_p, min_rows=256)
        seen = plan_recorder(router)
        slots = len(range(0, n, -(-n // len(topo_p))))  # the plan's non-empty chunks
        distinct = len(set(topo_p.devices))
        before = router.stats()
        counts = routed_engines(vs, vs_b, commit, bid, router, verifier_t, verifier_g, bls_rows, want)
        # a bad signature in the second lane's chunk, before quorum, and 60 % of the power
        second = -(-n // slots) + 5
        routed_t = TorchBatchVerifier(router=router)
        errs_t = negative_cases(vs, commit, bid, routed_t, bad_pos=second, quiet=True)
        errs_g = negative_cases(vs, commit, bid, type(verifier_g)(router=router), bad_pos=second, quiet=True)
        want_errs = negative_cases(vs, commit, bid, verifier_t, bad_pos=second, quiet=True)
        require(errs_t == errs_g == want_errs, f"{what}: routed errors equal the unrouted ones: {errs_t} {want_errs}")
        st = router.stats()
        for name in ("ed25519_build_tables",):
            require(counts["verify_commit (tabled, default provider)"].get(name) == distinct
                    and counts["verify_commit_trusting"].get(name) == distinct,
                    f"{what}: the tables built once a distinct device and set: {counts}")
        for call, names in (("verify_commit (tabled, default provider)",
                             ("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish")),
                            ("verify_commit_trusting", ("ed25519_prepare_tabled", "ed25519_scan_tabled",
                                                        "ed25519_finish")),
                            ("verify_commit (generic)", ("ed25519_prepare", "ed25519_scan", "ed25519_finish")),
                            ("BLSEngine.verify_rows", ("bls12_pairing_check",)),
                            ("MerkleHasher.root", ("sha256_leaf_blocks",))):
            require(all(counts[call].get(k) == slots for k in names), f"{what}: {call} launched each routed kernel "
                                                                       f"once a slot ({slots}): {counts[call]}")
        require(counts["verify_commit (generic)"].get("ed25519_prepare_tabled") is None
                and counts["verify_commit (tabled, default provider)"].get("ed25519_prepare") is None,
                f"{what}: each path ran its own kernels: {counts}")
        require(counts["MerkleHasher.root"].get("merkle_tree") == 1,
                f"the tree ran unrouted, in one launch: {counts['MerkleHasher.root']}")
        report[what] = {"slots": slots, "distinct_devices": distinct, "launches": counts, "errors": errs_t,
                        "router": check_router(router, seen, what, True)}
        require(st["collective_bundles"] > before["collective_bundles"], f"{what}: the bundles were collective")
        print(f"  placed, {what} ({slots} slots): launches {counts}; negative cases with the bad row in the second "
              f"lane: {[e[0] for e in errs_t]}, identical to the unrouted errors; router {report[what]['router']}")
        if lanes_two is None:
            lanes_two = (router, routed_t, type(verifier_g)(router=router), counts)

    # 3. logical lanes under ValidatorSet.verify_commit
    for path, inner in (("tabled", TorchBatchVerifier()), ("generic", type(verifier_g)())):
        lr = MeshRouter(DeviceTopology.logical(4))
        seen = plan_recorder(lr)
        mv = MeshRoutedVerifier(inner, lr)
        prev = get_default_provider()
        set_default_provider(mv)
        try:
            c, _ = counted_run(lambda: vs.verify_commit(CHAIN, bid, HEIGHT, fresh(commit)))
        finally:
            set_default_provider(prev)
        names = (("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish") if path == "tabled"
                 else ("ed25519_prepare", "ed25519_scan", "ed25519_finish"))
        require(all(c.get(k) == 4 for k in names), f"logical lanes, {path}: four launches of each kernel: {c}")
        if path == "tabled":
            got = mv.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig)
            require(np.array_equal(got, want["ok_t"]), "logical lanes: tabled verdicts identical")
        else:
            got = mv.verify_commit_batch(all_pk[vals_idx], splice_ts(tpl), csig, cpow, ccnt)
            require(np.array_equal(got[0], want["ok_g"]) and got[1] == want["tally_g"],
                    "logical lanes: generic verdicts and tally identical")
        report[f"logical lanes, {path}"] = {"launches": c, "router": check_router(lr, seen, f"logical {path}", True)}
        print(f"  logical lanes (4), {path} path under verify_commit: launches {c}; verdicts identical")

    # 4. a lane that fails: the inner verifier raises on the second slot
    class FailSecondSlot(TorchBatchVerifier):
        calls = 0

        def verify_rows_cached_templated(self, *a):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("lane 1 down (injected by the smoke)")
            return super().verify_rows_cached_templated(*a)

    fr = MeshRouter(DeviceTopology.logical(4))
    fr.topology.breakers = [CircuitBreaker(f"mesh.device{i}", failure_threshold=1, cooldown_s=3600.0)
                            for i in range(4)]
    mv = MeshRoutedVerifier(FailSecondSlot(), fr)
    c_fail, got = counted_run(lambda: mv.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig))
    st = fr.stats()
    require(np.array_equal(got, want["ok_t"]), "a failed lane: the bundle's answer equals the unrouted one")
    require(c_fail.get("ed25519_prepare_tabled") == 2 and c_fail.get("ed25519_scan_tabled") == 2
            and c_fail.get("ed25519_finish") == 2,
            f"a failed lane: the first slot's launches, then the bundle recomputed by the kernels: {c_fail}")
    require(st["shard_failures"] == 1 and st["breakers"][1]["state"] == "open"
            and [b["state"] for b in st["breakers"]].count("open") == 1,
            f"a failed lane: one shard failure, that lane's breaker open: {st}")
    rows1 = st["device_rows"][1]
    got2 = mv.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig)
    st2 = fr.stats()
    require(np.array_equal(got2, want["ok_t"]) and st2["admitted"] == 3 and st2["device_rows"][1] == rows1
            and st2["shard_failures"] == 1, f"the next bundle's plan omits the failed lane: {st2}")
    report["a lane that fails"] = {"launches": c_fail, "stats_after": {k: st[k] for k in ("shard_failures",
                                                                                          "device_rows")},
                                   "next_bundle": {k: st2[k] for k in ("admitted", "sheds", "device_rows")}}
    print(f"  a lane that fails (logical 4, lane 1 raises): answer identical, launches {c_fail}, "
          f"shard_failures {st['shard_failures']}, breakers {[b['state'] for b in st['breakers']]}; the next "
          f"bundle over {st2['admitted']} lanes, device_rows {st2['device_rows']}")

    # 5. the cost of splitting a bundle: two lanes of this card
    router, routed_t, routed_g, two_counts = lanes_two
    before = router.stats()
    seen = plan_recorder(router)
    t50, t99, _wall = time_verify_commit(vs, commit, bid, routed_t, cold=True)
    g50, g99, _wall = time_verify_commit(vs, commit, bid, routed_g, cold=True)
    # one device and two lanes in turns, in this phase: verify_commit on
    # fresh commits, the BLS pairing rows, the merkle root
    paired = {
        "verify_commit tabled": paired_ms(
            lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c, provider=verifier_t),
            lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c, provider=routed_t), lambda: fresh(commit), 30),
        "verify_commit generic": paired_ms(
            lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c, provider=verifier_g),
            lambda c: vs.verify_commit(CHAIN, bid, HEIGHT, c, provider=routed_g), lambda: fresh(commit), 30),
        "BLSEngine.verify_rows": paired_ms(
            lambda e: e[0].verify_rows(bls_rows), lambda e: e[1].verify_rows(bls_rows),
            lambda: (BLSEngine(), BLSEngine(router=router)), 5),
        "MerkleHasher.root": paired_ms(
            lambda h: h[0].root(leaves), lambda h: h[1].root(leaves),
            lambda: (MerkleHasher(), MerkleHasher(router=router)), 10),
    }
    check_router(router, seen, "two lanes, timing", True, before)
    # the kernels alone: one launch of each stage over every row, against
    # one a lane over half the rows each, on device tensors
    entry = routed_t.model.tables_entry(key, all_pk)
    half = -(-n // 2)
    dev = torch.device("cuda")
    tsrc = {"idx": torch.from_numpy(vals_idx.astype(np.int32)).to(dev),
            "templates": torch.from_numpy(np.array(tpl[0])).to(dev),
            "tmpl_idx": torch.from_numpy(tpl[1].astype(np.int32)).to(dev),
            "ts8": torch.from_numpy(np.array(tpl[2])).to(dev)}
    tsig = torch.from_numpy(np.array(csig)).to(dev)
    g = [torch.from_numpy(np.array(a)).to(dev) for a in (all_pk[vals_idx], splice_ts(tpl), csig)]
    gp, gc = torch.from_numpy(np.asarray(cpow)).to(dev), torch.from_numpy(np.asarray(ccnt)).to(dev)

    def lanes_of(fn, k):
        bounds = [(lo, min(n, lo + -(-n // k))) for lo in range(0, n, -(-n // k))]
        return lambda: [fn(lo, hi) for lo, hi in bounds]

    def tabled_chunk(lo, hi):
        src = {"idx": tsrc["idx"][lo:hi], "templates": tsrc["templates"], "tmpl_idx": tsrc["tmpl_idx"][lo:hi],
               "ts8": tsrc["ts8"][lo:hi]}
        return ed.verify_tabled(entry.tables, entry.a_ok, entry.pk, tsig[lo:hi], **src)

    def generic_chunk(lo, hi):
        return ed.verify_and_tally(*(x[lo:hi] for x in g), gp[lo:hi], gc[lo:hi])

    kern = {path: {k: device_ms(lanes_of(fn, k), reps=10) for k in (1, 2)}
            for path, fn in (("tabled", tabled_chunk), ("generic", generic_chunk))}
    report["timing"] = {
        "verify_commit_ms_p50_p99": {"tabled": {"one_device": list(unrouted_ms["tabled"]), "two_lanes": [t50, t99]},
                                     "generic": {"one_device": list(unrouted_ms["generic"]),
                                                 "two_lanes": [g50, g99]}},
        "kernels_device_ms": {path: {"one_launch_a_stage": v[1], "two_lanes": v[2]} for path, v in kern.items()},
        "in_turns_ms_p50_p99": {what: {"one_device": list(v[:2]), "two_lanes": list(v[2:])}
                                for what, v in paired.items()},
        "rows": n, "half": half, "card": card,
    }
    for path, (p50, p99), (r50, r99) in (("tabled", unrouted_ms["tabled"], (t50, t99)),
                                         ("generic", unrouted_ms["generic"], (g50, g99))):
        print(f"  two lanes on one card: the cost of splitting a bundle, not a multi-GPU figure: {path} "
              f"verify_commit @{N_VALS} ({n} rows, {half} a lane), CUDA events p50 {r50:.3f} ms p99 {r99:.3f} ms "
              f"over 30 fresh commits, against one device's p50 {p50:.3f} ms p99 {p99:.3f} ms (phase "
              f"{5 if path == 'tabled' else 4}); the kernels alone {kern[path][2]:.4f} ms on the device for two "
              f"lanes against {kern[path][1]:.4f} ms for one launch a stage ({card})")
    for what, (a50, a99, b50, b99) in paired.items():
        print(f"  two lanes on one card, in turns with one device: {what} p50 {b50:.3f} ms p99 {b99:.3f} ms against "
              f"{a50:.3f} / {a99:.3f} ms ({card})")
    for k in kernels.values():
        k["launches_mesh_two_lanes"] = {call: c.get(k["name"], 0) for call, c in two_counts.items()
                                        if c.get(k["name"], 0)}
    print(json.dumps({"mesh": report}))
    print(f"phase 9: passed in {time.perf_counter() - t_phase:.1f} s")


# -- phase 10: a block's transactions and the mempool's tx keys ---------------


def leaf_split(sha, pack, items, tree: bool, reps: int = 10) -> dict:
    """The host clock split of one bundle through the leaf kernel (and
    the tree kernel, for a root), medians of `reps`: the pack, the upload
    of the blocks, offsets and counts (as models/hasher.py sends them),
    the kernels, the download of the root's or every row's digest
    (sha256.digest_list)."""
    parts = {"pack": [], "upload": [], "kernels": [], "download": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        blocks, offsets, counts = pack(list(items))
        t1 = time.perf_counter()
        n = counts.shape[0]
        b, o, c = (torch.from_numpy(a).cuda() for a in (blocks, offsets, counts))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st = sha.leaf_block_states(b, c, o)
        if tree:
            st = sha.merkle_tree(st, n)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        sha.digest_list(st)
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(1e3 * dt)
    return {key: float(np.median(v)) for key, v in parts.items()}


def phase10(card, kernels):
    """Txs.hash and proofs at 10,000 transactions and TxKeyHasher.keys at
    65,536, payments-sized and ragged: against hashlib, launch counts, p50
    on fresh objects and bundles, the host split, hashlib alone. Fills in
    sha256_leaf_blocks' and merkle_tree's launches on these paths."""
    from tendermint_tpu_torch import TxKeyHasher, Txs
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.ingest import hashing
    from tendermint_tpu_torch.models import hasher
    from tendermint_tpu_torch.ops import sha256 as sha

    rng = np.random.default_rng(SEED + 10)
    report = {}
    for kind in ("payments", "ragged"):
        t0 = time.perf_counter()
        items = tx_bundle(rng, N_TXS, kind == "ragged")
        root, aunts = host_tree(items)
        sha.reset_launches()
        txs = Txs(items)
        got = txs.hash()
        torch.cuda.synchronize()
        n_hash = sha.launches()
        proofs = [txs.proof(i) for i in range(len(items))]
        torch.cuda.synchronize()
        n_all = sha.launches()
        require(got == root, f"Txs.hash of {N_TXS} {kind} txs equals hashlib's recursion")
        require(n_hash == {"sha256_leaf_blocks": 1, "merkle_tree": 1},
                f"Txs.hash at {N_TXS}: one leaf launch and one tree launch: {n_hash}")
        require(n_all == {"sha256_leaf_blocks": 2, "merkle_tree": 2},
                f"Txs.proof built every proof from one more leaf and tree launch: {n_all}")
        require([p.proof.aunts for p in proofs] == aunts and all(p.validate(root) is None for p in proofs[::97]),
                f"every Txs proof's aunts equal hashlib's, and proofs validate against the root ({kind})")
        p50, p99, wall = events_and_wall(lambda t: t.hash(), lambda: Txs(items), reps=20)
        split = leaf_split(sha, hasher.MerkleHasher().pack, items, tree=True)
        saved = merkle.DEVICE_THRESHOLD
        merkle.DEVICE_THRESHOLD = len(items) + 1
        try:
            t = time.perf_counter()
            alone = [Txs(items).hash() for _ in range(5)]
            split["hashlib_alone"] = 1e3 * (time.perf_counter() - t) / 5
        finally:
            merkle.DEVICE_THRESHOLD = saved
        require(alone[0] == root, "hashlib's Txs root equals the card's")
        report[f"Txs.hash {kind}"] = dict(launches=n_hash, launches_with_proofs=n_all, p50=p50, p99=p99, wall=wall,
                                          split=split)
        print(f"phase 10: Txs.hash of {N_TXS} {kind} txs ({sum(map(len, items))} B): root and every proof's "
              f"aunts = hashlib, launches {n_hash} ({n_all} with the proofs); 20 calls on fresh Txs, CUDA events "
              f"p50 {p50:.3f} ms p99 {p99:.3f} ms, host clock p50 {wall:.3f} ms ({time.perf_counter() - t0:.1f} s; "
              f"{card})")
        print("  host clock split (medians of 10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

        t0 = time.perf_counter()
        bundle = tx_bundle(rng, N_TX_KEYS, kind == "ragged")
        want = hashing.host_keys(bundle)
        h = TxKeyHasher()
        sha.reset_launches()
        keys = h.keys_or_host(bundle, threshold=1)
        torch.cuda.synchronize()
        n_keys = sha.launches()
        require(keys == want, f"TxKeyHasher keys of {N_TX_KEYS} {kind} txs equal hashlib's")
        require(n_keys == {"sha256_leaf_blocks": 1, "merkle_tree": 0},
                f"TxKeyHasher: one leaf launch a bundle: {n_keys}")
        st = h.stats()
        require(st["hash_device_rows"] == N_TX_KEYS and st["hash_device_bundles"] == 1 and st["hash_host_rows"] == 0,
                f"TxKeyHasher counted every row on the device: {st}")
        p50, p99, wall = events_and_wall(h.keys, lambda: list(bundle), reps=10)
        split = leaf_split(sha, hashing.pack_msg_blocks, bundle, tree=False)
        t = time.perf_counter()
        for _ in range(3):
            hashing.host_keys(bundle)
        split["hashlib_alone"] = 1e3 * (time.perf_counter() - t) / 3
        report[f"TxKeyHasher.keys {kind}"] = dict(launches=n_keys, stats=st, p50=p50, p99=p99, wall=wall,
                                                  split=split)
        print(f"  TxKeyHasher.keys of {N_TX_KEYS} {kind} txs ({sum(map(len, bundle))} B): = hashlib, launches "
              f"{n_keys}, stats {st}; 10 calls on fresh bundles, CUDA events p50 {p50:.3f} ms p99 {p99:.3f} ms, "
              f"host clock p50 {wall:.3f} ms ({time.perf_counter() - t0:.1f} s; {card})")
        print("  host clock split (medians of 10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    lr = kernels["sha256_leaf_blocks"]
    lr.update(launches_txs_hash=report["Txs.hash ragged"]["launches"]["sha256_leaf_blocks"],
              launches_tx_keys=report["TxKeyHasher.keys ragged"]["launches"]["sha256_leaf_blocks"],
              transactions=report)
    kernels["merkle_tree"]["launches_txs_hash"] = report["Txs.hash ragged"]["launches"]["merkle_tree"]
    print(json.dumps({"transactions": report}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from tendermint_tpu_torch import Commit, ErrInvalidCommit, TorchBatchVerifier
    from tendermint_tpu_torch.codec.signbytes import splice_timestamps
    from tendermint_tpu_torch.ops import _build, curve, field
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import ref_ed25519 as ref

    t_start = time.perf_counter()
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"phase 1: built {lib_path.name} (ed25519, SHA-256 and BLS12-381 kernels) in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            print("  " + line.strip())
    t0 = time.perf_counter()
    comb = curve.base_comb256_limbs()
    print(f"  the tabled scan's base comb ({len(comb)} x {len(comb[0])} entries) built from the oracle on the "
          f"host in {time.perf_counter() - t0:.2f} s")

    # -- phase 2: kernels against their plain versions -----------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    rows = adversarial_batch(rng, N_BATCH)
    want = [ref.verify(*r) for r in rows]
    pk, msg, sig = to_dev(rows, 0), to_dev(rows, 1), to_dev(rows, 2)
    powers = torch.from_numpy(rng.integers(1, 1 << 40, N_BATCH)).cuda()
    counted = torch.from_numpy(rng.random(N_BATCH) < 0.8).cuda()
    errs, ok = compare_kernels(ed, field, pk, msg, sig, powers, counted)
    require(all(e == 0 for e in errs.values()), f"kernels identical to plain versions: {errs}")
    require(ok.tolist() == want, "kernel verdicts equal the pure-Python oracle")
    require(0 < sum(want) < N_BATCH, "the batch holds accepted and rejected rows")
    rfc_pk = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
    rfc_sig = bytes.fromhex(
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
    )
    rfc_rows = [(rfc_pk, b"", rfc_sig), (rfc_pk, b"", rfc_sig[:32] + bytes(32))]
    rfc_errs, rfc_ok = compare_kernels(
        ed, field, to_dev(rfc_rows, 0), torch.zeros((2, 0), dtype=torch.uint8, device="cuda"),
        to_dev(rfc_rows, 2), torch.ones(2, dtype=torch.int64, device="cuda"),
        torch.ones(2, dtype=torch.bool, device="cuda"),
    )
    require(all(e == 0 for e in rfc_errs.values()) and rfc_ok.tolist() == [True, False], "RFC 8032 vector 1")
    ragged = {}
    for nr in RAGGED_ROWS:
        rrows = ragged_batch(rng, nr)
        rwant = [ref.verify(*r) for r in rrows]
        rerrs, rok = compare_kernels(ed, field, to_dev(rrows, 0), to_dev(rrows, 1), to_dev(rrows, 2),
                                     torch.from_numpy(rng.integers(1, 1 << 40, nr)).cuda(),
                                     torch.from_numpy(rng.random(nr) < 0.8).cuda())
        require(all(e == 0 for e in rerrs.values()), f"kernels identical to plain versions at {nr} rows: {rerrs}")
        require(rok.tolist() == rwant, f"kernel verdicts equal the oracle at {nr} rows")
        ragged[nr] = sum(rwant)
    print(f"phase 2: {N_BATCH} rows ({sum(want)} valid), seams identical, verdicts = oracle; "
          f"RFC 8032 vector 1 ok; ragged batches {', '.join(f'{k} rows ({v} valid)' for k, v in ragged.items())} "
          f"(undecodable keys in warps' last rows and the last row): "
          f"seams identical, verdicts = oracle ({time.perf_counter() - t0:.1f} s)")

    # -- phase 3: the generic path -------------------------------------------
    t0 = time.perf_counter()
    vs, commit, bid, by_addr = build_commit(rng)
    print(f"phase 3: {N_VALS}-validator set and commit signed in {time.perf_counter() - t0:.1f} s")
    generic = ("ed25519_prepare", "ed25519_scan", "ed25519_finish")
    tabled = ("ed25519_build_tables", "ed25519_prepare_tabled", "ed25519_scan_tabled")

    class GenericOnly(TorchBatchVerifier):
        """The provider with its tabled path "not available" (the base
        BatchVerifier's None), so that commits take the generic path."""

        def verify_rows_cached(self, *a, **k):
            return None

        def verify_rows_cached_templated(self, *a, **k):
            return None

    verifier_g = GenericOnly()
    ed.reset_launches()
    vs.verify_commit(CHAIN, bid, HEIGHT, commit, provider=verifier_g)
    torch.cuda.synchronize()
    launches = ed.launches()
    require(all(launches[k] > 0 for k in generic), f"every generic kernel launched on its path: {launches}")
    require(all(launches[k] == 0 for k in tabled), f"no tabled kernel launched on the generic path: {launches}")
    rows_present = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    all_pk, _ = vs._device_arrays()
    _idxs, vals_idx, csig, cpow, ccnt, _sig_ok, tpl = vs._commit_batch_arrays(CHAIN, commit)
    cpk, cmsg = all_pk[vals_idx], splice_timestamps(tpl[0][tpl[1]], tpl[2])
    ok_all, tally = verifier_g.verify_commit_batch(cpk, cmsg, csig, cpow, ccnt)
    require(bool(ok_all.all()), "every present row of the honest commit verifies")
    require(tally == int(cpow[ccnt].sum()), "device tally equals the host sum of counted power")
    print(f"  verify_commit passed: {len(rows_present)} rows, launches {launches}, tally {tally}")
    negative_cases(vs, commit, bid, verifier_g)

    # -- phase 4: the generic path at its shapes, timing -----------------------
    p50, p99, wall50 = time_verify_commit(vs, commit, bid, verifier_g, cold=True)
    m50, m99, mwall50 = time_verify_commit(vs, commit, bid, verifier_g, cold=False)
    # host clock split of a fresh commit's call: each part of
    # verify_commit timed alone, in the order the call runs them
    parts = {"checks": [], "sign_bytes_parts": [], "packing": [], "provider": [], "replay": []}
    for _ in range(10):
        c = fresh(commit)
        t = time.perf_counter()
        vs._verify_commit_basic(c, HEIGHT, bid)
        t1 = time.perf_counter()
        c.sign_bytes_parts(CHAIN)
        t2 = time.perf_counter()
        idxs, vi, sg, pw, ct, sig_ok, tp = vs._commit_batch_arrays(CHAIN, c)
        pk_rows, msgs = all_pk[vi], splice_timestamps(tp[0][tp[1]], tp[2])
        t3 = time.perf_counter()
        ok_rows, talled = verifier_g.verify_commit_batch(pk_rows, msgs, sg, pw, ct & sig_ok)
        t4 = time.perf_counter()
        vs._replay_commit_full(c, np.asarray(ok_rows, dtype=bool) & sig_ok, idxs, pw, ct, talled)
        t5 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[key].append(1e3 * dt)
    split = {key: float(np.median(v)) for key, v in parts.items()}
    print(f"phase 4: generic verify_commit @{N_VALS} validators ({len(rows_present)} rows), 30 warm runs on a "
          f"fresh commit each, CUDA events p50 {p50:.3f} ms p99 {p99:.3f} ms, host clock p50 {wall50:.3f} ms; "
          f"30 on the same (memoised) commit, p50 {m50:.3f} ms p99 {m99:.3f} ms, host clock p50 {mwall50:.3f} ms "
          f"({card})")
    print("  host clock split of a fresh commit's call (medians of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; unattributed (host p50 minus the parts) {wall50 - sum(split.values()):.3f} ms")

    n = len(rows_present)
    g = [torch.from_numpy(np.array(a)).cuda() for a in (cpk, cmsg, csig)]
    gpow = torch.from_numpy(np.array(cpow)).cuda()
    gcnt = torch.from_numpy(np.array(ccnt)).cuda()
    errs_main, ok_main = compare_kernels(ed, field, *g, gpow, gcnt)
    require(all(e == 0 for e in errs_main.values()), f"kernels identical to plain versions on the main path: {errs_main}")
    require(bool(ok_main.all()), "every main-path row verifies")
    print(f"  main path, {n} rows: seams identical to the plain versions ({errs_main})")
    prep = ed.verify_stage_prepare(*g)
    point = ed.verify_stage_scan(*prep[:3])
    m = cmsg.shape[1]
    one = [t[:1].cpu() for t in g]
    one_prep = ed.verify_stage_prepare(*one)
    one_point = ed.verify_stage_scan(*one_prep[:3])
    muls = {
        "ed25519_prepare": field_muls_per_row(lambda: ed.verify_stage_prepare(*one)),
        "ed25519_scan": field_muls_per_row(lambda: ed.verify_stage_scan(*one_prep[:3])),
        "ed25519_finish": field_muls_per_row(
            lambda: ed.verify_stage_finish(one_point, one[2], one_prep[3], one_prep[4])),
    }
    sha_blocks = (64 + m + 17 + 127) // 128
    ops = {name: n * field_ops(muls[name]) for name in muls}
    ops["ed25519_prepare"] += n * sha_blocks * OPS_PER_SHA512_BLOCK
    # finish's inversions as one batch inversion (ED_GCD_INV_OPS); beside it,
    # one inversion a row by the GCD and by Fermat's chain (the plain
    # version's, counted)
    inv_fermat = field_ops(field_muls_per_row(lambda: field.invert(one_point[:, 2].to(torch.int64))))
    fin_rest = field_ops(muls["ed25519_finish"]) - inv_fermat
    ops_fin_a_row = {"gcd": n * (fin_rest + ED_GCD_INV_OPS), "fermat": n * (fin_rest + inv_fermat)}
    ops["ed25519_finish"] = n * (fin_rest + BATCH_INV_MULS_PER_ROW * OPS_PER_FIELD_MUL) + ED_GCD_INV_OPS
    io_bytes = {  # each input read once, each output written once
        "ed25519_prepare": n * (32 + m + 64) + n * (64 + 64 + 160 + 1 + 1),
        "ed25519_scan": n * (64 + 64 + 160) + n * 160,
        "ed25519_finish": n * (120 + 32 + 1 + 1 + 8 + 1) + n + 8,
    }
    runs = {
        "ed25519_prepare": (lambda: ed.verify_stage_prepare(*g), lambda: ed.prepare_plain(*g)),
        "ed25519_scan": (lambda: ed.verify_stage_scan(*prep[:3]), lambda: ed.scan_plain(*prep[:3])),
        "ed25519_finish": (
            lambda: ed.verify_stage_finish(point, g[2], prep[3], prep[4], tally=True, powers=gpow, counted=gcnt),
            lambda: ed.finish_plain(point, g[2], prep[3], prep[4], gpow, gcnt),
        ),
    }
    kernels = {}
    for name, (kern, plain) in runs.items():
        kernels[name] = kernel_row(name, "ed25519_kernels.cu", launches[name], max(errs[name], errs_main[name]),
                                   median_ms(kern, reps=20, repeats=5), median_ms(plain, reps=1, repeats=3),
                                   io_bytes[name], ops[name], n, sum(muls[name].values()))
        kernels[name].update(max_abs_err_adversarial=errs[name], max_abs_err_main_path=errs_main[name],
                             ms_device_only=device_ms(kern, reps=20),
                             field_squarings_per_row=muls[name]["squarings"], **ptxas_usage(name))
    fin = kernels["ed25519_finish"]
    fin.update(ops_per_launch=ED_GCD_INV_OPS, inversion_ops_gcd=ED_GCD_INV_OPS, inversion_ops_fermat=inv_fermat,
               **{f"bound_ms_{k}_inversion_a_row": 1e3 * max(io_bytes["ed25519_finish"] / HBM_BYTES_PER_S,
                                                             v / INT32_MAD_OPS_PER_S)
                  for k, v in ops_fin_a_row.items()})
    print(f"  ed25519_finish's bound {fin['bound_ms']:.4f} ms by {fin['bound_by']}: its inversions counted as one "
          f"batch inversion ({BATCH_INV_MULS_PER_ROW} products a row and a binary GCD's {ED_GCD_INV_OPS} "
          f"operations a launch); [{fin['bound_ms_gcd_inversion_a_row']:.4f} ms with a GCD a row, "
          f"{fin['bound_ms_fermat_inversion_a_row']:.4f} with Fermat's chain a row]")
    print(f"  generic kernels sum {sum(k['ms'] for k in kernels.values()):.4f} ms of the fresh-commit verify_commit p50 {p50:.3f} ms")

    # -- phase 5: the per-valset tabled path -----------------------------------
    verifier_t = TorchBatchVerifier()
    key, _ = vs.batch_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ed.reset_launches()
    t = time.perf_counter()
    vs.verify_commit(CHAIN, bid, HEIGHT, commit, provider=verifier_t)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t)
    launches_t = ed.launches()
    peak = torch.cuda.max_memory_allocated()
    entry = verifier_t.model.tables_entry(key, all_pk)
    require(ed.launches() == launches_t, "the set's tables are cached after the first call")
    require(all(launches_t[k] > 0 for k in tabled + ("ed25519_finish",)),
            f"every tabled kernel and ed25519_finish launched on the tabled path: {launches_t}")
    require(launches_t["ed25519_prepare"] == 0 and launches_t["ed25519_scan"] == 0,
            f"the generic prepare and scan did not launch on the tabled path: {launches_t}")
    # the table build alone: what it holds at its peak besides its outputs
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_out = ed.build_valset_tables(entry.pk)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - held
    del build_out
    print(f"phase 5: tabled verify_commit passed; first call {first_ms:.1f} ms, of which the table build "
          f"{1e3 * entry.build_s:.1f} ms ({N_VALS} validators, {entry.tables.numel() * 4 / 1e6:.1f} MB of tables); "
          f"peak device memory {peak / 1e6:.1f} MB ({(peak - mem0) / 1e6:.1f} MB above the {mem0 / 1e6:.1f} MB "
          f"held before); the table build alone {build_peak / 1e6:.2f} MB at its peak (tables and a_ok "
          f"{(entry.tables.numel() * 4 + N_VALS) / 1e6:.2f} MB); launches {launches_t}")
    _idxs, vals_idx, csig, cpow, ccnt, _sig_ok, tpl = vs._commit_batch_arrays(CHAIN, commit)
    ok_t = verifier_t.verify_rows_cached_templated(key, all_pk, vals_idx, *tpl, csig)
    require(bool(ok_t.all()), "every present row of the honest commit verifies on the tabled path")
    ed.reset_launches()
    negative_cases(vs, commit, bid, verifier_t)
    neg = ed.launches()
    require(neg["ed25519_prepare"] == 0 and neg["ed25519_scan"] == 0 and neg["ed25519_build_tables"] == 0
            and neg["ed25519_prepare_tabled"] == 2 and neg["ed25519_scan_tabled"] == 2,
            f"the negative cases ran on the cached tables alone: {neg}")

    vs_b = second_set(vs, rng)
    key_b, pk_b = vs_b.batch_cache()
    ed.reset_launches()
    vs_b.verify_commit_trusting(CHAIN, bid, HEIGHT, commit, Fraction(1, 3), provider=verifier_t)
    torch.cuda.synchronize()
    launches_tr = ed.launches()
    require(all(launches_tr[k] == 1 for k in tabled + ("ed25519_finish",))
            and launches_tr["ed25519_prepare"] == 0 and launches_tr["ed25519_scan"] == 0,
            f"verify_commit_trusting ran the tabled kernels: {launches_tr}")
    _i, b_vals, b_sig, _p, _c, _s, b_tpl = vs_b._commit_batch_arrays(CHAIN, commit, by_address=True)
    ok_b = verifier_t.verify_rows_cached_templated(key_b, pk_b, b_vals, *b_tpl, b_sig)
    ok_bg = verifier_g.verify_batch(pk_b[b_vals], splice_timestamps(b_tpl[0][b_tpl[1]], b_tpl[2]), b_sig)
    require(bool(ok_b.all()) and np.array_equal(ok_b, ok_bg), "trusting rows verify, as on the generic kernels")
    b_rows = [i for i, cs in enumerate(commit.signatures)
              if not cs.absent_() and vs_b.get_by_address(cs.validator_address)[1] is not None]
    dup = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    dup.signatures[b_rows[2]] = commit.signatures[b_rows[0]]
    try:
        vs_b.verify_commit_trusting(CHAIN, bid, HEIGHT, dup, Fraction(1, 3), provider=verifier_t)
    except ErrInvalidCommit as e:
        require(str(e).startswith("double vote from validator index"), f"duplicate signer: {e}")
        print(f"  duplicate signer before the trust level: ErrInvalidCommit ({e})")
    else:
        raise RuntimeError("a duplicate signer before the trust level was accepted")
    print(f"  verify_commit_trusting (1/3) against a set sharing {len(vs_b.validators) // 2} validators passed: "
          f"{len(b_rows)} rows read the second set's tables through their index; launches {launches_tr}")

    # each tabled kernel against its plain version, at the main path's
    # shapes and on the adversarial batch with its keys as the set
    err_build_main, plain_build_ms = compare_tables(ed, field, entry.pk, entry.tables, entry.a_ok)
    tsrc = {"idx": torch.from_numpy(vals_idx.astype(np.int32)).cuda(),
            "templates": torch.from_numpy(tpl[0].copy()).cuda(),
            "tmpl_idx": torch.from_numpy(tpl[1].astype(np.int32)).cuda(),
            "ts8": torch.from_numpy(tpl[2].copy()).cuda()}
    tsig = torch.from_numpy(csig.copy()).cuda()
    errs_t_main, ok_tm = compare_tabled(ed, field, entry.tables, entry.a_ok, entry.pk, tsig, tsrc)
    require(bool(ok_tm.all()), "every main-path row verifies through the tabled kernels")
    adv_tables, adv_ok = ed.build_valset_tables(pk)
    err_build_adv, _ = compare_tables(ed, field, pk, adv_tables, adv_ok)
    errs_t_adv, ok_adv = compare_tabled(ed, field, adv_tables, adv_ok, pk, sig, {"msgs": msg})
    require(ok_adv.tolist() == want, "tabled verdicts on the adversarial batch equal the pure-Python oracle")
    errs_t_main["ed25519_build_tables"] = err_build_main
    errs_t_adv["ed25519_build_tables"] = err_build_adv
    # the tabled prepare at verify_commit_trusting's rows and at its edges
    trsrc = {"idx": torch.from_numpy(np.asarray(b_vals, dtype=np.int32)).cuda(),
             "templates": torch.from_numpy(np.ascontiguousarray(b_tpl[0])).cuda(),
             "tmpl_idx": torch.from_numpy(np.asarray(b_tpl[1], dtype=np.int32)).cuda(),
             "ts8": torch.from_numpy(np.ascontiguousarray(b_tpl[2])).cuda()}
    trsig = torch.from_numpy(np.array(b_sig)).cuda()
    trpk = torch.from_numpy(np.ascontiguousarray(pk_b)).cuda()
    err_trust = prepare_tabled_err(ed, trpk, trsig, trsrc)
    err_edges = prepare_tabled_edges_err(ed, entry.pk, tsig, tsrc)
    errs_t_main["ed25519_prepare_tabled"] = max(errs_t_main["ed25519_prepare_tabled"], err_trust, err_edges)
    print(f"  ed25519_prepare_tabled at verify_commit_trusting's {trsig.shape[0]} rows: {err_trust}; with key and "
          f"template indices out of range: {err_edges}")
    require(all(e == 0 for e in list(errs_t_main.values()) + list(errs_t_adv.values())),
            f"tabled kernels identical to their plain versions: main {errs_t_main}, adversarial {errs_t_adv}")
    print(f"  seams identical to the plain versions: main path ({N_VALS} validators, {n} rows) {errs_t_main}; "
          f"adversarial batch ({N_BATCH} keys and rows) {errs_t_adv}")

    t50, t99, twall50 = time_verify_commit(vs, commit, bid, verifier_t, cold=True)
    tm50, tm99, tmwall50 = time_verify_commit(vs, commit, bid, verifier_t, cold=False)
    parts = {"checks": [], "sign_bytes_parts": [], "packing": [], "provider": [], "replay": []}
    for _ in range(10):
        c = fresh(commit)
        t = time.perf_counter()
        vs._verify_commit_basic(c, HEIGHT, bid)
        t1 = time.perf_counter()
        c.sign_bytes_parts(CHAIN)
        t2 = time.perf_counter()
        idxs, vi, sg, pw, ct, sig_ok, tp = vs._commit_batch_arrays(CHAIN, c)
        t3 = time.perf_counter()
        ok_rows = vs._rows_cached(verifier_t, vi, sg, tp)
        t4 = time.perf_counter()
        ok_rows = ok_rows & sig_ok
        vs._replay_commit_full(c, ok_rows, idxs, pw, ct, int(pw[ok_rows & ct].sum()))
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(1e3 * dt)
    tsplit = {k: float(np.median(v)) for k, v in parts.items()}
    trust_ms = []
    for _ in range(10):
        t = time.perf_counter()
        vs_b.verify_commit_trusting(CHAIN, bid, HEIGHT, commit, Fraction(1, 3), provider=verifier_t)
        trust_ms.append(1e3 * (time.perf_counter() - t))
    print(f"  tabled verify_commit @{N_VALS} validators ({n} rows), 30 warm runs on a fresh commit each, "
          f"CUDA events p50 {t50:.3f} ms p99 {t99:.3f} ms, host clock p50 {twall50:.3f} ms; 30 on the same "
          f"(memoised) commit, p50 {tm50:.3f} ms p99 {tm99:.3f} ms, host clock p50 {tmwall50:.3f} ms ({card})")
    print("  host clock split of a fresh commit's call (medians of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in tsplit.items())
          + f"; unattributed (host p50 minus the parts) {twall50 - sum(tsplit.values()):.3f} ms")
    print(f"  verify_commit_trusting host clock p50 of 10 warm runs {np.median(trust_ms):.3f} ms "
          f"({len(b_rows)} rows)")

    prep_t = ed.verify_stage_prepare_tabled(entry.pk, tsig, **tsrc)
    cpu = torch.device("cpu")
    one_pk = entry.pk[:1].to(cpu)
    one_tables, one_ok = ed.build_valset_tables(one_pk)
    one_prep_t = [x[:1].to(cpu) for x in prep_t]
    tmuls = {
        "ed25519_build_tables": field_muls_per_row(lambda: ed.build_valset_tables(one_pk)),
        "ed25519_prepare_tabled": {"products": 0, "squarings": 0},  # SHA-512 and the scalar reduction only
        "ed25519_scan_tabled": field_muls_per_row(
            lambda: ed.verify_stage_scan_tabled(one_prep_t[0], one_prep_t[1], one_tables, one_ok)),
    }
    v = entry.v
    rows_idx = tsrc["idx"].long()
    # table entries the scan reads: distinct (validator, split, |digit|)
    # with a nonzero digit, and distinct base-comb (position, |digit|)
    kmag = prep_t[1].long().abs().reshape(n, 16, 4)
    ent = (rows_idx[:, None, None] * 16 + torch.arange(16, device=rows_idx.device)[None, :, None]) * 8 + kmag - 1
    key_entries = int(torch.unique(ent[kmag > 0]).numel())
    smag = prep_t[0].long().abs()
    comb_entries = int(torch.unique((torch.arange(32, device=rows_idx.device)[None, :] * 128 + smag - 1)[smag > 0]).numel())
    distinct_vals = int(torch.unique(rows_idx).numel())
    t_bytes = {
        "ed25519_build_tables": v * 32 + v * 15360 + v,
        "ed25519_prepare_tabled": distinct_vals * 32 + n * (64 + 4 + 4 + 8) + tpl[0].size + n * (32 + 64 + 1),
        "ed25519_scan_tabled": (key_entries + comb_entries) * 120 + distinct_vals + n * (32 + 64 + 4)
        + n * (160 + 1),
    }
    t_ops = {
        "ed25519_build_tables": v * field_ops(tmuls["ed25519_build_tables"]),
        "ed25519_prepare_tabled": n * (sha_blocks * OPS_PER_SHA512_BLOCK + 2 * PREPARE_TABLED_SCALAR_INSTR),
        "ed25519_scan_tabled": n * field_ops(tmuls["ed25519_scan_tabled"]),
    }
    t_runs = {
        "ed25519_build_tables": (lambda: ed.build_valset_tables(entry.pk), None),
        "ed25519_prepare_tabled": (lambda: ed.verify_stage_prepare_tabled(entry.pk, tsig, **tsrc),
                                   lambda: ed.prepare_tabled_plain(entry.pk, tsig, **tsrc)),
        "ed25519_scan_tabled": (
            lambda: ed.verify_stage_scan_tabled(prep_t[0], prep_t[1], entry.tables, entry.a_ok, tsrc["idx"]),
            lambda: ed.scan_tabled_plain(prep_t[0], prep_t[1], entry.tables, entry.a_ok, tsrc["idx"])),
    }
    replaces_t = {
        "ed25519_build_tables": "tendermint_tpu/ops/ed25519.py:113",
        "ed25519_prepare_tabled": "tendermint_tpu/ops/ed25519.py:123",
        "ed25519_scan_tabled": "tendermint_tpu/ops/ed25519.py:195",
    }
    for name, (kern, plain) in t_runs.items():
        reps = 3 if name == "ed25519_build_tables" else 20
        plain_ms = plain_build_ms if plain is None else median_ms(plain, reps=1, repeats=3)
        rows = v if name == "ed25519_build_tables" else n
        kernels[name] = kernel_row(name, "ed25519_tabled.cu", launches_t[name],
                                   max(errs_t_main[name], errs_t_adv[name]), median_ms(kern, reps=reps, repeats=3),
                                   plain_ms, t_bytes[name], t_ops[name], rows, sum(tmuls[name].values()))
        kernels[name].update(replaces=replaces_t[name], max_abs_err_adversarial=errs_t_adv[name],
                             max_abs_err_main_path=errs_t_main[name], ms_device_only=device_ms(kern, reps=reps),
                             field_squarings_per_row=tmuls[name]["squarings"], **ptxas_usage(name))
    ptr = kernels["ed25519_prepare_tabled"]
    ms_tr = device_ms(lambda: ed.verify_stage_prepare_tabled(trpk, trsig, **trsrc), reps=20)
    bound_tr, by_tr = bound_at(ptr, trsig.shape[0])
    sass_prep = sass_opcodes("ed25519_prepare_tabled")
    ptr.update(rows_trusting=int(trsig.shape[0]), ms_device_only_trusting=ms_tr, bound_ms_trusting=bound_tr,
               max_abs_err_trusting=err_trust, max_abs_err_out_of_range_rows=err_edges,
               scalar_instructions_per_row=PREPARE_TABLED_SCALAR_INSTR,
               chain_floor_ms=chain_floor_ms(sha_blocks * OPS_PER_SHA512_BLOCK // 2 + PREPARE_TABLED_SCALAR_INSTR),
               sass_local_memory=None if sass_prep is None else {k: sass_prep.get(k, 0) for k in ("LDL", "STL")},
               sass_static_instructions=None if sass_prep is None else sum(sass_prep.values()))
    print(f"  ed25519_prepare_tabled: {ptr['ms_device_only']:.4f} ms on the device alone at {n} rows (bound "
          f"{ptr['bound_ms']:.4f} ms by {ptr['bound_by']}, SHA-512 and {PREPARE_TABLED_SCALAR_INSTR} scalar "
          f"instructions a row), {ms_tr:.4f} ms at {trsig.shape[0]} rows (bound {bound_tr:.4f} by {by_tr}); "
          f"{ptr['registers']} registers, {ptr['stack_frame']} bytes of stack frame, {ptr['spill_stores']} / "
          f"{ptr['spill_loads']} bytes of spill stores / loads, local memory in its SASS {ptr['sass_local_memory']}; "
          f"a row's chain at least {ptr['chain_floor_ms']:.4f} ms at the card's maximum SM clock ({card})")
    for name in ("ed25519_prepare", "ed25519_finish"):
        print(f"  {name}: one thread a row; -Xptxas -v: {kernels[name]['registers']} registers, "
              f"{kernels[name]['spill_stores']} / {kernels[name]['spill_loads']} bytes of spill stores / loads, "
              f"{kernels[name]['stack_frame']} bytes of stack frame")
    for name, g in ed.lanes().items():
        kernels[name]["lanes"] = g
        print(f"  {name}: G = {g} lanes a {'validator' if 'build' in name else 'row'} (compiled in); -Xptxas -v: "
              f"{kernels[name]['registers']} registers, {kernels[name]['spill_stores']} / "
              f"{kernels[name]['spill_loads']} bytes of spill stores / loads, {kernels[name]['stack_frame']} bytes "
              f"of stack frame")
    kernels["ed25519_finish"]["launches_tabled_path"] = launches_t["ed25519_finish"]
    per_call = sum(kernels[k]["ms"] for k in ("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish"))
    print(f"  tabled kernels per call sum {per_call:.4f} ms of the fresh-commit verify_commit p50 {t50:.3f} ms "
          f"(ed25519_finish timed with its tally in phase 4)")

    # -- phases 6 and 7: merkle roots and the light client ---------------------
    kernels.update(phase6(vs, commit, card))
    phase7(vs, by_addr, rng, card, kernels)
    bls_rows8, bls_rows = phase8(card, kernels)
    kernels.update(bls_rows8)
    phase9(vs, vs_b, commit, bid, card, kernels, bls_rows, verifier_t, verifier_g,
           {"generic": (p50, p99), "tabled": (t50, t99)})
    phase10(card, kernels)
    for k in kernels.values():
        muls = "" if k["field_muls_per_row"] is None else f", {k['field_muls_per_row']} field muls/row"
        print(f"  {k['name']}: {k['ms']:.4f} ms ({k['ms_device_only']:.4f} on the device alone; plain "
              f"{k['plain_ms']:.1f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}{muls}, {k['rows']} rows), {k['launches']} launches on its path")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
