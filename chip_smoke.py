"""Chip smoke test of the PyTorch/CUDA port (tendermint_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit):

1. Print the card's name and power limit (nvidia-smi), build the three
   ed25519 kernels from tendermint_tpu_torch/csrc (nvcc, sm_90a).
2. Hold each kernel against its plain PyTorch version, on the card, on
   one 1,024-row batch of honest and adversarial rows (s + L, flipped R,
   s and message bits, an undecodable key, a non-canonical A.y, small-order
   A and R), exactly at the byte seams; hold the verdicts against the
   pure-Python oracle; and RFC 8032 vector 1 (empty message).
3. The main path: a 10,000-validator ValidatorSet and a signed commit
   (about 90 % for the block, some nil and absent rows) through
   ValidatorSet.verify_commit with TorchBatchVerifier(). The kernels'
   launch counts are set to 0 just before and read just after; each must
   have moved. A bad signature before quorum must raise
   ErrInvalidCommitSignature, 60 % of the power ErrNotEnoughVotingPower.
4. At the main path's shapes (the commit's present rows): each kernel
   against its plain version again, exactly at the byte seams; then
   timing with CUDA events: verify_commit p50/p99 over 30 warm runs, the
   host clock split of the call, each kernel's median and each plain
   version's time.

Before the last line it prints one JSON object with a row per kernel
(launches, max_abs_err, ms, plain_ms, bound_ms, ...), then the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

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

N_BATCH = 1024
N_VALS = 10_000
CHAIN = "smoke-chain"
HEIGHT = 12
SEED = 20261017


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def field_muls_per_row(stage) -> int:
    """Field multiplications (squarings included) a row costs, counted by
    running the plain version on one CPU row; the kernels run the same
    formulas and every row does the same work."""
    from tendermint_tpu_torch.ops import field

    count = [0]
    mul = field.mul

    def counting(f, g):
        count[0] += 1
        return mul(f, g)

    field.mul = counting
    try:
        stage()
    finally:
        field.mul = mul
    return count[0]


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
    torch.cuda.synchronize()
    return {"ed25519_prepare": err_prep, "ed25519_scan": err_scan, "ed25519_finish": err_fin}, ok


def build_commit(rng):
    """A 10,000-validator set (seeded keys and powers) and a commit signed
    by it: ~90 % of the rows for the block, ~5 % nil, ~5 % absent."""
    from tendermint_tpu_torch import Commit, CommitSig, Ed25519PrivKey, Validator, ValidatorSet
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_ABSENT,
        BLOCK_ID_FLAG_COMMIT,
        BLOCK_ID_FLAG_NIL,
        BlockID,
        PartSetHeader,
    )
    from tendermint_tpu_torch.types.validator_set import MAX_TOTAL_VOTING_POWER

    privs = [Ed25519PrivKey(rng.bytes(32)) for _ in range(N_VALS)]
    powers = rng.integers(1, 1 << 40, N_VALS)
    require(int(powers.sum()) <= MAX_TOTAL_VOTING_POWER, "total power within MAX_TOTAL_VOTING_POWER")
    vs = ValidatorSet([Validator(p.pub_key(), int(w)) for p, w in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(rng.bytes(32), PartSetHeader(4, rng.bytes(32)))
    draw = rng.random(N_VALS)
    flags = np.where(draw < 0.90, BLOCK_ID_FLAG_COMMIT, np.where(draw < 0.95, BLOCK_ID_FLAG_NIL, BLOCK_ID_FLAG_ABSENT))
    sigs = []
    for i, val in enumerate(vs.validators):
        if flags[i] == BLOCK_ID_FLAG_ABSENT:
            sigs.append(CommitSig.absent())
        else:
            sigs.append(CommitSig(int(flags[i]), val.address, 1_760_000_000_000_000_000 + i, b""))
    commit = Commit(HEIGHT, 0, bid, sigs)
    for i, cs in enumerate(sigs):
        if not cs.absent_():
            cs.signature = by_addr[cs.validator_address].sign(commit.vote_sign_bytes(CHAIN, i))
    return vs, commit, bid


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from tendermint_tpu_torch import Commit, ErrInvalidCommitSignature, ErrNotEnoughVotingPower, TorchBatchVerifier
    from tendermint_tpu_torch.ops import _build, field
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import ref_ed25519 as ref
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_ABSENT, CommitSig

    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"phase 1: built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            print("  " + line.strip())

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
    print(f"phase 2: {N_BATCH} rows ({sum(want)} valid), seams identical, verdicts = oracle; "
          f"RFC 8032 vector 1 ok ({time.perf_counter() - t0:.1f} s)")

    # -- phase 3: the main path ----------------------------------------------
    t0 = time.perf_counter()
    vs, commit, bid = build_commit(rng)
    print(f"phase 3: {N_VALS}-validator set and commit signed in {time.perf_counter() - t0:.1f} s")
    verifier = TorchBatchVerifier()
    ed.reset_launches()
    vs.verify_commit(CHAIN, bid, HEIGHT, commit, provider=verifier)
    torch.cuda.synchronize()
    launches = ed.launches()
    require(all(n > 0 for n in launches.values()), f"every kernel launched on the main path: {launches}")
    rows_present = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    _idxs, cpk, cmsg, csig, cpow, ccnt, _sig_ok = vs._commit_batch_arrays(CHAIN, commit)
    ok_all, tally = verifier.verify_commit_batch(cpk, cmsg, csig, cpow, ccnt)
    require(bool(ok_all.all()), "every present row of the honest commit verifies")
    require(tally == int(cpow[ccnt].sum()), "device tally equals the host sum of counted power")
    print(f"  verify_commit passed: {len(rows_present)} rows, launches {launches}, tally {tally}")

    cs = commit.signatures[rows_present[5]]
    bad_commit = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    bad_commit.signatures[rows_present[5]] = dataclasses.replace(
        cs, signature=bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad_commit, provider=verifier)
    except ErrInvalidCommitSignature as e:
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
        vs.verify_commit(CHAIN, bid, HEIGHT, low, provider=verifier)
    except ErrNotEnoughVotingPower as e:
        print(f"  {100 * talled / total:.1f} % of the power: ErrNotEnoughVotingPower ({e})")
    else:
        raise RuntimeError("a commit with 60 % of the power was accepted")

    # -- phase 4: timing -----------------------------------------------------
    walls, events = [], []
    for _ in range(30):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        vs.verify_commit(CHAIN, bid, HEIGHT, commit, provider=verifier)
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        events.append(start.elapsed_time(end))
    p50, p99 = np.percentile(events, 50), np.percentile(events, 99)
    # host clock split: each part of verify_commit timed alone, in the
    # order the call runs them
    parts = {"checks": [], "packing": [], "provider": [], "replay": []}
    for _ in range(10):
        t = time.perf_counter()
        vs._verify_commit_basic(commit, HEIGHT, bid)
        t1 = time.perf_counter()
        idxs, *arrays, sig_ok = vs._commit_batch_arrays(CHAIN, commit)
        t2 = time.perf_counter()
        ok_rows, talled = verifier.verify_commit_batch(*arrays[:4], arrays[4] & sig_ok)
        t3 = time.perf_counter()
        vs._replay_commit_full(commit, np.asarray(ok_rows, dtype=bool) & sig_ok, idxs, arrays[3], arrays[4], talled)
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(1e3 * dt)
    split = {key: float(np.median(v)) for key, v in parts.items()}
    wall50 = float(np.percentile(walls, 50))
    print(f"phase 4: verify_commit @{N_VALS} validators ({len(rows_present)} rows), 30 warm runs, "
          f"CUDA events p50 {p50:.3f} ms p99 {p99:.3f} ms; host clock p50 {wall50:.3f} ms ({card})")
    print("  host clock split (medians of 10): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
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
    replaces = {
        "ed25519_prepare": "tendermint_tpu/ops/ed25519.py:56",
        "ed25519_scan": "tendermint_tpu/ops/ed25519.py:79",
        "ed25519_finish": "tendermint_tpu/ops/ed25519.py:85",
    }
    kernels = []
    for name, (kern, plain) in runs.items():
        ms = median_ms(kern, reps=20, repeats=5)
        plain_ms = median_ms(plain, reps=1, repeats=3)
        bytes_s = io_bytes[name] / HBM_BYTES_PER_S
        ops_s = n * muls[name] * OPS_PER_FIELD_MUL / INT32_MAD_OPS_PER_S
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tendermint_tpu_torch/csrc/ed25519_kernels.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(errs[name], errs_main[name]),
            "max_abs_err_adversarial": errs[name],
            "max_abs_err_main_path": errs_main[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s > ops_s else "operations",
            "library_ms": None,
            "rows": n,
            "field_muls_per_row": muls[name],
        })
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.1f} ms, bound {1e3 * max(bytes_s, ops_s):.4f} ms, "
              f"{muls[name]} field muls/row, {n} rows)")
    print(f"  kernels sum {sum(k['ms'] for k in kernels):.4f} ms of verify_commit p50 {p50:.3f} ms")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
