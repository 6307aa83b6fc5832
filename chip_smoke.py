"""Chip smoke test of the PyTorch/CUDA port (tendermint_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit):

1. Print the card's name and power limit (nvidia-smi), build the six
   ed25519 kernels from tendermint_tpu_torch/csrc (nvcc, sm_90a).
2. Hold each kernel against its plain PyTorch version, on the card, on
   one 1,024-row batch of honest and adversarial rows (s + L, flipped R,
   s and message bits, an undecodable key, a non-canonical A.y, small-order
   A and R), exactly at the byte seams; hold the verdicts against the
   pure-Python oracle; and RFC 8032 vector 1 (empty message).
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
   time and peak device memory printed); counts set to 0 just before
   and read just after, the tabled kernels and ed25519_finish must have
   moved. The same negative cases, during which the generic prepare and
   scan must not launch. verify_commit_trusting of the commit against a
   second set that shares half the validators, and its duplicate-signer
   case. Each tabled kernel against its plain version, exactly at the
   byte seams, at the main path's shapes (all 10,000 validators' tables,
   the 9,510 present rows read through their validator index, templated
   sign-bytes) and on the 1,024-row adversarial batch with its keys as
   the set (row r is validator r, a message matrix). Timing as in 4.

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
# SHA-512 on 32-bit lanes: one compression is 80 rounds of about 23
# 64-bit operations (three rotates and two XORs in each sigma, choice,
# majority, five additions) and 64 schedule words of about 13, each
# 64-bit operation two 32-bit instructions, which the same table gives
# at the multiply-add's rate (64 a clock per SM): counted as 2
# operations each, like a multiply-add.
OPS_PER_SHA512_BLOCK = 2 * 2 * (80 * 23 + 64 * 13)

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


def compare_tabled(ed, field, tables, a_ok, pk_all, sig, src):
    """ed25519_prepare_tabled and ed25519_scan_tabled against their plain
    versions on the same inputs (`src`: idx, and msgs or templates,
    tmpl_idx, ts8); returns ({kernel: largest seam difference}, ok)."""
    fb = lambda limbs: field.to_bytes(limbs.to(torch.int64))  # noqa: E731
    prep = ed.verify_stage_prepare_tabled(pk_all, sig, **src)
    plain = ed.prepare_tabled_plain(pk_all, sig, **src)
    err_prep = max(seam_err(a, b) for a, b in zip(prep, plain))
    idx = src.get("idx")
    point, row_ok = ed.verify_stage_scan_tabled(prep[0], prep[1], tables, a_ok, idx)
    ppoint, prow_ok = ed.scan_tabled_plain(prep[0], prep[1], tables, a_ok, idx)
    err_scan = max(seam_err(fb(point), fb(ppoint)), seam_err(row_ok, prow_ok))
    ok = ed.verify_stage_finish(point, sig, row_ok, prep[2])
    torch.cuda.synchronize()
    return {"ed25519_prepare_tabled": err_prep, "ed25519_scan_tabled": err_scan}, ok


def negative_cases(vs, commit, bid, provider) -> None:
    """A bad signature before quorum and a commit with 60 % of the power
    must both be refused."""
    from tendermint_tpu_torch import Commit, ErrInvalidCommitSignature, ErrNotEnoughVotingPower
    from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_ABSENT, CommitSig

    rows_present = [i for i, cs in enumerate(commit.signatures) if not cs.absent_()]
    cs = commit.signatures[rows_present[5]]
    bad_commit = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    bad_commit.signatures[rows_present[5]] = dataclasses.replace(
        cs, signature=bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    try:
        vs.verify_commit(CHAIN, bid, HEIGHT, bad_commit, provider=provider)
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
        vs.verify_commit(CHAIN, bid, HEIGHT, low, provider=provider)
    except ErrNotEnoughVotingPower as e:
        print(f"  {100 * talled / total:.1f} % of the power: ErrNotEnoughVotingPower ({e})")
    else:
        raise RuntimeError("a commit with 60 % of the power was accepted")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from tendermint_tpu_torch import Commit, ErrInvalidCommit, TorchBatchVerifier
    from tendermint_tpu_torch.codec.signbytes import splice_timestamps
    from tendermint_tpu_torch.ops import _build, curve, field
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import ref_ed25519 as ref

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
    print(f"phase 2: {N_BATCH} rows ({sum(want)} valid), seams identical, verdicts = oracle; "
          f"RFC 8032 vector 1 ok ({time.perf_counter() - t0:.1f} s)")

    # -- phase 3: the generic path -------------------------------------------
    t0 = time.perf_counter()
    vs, commit, bid = build_commit(rng)
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
    ops = {name: n * muls[name] * OPS_PER_FIELD_MUL for name in muls}
    ops["ed25519_prepare"] += n * sha_blocks * OPS_PER_SHA512_BLOCK
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
                                   io_bytes[name], ops[name], n, muls[name])
        kernels[name].update(max_abs_err_adversarial=errs[name], max_abs_err_main_path=errs_main[name])
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
    print(f"phase 5: tabled verify_commit passed; first call {first_ms:.1f} ms, of which the table build "
          f"{1e3 * entry.build_s:.1f} ms ({N_VALS} validators, {entry.tables.numel() * 4 / 1e6:.1f} MB of tables); "
          f"peak device memory {peak / 1e6:.1f} MB ({(peak - mem0) / 1e6:.1f} MB above the {mem0 / 1e6:.1f} MB "
          f"held before); launches {launches_t}")
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
        "ed25519_prepare_tabled": 0,  # SHA-512 and the scalar reduction only
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
        "ed25519_build_tables": v * tmuls["ed25519_build_tables"] * OPS_PER_FIELD_MUL,
        "ed25519_prepare_tabled": n * sha_blocks * OPS_PER_SHA512_BLOCK,
        "ed25519_scan_tabled": n * tmuls["ed25519_scan_tabled"] * OPS_PER_FIELD_MUL,
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
                                   plain_ms, t_bytes[name], t_ops[name], rows, tmuls[name])
        kernels[name].update(replaces=replaces_t[name], max_abs_err_adversarial=errs_t_adv[name],
                             max_abs_err_main_path=errs_t_main[name])
    kernels["ed25519_finish"]["launches_tabled_path"] = launches_t["ed25519_finish"]
    for k in kernels.values():
        print(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.1f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, {k['field_muls_per_row']} field muls/row, {k['rows']} rows)")
    per_call = sum(kernels[k]["ms"] for k in ("ed25519_prepare_tabled", "ed25519_scan_tabled", "ed25519_finish"))
    print(f"  tabled kernels per call sum {per_call:.4f} ms of the fresh-commit verify_commit p50 {t50:.3f} ms "
          f"(ed25519_finish timed with its tally in phase 4)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
