"""Batched ed25519 verification in stages, each a hand-written CUDA
kernel on the card and a plain PyTorch version on the CPU.

Counterpart of the JAX package's ``ops/ed25519.py`` generic path:

    ok[i] = s_i < L
          & decompress(A_i) succeeds
          & encode([s_i]B + [k_i](-A_i)) == R_i    (byte equality)
    with k_i = SHA512(R_i || A_i || M_i) mod L

which is Go x/crypto's cofactorless acceptance (R is never
decompressed, a non-canonical A.y is taken mod p, s >= L is rejected).

Each wrapper checks device, dtype, shape and contiguity, then runs the
plain version for a tensor on the CPU and launches its kernel for a
tensor on the card (or raises: there is no fallback from one to the
other). ``<wrapper>.launches`` counts kernel launches and nothing else.

Seam layouts (the kernels' and the plain versions' are the same):
  sd, kd  (N, 64) int8 signed window digits in [-8, 8), low first
  neg_a   (N, 4, 10) int32 extended coordinates of -A (field limbs)
  point   (N, 4, 10) int32 [s]B + [k](-A), T zeroed
  a_ok, s_ok, ok (N,) bool; tally a 0-d int64 tensor
The limbs of two versions may differ for the same value; they are
compared at byte seams (``field.to_bytes``).

The per-valset tabled path (the JAX package's live commit path) hoists
what depends only on the keys out of the per-commit work: once per
validator set, ``build_valset_tables`` decompresses every key and
tabulates -A's multiples; per commit, ``verify_stage_prepare_tabled``
hashes and recodes, ``verify_stage_scan_tabled`` runs 16 doublings and
96 mixed additions from the tables and the base comb, and
``verify_stage_finish`` ends as on the generic path (the JAX package's
``verify_stage_finish_blocked`` computes the same function; its blocked
inversion was a workaround for XLA's compile time). Its seams:
  tables  (V, 16, 8, 3, 10) int32 affine-cached [i 16^(4m)](-A)
  sd8     (N, 32) int8 signed base-256 digits of s
  kd      (N, 64) int8 signed nibbles of k, as above
  idx     (N,) int32 validator of each row, or None for row r = validator r
Rows read their key and table through ``idx``; no gathered copy of a
table is made, so the JAX package's dense, gathered and sharded scans
(which keep XLA's gathers bounded) are one kernel here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tendermint_tpu_torch.codec.signbytes import TIMESTAMP_OFFSET
from tendermint_tpu_torch.ops import curve, sc
from tendermint_tpu_torch.ops.sha512 import sha512


def _check(t: torch.Tensor, name: str, shape: Sequence[Optional[int]], dtype: torch.dtype,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _route(device: torch.device) -> bool:
    """True for the kernel, False for the plain version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _lib(device: torch.device):
    from tendermint_tpu_torch.ops import _build

    return _build.library(device.index if device.index is not None else torch.cuda.current_device())


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lanes(device=None) -> dict:
    """The lanes G that work one row of ed25519_scan, one validator of
    ed25519_build_tables and one row of ed25519_scan_tabled, as compiled
    into the library (loads it on `device`, default cuda)."""
    import ctypes

    lib = _lib(torch.device("cuda" if device is None else device))
    scan, build, tabled = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.tm_ed25519_lanes(ctypes.byref(scan), ctypes.byref(build), ctypes.byref(tabled))
    return {"ed25519_scan": scan.value, "ed25519_build_tables": build.value, "ed25519_scan_tabled": tabled.value}


# -- stage 1 ------------------------------------------------------------------


def prepare_plain(pubkeys, msgs, sigs):
    s_bytes = sigs[:, 32:]
    s_ok = sc.is_canonical(s_bytes)
    a_point, a_ok = curve.decompress(pubkeys)
    neg_a = curve.negate(a_point)
    k_bytes = sc.reduce512(sha512(torch.cat([sigs[:, :32], pubkeys, msgs], dim=1)))
    sd = curve.signed_digits(curve.nibble_digits(s_bytes)).to(torch.int8)
    kd = curve.signed_digits(curve.nibble_digits(k_bytes)).to(torch.int8)
    return sd, kd, torch.stack(list(neg_a), dim=1).to(torch.int32), a_ok, s_ok


def verify_stage_prepare(pubkeys: torch.Tensor, msgs: torch.Tensor, sigs: torch.Tensor):
    """pubkeys (N,32) u8, msgs (N,M) u8, sigs (N,64) u8 ->
    (sd, kd, neg_a, a_ok, s_ok): the challenge hash k reduced mod L, the
    signed digits of s and k, -A by decompression, and the two checks."""
    dev = pubkeys.device
    n = pubkeys.shape[0]
    _check(pubkeys, "pubkeys", (n, 32), torch.uint8, dev)
    _check(msgs, "msgs", (n, None), torch.uint8, dev)
    _check(sigs, "sigs", (n, 64), torch.uint8, dev)
    if not _route(dev):
        return prepare_plain(pubkeys, msgs, sigs)
    sd = torch.empty((n, 64), dtype=torch.int8, device=dev)
    kd = torch.empty((n, 64), dtype=torch.int8, device=dev)
    neg_a = torch.empty((n, 4, 10), dtype=torch.int32, device=dev)
    a_ok = torch.empty(n, dtype=torch.bool, device=dev)
    s_ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_ed25519_prepare(
            pubkeys.data_ptr(), msgs.data_ptr(), sigs.data_ptr(), n, msgs.shape[1],
            sd.data_ptr(), kd.data_ptr(), neg_a.data_ptr(), a_ok.data_ptr(), s_ok.data_ptr(),
            _stream(dev)), "ed25519_prepare launch")
        verify_stage_prepare.launches += 1
    return sd, kd, neg_a, a_ok, s_ok


# -- stage 2 ------------------------------------------------------------------


def scan_plain(sd, kd, neg_a):
    q = curve.Point(*(neg_a[:, i].to(torch.int64) for i in range(4)))
    p = curve.double_scalar_mul_signed(sd.to(torch.int64), kd.to(torch.int64), q)
    return torch.stack(list(p), dim=1).to(torch.int32)


def verify_stage_scan(sd: torch.Tensor, kd: torch.Tensor, neg_a: torch.Tensor) -> torch.Tensor:
    """[s]B + [k](-A) by Straus (the dominant cost): (N, 4, 10) int32."""
    dev = sd.device
    n = sd.shape[0]
    _check(sd, "sd", (n, 64), torch.int8, dev)
    _check(kd, "kd", (n, 64), torch.int8, dev)
    _check(neg_a, "neg_a", (n, 4, 10), torch.int32, dev)
    if not _route(dev):
        return scan_plain(sd, kd, neg_a)
    out = torch.empty((n, 4, 10), dtype=torch.int32, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_ed25519_scan(
            sd.data_ptr(), kd.data_ptr(), neg_a.data_ptr(), n, out.data_ptr(), _stream(dev)),
            "ed25519_scan launch")
        verify_stage_scan.launches += 1
    return out


# -- stage 3 ------------------------------------------------------------------


def finish_plain(point, sigs, a_ok, s_ok, powers=None, counted=None):
    p = curve.Point(*(point[:, i].to(torch.int64) for i in range(4)))
    enc = curve.encode(p)
    ok = (enc == sigs[:, :32]).all(dim=-1) & a_ok & s_ok
    if powers is None:
        return ok
    return ok, torch.where(ok & counted, powers, torch.zeros_like(powers)).sum()


def verify_stage_finish(point: torch.Tensor, sigs: torch.Tensor, a_ok: torch.Tensor,
                        s_ok: torch.Tensor, *, tally: bool = False,
                        powers: Optional[torch.Tensor] = None,
                        counted: Optional[torch.Tensor] = None):
    """Encode the point (one inversion a row), compare with R, AND with
    a_ok and s_ok -> ok (N,) bool. With ``tally=True`` also the int64 sum
    of ``powers`` (N,) int64 where ``ok & counted`` ((N,) bool), as a 0-d
    tensor: returns (ok, tally)."""
    dev = point.device
    n = point.shape[0]
    _check(point, "point", (n, 4, 10), torch.int32, dev)
    _check(sigs, "sigs", (n, 64), torch.uint8, dev)
    _check(a_ok, "a_ok", (n,), torch.bool, dev)
    _check(s_ok, "s_ok", (n,), torch.bool, dev)
    if tally:
        _check(powers, "powers", (n,), torch.int64, dev)
        _check(counted, "counted", (n,), torch.bool, dev)
    elif powers is not None or counted is not None:
        raise ValueError("powers and counted are read only with tally=True")
    if not _route(dev):
        return finish_plain(point, sigs, a_ok, s_ok, powers, counted)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_ed25519_finish(
            point.data_ptr(), sigs.data_ptr(), a_ok.data_ptr(), s_ok.data_ptr(),
            powers.data_ptr() if tally else None, counted.data_ptr() if tally else None,
            n, ok.data_ptr(), total.data_ptr() if tally else None, _stream(dev)),
            "ed25519_finish launch")
        verify_stage_finish.launches += 1
    return (ok, total) if tally else ok


# -- the tabled path: table build ---------------------------------------------


def build_tables_plain(pubkeys):
    a_point, a_ok = curve.decompress(pubkeys)
    return curve.build_split_tables(curve.negate(a_point)).to(torch.int32), a_ok


def build_valset_tables(pubkeys: torch.Tensor):
    """pubkeys (V,32) u8 -> (tables (V,16,8,3,10) int32, a_ok (V,) bool):
    once per validator set, decompress every key (Go's acceptance) and
    tabulate -A's affine-cached multiples [i 16^(4m)](-A)."""
    dev = pubkeys.device
    v = pubkeys.shape[0]
    _check(pubkeys, "pubkeys", (v, 32), torch.uint8, dev)
    if not _route(dev):
        return build_tables_plain(pubkeys)
    tables = torch.empty((v, curve.SPLITS, curve.TBL, 3, 10), dtype=torch.int32, device=dev)
    a_ok = torch.empty(v, dtype=torch.bool, device=dev)
    if v:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_ed25519_build_tables(
            pubkeys.data_ptr(), v, tables.data_ptr(), a_ok.data_ptr(), _stream(dev)),
            "ed25519_build_tables launch")
        build_valset_tables.launches += 1
    return tables, a_ok


# -- the tabled path: stage 1 ---------------------------------------------------


def materialize_sign_bytes(templates, tmpl_idx, ts8):
    """templates (T,W) u8, tmpl_idx (N,) int, ts8 (N,8) u8 -> (N,W) u8:
    row r is templates[tmpl_idx[r]] with ts8[r] at the timestamp offset
    (plain only: the prepare kernel splices the timestamp into the
    template's words)."""
    rows = templates[tmpl_idx.long()].clone()
    rows[:, TIMESTAMP_OFFSET:TIMESTAMP_OFFSET + 8] = ts8
    return rows


def prepare_tabled_plain(pk_all, sigs, idx=None, msgs=None, templates=None, tmpl_idx=None, ts8=None):
    pubkeys = pk_all[: sigs.shape[0]] if idx is None else pk_all[idx.long()]
    if msgs is None:
        msgs = materialize_sign_bytes(templates, tmpl_idx, ts8)
    s_bytes = sigs[:, 32:]
    k_bytes = sc.reduce512(sha512(torch.cat([sigs[:, :32], pubkeys, msgs], dim=1)))
    sd8 = curve.signed_digits_base256(s_bytes).to(torch.int8)
    kd = curve.signed_digits(curve.nibble_digits(k_bytes)).to(torch.int8)
    return sd8, kd, sc.is_canonical(s_bytes)


def verify_stage_prepare_tabled(pk_all: torch.Tensor, sigs: torch.Tensor, *,
                                idx: Optional[torch.Tensor] = None,
                                msgs: Optional[torch.Tensor] = None,
                                templates: Optional[torch.Tensor] = None,
                                tmpl_idx: Optional[torch.Tensor] = None,
                                ts8: Optional[torch.Tensor] = None):
    """Tabled stage 1: k = SHA512(R || A || M) mod L with A = pk_all[idx]
    (V,32) u8, s < L, and the digits -> (sd8 (N,32) int8, kd (N,64) int8,
    s_ok (N,) bool). No decompression: the tables hold -A.

    The messages are ``msgs`` (N,M) u8, or ``templates`` (T,M) u8 with
    ``tmpl_idx`` (N,) int32 and ``ts8`` (N,8) u8 (M >= the timestamp
    offset + 8). ``idx`` (N,) int32, or None when row r is validator r.
    Indices must be in range (the caller checks them on the host; a
    kernel row with one out of range reads nothing and is rejected). On
    the card pk_all and sigs must start 16-byte aligned and ts8 8-byte
    aligned (the kernel reads them in 16- and 8-byte words)."""
    dev = sigs.device
    n = sigs.shape[0]
    v = pk_all.shape[0]
    _check(pk_all, "pk_all", (v, 32), torch.uint8, dev)
    _check(sigs, "sigs", (n, 64), torch.uint8, dev)
    if idx is not None:
        _check(idx, "idx", (n,), torch.int32, dev)
    elif n > v:
        raise ValueError(f"idx None needs a row per validator at most: {n} rows, {v} validators")
    if (msgs is None) == (templates is None):
        raise ValueError("give msgs or templates (with tmpl_idx and ts8), not both")
    if msgs is not None:
        if tmpl_idx is not None or ts8 is not None:
            raise ValueError("tmpl_idx and ts8 go with templates")
        _check(msgs, "msgs", (n, None), torch.uint8, dev)
        width = msgs.shape[1]
    else:
        _check(templates, "templates", (None, None), torch.uint8, dev)
        _check(tmpl_idx, "tmpl_idx", (n,), torch.int32, dev)
        _check(ts8, "ts8", (n, 8), torch.uint8, dev)
        width = templates.shape[1]
        if width < TIMESTAMP_OFFSET + 8:
            raise ValueError(f"templates {width} bytes wide: no room for the timestamp at {TIMESTAMP_OFFSET}")
    if not _route(dev):
        return prepare_tabled_plain(pk_all, sigs, idx, msgs, templates, tmpl_idx, ts8)
    for t, name, align in ((pk_all, "pk_all", 16), (sigs, "sigs", 16), (ts8, "ts8", 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel reads {align}-byte words; the tensor must start {align}-byte aligned")
    sd8 = torch.empty((n, 32), dtype=torch.int8, device=dev)
    kd = torch.empty((n, 64), dtype=torch.int8, device=dev)
    s_ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        check(lib, lib.tm_ed25519_prepare_tabled(
            pk_all.data_ptr(), ptr(idx), v, ptr(msgs), width, ptr(templates),
            0 if templates is None else templates.shape[0], ptr(tmpl_idx), ptr(ts8), TIMESTAMP_OFFSET,
            sigs.data_ptr(), n, sd8.data_ptr(), kd.data_ptr(), s_ok.data_ptr(), _stream(dev)),
            "ed25519_prepare_tabled launch")
        verify_stage_prepare_tabled.launches += 1
    return sd8, kd, s_ok


# -- the tabled path: stage 2 ---------------------------------------------------


def scan_tabled_plain(sd8, kd, tables, a_ok, idx=None):
    n = kd.shape[0]
    rows = tables[:n] if idx is None else tables[idx.long()]
    p = curve.double_scalar_mul_tabled(sd8.to(torch.int64), kd.to(torch.int64), rows.to(torch.int64))
    return torch.stack(list(p), dim=1).to(torch.int32), a_ok[:n] if idx is None else a_ok[idx.long()]


def verify_stage_scan_tabled(sd8: torch.Tensor, kd: torch.Tensor, tables: torch.Tensor,
                             a_ok: torch.Tensor, idx: Optional[torch.Tensor] = None):
    """Tabled stage 2: [s]B + [k](-A) from row r's table tables[idx[r]]
    and the base comb -> (point (N,4,10) int32 with T zero, a_ok[idx]
    (N,) bool). ``idx`` None means row r is validator r."""
    dev = kd.device
    n = kd.shape[0]
    v = tables.shape[0]
    _check(sd8, "sd8", (n, 32), torch.int8, dev)
    _check(kd, "kd", (n, 64), torch.int8, dev)
    _check(tables, "tables", (v, curve.SPLITS, curve.TBL, 3, 10), torch.int32, dev)
    _check(a_ok, "a_ok", (v,), torch.bool, dev)
    if idx is not None:
        _check(idx, "idx", (n,), torch.int32, dev)
    elif n > v:
        raise ValueError(f"idx None needs a row per validator at most: {n} rows, {v} validators")
    if not _route(dev):
        return scan_tabled_plain(sd8, kd, tables, a_ok, idx)
    out = torch.empty((n, 4, 10), dtype=torch.int32, device=dev)
    row_ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from tendermint_tpu_torch.ops._build import check

        lib = _lib(dev)
        check(lib, lib.tm_ed25519_scan_tabled(
            sd8.data_ptr(), kd.data_ptr(), tables.data_ptr(), a_ok.data_ptr(),
            None if idx is None else idx.data_ptr(), v, n, out.data_ptr(), row_ok.data_ptr(), _stream(dev)),
            "ed25519_scan_tabled launch")
        verify_stage_scan_tabled.launches += 1
    return out, row_ok


KERNELS = {
    "ed25519_prepare": verify_stage_prepare,
    "ed25519_scan": verify_stage_scan,
    "ed25519_finish": verify_stage_finish,
    "ed25519_build_tables": build_valset_tables,
    "ed25519_prepare_tabled": verify_stage_prepare_tabled,
    "ed25519_scan_tabled": verify_stage_scan_tabled,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def verify(pubkeys, msgs, sigs) -> torch.Tensor:
    """The three stages chained: (N,) bool."""
    sd, kd, neg_a, a_ok, s_ok = verify_stage_prepare(pubkeys, msgs, sigs)
    return verify_stage_finish(verify_stage_scan(sd, kd, neg_a), sigs, a_ok, s_ok)


def verify_and_tally(pubkeys, msgs, sigs, powers, counted) -> Tuple[torch.Tensor, torch.Tensor]:
    sd, kd, neg_a, a_ok, s_ok = verify_stage_prepare(pubkeys, msgs, sigs)
    point = verify_stage_scan(sd, kd, neg_a)
    return verify_stage_finish(point, sigs, a_ok, s_ok, tally=True, powers=powers, counted=counted)


def verify_tabled(tables, a_ok, pk_all, sigs, **source) -> torch.Tensor:
    """The tabled stages chained over a valset's tables: (N,) bool.
    ``source`` is prepare's keywords (idx, and msgs or templates,
    tmpl_idx and ts8); the scan reads the same idx."""
    sd8, kd, s_ok = verify_stage_prepare_tabled(pk_all, sigs, **source)
    point, row_ok = verify_stage_scan_tabled(sd8, kd, tables, a_ok, source.get("idx"))
    return verify_stage_finish(point, sigs, row_ok, s_ok)
