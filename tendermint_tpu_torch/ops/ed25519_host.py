"""The ed25519 kernels' arithmetic as host C++ (``csrc/ed25519_host.cc``
over ``csrc/fe25519.cuh``, ``csrc/ge25519.cuh``,
``csrc/ge25519_lanes.cuh`` and the tabled prepare's
``csrc/prepare_tabled.cuh``, ``sha512.cuh`` and ``sc25519.cuh``), built
with ``g++`` and loaded with ctypes.

Not a path of the port: the kernels run on the card only. This build runs
the same formulas on the CPU, a row's lanes in turn over each stage, so
the tests can hold them against the plain versions and the JAX package
without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from tendermint_tpu_torch.codec.signbytes import TIMESTAMP_OFFSET
from tendermint_tpu_torch.ops.bls12_host import gxx

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "ed25519_host.cc"


class HostEd25519:
    """The host build in `build_dir`; its constants set from the oracle
    (``_build.constants_blob``, the kernels' own)."""

    def __init__(self, build_dir) -> None:
        from tendermint_tpu_torch.ops._build import comb_blob, constants_blob

        out = Path(build_dir) / "libed25519_host.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([gxx(), "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_CSRC), "-o", str(out), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(out))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ed_host_set_constants.argtypes = [vp, ctypes.c_size_t]
        lib.ed_host_fe_op.argtypes = [i32, vp, vp, vp]
        lib.ed_host_point_op.argtypes = [i32, vp, vp, i32, i32, i32]
        lib.ed_host_scan_row.argtypes = [vp, vp, vp, vp, i32]
        lib.ed_host_scan_row.restype = None
        lib.ed_host_build_row.argtypes = [vp, vp, i32]
        lib.ed_host_set_comb.argtypes = [vp, ctypes.c_size_t]
        lib.ed_host_decompress.argtypes = [vp, vp]
        lib.ed_host_invert.argtypes = [vp, vp, i32]
        lib.ed_host_finish_row.argtypes = [vp, vp, i32, i32, vp]
        lib.ed_host_scan_tabled_row.argtypes = [vp, vp, vp, vp, i32]
        lib.ed_host_scan_tabled_row.restype = None
        lib.ed_host_prepare_tabled.argtypes = [vp, vp, i32, vp, i32, vp, i32, vp, vp, i32, vp, i32, vp, vp, vp, vp,
                                               i32]
        lib.ed_host_sc_reduce.argtypes = [vp, vp]
        lib.ed_host_sc_reduce.restype = None
        lib.ed_host_scalar_digits.argtypes = [vp, vp, vp]
        for fn in (lib.ed_host_set_constants, lib.ed_host_fe_op, lib.ed_host_point_op, lib.ed_host_build_row,
                   lib.ed_host_set_comb, lib.ed_host_decompress, lib.ed_host_invert, lib.ed_host_finish_row,
                   lib.ed_host_prepare_tabled, lib.ed_host_scalar_digits):
            fn.restype = i32
        blob = constants_blob()
        if lib.ed_host_set_constants(blob, len(blob)) != 0:
            raise RuntimeError("the host build's TmConstants struct differs from constants_blob()")
        blob = comb_blob()
        if lib.ed_host_set_comb(blob, len(blob)) != 0:
            raise RuntimeError("the base comb's size differs from the host build's")
        self.lib = lib

    def fe_op(self, op: int, a, b=None) -> np.ndarray:
        """op 0: fe_mul(a, b), 1: fe_sq(a), 2: fe_mul(a, a), on 10 int32 limbs."""
        x = np.ascontiguousarray(a, dtype=np.int32)
        y = np.ascontiguousarray(x if b is None else b, dtype=np.int32)
        r = np.zeros(10, dtype=np.int32)
        if self.lib.ed_host_fe_op(op, x.ctypes.data, y.ctypes.data, r.ctypes.data) != 0:
            raise ValueError(f"no field op {op}")
        return r

    def decompress(self, pk: bytes):
        """ed25519_prepare's decompression: (-A (4, 10) int32, a_ok)."""
        out = np.zeros((4, 10), dtype=np.int32)
        ok = self.lib.ed_host_decompress(out.ctypes.data, bytes(pk))
        return out, bool(ok)

    def invert(self, a, gcd: bool = True):
        """(1 / a as 10 canonical int32 limbs, the batches run): by the
        binary GCD (fe_inv_gcd), or with gcd=False by Fermat's power
        (fe_invert, 0 batches)."""
        x = np.ascontiguousarray(a, dtype=np.int32)
        r = np.zeros(10, dtype=np.int32)
        steps = self.lib.ed_host_invert(x.ctypes.data, r.ctypes.data, int(gcd))
        return r, steps

    def finish_row(self, point, r: bytes, a_ok: bool, s_ok: bool):
        """One ed25519_finish row: point (4, 10) int32, R (32 B) -> (ok,
        the point's 32-byte encoding)."""
        pt = np.ascontiguousarray(point, dtype=np.int32)
        enc = np.zeros(32, dtype=np.uint8)
        ok = self.lib.ed_host_finish_row(pt.ctypes.data, bytes(r), int(a_ok), int(s_ok), enc.ctypes.data)
        return bool(ok), enc

    def point_op(self, op: int, p, q=None, digit: int = 1, want_t: bool = True, lanes: int = 4) -> np.ndarray:
        """op 0: the staged doubling of p, 1: the staged cached addition
        p + q (q cached, read through `digit`); (4, 10) int32 each."""
        pt = np.array(p, dtype=np.int32).reshape(4, 10)
        qq = np.ascontiguousarray(np.zeros((4, 10)) if q is None else q, dtype=np.int32)
        if self.lib.ed_host_point_op(op, pt.ctypes.data, qq.ctypes.data, digit, int(want_t), lanes) != 0:
            raise ValueError(f"no point op {op}")
        return pt

    def scan_row(self, sd, kd, neg_a, lanes: int = 4) -> np.ndarray:
        """One ed25519_scan row: sd, kd (64,) int8, neg_a (4, 10) -> (4, 10) int32."""
        s = np.ascontiguousarray(sd, dtype=np.int8)
        k = np.ascontiguousarray(kd, dtype=np.int8)
        a = np.ascontiguousarray(neg_a, dtype=np.int32)
        out = np.zeros((4, 10), dtype=np.int32)
        self.lib.ed_host_scan_row(out.ctypes.data, s.ctypes.data, k.ctypes.data, a.ctypes.data, lanes)
        return out

    def scan_tabled_row(self, sd8, kd, table, lanes: int = 4) -> np.ndarray:
        """One ed25519_scan_tabled row: sd8 (32,), kd (64,) int8, table the
        row's validator's (16, 8, 3, 10) int32, or None for an index out of
        range -> (4, 10) int32."""
        s = np.ascontiguousarray(sd8, dtype=np.int8)
        k = np.ascontiguousarray(kd, dtype=np.int8)
        t = None if table is None else np.ascontiguousarray(table, dtype=np.int32)
        out = np.full((4, 10), -1, dtype=np.int32)
        self.lib.ed_host_scan_tabled_row(out.ctypes.data, s.ctypes.data, k.ctypes.data,
                                         None if t is None else t.ctypes.data, lanes)
        return out

    def build_row(self, pk: bytes, lanes: int = 4):
        """One ed25519_build_tables validator: (tables (16, 8, 3, 10) int32, a_ok)."""
        out = np.zeros((16, 8, 3, 10), dtype=np.int32)
        ok = self.lib.ed_host_build_row(out.ctypes.data, bytes(pk), lanes)
        return out, bool(ok)

    def prepare_tabled(self, pk_all, sig, idx=None, msgs=None, templates=None, tmpl_idx=None, ts8=None,
                       ts_off: int = TIMESTAMP_OFFSET, rows: int = 64):
        """ed25519_prepare_tabled's steps with blocks of `rows` (32, 64 or
        128), on numpy arrays as the wrapper's: (sd8 (N,32) int8, kd (N,64)
        int8, s_ok (N,) bool, the rows' SHA-512 digests (N,64) uint8)."""
        c = lambda a, t: None if a is None else np.ascontiguousarray(a, dtype=t)  # noqa: E731
        pk, sg, ix = c(pk_all, np.uint8), c(sig, np.uint8), c(idx, np.int32)
        ms, tp, ti, ts = c(msgs, np.uint8), c(templates, np.uint8), c(tmpl_idx, np.int32), c(ts8, np.uint8)
        n = sg.shape[0]
        width = (ms if ms is not None else tp).shape[1]
        sd8, kd = np.zeros((n, 32), np.int8), np.zeros((n, 64), np.int8)
        s_ok, digest = np.zeros(n, np.uint8), np.zeros((n, 64), np.uint8)
        p = lambda a: None if a is None else a.ctypes.data  # noqa: E731
        code = self.lib.ed_host_prepare_tabled(
            p(pk), p(ix), pk.shape[0], p(ms), width, p(tp), 0 if tp is None else tp.shape[0], p(ti), p(ts), ts_off,
            p(sg), n, p(sd8), p(kd), p(s_ok), p(digest), rows)
        if code != 0:
            raise ValueError(f"no host prepare with blocks of {rows} rows")
        return sd8, kd, s_ok.astype(bool), digest

    def sc_reduce(self, digest: bytes) -> bytes:
        """sc_reduce_words of a 64-byte digest: its 32-byte value mod L."""
        out = np.zeros(32, dtype=np.uint8)
        self.lib.ed_host_sc_reduce(bytes(digest), out.ctypes.data)
        return out.tobytes()

    def scalar_digits(self, s: bytes):
        """A 32-byte scalar's packed digits, unpacked: (nibbles (64,) int8,
        base-256 (32,) int8, s < L)."""
        nib, b256 = np.zeros(64, dtype=np.int8), np.zeros(32, dtype=np.int8)
        ok = self.lib.ed_host_scalar_digits(bytes(s), nib.ctypes.data, b256.ctypes.data)
        return nib, b256, bool(ok)
