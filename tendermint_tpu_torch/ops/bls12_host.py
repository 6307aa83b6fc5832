"""The BLS kernels' arithmetic as host C++ (``csrc/bls12_host.cc`` over
``csrc/fp381.cuh`` and ``csrc/bls12_curve.cuh``), built with ``g++`` and
loaded with ctypes.

Not a path of the port: the kernels run on the card only. This build runs
the same formulas on the CPU, a row's lanes in turn over each stage, so
the tests can hold them against the oracle without a card, and it counts
the Fp products a row runs (a counter only the host build compiles).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "bls12_host.cc"
FP_BYTES = 48
# bls12_g1_aggregate's points a block and lanes a group as
# csrc/bls12_kernels.cu compiles them (kAggChunk, kAggLanes; the card's
# library reports them through ops/bls12.py lanes())
AGG_CHUNK = 64
AGG_LANES = 8


def gxx() -> str:
    """The host C++ compiler, or RuntimeError."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found")
    return path


class HostBLS:
    """The host build in `build_dir`; its constants set from the oracle."""

    def __init__(self, build_dir) -> None:
        from tendermint_tpu_torch.ops import bls12

        out = Path(build_dir) / "libbls12_host.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([gxx(), "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(_CSRC), "-o", str(out), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(out))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bls_host_set_constants.argtypes = [vp, ctypes.c_size_t]
        lib.bls_host_count.restype = ctypes.c_uint64
        lib.bls_host_fp_op.argtypes = [i32, vp, vp, vp]
        lib.bls_host_f12_op.argtypes = [i32, vp, vp, vp, i32]
        lib.bls_host_pairing_row.argtypes = [vp, vp, vp, vp, i32, i32]
        lib.bls_host_map_row.argtypes = [vp, vp, vp, vp, i32]
        lib.bls_host_g1_sum.argtypes = [vp, vp, vp, i32, i32, i32]
        lib.bls_host_g1_add.argtypes = [vp, vp, vp, i32, i32]
        lib.bls_host_g1_add.restype = None
        for fn in (lib.bls_host_set_constants, lib.bls_host_fp_op, lib.bls_host_f12_op, lib.bls_host_pairing_row,
                   lib.bls_host_map_row, lib.bls_host_g1_sum):
            fn.restype = i32
        blob = bls12.constants_blob()
        if lib.bls_host_set_constants(blob, len(blob)) != 0:
            raise RuntimeError("the host build's Constants struct differs from constants_blob()")
        self.lib = lib

    def reset_count(self) -> None:
        self.lib.bls_host_count_reset()

    def count(self) -> int:
        """Fp products since the last reset_count()."""
        return int(self.lib.bls_host_count())

    def fp_op(self, op: int, a: int, b: int = 0) -> int:
        """op 0: Montgomery product, 1: sum, 2: difference, 3: inverse by
        Fermat, 4: inverse by the binary GCD, on raw words."""
        return self.fp_op_steps(op, a, b)[0]

    def fp_op_steps(self, op: int, a: int, b: int = 0):
        """(fp_op's result, the GCD's outer steps for op 4, else 0)."""
        wa = np.array([(a >> (32 * i)) & 0xFFFFFFFF for i in range(12)], dtype=np.uint32)
        wb = np.array([(b >> (32 * i)) & 0xFFFFFFFF for i in range(12)], dtype=np.uint32)
        r = np.zeros(12, dtype=np.uint32)
        steps = self.lib.bls_host_fp_op(op, wa.ctypes.data, wb.ctypes.data, r.ctypes.data)
        return sum(int(w) << (32 * i) for i, w in enumerate(r)), steps

    def f12_op(self, op: int, a: bytes, b: bytes = bytes(576), lanes: int = 8) -> bytes:
        out = ctypes.create_string_buffer(576)
        if self.lib.bls_host_f12_op(op, out, a, b, lanes) != 0:
            raise ValueError(f"no Fp12 op {op}")
        return out.raw

    def pairing_row(self, pk: bytes, hm: bytes, sig, lanes: int = 8):
        """(verdict, the reduced Fp12 value as 576 bytes); sig None: e(pk, hm)."""
        value = ctypes.create_string_buffer(576)
        ok = self.lib.bls_host_pairing_row(value, pk, hm, sig, 1 if sig is None else 2, lanes)
        return bool(ok), value.raw

    def map_row(self, u0: bytes, u1: bytes, lanes: int = 8):
        """(x, y as 96 bytes each, the identity flag)."""
        x, y = ctypes.create_string_buffer(96), ctypes.create_string_buffer(96)
        inf = self.lib.bls_host_map_row(x, y, u0, u1, lanes)
        return x.raw, y.raw, bool(inf)

    def g1_sum(self, points: bytes, mask: bytes, chunk: int = AGG_CHUNK, lanes: int = AGG_LANES):
        """bls12_g1_aggregate's work for one batch row, `chunk` points a
        block and `lanes` a group: (the sum's x, y as 96 bytes, the
        identity flag)."""
        out = ctypes.create_string_buffer(96)
        inf = self.lib.bls_host_g1_sum(out, points, mask, len(mask), chunk, lanes)
        if inf < 0:
            raise ValueError(f"no aggregate on {lanes} lanes")
        return out.raw, bool(inf)

    def g1_add(self, p: bytes, q: bytes, lanes: int) -> bytes:
        """The staged addition on `lanes`: p (X, Y, Z) as 144 bytes, q the
        same or affine (x, y) as 96 bytes (the mixed form) -> 144 bytes."""
        out = ctypes.create_string_buffer(144)
        self.lib.bls_host_g1_add(out, p, q, int(len(q) == 96), lanes)
        return out.raw
