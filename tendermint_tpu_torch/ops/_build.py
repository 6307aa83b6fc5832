"""Build and load the hand-written CUDA kernels (``csrc/``): ed25519,
SHA-256 and BLS12-381.

The kernels are compiled at first use on the machine with the card, with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the repo root
(git-ignored), as one shared library with a plain C interface that
ctypes loads. Nothing includes PyTorch's headers, so a build takes
seconds rather than minutes. Each ``.cu`` is compiled by its own ``nvcc``
process, all started together, then linked; the library's name carries a
digest of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

After loading, the curve constants and the [1..8]B table (from the
pure-Python oracle) are copied into the kernels' ``__constant__``
memory, and the tabled scan's 8-bit base comb (491,520 B, too large for
``__constant__``) into a ``__device__`` array, once per device, with the
BLS12-381 field and curve constants (``ops/bls12.py`` constants_blob,
from the pure-Python oracle). The round constants of SHA-512 and SHA-256
are compiled in (``sha512.cuh``, ``sha256.cuh``), immediates of the
unrolled rounds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("ed25519_kernels.cu", "ed25519_tabled.cu", "sha256_kernels.cu", "bls12_kernels.cu", "bindings.cu")
HEADERS = ("fe25519.cuh", "divsteps.cuh", "ge25519.cuh", "ge25519_lanes.cuh", "lanes.cuh", "sc25519.cuh", "sha512.cuh",
           "prepare_tabled.cuh", "sha256.cuh", "fp381.cuh", "bls12_curve.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_lib = None
_const_devices: set = set()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this digest has not been built; return the
    library's path. Raises with nvcc's output when a compile fails."""
    out = BUILD_DIR / f"libtm_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{src}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = []
    for src, _obj, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
    link = [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp)]
    link += [str(obj) for _src, obj, _p in procs]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for _src, obj, _p in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout.decode(errors='replace')}")
    (BUILD_DIR / f"{out.name}.ptxas.log").write_text("\n".join(logs))
    os.replace(tmp, out)
    return out


def ptxas_log() -> str:
    """What ``-Xptxas -v`` said (registers, spills) for the current build."""
    p = BUILD_DIR / f"libtm_kernels_{_digest()}.so.ptxas.log"
    return p.read_text() if p.exists() else ""


def _declare(lib) -> None:
    vp, i32, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.tm_set_constants.argtypes = [i32, vp, sz]
    lib.tm_error_string.argtypes = [i32]
    lib.tm_error_string.restype = ctypes.c_char_p
    lib.tm_ed25519_prepare.argtypes = [vp, vp, vp, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.tm_ed25519_scan.argtypes = [vp, vp, vp, i32, vp, vp]
    lib.tm_ed25519_finish.argtypes = [vp, vp, vp, vp, vp, vp, i32, vp, vp, vp]
    lib.tm_set_comb.argtypes = [i32, vp, sz]
    lib.tm_ed25519_build_tables.argtypes = [vp, i32, vp, vp, vp]
    lib.tm_ed25519_lanes.argtypes = [vp, vp, vp]
    lib.tm_ed25519_lanes.restype = None
    lib.tm_ed25519_prepare_tabled.argtypes = [vp, vp, i32, vp, i32, vp, i32, vp, vp, i32, vp, i32, vp, vp, vp, vp]
    lib.tm_ed25519_scan_tabled.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp, vp, vp]
    lib.tm_sha256_leaf_blocks.argtypes = [vp, vp, vp, i32, i32, vp, vp]
    lib.tm_merkle_tree.argtypes = [vp, i32, i32, vp, i32, vp, i32, vp, i32, vp]
    lib.tm_merkle_tree_layout.argtypes = [i32, vp]
    lib.tm_merkle_tree_layout.restype = i32
    lib.tm_set_bls_constants.argtypes = [i32, vp, sz]
    lib.tm_bls12_lanes.argtypes = [vp, vp, vp, vp]
    lib.tm_bls12_lanes.restype = None
    lib.tm_bls12_pairing_check.argtypes = [vp, vp, vp, i32, i32, vp, vp, vp]
    lib.tm_bls12_map_to_g2.argtypes = [vp, vp, i32, vp, vp, vp]
    lib.tm_bls12_g1_aggregate_scratch.argtypes = [i32, i32]
    lib.tm_bls12_g1_aggregate_scratch.restype = sz
    lib.tm_bls12_g1_aggregate.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp]
    for fn in (lib.tm_set_constants, lib.tm_ed25519_prepare, lib.tm_ed25519_scan, lib.tm_ed25519_finish,
               lib.tm_set_comb, lib.tm_ed25519_build_tables, lib.tm_ed25519_prepare_tabled,
               lib.tm_ed25519_scan_tabled, lib.tm_sha256_leaf_blocks, lib.tm_merkle_tree,
               lib.tm_set_bls_constants, lib.tm_bls12_pairing_check, lib.tm_bls12_map_to_g2,
               lib.tm_bls12_g1_aggregate):
        fn.restype = i32


def constants_blob() -> bytes:
    """The kernels' TmConstants struct (ge25519.cuh), packed on the host:
    d, 2d, sqrt(-1) and the cached [1..8]B table as int32 limbs."""
    from tendermint_tpu_torch.ops import curve, field

    limbs = field.to_limbs(curve.D) + field.to_limbs(curve.D2) + field.to_limbs(curve.SQRT_M1)
    for row in curve.base_table_ints():
        for c in row:
            limbs += field.to_limbs(c)
    return struct.pack(f"<{len(limbs)}i", *limbs)


def comb_blob() -> bytes:
    """The tabled scan's base comb (csrc/ed25519_tabled.cu c_comb):
    curve.base_comb256_limbs() as little-endian int32."""
    from tendermint_tpu_torch.ops import curve

    flat = [x for pos in curve.base_comb256_limbs() for ent in pos for c in ent for x in c]
    return struct.pack(f"<{len(flat)}i", *flat)


def check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.tm_error_string(code).decode()})")


def library(device_index: int):
    """The loaded kernel library, with its constants on `device_index`."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        if device_index not in _const_devices:
            blob = constants_blob()
            check(_lib, _lib.tm_set_constants(device_index, blob, len(blob)), "constants upload")
            blob = comb_blob()
            check(_lib, _lib.tm_set_comb(device_index, blob, len(blob)), "base comb upload")
            from tendermint_tpu_torch.ops import bls12

            blob = bls12.constants_blob()
            check(_lib, _lib.tm_set_bls_constants(device_index, blob, len(blob)), "BLS12-381 constants upload")
            _const_devices.add(device_index)
        return _lib
