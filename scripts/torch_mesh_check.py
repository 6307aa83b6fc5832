"""Phase 9 of chip_smoke.py (the port's mesh runtime) alone, at 2,000
validators, on every GPU the machine shows: the quickest check that the
routed engines give their unrouted results over several real devices.

    python3 scripts/torch_mesh_check.py

With one GPU it runs the one-device route and two lanes of cuda:0; with
2-4 it also runs the placed path over the real devices (chip_smoke.py
phase 9, step 2), whose results must be identical to one device's. The
BLS rows are 16 pairing checks made with the oracle (two of them bad).
Exits nonzero on any failed check, and without CUDA.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_VALS = 2000
N_BLS_ROWS = 16


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch import TorchBatchVerifier
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import ref_bls12 as B

    cs.N_VALS, cs.N_BLS = N_VALS, N_BLS_ROWS
    t0 = time.perf_counter()
    card = cs.nvidia_smi()
    print(f"{card}; {torch.cuda.device_count()} devices; built {_build.build().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(cs.SEED + 9)
    vs, commit, bid, _by_addr = cs.build_commit(rng)
    vs_b = cs.second_set(vs, rng)

    class GenericOnly(TorchBatchVerifier):
        def verify_rows_cached(self, *a, **k):
            return None

        def verify_rows_cached_templated(self, *a, **k):
            return None

    verifier_t, verifier_g = TorchBatchVerifier(), GenericOnly()
    sks = [B.keygen(b"mesh-check-%d" % i) for i in range(N_BLS_ROWS)]
    hms = [B.hash_to_curve_g2(b"mesh-check-msg-%d" % i, B.DST_SIG) for i in range(N_BLS_ROWS)]
    sigs = [B.g2_mul(s, h) for s, h in zip(sks, hms)]
    for i in (N_BLS_ROWS - 7, N_BLS_ROWS - 3):  # among the last 8 rows, as phase 8's adversarial rows
        sigs[i] = B.g2_mul(777 + i, B.G2_GEN)
    bls_rows = list(zip([B.sk_to_pk(s) for s in sks], hms, sigs))
    unrouted = {path: cs.time_verify_commit(vs, commit, bid, v, cold=True)[:2]
                for path, v in (("generic", verifier_g), ("tabled", verifier_t))}
    kernels = {name: {"name": name} for name in cs.all_launches()}
    cs.phase9(vs, vs_b, commit, bid, card, kernels, bls_rows, verifier_t, verifier_g, unrouted)
    print(f"torch_mesh_check: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
