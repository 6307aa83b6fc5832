"""VerifierModel: the three ed25519 stages chained on one device.

Counterpart of the JAX package's ``models/verifier.py``. What that module
needs only because of XLA is not carried over: batch-size buckets, the
AOT executable cache, compile threads, 16384-row windows and 16-bit
int32 power chunks. Batches of any size go straight to the kernels, the
intermediates stay on the device, and the tally is one int64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.utils.device import resolve_device


class VerifierModel:
    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _upload(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch.from_numpy wants a writable array
            a = a.copy()
        t = torch.from_numpy(a).to(dtype)
        return t.to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    def _inputs(self, pubkeys, msgs, sigs):
        return (
            self._upload(np.asarray(pubkeys, dtype=np.uint8), torch.uint8),
            self._upload(np.asarray(msgs, dtype=np.uint8), torch.uint8),
            self._upload(np.asarray(sigs, dtype=np.uint8), torch.uint8),
        )

    def verify(self, pubkeys: np.ndarray, msgs: np.ndarray, sigs: np.ndarray) -> np.ndarray:
        """(N,32), (N,M), (N,64) uint8 -> (N,) bool."""
        return ed25519.verify(*self._inputs(pubkeys, msgs, sigs)).cpu().numpy()

    def verify_commit(self, pubkeys, msgs, sigs, powers, counted) -> Tuple[np.ndarray, int]:
        """Verify and sum `powers` (N,) int64 over rows that verified and
        are `counted` (N,) bool -> (ok (N,) bool, tally int)."""
        pk, m, s = self._inputs(pubkeys, msgs, sigs)
        pw = self._upload(np.asarray(powers, dtype=np.int64), torch.int64)
        ct = self._upload(np.asarray(counted, dtype=bool), torch.bool)
        ok, tally = ed25519.verify_and_tally(pk, m, s, pw, ct)
        return ok.cpu().numpy(), int(tally.item())
