"""BatchVerifier: the seam where signature rows go to the device.

The port's copy of the contract in the JAX package's ``crypto/batch.py``
and its provider, ``TorchBatchVerifier``, which runs the ed25519 kernels
through ``models.verifier.VerifierModel``: the generic path for
``verify_batch``/``verify_commit_batch`` and the per-valset tabled path
for ``verify_rows_cached{,_templated}``.

Unlike the JAX package's TPU provider, this one never answers on the
host: rows of ragged length (``msg_lens``) raise instead of being
verified one by one, and there is no cold-bucket fallback (there are no
buckets). ``verify_rows_cached*`` return None ("not available") only
where the JAX provider's do for the same set: past the tabled path's
size limit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np


class BatchVerifier:
    """Batch signature verification over rectangular uint8 arrays."""

    name = "abstract"

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        """pubkeys (N,32), msgs (N,L), sigs (N,64) uint8 -> (N,) bool.
        `msg_lens` (N,) gives each row's true length when rows are padded
        to L; None means every row is exactly L."""
        raise NotImplementedError

    def verify_commit_batch(self, pubkeys, msgs, sigs, powers, counted) -> Tuple[np.ndarray, int]:
        """Verify and tally: (ok (N,) bool, sum of `powers` where ok and
        `counted`)."""
        ok = np.asarray(self.verify_batch(pubkeys, msgs, sigs), dtype=bool)
        return ok, int(np.sum(np.where(ok & np.asarray(counted, dtype=bool), powers, 0)))

    def verify_rows_cached(self, valset_key, all_pubkeys, row_idx, msgs, sigs) -> Optional[np.ndarray]:
        """Per-valset precomputed tables; None means "not available"."""
        return None

    def verify_rows_cached_templated(
        self, valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs
    ) -> Optional[np.ndarray]:
        return None


def uniform_msgs(msgs: np.ndarray, msg_lens) -> np.ndarray:
    """The rows cut to their common true length; ValueError when the
    lengths differ (or exceed the padded width)."""
    if msg_lens is None:
        return msgs
    lens = np.unique(np.asarray(msg_lens, dtype=np.int64))
    if lens.size > 1:
        raise ValueError("ragged msg_lens: the device path takes rows of one length")
    if lens.size and (lens[0] < 0 or lens[0] > msgs.shape[1]):
        raise ValueError(f"msg_lens {int(lens[0])} outside the row width {msgs.shape[1]}")
    return msgs[:, : int(lens[0])] if lens.size else msgs


class TorchBatchVerifier(BatchVerifier):
    """The hand-written ed25519 kernels on the card (or their plain
    versions with device="cpu")."""

    name = "torch"

    def __init__(self, device=None):
        from tendermint_tpu_torch.models.verifier import VerifierModel

        self.model = VerifierModel(device)

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        return self.model.verify(pubkeys, uniform_msgs(np.asarray(msgs), msg_lens), sigs)

    def verify_commit_batch(self, pubkeys, msgs, sigs, powers, counted) -> Tuple[np.ndarray, int]:
        return self.model.verify_commit(pubkeys, msgs, sigs, powers, counted)

    def verify_rows_cached(self, valset_key, all_pubkeys, row_idx, msgs, sigs) -> Optional[np.ndarray]:
        return self.model.verify_rows_cached(valset_key, all_pubkeys, row_idx, msgs, sigs)

    def verify_rows_cached_templated(
        self, valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs
    ) -> Optional[np.ndarray]:
        return self.model.verify_rows_cached_templated(
            valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs)


_DEFAULT: Dict[str, TorchBatchVerifier] = {}
_DEFAULT_LOCK = threading.Lock()


def default_provider(device=None) -> TorchBatchVerifier:
    """One shared TorchBatchVerifier per device (the JAX package's
    get_default_provider), so that a set's tables outlive a call."""
    from tendermint_tpu_torch.utils.device import resolve_device

    key = str(resolve_device(device))
    with _DEFAULT_LOCK:
        v = _DEFAULT.get(key)
        if v is None:
            v = _DEFAULT[key] = TorchBatchVerifier(key)
        return v
