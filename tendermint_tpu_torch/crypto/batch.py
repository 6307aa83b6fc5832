"""BatchVerifier: the seam where signature rows go to the device.

The port's copy of the contract in the JAX package's ``crypto/batch.py``
and its providers:

- ``"cuda"``: ``TorchBatchVerifier``, which runs the ed25519 kernels
  through ``models.verifier.VerifierModel``: the generic path for
  ``verify_batch``/``verify_commit_batch`` and the per-valset tabled path
  for ``verify_rows_cached{,_templated}``. With a ``router``
  (``parallel.topology.MeshRouter``) a bundle the router plans as
  collective runs on a ``VerifierModel`` over the plan's devices;
- ``"cpu"``: ``CPUBatchVerifier``, the serial host loop, chosen only by
  name (``make_provider("cpu")``), never as a fallback;
- ``MeshRoutedVerifier``: chunked routing over any inner verifier, host
  lanes included.

Unlike the JAX package's TPU provider, ``TorchBatchVerifier`` never
answers on the host: rows of ragged length (``msg_lens``) raise instead
of being verified one by one, there is no cold-bucket fallback (there
are no buckets) and no ``min_device_batch``. A failed routed call falls
through to the unrouted path of the same provider: the same kernels on
its own device. ``verify_rows_cached*`` return None ("not available")
only where the JAX provider's do for the same set: past the tabled
path's size limit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from tendermint_tpu_torch.models.verifier import VerifierModel
from tendermint_tpu_torch.utils.device import resolve_device


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


class CPUBatchVerifier(BatchVerifier):
    """Serial host verification with the pure-Python oracle
    (``crypto/keys.Ed25519PubKey.verify``): Go x/crypto's acceptance, one
    row at a time."""

    name = "cpu"

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        from tendermint_tpu_torch.crypto.keys import Ed25519PubKey

        n = len(pubkeys)
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            try:
                pk = Ed25519PubKey(bytes(bytearray(pubkeys[i])))
            except ValueError:
                continue
            msg = bytes(bytearray(msgs[i]))
            if msg_lens is not None:
                msg = msg[: int(msg_lens[i])]
            out[i] = pk.verify(msg, bytes(bytearray(sigs[i])))
        return out


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
    versions with device="cpu"), sharded over the router's admitted
    devices when it plans a bundle as collective."""

    name = "torch"

    # The admitted set changes rarely (a breaker trip or recovery): keep
    # a few meshed models so that flapping between two cohorts does not
    # rebuild tables every bundle.
    _MAX_MESH_MODELS = 4

    def __init__(self, device=None, router=None):
        self.model = VerifierModel(device)
        self.router = router
        self._mesh_lock = threading.Lock()
        self._mesh_models: dict = {}  # mesh_key tuple -> VerifierModel
        self._valsets: dict = {}  # valset_key -> all_pubkeys (re-registered on a new mesh model)

    def warmup(self, rows: int = 2, msg_len: int = 160) -> None:
        self.model.warmup(rows=rows, msg_len=msg_len)

    # -- mesh routing (the seam: the model stays one call over its mesh) ----

    def _plan(self, n: int):
        if self.router is None:
            return None
        return self.router.plan(n)

    def _collective_model(self, plan):
        """The VerifierModel over exactly the plan's devices (None when
        the topology has no placement)."""
        key = self.router.mesh_key(plan)
        with self._mesh_lock:
            model = self._mesh_models.get(key)
            if model is not None:
                return model
            mesh = self.router.device_mesh(plan)
            if mesh is None:
                return None
            model = VerifierModel(self.model.device, mesh=mesh)
            for vk, pks in self._valsets.items():
                model.register_valset(vk, pks)
            if len(self._mesh_models) >= self._MAX_MESH_MODELS:
                self._mesh_models.pop(next(iter(self._mesh_models)))
            self._mesh_models[key] = model
            return model

    def _meshed(self, n: int, call):
        """Run ``call(model)`` over the admitted mesh when the router says
        collective; a failure (counted by the router in
        ``shard_failures``) or a None no-cached-path result falls through
        to the unrouted path, with bit-identical results."""
        plan = self._plan(n)
        if plan is None or not plan.collective:
            return False, None
        model = self._collective_model(plan)
        if model is None:
            self.router.release(plan)
            return False, None
        try:
            return True, self.router.run_collective(plan, lambda: call(model))
        except Exception:
            return False, None

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        msgs = uniform_msgs(np.asarray(msgs), msg_lens)
        ran, out = self._meshed(len(pubkeys), lambda m: m.verify(pubkeys, msgs, sigs))
        if ran:
            return out
        return self.model.verify(pubkeys, msgs, sigs)

    def verify_commit_batch(self, pubkeys, msgs, sigs, powers, counted) -> Tuple[np.ndarray, int]:
        ran, out = self._meshed(len(pubkeys), lambda m: m.verify_commit(pubkeys, msgs, sigs, powers, counted))
        if ran:
            return out
        return self.model.verify_commit(pubkeys, msgs, sigs, powers, counted)

    def verify_rows_cached(self, valset_key, all_pubkeys, row_idx, msgs, sigs) -> Optional[np.ndarray]:
        ran, out = self._meshed(
            len(row_idx), lambda m: m.verify_rows_cached(valset_key, all_pubkeys, row_idx, msgs, sigs))
        if ran and out is not None:
            return out
        return self.model.verify_rows_cached(valset_key, all_pubkeys, row_idx, msgs, sigs)

    def verify_rows_cached_templated(
        self, valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs
    ) -> Optional[np.ndarray]:
        ran, out = self._meshed(
            len(row_idx),
            lambda m: m.verify_rows_cached_templated(valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8,
                                                     sigs))
        if ran and out is not None:
            return out
        return self.model.verify_rows_cached_templated(
            valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs)

    def register_valset(self, valset_key, all_pubkeys) -> None:
        """Build the set's tables now (node start), on the provider's
        device and on every meshed model's devices."""
        with self._mesh_lock:
            self._valsets[valset_key] = all_pubkeys
            models = list(self._mesh_models.values())
        self.model.register_valset(valset_key, all_pubkeys)
        for m in models:
            m.register_valset(valset_key, all_pubkeys)


class MeshRoutedVerifier(BatchVerifier):
    """Chunked mesh routing over ANY inner verifier.

    Where ``TorchBatchVerifier(router=...)`` runs one ``VerifierModel``
    call over the admitted mesh, this wrapper splits the bundle into
    contiguous per-device row chunks and calls the inner verifier once
    per chunk: the same ``MeshRouter`` admission and breaker semantics
    with no placement, which is what logical host lanes need. Verdict
    order is kept by concatenation and the quorum tally is an exact
    integer sum, so results are bit-identical to the unrouted inner
    verifier by construction; a failed bundle is answered by the inner
    verifier unrouted."""

    def __init__(self, inner: BatchVerifier, router):
        self.inner = inner
        self.router = router
        self.name = f"mesh({inner.name})"

    def warmup(self, *a, **kw):
        fn = getattr(self.inner, "warmup", None)
        return fn(*a, **kw) if fn else None

    def register_valset(self, valset_key, all_pubkeys) -> None:
        fn = getattr(self.inner, "register_valset", None)
        if fn:
            fn(valset_key, all_pubkeys)

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        plan = self.router.plan(len(pubkeys))
        if not plan.collective:
            return self.inner.verify_batch(pubkeys, msgs, sigs, msg_lens=msg_lens)
        try:
            return self.router.run(
                plan,
                lambda s: self.inner.verify_batch(
                    pubkeys[s.lo : s.hi], msgs[s.lo : s.hi], sigs[s.lo : s.hi],
                    msg_lens=None if msg_lens is None else msg_lens[s.lo : s.hi]),
                lambda outs: np.concatenate(outs),
            )
        except Exception:
            return self.inner.verify_batch(pubkeys, msgs, sigs, msg_lens=msg_lens)

    def verify_commit_batch(self, pubkeys, msgs, sigs, powers, counted):
        plan = self.router.plan(len(pubkeys))
        if not plan.collective:
            return self.inner.verify_commit_batch(pubkeys, msgs, sigs, powers, counted)

        def _combine(outs):
            ok = np.concatenate([o[0] for o in outs])
            return ok, int(sum(o[1] for o in outs))

        try:
            return self.router.run(
                plan,
                lambda s: self.inner.verify_commit_batch(
                    pubkeys[s.lo : s.hi], msgs[s.lo : s.hi], sigs[s.lo : s.hi], powers[s.lo : s.hi],
                    counted[s.lo : s.hi]),
                _combine,
            )
        except Exception:
            return self.inner.verify_commit_batch(pubkeys, msgs, sigs, powers, counted)

    def verify_rows_cached(self, valset_key, all_pubkeys, row_idx, msgs, sigs):
        plan = self.router.plan(len(row_idx))
        if not plan.collective:
            return self.inner.verify_rows_cached(valset_key, all_pubkeys, row_idx, msgs, sigs)

        def _combine(outs):
            if any(o is None for o in outs):
                return None  # a chunk had no cached path: the whole bundle takes the caller's fallback
            return np.concatenate(outs)

        try:
            return self.router.run(
                plan,
                lambda s: self.inner.verify_rows_cached(
                    valset_key, all_pubkeys, row_idx[s.lo : s.hi], msgs[s.lo : s.hi], sigs[s.lo : s.hi]),
                _combine,
            )
        except Exception:
            return self.inner.verify_rows_cached(valset_key, all_pubkeys, row_idx, msgs, sigs)

    def verify_rows_cached_templated(self, valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs):
        plan = self.router.plan(len(row_idx))
        if not plan.collective:
            return self.inner.verify_rows_cached_templated(
                valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs)

        def _combine(outs):
            if any(o is None for o in outs):
                return None
            return np.concatenate(outs)

        try:
            # the templates go whole to every chunk; tmpl_idx stays valid
            return self.router.run(
                plan,
                lambda s: self.inner.verify_rows_cached_templated(
                    valset_key, all_pubkeys, row_idx[s.lo : s.hi], templates, tmpl_idx[s.lo : s.hi],
                    ts8[s.lo : s.hi], sigs[s.lo : s.hi]),
                _combine,
            )
        except Exception:
            return self.inner.verify_rows_cached_templated(
                valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8, sigs)


_DEFAULT: Dict[str, BatchVerifier] = {}
_DEFAULT_LOCK = threading.Lock()


def get_default_provider(device=None) -> BatchVerifier:
    """The provider of `device` (None: the card) that the entry points use
    when given none: the one set with ``set_default_provider``, else one
    shared TorchBatchVerifier per device, so that a set's tables outlive a
    call."""
    key = str(resolve_device(device))
    with _DEFAULT_LOCK:
        v = _DEFAULT.get(key)
        if v is None:
            v = _DEFAULT[key] = TorchBatchVerifier(key)
        return v


def set_default_provider(v: Optional[BatchVerifier], device=None) -> None:
    """Make `v` the default provider of `device`; None restores a fresh
    TorchBatchVerifier at the next ``get_default_provider``."""
    key = str(resolve_device(device))
    with _DEFAULT_LOCK:
        if v is None:
            _DEFAULT.pop(key, None)
        else:
            _DEFAULT[key] = v


default_provider = get_default_provider


def make_provider(name: str, router=None, device=None) -> BatchVerifier:
    """"cuda": a TorchBatchVerifier on `device` (None: the card), routed
    by `router` when one is given; "cpu": the serial host loop."""
    if name == "cpu":
        return CPUBatchVerifier()
    if name == "cuda":
        return TorchBatchVerifier(device, router=router)
    raise ValueError(f"unknown crypto provider {name!r}")
