"""VerifierModel: the ed25519 stages chained on one device.

Counterpart of the JAX package's ``models/verifier.py``, with its two
paths:

- the generic path (``verify``, ``verify_commit``): the three generic
  kernels, with the voting-power tally fused into the last;
- the per-valset tabled path (``verify_rows_cached``,
  ``verify_rows_cached_templated``): the set's keys are decompressed and
  tabulated once (``ed25519_build_tables``) and kept on the device in a
  small LRU (``MAX_CACHED_VALSETS``), keyed by the pubkey digest and the
  device; each call then runs ``ed25519_prepare_tabled``,
  ``ed25519_scan_tabled`` and ``ed25519_finish``. Rows name their
  validator by index, so a commit of this set, a subset of it, or rows
  with repeated validators (the light client's trusting path) all read
  the same tables.

What the JAX module needs only because of XLA or the TPU is not carried
over: batch-size buckets and padding, the AOT executable cache, compile
threads and their non-blocking cold path, 16384-row windows, 16-bit
int32 power chunks, ``_TABLE_BUILD_CHUNK`` (the build program's HBM
bound), ``_GATHER_POLICY_MIN_TABLE`` (XLA's pathological large-table
gathers), the dense/gathered/sharded split of the tabled scan (here one
kernel reads each row's table in place) and ``MAX_TABLED_VALSET``. The
table build is synchronous and a failed build or launch raises: there
is no breaker that quietly falls back to the generic path. Not carried
over yet: table persistence on disk, ``register_valset``/``warmup``,
the mesh variants.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.utils.device import resolve_device

# Two sets cover the live pattern: the current set and the next one
# around a validator-set change. 15,360 B of tables a validator, so a
# 10,000-validator entry holds 154 MB of device memory.
MAX_CACHED_VALSETS = 2

# Sets above this size take the generic path, as in the JAX package
# (65,536 validators are about 1 GB of tables).
MAX_SHARDED_VALSET = 1 << 16


class ValsetTables:
    """A validator set's tables on one device."""

    __slots__ = ("tables", "a_ok", "pk", "v", "build_s")

    def __init__(self, tables, a_ok, pk, build_s: float):
        self.tables = tables  # (V, 16, 8, 3, 10) int32
        self.a_ok = a_ok  # (V,) bool
        self.pk = pk  # (V, 32) uint8, read by prepare through the row index
        self.v = int(pk.shape[0])
        self.build_s = build_s


class VerifierModel:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._valset_tables: "OrderedDict[Tuple[bytes, str], ValsetTables]" = OrderedDict()

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

    # -- the per-valset tabled path ------------------------------------------

    def tables_entry(self, valset_key: bytes, all_pubkeys: np.ndarray) -> Optional[ValsetTables]:
        """The set's tables, built now if they are not cached; None when
        the set is too large for the tabled path. `valset_key` is the
        digest of `all_pubkeys` (``ValidatorSet.batch_cache``)."""
        v = int(all_pubkeys.shape[0])
        if v > MAX_SHARDED_VALSET:
            return None
        key = (bytes(valset_key), str(self.device))
        with self._lock:
            e = self._valset_tables.get(key)
            if e is not None:
                self._valset_tables.move_to_end(key)
                if e.v != v:
                    raise ValueError(f"valset key names a set of {e.v} validators, got {v}")
                return e
            t0 = time.perf_counter()
            pk = self._upload(np.asarray(all_pubkeys, dtype=np.uint8), torch.uint8)
            tables, a_ok = ed25519.build_valset_tables(pk)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # a fault surfaces here, not in a later verify
            e = ValsetTables(tables, a_ok, pk, time.perf_counter() - t0)
            self._valset_tables[key] = e
            while len(self._valset_tables) > MAX_CACHED_VALSETS:
                self._valset_tables.popitem(last=False)
            return e

    def verify_rows_cached(self, valset_key, all_pubkeys, row_idx, msgs, sigs) -> Optional[np.ndarray]:
        """Verify rows whose keys are all_pubkeys[row_idx] against the
        set's tables: (N,) bool, or None when the set is too large for
        the tabled path (the caller takes the generic path). Rows are
        independent, so repeated indices are fine."""
        return self._rows_cached(valset_key, all_pubkeys, row_idx, sigs,
                                 msgs=np.asarray(msgs, dtype=np.uint8))

    def verify_rows_cached_templated(self, valset_key, all_pubkeys, row_idx, templates, tmpl_idx, ts8,
                                     sigs) -> Optional[np.ndarray]:
        """verify_rows_cached with row r's message templates[tmpl_idx[r]]
        with ts8[r] (8 bytes, big-endian) at the timestamp offset; the
        prepare kernel reads the bytes in place, so per row only the
        template index and the timestamp go to the device."""
        templates = np.asarray(templates, dtype=np.uint8)
        tmpl_idx = np.asarray(tmpl_idx, dtype=np.int64)
        if tmpl_idx.size and (tmpl_idx.min() < 0 or tmpl_idx.max() >= templates.shape[0]):
            raise IndexError(f"tmpl_idx outside the {templates.shape[0]} templates")
        return self._rows_cached(valset_key, all_pubkeys, row_idx, sigs, templates=templates,
                                 tmpl_idx=tmpl_idx, ts8=np.asarray(ts8, dtype=np.uint8))

    def _rows_cached(self, valset_key, all_pubkeys, row_idx, sigs, msgs=None, templates=None,
                     tmpl_idx=None, ts8=None) -> Optional[np.ndarray]:
        idx = np.asarray(row_idx, dtype=np.int64)
        n = int(idx.shape[0])
        if n == 0:
            return np.zeros(0, dtype=bool)
        all_pubkeys = np.asarray(all_pubkeys, dtype=np.uint8)
        e = self.tables_entry(valset_key, all_pubkeys)
        if e is None:
            return None
        if idx.min() < 0 or idx.max() >= e.v:
            raise IndexError(f"row_idx outside the set of {e.v} validators")
        src = {}
        # row r is validator r: no index to upload
        if not (n <= e.v and np.array_equal(idx, np.arange(n))):
            src["idx"] = self._upload(idx, torch.int32)
        if msgs is not None:
            src["msgs"] = self._upload(msgs, torch.uint8)
        else:
            src["templates"] = self._upload(templates, torch.uint8)
            src["tmpl_idx"] = self._upload(tmpl_idx, torch.int32)
            src["ts8"] = self._upload(ts8, torch.uint8)
        sg = self._upload(np.asarray(sigs, dtype=np.uint8), torch.uint8)
        return ed25519.verify_tabled(e.tables, e.a_ok, e.pk, sg, **src).cpu().numpy()
