"""VerifierModel: the ed25519 stages chained on one device, or on a mesh.

Counterpart of the JAX package's ``models/verifier.py``, with its two
paths:

- the generic path (``verify``, ``verify_commit``): the three generic
  kernels, with the voting-power tally fused into the last;
- the per-valset tabled path (``verify_rows_cached``,
  ``verify_rows_cached_templated``): the set's keys are decompressed and
  tabulated once (``ed25519_build_tables``) and kept on the device in a
  small LRU (``MAX_CACHED_VALSETS`` a device), keyed by the pubkey digest
  and the device; each call then runs ``ed25519_prepare_tabled``,
  ``ed25519_scan_tabled`` and ``ed25519_finish``. Rows name their
  validator by index, so a commit of this set, a subset of it, or rows
  with repeated validators (the light client's trusting path) all read
  the same tables.

With ``mesh`` (a tuple of devices, ``parallel.mesh.make_mesh``) the model
is the counterpart of the JAX package's ``shard_map`` variants: the rows
split into contiguous chunks of ceil(N / D) rows, one a device of the
mesh, the same chunks ``parallel.topology.MeshRouter`` plans. Every
chunk's kernels are launched on its device's current stream before
anything is read back; then the verdicts are concatenated in row order
and the per-device tallies (one int64 each) summed on the host with
Python ints, which replaces the JAX package's ``psum``
(``finish_tally_psum``). On the tabled path the set's tables replicate
(one build on each distinct device of the mesh) while the rows, their
indices, timestamps and signatures shard; the message templates go whole
to every device. ``sharded_valset_cap`` divides the table budget by the
mesh size. A mesh may name one device more than once: its chunks then
run one after another there, on one set of tables.

What the JAX module needs only because of XLA or the TPU is not carried
over: batch-size buckets and padding, the AOT executable cache, compile
threads and their non-blocking cold path, 16384-row windows, 16-bit
int32 power chunks, ``_TABLE_BUILD_CHUNK`` (the build program's HBM
bound), ``_GATHER_POLICY_MIN_TABLE`` (XLA's pathological large-table
gathers) and the dense/gathered/sharded split of the tabled scan (here
one kernel reads each row's table in place). The table build is
synchronous and a failed build or launch raises: there is no breaker
that quietly falls back to the generic path. ``warmup`` has no compiles
to do; it builds the kernel library and launches each kernel once. Not
carried over yet: table persistence on disk.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519
from tendermint_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from tendermint_tpu_torch.utils.device import on_device, resolve_device

# Two sets a device cover the live pattern: the current set and the next
# one around a validator-set change. 15,360 B of tables a validator, so
# a 10,000-validator entry holds 154 MB of device memory.
MAX_CACHED_VALSETS = 2

# Sets up to this size take the tabled path on any mesh (the JAX
# package's dense-table bound).
MAX_TABLED_VALSET = 16384

# Larger sets take the generic path, as in the JAX package (65,536
# validators are about 1 GB of tables). The figure is one device's; on a
# mesh of D devices the cap is MAX_SHARDED_VALSET // D
# (``sharded_valset_cap``).
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


def upload(a: np.ndarray, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable array
        a = a.copy()
    t = torch.from_numpy(a).to(dtype)
    return t.to(dev, non_blocking=True) if dev.type == "cuda" else t


class VerifierModel:
    def __init__(self, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = None if mesh is None else tuple(resolve_device(d) for d in make_mesh(mesh))
        # the devices a call's chunks run on, in row order
        self._lanes: Tuple[torch.device, ...] = self.mesh if self.mesh is not None else (self.device,)
        self._lock = threading.Lock()
        self._valset_tables: "OrderedDict[Tuple[bytes, str], ValsetTables]" = OrderedDict()

    def _chunks(self, n: int) -> List[Tuple[torch.device, int, int]]:
        """(device, lo, hi): contiguous chunks of ceil(n / D) rows, the
        last one short, empty ones dropped (``MeshRouter.plan``'s)."""
        d = len(self._lanes)
        c = pad_to_multiple(n, d) // d
        return [(dev, k * c, min(n, (k + 1) * c)) for k, dev in enumerate(self._lanes) if k * c < n]

    def _distinct_lanes(self) -> List[torch.device]:
        return list(dict.fromkeys(self._lanes))

    # -- the generic path ----------------------------------------------------

    def verify(self, pubkeys: np.ndarray, msgs: np.ndarray, sigs: np.ndarray) -> np.ndarray:
        """(N,32), (N,M), (N,64) uint8 -> (N,) bool."""
        pubkeys, msgs, sigs = (np.asarray(a, dtype=np.uint8) for a in (pubkeys, msgs, sigs))
        outs = []
        for dev, lo, hi in self._chunks(pubkeys.shape[0]):
            with on_device(dev):
                outs.append(ed25519.verify(*(upload(a[lo:hi], torch.uint8, dev) for a in (pubkeys, msgs, sigs))))
        return np.concatenate([o.cpu().numpy() for o in outs]) if outs else np.zeros(0, dtype=bool)

    def verify_commit(self, pubkeys, msgs, sigs, powers, counted) -> Tuple[np.ndarray, int]:
        """Verify and sum `powers` (N,) int64 over rows that verified and
        are `counted` (N,) bool -> (ok (N,) bool, tally int)."""
        pubkeys, msgs, sigs = (np.asarray(a, dtype=np.uint8) for a in (pubkeys, msgs, sigs))
        powers = np.asarray(powers, dtype=np.int64)
        counted = np.asarray(counted, dtype=bool)
        outs = []
        for dev, lo, hi in self._chunks(pubkeys.shape[0]):
            with on_device(dev):
                outs.append(ed25519.verify_and_tally(
                    *(upload(a[lo:hi], torch.uint8, dev) for a in (pubkeys, msgs, sigs)),
                    upload(powers[lo:hi], torch.int64, dev), upload(counted[lo:hi], torch.bool, dev)))
        if not outs:
            return np.zeros(0, dtype=bool), 0
        ok = np.concatenate([o[0].cpu().numpy() for o in outs])
        return ok, sum(int(o[1].item()) for o in outs)

    # -- the per-valset tabled path ------------------------------------------

    def sharded_valset_cap(self) -> int:
        """The largest set the tabled path serves past MAX_TABLED_VALSET
        on this model: MAX_SHARDED_VALSET, divided by the mesh size on a
        mesh (the tables replicate to every device while each works its
        share of the rows)."""
        if self.mesh is None:
            return MAX_SHARDED_VALSET
        return MAX_SHARDED_VALSET // max(1, len(self.mesh))

    def tables_entry(self, valset_key: bytes, all_pubkeys: np.ndarray) -> Optional[ValsetTables]:
        """The set's tables, built now on every device of the model where
        they are not cached; the first device's entry, or None when the
        set is too large for the tabled path. `valset_key` is the digest
        of `all_pubkeys` (``ValidatorSet.batch_cache``)."""
        entries = self._tables(valset_key, np.asarray(all_pubkeys, dtype=np.uint8))
        return None if entries is None else entries[str(self._lanes[0])]

    def _tables(self, valset_key: bytes, all_pubkeys: np.ndarray):
        v = int(all_pubkeys.shape[0])
        if v > MAX_TABLED_VALSET and v > self.sharded_valset_cap():
            return None
        return {str(dev): self._tables_on(bytes(valset_key), all_pubkeys, dev) for dev in self._distinct_lanes()}

    def _tables_on(self, valset_key: bytes, all_pubkeys: np.ndarray, dev: torch.device) -> ValsetTables:
        v = int(all_pubkeys.shape[0])
        key = (valset_key, str(dev))
        with self._lock:
            e = self._valset_tables.get(key)
            if e is not None:
                self._valset_tables.move_to_end(key)
                if e.v != v:
                    raise ValueError(f"valset key names a set of {e.v} validators, got {v}")
                return e
            t0 = time.perf_counter()
            with on_device(dev):
                pk = upload(all_pubkeys, torch.uint8, dev)
                tables, a_ok = ed25519.build_valset_tables(pk)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)  # a fault surfaces here, not in a later verify
            e = ValsetTables(tables, a_ok, pk, time.perf_counter() - t0)
            self._valset_tables[key] = e
            same = [k for k in self._valset_tables if k[1] == key[1]]
            for old in same[: max(0, len(same) - MAX_CACHED_VALSETS)]:
                del self._valset_tables[old]
            return e

    def register_valset(self, valset_key: bytes, all_pubkeys) -> None:
        """Build the set's tables now, on every device of the model, so
        that its first commit pays no build (a no-op for a set already
        cached, or too large for the tabled path)."""
        self.tables_entry(valset_key, all_pubkeys)

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
        entries = self._tables(valset_key, all_pubkeys)
        if entries is None:
            return None
        v = int(all_pubkeys.shape[0])
        if idx.min() < 0 or idx.max() >= v:
            raise IndexError(f"row_idx outside the set of {v} validators")
        sigs = np.asarray(sigs, dtype=np.uint8)
        outs = []
        for dev, lo, hi in self._chunks(n):
            e = entries[str(dev)]
            chunk = idx[lo:hi]
            with on_device(dev):
                src = {}
                # row r is validator r: no index to upload (a chunk past
                # the first of a full commit starts at validator lo)
                if not (hi - lo <= e.v and np.array_equal(chunk, np.arange(hi - lo))):
                    src["idx"] = upload(chunk, torch.int32, dev)
                if msgs is not None:
                    src["msgs"] = upload(msgs[lo:hi], torch.uint8, dev)
                else:
                    src["templates"] = upload(templates, torch.uint8, dev)
                    src["tmpl_idx"] = upload(tmpl_idx[lo:hi], torch.int32, dev)
                    src["ts8"] = upload(ts8[lo:hi], torch.uint8, dev)
                sg = upload(sigs[lo:hi], torch.uint8, dev)
                outs.append(ed25519.verify_tabled(e.tables, e.a_ok, e.pk, sg, **src))
        return np.concatenate([o.cpu().numpy() for o in outs])

    # -- warmup ----------------------------------------------------------------

    def warmup(self, rows: int = 2, msg_len: int = 160) -> None:
        """Build the kernel library and launch each generic and tabled
        kernel once on `rows` rows of zeros on every device of the model,
        which is all a first live call would otherwise pay (there are no
        compiles). Builds no cached tables."""
        z = np.zeros
        for dev in self._distinct_lanes():
            with on_device(dev):
                pk, sg = upload(z((rows, 32), np.uint8), torch.uint8, dev), upload(z((rows, 64), np.uint8),
                                                                                  torch.uint8, dev)
                mg = upload(z((rows, msg_len), np.uint8), torch.uint8, dev)
                ed25519.verify_and_tally(pk, mg, sg, upload(z(rows, np.int64), torch.int64, dev),
                                         upload(z(rows, bool), torch.bool, dev))
                tables, a_ok = ed25519.build_valset_tables(pk)
                ed25519.verify_tabled(tables, a_ok, pk, sg, msgs=mg)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
