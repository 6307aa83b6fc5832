"""BLSEngine: the three BLS12-381 kernels on one device.

Counterpart of the JAX package's ``models/bls.py``, with its three
surfaces, one per kernel of ``ops/bls12.py``:

- ``verify_rows``: per-row pairing checks e(pk, H(m)) == e(G1, sig), one
  launch of ``bls12_pairing_check`` for all rows;
- ``map_rows``: hash-to-G2 tails of host-expanded field elements, one
  launch of ``bls12_map_to_g2``;
- ``aggregate``: masked sums over a G1 point table, one launch of
  ``bls12_g1_aggregate`` for all masks.

Points cross as the oracle's affine tuples, as in the JAX engine; the
host's packing of them is a few ms a call beside the host's signature
decoding (seconds at 128 rows).

With a ``router`` (``parallel.topology.MeshRouter``) whose topology has
placement, ``verify_rows`` splits its rows into per-device chunks from
``MESH_MIN_ROWS`` rows on (``_mesh_verify``): one pairing launch a chunk
on its device, every chunk launched before any is read back, the
verdicts concatenated in row order. A failed routed call is answered by
the single-device launch. ``map_rows`` and ``aggregate`` stay unrouted,
as in the JAX engine.

Not copied from the JAX module, which needs them for XLA's compiles:
the row and table buckets and their pad rows, the blocking and
background compiles, the compile breaker and the chaos sites. The
kernels take any row count and any table size (the JAX engine answers
None above 128 rows or 4,096 points, for the oracle to serve), and the
engine never answers None: a failed launch raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import bls12 as ops_bls
from tendermint_tpu_torch.utils.device import on_device, resolve_device


def _pairing_launch(rows, dev: torch.device) -> torch.Tensor:
    """One pairing-check launch on `dev` -> the (N,) verdicts there."""
    with on_device(dev):
        ok, _value = ops_bls.pairing_check_rows(ops_bls.g1_tensor([r[0] for r in rows], dev),
                                                ops_bls.g2_tensor([r[1] for r in rows], dev),
                                                ops_bls.g2_tensor([r[2] for r in rows], dev))
    return ok


class BLSEngine:
    """The BLS kernels on `device` (None: the card; "cpu": their plain
    versions)."""

    # A BLS pairing row costs about five orders of magnitude more than an
    # ed25519 row: a handful of rows already pays for a launch a device,
    # so the engine's mesh floor is its own, not the router's default.
    MESH_MIN_ROWS = 8

    def __init__(self, device=None, router=None):
        self.device = resolve_device(device)
        self.router = router
        self.stats: Dict[str, int] = {"device_rows": 0, "device_calls": 0, "device_maps": 0, "device_aggregates": 0}

    def _mesh_verify(self, rows) -> Optional[np.ndarray]:
        """Per-device chunks of pairing checks; rows are independent, so
        the concatenation equals the single launch's verdicts. None: take
        the single-device path (no router, no placement, a non-collective
        plan, or a failed routed call)."""
        r = self.router
        if r is None or not r.topology.has_placement:
            return None
        plan = r.plan(len(rows), min_rows=self.MESH_MIN_ROWS)
        if not plan.collective:
            return None
        try:
            return r.run(plan, lambda s: _pairing_launch(rows[s.lo:s.hi], s.device),
                         lambda outs: np.concatenate([o.cpu().numpy() for o in outs]))
        except Exception:
            return None

    def verify_rows(self, rows) -> np.ndarray:
        """rows: [(pk point, hm point, sig point)], oracle affine tuples of
        valid curve points -> (N,) bool."""
        if not rows:
            return np.zeros(0, dtype=bool)
        ok = self._mesh_verify(rows)
        if ok is None:
            ok = _pairing_launch(rows, self.device).cpu().numpy()
        self.stats["device_rows"] += len(rows)
        self.stats["device_calls"] += 1
        return ok

    def map_rows(self, us) -> List[Optional[Tuple]]:
        """us: [(u0, u1)] hash_to_field outputs -> G2 points (oracle
        tuples), identical to ref.clear_cofactor_g2(map + map) per row."""
        if not us:
            return []
        dev = self.device
        q, inf = ops_bls.map_to_g2(ops_bls.fp2_tensor([u[0] for u in us], dev),
                                   ops_bls.fp2_tensor([u[1] for u in us], dev))
        self.stats["device_maps"] += 1
        return ops_bls.g2_points(q, inf)

    def aggregate(self, points: Sequence[Tuple[int, int]], masks: np.ndarray) -> List[Optional[Tuple[int, int]]]:
        """Masked sums over a G1 point table: points (V affine tuples),
        masks (B, V) bool -> B points (None = the identity)."""
        masks = np.asarray(masks, dtype=bool)
        if masks.ndim != 2 or masks.shape[1] != len(points):
            raise ValueError(f"masks {masks.shape} do not match a table of {len(points)} points")
        dev = self.device
        out, inf = ops_bls.g1_aggregate(ops_bls.g1_tensor(points, dev), torch.from_numpy(masks).to(dev))
        self.stats["device_aggregates"] += 1
        return ops_bls.g1_points(out, inf)
