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

Not copied from the JAX module, which needs them for XLA's compiles:
the row and table buckets and their pad rows, the blocking and
background compiles, the compile breaker, the chaos sites and the mesh
router. The kernels take any row count and any table size (the JAX
engine answers None above 128 rows or 4,096 points, for the oracle to
serve), and the engine never answers None: a failed launch raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.ops import bls12 as ops_bls
from tendermint_tpu_torch.utils.device import resolve_device


class BLSEngine:
    """The BLS kernels on `device` (None: the card; "cpu": their plain
    versions)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.stats: Dict[str, int] = {"device_rows": 0, "device_calls": 0, "device_maps": 0, "device_aggregates": 0}

    def verify_rows(self, rows) -> np.ndarray:
        """rows: [(pk point, hm point, sig point)], oracle affine tuples of
        valid curve points -> (N,) bool."""
        if not rows:
            return np.zeros(0, dtype=bool)
        dev = self.device
        ok, _value = ops_bls.pairing_check_rows(ops_bls.g1_tensor([r[0] for r in rows], dev),
                                                ops_bls.g2_tensor([r[1] for r in rows], dev),
                                                ops_bls.g2_tensor([r[2] for r in rows], dev))
        self.stats["device_rows"] += len(rows)
        self.stats["device_calls"] += 1
        return ok.cpu().numpy()

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
