"""BLS12-381 keys and the batched BLS verification provider.

The port's copy of the JAX package's ``crypto/bls.py``. Scheme: min-pk
(pubkeys in G1, 48 bytes compressed; signatures in G2, 96 bytes), with
proof-of-possession registration: an aggregate is only sound over keys
whose owner has shown the secret (the rogue-key defense), and the
aggregated-commit path refuses keys without a verified proof.

Layering:

- host keys here (``BLSPubKey``, ``BLSPrivKey``, registered with the
  pubkey registry of ``crypto/keys.py``), on the pure-Python oracle
  (``ops/ref_bls12.py``): keygen, signing, compression, subgroup checks
  and the proofs of possession stay on the host, as in the JAX package;
- ``BLSBatchVerifier`` over ``models/bls.BLSEngine``: the rows' pubkeys
  and signatures are decoded on the host (pubkeys cached), their
  messages expanded to field elements on the host (RFC 9380
  ``hash_to_field``), then one launch maps every distinct message to G2
  and one launch checks every row's pairing. An aggregate check is one
  launch each of the pubkey aggregate, the map and the pairing.

Unlike the JAX provider there is no oracle fallback behind the engine:
no ``min_device_rows``, no None for "serve it on the host"; on a card
every row's map and pairing run there, and a failed launch raises. The
default provider is the one on the card (the JAX package's default is
host-only until a node configures its engine); ``device="cpu"`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.crypto.hash import address_hash
from tendermint_tpu_torch.crypto.keys import register_pubkey_type
from tendermint_tpu_torch.ops import ref_bls12 as ref
from tendermint_tpu_torch.utils.device import resolve_device

BLS_TYPE = "bls12-381"
BLS_PUBKEY_SIZE = 48
BLS_PRIVKEY_SIZE = 32
BLS_SIGNATURE_SIZE = 96


class BLSPubKey:
    """48-byte compressed G1 pubkey. Decoding (decompression and the
    subgroup check) is lazy and cached: a key from wire bytes is cheap,
    and an invalid encoding verifies nothing."""

    type_name = BLS_TYPE
    __slots__ = ("_raw", "_pt", "_checked")

    def __init__(self, raw: bytes):
        if len(raw) != BLS_PUBKEY_SIZE:
            raise ValueError(f"bls12-381 pubkey must be {BLS_PUBKEY_SIZE} bytes")
        self._raw = bytes(raw)
        self._pt = None
        self._checked = False

    def address(self) -> bytes:
        return address_hash(self._raw)

    def bytes(self) -> bytes:
        return self._raw

    def point(self):
        """The decoded G1 point, or None when the encoding is invalid
        (off the curve, outside the r-torsion subgroup, or infinity)."""
        if not self._checked:
            self._checked = True
            self._pt = decode_pubkey_point(self._raw)
        return self._pt

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """Serial verification on the host (the oracle)."""
        pt = self.point()
        if pt is None:
            return False
        sig_pt = decode_signature(sig)
        if sig_pt is None:
            return False
        return ref.verify(pt, msg, sig_pt)

    def verify_possession(self, pop: bytes) -> bool:
        """The proof of possession over this key's compressed bytes."""
        pt = self.point()
        if pt is None:
            return False
        pop_pt = decode_signature(pop)
        if pop_pt is None:
            return False
        return ref.verify_possession(pt, pop_pt)

    def __eq__(self, other) -> bool:
        return isinstance(other, BLSPubKey) and self._raw == other._raw

    def __hash__(self) -> int:
        return hash(self._raw)

    def __repr__(self) -> str:
        return f"PubKeyBLS12_381{{{self._raw.hex()[:16]}…}}"


class BLSPrivKey:
    type_name = BLS_TYPE
    __slots__ = ("_sk", "_pub")

    def __init__(self, raw: bytes):
        if len(raw) != BLS_PRIVKEY_SIZE:
            raise ValueError(f"bls12-381 privkey must be {BLS_PRIVKEY_SIZE} bytes")
        self._sk = ref.sk_from_bytes(raw)
        self._pub = BLSPubKey(ref.g1_compress(ref.sk_to_pk(self._sk)))

    @classmethod
    def generate(cls) -> "BLSPrivKey":
        return cls.from_secret(os.urandom(32))

    @classmethod
    def from_secret(cls, secret: bytes) -> "BLSPrivKey":
        """Deterministic key from seed material (ref.keygen)."""
        return cls(ref.keygen(secret).to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self._sk.to_bytes(32, "big")

    def sign(self, msg: bytes) -> bytes:
        return ref.g2_compress(ref.sign(self._sk, msg))

    def prove_possession(self) -> bytes:
        return ref.g2_compress(ref.prove_possession(self._sk))

    def register_possession(self) -> bytes:
        """Prove possession of this key and record it in the registry;
        returns the proof."""
        pop = self.prove_possession()
        register_possession(self._pub.bytes(), pop)
        return pop

    def pub_key(self) -> BLSPubKey:
        return self._pub

    def __repr__(self) -> str:
        return "PrivKeyBLS12_381{…}"


register_pubkey_type(BLS_TYPE, BLSPubKey)


def is_batch_bls(pub_key) -> bool:
    """True for a key whose rows go to the BLS provider."""
    return isinstance(pub_key, BLSPubKey)


def decode_pubkey_point(raw: bytes):
    """48 bytes -> G1 point, or None for a malformed encoding, a point
    outside the subgroup, or infinity."""
    try:
        pt = ref.g1_decompress(raw)
    except ValueError:
        return None
    if pt is None or not ref.g1_in_subgroup(pt):
        return None
    return pt


def decode_signature(sig: bytes):
    """96 bytes -> G2 point, or None (malformed, off the curve, outside
    the subgroup, or infinity: all invalid signatures)."""
    if len(sig) != BLS_SIGNATURE_SIZE:
        return None
    try:
        pt = ref.g2_decompress(sig)
    except ValueError:
        return None
    if pt is None or not ref.g2_in_subgroup(pt):
        return None
    return pt


def aggregate_signatures(sigs: Sequence[bytes]) -> Optional[bytes]:
    """The sum of G2 signatures as 96 bytes (None when any is malformed
    or the list is empty)."""
    if not sigs:
        return None
    pts = []
    for s in sigs:
        pt = decode_signature(s)
        if pt is None:
            return None
        pts.append(pt)
    return ref.g2_compress(ref.aggregate_sigs(pts))


# -- the proof-of-possession registry --------------------------------------------
#
# ValidatorSet.verify_aggregated_commit refuses any flagged signer whose
# key has no verified proof here, so a rogue key (pk' = pk_atk - pk_victim,
# a valid subgroup point) can be a validator but never part of an
# aggregate: its owner cannot produce a proof for it.

_pop_lock = threading.Lock()
_pop_verified: set = set()


def register_possession(pk_bytes: bytes, pop: bytes) -> bool:
    """Verify `pop` for the 48-byte pubkey (on the host, with the oracle)
    and record it; returns the verdict. Only true verdicts are recorded."""
    try:
        pk = BLSPubKey(bytes(pk_bytes))
    except ValueError:
        return False
    if not pk.verify_possession(pop):
        return False
    with _pop_lock:
        _pop_verified.add(bytes(pk_bytes))
    return True


def has_possession(pk_bytes: bytes) -> bool:
    with _pop_lock:
        return bytes(pk_bytes) in _pop_verified


def clear_possessions() -> None:
    """Test isolation hook."""
    with _pop_lock:
        _pop_verified.clear()


# -- the provider ------------------------------------------------------------------


class BLSBatchVerifier:
    """Batched min-pk verification over rectangular uint8 arrays:
    pubkeys (N, 48), msgs (N, L), sigs (N, 96) -> (N,) bool, on `device`
    (None: the card; "cpu": the plain versions). With a `router`
    (``parallel.topology.MeshRouter``) the engine splits its pairing
    checks over the router's devices."""

    name = "bls"

    def __init__(self, device=None, router=None):
        from tendermint_tpu_torch.models.bls import BLSEngine

        self.device = resolve_device(device)
        self.engine = BLSEngine(self.device, router=router)
        self._pk_cache: Dict[bytes, object] = {}
        self._pk_cache_cap = 1 << 14
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {"rows": 0, "device_rows": 0, "device_maps": 0, "aggregate_checks": 0,
                                         "device_aggregates": 0}

    def decode_pk(self, raw: bytes):
        """The cached decode of a 48-byte pubkey (None when invalid)."""
        with self._lock:
            if raw in self._pk_cache:
                return self._pk_cache[raw]
        pt = decode_pubkey_point(raw)
        with self._lock:
            if len(self._pk_cache) >= self._pk_cache_cap:
                self._pk_cache.clear()
            self._pk_cache[raw] = pt
        return pt

    def hash_rows(self, msgs: List[bytes]):
        """Messages -> their G2 points: hash_to_field on the host for the
        distinct ones, then one map launch."""
        uniq: Dict[bytes, int] = {}
        for m in msgs:
            uniq.setdefault(m, len(uniq))
        pts = self.engine.map_rows([ref.hash_to_field_fp2(m, ref.DST_SIG, 2) for m in uniq])
        self.counters["device_maps"] += len(uniq)
        return [pts[uniq[m]] for m in msgs]

    def decode_rows(self, pubkeys, msgs, sigs, msg_lens=None):
        """Host decoding: [(row, pk point, message, sig point)] for the
        rows whose pubkey and signature decode."""
        pubkeys = np.asarray(pubkeys, dtype=np.uint8)
        msgs = np.asarray(msgs, dtype=np.uint8)
        sigs = np.asarray(sigs, dtype=np.uint8)
        rows = []
        for i in range(len(pubkeys)):
            pk = self.decode_pk(pubkeys[i].tobytes())
            if pk is None:
                continue
            sig = decode_signature(sigs[i].tobytes())
            if sig is None:
                continue
            m = msgs[i].tobytes()
            if msg_lens is not None:
                m = m[: int(msg_lens[i])]
            rows.append((i, pk, m, sig))
        return rows

    def verify_rows(self, rows) -> np.ndarray:
        """Decoded rows -> their verdicts: one map and one pairing launch."""
        if not rows:
            return np.zeros(0, dtype=bool)
        hms = self.hash_rows([r[2] for r in rows])
        self.counters["device_rows"] += len(rows)
        return self.engine.verify_rows([(r[1], hm, r[3]) for r, hm in zip(rows, hms)])

    def verify_batch(self, pubkeys, msgs, sigs, msg_lens=None) -> np.ndarray:
        n = len(pubkeys)
        out = np.zeros(n, dtype=bool)
        self.counters["rows"] += n
        rows = self.decode_rows(pubkeys, msgs, sigs, msg_lens)
        ok = self.verify_rows(rows)
        for (i, *_), v in zip(rows, ok):
            out[i] = bool(v)
        return out

    def verify_commit_batch(self, pubkeys, msgs, sigs, powers, counted):
        ok = self.verify_batch(pubkeys, msgs, sigs)
        talled = int(np.sum(np.where(ok & np.asarray(counted, dtype=bool), np.asarray(powers), 0)))
        return ok, talled

    # -- the aggregate path ----------------------------------------------------

    def aggregate_pubkey(self, pk_table: Sequence[bytes], mask: np.ndarray):
        """The sum of the selected pubkeys: 48-byte rows and a bool mask ->
        a G1 point, or None for an empty selection, a selected row that does
        not decode, or a sum at infinity. One aggregate launch."""
        mask = np.asarray(mask, dtype=bool)
        pts = [self.decode_pk(bytes(raw)) for raw in pk_table]
        sel = [i for i in range(len(pts)) if i < len(mask) and mask[i]]
        if not sel or any(pts[i] is None for i in sel):
            return None
        m = np.zeros((1, len(pts)), dtype=bool)
        m[0, : len(mask)] = mask[: len(pts)]
        # an invalid row holds the generator, never selected
        agg = self.engine.aggregate([pt if pt is not None else ref.G1_GEN for pt in pts], m)
        self.counters["device_aggregates"] += 1
        return agg[0]

    def verify_aggregate(self, pk_table: Sequence[bytes], mask: np.ndarray, msg: bytes, agg_sig: bytes) -> bool:
        """One-message aggregate check e(sum pk_i, H(msg)) == e(G1, sig):
        the aggregated-commit core."""
        self.counters["aggregate_checks"] += 1
        apk = self.aggregate_pubkey(pk_table, mask)
        if apk is None:
            return False
        sig_pt = decode_signature(agg_sig)
        if sig_pt is None:
            return False
        return bool(self.verify_rows([(0, apk, msg, sig_pt)])[0])


# -- the default provider, one per device ----------------------------------------

_lock = threading.Lock()
_DEFAULT: Dict[str, BLSBatchVerifier] = {}


def get_default_bls_provider(device=None) -> BLSBatchVerifier:
    key = str(resolve_device(device))
    with _lock:
        v = _DEFAULT.get(key)
        if v is None:
            v = _DEFAULT[key] = BLSBatchVerifier(key)
        return v


def set_default_bls_provider(v: BLSBatchVerifier, device=None) -> None:
    with _lock:
        _DEFAULT[str(resolve_device(device))] = v


def make_bls_provider(device=None, router=None) -> BLSBatchVerifier:
    """A BLS provider on `device` (None: the card) whose pairing checks
    split over `router`'s devices (``models/bls.BLSEngine``)."""
    return BLSBatchVerifier(device, router=router)
