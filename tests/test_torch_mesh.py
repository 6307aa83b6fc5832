"""The port's routed engines on the CPU, against their unrouted calls and
the JAX package's routed CPU provider.

Two routes, each over k lanes for k in (2, 3, 8):

- placed lanes: ``TorchBatchVerifier("cpu", router=MeshRouter(
  DeviceTopology(["cpu"] * k)))``, whose collective bundles run on a
  ``VerifierModel`` over a mesh of k CPU devices (the counterpart of the
  JAX package's ``shard_map`` verifier, the tally summed on the host);
- logical lanes: ``MeshRoutedVerifier(TorchBatchVerifier("cpu"),
  MeshRouter(DeviceTopology.logical(k)))``, one inner call a chunk.

Both run the kernels' plain versions chunk by chunk. A batch of 17 rows
over 16 keys, uneven for every k, carries a bad row in every shard, an
uncounted row and non-uniform powers (as ``tests/test_mesh_parity.py``);
the verdicts and tallies of every seam must equal the unrouted ones, and
``verify_batch``/``verify_commit_batch`` also the JAX package's
``MeshRoutedVerifier(CPUBatchVerifier(), ...)`` on logical lanes. The
slice as a whole: ``ValidatorSet.verify_commit`` and
``verify_commit_trusting`` with a routed default provider against the
JAX package's ``ValidatorSet`` with its routed CPU provider. No JAX
program is jitted and no JAX mesh is built.
"""

from fractions import Fraction

import numpy as np
import pytest

from test_torch_verify_commit_tabled import (  # noqa: F401  (sets is a fixture)
    CHAIN,
    HEIGHT,
    _block_id,
    _early_b_rows,
    _flags,
    make_commit,
    outcome,
    port_commit,
    sets,
)
from tendermint_tpu.crypto import batch as jax_batch
from tendermint_tpu.crypto.keys import Ed25519PrivKey
from tendermint_tpu.parallel import DeviceTopology as JaxTopology
from tendermint_tpu.parallel import MeshRouter as JaxRouter
from tendermint_tpu_torch import (
    DeviceTopology,
    MerkleHasher,
    MeshRoutedVerifier,
    MeshRouter,
    TorchBatchVerifier,
    get_default_provider,
    make_provider,
    set_default_provider,
)
from tendermint_tpu_torch.codec.signbytes import TIMESTAMP_OFFSET
from tendermint_tpu_torch.crypto import merkle as port_merkle
from tendermint_tpu_torch.crypto.batch import CPUBatchVerifier
from tendermint_tpu_torch.models import hasher as port_hasher
from tendermint_tpu_torch.models import verifier as port_verifier
from tendermint_tpu_torch.models.bls import BLSEngine
from tendermint_tpu_torch.ops import ed25519 as ted

N = 17  # uneven for every k; over 8 lanes, chunks of 3 fill 6 and leave 2 empty
N_KEYS = 16
MSG_LEN = 160  # a vote's sign-bytes width
# One row or more in each shard for k = 8 (chunks of 3), 3 (6) and 2 (9).
BAD = (0, 4, 8, 9, 13, 16)
KS = (2, 3, 8)
ROUTES = ("placed", "logical")
SEAMS = ("verify_batch", "verify_commit_batch", "verify_rows_cached", "verify_rows_cached_templated")
TS_OFF = TIMESTAMP_OFFSET  # where the templated seam splices each row's 8 bytes


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(37)
    keys = [Ed25519PrivKey.from_secret(f"mesh-key-{i}".encode()) for i in range(N_KEYS)]
    pks = np.stack([np.frombuffer(k.pub_key().bytes(), dtype=np.uint8) for k in keys])
    idx = (np.arange(N) * 5) % N_KEYS  # every key, one twice, in a scattered order
    msgs = rng.integers(0, 256, (N, MSG_LEN), dtype=np.uint8)
    sigs = np.stack([np.frombuffer(keys[v].sign(msgs[r].tobytes()), dtype=np.uint8) for r, v in enumerate(idx)])
    for r in BAD:
        sigs[r, (r * 7) % 64] ^= 0x10
    powers = rng.integers(1, 1 << 40, N).astype(np.int64)
    counted = np.ones(N, dtype=bool)
    counted[3] = False  # an uncounted (nil-vote) row
    templates = msgs.copy()
    templates[:, TS_OFF:TS_OFF + 8] = 0
    return dict(pks=pks, idx=idx, rows_pk=pks[idx], msgs=msgs, sigs=sigs, powers=powers, counted=counted,
                templates=templates, tmpl_idx=np.arange(N), ts8=msgs[:, TS_OFF:TS_OFF + 8].copy())


def call(provider, seam, b):
    """One seam of `provider` on the batch."""
    if seam == "verify_batch":
        return provider.verify_batch(b["rows_pk"], b["msgs"], b["sigs"])
    if seam == "verify_commit_batch":
        return provider.verify_commit_batch(b["rows_pk"], b["msgs"], b["sigs"], b["powers"], b["counted"])
    if seam == "verify_rows_cached":
        return provider.verify_rows_cached(b"mesh-set", b["pks"], b["idx"], b["msgs"], b["sigs"])
    return provider.verify_rows_cached_templated(b"mesh-set", b["pks"], b["idx"], b["templates"], b["tmpl_idx"],
                                                 b["ts8"], b["sigs"])


# One unrouted provider, and one routed provider a (route, k), for the
# whole module: the set's tables are built once on each (a plain table
# build is most of a tabled call's time here).
_UNROUTED = {}
_ROUTED = {}


def unrouted(seam, b):
    if seam not in _UNROUTED:
        provider = _UNROUTED.setdefault("provider", TorchBatchVerifier("cpu"))
        _UNROUTED[seam] = call(provider, seam, b)
    return _UNROUTED[seam]


def routed(route, k, min_rows=4):
    """(provider, router) for a route over k lanes."""
    if route == "placed":
        r = MeshRouter(DeviceTopology(["cpu"] * k), min_rows=min_rows)
        return TorchBatchVerifier("cpu", router=r), r
    r = MeshRouter(DeviceTopology.logical(k), min_rows=min_rows)
    return MeshRoutedVerifier(TorchBatchVerifier("cpu"), r), r


def shared_routed(route, k):
    if (route, k) not in _ROUTED:
        _ROUTED[route, k] = routed(route, k)
    return _ROUTED[route, k]


def chunk_sizes(k, n=N):
    c = -(-n // k)
    return [min(n, lo + c) - lo for lo in range(0, n, c)]


@pytest.mark.parametrize("seam", SEAMS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", KS)
def test_routed_seams_equal_unrouted(batch, monkeypatch, k, route, seam):
    want = unrouted(seam, batch)
    provider, r = shared_routed(route, k)
    before = r.stats()
    seen = []  # the rows of each launch of the verifier's last stage
    finish = ted.verify_stage_finish
    monkeypatch.setattr(ted, "verify_stage_finish", lambda point, *a, **kw: seen.append(point.shape[0])
                        or finish(point, *a, **kw))
    got = call(provider, seam, batch)
    ok_got, ok_want = (got[0], want[0]) if seam == "verify_commit_batch" else (got, want)
    np.testing.assert_array_equal(ok_got, ok_want)
    np.testing.assert_array_equal(np.flatnonzero(~ok_got), BAD)
    if seam == "verify_commit_batch":
        assert got[1] == want[1] == int(batch["powers"][ok_want & batch["counted"]].sum())
    assert seen == chunk_sizes(k)  # one chunk a lane, every lane's rows
    st = r.stats()
    rows = [a - b for a, b in zip(st["device_rows"], before["device_rows"])]
    assert st["collective_bundles"] == before["collective_bundles"] + 1 and st["shard_failures"] == 0
    assert rows == chunk_sizes(k) + [0] * (k - len(chunk_sizes(k)))
    if seam in ("verify_batch", "verify_commit_batch"):
        jr = JaxRouter(JaxTopology.logical(k), min_rows=4)
        jax_got = call(jax_batch.MeshRoutedVerifier(jax_batch.CPUBatchVerifier(), jr), seam, batch)
        if seam == "verify_commit_batch":
            np.testing.assert_array_equal(ok_got, jax_got[0])
            assert got[1] == jax_got[1]
        else:
            np.testing.assert_array_equal(ok_got, jax_got)
        assert jr.stats()["device_rows"] == rows


def test_chunks_past_the_first_upload_their_row_index(batch, monkeypatch):
    """Rows 0..n-1 of a full set need no index on the device; a chunk
    that starts at validator lo > 0 does, and must read its own rows."""
    keys = [Ed25519PrivKey.from_secret(f"mesh-full-{i}".encode()) for i in range(12)]
    pks = np.stack([np.frombuffer(k.pub_key().bytes(), dtype=np.uint8) for k in keys])
    msgs = batch["msgs"][:12]
    sigs = np.stack([np.frombuffer(k.sign(m.tobytes()), dtype=np.uint8) for k, m in zip(keys, msgs)])
    sigs[9, 0] ^= 1
    idxs = []
    tabled = ted.verify_tabled
    monkeypatch.setattr(port_verifier.ed25519, "verify_tabled",
                        lambda *a, **kw: idxs.append(kw.get("idx")) or tabled(*a, **kw))
    model = port_verifier.VerifierModel("cpu", mesh=["cpu", "cpu"])
    ok = model.verify_rows_cached(b"full-set", pks, np.arange(12), msgs, sigs)
    np.testing.assert_array_equal(ok, np.arange(12) != 9)
    assert idxs[0] is None and idxs[1].tolist() == list(range(6, 12))


def test_verify_commit_through_a_routed_default_provider_matches_jax(sets):
    """The slice as a whole: the port's ValidatorSet with a routed
    TorchBatchVerifier set as the CPU's default provider, against the
    JAX package's ValidatorSet with its routed CPU provider. The bad
    row before quorum lies in the second lane's chunk."""
    a, b, by_addr, pa, pb = sets
    r = MeshRouter(DeviceTopology(["cpu"] * 2), min_rows=8)
    jr = JaxRouter(JaxTopology.logical(2), min_rows=8)
    jax_provider = jax_batch.MeshRoutedVerifier(jax_batch.CPUBatchVerifier(), jr)
    flags = _flags(58, 3, 3)
    (r0, r1, r2), last = _early_b_rows(b, make_commit(a, by_addr, flags), 3)
    full = {"good": {}, "bad_row_in_second_lane_before_quorum": dict(bad=(35,)), "bad_row_after_quorum": dict(bad=(57,)),
            "too_little_power": dict(flags=_flags(30, 14, 20))}
    trusting = {"good": {}, "bad_row_before_quorum": dict(bad=(r1,)), "duplicate_before_quorum": dict(dup=((r0, r2),)),
                "trust_level_one": {}}
    prev = get_default_provider("cpu")
    set_default_provider(make_provider("cuda", router=r, device="cpu"), device="cpu")
    try:
        seen = []
        for case, kw in full.items():
            commit = make_commit(a, by_addr, kw.pop("flags", flags), **kw)
            pc = port_commit(commit, by_addr)
            want = outcome(lambda: a.verify_commit(CHAIN, _block_id(), HEIGHT, commit, provider=jax_provider))
            got = outcome(lambda: pa.verify_commit(CHAIN, pc.block_id, HEIGHT, pc, device="cpu"))
            assert got == want, case
            seen.append(got[0])
        for case, kw in trusting.items():
            level = Fraction(1, 1) if case == "trust_level_one" else Fraction(1, 3)
            commit = make_commit(a, by_addr, flags, **kw)
            pc = port_commit(commit, by_addr)
            want = outcome(lambda: b.verify_commit_trusting(CHAIN, _block_id(), HEIGHT, commit, level,
                                                            provider=jax_provider))
            got = outcome(lambda: pb.verify_commit_trusting(CHAIN, pc.block_id, HEIGHT, pc, level, device="cpu"))
            assert got == want, case
            seen.append(got[0])
    finally:
        set_default_provider(prev, device="cpu")
    assert seen == ["ok", "ErrInvalidCommitSignature", "ok", "ErrNotEnoughVotingPower",
                    "ok", "ErrInvalidCommitSignature", "ErrInvalidCommit", "ErrNotEnoughVotingPower"]
    st = r.stats()
    assert st["collective_bundles"] == 8 and st["shard_failures"] == 0  # every call, on two lanes
    assert get_default_provider("cpu") is prev


def test_sharded_valset_cap_divides_by_mesh_size(monkeypatch):
    monkeypatch.setattr(port_verifier, "MAX_SHARDED_VALSET", 1 << 10)
    assert port_verifier.VerifierModel("cpu").sharded_valset_cap() == 1 << 10
    assert port_verifier.VerifierModel("cpu", mesh=["cpu"] * 8).sharded_valset_cap() == (1 << 10) // 8


def test_tables_entry_honors_per_device_cap(monkeypatch):
    """At the boundary: a set over the per-device cap declines the tabled
    path on a mesh model (the generic path takes over) while the same set
    still tables on the single-device model."""
    monkeypatch.setattr(port_verifier, "MAX_TABLED_VALSET", 8)
    monkeypatch.setattr(port_verifier, "MAX_SHARDED_VALSET", 128)
    built = []
    monkeypatch.setattr(port_verifier.VerifierModel, "_tables_on",
                        lambda self, key, pks, dev: built.append((key, str(dev))) or object())
    meshed = port_verifier.VerifierModel("cpu", mesh=["cpu"] * 8)  # per-device cap 128 // 8 = 16
    plain = port_verifier.VerifierModel("cpu")
    pk_over = np.zeros((17, 32), dtype=np.uint8)
    pk_at = np.zeros((16, 32), dtype=np.uint8)
    assert meshed.tables_entry(b"over", pk_over) is None
    assert plain.tables_entry(b"over", pk_over) is not None
    assert meshed.tables_entry(b"at", pk_at) is not None
    assert built == [(b"over", "cpu"), (b"at", "cpu")]  # one build a distinct device


def test_register_valset_builds_on_every_device_and_warmup_runs(batch):
    """register_valset builds the set's tables now, once a distinct
    device, and a meshed model made later gets the known sets."""
    provider, r = routed("placed", 2)
    provider.register_valset(b"mesh-set", batch["pks"])
    assert list(provider.model._valset_tables) == [(b"mesh-set", "cpu")]
    call(provider, "verify_rows_cached", batch)
    (meshed,) = provider._mesh_models.values()
    assert list(meshed._valset_tables) == [(b"mesh-set", "cpu")]
    assert meshed.mesh == tuple(DeviceTopology(["cpu"] * 2).devices)
    meshed.warmup()


class FailSecondLane(TorchBatchVerifier):
    """A provider whose second call raises: a lane that goes down."""

    calls = 0

    def verify_commit_batch(self, *a):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("lane down")
        return super().verify_commit_batch(*a)


def _breakers(k):
    from tendermint_tpu_torch.utils.watchdog import CircuitBreaker

    return [CircuitBreaker(f"mesh.device{i}", failure_threshold=1, cooldown_s=3600.0) for i in range(k)]


@pytest.mark.parametrize("route", ROUTES)
def test_a_lane_that_raises_trips_its_breaker_and_the_answer_holds(batch, monkeypatch, route):
    b = batch
    want = unrouted("verify_commit_batch", b)
    if route == "logical":
        r = MeshRouter(DeviceTopology.logical(3), min_rows=4)
        r.topology.breakers = _breakers(3)
        provider = MeshRoutedVerifier(FailSecondLane("cpu"), r)
    else:
        r = MeshRouter(DeviceTopology(["cpu"] * 3), min_rows=4)
        r.topology.breakers = _breakers(3)
        provider = TorchBatchVerifier("cpu", router=r)
        unmeshed = port_verifier.VerifierModel.verify_commit

        def flaky(model, *a):
            if model.mesh is not None:
                raise RuntimeError("mesh down")
            return unmeshed(model, *a)

        monkeypatch.setattr(port_verifier.VerifierModel, "verify_commit", flaky)
    got = provider.verify_commit_batch(b["rows_pk"], b["msgs"], b["sigs"], b["powers"], b["counted"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    st = r.stats()
    assert st["shard_failures"] == 1
    # the logical lane that raised is blamed alone; one sharded call, all of it
    want_states = ["closed", "open", "closed"] if route == "logical" else ["open"] * 3
    assert [bk["state"] for bk in st["breakers"]] == want_states
    nxt = r.plan(N)
    if route == "logical":
        assert [s.index for s in nxt.slots] == [0, 2]
    else:
        assert not nxt.collective


@pytest.mark.parametrize("leaves", (2, 3, 129))
def test_routed_merkle_hasher_equals_unrouted_and_hashlib(monkeypatch, leaves):
    rng = np.random.default_rng(leaves)
    items = [rng.bytes(int(n)) for n in rng.choice([0, 11, 55, 56, 95, 200], leaves)]
    r = MeshRouter(DeviceTopology(["cpu"] * 3), min_rows=2)
    routed_h = MerkleHasher("cpu", router=r)
    plain_h = MerkleHasher("cpu")
    want = port_hasher.host_levels([port_merkle.leaf_hash(it) for it in items])
    assert routed_h.tree(items) == plain_h.tree(items) == want
    assert routed_h.root(items) == want[-1][0]
    st = r.stats()
    assert st["collective_bundles"] == 2 and st["shard_failures"] == 0
    assert sum(st["device_rows"]) == 2 * leaves
    monkeypatch.setattr(port_merkle, "DEVICE_THRESHOLD", 2)
    port_merkle.configure_device(router=r)
    try:
        root, proofs = port_merkle.proofs_from_byte_slices(items, device="cpu")
    finally:
        port_merkle.configure_device(router=None)
    assert root == want[-1][0] and r.stats()["collective_bundles"] == 3
    for it, p in zip(items, proofs):
        p.verify(root, it)


def test_bls_engine_declines_on_one_device_before_any_work():
    """With one device the plan is not collective: _mesh_verify answers
    None before it reads a row, and verify_rows is the unrouted path."""
    r = MeshRouter(DeviceTopology(["cpu"]), min_rows=1)
    eng = BLSEngine("cpu", router=r)
    assert eng._mesh_verify([(None, None, None)] * 16) is None
    assert r.stats()["collective_bundles"] == 0
    logical = BLSEngine("cpu", router=MeshRouter(DeviceTopology.logical(2), min_rows=1))
    assert logical._mesh_verify([(None, None, None)] * 16) is None  # no placement


def test_bls_engine_on_two_placed_lanes():
    """Eight pairing rows (the engine's MESH_MIN_ROWS) over two placed
    CPU lanes, a bad signature in each lane: one plain pairing call a
    lane, verdicts identical to the unrouted call and to the truth."""
    from tendermint_tpu_torch.ops import ref_bls12 as B

    n = BLSEngine.MESH_MIN_ROWS
    sks = [B.keygen(b"mesh-%d" % i) for i in range(n)]
    hms = [B.hash_to_curve_g2(b"mesh-msg-%d" % i, B.DST_SIG) for i in range(n)]
    sigs = [B.g2_mul(s, h) for s, h in zip(sks, hms)]
    bad = (2, 6)
    for i in bad:
        sigs[i] = B.g2_mul(12345 + i, B.G2_GEN)
    rows = list(zip([B.sk_to_pk(s) for s in sks], hms, sigs))
    r = MeshRouter(DeviceTopology(["cpu"] * 2), min_rows=256)
    ok = BLSEngine("cpu", router=r).verify_rows(rows)
    assert ok.tolist() == [i not in bad for i in range(n)]
    assert ok.tolist() == BLSEngine("cpu").verify_rows(rows).tolist()
    st = r.stats()
    assert st["collective_bundles"] == 1 and st["device_rows"] == [4, 4] and st["shard_failures"] == 0


def test_providers_by_name():
    assert isinstance(make_provider("cpu"), CPUBatchVerifier)
    assert isinstance(make_provider("cuda", device="cpu"), TorchBatchVerifier)
    with pytest.raises(ValueError):
        make_provider("tpu")
    b_rows = np.zeros((2, 32), dtype=np.uint8)
    assert make_provider("cpu").verify_batch(b_rows, np.zeros((2, 4), dtype=np.uint8),
                                             np.zeros((2, 64), dtype=np.uint8)).tolist() == [False, False]


def test_cpu_provider_equals_the_jax_cpu_provider(batch):
    b = batch
    got = CPUBatchVerifier().verify_commit_batch(b["rows_pk"], b["msgs"], b["sigs"], b["powers"], b["counted"])
    want = jax_batch.CPUBatchVerifier().verify_commit_batch(b["rows_pk"], b["msgs"], b["sigs"], b["powers"],
                                                            b["counted"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
