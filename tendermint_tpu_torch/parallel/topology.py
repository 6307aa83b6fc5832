"""DeviceTopology + MeshRouter: which devices serve a bundle of rows.

The port's copy of the JAX package's ``parallel/topology.py``, with the
same semantics line for line:

- :class:`DeviceTopology`: the device inventory, one
  :class:`~tendermint_tpu_torch.utils.watchdog.CircuitBreaker` a device
  (``mesh.device<i>``). ``discover`` lists the visible CUDA devices;
  ``logical(n)`` makes n host lanes without placement. A topology may
  list one device more than once (``DeviceTopology(["cuda:0"] * 2)``,
  ``DeviceTopology(["cpu"] * 3)``): ``discover`` never does, but that is
  how the placed path runs on one card, or on the CPU in tests, with
  every lane a placement of its own.
- :class:`MeshRouter`: shard sizing (rows padded to a device multiple by
  :func:`pad_to_multiple`, the last chunk short, empty chunks dropped),
  per-device breaker admission with half-open probe tokens, and the
  rule that a bundle under ``min_rows``, or fewer than two admitted
  devices, takes the engine's single-device path. A failing device is
  shed from the next bundle's plan; the half-open probe re-admits it.

Every engine keeps the fall-through contract: a failed routed call is
answered by the engine's unrouted path on its own device, with
bit-identical results (the port's unrouted path is the same kernels,
never the host).

Not copied: the ``trace.instant`` events and the ``mesh.shard`` chaos
site; the counters in ``stats`` carry the same facts. ``jax_mesh``
becomes :meth:`MeshRouter.device_mesh`.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

from tendermint_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from tendermint_tpu_torch.utils.watchdog import CircuitBreaker


class DeviceTopology:
    """The device inventory plus one breaker per device.

    ``devices`` holds ``torch.device``s (anything ``torch.device`` takes)
    for a placed topology, or ``None`` placeholders for a *logical* one:
    N host lanes with the router's and breakers' semantics but no device
    placement (``MeshRoutedVerifier`` over any inner verifier)."""

    def __init__(self, devices: Sequence, platform: str = "host"):
        if not devices:
            raise ValueError("DeviceTopology needs at least one device")
        self.devices = [None if d is None else torch.device(d) for d in devices]
        self.platform = platform
        self.breakers: List[CircuitBreaker] = [CircuitBreaker(f"mesh.device{i}") for i in range(len(self.devices))]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def has_placement(self) -> bool:
        """True when shards can be committed to real devices."""
        return self.devices[0] is not None

    @classmethod
    def discover(cls, max_devices: int = 0) -> Optional["DeviceTopology"]:
        """Topology over the visible CUDA devices, ``cuda:0`` ..
        ``cuda:{n-1}`` (None without CUDA). ``max_devices`` > 0 caps the
        inventory."""
        try:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        except Exception:
            return None
        if not n:
            return None
        if max_devices and max_devices > 0:
            n = min(n, max_devices)
        return cls([torch.device("cuda", i) for i in range(n)], platform="gpu")

    @classmethod
    def logical(cls, n: int) -> "DeviceTopology":
        """N host lanes: router semantics without device placement."""
        return cls([None] * n, platform="logical")


class Slot:
    """One device's share of a bundle: rows ``[lo, hi)`` on device
    ``device`` (topology index ``index``). ``probe`` marks that this
    slot's admission consumed the breaker's half-open probe token."""

    __slots__ = ("index", "device", "lo", "hi", "probe")

    def __init__(self, index: int, device, lo: int, hi: int, probe: bool):
        self.index = index
        self.device = device
        self.lo = lo
        self.hi = hi
        self.probe = probe

    @property
    def rows(self) -> int:
        return self.hi - self.lo


class ShardPlan:
    """The router's verdict for one bundle. ``collective`` False means
    take the engine's single-device path unchanged (the sub-threshold,
    one-device or all-shed route)."""

    __slots__ = ("n", "slots", "collective")

    def __init__(self, n: int, slots: List[Slot], collective: bool):
        self.n = n
        self.slots = slots
        self.collective = collective


class MeshRouter:
    """Admission, shard sizing and per-device breaker bookkeeping.

    Engines call :meth:`plan` per bundle and, when the plan is
    collective, dispatch one chunk per slot via :meth:`run` (chunked
    engines) or the whole bundle via :meth:`run_collective` (the sharded
    ``VerifierModel``, one call over every slot). A failure records
    against the owning breaker(s) and the engine falls through to its
    unrouted path for that bundle; the next :meth:`plan` re-shards
    across the survivors."""

    def __init__(self, topology: DeviceTopology, min_rows: int = 256, logger=None):
        self.topology = topology
        self.min_rows = max(1, int(min_rows))
        self.logger = logger
        self._lock = threading.Lock()
        self._admitted: tuple = tuple(range(len(topology)))
        self._device_rows = [0] * len(topology)
        self._collective_bundles = 0
        self._single_bundles = 0
        self._shard_failures = 0
        self._sheds = 0
        self._readmits = 0
        self._imbalance = 0.0

    # -- admission --------------------------------------------------------

    def plan(self, n_rows: int, min_rows: Optional[int] = None) -> ShardPlan:
        """Shard ``n_rows`` across the admitted devices.

        Sub-``min_rows`` bundles never touch the breakers (no probe
        tokens consumed) and get a non-collective plan, as does a
        topology with fewer than two admitted devices: the engine's own
        single-device path is the one-device route. ``min_rows``
        overrides the router default for engines whose rows cost far
        more than an ed25519 row (a BLS pairing)."""
        n = int(n_rows)
        floor = self.min_rows if min_rows is None else max(1, int(min_rows))
        with self._lock:
            if n < floor or len(self.topology) < 2:
                self._single_bundles += 1
                return ShardPlan(n, [], collective=False)
            admitted: List[int] = []
            probes: List[bool] = []
            for i, b in enumerate(self.topology.breakers):
                was_open = b.state() == "open"
                if b.allow():
                    admitted.append(i)
                    probes.append(was_open)
            self._note_admitted(tuple(admitted))
            if len(admitted) < 2:
                # no collective: hand back any probe token taken but not
                # exercised (only the holder releases)
                for i, probed in zip(admitted, probes):
                    if probed:
                        self.topology.breakers[i].release_probe()
                self._single_bundles += 1
                return ShardPlan(n, [], collective=False)
            chunk = pad_to_multiple(n, len(admitted)) // len(admitted)
            slots: List[Slot] = []
            for k, (i, probed) in enumerate(zip(admitted, probes)):
                lo = k * chunk
                hi = min(n, lo + chunk)
                if lo >= hi:
                    if probed:
                        self.topology.breakers[i].release_probe()
                    continue
                slots.append(Slot(i, self.topology.devices[i], lo, hi, probed))
                self._device_rows[i] += hi - lo
            if len(slots) < 2:
                for s in slots:
                    if s.probe:
                        self.topology.breakers[s.index].release_probe()
                self._single_bundles += 1
                return ShardPlan(n, [], collective=False)
            self._collective_bundles += 1
            rows = [s.rows for s in slots]
            self._imbalance = (max(rows) - min(rows)) / float(chunk)
        return ShardPlan(n, slots, collective=True)

    def _note_admitted(self, admitted: tuple) -> None:
        # lock held
        prev = set(self._admitted)
        cur = set(admitted)
        shed = prev - cur
        back = cur - prev
        if shed:
            self._sheds += len(shed)
            if self.logger:
                self.logger.info("mesh shed device(s) %s; %d admitted", sorted(shed), len(cur))
        if back:
            self._readmits += len(back)
            if self.logger:
                self.logger.info("mesh re-admitted device(s) %s; %d admitted", sorted(back), len(cur))
        self._admitted = admitted

    # -- bundle lifecycle -------------------------------------------------

    def complete(self, plan: ShardPlan) -> None:
        """Every slot served its chunk: close (or heal) the breakers."""
        for s in plan.slots:
            self.topology.breakers[s.index].record_success()

    def fail(self, plan: ShardPlan, failed_pos: Optional[int] = None) -> None:
        """A collective bundle failed.

        ``failed_pos`` names the slot whose dispatch raised (chunked
        engines attribute precisely); None means the failure surfaced at
        combine time and every participant is blamed, as for one sharded
        call."""
        with self._lock:
            self._shard_failures += 1
        for pos, s in enumerate(plan.slots):
            b = self.topology.breakers[s.index]
            if failed_pos is None or pos == failed_pos:
                b.record_failure()
            elif pos < failed_pos:
                # dispatched fine before the failure: the device worked
                b.record_success()
            elif s.probe:
                # never exercised: return the half-open probe token
                b.release_probe()

    def release(self, plan: ShardPlan) -> None:
        """The caller abandoned the plan before dispatch (no placed
        engine for it): return unexercised probe tokens."""
        for s in plan.slots:
            if s.probe:
                self.topology.breakers[s.index].release_probe()

    def run(self, plan: ShardPlan, dispatch: Callable, combine: Callable):
        """Chunked dispatch: ``dispatch(slot)`` once per slot (device
        engines launch there and return device tensors), then
        ``combine(outs)`` reads them back. The breaker bookkeeping lives
        here so every engine shares one code path."""
        outs = []
        done = 0
        try:
            for s in plan.slots:
                outs.append(dispatch(s))
                done += 1
            res = combine(outs)
        except Exception:
            self.fail(plan, done if done < len(plan.slots) else None)
            raise
        self.complete(plan)
        return res

    def run_collective(self, plan: ShardPlan, thunk: Callable):
        """One call spanning every slot (the sharded ``VerifierModel``).
        A failure is not attributed to one device, so every participant
        records it; the cohort probes back in together after cooldown."""
        try:
            res = thunk()
        except Exception:
            self.fail(plan, None)
            raise
        self.complete(plan)
        return res

    # -- the sharded verifier's mesh ---------------------------------------

    def device_mesh(self, plan: ShardPlan):
        """The plan's devices, in slot order, as a mesh
        (``parallel.mesh.make_mesh``); None for a logical topology or a
        non-collective plan. Callers cache what they build on it by
        :meth:`mesh_key`."""
        if not self.topology.has_placement or not plan.collective:
            return None
        return make_mesh([s.device for s in plan.slots])

    @staticmethod
    def mesh_key(plan: ShardPlan) -> tuple:
        return tuple(s.index for s in plan.slots)

    # -- telemetry --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "devices": len(self.topology),
                "platform": self.topology.platform,
                "admitted": len(self._admitted),
                "min_rows": self.min_rows,
                "collective_bundles": self._collective_bundles,
                "single_bundles": self._single_bundles,
                "shard_failures": self._shard_failures,
                "sheds": self._sheds,
                "readmits": self._readmits,
                "shard_imbalance": self._imbalance,
                "device_rows": list(self._device_rows),
                "breakers": [b.stats() for b in self.topology.breakers],
            }
