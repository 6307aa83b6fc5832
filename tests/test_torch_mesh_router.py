"""The port's mesh router against the JAX package's, on host lanes.

``tendermint_tpu_torch.parallel`` (``DeviceTopology``, ``MeshRouter``)
and ``utils.watchdog.CircuitBreaker`` are copies of the JAX package's
``parallel/topology.py`` and its breaker. Neither side needs a device
here: each case below is one script, run once over the JAX package's
classes and once over the port's, on logical lanes with deterministic
breakers (one failure trips; a cooldown of 3600 s, "never within the
test", or 0). There is a case for each router test of
``tests/test_mesh_router.py``; each must give the same slots
(index, lo, hi, probe), the same values back from ``run``, the same
breaker states and the same ``stats()`` on both sides. Breakers are
tripped with ``record_failure`` (the port does not copy ``force_open``).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu import parallel as jax_parallel
from tendermint_tpu.utils.watchdog import CircuitBreaker as JaxBreaker
from tendermint_tpu_torch import parallel as port_parallel
from tendermint_tpu_torch.utils.watchdog import CircuitBreaker as PortBreaker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "jax": SimpleNamespace(
        DeviceTopology=jax_parallel.DeviceTopology, MeshRouter=jax_parallel.MeshRouter,
        breaker=lambda name, t, c: JaxBreaker(name, failure_threshold=t, cooldown_s=c, register=False)),
    "port": SimpleNamespace(
        DeviceTopology=port_parallel.DeviceTopology, MeshRouter=port_parallel.MeshRouter,
        breaker=lambda name, t, c: PortBreaker(name, failure_threshold=t, cooldown_s=c)),
}


def _router(ns, n=4, min_rows=4, threshold=1, cooldown=3600.0):
    topo = ns.DeviceTopology.logical(n)
    topo.breakers = [ns.breaker(f"mesh.device{i}", threshold, cooldown) for i in range(n)]
    return ns.MeshRouter(topo, min_rows=min_rows)


def _plan(plan):
    return plan.n, plan.collective, [(s.index, s.lo, s.hi, s.probe) for s in plan.slots]


def _states(r):
    return [b.state() for b in r.topology.breakers]


def _rows(s):
    return np.arange(s.lo, s.hi)


def _run(r, plan, fail_index=None):
    """router.run over the plan: the rows back in order, or the error."""
    def dispatch(s):
        if s.index == fail_index:
            raise RuntimeError(f"lane {s.index} down")
        return _rows(s)

    try:
        return r.run(plan, dispatch, np.concatenate).tolist()
    except RuntimeError as e:
        return str(e)


def case_sub_threshold(ns, log):
    r = _router(ns, min_rows=256)
    log += [_plan(r.plan(255)), _plan(r.plan(256))]
    return r


def case_sub_threshold_never_touches_breakers(ns, log):
    r = _router(ns, min_rows=64, cooldown=0.0)
    r.topology.breakers[1].record_failure()
    for _ in range(5):
        log.append(_plan(r.plan(8)))
    log.append(_states(r))  # the probe token is still there
    plan = r.plan(64)
    log += [_plan(plan), [s.index for s in plan.slots if s.probe]]
    return r


def case_one_device(ns, log):
    r = ns.MeshRouter(ns.DeviceTopology.logical(1), min_rows=1)
    log.append(_plan(r.plan(100_000)))
    return r


def case_min_rows_override(ns, log):
    r = _router(ns, min_rows=256)
    log += [_plan(r.plan(16)), _plan(r.plan(16, min_rows=8))]
    return r


def case_tripped_breaker_sheds(ns, log):
    r = _router(ns, n=4, min_rows=4)
    plan = r.plan(64)
    log += [_plan(plan), _run(r, plan)]
    r.topology.breakers[2].record_failure()  # device 2 goes sick
    plan = r.plan(64)  # the next bundle re-shards over the survivors
    log += [_plan(plan), _run(r, plan), _states(r)]
    return r


def case_all_shed(ns, log):
    r = _router(ns, n=2, min_rows=2)
    for b in r.topology.breakers:
        b.record_failure()
    log.append(_plan(r.plan(16)))
    return r


def case_half_open_probe_readmits(ns, log):
    r = _router(ns, n=4, min_rows=4)
    sick = r.topology.breakers[1]
    sick.record_failure()
    plan = r.plan(32)
    log += [_plan(plan), _run(r, plan)]
    sick._cooldown_s = 0.0  # the cooldown elapses: device 1 takes the probe
    plan = r.plan(32)
    log.append(_plan(plan))
    r.complete(plan)
    log.append(_states(r))
    return r


def case_failed_probe_reopens(ns, log):
    r = _router(ns, n=4, min_rows=4, cooldown=0.0)
    r.topology.breakers[3].record_failure()
    plan = r.plan(32)  # the probe admitted at once (cooldown 0)
    log += [_plan(plan), _run(r, plan, fail_index=3), _states(r)]
    return r


def case_failure_attribution(ns, log):
    r = _router(ns, n=4, min_rows=4)
    plan = r.plan(16)
    log += [_plan(plan), _run(r, plan, fail_index=1), _states(r)]
    # a failed collective call is blamed on every participant
    r2 = _router(ns, n=3, min_rows=4)
    plan = r2.plan(16)

    def boom():
        raise RuntimeError("collective down")

    with pytest.raises(RuntimeError):
        r2.run_collective(plan, boom)
    log += [_plan(plan), _states(r2), _stats(r2)]
    return r


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


def _stats(r):
    st = r.stats()
    assert st["breakers"] and all("state" in b for b in st["breakers"])
    return st


def drive(side, case):
    log = []
    r = CASES[case](SIDES[side], log)
    return log, _stats(r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_matches_jax(case):
    port = drive("port", case)
    assert port == drive("jax", case)
    log, st = port
    # the facts the JAX package's own test of each case checks
    if case == "sub_threshold":
        assert not log[0][1] and log[1][1] and st["single_bundles"] == 1 and st["collective_bundles"] == 1
    elif case == "sub_threshold_never_touches_breakers":
        assert log[5] == ["closed", "open", "closed", "closed"] and log[7] == [1]
    elif case == "one_device":
        assert not log[0][1] and st["collective_bundles"] == 0
    elif case == "min_rows_override":
        assert not log[0][1] and log[1][1]
    elif case == "tripped_breaker_sheds":
        assert log[1] == log[3] == list(range(64))
        assert [s[0] for s in log[2][2]] == [0, 1, 3]
        assert st["admitted"] == 3 and st["sheds"] == 1 and st["device_rows"][2] == 16
    elif case == "all_shed":
        assert not log[0][1] and st["admitted"] == 0 and st["collective_bundles"] == 0
    elif case == "half_open_probe_readmits":
        assert [s[0] for s in log[2][2]] == [0, 1, 2, 3] and [s[3] for s in log[2][2]] == [False, True, False, False]
        assert log[3] == ["closed"] * 4 and st["admitted"] == 4 and st["readmits"] == 1
    elif case == "failed_probe_reopens":
        assert log[1] == "lane 3 down" and log[2][3] == "open" and log[2][0] == "closed"
        assert st["shard_failures"] == 1
    elif case == "failure_attribution":
        assert log[2] == ["closed", "open", "closed", "closed"]
        assert log[4] == ["open"] * 3 and log[5]["shard_failures"] == 1


@pytest.mark.parametrize("k", range(2, 9))
def test_plans_match_jax_over_bundle_sizes(k):
    """Chunk sizing: pad_to_multiple(n, k) // k rows a slot, the last
    short, empty slots dropped, a plan of one slot not collective."""
    plans = {}
    for side, ns in SIDES.items():
        r = ns.MeshRouter(ns.DeviceTopology.logical(k), min_rows=1)
        plans[side] = [_plan(r.plan(n)) for n in range(1, 41)]
        plans[side].append(_stats(r))
    assert plans["port"] == plans["jax"]
    for n, (_n, collective, slots) in enumerate(plans["port"][:-1], start=1):
        if collective:
            assert [(lo, hi) for _i, lo, hi, _p in slots] == [
                (lo, min(n, lo + -(-n // k))) for lo in range(0, n, -(-n // k))]


def test_placed_topology_and_mesh():
    """A placed topology may list one device more than once; its plans
    are the logical ones, and device_mesh is the plan's devices."""
    r = port_parallel.MeshRouter(port_parallel.DeviceTopology(["cpu"] * 3), min_rows=1)
    j = jax_parallel.MeshRouter(jax_parallel.DeviceTopology.logical(3), min_rows=1)
    plan = r.plan(10)
    assert _plan(plan) == _plan(j.plan(10))
    assert r.topology.has_placement and r.device_mesh(plan) == tuple(port_parallel.make_mesh(["cpu"] * 3))
    assert r.mesh_key(plan) == (0, 1, 2)
    assert port_parallel.MeshRouter(port_parallel.DeviceTopology.logical(3)).device_mesh(plan) is None
    assert port_parallel.pad_to_multiple(37, 8) == jax_parallel.pad_to_multiple(37, 8) == 40


def test_parallel_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, tendermint_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tendermint_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
