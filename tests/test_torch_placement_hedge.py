"""The port's control plane of multi-host serving against the JAX package.

``repro_torch.index.placement`` and ``repro_torch.index.hedge`` are host
code copied from ``repro.index``. The same operations go through both
packages and must give equal answers: placements (assignments, replica
sets, owners) and their elastic changes (fail, recover, add and remove a
node) over the grid of ``tests/test_multihost.py::
test_placement_elasticity_property``; and the hedged executor under the
deterministic ``SimClock`` / ``ShardSim`` models (winning node, latency,
hedge and failover counters, hedged fraction, percentiles, and
``AllReplicasFailed``), in simulation, with real calls and over futures.
"""
import json
import random
from concurrent.futures import Future

import pytest

from repro.index import hedge as jax_hedge
from repro.index import placement as jax_placement

from repro_torch.index import hedge as torch_hedge
from repro_torch.index import placement as torch_placement

GRID = [(n, r) for n in (2, 3, 5, 8) for r in (1, 2, 3)]
SHARDS = (10, 37, 60)


def _answer(fn, *args):
    """fn's result, or the error it raises when every replica is down."""
    try:
        return fn(*args)
    except RuntimeError as e:
        return f"RuntimeError: {e}"


def _view(p, n_shards):
    """Everything a placement answers, as plain data."""
    covered = p.is_covered()
    return {"nodes": list(p.nodes), "live": p.live_nodes,
            "assignment": p.assignment() if covered else None,
            "replicas": p.replica_assignment(),
            "owners": [_answer(p.owner, s) for s in range(n_shards)],
            "covered": covered}


@pytest.mark.parametrize("n_nodes,replication", GRID)
def test_placement_equals_reference(n_nodes, replication):
    for n_shards in SHARDS:
        r = min(replication, n_nodes)
        nodes = [f"n{i}" for i in range(n_nodes)]
        want = jax_placement.ShardPlacement(nodes, n_shards, replication=r)
        got = torch_placement.ShardPlacement(nodes, n_shards, replication=r)
        assert got.n_shards == want.n_shards == n_shards
        assert _view(got, n_shards) == _view(want, n_shards)
        assert [got.replicas(s) for s in range(n_shards)] == \
            [want.replicas(s) for s in range(n_shards)]
        # fail one node, then another, then recover the first
        victims = [nodes[n_shards % n_nodes], nodes[(n_shards + 1) % n_nodes]]
        for v in victims:
            assert _answer(got.fail, v) == _answer(want.fail, v)
            assert _view(got, n_shards) == _view(want, n_shards)
        assert got.recover(victims[0]) == want.recover(victims[0])
        assert _view(got, n_shards) == _view(want, n_shards)
        # elasticity: add a fresh node, remove an old one
        assert got.add_node("fresh") == want.add_node("fresh")
        assert _view(got, n_shards) == _view(want, n_shards)
        assert got.remove_node(victims[1]) == want.remove_node(victims[1])
        assert _view(got, n_shards) == _view(want, n_shards)


def test_placement_errors_and_block_placement_equal_reference():
    for mod in (jax_placement, torch_placement):
        with pytest.raises(ValueError):
            mod.RendezvousPlacement([], 4)
        with pytest.raises(ValueError):
            mod.RendezvousPlacement(["a"], 4, replication=0)
        p = mod.ShardPlacement(["a", "b"], 3, replication=1)
        with pytest.raises(KeyError):
            p.fail("zz")
        with pytest.raises(KeyError):
            p.remove_node("zz")
        p.fail(p.owner(0))
        with pytest.raises(RuntimeError, match="all replicas down"):
            p.owner(0)
    nodes = ["x", "y", "y", "z"]                  # duplicates dropped
    want = jax_placement.BlockPlacement(nodes, 17, replication=2)
    got = torch_placement.BlockPlacement(nodes, 17, replication=2)
    assert got.n_blocks == want.n_blocks == 17
    assert _view(got, 17) == _view(want, 17)


def test_for_store_equals_reference(tmp_path):
    store = tmp_path / "v2"
    store.mkdir()
    manifest = {"format": "cobs-jax-v2",
                "shards": [{"rows": [0, 64]}, {"rows": [64, 128]},
                           {"rows": [128, 160]}]}
    (store / "manifest.json").write_text(json.dumps(manifest))
    nodes = ["h0", "h1", "h2"]
    want = jax_placement.ShardPlacement.for_store(store, nodes, 2)
    got = torch_placement.ShardPlacement.for_store(store, nodes, 2)
    assert got.n_shards == 3
    assert _view(got, 3) == _view(want, 3)
    manifest["format"] = "cobs-jax-v1"
    (store / "manifest.json").write_text(json.dumps(manifest))
    for mod in (jax_placement, torch_placement):
        with pytest.raises(ValueError, match="not a cobs-jax-v2 store"):
            mod.ShardPlacement.for_store(store, nodes)


# --------------------------------------------------------------------------
# HedgedExecutor
# --------------------------------------------------------------------------

def _executor(mod, n=4, base=1.0, hedge_after=2.0, max_hedges=1):
    shards = {f"s{i}": mod.ShardSim(f"s{i}", base_latency=base)
              for i in range(n)}
    return mod.HedgedExecutor(shards=shards, hedge_after=hedge_after,
                              max_hedges=max_hedges)


def _stats(ex):
    return {"hedges_fired": ex.hedges_fired, "hedges_won": ex.hedges_won,
            "hedges_cancelled": ex.hedges_cancelled,
            "failovers": ex.failovers, "skipped_dead": ex.skipped_dead,
            "latencies": ex.latencies(), "completions": list(ex.completions),
            "hedged_fraction": ex.hedged_fraction(),
            "percentiles": [ex.percentile(q) for q in (0.0, 0.5, 0.9,
                                                       0.99, 1.0)],
            "now": ex.clock.now}


def _simulate(mod, seed, max_hedges, hedge_after):
    """A seeded run of 150 queries: straggling, failed and recovered
    replicas; every outcome (or AllReplicasFailed) is recorded."""
    rng = random.Random(seed)
    ex = _executor(mod, n=5, hedge_after=hedge_after, max_hedges=max_hedges)
    names = sorted(ex.shards)
    outcomes = []
    for q in range(150):
        for s in ex.shards.values():
            if rng.random() < 0.15:
                s.straggle_until = ex.clock.now + rng.choice((0.5, 50.0))
                s.straggle_factor = rng.choice((3.0, 10.0, 50.0))
            if rng.random() < 0.08:
                s.failed = not s.failed
        replicas = rng.sample(names, rng.randint(1, 4))
        try:
            outcomes.append(ex.run_query(q, replicas))
        except mod.AllReplicasFailed as e:
            outcomes.append(("failed", str(e)))
    return outcomes, _stats(ex)


@pytest.mark.parametrize("seed,max_hedges,hedge_after",
                         [(0, 1, 2.0), (1, 2, 2.0), (2, 3, 1.5),
                          (3, 1, 20.0)])
def test_simulated_dispatch_equals_reference(seed, max_hedges, hedge_after):
    want = _simulate(jax_hedge, seed, max_hedges, hedge_after)
    got = _simulate(torch_hedge, seed, max_hedges, hedge_after)
    assert got == want
    assert any(o[0] == "failed" for o in got[0])     # the loss case ran
    assert got[1]["failovers"] + got[1]["skipped_dead"] > 0


def _real_dispatch(mod):
    """``run`` with real calls: models for s0-s2, s3 timed on the wall
    clock (it is never hedged onto); calls that raise AttemptFailed fail
    over."""
    ex = _executor(mod, n=3, hedge_after=2.0, max_hedges=2)
    ex.shards["s0"].straggle_until = 1e9
    dead = {"s1"}

    def call(node):
        if node in dead:
            raise mod.AttemptFailed(node)
        return f"res-{node}"

    out = [ex.run(0, ["s0", "s1", "s2"], call),
           ex.run(1, ["s1", "s2"], call)]
    dead.add("s2")
    out.append(ex.run(2, ["s1", "s2", "s0"], call))
    w = ex.run(3, ["s3", "s0"], call)            # wall-clock primary
    out.append((w[0], w[2]))
    dead.add("s0")
    with pytest.raises(mod.AllReplicasFailed):
        ex.run(4, ["s0", "s1", "s2"], call)
    with pytest.raises(KeyError):
        ex.run_query(5, ["unmodelled"])
    st = _stats(ex)
    for k in ("latencies", "percentiles", "now"):     # s3's is wall time
        st.pop(k)
    st["completions"] = [c for c in st["completions"] if c[1] != "s3"]
    return out, st


def test_real_dispatch_equals_reference():
    assert _real_dispatch(torch_hedge) == _real_dispatch(jax_hedge)


def _async_dispatch(mod):
    """``run_async`` over futures that are resolved or failed at once:
    the winner, result, failovers, skips and cancellations are
    deterministic."""
    ex = _executor(mod, n=0, hedge_after=10.0, max_hedges=1)
    ex.shards["dead"] = mod.ShardSim("dead", failed=True)
    cancelled = []

    def begin(node):
        if node == "refuses":
            raise mod.AttemptFailed(node)        # never sent
        f = Future()
        if node.startswith("fails"):
            f.set_exception(mod.AttemptFailed(node))
        elif node != "mute":
            f.set_result(f"res-{node}")
        return f

    def cancel(node, fut):
        cancelled.append(node)

    out = []
    for replicas in (["a", "b"], ["dead", "refuses", "fails1", "c"],
                     ["refuses", "fails1", "fails2"]):
        try:
            node, _, res = ex.run_async(0, replicas, begin, cancel)
            out.append((node, res))
        except mod.AllReplicasFailed as e:
            out.append(("failed", str(e)))
    st = _stats(ex)
    for k in ("latencies", "percentiles", "completions"):
        st.pop(k)
    return out, st, cancelled


def test_async_dispatch_equals_reference():
    got = _async_dispatch(torch_hedge)
    assert got == _async_dispatch(jax_hedge)
    assert got[0][-1][0] == "failed" and got[1]["failovers"] == 5
