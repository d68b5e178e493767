"""The port's multi-host data plane against the JAX package, on the CPU.

``repro_torch.serve.ShardWorker`` and ``Frontend`` run beside
``repro.serve.ShardWorker`` and ``Frontend`` on the same cobs-jax-v2
stores, written by the JAX streaming builder at the sizes of
``tests/test_multihost.py`` (96 documents, k = 15, blocks of 32, three
shards), plus a rowdict store (blocks of 128, see ROADMAP "JAX pruning
fixture"). The same requests must give equal answers:

* a worker's candidates for every held shard — raw, rowdict served
  compressed, pruned, tiles padded to the host's own tallest shard
  (``local_pad``); threshold and top-k — with equal tile padding and
  equal dispatch, tile and prune counters;
* a frontend's responses over 2-5 hosts and replication 1-3, with
  sequential and concurrent scatter and one failed worker, equal to the
  JAX frontend's and to the JAX ``QueryEngine``; pruned and compressed
  fleets too;
* under ``latency_models`` (a simulated clock), equal latencies, hedge
  counts and failovers: the whole metrics snapshot;
* total loss answers FAILED; a missing replica raises; the tile prefetch
  works across hosts.

Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_compact as jax_build
from repro.data import make_corpus, make_queries
from repro.index import ShardPlacement as JaxPlacement
from repro.index import ShardSim as JaxSim
from repro.index import build_compact_streaming as jax_streaming
from repro.serve import Frontend as JaxFrontend
from repro.serve import FrontendConfig as JaxConfig
from repro.serve import ShardWorker as JaxWorker

from repro_torch.core import query as q
from repro_torch.core.store import open_store
from repro_torch.index import ShardPlacement, ShardSim
from repro_torch.serve import (Frontend, FrontendConfig, ShardWorker,
                               Status)

torch.set_num_threads(2)

CPU = "cpu"
PARAMS = JaxParams(n_hashes=1, fpr=0.3, kmer=15)
PRUNE_FIELDS = [f.name for f in dataclasses.fields(q.PruneStats)]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(corpus, kind -> (store path, JAX engine over the same data))."""
    root = tmp_path_factory.mktemp("torch-mh")
    c = make_corpus(96, k=15, mean_length=400, sigma=1.0, seed=7)
    jax_streaming(c.doc_terms, root / "raw", PARAMS, block_docs=32,
                  row_align=64)
    dense = jax_build(c.doc_terms, PARAMS, block_docs=32, row_align=64)
    # a replicated collection, so that rowdict codes its shards
    base = make_corpus(24, k=15, mean_length=300, min_length=200, seed=3)
    rep = [base.doc_terms[i % 24] for i in range(24 * 12)]
    comp, _ = jax_streaming(rep, root / "comp", JaxParams(1, 0.03, 15),
                            block_docs=128, codec="rowdict")
    return c, base, {"raw": (root / "raw", JaxEngine(dense)),
                     "comp": (root / "comp", JaxEngine(comp,
                                                       compressed=True))}


def _workers(pkg, store, placement, **kw):
    held = placement.replica_assignment()
    if pkg == "torch":
        return {n: ShardWorker(n, store, held[n], device=CPU, **kw)
                for n in placement.nodes if held[n]}
    return {n: JaxWorker(n, store, held[n], **kw)
            for n in placement.nodes if held[n]}


def _pair(store, n_hosts, replication, *, worker_kw=None, sims=None,
          **cfg):
    """(JAX frontend, torch frontend) over the same placement."""
    nodes = [f"h{i}" for i in range(n_hosts)]
    r = min(replication, n_hosts)
    cfg = dict(dict(max_batch=8, max_wait_s=0.0, hedge_after_s=1e9), **cfg)
    out = []
    for pkg in ("jax", "torch"):
        P, F, C, S = ((JaxPlacement, JaxFrontend, JaxConfig, JaxSim)
                      if pkg == "jax" else
                      (ShardPlacement, Frontend, FrontendConfig, ShardSim))
        place = P.for_store(store, nodes, replication=r)
        models = ({n: S(n, **kw) for n, kw in sims.items()}
                  if sims is not None else None)
        out.append(F(_workers(pkg, store, place, **(worker_kw or {})),
                     place, C(**cfg), latency_models=models))
    return out


def _serve(fe, requests):
    ids = [fe.submit(p, **kw) for p, kw in requests]
    fe.drain()
    resp = fe.pop_responses()
    return [resp[i] for i in ids]


def assert_same_responses(got, want, timed=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status.value == w.status.value
        assert (g.method, g.batch_size) == (w.method, w.batch_size)
        if timed:
            assert (g.wait_s, g.service_s) == (w.wait_s, w.service_s)
        if w.result is None:
            assert g.result is None
            continue
        np.testing.assert_array_equal(g.result.doc_ids, w.result.doc_ids)
        np.testing.assert_array_equal(g.result.scores, w.result.scores)
        assert (g.result.n_terms, g.result.threshold) == \
            (w.result.n_terms, w.result.threshold)


def assert_engine_answers(resp, requests, engine):
    for r, (p, kw) in zip(resp, requests):
        want = (engine.top_k(p, k=kw["top_k"]) if "top_k" in kw
                else engine.search(p, threshold=kw["threshold"]))
        np.testing.assert_array_equal(r.result.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(r.result.scores, want.scores)
        assert r.result.threshold == want.threshold


def _requests(corpus, seed, threshold=0.7, k=3):
    qs, _ = make_queries(corpus, n_pos=3, n_neg=2, length=100, seed=seed)
    return ([(p, {"threshold": threshold}) for p in qs]
            + [(p, {"top_k": k}) for p in qs])


SNAP_COUNTS = ("served", "failed", "batches", "methods", "failovers",
               "skipped_dead", "hedges_fired", "hedges_won", "dispatches",
               "page_faults", "tile_hits", "prefetched_tiles",
               "prefetch_hits", "resident_tiles", "pruned_blocks",
               "tiles_skipped", "pruned_bytes_saved", "shard_faults")


def assert_same_counts(fe_t, fe_j):
    st, sj = fe_t.metrics.snapshot(), fe_j.metrics.snapshot()
    for f in SNAP_COUNTS:
        assert getattr(st, f) == getattr(sj, f), f
    assert set(st.worker_p99_ms) == set(sj.worker_p99_ms)


# --------------------------------------------------------------------------
# ShardWorker
# --------------------------------------------------------------------------

WORKER_CASES = [("raw", {}), ("comp", {"compressed": True}),
                ("raw", {"pruned": True, "prune_chunk": 16}),
                ("comp", {"pruned": True, "prune_chunk": 16,
                          "compressed": True}),
                ("raw", {"local_pad": True})]


@pytest.mark.parametrize("kind,kw", WORKER_CASES,
                         ids=["raw", "rowdict", "pruned", "pruned-rowdict",
                              "local-pad"])
def test_worker_candidates_equal_reference(built, kind, kw):
    c, base, stores = built
    store = stores[kind][0]
    corpus = c if kind == "raw" else base
    n = ShardPlacement.for_store(store, ["x"]).n_shards
    assert n >= 3
    held = list(range(n))
    if kw.get("local_pad"):
        # hold every shard but the tallest, so the local pad is smaller
        heights = np.diff(open_store(store, device=CPU)[1].shard_row_starts)
        held.remove(int(np.argmax(heights)))
    jw = JaxWorker("w", store, held, **kw)
    tw = ShardWorker("w", store, held, device=CPU, **kw)
    assert tw.tiles.pad_rows_to == jw.tiles.pad_rows_to
    if kw.get("local_pad"):
        assert tw.tiles.pad_rows_to == int(heights[held].max())
        assert tw.tiles.pad_rows_to < int(heights.max())
    if kind == "comp":
        assert any(tw.storage.shard_codec(s) == "rowdict" for s in range(n))
    qs, _ = make_queries(corpus, n_pos=5, n_neg=3, length=120, seed=5)
    sets = [q.compile_pattern(p, tw.params) for p in qs]
    for mode in ("threshold", "top-k", "mixed"):
        Q = len(sets)
        B = 64 * -(-max(s.shape[0] for s in sets) // 64)
        buf = np.zeros((Q, B, 2), np.uint32)
        n_valid = np.zeros(Q, np.int32)
        for i, s in enumerate(sets):
            buf[i, :s.shape[0]] = s
            n_valid[i] = s.shape[0]
        topks = np.zeros(Q, np.int32)
        if mode != "threshold":
            topks[:Q if mode == "top-k" else Q // 2] = 4
        cutoffs = np.array([0 if topks[i] else
                            q.coverage_cutoff(0.8, int(n_valid[i]))
                            for i in range(Q)], np.int32)
        jt = jw.stage_batch(buf, n_valid)
        tt = tw.stage_batch(buf, n_valid)
        assert tt[0].dtype == torch.int32
        for g in held:
            want, wm = jw.score_candidates(g, *jt, cutoffs, topks, Q)
            got, gm = tw.score_candidates(g, *tt, cutoffs, topks, Q)
            assert gm == wm
            assert len(got) == len(want) == Q
            for (gd, gs), (wd, ws) in zip(got, want):
                np.testing.assert_array_equal(gd, wd)
                np.testing.assert_array_equal(gs, ws)
    for f in ("dispatches", "compressed_dispatches", "pruned_dispatches",
              "prune_baseline_bytes"):
        assert getattr(tw, f) == getattr(jw, f), f
    for f in PRUNE_FIELDS:
        assert getattr(tw.prune_stats, f) == getattr(jw.prune_stats, f), f
    for f in ("hits", "faults", "raw_bytes_staged", "comp_bytes_staged"):
        assert getattr(tw.tiles, f) == getattr(jw.tiles, f), f
    if kw.get("pruned"):
        assert tw.pruned_dispatches > 0
    if kw.get("compressed"):
        assert tw.compressed_dispatches > 0


def test_worker_single_query_unpack_and_errors(built):
    """A singleton short batch dispatches ``unpack`` on both sides; a
    failed worker and a shard it does not hold raise AttemptFailed."""
    c, _, stores = built
    store = stores["raw"][0]
    from repro_torch.index import AttemptFailed
    jw, tw = JaxWorker("w", store, [0, 2]), \
        ShardWorker("w", store, [0, 2], device=CPU)
    assert tw.shard_ids == jw.shard_ids == (0, 2)
    assert tw.holds(2) and not tw.holds(1)
    terms = q.compile_pattern(c.documents[5][:60], tw.params)
    buf = np.zeros((1, 64, 2), np.uint32)
    buf[0, :terms.shape[0]] = terms
    nv = np.array([terms.shape[0]], np.int32)
    co = np.array([q.coverage_cutoff(0.7, terms.shape[0])], np.int32)
    tk = np.zeros(1, np.int32)
    want = jw.score_candidates(0, *jw.stage_batch(buf, nv), co, tk, 1)
    got = tw.score_candidates(0, *tw.stage_batch(buf, nv), co, tk, 1)
    assert got[1] == want[1] == "unpack"
    np.testing.assert_array_equal(got[0][0][0], want[0][0][0])
    np.testing.assert_array_equal(got[0][0][1], want[0][0][1])
    staged = tw.stage_batch(buf, nv)
    with pytest.raises(AttemptFailed, match="does not hold"):
        tw.score_candidates(1, *staged, co, tk, 1)
    tw.fail()
    with pytest.raises(AttemptFailed, match="is down"):
        tw.score_candidates(0, *staged, co, tk, 1)
    assert not tw.prefetch_shard(0)
    tw.recover()
    assert tw.prefetch_shard(2) and not tw.prefetch_shard(2)


# --------------------------------------------------------------------------
# Frontend == the JAX frontend == the JAX engine
# --------------------------------------------------------------------------

FLEETS = [(2, 1, 1), (2, 2, 4), (3, 2, 1), (3, 3, 4), (4, 2, 4), (5, 3, 1)]


@pytest.mark.parametrize("n_hosts,replication,threads", FLEETS)
def test_frontend_equals_reference(built, n_hosts, replication, threads):
    c, _, stores = built
    store, engine = stores["raw"]
    jf, tf = _pair(store, n_hosts, replication, scatter_threads=threads)
    assert (tf._pool is not None) == (threads > 1)
    if replication >= 2:
        victim = tf.placement.owner(n_hosts % tf.placement.n_shards)
        assert tf.fail_worker(victim) == jf.fail_worker(victim)
    reqs = _requests(c, seed=n_hosts * 10 + replication)
    want = _serve(jf, reqs)
    got = _serve(tf, reqs)
    assert all(r.status == Status.OK for r in got)
    assert_same_responses(got, want)
    assert_engine_answers(got, reqs, engine)
    assert_same_counts(tf, jf)
    if replication >= 2:
        assert tf.metrics.snapshot().failovers > 0
        assert tf.recover_worker(victim) == jf.recover_worker(victim)
        assert not tf.workers[victim].failed
        assert_same_responses(_serve(tf, reqs[:3]), _serve(jf, reqs[:3]))


@pytest.mark.parametrize("kind", ["pruned", "rowdict"])
def test_pruned_and_compressed_fleets_equal_reference(built, kind):
    c, base, stores = built
    if kind == "pruned":
        (store, engine), corpus = stores["raw"], c
        wkw, cfg = {}, {"pruned": True, "prune_chunk": 16}
    else:
        (store, engine), corpus = stores["comp"], base
        wkw, cfg = {"compressed": True}, {}
    jf, tf = _pair(store, 3, 2, worker_kw=wkw, scatter_threads=4, **cfg)
    reqs = _requests(corpus, seed=9, threshold=0.8)
    got, want = _serve(tf, reqs), _serve(jf, reqs)
    assert_same_responses(got, want)
    assert_engine_answers(got, reqs, engine)
    assert_same_counts(tf, jf)
    if kind == "pruned":
        assert tf.metrics.snapshot().methods.get("lookup_p", 0) > 0
        assert tf.metrics.snapshot().pruned_blocks > 0
    else:
        assert sum(w.compressed_dispatches
                   for w in tf.workers.values()) > 0


def test_simulated_clock_equals_reference(built):
    """Deterministic latencies: one straggler and a hedge deadline, then a
    failed worker; every response's wait and service and the whole
    metrics snapshot equal the JAX frontend's."""
    c, _, stores = built
    store, engine = stores["raw"]
    sims = {f"h{i}": {"base_latency": 1e-3} for i in range(3)}
    jf, tf = _pair(store, 3, 2, sims=sims, hedge_after_s=2e-3)
    victim = tf.placement.owner(0)
    for fe in (jf, tf):
        fe.executor.shards[victim].straggle_until = 1e9
        fe.executor.shards[victim].straggle_factor = 50.0
    reqs = _requests(c, seed=51)
    got, want = _serve(tf, reqs), _serve(jf, reqs)
    assert_same_responses(got, want, timed=True)
    assert_engine_answers(got, reqs, engine)
    for fe in (jf, tf):
        fe.fail_worker(tf.placement.owner(1))
    got2, want2 = _serve(tf, reqs[:4]), _serve(jf, reqs[:4])
    assert_same_responses(got2, want2, timed=True)
    st, sj = tf.metrics.snapshot(), jf.metrics.snapshot()
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert st.hedges_fired > 0 and st.hedges_won > 0
    assert st.skipped_dead > 0
    assert tf.executor.hedged_fraction() == jf.executor.hedged_fraction()
    assert tf.executor.latencies() == jf.executor.latencies()
    assert tf.hedge_after_s == jf.hedge_after_s == 2e-3


@pytest.mark.parametrize("threads", [1, 4])
def test_total_loss_answers_failed(built, threads):
    c, _, stores = built
    jf, tf = _pair(stores["raw"][0], 2, 1, scatter_threads=threads)
    victim = tf.placement.owner(0)
    for fe in (jf, tf):
        fe.workers[victim].fail()            # dead at call time
        if threads == 1:
            fe.fail_worker(victim)
    reqs = _requests(c, seed=41)[:4]
    got, want = _serve(tf, reqs), _serve(jf, reqs)
    assert all(r.status == Status.FAILED and r.result is None for r in got)
    assert_same_responses(got, want)
    assert tf.metrics.snapshot().failed == jf.metrics.snapshot().failed \
        == len(reqs)


def test_missing_replica_raises(built):
    store = built[2]["raw"][0]
    place = ShardPlacement.for_store(store, ["a", "b"], replication=2)
    held = place.replica_assignment()
    with pytest.raises(ValueError, match="has no worker"):
        Frontend({"a": ShardWorker("a", store, held["a"], device=CPU)},
                 place)
    short = [g for g in held["b"]][:1]
    with pytest.raises(ValueError, match="missing replica shards"):
        Frontend({"a": ShardWorker("a", store, held["a"], device=CPU),
                  "b": ShardWorker("b", store, short, device=CPU)}, place)


def test_prefetch_across_hosts_equals_reference(built):
    c, _, stores = built
    jf, tf = _pair(stores["raw"][0], 3, 2, scatter_threads=1)
    reqs = _requests(c, seed=91)
    assert_same_responses(_serve(tf, reqs), _serve(jf, reqs))
    st, sj = tf.metrics.snapshot(), jf.metrics.snapshot()
    assert st.prefetched_tiles > 0 and st.prefetch_hit_rate > 0
    assert (st.prefetched_tiles, st.prefetch_hits, st.page_faults) == \
        (sj.prefetched_tiles, sj.prefetch_hits, sj.page_faults)
    assert st.shard_faults == sj.shard_faults
