"""The port's shard-major bulk executor against the JAX package, on the CPU.

``run_shard_major`` of both packages sweeps the same query set over the
same stores (24 base documents x 6, k = 15, built by the JAX writer: raw
with one 32-document block a shard, rowdict with 128-document blocks,
dense single-shard), each through an unpadded tile cache of its own
package. The port must return the JAX ``(out, next_shard, required)`` and
the same ``BulkStats``, field by field, for threshold and top-k sweeps,
slabs that split the query set, a sweep suspended after every shard and
resumed, a list of caches, two hashes, and a cache bounded at one shard.
Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import query as jax_query
from repro.data import make_corpus
from repro.index import build_compact_streaming as jax_streaming

from repro_torch.core import DeviceTileCache, QueryEngine, load_index_v2
from repro_torch.core import query as q

torch.set_num_threads(2)

CPU = "cpu"
JPARAMS = JaxParams(n_hashes=1, fpr=0.03, kmer=15)
KINDS = ["raw", "comp", "dense"]
STATS_FIELDS = [f.name for f in dataclasses.fields(q.BulkStats)]


def _redundant_terms(n_base=24, reps=6, seed=3):
    c = make_corpus(n_base, k=15, mean_length=160, min_length=120,
                    seed=seed)
    return c, [c.doc_terms[i % n_base] for i in range(n_base * reps)]


def _patterns(c, n_random=4, seed=0):
    rng = np.random.default_rng(seed)
    pats = ["".join(rng.choice(list("ACGT"), size=70))
            for _ in range(n_random)]
    return pats + [c.documents[i][10:100] for i in range(4)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """kind -> (JAX index, port index over the same files)."""
    c, terms = _redundant_terms()
    root = tmp_path_factory.mktemp("bulk")
    kw = {"raw": dict(block_docs=32, blocks_per_shard=1, codec="raw"),
          "comp": dict(block_docs=128, blocks_per_shard=1, codec="rowdict"),
          "dense": dict(block_docs=32, blocks_per_shard=64, codec="raw")}
    out = {}
    for kind, args in kw.items():
        jidx, _ = jax_streaming(terms, root / kind, JPARAMS, **args)
        out[kind] = (jidx, load_index_v2(root / kind, device=CPU))
    return c, out


def _batch(c, params, mode):
    """Padded terms of the 8 patterns and their cutoffs: a threshold
    sweep ('0.5', '0.9') or a top-k sweep ('top3')."""
    term_sets = [jax_query.compile_pattern(p, params) for p in _patterns(c)]
    buf, ells = jax_query.pad_term_batch(term_sets, 16)
    ells = np.asarray(ells, np.int32)
    topk = np.zeros(len(ells), np.int32)
    if mode.startswith("top"):
        topk[:] = int(mode[3:])
        required = np.zeros(len(ells), np.int64)
    else:
        required = np.array([jax_query.coverage_cutoff(float(mode), int(e))
                             for e in ells], np.int64)
    return buf, ells, required, topk


def _plans(jidx, tidx):
    return (jax_query.plan_shards(jidx.layout, jidx.storage.shard_row_starts),
            q.plan_shards(tidx.layout, tidx.storage.shard_row_starts))


def assert_same_sweep(got, want, tstats=None, jstats=None):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    if tstats is not None:
        for f in STATS_FIELDS:
            assert getattr(tstats, f) == getattr(jstats, f), f
        assert tstats.prune_rate == jstats.prune_rate


def _sweep_both(jidx, tidx, jtiles, ttiles, buf, ells, required, topk,
                **kw):
    jplans, tplans = _plans(jidx, tidx)
    jstats, tstats = jax_query.BulkStats(), q.BulkStats()
    want = jax_query.run_shard_major(jtiles, jplans, buf, ells, required,
                                     topk, stats=jstats, **kw)
    got = q.run_shard_major(ttiles, tplans, buf, ells, required, topk,
                            stats=tstats, **kw)
    assert_same_sweep(got, want, tstats, jstats)
    return got, tstats


def _select(tidx, out, ells, mode):
    slot = np.asarray(tidx.layout.doc_slot)
    if mode.startswith("top"):
        return [q.select_top_k(out[i][slot], int(e), int(mode[3:]))
                for i, e in enumerate(ells)]
    return [q.select_hits(out[i][slot], int(e), float(mode))
            for i, e in enumerate(ells)]


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


@pytest.mark.parametrize("query_chunk", [None, 3])
@pytest.mark.parametrize("mode", ["0.5", "0.9", "top3"])
@pytest.mark.parametrize("kind", KINDS)
def test_shard_major_equals_reference(stores, kind, mode, query_chunk):
    c, idxs = stores
    jidx, tidx = idxs[kind]
    buf, ells, required, topk = _batch(c, JPARAMS, mode)
    jtiles, ttiles = JaxCache(jidx.storage), DeviceTileCache(tidx.storage)
    (out, nxt, _), stats = _sweep_both(
        jidx, tidx, jtiles, ttiles, buf, ells, required, topk,
        chunk_terms=16, query_chunk=query_chunk)
    assert nxt == tidx.storage.n_shards == stats.shards_swept
    assert stats.tiles_staged == tidx.storage.n_shards
    assert stats.bytes_staged == (ttiles.raw_bytes_staged
                                  + ttiles.comp_bytes_staged)
    if query_chunk:
        assert stats.query_chunks == 3 * tidx.storage.n_shards
    # the sweep's hits are the exhaustive engine's
    engine = QueryEngine(tidx, compressed=kind == "comp", device=CPU)
    pats = _patterns(c)
    want = ([engine.top_k(p, k=3) for p in pats] if mode == "top3"
            else engine.search_batch(pats, float(mode)))
    assert_same_results(_select(tidx, out, ells, mode), want)


@pytest.mark.parametrize("mode", ["0.5", "top3"])
@pytest.mark.parametrize("kind", ["raw", "comp"])
def test_suspend_and_resume_equal_reference(stores, kind, mode):
    """Suspended after every shard and resumed from the returned state,
    each hop equals the JAX hop and the end equals one unbroken sweep."""
    c, idxs = stores
    jidx, tidx = idxs[kind]
    buf, ells, required, topk = _batch(c, JPARAMS, mode)
    jplans, tplans = _plans(jidx, tidx)
    jtiles, ttiles = JaxCache(jidx.storage), DeviceTileCache(tidx.storage)
    jstats, tstats = jax_query.BulkStats(), q.BulkStats()
    jstate, tstate = (None, 0, required), (None, 0, required)
    hops = 0
    while tstate[1] < len(tplans):
        jstate = jax_query.run_shard_major(
            jtiles, jplans, buf, ells, jstate[2], topk, chunk_terms=16,
            stats=jstats, start_shard=jstate[1], out=jstate[0],
            should_yield=lambda: True)
        tstate = q.run_shard_major(
            ttiles, tplans, buf, ells, tstate[2], topk, chunk_terms=16,
            stats=tstats, start_shard=tstate[1], out=tstate[0],
            should_yield=lambda: True)
        assert_same_sweep(tstate, jstate, tstats, jstats)
        hops += 1
    assert hops == len(tplans) == tstats.shards_swept
    whole = q.run_shard_major(DeviceTileCache(tidx.storage), tplans, buf,
                              ells, required, topk, chunk_terms=16)
    np.testing.assert_array_equal(tstate[0], whole[0])
    assert_same_results(_select(tidx, tstate[0], ells, mode),
                        _select(tidx, whole[0], ells, mode))


def test_list_of_caches_equals_reference(stores):
    """One cache per shard, alternating between two caches, as a
    multi-host sweep walks each shard's own worker cache."""
    c, idxs = stores
    jidx, tidx = idxs["raw"]
    buf, ells, required, topk = _batch(c, JPARAMS, "0.5")
    jc = [JaxCache(jidx.storage), JaxCache(jidx.storage)]
    tc = [DeviceTileCache(tidx.storage), DeviceTileCache(tidx.storage)]
    n = tidx.storage.n_shards
    _, stats = _sweep_both(jidx, tidx, [jc[i % 2] for i in range(n)],
                           [tc[i % 2] for i in range(n)], buf, ells,
                           required, topk, chunk_terms=8)
    assert tc[0].faults + tc[1].faults == n == stats.tiles_staged
    for a, b in zip(tc, jc):
        assert (a.faults, a.hits, a.raw_bytes_staged) == (
            b.faults, b.hits, b.raw_bytes_staged)


def test_bounded_cache_stages_each_tile_once(stores):
    """A cache of one shard's room: the sweep stages every shard once (the
    next one prefetched), each by its own bytes."""
    c, idxs = stores
    jidx, tidx = idxs["raw"]
    st = tidx.storage
    cap = max(st.shard_nbytes(s) for s in range(st.n_shards))
    buf, ells, required, topk = _batch(c, JPARAMS, "0.5")
    ttiles = DeviceTileCache(st, capacity_bytes=cap)
    _, stats = _sweep_both(jidx, tidx, JaxCache(jidx.storage,
                                                capacity_bytes=cap),
                           ttiles, buf, ells, required, topk)
    assert stats.tiles_staged == st.n_shards
    assert stats.bytes_staged == st.nbytes()
    assert ttiles.evictions == st.n_shards - 1
    assert ttiles.resident_bytes <= cap


def test_k2_shard_major_equals_reference(tmp_path):
    """Two hashes: each chunk's unique row sets gathered and ANDed on the
    device, then the dedup chunk kernel."""
    c, terms = _redundant_terms(n_base=16, reps=4, seed=9)
    p2 = JaxParams(n_hashes=2, fpr=0.05, kmer=15)
    jidx, _ = jax_streaming(terms, tmp_path / "k2", p2, block_docs=32,
                            blocks_per_shard=1)
    tidx = load_index_v2(tmp_path / "k2", device=CPU)
    engine = QueryEngine(tidx, method="vertical", device=CPU)
    pats = _patterns(c)
    for mode in ("0.5", "1.0", "top3"):
        buf, ells, required, topk = _batch(c, p2, mode)
        (out, _, _), stats = _sweep_both(
            jidx, tidx, JaxCache(jidx.storage), DeviceTileCache(tidx.storage),
            buf, ells, required, topk, n_hashes=2, chunk_terms=16)
        want = ([engine.top_k(p, k=3) for p in pats] if mode == "top3"
                else engine.search_batch(pats, float(mode)))
        assert_same_results(_select(tidx, out, ells, mode), want)


def test_empty_sweeps_and_stats(stores):
    c, idxs = stores
    jidx, tidx = idxs["raw"]
    jplans, tplans = _plans(jidx, tidx)
    tiles = DeviceTileCache(tidx.storage)
    buf = np.zeros((2, 16, 2), np.uint32)
    zero = np.zeros(2, np.int32)
    got = q.run_shard_major(tiles, tplans, buf, zero, zero, zero)
    want = jax_query.run_shard_major(JaxCache(jidx.storage), jplans, buf,
                                     zero, zero, zero)
    assert_same_sweep(got, want)
    assert tiles.faults == 0
    out, nxt, _ = q.run_shard_major(tiles, [], buf, zero, zero, zero)
    assert out.shape == (2, 0) and nxt == 0
    a = q.BulkStats(blocks_total=8, blocks_pruned=2, tiles_staged=1)
    a.merge(q.BulkStats(blocks_total=2, tiles_staged=3))
    assert (a.blocks_total, a.tiles_staged, a.prune_rate) == (10, 4, 0.2)
    assert q.BulkStats().prune_rate == 0.0
