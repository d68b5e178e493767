"""The port's pruned executor against the JAX package, on the CPU.

``QueryEngine.search_pruned / search_batch_pruned / top_k_pruned`` of both
packages run on the same stores (24 base documents x 6, k = 15, built by
the JAX writer): a raw store of one 32-document block a shard, a rowdict
store of 128-document blocks (every shard dict-coded, W = 4 words in a
running-count buffer of 8), and a dense single-shard store. The port must
return the JAX ``SearchResult``s and the same ``PruneStats``, field by
field; ``run_paged_pruned`` with ``promote_ratio=0`` (every shard promoted
on its first visit: the fused chunk kernels, and ``gather_and_rows`` for
two hashes) must give the JAX slot scores, stats and tile-cache counters.
Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import query as jax_query
from repro.data import make_corpus
from repro.index import build_compact_streaming as jax_streaming

from repro_torch.core import DeviceTileCache, QueryEngine, load_index_v2
from repro_torch.core import query as q
from repro_torch.kernels import ops

torch.set_num_threads(2)

CPU = "cpu"
JPARAMS = JaxParams(n_hashes=1, fpr=0.03, kmer=15)
KINDS = ["raw", "comp", "dense"]
STATS_FIELDS = [f.name for f in dataclasses.fields(q.PruneStats)]


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
    root = tmp_path_factory.mktemp("prune")
    kw = {"raw": dict(block_docs=32, blocks_per_shard=1, codec="raw"),
          "comp": dict(block_docs=128, blocks_per_shard=1, codec="rowdict"),
          "dense": dict(block_docs=32, blocks_per_shard=64, codec="raw")}
    out = {}
    for kind, args in kw.items():
        jidx, _ = jax_streaming(terms, root / kind, JPARAMS, **args)
        out[kind] = (jidx, load_index_v2(root / kind, device=CPU))
    st = out["comp"][1].storage
    assert st.n_shards == 2 and all(
        st.shard_codec(s) == "rowdict" for s in range(2))
    assert out["raw"][1].storage.n_shards > 2
    assert out["dense"][1].storage.n_shards == 1
    return c, root, terms, out


def _engines(stores, kind, chunk, **kw):
    jidx, tidx = stores[3][kind]
    comp = kind == "comp"
    return (JaxEngine(jidx, method="lookup", compressed=comp,
                      prune_chunk=chunk, **kw),
            QueryEngine(tidx, method="lookup", compressed=comp,
                        prune_chunk=chunk, device=CPU))


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)


def assert_same_stats(got, want):
    for f in STATS_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert (got.bytes_read, got.prune_rate) == (want.bytes_read,
                                                 want.prune_rate)


# --------------------------------------------------------------------------
# Engine entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_search_batch_pruned_equals_reference(stores, kind, chunk,
                                              threshold):
    c = stores[0]
    jeng, teng = _engines(stores, kind, chunk)
    pats = _patterns(c, seed=chunk)
    jstats, tstats = jax_query.PruneStats(), q.PruneStats()
    want = jeng.search_batch_pruned(pats, threshold, stats=jstats)
    got = teng.search_batch_pruned(pats, threshold, stats=tstats)
    assert_same_results(got, want)
    assert_same_stats(tstats, jstats)
    assert tstats.blocks_total > 0
    assert teng.tiles.faults == jeng.tiles.faults
    # pruned results equal the exhaustive engine's
    assert_same_results(got, teng.search_batch(pats, threshold))


@pytest.mark.parametrize("kind", KINDS)
def test_search_pruned_singles_equal_reference(stores, kind):
    c = stores[0]
    jeng, teng = _engines(stores, kind, 8)
    for pat in _patterns(c, seed=5) + [""]:
        jstats, tstats = jax_query.PruneStats(), q.PruneStats()
        assert_same_results([teng.search_pruned(pat, 0.8, stats=tstats)],
                            [jeng.search_pruned(pat, 0.8, stats=jstats)])
        assert_same_stats(tstats, jstats)


@pytest.mark.parametrize("top", [1, 5, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_top_k_pruned_equals_reference(stores, kind, top):
    c = stores[0]
    jeng, teng = _engines(stores, kind, 16)
    for pat in _patterns(c)[2:6]:
        jstats, tstats = jax_query.PruneStats(), q.PruneStats()
        got = teng.top_k_pruned(pat, k=top, stats=tstats)
        assert_same_results([got],
                            [jeng.top_k_pruned(pat, k=top, stats=jstats)])
        assert_same_stats(tstats, jstats)
        assert_same_results([got], [teng.top_k(pat, k=top)])
    assert_same_results([teng.top_k_pruned("", k=top)],
                        [jeng.top_k_pruned("", k=top)])


def test_pure_negative_query_stages_no_tile(stores):
    """At threshold 1.0 a negative query loses every block after its
    first chunk, and the tile cache never stages a shard."""
    jeng, teng = _engines(stores, "raw", 8)
    rng = np.random.default_rng(42)
    neg = "".join(rng.choice(list("ACGT"), size=90))
    jstats, tstats = jax_query.PruneStats(), q.PruneStats()
    got = teng.search_batch_pruned([neg], threshold=1.0, stats=tstats)
    assert_same_results(got, jeng.search_batch_pruned([neg], 1.0,
                                                      stats=jstats))
    assert_same_stats(tstats, jstats)
    assert got[0].doc_ids.size == 0 and tstats.prune_rate > 0.5
    assert teng.tiles.faults == 0 == jeng.tiles.faults


# --------------------------------------------------------------------------
# The executor: promotion, order, two hashes
# --------------------------------------------------------------------------

def _batch(c, params, threshold):
    term_sets = [jax_query.compile_pattern(p, params) for p in _patterns(c)]
    buf, ells = jax_query.pad_term_batch(term_sets, 16)
    required = np.array([jax_query.coverage_cutoff(threshold, int(e))
                         for e in ells], np.int64)
    return buf, np.asarray(ells, np.int32), required


def _run_both(jidx, tidx, buf, ells, required, topk, **kw):
    """run_paged_pruned of both packages through unpadded tile caches."""
    jtiles, ttiles = JaxCache(jidx.storage), DeviceTileCache(tidx.storage)
    jstats, tstats = jax_query.PruneStats(), q.PruneStats()
    plans = q.plan_shards(tidx.layout, tidx.storage.shard_row_starts)
    jplans = jax_query.plan_shards(jidx.layout, jidx.storage.shard_row_starts)
    want = jax_query.run_paged_pruned(jtiles, jplans, buf, ells, required,
                                      topk, stats=jstats, **kw)
    got = q.run_paged_pruned(ttiles, plans, buf, ells, required, topk,
                             stats=tstats, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert_same_stats(tstats, jstats)
    for name in ("faults", "hits", "prefetched", "prefetch_hits",
                 "raw_bytes_staged", "comp_bytes_staged"):
        assert getattr(ttiles, name) == getattr(jtiles, name), name
    return got, tstats, ttiles


@pytest.mark.parametrize("mode", ["threshold", "topk"])
@pytest.mark.parametrize("kind", KINDS)
def test_promoted_pruned_equals_reference(stores, kind, mode):
    """promote_ratio=0: every shard is staged on its first visit and
    scored by the fused chunk kernels (the fused-decode one on rowdict
    shards)."""
    c, _, _, idxs = stores
    jidx, tidx = idxs[kind]
    buf, ells, required = _batch(c, JPARAMS, 0.8)
    topk = np.zeros(len(ells), np.int32)
    if mode == "topk":
        required[:], topk[:] = 0, 3
    for chunk in (8, 32):
        _, stats, tiles = _run_both(jidx, tidx, buf, ells, required, topk,
                                    chunk_terms=chunk, promote_ratio=0.0)
        assert stats.tiles_promoted == tidx.storage.n_shards
        assert stats.bytes_gathered == 0
        if kind == "comp":
            assert tiles.comp_bytes_staged > 0 == tiles.raw_bytes_staged


@pytest.mark.parametrize("kind", KINDS)
def test_order_terms_rarest_equals_reference(stores, kind):
    c, _, _, idxs = stores
    jidx, tidx = idxs[kind]
    buf, ells, _ = _batch(c, JPARAMS, 0.8)
    plans = q.plan_shards(tidx.layout, tidx.storage.shard_row_starts)
    jplans = jax_query.plan_shards(jidx.layout, jidx.storage.shard_row_starts)
    for n_hashes, max_blocks in ((1, 8), (2, 8), (1, 2)):
        got = q.order_terms_rarest(tidx.storage, plans, buf, ells,
                                   n_hashes=n_hashes, max_blocks=max_blocks)
        want = jax_query.order_terms_rarest(jidx.storage, jplans, buf, ells,
                                            n_hashes=n_hashes,
                                            max_blocks=max_blocks)
        np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert not np.array_equal(got, np.broadcast_to(
        np.arange(buf.shape[1]), got.shape))


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    c, terms = _redundant_terms(n_base=16, reps=4, seed=9)
    p2 = JaxParams(n_hashes=2, fpr=0.05, kmer=15)
    root = tmp_path_factory.mktemp("k2")
    jidx, _ = jax_streaming(terms, root / "k2", p2, block_docs=32,
                            blocks_per_shard=1)
    return c, p2, jidx, load_index_v2(root / "k2", device=CPU)


@pytest.mark.parametrize("promote_ratio", [0.5, 0.0])
def test_k2_pruned_equals_reference(k2, promote_ratio):
    """Two hashes: host-ANDed unique row sets when unpromoted, the device
    gather + AND (``gather_and_rows``) when promoted."""
    c, p2, jidx, tidx = k2
    for thr in (0.5, 1.0):
        buf, ells, required = _batch(c, p2, thr)
        _, stats, _ = _run_both(jidx, tidx, buf, ells, required,
                                np.zeros(len(ells), np.int32), n_hashes=2,
                                chunk_terms=16, promote_ratio=promote_ratio)
        # unpromoted visits gather rows on the host; at ratio 0 none does
        assert (stats.bytes_gathered == 0) == (promote_ratio == 0.0)
        assert stats.tiles_promoted > 0
    jeng = JaxEngine(jidx, method="vertical", prune_chunk=16)
    teng = QueryEngine(tidx, method="vertical", prune_chunk=16, device=CPU)
    pats = _patterns(c)[:5]
    jstats, tstats = jax_query.PruneStats(), q.PruneStats()
    got = teng.search_batch_pruned(pats, 0.5, stats=tstats)
    assert_same_results(got, jeng.search_batch_pruned(pats, 0.5,
                                                      stats=jstats))
    assert_same_stats(tstats, jstats)
    assert_same_results(got, teng.search_batch(pats, 0.5))


def test_prune_stats_merge_and_rates():
    a = q.PruneStats(blocks_total=10, blocks_pruned=4, bytes_gathered=7,
                     bytes_tile_staged=5)
    b = q.PruneStats(blocks_total=6, blocks_pruned=2, chunks=3)
    a.merge(b)
    assert (a.blocks_total, a.blocks_pruned, a.chunks) == (16, 6, 3)
    assert a.bytes_read == 12 and a.prune_rate == 6 / 16
    assert q.PruneStats().prune_rate == 0.0
    assert q._pad_unique(0) == 8 == jax_query._pad_unique(0)
    for n in (1, 8, 9, 1000):
        assert q._pad_unique(n) == jax_query._pad_unique(n)


# --------------------------------------------------------------------------
# device=None means the card
# --------------------------------------------------------------------------

def test_pruned_entry_points_need_cuda_unless_told(monkeypatch, stores):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, root, _, idxs = stores
    tidx = idxs["raw"][1]
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(tidx, prune_chunk=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_index_v2(root / "raw")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.chunk_acc_init(1, 1, 1)
    eng = QueryEngine(tidx, prune_chunk=8, device=CPU)
    assert eng.tiles.device == torch.device(CPU)
    assert eng.search_pruned("ACGT" * 20, 0.5).doc_ids.dtype == np.int32
    assert ops.chunk_acc_init(1, 1, 1, device=CPU).device == torch.device(CPU)
