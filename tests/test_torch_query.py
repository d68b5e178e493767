"""The PyTorch port's QueryEngine against the JAX QueryEngine, on the CPU.

JAX indexes (classic and compact, one and two hash functions) are carried
across with ``index_from_numpy``; for every method the port's ``search``,
``search_batch`` and ``top_k`` must give SearchResults equal to the JAX
engine's field by field. Every comparison is exact
(``np.testing.assert_array_equal``): the fields are document ids, integer
scores and integer cutoffs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_classic as jax_build_classic
from repro.core import build_compact as jax_build_compact
from repro.core import query as jax_query
from repro.core.hashing import hash_terms_np as jax_hash_terms_np
from repro.data import make_queries as jax_make_queries

from repro_torch.core import (IndexParams, MappedArena, QueryEngine, hashing,
                              index_from_numpy)
from repro_torch.core import query as q
from repro_torch.core.arena import ArenaLayout, DeviceTileCache
from repro_torch.core.index import BitSlicedIndex

torch.set_num_threads(2)

CPU = "cpu"
METHODS = ["ref", "unpack", "vertical", "lookup"]


def carry(jax_index, device=CPU):
    lay = jax_index.layout
    return index_from_numpy(np.asarray(jax_index.storage.full_host()),
                            lay.row_offset, lay.block_width, lay.doc_slot,
                            lay.doc_n_terms, lay.block_docs, lay.n_docs,
                            jax_index.params.to_json(), device=device)


@pytest.fixture(scope="module")
def jax_indexes(small_corpus, small_indexes):
    params2 = JaxParams(n_hashes=2, fpr=0.3, kmer=15)
    classic1, compact1 = small_indexes
    return {
        ("classic", 1): classic1,
        ("compact", 1): compact1,
        ("classic", 2): jax_build_classic(small_corpus.doc_terms, params2),
        ("compact", 2): jax_build_compact(small_corpus.doc_terms, params2,
                                          block_docs=32, row_align=64),
    }


@pytest.fixture(scope="module")
def patterns(small_corpus):
    pats, _ = jax_make_queries(small_corpus, n_pos=3, n_neg=2, length=80,
                               seed=11)
    # a short query, one with fewer bases than k (no terms), a DNA string
    return pats[:4] + [pats[0][:24], pats[1][:10], "ACGT" * 20]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert g.doc_ids.dtype == w.doc_ids.dtype == np.int32
        assert g.scores.dtype == w.scores.dtype
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_hashes", [1, 2])
@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_engine_equals_reference(jax_indexes, patterns, kind, n_hashes,
                                 method):
    jax_index = jax_indexes[(kind, n_hashes)]
    want_engine = JaxEngine(jax_index, method=method)
    got_engine = QueryEngine(carry(jax_index), method=method, device=CPU)
    assert_same([got_engine.search(p, 0.5) for p in patterns],
                [want_engine.search(p, 0.5) for p in patterns])
    assert_same(got_engine.search_batch(patterns, 0.5),
                want_engine.search_batch(patterns, 0.5))
    assert_same([got_engine.top_k(p, 5) for p in patterns],
                [want_engine.top_k(p, 5) for p in patterns])


def test_positives_reach_full_score(small_corpus, jax_indexes):
    """Bloom filters have no false negatives: an exact substring scores
    ell in its origin document."""
    pats, origin = jax_make_queries(small_corpus, n_pos=10, n_neg=0,
                                    length=60, seed=5)
    for key in (("classic", 1), ("compact", 2)):
        engine = QueryEngine(carry(jax_indexes[key]), device=CPU)
        for p, o in zip(pats, origin):
            r = engine.search(p, threshold=1.0)
            assert o in set(r.doc_ids.tolist())


# --------------------------------------------------------------------------
# the pure helpers and the scoring functions
# --------------------------------------------------------------------------

def test_plan_rows_equals_reference():
    rng = np.random.default_rng(0)
    hashes = rng.integers(0, 2 ** 32, size=(50, 2), dtype=np.uint32)
    hashes[:4] = 0xFFFFFFFF
    offsets = np.array([0, 700, 1300], np.int32)
    widths = np.array([700, 600, 4096], np.int32)
    want = np.asarray(jax_query.plan_rows(jnp.asarray(hashes),
                                          jnp.asarray(offsets),
                                          jnp.asarray(widths)))
    got = q.plan_rows(torch.from_numpy(hashes.view(np.int32)),
                      torch.from_numpy(offsets), torch.from_numpy(widths))
    np.testing.assert_array_equal(got.numpy(), want)


def test_planning_helpers_equal_reference(small_corpus, patterns):
    params, jparams = IndexParams(1, 0.3, 15), JaxParams(1, 0.3, 15)
    sets = [q.compile_pattern(p, params) for p in patterns]
    for p, got in zip(patterns, sets):
        np.testing.assert_array_equal(got,
                                      jax_query.compile_pattern(p, jparams))
    for n in (0, 1, 63, 64, 65, 300):
        assert q.padded_len(n, 64) == jax_query.padded_len(n, 64)
        for thr in (0.0, 0.3, 0.8, 1.0):
            assert q.coverage_cutoff(thr, n) == \
                jax_query.coverage_cutoff(thr, n)
    for a, b in zip(q.pad_terms(sets[0], 64), jax_query.pad_terms(sets[0], 64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(q.pad_term_batch(sets, 32),
                    jax_query.pad_term_batch(sets, 32)):
        np.testing.assert_array_equal(a, b)


def test_selection_equals_reference():
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 6, size=200).astype(np.int32)   # many ties
    for n_terms, thr in ((5, 0.8), (5, 0.2), (0, 0.5), (9, 1.0)):
        assert_same([q.select_hits(scores, n_terms, thr)],
                    [jax_query.select_hits(scores, n_terms, thr)])
    for k_ in (0, 1, 7, 200, 500):
        assert_same([q.select_top_k(scores, 5, k_)],
                    [jax_query.select_top_k(scores, 5, k_)])


@pytest.mark.parametrize("n_hashes", [1, 3])
def test_gather_rows_equals_reference(n_hashes):
    rng = np.random.default_rng(n_hashes)
    arena = rng.integers(0, 2 ** 32, size=(40, 3), dtype=np.uint32)
    rows = rng.integers(0, 40, size=(9, n_hashes, 2)).astype(np.int32)
    valid = np.arange(9) < 6
    want = np.asarray(jax_query.gather_rows(jnp.asarray(arena),
                                            jnp.asarray(rows),
                                            jnp.asarray(valid)))
    got = q.gather_rows(torch.from_numpy(arena.view(np.int32)),
                        torch.from_numpy(rows), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    batched = q.gather_rows(torch.from_numpy(arena.view(np.int32)),
                            torch.from_numpy(np.stack([rows, rows])),
                            torch.from_numpy(np.stack([valid, valid])))
    np.testing.assert_array_equal(batched[1].numpy().view(np.uint32), want)


@pytest.mark.parametrize("method", METHODS)
def test_score_fns_equal_reference(jax_indexes, method):
    """Slot scores of make_score_fn / make_batch_score_fn, before document
    reordering, equal the JAX scoring functions' (compact, k=1)."""
    jax_index = jax_indexes[("compact", 1)]
    index = carry(jax_index)
    rng = np.random.default_rng(4)
    terms = rng.integers(0, 2 ** 32, size=(3, 64, 2), dtype=np.uint32)
    n_valid = np.array([64, 17, 0], np.int32)
    jargs = (jax_index.arena, jax_index.row_offset, jax_index.block_width)
    targs = (index.arena, index.row_offset, index.block_width)
    want = np.asarray(jax_query.make_batch_score_fn(1, method)(
        *jargs, jnp.asarray(terms), jnp.asarray(n_valid)))
    got = q.make_batch_score_fn(1, method, grid_order="qw")(
        *targs, torch.from_numpy(terms.view(np.int32)),
        torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    single = q.make_score_fn(1, method)(
        *targs, torch.from_numpy(terms[1].view(np.int32)), 17)
    np.testing.assert_array_equal(single.numpy(), want[1])


@pytest.mark.parametrize("tiles", ["one tile", "a tile a block"])
@pytest.mark.parametrize("form", ["batch", "single"])
def test_grouped_form_equals_reference(jax_indexes, form, tiles):
    """The k = 1 lookup's grouped form (every block of a tile cache's block
    table in one launch, each term's row hashed and planned by the
    kernel's plain version) gives the JAX scoring functions' slot scores:
    over the index's one arena, and over each block copied into a tile of its own
    (row offsets 0); terms with zero and all-ones words, and n_valid of 0,
    part and all of L."""
    jax_index = jax_indexes[("compact", 1)]
    index = carry(jax_index)
    lay = index.layout
    rng = np.random.default_rng(6)
    terms = rng.integers(0, 2 ** 32, size=(4, 64, 2), dtype=np.uint32)
    terms[:, 0] = 0
    terms[:, 1] = 0xFFFFFFFF
    terms[:, 2] = [0, 0xFFFFFFFF]
    n_valid = np.array([64, 17, 0, 3], np.int32)
    want = np.asarray(jax_query.make_batch_score_fn(1, "lookup")(
        jax_index.arena, jax_index.row_offset, jax_index.block_width,
        jnp.asarray(terms), jnp.asarray(n_valid)))
    nb = lay.n_blocks
    if tiles == "one tile":
        pairs = [(index.arena, q.ShardPlan(0, 0, nb, lay.row_offset,
                                           lay.block_width))]
    else:
        pairs = [(index.arena[int(o):int(o) + int(w)].clone(),
                  q.ShardPlan(b, b, b + 1, np.zeros(1, np.int32),
                              lay.block_width[b:b + 1]))
                 for b, (o, w) in enumerate(zip(lay.row_offset,
                                                lay.block_width))][::-1]
    tiles_ = [t for t, _ in pairs]
    table = DeviceTileCache(index.storage).block_table(
        [sp for _, sp in pairs], tiles_, 0, nb)
    t = torch.from_numpy(terms.view(np.int32))
    if form == "batch":
        got = q.grouped_lookup(table, tiles_, t, torch.from_numpy(n_valid))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        for i, n in enumerate(n_valid):
            got = q.grouped_lookup(table, tiles_, t[i], int(n))
            np.testing.assert_array_equal(got.numpy(), want[i])
    with pytest.raises(ValueError, match="not the block table's"):
        q.grouped_lookup(table, [x.clone() for x in tiles_], t,
                         torch.from_numpy(n_valid))
    assert q.grouped_form(1, "lookup")
    assert not q.grouped_form(1, "vertical")
    assert not q.grouped_form(2, "lookup")


def test_hash_mirror_feeds_plan_rows():
    """The rows the engine addresses are the reference's hash % width +
    offset, for uint32 hashes above 2^31."""
    terms = np.array([[0xFFFFFFFF, 0xFFFFFFFF], [0x80000000, 1]], np.uint32)
    h = jax_hash_terms_np(terms, 2)
    got = q.plan_rows(hashing.hash_terms(
        torch.from_numpy(terms.view(np.int32)), 2),
        torch.tensor([0, 1000], dtype=torch.int32),
        torch.tensor([1000, 777], dtype=torch.int32))
    want = np.stack([h % 1000, h % 777 + 1000], axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# what this slice refuses
# --------------------------------------------------------------------------

def test_engine_refuses_what_is_not_ported(jax_indexes):
    """Sharded and compressed storage are ported now: a two-shard storage
    runs paged, and ``compressed=True`` on a raw index leaves the flag
    off. What the engine still refuses: an unknown method and an index on
    another device."""
    index = carry(jax_indexes[("compact", 1)])
    assert not QueryEngine(index, compressed=True, device=CPU).compressed
    layout = ArenaLayout.make([0, 32], [32, 32], [0, 1], [5, 5], 32, 2)
    words = np.zeros((64, 1), np.uint32)
    words[:, 0] = 1                      # every row holds slot 0 (doc 0)
    sharded = BitSlicedIndex(layout, MappedArena(
        [words[:32], words[32:]], [0, 32, 64], 1, device=CPU))
    engine = QueryEngine(sharded, method="lookup", device=CPU)
    assert engine.index.storage.n_shards == 2
    got = engine.score_terms(np.array([[1, 2], [3, 4]], np.uint32))
    np.testing.assert_array_equal(got, [2, 0])
    assert engine.tiles.faults == 2 and engine.tiles.prefetch_hits == 1
    with pytest.raises(ValueError, match="unknown method"):
        QueryEngine(index, method="fast", device=CPU)
    with pytest.raises(ValueError, match="lives on"):
        QueryEngine(index, device="meta")


# --------------------------------------------------------------------------
# an empty batch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hash_indexes(small_corpus, small_indexes):
    """Classic and compact indexes with one hash and with three."""
    params3 = JaxParams(n_hashes=3, fpr=0.3, kmer=15)
    classic1, compact1 = small_indexes
    return {
        ("classic", 1): classic1,
        ("compact", 1): compact1,
        ("classic", 3): jax_build_classic(small_corpus.doc_terms, params3),
        ("compact", 3): jax_build_compact(small_corpus.doc_terms, params3,
                                          block_docs=32, row_align=64),
    }


@pytest.mark.parametrize("n_hashes", [1, 3])
@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_empty_batch_equals_reference(hash_indexes, kind, n_hashes):
    """``search_batch([])`` under ``method="ref"`` answers ``[]``, as the
    JAX engine does."""
    jax_index = hash_indexes[(kind, n_hashes)]
    want = JaxEngine(jax_index, method="ref").search_batch([])
    got = QueryEngine(carry(jax_index), method="ref",
                      device=CPU).search_batch([])
    assert want == [] and got == []


def test_empty_batch_still_raises_where_reference_raises(hash_indexes):
    """``method="vertical"`` refuses an empty batch on both sides."""
    jax_index = hash_indexes[("compact", 1)]
    with pytest.raises(Exception):
        JaxEngine(jax_index, method="vertical").search_batch([])
    with pytest.raises(RuntimeError):
        QueryEngine(carry(jax_index), method="vertical",
                    device=CPU).search_batch([])
