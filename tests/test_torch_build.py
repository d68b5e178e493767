"""The PyTorch port's host inputs, hash and index build against the JAX
package, on the CPU.

Every comparison is exact (``np.testing.assert_array_equal``): the outputs
are uint32 words, integer counts and document ids, where a tolerance would
hide an off-by-one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import IndexParams as JaxParams
from repro.core import bloom as jax_bloom
from repro.core import build_classic as jax_build_classic
from repro.core import build_compact as jax_build_compact
from repro.core import dna as jax_dna
from repro.core import theory as jax_theory
from repro.core.hashing import hash_terms_np as jax_hash_terms_np
from repro.core.index import plan_compact_layout as jax_plan_compact_layout
from repro.data import make_queries as jax_make_queries

from repro_torch.core import (ArenaLayout, DeviceArena, DeviceTileCache,
                              HostArena, IndexParams, bloom, build_classic,
                              build_compact, dna, hashing, index_from_numpy,
                              theory)
from repro_torch.core.arena import (ArenaStorage, common_tile_rows,
                                    wrap_arena)
from repro_torch.core.index import plan_compact_layout
from repro_torch.data import make_corpus, make_queries

torch.set_num_threads(2)

CPU = "cpu"


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def port_corpus():
    return make_corpus(64, k=15, mean_length=400, sigma=1.0, seed=7)


# --------------------------------------------------------------------------
# hashing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_hashes", [1, 2, 3])
def test_hash_terms_equals_reference(n_hashes):
    rng = np.random.default_rng(n_hashes)
    terms = rng.integers(0, 2 ** 32, size=(2000, 2), dtype=np.uint32)
    terms[:8] = 0xFFFFFFFF                 # both words all ones
    terms[8:16, 0] = 0xFFFFFFFF            # lo all ones
    terms[16:24, 1] = 0xFFFFFFFF           # hi all ones
    terms[24:32] = 0
    want = jax_hash_terms_np(terms, n_hashes)
    np.testing.assert_array_equal(
        _u32(hashing.hash_terms(_i32(terms), n_hashes)), want)
    np.testing.assert_array_equal(hashing.hash_terms_np(terms, n_hashes),
                                  want)
    # leading batch axes hash elementwise
    batched = hashing.hash_terms(_i32(terms.reshape(40, 50, 2)), n_hashes)
    np.testing.assert_array_equal(_u32(batched).reshape(2000, n_hashes), want)


def test_hash_terms_rejects_non_int32():
    with pytest.raises(TypeError):
        hashing.hash_terms(torch.zeros((4, 2), dtype=torch.int64), 1)


def test_word_convention_helpers():
    x = _i32(np.array([0x80000000, 0xFFFFFFFF, 1, 0x7FFFFFFF], np.uint32))
    np.testing.assert_array_equal(
        _u32(hashing.lsr(x, 13)),
        np.array([0x80000000, 0xFFFFFFFF, 1, 0x7FFFFFFF], np.uint32) >> 13)
    np.testing.assert_array_equal(
        hashing.as_unsigned(x).numpy(),
        np.array([0x80000000, 0xFFFFFFFF, 1, 0x7FFFFFFF], np.int64))


# --------------------------------------------------------------------------
# host inputs: dna, theory, synthetic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 16, 17, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_dna_equals_reference(k, canonical):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=300, dtype=np.uint8)
    codes = np.concatenate([codes, codes[:100]])       # repeated k-mers
    np.testing.assert_array_equal(dna.pack_kmers(codes, k, canonical),
                                  jax_dna.pack_kmers(codes, k, canonical))
    terms = dna.pack_kmers(codes, k, canonical)
    np.testing.assert_array_equal(dna.unique_terms(terms),
                                  jax_dna.unique_terms(terms))
    reads = [codes[:150], codes[100:], codes[:k - 1]]
    np.testing.assert_array_equal(
        dna.document_terms(reads, k, canonical),
        jax_dna.document_terms(reads, k, canonical))
    seq = "ACGTNacgt" * 7
    np.testing.assert_array_equal(dna.encode_dna(seq),
                                  jax_dna.encode_dna(seq))


def test_theory_equals_reference():
    for v in (0, 1, 10, 1234, 10 ** 6):
        for fpr in (0.01, 0.3, 0.9):
            for k in (1, 2, 3):
                assert theory.bloom_size(v, fpr, k) == \
                    jax_theory.bloom_size(v, fpr, k)
                w = theory.bloom_size(v, fpr, k)
                assert theory.bloom_fpr(w, k, v) == \
                    jax_theory.bloom_fpr(w, k, v)


def test_make_corpus_equals_reference(small_corpus, port_corpus):
    assert port_corpus.names == small_corpus.names
    assert port_corpus.k == small_corpus.k
    for a, b in zip(port_corpus.documents, small_corpus.documents):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_corpus.doc_terms, small_corpus.doc_terms):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_corpus.term_counts(),
                                  small_corpus.term_counts())


@pytest.mark.parametrize("length", [20, 80, 160])
def test_make_queries_equals_reference(small_corpus, port_corpus, length):
    want, want_o = jax_make_queries(small_corpus, n_pos=6, n_neg=6,
                                    length=length, seed=length)
    got, got_o = make_queries(port_corpus, n_pos=6, n_neg=6, length=length,
                              seed=length)
    np.testing.assert_array_equal(got_o, want_o)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_hashes", [1, 2])
def test_build_filters_and_pack_equal_reference(n_hashes):
    rng = np.random.default_rng(10 + n_hashes)
    C, T, w = 64, 1024, 700
    terms = rng.integers(0, 2 ** 32, size=(C, T, 2), dtype=np.uint32)
    counts = rng.integers(0, T + 1, size=C).astype(np.int32)
    counts[:3] = (0, T, 1)
    want = np.asarray(jax_bloom.build_filters(jnp.asarray(terms),
                                              jnp.asarray(counts), w,
                                              n_hashes))
    got = bloom.build_filters(_i32(terms), torch.from_numpy(counts), w,
                              n_hashes)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _u32(bloom.pack_doc_major(got)),
        np.asarray(jax_bloom.pack_doc_major(jnp.asarray(want))))


def test_pack_doc_major_needs_32_docs():
    with pytest.raises(ValueError):
        bloom.pack_doc_major(torch.zeros((31, 8), dtype=torch.bool))


def test_plan_compact_layout_equals_reference(port_corpus):
    counts = port_corpus.term_counts()
    for block_docs, row_align in ((32, 64), (40, 512), (1024, 512)):
        got, got_order = plan_compact_layout(counts, IndexParams(1, 0.3, 15),
                                             block_docs, row_align)
        want, want_order = jax_plan_compact_layout(
            counts, JaxParams(1, 0.3, 15), block_docs, row_align)
        np.testing.assert_array_equal(got_order, want_order)
        for f in ("row_offset", "block_width", "doc_slot", "doc_n_terms"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.block_docs, got.n_docs) == (want.block_docs, want.n_docs)


@pytest.mark.parametrize("n_hashes", [1, 2])
@pytest.mark.parametrize("kind", ["compact", "classic"])
def test_arena_equals_reference(small_corpus, port_corpus, kind, n_hashes):
    """The port's build gives the JAX arena word for word."""
    jp, tp = JaxParams(n_hashes, 0.3, 15), IndexParams(n_hashes, 0.3, 15)
    if kind == "compact":
        want = jax_build_compact(small_corpus.doc_terms, jp, block_docs=32,
                                 row_align=64)
        got = build_compact(port_corpus.doc_terms, tp, block_docs=32,
                            row_align=64, device=CPU)
    else:
        want = jax_build_classic(small_corpus.doc_terms, jp)
        got = build_classic(port_corpus.doc_terms, tp, device=CPU)
    np.testing.assert_array_equal(got.storage.full_host(),
                                  np.asarray(want.storage.full_host()))
    for f in ("row_offset", "block_width", "doc_slot", "doc_n_terms"):
        np.testing.assert_array_equal(getattr(got.layout, f),
                                      getattr(want.layout, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want.layout, f))
    assert (got.n_blocks, got.total_rows, got.n_slots, got.size_bytes()) == \
        (want.n_blocks, want.total_rows, want.n_slots, want.size_bytes())
    np.testing.assert_array_equal(got.expected_fpr(), want.expected_fpr())


def test_small_chunks_give_the_same_block():
    rng = np.random.default_rng(4)
    docs = [rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
            for n in (0, 5, 2000, 77)]
    whole = bloom.build_block_matrix(docs, 1000, 2, 64, torch.device(CPU))
    chunked = bloom.build_block_matrix(docs, 1000, 2, 64, torch.device(CPU),
                                       max_chunk_bytes=32 * 1000)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    np.testing.assert_array_equal(
        _u32(whole), jax_bloom.build_block_matrix(docs, 1000, 2, 64))


def test_build_rejects_empty_and_oversized():
    with pytest.raises(ValueError):
        build_compact([], device=CPU)
    with pytest.raises(ValueError):
        build_classic([], device=CPU)
    with pytest.raises(ValueError):
        bloom.build_block_matrix([np.zeros((1, 2), np.uint32)] * 33, 512, 1,
                                 32, torch.device(CPU))


def test_index_from_numpy_carries_a_jax_index(small_indexes):
    for want in small_indexes:
        lay = want.layout
        got = index_from_numpy(np.asarray(want.storage.full_host()),
                               lay.row_offset, lay.block_width, lay.doc_slot,
                               lay.doc_n_terms, lay.block_docs, lay.n_docs,
                               want.params.to_json(), device=CPU)
        np.testing.assert_array_equal(_u32(got.arena),
                                      np.asarray(want.storage.full_host()))
        assert got.params.to_json() == want.params.to_json()
        assert got.layout.n_blocks == lay.n_blocks
        assert got.device == torch.device(CPU)


def test_index_rejects_mismatched_storage():
    from repro_torch.core import BitSlicedIndex
    layout = ArenaLayout.make([0], [64], [0], [3], 32, 1)
    with pytest.raises(ValueError):
        BitSlicedIndex(layout, DeviceArena(torch.zeros((63, 1), dtype=torch.int32)))


# --------------------------------------------------------------------------
# storage and the tile cache
# --------------------------------------------------------------------------

def test_arena_storages_agree():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 32, size=(50, 3), dtype=np.uint32)
    host = HostArena(words, device=CPU)
    dev = DeviceArena(_i32(words))
    for st in (host, dev, wrap_arena(words, device=CPU),
               wrap_arena(_i32(words))):
        assert st.n_shards == 1 and st.nbytes() == words.nbytes
        np.testing.assert_array_equal(st.full_host(), words)
        np.testing.assert_array_equal(_u32(st.full_device()), words)
    assert wrap_arena(host) is host
    assert common_tile_rows(host) is None
    with pytest.raises(TypeError):
        DeviceArena(torch.zeros((4, 2), dtype=torch.int64))


class _Shards(ArenaStorage):
    """Three host shards of 4, 6 and 2 rows (a multi-shard storage)."""

    def __init__(self):
        rng = np.random.default_rng(8)
        self.parts = [rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
                      for n in (4, 6, 2)]
        self.shard_row_starts = np.array([0, 4, 10, 12], np.int64)
        self.shape = (12, 2)
        self.device = torch.device(CPU)

    def shard_host(self, s):
        return self.parts[s]


def test_tile_cache_counts_and_evicts():
    st = _Shards()
    assert common_tile_rows(st) == 6
    cache = DeviceTileCache(st, capacity_bytes=2 * 6 * 2 * 4,
                            pad_rows_to=common_tile_rows(st))
    t0 = cache.get(0)
    assert t0.shape == (6, 2)
    np.testing.assert_array_equal(_u32(t0[:4]), st.parts[0])
    assert (t0[4:] == 0).all()
    assert cache.get(0) is t0
    assert cache.prefetch(1) and not cache.prefetch(1)
    cache.get(1)
    assert (cache.hits, cache.faults, cache.prefetched,
            cache.prefetch_hits) == (2, 2, 1, 1)
    cache.get(2)                                  # evicts shard 0 (LRU)
    assert cache.resident_shards == (1, 2)
    assert cache.evictions == 1
    assert cache.resident_bytes == 2 * 6 * 2 * 4
    np.testing.assert_array_equal(_u32(cache.get(2)[:2]), st.parts[2])
    with pytest.raises(ValueError):
        DeviceTileCache(st, pad_rows_to=5).get(1)
