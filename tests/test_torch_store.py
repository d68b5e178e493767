"""The PyTorch port's out-of-core store against the JAX package, on the CPU.

Stores written by the port's ``build_compact_streaming`` and by the JAX one
must be byte-equal (manifest, shard and popcount files; the ``meta.npz``
arrays), each package must open the other's stores, and every store
operation (resume, verify, codec migration, v1 migration, merges,
sub-stores) must give what the JAX operation gives. The port's
``DeviceTileCache`` must count exactly as the JAX cache does for the same
access sequence, and the paged ``QueryEngine`` must return the JAX paged
engine's results. Every comparison is exact: the outputs are words, bytes,
counts and document ids.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_classic as jax_build_classic
from repro.core import build_compact as jax_build_compact
from repro.core import index as jax_index_mod
from repro.core import query as jax_query
from repro.core import store as jax_store
from repro.data import make_corpus, make_queries
from repro.index import build_compact_parallel as jax_build_parallel
from repro.index import build_compact_streaming as jax_streaming

from repro_torch.core import (DeviceTileCache, IndexParams, MappedArena,
                              QueryEngine, build_classic, build_compact,
                              index_from_numpy, load_index, merge_classic,
                              merge_compact, save_index, store)
from repro_torch.core import query as q
from repro_torch.core.arena import common_tile_rows
from repro_torch.index import build_compact_parallel, build_compact_streaming

torch.set_num_threads(2)

CPU = "cpu"
PARAMS, JPARAMS = IndexParams(1, 0.3, 15), JaxParams(1, 0.3, 15)
KW = dict(block_docs=32, row_align=64)


def _corpus(n=96, seed=7, mean=400):
    return make_corpus(n, k=15, mean_length=mean, sigma=1.0, seed=seed)


def _redundant():
    """24 documents, each repeated 8 times (tests/test_compression.py's
    compressible regime: blocks of 128 hold few distinct columns)."""
    c = make_corpus(24, k=15, mean_length=160, min_length=120, seed=3)
    return c, [c.doc_terms[i % 24] for i in range(24 * 8)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def assert_same_files(a: Path, b: Path) -> None:
    """Same file names; byte-equal files; equal arrays in meta.npz (zip
    entries carry timestamps, so the npz bytes are not compared)."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        if n == "meta.npz":
            with np.load(a / n) as za, np.load(b / n) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
                    assert za[k].dtype == zb[k].dtype
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    """The 96-document corpus as a 3-shard raw store, written by each
    package, for one and two hash functions."""
    root = tmp_path_factory.mktemp("stores")
    out = {}
    for n in (1, 2):
        jdir, tdir = root / f"jax-{n}", root / f"port-{n}"
        jidx, jstats = jax_streaming(corpus.doc_terms, jdir,
                                     JaxParams(n, 0.3, 15), **KW)
        tidx, tstats = build_compact_streaming(
            corpus.doc_terms, tdir, IndexParams(n, 0.3, 15), **KW,
            device=CPU)
        out[n] = (jdir, tdir, jidx, tidx, jstats, tstats)
    return out


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A store with rowdict and raw shards: the redundant corpus built
    rowdict-coded and raw (2 shards each), merged by each package."""
    _, terms = _redundant()
    root = tmp_path_factory.mktemp("mixed")
    p = JaxParams(1, 0.03, 15)
    for codec in ("rowdict", "raw"):
        jax_streaming(terms, root / f"j-{codec}", p, block_docs=128,
                      codec=codec)
    jax_store.merge_stores(root / "j-rowdict", root / "j-raw", root / "jax")
    for codec in ("rowdict", "raw"):
        build_compact_streaming(terms, root / f"t-{codec}",
                                IndexParams(1, 0.03, 15), block_docs=128,
                                codec=codec, device=CPU)
    store.merge_stores(root / "t-rowdict", root / "t-raw", root / "port")
    return root


# --------------------------------------------------------------------------
# Store interop, both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bps", [1, 2])
@pytest.mark.parametrize("codec", ["raw", "rowdict", "auto"])
def test_streaming_store_files_equal_reference(tmp_path, codec, bps):
    c, terms = _redundant()
    p, jp = IndexParams(1, 0.03, 15), JaxParams(1, 0.03, 15)
    jidx, jstats = jax_streaming(terms, tmp_path / "jax", jp, block_docs=128,
                                 blocks_per_shard=bps, codec=codec)
    tidx, tstats = build_compact_streaming(
        terms, tmp_path / "port", p, block_docs=128, blocks_per_shard=bps,
        codec=codec, device=CPU)
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    if codec != "raw":
        assert tstats.n_compressed_shards > 0
    # each package opens the other's store
    want = np.asarray(jidx.storage.full_host())
    np.testing.assert_array_equal(
        store.load_index_v2(tmp_path / "jax", device=CPU).storage.full_host(),
        want)
    np.testing.assert_array_equal(
        jax_store.load_index_v2(tmp_path / "port").storage.full_host(), want)
    np.testing.assert_array_equal(tidx.storage.full_host(), want)


@pytest.mark.parametrize("n_hashes", [1, 2])
def test_raw_streaming_store_equals_reference_and_dense(built, corpus,
                                                        n_hashes):
    jdir, tdir, jidx, tidx, jstats, tstats = built[n_hashes]
    assert_same_files(jdir, tdir)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.n_shards == 3
    assert tstats.peak_block_bytes == tstats.max_shard_bytes \
        < tstats.total_arena_bytes
    dense = build_compact(corpus.doc_terms, IndexParams(n_hashes, 0.3, 15),
                          **KW, device=CPU)
    np.testing.assert_array_equal(tidx.storage.full_host(),
                                  dense.storage.full_host())
    assert isinstance(tidx.storage, MappedArena)
    assert tidx.device == torch.device(CPU)


def test_engines_agree_across_packages_and_stores(built, corpus):
    """The JAX engine on the port's store and the port's engine on the JAX
    store give the same results."""
    jdir, tdir, _, _, _, _ = built[1]
    pats, _ = make_queries(corpus, n_pos=3, n_neg=1, length=90, seed=2)
    want = JaxEngine(jax_store.load_index_v2(tdir)).search_batch(pats, 0.6)
    got = QueryEngine(store.load_index_v2(jdir, device=CPU),
                      device=CPU).search_batch(pats, 0.6)
    assert_same_results(got, want)


def test_mapped_arena_pages_not_loads(built):
    _, tdir, _, _, _, _ = built[1]
    idx = load_index(tdir, device=CPU)          # dispatches on the manifest
    assert isinstance(idx.storage, MappedArena)
    assert not idx.storage._open
    assert isinstance(idx.storage.shard_host(0), np.memmap)
    assert len(idx.storage._open) == 1


def test_mapped_arena_surface_equals_reference(mixed):
    _, jst, _ = jax_store.open_store(mixed / "jax")
    _, tst, _ = store.open_store(mixed / "port", device=CPU)
    n = jst.n_shards
    assert tst.n_shards == n == 4
    rows = np.array([[0, 5, tst.shape[0] - 1], [7, 7, 300]])
    np.testing.assert_array_equal(tst.read_rows_host(rows),
                                  jst.read_rows_host(rows))
    np.testing.assert_array_equal(tst.row_popcounts(rows),
                                  jst.row_popcounts(rows))
    assert tst.has_popcounts() and tst.mean_popcount() == jst.mean_popcount()
    assert tst.comp_summary() == jst.comp_summary()
    assert tst.dict_ratio() == jst.dict_ratio()
    for s in range(n):
        assert tst.shard_codec(s) == jst.shard_codec(s)
        assert tst.shard_comp_nbytes(s) == jst.shard_comp_nbytes(s)
        assert tst.shard_hbm_nbytes(s) == jst.shard_hbm_nbytes(s)
        np.testing.assert_array_equal(tst.shard_popcounts(s),
                                      jst.shard_popcounts(s))
        d, jd = tst.shard_dict_host(s), jst.shard_dict_host(s)
        assert (d is None) == (jd is None)
        if d is not None:
            for a, b in zip(d, jd):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    assert [tst.shard_codec(s) for s in range(n)] == \
        ["rowdict", "rowdict", "raw", "raw"]
    np.testing.assert_array_equal(tst.full_host(), jst.full_host())


# --------------------------------------------------------------------------
# Store operations
# --------------------------------------------------------------------------

def test_resume_from_partial_shards(built, corpus, tmp_path):
    """A store the JAX builder left half written is finished by the
    port's builder, and the result equals the full JAX store."""
    jdir, _, _, _, _, jstats = built[1]
    part = tmp_path / "partial"
    jax_streaming(corpus.doc_terms, part, JPARAMS, **KW)
    (part / "manifest.json").unlink()
    (part / "shard-000001.npy").unlink()
    idx, stats = build_compact_streaming(corpus.doc_terms, part, PARAMS,
                                         **KW, device=CPU)
    assert stats.n_resumed == jstats.n_shards - 1
    assert stats.peak_block_bytes == idx.storage.shard_nbytes(1)  # built
    assert_same_files(jdir, part)
    np.testing.assert_array_equal(
        idx.storage.full_host(),
        jax_store.load_index_v2(jdir).storage.full_host())


def test_verify_catches_a_flipped_byte(corpus, tmp_path):
    build_compact_streaming(corpus.doc_terms, tmp_path / "v", PARAMS, **KW,
                            device=CPU)
    f = tmp_path / "v" / "shard-000000.npy"
    a = np.load(f)
    a[0, 0] ^= np.uint32(1)
    np.save(f, a)
    store.load_index_v2(tmp_path / "v", device=CPU)          # lazy: fine
    with pytest.raises(IOError, match="hash mismatch"):
        store.load_index_v2(tmp_path / "v", verify=True, device=CPU)
    with pytest.raises(IOError):
        store.open_substore(tmp_path / "v", [0], verify=True, device=CPU)
    store.open_substore(tmp_path / "v", [1, 2], verify=True, device=CPU)


def test_migrate_store_codec_keeps_hashes(tmp_path):
    _, terms = _redundant()
    build_compact_streaming(terms, tmp_path / "raw", IndexParams(1, 0.03, 15),
                            block_docs=128, device=CPU)
    got = store.migrate_store_codec(tmp_path / "raw", tmp_path / "t-auto",
                                    codec="auto")
    back = store.migrate_store_codec(tmp_path / "t-auto", tmp_path / "t-raw",
                                     codec="raw")
    src = json.loads((tmp_path / "raw" / "manifest.json").read_text())
    assert [s["hash"] for s in got["shards"]] == \
        [s["hash"] for s in src["shards"]] == \
        [s["hash"] for s in back["shards"]]
    assert any(s["codec"] != "raw" for s in got["shards"])
    jax_store.migrate_store_codec(tmp_path / "raw", tmp_path / "j-auto",
                                  codec="auto")
    assert_same_files(tmp_path / "j-auto", tmp_path / "t-auto")
    assert_same_files(tmp_path / "raw", tmp_path / "t-raw")
    for name in ("t-auto", "t-raw"):
        _, st, _ = store.open_store(tmp_path / name, verify=True, device=CPU)
        _, jst, _ = jax_store.open_store(tmp_path / name, verify=True)
        np.testing.assert_array_equal(st.full_host(), jst.full_host())


def test_v1_save_load_both_ways(corpus, tmp_path):
    jdense = jax_build_compact(corpus.doc_terms, JPARAMS, **KW)
    dense = build_compact(corpus.doc_terms, PARAMS, **KW, device=CPU)
    save_index(dense, tmp_path / "port-v1")
    jax_index_mod.save_index(jdense, tmp_path / "jax-v1")
    assert (tmp_path / "port-v1" / "manifest.json").read_bytes() == \
        (tmp_path / "jax-v1" / "manifest.json").read_bytes()
    want = np.asarray(jdense.storage.full_host())
    got = load_index(tmp_path / "jax-v1", device=CPU)
    np.testing.assert_array_equal(got.storage.full_host(), want)
    np.testing.assert_array_equal(got.layout.doc_slot, jdense.layout.doc_slot)
    assert got.params.to_json() == jdense.params.to_json()
    np.testing.assert_array_equal(
        np.asarray(jax_index_mod.load_index(tmp_path / "port-v1").arena),
        want)
    # version=2 writes a store equal to the JAX one
    save_index(dense, tmp_path / "port-v2", version=2, blocks_per_shard=2)
    jax_index_mod.save_index(jdense, tmp_path / "jax-v2", version=2,
                             blocks_per_shard=2)
    assert_same_files(tmp_path / "jax-v2", tmp_path / "port-v2")


def test_migrate_v1_to_v2_equals_reference(corpus, tmp_path):
    jdense = jax_build_compact(corpus.doc_terms, JPARAMS, **KW)
    jax_index_mod.save_index(jdense, tmp_path / "v1")
    store.migrate_v1_to_v2(tmp_path / "v1", tmp_path / "port")
    jax_store.migrate_v1_to_v2(tmp_path / "v1", tmp_path / "jax")
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(ValueError, match="cobs-jax-v1"):
        store.migrate_v1_to_v2(tmp_path / "port", tmp_path / "again")


def test_merge_stores_links_shards_like_reference(tmp_path):
    ca, cb = _corpus(40, seed=41), _corpus(24, seed=42)
    for name, c in (("a", ca), ("b", cb)):
        build_compact_streaming(c.doc_terms, tmp_path / name, PARAMS, **KW,
                                device=CPU)
    store.merge_stores(tmp_path / "a", tmp_path / "b", tmp_path / "port")
    jax_store.merge_stores(tmp_path / "a", tmp_path / "b", tmp_path / "jax")
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    src, dst = tmp_path / "a" / "shard-000000.npy", \
        tmp_path / "port" / "shard-000000.npy"
    if src.stat().st_ino == dst.stat().st_ino:       # linked, not copied
        assert src.stat().st_nlink >= 3
    build_compact_streaming(cb.doc_terms, tmp_path / "c",
                            IndexParams(1, 0.1, 15), **KW, device=CPU)
    with pytest.raises(ValueError, match="parameter mismatch"):
        store.merge_stores(tmp_path / "a", tmp_path / "c", tmp_path / "m2")


def test_merge_compact_and_classic_equal_reference(tmp_path):
    ca, cb = _corpus(40, seed=31), _corpus(24, seed=32)
    # mapped + mapped: a shard-list concatenation that reads no bytes
    a, _ = build_compact_streaming(ca.doc_terms, tmp_path / "a", PARAMS,
                                   **KW, device=CPU)
    b, _ = build_compact_streaming(cb.doc_terms, tmp_path / "b", PARAMS,
                                   **KW, device=CPU)
    m = merge_compact(a, b)
    assert isinstance(m.storage, MappedArena)
    assert m.storage.sources[:a.storage.n_shards] == a.storage.sources
    assert not a.storage._open and not b.storage._open
    ja = jax_store.load_index_v2(tmp_path / "a")
    jb = jax_store.load_index_v2(tmp_path / "b")
    jm = jax_index_mod.merge_compact(ja, jb)
    for f in ("row_offset", "block_width", "doc_slot", "doc_n_terms"):
        np.testing.assert_array_equal(getattr(m.layout, f),
                                      getattr(jm.layout, f))
    np.testing.assert_array_equal(m.storage.shard_row_starts,
                                  jm.storage.shard_row_starts)
    np.testing.assert_array_equal(m.storage.full_host(),
                                  jm.storage.full_host())
    # dense + dense: concatenated on the device
    da = build_compact(ca.doc_terms, PARAMS, **KW, device=CPU)
    db = build_compact(cb.doc_terms, PARAMS, **KW, device=CPU)
    md = merge_compact(da, db)
    np.testing.assert_array_equal(md.storage.full_host(),
                                  jm.storage.full_host())
    pats, _ = make_queries(cb, n_pos=2, n_neg=1, length=80, seed=44)
    assert_same_results(QueryEngine(m, device=CPU).search_batch(pats, 0.8),
                        QueryEngine(md, device=CPU).search_batch(pats, 0.8))
    # classic + classic (equal widths: the same documents, reversed):
    # documents concatenate along the word axis
    docs = _corpus(32, seed=7).doc_terms
    ta = build_classic(docs, PARAMS, device=CPU)
    tb = build_classic(docs[::-1], PARAMS, device=CPU)
    want = jax_index_mod.merge_classic(jax_build_classic(docs, JPARAMS),
                                       jax_build_classic(docs[::-1], JPARAMS))
    got = merge_classic(ta, tb)
    np.testing.assert_array_equal(got.storage.full_host(),
                                  np.asarray(want.arena))
    for f in ("row_offset", "block_width", "doc_slot", "doc_n_terms"):
        np.testing.assert_array_equal(getattr(got.layout, f),
                                      getattr(want.layout, f))
    assert (got.block_docs, got.n_docs) == (want.block_docs, want.n_docs)
    with pytest.raises(ValueError):
        merge_classic(da, db)
    with pytest.raises(ValueError, match="parameter mismatch"):
        merge_compact(da, build_compact(cb.doc_terms, IndexParams(2, 0.3, 15),
                                        **KW, device=CPU))


def test_substore_and_plan_shards_subset_equal_reference(built, corpus):
    _, tdir, _, _, _, _ = built[1]
    for ids in ([0, 2], [2, 1, 2], [1]):
        sub = store.open_substore(tdir, ids, verify=True, device=CPU)
        jsub = jax_store.open_substore(tdir, ids, verify=True)
        assert sub.shard_ids == jsub.shard_ids
        assert sub.n_shards_total == jsub.n_shards_total == 3
        np.testing.assert_array_equal(sub.global_row_starts,
                                      jsub.global_row_starts)
        np.testing.assert_array_equal(sub.storage.full_host(),
                                      jsub.storage.full_host())
        got = q.plan_shards_subset(sub.layout, sub.global_row_starts,
                                   sub.shard_ids)
        want = jax_query.plan_shards_subset(jsub.layout,
                                            jsub.global_row_starts,
                                            jsub.shard_ids)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.shard, g.block_start, g.block_end) == \
                (w.shard, w.block_start, w.block_end)
            np.testing.assert_array_equal(g.row_offset, w.row_offset)
            np.testing.assert_array_equal(g.block_width, w.block_width)
            assert g.row_offset.dtype == w.row_offset.dtype
    with pytest.raises(ValueError, match="out of range"):
        store.open_substore(tdir, [3], device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        store.open_substore(tdir, [], device=CPU)


def test_layout_and_shard_bounds_equal_reference(built):
    _, tdir, jidx, tidx, _, _ = built[1]
    for bps in (1, 2, 3, 5):
        bounds = store.shard_row_bounds(tidx.layout, bps)
        np.testing.assert_array_equal(
            bounds, jax_store.shard_row_bounds(jidx.layout, bps))
        assert tidx.layout.shard_blocks(bounds) == \
            jidx.layout.shard_blocks(bounds)
    for b in range(tidx.layout.n_blocks):
        assert tidx.layout.block_row_range(b) == \
            jidx.layout.block_row_range(b)
    with pytest.raises(ValueError, match="block boundary"):
        tidx.layout.shard_blocks(np.array([0, 7], np.int64))
    with pytest.raises(ValueError):
        store.shard_row_bounds(tidx.layout, 0)
    plans = q.plan_shards(tidx.layout, tidx.storage.shard_row_starts)
    assert [(p.block_start, p.block_end) for p in plans] == \
        [(0, 1), (1, 2), (2, 3)]
    assert all(int(p.row_offset[0]) == 0 for p in plans)
    m = np.random.default_rng(0).integers(0, 2 ** 32, size=(70000, 3),
                                          dtype=np.uint32)
    np.testing.assert_array_equal(store.row_popcounts(m),
                                  jax_store.row_popcounts(m))


def test_build_compact_parallel_equals_reference(corpus, tmp_path):
    want = jax_build_parallel(corpus.doc_terms, JaxParams(kmer=15), **KW,
                              workers=1, checkpoint_dir=tmp_path / "jax")
    for workers in (1, 3):
        got = build_compact_parallel(corpus.doc_terms, IndexParams(kmer=15),
                                     **KW, workers=workers,
                                     checkpoint_dir=tmp_path / f"p{workers}",
                                     device=CPU)
        np.testing.assert_array_equal(got.storage.full_host(),
                                      np.asarray(want.arena))
        assert_same_files(tmp_path / "jax", tmp_path / f"p{workers}")
    # a restart reads the checkpoints: poison one and see it come back
    victim = tmp_path / "p1" / "block000001.npy"
    m = np.load(victim)
    m[0, 0] ^= np.uint32(1)
    np.save(victim, m)
    again = build_compact_parallel(corpus.doc_terms, IndexParams(kmer=15),
                                   **KW, workers=1,
                                   checkpoint_dir=tmp_path / "p1",
                                   device=CPU)
    r0 = int(again.layout.row_offset[1])
    assert again.storage.full_host()[r0, 0] == \
        np.asarray(want.arena)[r0, 0] ^ np.uint32(1)


# --------------------------------------------------------------------------
# The tile cache: the JAX cache's counters for the same access sequence
# --------------------------------------------------------------------------

OPS = [("get_c", 0), ("get", 2), ("get", 3), ("prefetch_c", 1),
       ("get_c", 1), ("get", 2), ("get_c", 0), ("prefetch", 3),
       ("prefetch", 3), ("get", 3), ("get", 0), ("get_c", 2), ("get_c", 1),
       ("prefetch_c", 0), ("get", 1), ("get_c", 0), ("clear", None),
       ("get", 3), ("get_c", 1), ("get_c", 1)]


def _counters(cache, evictions) -> dict:
    return {
        "hits": cache.hits, "faults": cache.faults,
        "prefetched": cache.prefetched, "prefetch_hits": cache.prefetch_hits,
        "evictions": evictions, "resident_bytes": cache.resident_bytes,
        "raw_bytes_staged": cache.raw_bytes_staged,
        "comp_bytes_staged": cache.comp_bytes_staged,
        "shard_hits": cache.shard_hits, "shard_faults": cache.shard_faults,
        "shard_evictions": cache.shard_evictions, "len": len(cache),
        "resident": cache.resident_shards,
        "has_c": [cache.has_compressed(s) for s in range(4)],
    }


def _apply(cache, op, s):
    """One access; returns the tile(s) as numpy uint32 (or the error type,
    or the bool a prefetch returns)."""
    try:
        if op == "clear":
            return cache.clear()
        out = {"get": cache.get, "get_c": cache.get_compressed,
               "prefetch": cache.prefetch,
               "prefetch_c": cache.prefetch_compressed}[op](s)
    except ValueError:
        return "ValueError"
    if isinstance(out, bool):
        return out
    parts = out if isinstance(out, tuple) else (out,)
    return [p.numpy().view(np.uint32) if isinstance(p, torch.Tensor)
            else np.asarray(p).view(np.uint32) for p in parts]


@pytest.mark.parametrize("cap,pad", [("two", False), ("two", True),
                                     ("one", False), (None, True)])
def test_tile_cache_counts_like_reference(mixed, cap, pad):
    _, jst, _ = jax_store.open_store(mixed / "jax")
    _, tst, _ = store.open_store(mixed / "port", device=CPU)
    hbm = max(tst.shard_hbm_nbytes(s) for s in range(4))
    raw = max(tst.shard_nbytes(s) for s in range(4))
    capacity = {"two": raw + hbm, "one": raw, None: None}[cap]
    pad_rows = common_tile_rows(tst) if pad else None
    jc = JaxCache(jst, capacity_bytes=capacity, pad_rows_to=pad_rows)
    tc = DeviceTileCache(tst, capacity_bytes=capacity, pad_rows_to=pad_rows)
    jev, tev = [], []
    jc.observer = lambda s, e, _t: jev.append((s, e))
    tc.observer = lambda s, e, _t: tev.append((s, e))
    for op, s in OPS:
        got, want = _apply(tc, op, s), _apply(jc, op, s)
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            assert got == want, (op, s)
        assert _counters(tc, tc.evictions) == _counters(
            jc, sum(jc.shard_evictions.values())), (op, s)
    assert tev == jev
    if cap == "two":
        assert tc.evictions > 0
        # ratio-aware eviction: a raw tile went while an older dict entry
        # stayed resident
        assert any(e == "eviction" and s in (2, 3) for s, e in tev)


def test_tile_cache_refs_checked_once_at_staging(mixed):
    _, tst, _ = store.open_store(mixed / "port", device=CPU)
    d, refs = tst.shard_dict_host(0)
    bad = refs.copy()
    bad[5] = d.shape[0]
    tst._open_dict[0] = (d, bad)
    with pytest.raises(ValueError, match="refs outside"):
        DeviceTileCache(tst).get_compressed(0)
    with pytest.raises(ValueError, match="no dict form"):
        DeviceTileCache(tst).get_compressed(2)
    with pytest.raises(ValueError, match="taller"):
        DeviceTileCache(tst, pad_rows_to=8).get_compressed(1)


# --------------------------------------------------------------------------
# The paged engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patterns(corpus):
    pats, _ = make_queries(corpus, n_pos=3, n_neg=2, length=80, seed=11)
    return pats[:4] + [pats[0][:24], pats[1][:10]]


@pytest.mark.parametrize("method", ["ref", "unpack", "vertical", "lookup"])
@pytest.mark.parametrize("n_hashes", [1, 2])
def test_paged_engine_equals_reference(built, patterns, n_hashes, method):
    _, _, jidx, tidx, _, _ = built[n_hashes]
    want = JaxEngine(jidx, method=method)
    got = QueryEngine(tidx, method=method, device=CPU)
    assert got.index.storage.n_shards > 1 and not got.compressed
    assert_same_results([got.search(p, 0.5) for p in patterns],
                        [want.search(p, 0.5) for p in patterns])
    assert_same_results(got.search_batch(patterns, 0.5),
                        want.search_batch(patterns, 0.5))
    assert_same_results([got.top_k(p, 5) for p in patterns[:3]],
                        [want.top_k(p, 5) for p in patterns[:3]])
    assert (got.tiles.faults, got.tiles.hits, got.tiles.prefetch_hits) == \
        (want.tiles.faults, want.tiles.hits, want.tiles.prefetch_hits)


def test_paged_engine_under_a_byte_cap_equals_dense(built, corpus, patterns):
    """One tile of room: every query pages every shard in turn, with the
    next shard prefetched; results equal the dense engine's."""
    _, _, _, tidx, _, tstats = built[1]
    dense = build_compact(corpus.doc_terms, PARAMS, **KW, device=CPU)
    cache = DeviceTileCache(tidx.storage,
                            capacity_bytes=tstats.max_shard_bytes)
    paged = QueryEngine(tidx, method="lookup", tile_cache=cache, device=CPU)
    ref = QueryEngine(dense, method="lookup", device=CPU)
    assert_same_results(paged.search_batch(patterns, 0.5),
                        ref.search_batch(patterns, 0.5))
    assert_same_results([paged.top_k(p, 3) for p in patterns],
                        [ref.top_k(p, 3) for p in patterns])
    assert cache.faults > tidx.storage.n_shards
    assert cache.evictions > 0 and cache.prefetch_hits > 0
    assert cache.resident_bytes <= tstats.max_shard_bytes


# --------------------------------------------------------------------------
# device=None means the card
# --------------------------------------------------------------------------

def test_store_entry_points_need_cuda_unless_told(monkeypatch, built,
                                                  corpus, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdir, _, tidx, _, _ = built[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        store.open_store(tdir)
    with pytest.raises(RuntimeError, match="CUDA"):
        store.load_index_v2(tdir)
    with pytest.raises(RuntimeError, match="CUDA"):
        store.open_substore(tdir, [0])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_index(tdir)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_compact_streaming(corpus.doc_terms[:8], tmp_path / "x", PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_compact_parallel(corpus.doc_terms[:8], PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        MappedArena([np.zeros((4, 1), np.uint32)], [0, 4], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTileCache(tidx.storage, device="cuda")
    cache = DeviceTileCache(tidx.storage)        # the storage's device
    assert cache.device == torch.device(CPU)
    assert cache.get(0).device == torch.device(CPU)
    carried = index_from_numpy(tidx.storage.full_host(),
                               tidx.layout.row_offset,
                               tidx.layout.block_width, tidx.layout.doc_slot,
                               tidx.layout.doc_n_terms, 32, tidx.n_docs,
                               PARAMS.to_json(), device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(carried)
