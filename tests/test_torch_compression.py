"""The PyTorch port's compressed arena against the JAX package, on the CPU.

The codec must encode every tile as the JAX codec does (same codec chosen,
equal component arrays); the fused-decode wrappers' plain versions must
equal the JAX ``ops.bitslice_lookup_score_*_comp`` (Pallas in interpret
mode) and the oracles; and ``QueryEngine(compressed=True)`` must return
the JAX compressed engine's results, which equal the raw engine's, for
one and two hash functions. The corpus is tests/test_compression.py's
compressible regime: every document repeated so that blocks of 128 hold
few distinct columns. Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import codec as jax_codec
from repro.core import query as jax_query
from repro.core import store as jax_store
from repro.data import make_corpus
from repro.index import build_compact_streaming as jax_streaming
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.core import IndexParams, QueryEngine, codec, store
from repro_torch.core import query as q
from repro_torch.index import build_compact_streaming
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import bitslice_score as k

torch.set_num_threads(2)

CPU = "cpu"
METHODS = ["ref", "unpack", "vertical", "lookup"]


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _redundant(n_base=24, reps=8, seed=3):
    c = make_corpus(n_base, k=15, mean_length=160, min_length=120,
                    seed=seed)
    return c, [c.doc_terms[i % n_base] for i in range(n_base * reps)]


def _patterns(c, n_random=6, seed=0):
    rng = np.random.default_rng(seed)
    pats = ["".join(rng.choice(list("ACGT"), size=60))
            for _ in range(n_random)]
    return pats + [c.documents[i][10:90] for i in range(5)]


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)


# --------------------------------------------------------------------------
# Codec
# --------------------------------------------------------------------------

def _tile(kind: str, rows: int, words: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return rng.integers(0, 2 ** 32, size=(rows, words), dtype=np.uint32)
    if kind == "sparse":
        return (rng.random((rows, words)) < 0.05).astype(np.uint32) << 31
    if kind == "zero":
        return np.zeros((rows, words), dtype=np.uint32)
    if kind == "ones":
        t = np.zeros((rows, words), dtype=np.uint32)
        t[::3] = 0xFFFFFFFF
        return t
    base = rng.integers(0, 2 ** 32, size=(max(1, rows // 8), words),
                        dtype=np.uint32)
    base[0] = 0xFFFFFFFF
    base[-1, 0] = 0x80000000
    return base[rng.integers(0, base.shape[0], size=rows)]


@pytest.mark.parametrize("kind", ["dense", "sparse", "zero", "ones",
                                  "redundant"])
@pytest.mark.parametrize("which", ["raw", "rowdict", "bitplane_rle",
                                   "rowdict+rle", "auto"])
def test_encode_tile_equals_reference(which, kind):
    for rows, words, seed in ((96, 4, 1), (33, 1, 2), (200, 9, 3)):
        tile = _tile(kind, rows, words, seed)
        got = codec.encode_tile(tile, which)
        want = jax_codec.encode_tile(tile, which)
        assert (got.codec, got.rows, got.doc_words) == \
            (want.codec, want.rows, want.doc_words)
        assert sorted(got.arrays) == sorted(want.arrays)
        for name in want.arrays:
            np.testing.assert_array_equal(got.arrays[name],
                                          want.arrays[name])
            assert got.arrays[name].dtype == want.arrays[name].dtype
        assert (got.raw_nbytes, got.comp_nbytes, got.ratio) == \
            (want.raw_nbytes, want.comp_nbytes, want.ratio)
        np.testing.assert_array_equal(got.decode(), tile)
        d = got.dict_form()
        assert (d is None) == (got.codec not in codec.DICT_CODECS)
        if d is not None:
            np.testing.assert_array_equal(d[0][d[1]], tile)
    if kind == "redundant" and which in ("rowdict", "auto"):
        assert got.codec == "rowdict"


def test_codec_constants_and_rle_equal_reference():
    assert codec.CODECS == jax_codec.CODECS
    assert codec.DICT_CODECS == jax_codec.DICT_CODECS
    assert codec.MIN_ENCODE_GAIN == jax_codec.MIN_ENCODE_GAIN
    assert codec.COMPONENT_SUFFIX == jax_codec.COMPONENT_SUFFIX
    rng = np.random.default_rng(11)
    for density in (0.0, 0.01, 0.2, 0.9, 1.0):
        m = (rng.random((64, 8)) < density).astype(np.uint32) * \
            rng.integers(1, 2 ** 32, size=(64, 8), dtype=np.uint32)
        got = codec.rle_encode(m)
        np.testing.assert_array_equal(got, jax_codec.rle_encode(m))
        np.testing.assert_array_equal(codec.rle_decode(got), m)
    np.testing.assert_array_equal(
        codec.rle_encode(np.zeros((0, 3), np.uint32)),
        jax_codec.rle_encode(np.zeros((0, 3), np.uint32)))
    with pytest.raises(ValueError, match="unknown codec"):
        codec.encode_tile(np.zeros((4, 4), np.uint32), "zip")
    with pytest.raises(ValueError, match="unknown codec"):
        codec.tile_from_arrays("zip", {}, 4, 4)


# --------------------------------------------------------------------------
# The fused-decode kernels' plain versions
# --------------------------------------------------------------------------

COMP_SHAPES = [(1, 1, 8, 8, 40, 6), (3, 2, 17, 4, 300, 31),
               (2, 2, 64, 4, 700, 155), (1, 3, 33, 130, 90, 11)]


@pytest.mark.parametrize("Q,nb,L,W,R,D", COMP_SHAPES)
def test_comp_lookups_equal_reference(Q, nb, L, W, R, D):
    rng = np.random.default_rng(Q * 1000 + L)
    dict_rows = rng.integers(0, 2 ** 32, size=(D, W), dtype=np.uint32)
    dict_rows[0] = 0xFFFFFFFF
    refs = rng.integers(0, D, size=R).astype(np.int32)
    idx = rng.integers(0, R, size=(Q, nb, L)).astype(np.int32)
    idx[..., 1] = idx[..., 0]                       # duplicate rows
    mask = rng.integers(0, 2, size=(Q, nb, L)).astype(np.int32)
    mask[0, 0] = 0                                  # a cell of no terms
    expanded = dict_rows[refs]
    want_multi = np.asarray(jax_ref.bitslice_lookup_score_multi_ref(
        jnp.asarray(expanded), jnp.asarray(idx), jnp.asarray(mask)))
    want_blocks = want_multi[0]
    args = (_t(dict_rows), _t(refs), _t(idx), _t(mask))
    for grid_order in ("wq", "qw"):
        np.testing.assert_array_equal(ops.bitslice_lookup_score_multi_comp(
            *args, grid_order=grid_order).numpy(), want_multi)
    np.testing.assert_array_equal(
        ref.bitslice_lookup_score_multi_comp_ref(*args).numpy(), want_multi)
    b_args = (_t(dict_rows), _t(refs), _t(idx[0]), _t(mask[0]))
    np.testing.assert_array_equal(
        ops.bitslice_lookup_score_blocks_comp(*b_args).numpy(), want_blocks)
    np.testing.assert_array_equal(
        ref.bitslice_lookup_score_blocks_comp_ref(*b_args).numpy(),
        want_blocks)
    # the raw lookup on the expanded tile is the same function
    np.testing.assert_array_equal(
        k.lookup_score_multi_compressed(*args).numpy(),
        k.lookup_score_multi(_t(expanded), _t(idx), _t(mask)).numpy())
    if W <= 8:                      # Pallas interpret mode: small shapes
        jargs = (jnp.asarray(dict_rows), jnp.asarray(refs))
        np.testing.assert_array_equal(np.asarray(
            jax_ops.bitslice_lookup_score_multi_comp(
                *jargs, jnp.asarray(idx), jnp.asarray(mask))), want_multi)
        np.testing.assert_array_equal(np.asarray(
            jax_ops.bitslice_lookup_score_blocks_comp(
                *jargs, jnp.asarray(idx[0]), jnp.asarray(mask[0]))),
            want_blocks)


def test_comp_wrappers_check_their_inputs():
    d = torch.zeros((6, 4), dtype=torch.int32)
    refs = torch.zeros(10, dtype=torch.int32)
    idx = torch.zeros((2, 5), dtype=torch.int32)
    blocks, multi = k.lookup_score_blocks_compressed, \
        k.lookup_score_multi_compressed
    assert blocks(d, refs, idx, idx).shape == (2, 4, 32)
    assert multi(d, refs, idx[None], idx[None]).shape == (1, 2, 4, 32)
    with pytest.raises(TypeError, match="int32"):
        blocks(d.to(torch.int64), refs, idx, idx)
    with pytest.raises(TypeError, match="int32"):
        blocks(d, refs.to(torch.int64), idx, idx)
    with pytest.raises(TypeError, match="int32"):
        blocks(d, refs, idx.to(torch.int16), idx)
    with pytest.raises(TypeError):
        blocks(d.numpy(), refs, idx, idx)
    with pytest.raises(ValueError, match="dimensions"):
        blocks(d, refs[None], idx, idx)
    with pytest.raises(ValueError, match="dimensions"):
        multi(d, refs, idx, idx)
    with pytest.raises(ValueError, match="mask shape"):
        blocks(d, refs, idx, idx[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        blocks(torch.zeros((4, 6), dtype=torch.int32).T, refs, idx, idx)
    with pytest.raises(IndexError, match="refs"):
        blocks(d, refs, idx + 10, idx)
    with pytest.raises(IndexError):
        multi(d, refs, idx[None] - 1, idx[None])
    # more terms than 16 counter planes count: no cap, the plain counts
    big = torch.zeros((1, 1 << 16), dtype=torch.int32)
    assert torch.equal(blocks(d - 1, refs, big, big + 1),
                       torch.full((1, 4, 32), 1 << 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="grid_order"):
        multi(d, refs, idx[None], idx[None], grid_order="ww")
    with pytest.raises(ValueError, match="different devices"):
        blocks(d, refs.to("meta"), idx, idx)


def test_comp_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(k.launches)
    d = _t(np.arange(24, dtype=np.uint32).reshape(6, 4))
    refs = _t(np.arange(9, dtype=np.int32) % 6)
    idx = _t(np.arange(18, dtype=np.int32).reshape(1, 2, 9) % 9)
    k.lookup_score_blocks_compressed(d, refs, idx[0], idx[0])
    k.lookup_score_multi_compressed(d, refs, idx, idx)
    assert k.launches == before
    assert "cobs_lookup_comp" in _build._SIGNATURES
    assert " cobs_lookup_comp(" in _build.SOURCE.read_text()
    assert "launch_split(lookup_comp_kernel" in _build.SOURCE.read_text()


@pytest.mark.parametrize("n_hashes", [1, 3])
def test_gather_rows_comp_equals_reference(n_hashes):
    rng = np.random.default_rng(n_hashes)
    dict_rows = rng.integers(0, 2 ** 32, size=(12, 3), dtype=np.uint32)
    refs = rng.integers(0, 12, size=40).astype(np.int32)
    rows = rng.integers(0, 40, size=(9, n_hashes, 2)).astype(np.int32)
    valid = np.arange(9) < 6
    want = np.asarray(jax_query.gather_rows_comp(
        jnp.asarray(dict_rows), jnp.asarray(refs), jnp.asarray(rows),
        jnp.asarray(valid)))
    got = q.gather_rows_comp(_t(dict_rows), _t(refs), _t(rows),
                             torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# --------------------------------------------------------------------------
# The compressed engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The redundant corpus (24 x 8 documents, FPR 0.03) as rowdict and
    raw stores, blocks of 128 documents, one block per shard."""
    c, terms = _redundant()
    root = tmp_path_factory.mktemp("comp")
    p = IndexParams(1, 0.03, 15)
    idx_c, stats = build_compact_streaming(terms, root / "comp", p,
                                           block_docs=128, codec="rowdict",
                                           device=CPU)
    idx_r, _ = build_compact_streaming(terms, root / "raw", p,
                                       block_docs=128, codec="raw",
                                       device=CPU)
    return c, root, idx_c, idx_r, stats


@pytest.fixture(scope="module")
def comp_dense(tmp_path_factory):
    """The redundant corpus as a rowdict store of one shard (both blocks
    in it): the shard loop's one-shard case."""
    _, terms = _redundant()
    root = tmp_path_factory.mktemp("comp_dense")
    idx, _ = build_compact_streaming(terms, root / "comp",
                                     IndexParams(1, 0.03, 15),
                                     block_docs=128, blocks_per_shard=2,
                                     codec="rowdict", device=CPU)
    assert idx.storage.n_shards == 1
    assert idx.storage.shard_codec(0) == "rowdict"
    return root, idx


def test_compressed_store_is_compressed(stores):
    _, root, idx_c, idx_r, stats = stores
    assert idx_c.storage.n_shards == 2 == stats.n_compressed_shards
    assert idx_c.storage.dict_ratio() >= 2.0
    assert idx_r.storage.dict_ratio() is None
    np.testing.assert_array_equal(idx_c.storage.full_host(),
                                  idx_r.storage.full_host())
    assert QueryEngine(idx_c, compressed=True, device=CPU).compressed
    assert not QueryEngine(idx_r, compressed=True, device=CPU).compressed
    assert not QueryEngine(idx_c, device=CPU).compressed


# case -> (method, store): the paged rowdict store of ``stores`` or the
# one-shard store of ``comp_dense``
ENGINE_CASES = {**{m: (m, "paged") for m in METHODS},
                **{f"{m} dense": (m, "dense") for m in METHODS}}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_compressed_engine_equals_reference(stores, comp_dense, case):
    c, root, idx_c, idx_r, _ = stores
    method, shards = ENGINE_CASES[case]
    if shards == "dense":
        root, idx_c = comp_dense
    jidx = jax_store.load_index_v2(root / "comp")
    # the JAX engine's default cache pads tiles to the tallest shard (one
    # compiled kernel for all); the port's does not, so give both the same
    # unpadded cache to compare the counters
    want = JaxEngine(jidx, method=method, compressed=True,
                     tile_cache=JaxCache(jidx.storage))
    got = QueryEngine(idx_c, method=method, compressed=True, device=CPU)
    raw = QueryEngine(idx_r, method=method, device=CPU)
    pats = _patterns(c)
    singles = [got.search(p, 0.4) for p in pats]
    assert_same_results(singles, [want.search(p, 0.4) for p in pats])
    assert_same_results(singles, [raw.search(p, 0.4) for p in pats])
    batch = got.search_batch(pats[:6], 0.4)
    assert_same_results(batch, want.search_batch(pats[:6], 0.4))
    assert_same_results(batch, raw.search_batch(pats[:6], 0.4))
    top = c.documents[2][5:85]
    got_top = [got.top_k(top, 7)]
    assert_same_results(got_top, [want.top_k(top, 7)])
    assert_same_results(got_top, [raw.top_k(top, 7)])
    assert got.tiles.comp_bytes_staged == want.tiles.comp_bytes_staged > 0
    assert got.tiles.raw_bytes_staged == want.tiles.raw_bytes_staged == 0
    assert (got.tiles.faults, got.tiles.hits, got.tiles.prefetch_hits) == \
        (want.tiles.faults, want.tiles.hits, want.tiles.prefetch_hits)


def test_compressed_engine_k2_equals_reference(tmp_path):
    """n_hashes=2: the gather_rows_comp path (dict[refs[rows]] + AND),
    against the JAX compressed engine and the port's raw engine."""
    c, terms = _redundant(n_base=16, reps=6, seed=9)
    p = IndexParams(2, 0.05, 15)
    idx_c, _ = build_compact_streaming(terms, tmp_path / "c2", p,
                                       block_docs=128, codec="rowdict",
                                       device=CPU)
    idx_r, _ = build_compact_streaming(terms, tmp_path / "r2", p,
                                       block_docs=128, codec="raw",
                                       device=CPU)
    jidx, _ = jax_streaming(terms, tmp_path / "j2", JaxParams(2, 0.05, 15),
                            block_docs=128, codec="rowdict")
    pats = _patterns(c, n_random=4, seed=5)
    for method in ("vertical", "lookup", "unpack"):
        got = QueryEngine(idx_c, method=method, compressed=True, device=CPU)
        assert got.compressed
        want = JaxEngine(jidx, method=method, compressed=True)
        raw = QueryEngine(idx_r, method=method, device=CPU)
        singles = [got.search(pt, 0.4) for pt in pats]
        assert_same_results(singles, [want.search(pt, 0.4) for pt in pats])
        assert_same_results(singles, [raw.search(pt, 0.4) for pt in pats])
        assert_same_results(got.search_batch(pats, 0.4),
                            want.search_batch(pats, 0.4))


def test_mixed_codec_store_equals_reference(stores, tmp_path):
    """rowdict and raw shards in one store: both forms of the shard loop
    (``score_shards``), with codec-aware prefetch."""
    c, root, idx_c, idx_r, _ = stores
    store.merge_stores(root / "comp", root / "raw", tmp_path / "mixed")
    idx = store.load_index_v2(tmp_path / "mixed", device=CPU)
    assert [idx.storage.shard_codec(s) for s in range(4)] == \
        ["rowdict", "rowdict", "raw", "raw"]
    jidx = jax_store.load_index_v2(tmp_path / "mixed")
    pats = _patterns(c, n_random=3)
    got = QueryEngine(idx, method="lookup", compressed=True, device=CPU)
    want = JaxEngine(jidx, method="lookup", compressed=True)
    assert_same_results(got.search_batch(pats, 0.4),
                        want.search_batch(pats, 0.4))
    assert_same_results([got.search(pt, 0.4) for pt in pats],
                        [want.search(pt, 0.4) for pt in pats])
    tiles, st = got.tiles, idx.storage
    assert (tiles.faults, tiles.hits, tiles.prefetch_hits) == \
        (want.tiles.faults, want.tiles.hits, want.tiles.prefetch_hits)
    assert tiles.prefetch_hits > 0
    # each shard staged once, in the form it is scored in (the JAX
    # default cache pads tiles, so its byte counts differ)
    assert tiles.raw_bytes_staged == st.shard_nbytes(2) + \
        st.shard_nbytes(3)
    assert tiles.comp_bytes_staged == sum(
        int(a.nbytes) for s in (0, 1) for a in tiles.get_compressed(s))
    assert all(got.tiles.has_compressed(s) for s in (0, 1))


@pytest.mark.parametrize("method", ["lookup", "vertical"])
def test_comp_score_fns_equal_reference(stores, method):
    """Slot scores of make_comp_score_fn / make_comp_batch_score_fn on one
    staged shard equal the JAX functions'."""
    _, root, idx_c, _, _ = stores
    jidx = jax_store.load_index_v2(root / "comp")
    d, refs = idx_c.storage.shard_dict_host(0)
    lay = idx_c.layout
    offs, widths = lay.row_offset[:1], lay.block_width[:1]
    rng = np.random.default_rng(4)
    terms = rng.integers(0, 2 ** 32, size=(3, 64, 2), dtype=np.uint32)
    n_valid = np.array([64, 17, 0], np.int32)
    jargs = (jnp.asarray(d), jnp.asarray(refs), jnp.asarray(offs),
             jnp.asarray(widths))
    targs = (_t(np.array(d)), _t(np.array(refs)), torch.from_numpy(offs),
             torch.from_numpy(widths))
    want = np.asarray(jax_query.make_comp_batch_score_fn(1, method)(
        *jargs, jnp.asarray(terms), jnp.asarray(n_valid)))
    got = q.make_comp_batch_score_fn(1, method, grid_order="qw")(
        *targs, _t(terms), torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    single = q.make_comp_score_fn(1, method)(*targs, _t(terms[1]), 17)
    np.testing.assert_array_equal(single.numpy(), want[1])
    assert jidx.storage.shard_codec(0) == "rowdict"
