"""The port's row-dedup path against the JAX package, on the CPU.

* the plain versions of the three new kernels (``gather_plain``,
  ``gather_comp_plain``, ``dedup_plain``) against the Pallas
  ``gather_rows``, ``gather_rows_compressed`` and ``dedup_score`` run in
  interpret mode, over disjoint, duplicated and mixed rows, at ragged word
  counts, with [U, k] row sets for k = 2;
* ``ops.bitslice_lookup_score_dedup(_comp)`` against the JAX ops (which
  pad the word axis and slice back);
* ``plan_dedup_batch`` field by field, dense and per shard, one and two
  hashes, with the server's zero-padded queries;
* ``run_paged_dedup`` on dense, raw and rowdict stores (and a two-hash
  raw store) against the JAX function: slot scores and tile-cache
  counters, both caches unpadded.

Every comparison is exact (``np.testing.assert_array_equal``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import build_compact as jax_build_compact
from repro.core import query as jq
from repro.data import make_corpus, make_queries
from repro.index import build_compact_streaming as jax_streaming
from repro.kernels import bitslice_score as jk
from repro.kernels import ops as jops

from repro_torch.core import DeviceTileCache, load_index_v2
from repro_torch.core import query as q
from repro_torch.kernels import _build
from repro_torch.kernels import bitslice_score as k
from repro_torch.kernels import ops

torch.set_num_threads(2)

CPU = "cpu"
DUPLICATION = ["disjoint", "dup", "mixed"]
SHAPES = [(2, 1, 8, 3), (3, 2, 17, 40), (4, 1, 33, 130), (2, 2, 9, 33)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _rows(rng, n, R, duplication):
    if duplication == "disjoint":
        return rng.permutation(max(R, n))[:n] % R
    if duplication == "dup":
        return rng.choice(rng.integers(0, R, size=max(1, n // 8)), size=n)
    return rng.integers(0, R, size=n)


def _dedup_inputs(seed, Q, nb, L, W, duplication, kk):
    """Arena, dictionary, refs and a batch's dedup addressing: uniq [U_pad]
    (kk = 1) or [U_pad, kk] (0-padded), indir and a 0/1 mask [Q, nb, L]."""
    rng = np.random.default_rng(seed)
    R = 4 * Q * nb * L + 1
    D = max(2, R // 3)
    arena = rng.integers(0, 2 ** 32, size=(R, W), dtype=np.uint32)
    dict_rows = rng.integers(0, 2 ** 32, size=(D, W), dtype=np.uint32)
    refs = rng.integers(0, D, size=R).astype(np.int32)
    cells = _rows(rng, Q * nb * L * kk, R, duplication).reshape(-1, kk)
    if kk == 1:
        uniq, inv = np.unique(cells[:, 0], return_inverse=True)
    else:
        uniq, inv = np.unique(cells, axis=0, return_inverse=True)
    pad = q._pad_unique(uniq.shape[0])
    uniq_pad = np.zeros((pad,) + uniq.shape[1:], dtype=np.int32)
    uniq_pad[: uniq.shape[0]] = uniq
    indir = np.asarray(inv).reshape(Q, nb, L).astype(np.int32)
    mask = rng.integers(0, 2, size=(Q, nb, L)).astype(np.int32)
    return arena, dict_rows, refs, uniq_pad, indir, mask


def _wb(W):
    return min(jk.DEFAULT_WORD_BLOCK, max(8, W))


def _pad_words(a: np.ndarray, wb: int) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, (-a.shape[1]) % wb)))


# --------------------------------------------------------------------------
# The three plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def _pallas_gather(arena_p, refs, uniq_pad, wb):
    cols = [uniq_pad] if uniq_pad.ndim == 1 else list(uniq_pad.T)
    out = None
    for col in cols:
        col = jnp.asarray(np.ascontiguousarray(col))
        g = (jk.gather_rows(jnp.asarray(arena_p), col, word_block=wb,
                            interpret=True) if refs is None
             else jk.gather_rows_compressed(
                 jnp.asarray(arena_p), jnp.asarray(refs), col,
                 word_block=wb, interpret=True))
        out = g if out is None else out & g
    return np.asarray(out)


@pytest.mark.parametrize("kk", [1, 2])
@pytest.mark.parametrize("duplication", DUPLICATION)
@pytest.mark.parametrize("Q,nb,L,W", SHAPES)
def test_plain_versions_equal_pallas_kernels(Q, nb, L, W, duplication, kk):
    arena, dict_rows, refs, uniq_pad, indir, mask = _dedup_inputs(
        Q * 100 + L + W + kk, Q, nb, L, W, duplication, kk)
    wb = _wb(W)
    want_g = _pallas_gather(_pad_words(arena, wb), None, uniq_pad, wb)
    got_g = k.gather_plain(_t(arena), _t(uniq_pad))
    np.testing.assert_array_equal(got_g.numpy().view(np.uint32),
                                  want_g[:, :W])
    want_c = _pallas_gather(_pad_words(dict_rows, wb), refs, uniq_pad, wb)
    got_c = k.gather_comp_plain(_t(dict_rows), _t(refs), _t(uniq_pad))
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32),
                                  want_c[:, :W])
    want_s = np.asarray(jk.dedup_score(
        jnp.asarray(want_g), jnp.asarray(indir), jnp.asarray(mask),
        word_block=wb, interpret=True))[:, :, :W]
    got_s = k.dedup_plain(got_g, _t(indir), _t(mask))
    np.testing.assert_array_equal(got_s.numpy(), want_s)


# --------------------------------------------------------------------------
# The ops wrappers against the JAX ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kk", [1, 2])
@pytest.mark.parametrize("duplication", DUPLICATION)
@pytest.mark.parametrize("Q,nb,L,W", SHAPES[:3])
def test_ops_equal_jax_ops(Q, nb, L, W, duplication, kk):
    arena, dict_rows, refs, uniq_pad, indir, mask = _dedup_inputs(
        7 * Q + L + W + kk, Q, nb, L, W, duplication, kk)
    j = [jnp.asarray(a) for a in (uniq_pad, indir, mask)]
    want = np.asarray(jops.bitslice_lookup_score_dedup(jnp.asarray(arena),
                                                       *j))
    got = ops.bitslice_lookup_score_dedup(_t(arena), _t(uniq_pad),
                                          _t(indir), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    want_c = np.asarray(jops.bitslice_lookup_score_dedup_comp(
        jnp.asarray(dict_rows), jnp.asarray(refs), *j))
    got_c = ops.bitslice_lookup_score_dedup_comp(
        _t(dict_rows), _t(refs), _t(uniq_pad), _t(indir), _t(mask),
        word_block=32)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    if kk == 1:
        # the dedup pair equals the fused multi-query kernel on the
        # expanded indices
        fused = ops.bitslice_lookup_score_multi(
            _t(arena), _t(uniq_pad[indir]), _t(mask))
        np.testing.assert_array_equal(got.numpy(), fused.numpy())


def test_cpu_wrappers_take_the_plain_path_and_check(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(k.launches)
    arena, dict_rows, refs, uniq_pad, indir, mask = _dedup_inputs(
        3, 2, 1, 8, 5, "mixed", 2)
    a, d, r = _t(arena), _t(dict_rows), _t(refs)
    u, i, m = _t(uniq_pad), _t(indir), _t(mask)
    k.dedup_score(k.gather_rows(a, u, range_checked=True), i, m)
    k.dedup_score(k.gather_rows_compressed(d, r, u), i, m,
                  range_checked=True)
    assert k.launches == before
    for name in ("gather_rows", "gather_rows_compressed", "dedup_score"):
        assert name in k.launches
    # a CPU tensor is range-checked whatever the caller says
    with pytest.raises(IndexError):
        k.gather_rows(a, torch.tensor([0, arena.shape[0]], dtype=torch.int32),
                      range_checked=True)
    with pytest.raises(IndexError):
        k.gather_rows_compressed(d, r, torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(IndexError):
        k.dedup_score(k.gather_rows(a, u), i + u.shape[0], m,
                      range_checked=True)
    with pytest.raises(ValueError):
        k.gather_rows(a, torch.zeros((4, 0), dtype=torch.int32))
    with pytest.raises(TypeError):
        k.gather_rows(a, u.long())
    with pytest.raises(ValueError):
        k.dedup_score(k.gather_rows(a, u), i, m[..., :-1].contiguous())
    with pytest.raises(ValueError):
        ops.bitslice_lookup_score_dedup(a, u, i, m, word_block=0)


# --------------------------------------------------------------------------
# Host-side planning
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dedup_corpus():
    c = make_corpus(48, k=15, mean_length=400, sigma=1.0, seed=7)
    idx = {n: jax_build_compact(c.doc_terms,
                                JaxParams(n_hashes=n, fpr=0.3, kmer=15),
                                block_docs=32, row_align=64)
           for n in (1, 2)}
    return c, idx


def _batch(c, params, mode, q_pad=None):
    qs, _ = make_queries(c, n_pos=3, n_neg=1, length=100, seed=11)
    if mode == "duplicated":
        qs = [qs[0]] * 6 + qs[1:3]
    elif mode == "overlapping":
        doc = c.documents[5]
        qs = [doc[s:s + 100] for s in range(0, 240, 30)]
    term_sets = [jq.compile_pattern(p, params) for p in qs]
    buf, ells = jq.pad_term_batch(term_sets, 64)
    if q_pad:
        # the server pads the query axis with n_valid = 0 queries
        pb = np.zeros((q_pad,) + buf.shape[1:], buf.dtype)
        pb[: buf.shape[0]] = buf
        pe = np.zeros(q_pad, np.int32)
        pe[: ells.shape[0]] = ells
        buf, ells = pb, pe
    return buf, ells


def assert_same_plan(got, want):
    for f in ("uniq_rows", "indir", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.n_unique, got.n_gathers) == (want.n_unique, want.n_gathers)
    assert got.dedup_rate == want.dedup_rate


@pytest.mark.parametrize("q_pad", [None, 16])
@pytest.mark.parametrize("mode", ["disjoint", "duplicated", "overlapping"])
@pytest.mark.parametrize("n_hashes", [1, 2])
def test_plan_dedup_batch_equals_reference(dedup_corpus, n_hashes, mode,
                                           q_pad):
    c, idx = dedup_corpus
    jidx = idx[n_hashes]
    buf, ells = _batch(c, jidx.params, mode, q_pad)
    lay = jidx.layout
    want = jq.plan_dedup_batch(buf, ells, lay.row_offset, lay.block_width,
                               n_hashes=n_hashes)
    got = q.plan_dedup_batch(buf, ells, lay.row_offset, lay.block_width,
                             n_hashes=n_hashes)
    assert_same_plan(got, want)
    # per shard: two row ranges of the arena, rebased
    starts = np.array([0, int(lay.row_offset[1]), lay.total_rows], np.int64)
    for jsp, tsp in zip(jq.plan_shards(lay, starts),
                        q.plan_shards(lay, starts)):
        assert_same_plan(
            q.plan_dedup_batch(buf, ells, tsp.row_offset, tsp.block_width,
                               n_hashes=n_hashes),
            jq.plan_dedup_batch(buf, ells, jsp.row_offset, jsp.block_width,
                                n_hashes=n_hashes))
    if mode == "duplicated":
        assert got.dedup_rate > 0.5


def test_plan_dedup_batch_empty(dedup_corpus):
    c, idx = dedup_corpus
    lay = idx[1].layout
    buf = np.zeros((4, 64, 2), np.uint32)
    ells = np.zeros(4, np.int32)
    got = q.plan_dedup_batch(buf, ells, lay.row_offset, lay.block_width)
    assert_same_plan(got, jq.plan_dedup_batch(buf, ells, lay.row_offset,
                                              lay.block_width))
    assert got.dedup_rate == 0.0 and got.uniq_rows.shape == (8,)


# --------------------------------------------------------------------------
# run_paged_dedup on stores
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """kind -> (JAX index, port index over the same files, n_hashes)."""
    c = make_corpus(24, k=15, mean_length=160, min_length=120, seed=3)
    terms = [c.doc_terms[i % 24] for i in range(24 * 6)]
    root = tmp_path_factory.mktemp("dedup")
    p1 = JaxParams(n_hashes=1, fpr=0.03, kmer=15)
    p2 = JaxParams(n_hashes=2, fpr=0.1, kmer=15)
    kw = {"raw": (p1, dict(block_docs=32, blocks_per_shard=1, codec="raw")),
          "comp": (p1, dict(block_docs=128, blocks_per_shard=1,
                            codec="rowdict")),
          "dense": (p1, dict(block_docs=32, blocks_per_shard=64,
                             codec="raw")),
          "raw k=2": (p2, dict(block_docs=32, blocks_per_shard=1,
                               codec="raw"))}
    out = {}
    for kind, (params, args) in kw.items():
        jidx, _ = jax_streaming(terms, root / kind, params, **args)
        out[kind] = (jidx, load_index_v2(root / kind, device=CPU),
                     params.n_hashes)
    st = out["comp"][1].storage
    assert all(st.shard_codec(s) == "rowdict" for s in range(st.n_shards))
    assert out["raw"][1].storage.n_shards > 2
    assert out["dense"][1].storage.n_shards == 1
    return c, out


CACHE_COUNTERS = ("hits", "faults", "prefetched", "prefetch_hits",
                  "resident_bytes", "raw_bytes_staged", "comp_bytes_staged",
                  "shard_hits", "shard_faults", "shard_evictions")


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("kind", ["raw", "comp", "dense", "raw k=2"])
def test_run_paged_dedup_equals_reference(stores, kind, bounded):
    c, out = stores
    jidx, tidx, n_hashes = out[kind]
    pats = [c.documents[i][10:100] for i in (0, 1, 2, 0, 1)]
    pats += [c.documents[3][s:s + 80] for s in range(0, 60, 20)]
    term_sets = [jq.compile_pattern(p, jidx.params) for p in pats]
    buf, ells = jq.pad_term_batch(term_sets, 64)
    st = tidx.storage
    cap = (max(st.shard_nbytes(s) for s in range(st.n_shards))
           if bounded else None)
    jtiles = JaxCache(jidx.storage, capacity_bytes=cap)
    ttiles = DeviceTileCache(st, capacity_bytes=cap)
    comp = kind == "comp"
    for _ in range(2):                     # a second batch: cache hits
        want = jq.run_paged_dedup(
            jtiles, jq.plan_shards(jidx.layout, jidx.storage.shard_row_starts),
            jq.make_dedup_score_fn(), buf, ells, n_hashes=n_hashes,
            fn_comp=jq.make_comp_dedup_score_fn() if comp else None)
        got = q.run_paged_dedup(
            ttiles, q.plan_shards(tidx.layout, st.shard_row_starts),
            q.make_dedup_score_fn(), buf, ells, n_hashes=n_hashes,
            fn_comp=q.make_comp_dedup_score_fn() if comp else None)
        np.testing.assert_array_equal(got, want)
    for f in CACHE_COUNTERS:
        assert getattr(ttiles, f) == getattr(jtiles, f), f
    if comp:
        assert ttiles.raw_bytes_staged == 0 and ttiles.comp_bytes_staged
    # the exhaustive engine's slot scores
    eng = q.QueryEngine(tidx, method="lookup" if n_hashes == 1 else
                        "vertical", device=CPU)
    slot = np.asarray(tidx.layout.doc_slot)
    np.testing.assert_array_equal(got[:, slot],
                                  eng.score_terms_batch(buf, ells))


def test_run_paged_dedup_checks_rows_on_the_host(stores):
    _, out = stores
    jidx, tidx, _ = out["raw"]
    st = tidx.storage
    plans = q.plan_shards(tidx.layout, st.shard_row_starts)
    bad = [q.ShardPlan(p.shard, p.block_start, p.block_end,
                       p.row_offset + 10 ** 6, p.block_width) for p in plans]
    buf = np.ones((2, 64, 2), np.uint32)
    with pytest.raises(IndexError):
        q.run_paged_dedup(DeviceTileCache(st), bad, q.make_dedup_score_fn(),
                          buf, np.array([3, 5], np.int32))
