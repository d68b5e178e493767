"""The port's mesh-sharded ``DistributedIndex`` against the JAX package, on
the CPU.

* ``scores_for`` on meshes (1,1,1) and (2,2,2), documents sharded over
  ("pod", "data") or ("data",), rows over "model" or not, for the
  ``vertical``, ``unpack`` and ``lookup`` paths and ``lookup`` summed in
  int16: every score equals the JAX ``QueryEngine(method="ref")``'s, as
  ``tests/distributed_check.py`` holds JAX's own sharded index;
* ``search_batch`` on a one-position mesh equals JAX's ``DistributedIndex``
  on its one-device mesh, ids and values in order;
* on multi-shard meshes, ``topk_fn`` and ``search_batch`` equal a numpy
  model of the ``lax.top_k`` merge (each shard's cut, candidates gathered
  in doc-rank order, the final cut; the lower index first among ties) on
  an index built so that ties fall across shards;
* ``search_batch(..., topk=0)`` returns one empty hit list a query in the
  port and raises in JAX (C7, a deliberate difference);
* row sharding of a two-hash index raises in both packages.

Every comparison is exact.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_compact as jax_compact
from repro.core import dna
from repro.data import make_corpus, make_queries
from repro.index import DistributedIndex as JaxDistributed
from repro.launch.mesh import make_mesh as jax_mesh

from repro_torch.core import IndexParams, build_compact
from repro_torch.index import DistributedIndex
from repro_torch.kernels import bitslice_score as k
from repro_torch.launch.mesh import (data_axes, make_mesh,
                                     make_production_mesh, model_axis)

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
CPU = "cpu"


def _pair(doc_terms, n_hashes=1, block_docs=32):
    j = jax_compact(doc_terms, JaxParams(n_hashes, 0.3, 15),
                    block_docs=block_docs, row_align=64)
    t = build_compact(doc_terms, IndexParams(n_hashes, 0.3, 15),
                      block_docs=block_docs, row_align=64, device=CPU)
    return j, t


@pytest.fixture(scope="module")
def world():
    c = make_corpus(96, k=15, mean_length=400, sigma=1.0, seed=21)
    qs, origin = make_queries(c, n_pos=12, n_neg=8, length=80, seed=5)
    j, t = _pair(c.doc_terms)
    j2, t2 = _pair(c.doc_terms, n_hashes=2)
    return {"corpus": c, "queries": qs, "origin": origin,
            "k1": (j, t, JaxEngine(j, method="ref")),
            "k2": (j2, t2, JaxEngine(j2, method="ref"))}


@pytest.fixture(scope="module")
def tied():
    """An index whose documents 0-63 are one genome: the best score ties
    across 64 slots of two words, so across doc shards. Blocks of 128
    documents (4 words a block, one a shard on a (2, 2) doc grid)."""
    c = make_corpus(90, k=15, mean_length=400, sigma=0.6, min_length=200,
                    seed=9)
    terms = [c.doc_terms[0]] * 64 + list(c.doc_terms[1:])
    j, t = _pair(terms, block_docs=128)
    pats = [c.documents[0][:90], c.documents[0][40:200], c.documents[7][:80],
            c.documents[30][:60]]
    return j, t, JaxEngine(j, method="ref"), pats


def _terms(q):
    return dna.unique_terms(dna.pack_kmers(q, 15))


MESHES = {
    "1x1x1 docs": ((1, 1, 1), dict(doc_axes=("pod", "data"))),
    "1x1x1 docs+rows": ((1, 1, 1), dict(doc_axes=("pod", "data"),
                                        row_axis="model")),
    "2x2x2 docs": ((2, 2, 2), dict(doc_axes=("pod", "data"))),
    "2x2x2 docs+rows": ((2, 2, 2), dict(doc_axes=("pod", "data"),
                                        row_axis="model")),
    "2x2x2 data": ((2, 2, 2), dict(doc_axes=("data",))),
    "2x2x2 data+rows": ((2, 2, 2), dict(doc_axes=("data",),
                                        row_axis="model")),
}
PATHS = {"vertical": ("vertical", torch.int32),
         "unpack": ("unpack", torch.int32),
         "lookup": ("lookup", torch.int32),
         "lookup int16": ("lookup", torch.int16)}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_scores_for_equal_reference(world, mesh, path):
    shape, kw = MESHES[mesh]
    method, dtype = PATHS[path]
    _, idx, ref = world["k1"]
    dist = DistributedIndex(idx, make_mesh(shape, AXES, device=CPU),
                            score_method=method, score_dtype=dtype,
                            device=CPU, **kw)
    for q in world["queries"][:5]:
        terms = _terms(q)
        got = dist.scores_for(terms)
        assert got.dtype == (np.int16 if dtype == torch.int16 else np.int32)
        np.testing.assert_array_equal(got, ref.score_terms(terms))


@pytest.mark.parametrize("method", ["vertical", "unpack", "lookup"])
@pytest.mark.parametrize("mesh", ["1x1x1 docs", "2x2x2 docs", "2x2x2 data"])
def test_two_hash_scores_for_equal_reference(world, mesh, method):
    """k = 2 ANDs the hash rows on each doc shard (no row sharding)."""
    shape, kw = MESHES[mesh]
    _, idx, ref = world["k2"]
    dist = DistributedIndex(idx, make_mesh(shape, AXES, device=CPU),
                            score_method=method, device=CPU, **kw)
    for q in world["queries"][:4]:
        np.testing.assert_array_equal(dist.scores_for(_terms(q)),
                                      ref.score_terms(_terms(q)))


@pytest.mark.parametrize("method", ["vertical", "lookup"])
def test_search_batch_equals_jax_on_one_device(world, method):
    jidx, idx, _ = world["k1"]
    kw = dict(doc_axes=("pod", "data"), row_axis="model",
              score_method=method)
    jd = JaxDistributed(jidx, jax_mesh((1, 1, 1), AXES), **kw)
    td = DistributedIndex(idx, make_mesh((1, 1, 1), AXES, device=CPU),
                          device=CPU, **kw)
    qs = list(world["queries"])
    for threshold, topk in ((0.0, 8), (0.9, 16), (0.5, 200)):
        want = jd.search_batch(qs, threshold=threshold, topk=topk)
        got = td.search_batch(qs, threshold=threshold, topk=topk)
        assert len(got) == len(want)
        for (gi, gv), (wi, wv) in zip(got, want):
            assert gi.dtype == wi.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gv, wv)
    # true positives found, true negatives empty (distributed_check.py)
    for (ids, _), o in zip(td.search_batch(qs, 0.9, 16), world["origin"]):
        assert (o in set(ids.tolist())) if o >= 0 else len(ids) == 0


@pytest.mark.parametrize("method", ["vertical", "lookup", "unpack"])
def test_search_batch_topk_zero(world, method):
    """``topk=0`` (C7): the port answers one empty hit list a query, as
    both packages' ``QueryEngine.top_k(q, 0)`` do; JAX's
    ``DistributedIndex`` raises while lowering an all_gather of zero
    candidates."""
    jidx, idx, _ = world["k1"]
    kw = dict(doc_axes=("pod", "data"), row_axis="model",
              score_method=method)
    q = world["queries"][0]
    td = DistributedIndex(idx, make_mesh((1, 1, 1), AXES, device=CPU),
                          device=CPU, **kw)
    got = td.search_batch([q], topk=0)
    assert len(got) == 1
    ids, vals = got[0]
    assert ids.size == 0 and vals.size == 0
    jd = JaxDistributed(jidx, jax_mesh((1, 1, 1), AXES), **kw)
    with pytest.raises(Exception):
        jd.search_batch([q], topk=0)


def _model_topk(jidx, scores, n_doc_shards, topk):
    """numpy model of the sharded top-k: scores [n_docs] in document order
    -> (values, padded slots) as lax.top_k cuts and merges them."""
    lay = jidx.layout
    words = lay.doc_words + (-lay.doc_words) % n_doc_shards
    wl, spb, nb = words // n_doc_shards, words * 32, lay.n_blocks
    slot_scores = np.zeros(nb * spb, dtype=np.int64)
    b, pos = lay.doc_slot // lay.block_docs, lay.doc_slot % lay.block_docs
    slot_scores[b * spb + pos] = scores
    vals, slots = [], []
    for d in range(n_doc_shards):
        gslot = np.concatenate([blk * spb + d * wl * 32 + np.arange(wl * 32)
                                for blk in range(nb)])
        local = slot_scores[gslot]
        cut = np.argsort(-local, kind="stable")[:min(topk, local.size)]
        vals.append(local[cut])
        slots.append(gslot[cut])
    vals, slots = np.concatenate(vals), np.concatenate(slots)
    best = np.argsort(-vals, kind="stable")[:min(topk, vals.size)]
    slot_doc = np.full(nb * spb, -1)
    slot_doc[b * spb + pos] = np.arange(lay.n_docs)
    return vals[best], slots[best], slot_doc


@pytest.mark.parametrize("method", ["vertical", "lookup"])
@pytest.mark.parametrize("mesh", ["2x2x2 docs+rows", "2x2x2 docs",
                                  "2x2x2 data+rows"])
def test_topk_merge_equals_model_with_ties_across_shards(tied, mesh, method):
    jidx, idx, ref, pats = tied
    shape, kw = MESHES[mesh]
    dist = DistributedIndex(idx, make_mesh(shape, AXES, device=CPU),
                            score_method=method, device=CPU, **kw)
    n_shards = math.prod(shape[AXES.index(a)] for a in kw["doc_axes"])
    assert dist.words_local == 4 // n_shards
    for topk in (8, 40, 100):
        for p in pats:
            terms = _terms(p)
            want_v, want_s, slot_doc = _model_topk(
                jidx, ref.score_terms(terms), n_shards, topk)
            buf = np.zeros((1, 192, 2), np.uint32)
            buf[0, :len(terms)] = terms
            vals, slots = dist.topk_fn(topk)(buf, np.array([len(terms)]))
            np.testing.assert_array_equal(vals[0].numpy(), want_v)
            np.testing.assert_array_equal(slots[0].numpy(), want_s)
            ids, scores = dist.search_batch([p], threshold=0.5,
                                            topk=topk)[0]
            keep = (want_v >= math.ceil(0.5 * len(terms))) & \
                (slot_doc[want_s] >= 0)
            np.testing.assert_array_equal(ids, slot_doc[want_s][keep])
            np.testing.assert_array_equal(scores, want_v[keep])
    # the first pattern ties all 64 copies at its full count, across the
    # two words (shards) they fill
    terms = _terms(pats[0])
    vals, slots = dist.topk_fn(100)(terms[None], np.array([len(terms)]))
    assert (vals[0, :64] == len(terms)).all()
    assert not (vals[0, 64:] == len(terms)).any()
    words = (slots[0, :64].numpy() % dist.slots_per_block) // 32
    assert len(set(words // dist.words_local)) > 1


def test_row_sharding_two_hashes_raises_alike(world):
    jidx, idx, _ = world["k2"]
    with pytest.raises(ValueError, match="n_hashes == 1"):
        JaxDistributed(jidx, jax_mesh((1, 1, 1), AXES), row_axis="model")
    with pytest.raises(ValueError, match="n_hashes == 1"):
        DistributedIndex(idx, make_mesh((2, 2, 2), AXES, device=CPU),
                         row_axis="model", device=CPU)


def test_one_launch_per_slice_per_batch(world, monkeypatch):
    """A batch of Q queries calls each slice's kernel wrapper once (on the
    CPU the wrappers run their plain versions and count no launch, so
    count the calls)."""
    _, idx, _ = world["k1"]
    calls = []
    dist = DistributedIndex(idx, make_mesh((2, 2, 2), AXES, device=CPU),
                            doc_axes=("pod", "data"), row_axis="model",
                            score_method="lookup", device=CPU)
    real = k.lookup_score_multi

    def spy(arena, rows_idx, mask, **kw):
        calls.append(tuple(rows_idx.shape))
        return real(arena, rows_idx, mask, **kw)

    monkeypatch.setattr(k, "lookup_score_multi", spy)
    dist.search_batch(list(world["queries"]), 0.8, topk=8)
    q = len(world["queries"])
    assert len(calls) == 8 and all(c[0] == q for c in calls)


def test_mesh_helpers():
    m = make_mesh((2, 2, 2), AXES, device=CPU)
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert data_axes(m) == ("pod", "data") and model_axis(m) == "model"
    p = make_production_mesh(device=CPU)
    assert p.axis_names == ("data", "model") and p.shape["model"] == 16
    assert make_production_mesh(multi_pod=True, device=CPU).devices.size \
        == 512
    assert model_axis(make_mesh((4,), ("data",), device=CPU)) is None
    with pytest.raises(ValueError):
        make_mesh((2, 2), AXES, device=CPU)
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",), device=[CPU])
    with pytest.raises(ValueError):
        DistributedIndex.__init__(object.__new__(DistributedIndex), None, m,
                                  doc_axes=("rows",))


def test_mesh_of_one_device_a_position(world):
    """A mesh given one device a position places each slice on its
    position's device; the scores are those of the one-device mesh."""
    _, idx, ref = world["k1"]
    mesh = make_mesh((2, 2), ("data", "model"), device=[CPU] * 4)
    assert all(d == torch.device(CPU) for d in mesh.devices.flat)
    dist = DistributedIndex(idx, mesh, row_axis="model", device=CPU)
    assert sorted(dist.slices) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    terms = _terms(world["queries"][0])
    np.testing.assert_array_equal(dist.scores_for(terms),
                                  ref.score_terms(terms))
