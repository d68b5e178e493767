"""Queries of more than 65,535 terms through the port's QueryEngine,
against the JAX package, on the CPU.

The index is an 8-document compact index (k = 15, one hash, FPR 0.3) whose
first document is a random 70,100-base sequence, and the query is that
sequence: 70,082 distinct terms, padded to 70,144, all of which document 0
matches, a count that needs 17 counter planes. The port's ``vertical``,
``lookup`` and ``unpack`` engines must answer ``search`` and
``search_batch`` (the long query beside a short one) as the JAX
``QueryEngine(method="ref")`` does; ``top_k`` and a served request are in
``test_torch_terms_served.py`` (which imports this file's index), the
scoring wrappers at more than 65,535 terms in ``test_torch_terms_slabs.py``.
Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_compact as jax_build_compact
from repro.core.dna import decode_dna, document_terms
from repro.data import make_corpus

from repro_torch.core import QueryEngine, index_from_numpy
from repro_torch.core.query import compile_pattern

torch.set_num_threads(2)

LONG_BP = 70_100
THRESHOLD = 0.001     # a cutoff of 71: document 0 and three others


def long_query_world():
    """(JAX index, port index, long pattern, a short pattern)."""
    c = make_corpus(8, k=15, mean_length=400, sigma=1.0, seed=7)
    codes = np.random.default_rng(16).integers(0, 4, size=LONG_BP,
                                               dtype=np.uint8)
    doc_terms = [document_terms([codes], 15)] + c.doc_terms[1:]
    jax_index = jax_build_compact(doc_terms, JaxParams(1, 0.3, 15),
                                  block_docs=32, row_align=64)
    lay = jax_index.layout
    port = index_from_numpy(np.asarray(jax_index.storage.full_host()),
                            lay.row_offset, lay.block_width, lay.doc_slot,
                            lay.doc_n_terms, lay.block_docs, lay.n_docs,
                            jax_index.params.to_json(), device="cpu")
    return jax_index, port, decode_dna(codes), decode_dna(c.documents[3][:300])


def assert_same_result(got, want) -> None:
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.n_terms == want.n_terms
    assert got.threshold == want.threshold


@pytest.fixture(scope="module")
def world():
    return long_query_world()


def test_the_long_query_passes_the_old_cap(world):
    jax_index, port, long_pat, _ = world
    n_terms = compile_pattern(long_pat, port.params).shape[0]
    assert n_terms > 65_535 and -(-n_terms // 64) * 64 == 70_144
    want = JaxEngine(jax_index, method="ref").top_k(long_pat, 1)
    assert want.doc_ids.tolist() == [0] and int(want.scores[0]) > 65_535


@pytest.mark.parametrize("method", ["vertical", "lookup", "unpack"])
def test_long_search_equals_reference(world, method):
    jax_index, port, long_pat, _ = world
    want = JaxEngine(jax_index, method="ref").search(long_pat, THRESHOLD)
    assert want.doc_ids.size >= 2 and int(want.doc_ids[0]) == 0
    got = QueryEngine(port, method=method, device="cpu").search(long_pat,
                                                                THRESHOLD)
    assert_same_result(got, want)


@pytest.mark.parametrize("method", ["vertical", "lookup", "unpack"])
def test_long_search_batch_equals_reference(world, method):
    jax_index, port, long_pat, short_pat = world
    pats = [short_pat, long_pat]
    want = JaxEngine(jax_index, method="ref").search_batch(pats, THRESHOLD)
    got = QueryEngine(port, method=method, device="cpu").search_batch(
        pats, THRESHOLD)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_result(g, w)
