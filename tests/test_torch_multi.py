"""The port's ``MultiIndexEngine`` against the JAX package's, on the CPU.

Two or three datasets with different k-mer lengths and hash counts, the
same documents indexed under each; attach and detach, a subset of
datasets, thresholds, and ties across datasets (one index attached under
two names) — the merged hit list must equal JAX's field by field, in
order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import MultiIndexEngine as JaxMulti
from repro.core import build_classic as jax_classic
from repro.core import build_compact as jax_compact
from repro.data import make_corpus

from repro_torch.core import (IndexParams, MultiHit, MultiIndexEngine,
                              build_classic, build_compact)

torch.set_num_threads(2)

# name -> (k-mer length, hashes, layout)
DATASETS = {"k15": (15, 1, "compact"), "k11x2": (11, 2, "compact"),
            "k13classic": (13, 1, "classic")}


@pytest.fixture(scope="module")
def world():
    """(documents, name -> (JAX index, port index))."""
    out, docs = {}, None
    for name, (k, h, kind) in DATASETS.items():
        c = make_corpus(40, k=k, mean_length=300, sigma=0.8, seed=5)
        docs = c.documents
        if kind == "compact":
            j = jax_compact(c.doc_terms, JaxParams(h, 0.3, k), block_docs=32,
                            row_align=64)
            t = build_compact(c.doc_terms, IndexParams(h, 0.3, k),
                              block_docs=32, row_align=64, device="cpu")
        else:
            j = jax_classic(c.doc_terms, JaxParams(h, 0.3, k))
            t = build_classic(c.doc_terms, IndexParams(h, 0.3, k),
                              device="cpu")
        out[name] = (j, t)
    return docs, out


def _pair(world, names, method="vertical"):
    docs, idx = world
    jax_m, port_m = JaxMulti(method=method), MultiIndexEngine(
        method=method, device="cpu")
    for n in names:
        jax_m.attach(n, idx[n][0])
        port_m.attach(n, idx[n][1])
    return jax_m, port_m


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, MultiHit)
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
        assert all(type(a) is type(b) for a, b in
                   zip(dataclasses.astuple(g), dataclasses.astuple(w)))


def _patterns(docs):
    rng = np.random.default_rng(2)
    pats = [docs[i][:90] for i in (0, 3, 17)]
    pats.append(rng.integers(0, 4, 70, dtype=np.uint8))        # negative
    pats.append(docs[5][:8])                                    # < every k
    return pats


@pytest.mark.parametrize("method", ["vertical", "ref"])
def test_search_equals_jax(world, method):
    jax_m, port_m = _pair(world, list(DATASETS), method)
    assert port_m.datasets == jax_m.datasets == tuple(DATASETS)
    for p in _patterns(world[0]):
        for th in (0.0, 0.5, 0.9, 1.0):
            got, want = port_m.search(p, th), jax_m.search(p, th)
            _equal(got, want)
        if len(p) >= 90:
            assert {h.dataset for h in port_m.search(p, 0.9)} == \
                set(DATASETS)


def test_subset_attach_detach_equal_jax(world):
    jax_m, port_m = _pair(world, ["k15", "k11x2"])
    p = world[0][3][:90]
    for subset in (("k11x2",), ("k15",), ("k11x2", "k15"), ()):
        _equal(port_m.search(p, 0.5, datasets=subset),
               jax_m.search(p, 0.5, datasets=subset))
    for m in (port_m, jax_m):
        with pytest.raises(KeyError):
            m.attach("k15", world[1]["k15"][0 if m is jax_m else 1])
        m.detach("k15")
        m.attach("k13classic", world[1]["k13classic"][0 if m is jax_m
                                                       else 1])
    assert port_m.datasets == jax_m.datasets == ("k11x2", "k13classic")
    _equal(port_m.search(p, 0.5), jax_m.search(p, 0.5))
    with pytest.raises(KeyError):
        port_m.search(p, 0.5, datasets=("k15",))


def test_ties_across_datasets_equal_jax(world):
    """One index under two names scores every document twice, equally:
    the merge breaks each tie by dataset name, then document id."""
    docs, idx = world
    jax_m, port_m = JaxMulti(), MultiIndexEngine(device="cpu")
    for name in ("b", "a", "c"):
        jax_m.attach(name, idx["k15"][0])
        port_m.attach(name, idx["k15"][1])
    p = docs[0][:90]
    got, want = port_m.search(p, 0.0), jax_m.search(p, 0.0)
    _equal(got, want)
    assert [h.dataset for h in got[:3]] == ["a", "b", "c"]
    assert len(got) == 3 * len(docs)
