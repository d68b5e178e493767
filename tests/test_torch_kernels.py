"""The PyTorch port's scoring kernels against the JAX package, on the CPU.

Here every wrapper takes its plain PyTorch version (the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds each against its plain
version). Each plain version must equal ``repro.kernels.ref`` and the JAX
``ops`` (Pallas in interpret mode, at small shapes only, since interpret
mode is slow). Every comparison is exact (``np.testing.assert_array_equal``):
the outputs are integer counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import bitslice_score as jax_k
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.core.query import coverage_cutoff, select_hits
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import bitslice_score as k

torch.set_num_threads(2)

# the shapes of tests/test_kernels.py
SHAPES = [(8, 8), (8, 128), (16, 128), (64, 256), (8, 384), (200, 96),
          (1, 8), (7, 130), (1000, 64)]
SMALL = {(8, 8), (1, 8), (7, 130), (16, 128)}   # also run through Pallas
LOOKUP_SHAPES = [(1, 1, 8, 8), (3, 2, 17, 8), (4, 1, 33, 130),
                 (2, 3, 64, 40), (1, 2, 100, 130)]


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("L,W", SHAPES)
@pytest.mark.parametrize("method", ["unpack", "vertical"])
def test_score_equals_reference(L, W, method):
    rows = _words(np.random.default_rng(L * 1000 + W), L, W)
    want = np.asarray(jax_ref.bitslice_score_ref(jnp.asarray(rows)))
    np.testing.assert_array_equal(ops.bitslice_score(_t(rows), method).numpy(),
                                  want)
    np.testing.assert_array_equal(ref.bitslice_score_ref(_t(rows)).numpy(),
                                  want)
    wrapper = k.unpack_score if method == "unpack" else k.vertical_score
    np.testing.assert_array_equal(wrapper(_t(rows)).numpy().reshape(-1),
                                  want)
    if (L, W) in SMALL:
        np.testing.assert_array_equal(
            np.asarray(jax_ops.bitslice_score(jnp.asarray(rows),
                                              method=method)), want)


@pytest.mark.parametrize("method", ["ref", "unpack", "vertical"])
def test_batched_score_equals_each_entry(method):
    rows = _words(np.random.default_rng(3), 5, 37, 24)
    got = ops.bitslice_score(_t(rows), method).numpy()
    assert got.shape == (5, 24 * 32)
    for b in range(5):
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_ref.bitslice_score_ref(
                jnp.asarray(rows[b]))))


def test_edge_rows():
    L, W = 24, 32
    ones = np.full((L, W), 0xFFFFFFFF, dtype=np.uint32)
    one_bit = np.zeros((8, 16), dtype=np.uint32)
    one_bit[3, 5] = np.uint32(1) << 31           # doc 5 * 32 + 31
    for method in ("unpack", "vertical"):
        assert (ops.bitslice_score(_t(ones), method) == L).all()
        out = ops.bitslice_score(_t(one_bit), method)
        assert out[5 * 32 + 31] == 1 and int(out.sum()) == 1
        assert (ops.bitslice_score(torch.zeros((16, 64), dtype=torch.int32),
                                   method) == 0).all()


@pytest.mark.parametrize("Q,nb,L,W", LOOKUP_SHAPES)
def test_lookup_equals_reference(Q, nb, L, W):
    rng = np.random.default_rng(Q * 1000 + nb * 100 + L)
    R = 4 * L
    arena = _words(rng, R, W)
    idx = rng.integers(0, R, size=(Q, nb, L)).astype(np.int32)
    mask = rng.integers(0, 2, size=(Q, nb, L)).astype(np.int32)
    ja, ti = jnp.asarray(arena), _t(arena)
    small = W <= 8
    # rank 3: the multi-query kernel
    want = np.asarray(jax_ref.bitslice_lookup_score_multi_ref(
        ja, jnp.asarray(idx), jnp.asarray(mask)))
    for grid_order in ("wq", "qw"):
        np.testing.assert_array_equal(ops.bitslice_lookup_score_multi(
            ti, _t(idx), _t(mask), grid_order=grid_order).numpy(), want)
    np.testing.assert_array_equal(ref.bitslice_lookup_score_multi_ref(
        ti, _t(idx), _t(mask)).numpy(), want)
    if small:
        np.testing.assert_array_equal(np.asarray(
            jax_ops.bitslice_lookup_score_multi(
                ja, jnp.asarray(idx), jnp.asarray(mask))), want)
    # rank 2: blocks of one query
    want = np.asarray(jax_ref.bitslice_lookup_score_blocks_ref(
        ja, jnp.asarray(idx[0]), jnp.asarray(mask[0])))
    np.testing.assert_array_equal(ops.bitslice_lookup_score_blocks(
        ti, _t(idx[0]), _t(mask[0])).numpy(), want)
    np.testing.assert_array_equal(ref.bitslice_lookup_score_blocks_ref(
        ti, _t(idx[0]), _t(mask[0])).numpy(), want)
    if small:
        np.testing.assert_array_equal(np.asarray(
            jax_ops.bitslice_lookup_score_blocks(
                ja, jnp.asarray(idx[0]), jnp.asarray(mask[0]))), want)
    # rank 1: one block
    want = np.asarray(jax_ref.bitslice_lookup_score_ref(
        ja, jnp.asarray(idx[0, 0]), jnp.asarray(mask[0, 0])))
    np.testing.assert_array_equal(ops.bitslice_lookup_score(
        ti, _t(idx[0, 0]), _t(mask[0, 0])).numpy(), want)
    np.testing.assert_array_equal(ref.bitslice_lookup_score_ref(
        ti, _t(idx[0, 0]), _t(mask[0, 0])).numpy(), want)
    if small:
        np.testing.assert_array_equal(np.asarray(
            jax_ops.bitslice_lookup_score(
                ja, jnp.asarray(idx[0, 0]), jnp.asarray(mask[0, 0]))), want)


def test_kernel_shapes():
    rng = np.random.default_rng(1)
    arena = _t(_words(rng, 40, 3))
    idx = torch.zeros((2, 4, 5), dtype=torch.int32)
    assert k.lookup_score_multi(arena, idx, idx).shape == (2, 4, 3, 32)
    assert k.lookup_score_blocks(arena, idx[0], idx[0]).shape == (4, 3, 32)
    assert k.lookup_score(arena, idx[0, 0], idx[0, 0]).shape == (3, 32)
    rows = _t(_words(rng, 7, 3))
    assert k.unpack_score(rows).shape == k.vertical_score(rows).shape == \
        (3, 32)
    assert k.vertical_score(rows[None]).shape == (1, 3, 32)


def test_and_rows():
    rows = _words(np.random.default_rng(0), 8, 3, 16)
    np.testing.assert_array_equal(
        ops.and_rows(_t(rows)).numpy().view(np.uint32),
        np.asarray(jax_ops.and_rows(jnp.asarray(rows))))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 1023, 1024, 65535])
def test_num_planes_equals_reference(n):
    assert k.num_planes(n) == jax_k._num_planes(n)


def test_grid_order_is_validated():
    arena = torch.zeros((4, 2), dtype=torch.int32)
    idx = torch.zeros((1, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="grid_order"):
        ops.bitslice_lookup_score_multi(arena, idx, idx, grid_order="ww")


def test_wrappers_check_their_inputs():
    arena = torch.zeros((10, 4), dtype=torch.int32)
    idx = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(TypeError):
        k.vertical_score(torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        k.unpack_score(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        k.unpack_score(torch.zeros((4, 3), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="dimensions"):
        k.lookup_score(arena, idx, idx)
    with pytest.raises(ValueError, match="mask shape"):
        k.lookup_score_blocks(arena, idx, idx[:, :4].contiguous())
    with pytest.raises(IndexError):
        k.lookup_score_blocks(arena, idx + 10, idx)
    with pytest.raises(IndexError):
        k.lookup_score_blocks(arena, idx - 1, idx)
    # more rows than 16 counter planes count: no cap, the plain counts
    ones = torch.full((1 << 16, 1), -1, dtype=torch.int32)
    assert torch.equal(k.vertical_score(ones),
                       torch.full((1, 32), 1 << 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        k.vertical_score(torch.zeros((3, 4), dtype=torch.int32,
                                     device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        k.lookup_score(arena, idx[0], idx[0].to("meta"))
    with pytest.raises(ValueError, match="unknown method"):
        ops.bitslice_score(torch.zeros((3, 4), dtype=torch.int32), "lookup")
    scores = torch.zeros((4, 16), dtype=torch.int32)
    slot = torch.arange(10, dtype=torch.int32)
    cut = torch.ones(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        k.select_scores(scores.long(), slot, cut, 4)
    with pytest.raises(ValueError, match="dimensions"):
        k.select_scores(scores, slot[None], cut, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k.select_scores(torch.zeros((16, 4), dtype=torch.int32).T, slot,
                        cut, 4)
    with pytest.raises(ValueError, match="5 cutoffs for 4 score rows"):
        k.select_scores(scores, slot, torch.ones(5, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="cap"):
        k.select_scores(scores, slot, cut, 0)
    with pytest.raises(IndexError, match="outside the scores' 16 slots"):
        k.select_scores(scores, slot + 7, cut, 4)
    with pytest.raises(IndexError):
        k.select_scores(scores, slot - 1, cut, 4, range_checked=True)
    with pytest.raises(ValueError, match="different devices"):
        k.select_scores(scores, slot, cut.to("meta"), 4)


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(k.launches)
    rng = np.random.default_rng(2)
    rows, arena = _t(_words(rng, 9, 5)), _t(_words(rng, 30, 5))
    idx = torch.from_numpy(rng.integers(0, 30, size=(2, 3, 9)).astype(
        np.int32))
    k.unpack_score(rows)
    k.vertical_score(rows)
    k.lookup_score(arena, idx[0, 0], idx[0, 0])
    k.lookup_score_blocks(arena, idx[0], idx[0])
    k.lookup_score_multi(arena, idx, idx)
    k.select_scores(idx.reshape(6, 9), torch.arange(9, dtype=torch.int32),
                    idx[:, 0, 0].contiguous(), 4)
    assert k.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", missing)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_kernel_source_defines_every_entry_point():
    src = _build.SOURCE.read_text()
    for name in list(_build._SIGNATURES) + ["cobs_error_string"]:
        assert f'extern "C" ' in src and f" {name}(" in src
    assert _build.library_path().parent == _build.BUILD_DIR
    # the selection's entry point launches the selection kernel, whose
    # name no scoring kernel's pattern (``*_kernel`` of a lookup, dedup,
    # gather, unpack or vertical) takes in
    entry = src[src.index(" cobs_select_hits("):]
    assert "select_kernel<<<" in entry[:entry.index("\n}")]
    assert "cobs_select_hits" in _build._SIGNATURES
    assert k.launches["select_scores"] >= 0


# --------------------------------------------------------------------------
# selection: select_plain's hit lists against select_hits
# --------------------------------------------------------------------------

# name -> (queries Q, score rows R >= Q, documents, slots, n_terms of each
# query, threshold, scores drawn from [lo, hi) as shares of n_terms, cap)
SELECT_CASES = {
    "ties": (4, 4, 300, 320, [40, 41, 40, 7], 0.8, (0.6, 1.01), 1024),
    "none above": (3, 4, 200, 256, [50, 50, 50], 0.9, (0.0, 0.85), 1024),
    "no terms": (2, 2, 64, 64, [0, 30], 0.5, (0.0, 1.01), 1024),
    "Q not a power of two": (5, 8, 500, 512, [60, 61, 62, 63, 64], 0.7,
                             (0.5, 1.01), 1024),
    "Q = 1": (1, 1, 90, 96, [25], 0.6, (0.3, 1.01), 1024),
    "over the cap": (3, 4, 300, 320, [20, 20, 20], 0.5, (0.3, 1.01), 7),
    "no documents": (2, 2, 0, 32, [10, 10], 0.5, (0.0, 1.01), 4),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_plain_equals_select_hits(case):
    Q, R, n_docs, S, ells, thr, (lo, hi), cap = SELECT_CASES[case]
    rng = np.random.default_rng(len(case))
    scores = np.stack([rng.integers(int(lo * max(e, 1)),
                                    int(hi * max(e, 1)) + 1, size=S)
                       for e in ells + [0] * (R - Q)]).astype(np.int32)
    doc_slot = rng.permutation(S)[:n_docs].astype(np.int32)
    # a query with no terms gets the cutoff no score reaches, as the
    # server gives it
    cut = np.array([coverage_cutoff(thr, e) if e else np.iinfo(np.int32).max
                    for e in ells], np.int32)
    lists = k.select_plain(_t(scores), _t(doc_slot), _t(cut), cap).numpy()
    assert lists.shape == (Q, 1 + 2 * cap) and lists.dtype == np.int32
    np.testing.assert_array_equal(
        k.select_scores(_t(scores), _t(doc_slot), _t(cut), cap).numpy(),
        lists)
    for q, e in enumerate(ells):
        want = select_hits(scores[q][doc_slot], e, thr)
        n = int(lists[q, 0])
        if e == 0:
            assert n == 0 and want.doc_ids.size == 0
            continue
        assert n == want.doc_ids.size
        # the first min(n, cap) hits in document order, then zeros
        by_doc = np.argsort(want.doc_ids, kind="stable")[:cap]
        pairs = lists[q, 1:1 + 2 * min(n, cap)].reshape(-1, 2)
        np.testing.assert_array_equal(pairs[:, 0], want.doc_ids[by_doc])
        np.testing.assert_array_equal(pairs[:, 1], want.scores[by_doc])
        assert not lists[q, 1 + 2 * min(n, cap):].any()
    if case == "ties":
        assert max(np.bincount(lists[:, 2::2][lists[:, 2::2] > 0])) > 1
    if case == "none above":
        assert not lists[:, 0].any()
    if case == "over the cap":
        assert (lists[:, 0] > cap).all()
