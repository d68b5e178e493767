"""The port's chunked-accumulator kernels and their ops against the JAX
package, on the CPU.

The three chunk wrappers (``chunk_lookup_score_multi``, its fused-decode
twin and ``chunk_dedup_score``) take their plain versions here; each must
return the JAX ``ops.bitslice_chunk_score_*`` running counts and block
maxima (Pallas in interpret mode) exactly, including buffers whose word
axis is padded past W. ``chunk_topk_lower``, ``bulk_query_chunk``,
``chunk_acc_init`` / ``chunk_acc_scores`` and ``gather_and_rows(_comp)``
must equal theirs too. Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jax_ops

from repro_torch.kernels import _build, ops
from repro_torch.kernels import bitslice_score as k

torch.set_num_threads(2)

CPU = "cpu"
# (Q, nb, Lc, W, R): W = 1 and 4 pad acc to 8 words, W = 130 to 256
CHUNK_SHAPES = [(1, 1, 8, 1, 40), (3, 2, 17, 4, 300), (2, 3, 32, 8, 90),
                (2, 1, 5, 130, 64)]


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _inputs(Q, nb, L, W, R, seed):
    rng = np.random.default_rng(seed)
    rows = _words(rng, R, W)
    rows[0] = 0xFFFFFFFF
    idx = rng.integers(0, R, size=(Q, nb, L)).astype(np.int32)
    idx[..., 1 % L] = idx[..., 0]                   # a repeated row
    mask = rng.integers(0, 2, size=(Q, nb, L)).astype(np.int32)
    mask[0, 0] = 0                                  # a cell of no terms
    wp = np.asarray(jax_ops.chunk_acc_init(Q, nb, W)).shape[2]
    acc = rng.integers(0, 50, size=(Q, nb, wp, 32)).astype(np.int32)
    return rng, rows, idx, mask, acc


@pytest.mark.parametrize("kind", ["multi", "comp", "dedup"])
@pytest.mark.parametrize("Q,nb,L,W,R", CHUNK_SHAPES)
def test_chunk_scores_equal_reference(Q, nb, L, W, R, kind):
    rng, rows, idx, mask, acc = _inputs(Q, nb, L, W, R, Q * 100 + L)
    assert acc.shape[2] >= W
    if kind == "multi":
        want = jax_ops.bitslice_chunk_score_multi(
            jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(mask),
            jnp.asarray(acc))
        got = ops.bitslice_chunk_score_multi(_t(rows), _t(idx), _t(mask),
                                             _t(acc))
        plain = k.chunk_plain(_t(rows), _t(idx), _t(mask), _t(acc))
    elif kind == "comp":
        D = max(2, R // 7)
        dict_rows = rows[:D]
        refs = rng.integers(0, D, size=R).astype(np.int32)
        want = jax_ops.bitslice_chunk_score_multi_comp(
            jnp.asarray(dict_rows), jnp.asarray(refs), jnp.asarray(idx),
            jnp.asarray(mask), jnp.asarray(acc))
        got = ops.bitslice_chunk_score_multi_comp(
            _t(dict_rows), _t(refs), _t(idx), _t(mask), _t(acc))
        plain = k.chunk_plain(_t(dict_rows[refs]), _t(idx), _t(mask),
                              _t(acc))
    else:
        want = jax_ops.bitslice_chunk_score_dedup(
            jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(mask),
            jnp.asarray(acc))
        got = ops.bitslice_chunk_score_dedup(_t(rows), _t(idx), _t(mask),
                                             _t(acc))
        plain = k.chunk_plain(_t(rows), _t(idx), _t(mask), _t(acc))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want[0]))
    # the padded words keep their running counts: no row reaches them
    np.testing.assert_array_equal(got[0].numpy()[:, :, W:], acc[:, :, W:])


# the two chunk lookups' word geometries on the card: the bulk sweep's dense
# chunk (W = Wp = 32) and the rowdict store's tallest shard (W = 4, Wp = 8);
# L = 1024 ends on a shared-memory index stage, 1025 crosses one
@pytest.mark.parametrize("kind,W", [("multi", 32), ("comp", 4)])
@pytest.mark.parametrize("L", [1, 7, 33, 1024, 1025])
def test_chunk_lookups_at_the_card_geometries(kind, W, L):
    Q, nb, R = 3, 1, 500
    rng, rows, idx, mask, acc = _inputs(Q, nb, L, W, R, L * 10 + W)
    assert acc.shape[2] == (32 if W == 32 else 8)
    if kind == "multi":
        want = jax_ops.bitslice_chunk_score_multi(
            jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(mask),
            jnp.asarray(acc))
        got = k.chunk_lookup_score_multi(_t(rows), _t(idx), _t(mask),
                                         _t(acc))
    else:
        D = 60
        refs = rng.integers(0, D, size=R).astype(np.int32)
        want = jax_ops.bitslice_chunk_score_multi_comp(
            jnp.asarray(rows[:D]), jnp.asarray(refs), jnp.asarray(idx),
            jnp.asarray(mask), jnp.asarray(acc))
        got = k.chunk_lookup_score_multi_compressed(
            _t(rows[:D]), _t(refs), _t(idx), _t(mask), _t(acc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))


def test_chunks_telescope_into_the_full_lookup():
    """Chunk by chunk from a fresh buffer, the counts add up to the
    unchunked fused lookup's."""
    rng, rows, idx, mask, _ = _inputs(3, 2, 40, 5, 200, 9)
    acc = ops.chunk_acc_init(3, 2, 5, device=CPU)
    for j0 in range(0, 40, 16):
        sl = slice(j0, j0 + 16)
        acc, bmax = ops.bitslice_chunk_score_multi(
            _t(rows), _t(idx[..., sl].copy()), _t(mask[..., sl].copy()), acc)
        np.testing.assert_array_equal(bmax.numpy(),
                                      acc.amax(dim=(2, 3)).numpy())
    want = k.lookup_score_multi(_t(rows), _t(idx), _t(mask))
    np.testing.assert_array_equal(
        ops.chunk_acc_scores(acc, 5).numpy(),
        want.reshape(3, -1).numpy())


@pytest.mark.parametrize("W", [1, 4, 8, 32, 33, 130])
@pytest.mark.parametrize("nb", [1, 2, 5])
def test_acc_topk_and_query_chunk_equal_reference(nb, W):
    rng = np.random.default_rng(nb * 1000 + W)
    jacc = np.asarray(jax_ops.chunk_acc_init(3, nb, W))
    tacc = ops.chunk_acc_init(3, nb, W, device=CPU)
    assert tuple(tacc.shape) == jacc.shape and tacc.dtype == torch.int32
    assert not tacc.any()
    acc = rng.integers(0, 9, size=jacc.shape).astype(np.int32)
    for kk in (1, 5, 64, 10 ** 6):
        np.testing.assert_array_equal(
            ops.chunk_topk_lower(_t(acc), kk).numpy(),
            np.asarray(jax_ops.chunk_topk_lower(jnp.asarray(acc), kk)))
    np.testing.assert_array_equal(
        ops.chunk_acc_scores(_t(acc), W).numpy(),
        np.asarray(jax_ops.chunk_acc_scores(jnp.asarray(acc), W)))
    for word_block in (None, 8):
        for budget in (2 ** 10, 2 ** 20, 32 * 2 ** 20):
            assert ops.bulk_query_chunk(
                nb, W, word_block=word_block, budget_bytes=budget) == \
                jax_ops.bulk_query_chunk(nb, W, word_block=word_block,
                                         budget_bytes=budget)


@pytest.mark.parametrize("n_hashes", [1, 2, 3])
def test_gather_and_rows_equal_reference(n_hashes):
    rng = np.random.default_rng(n_hashes)
    arena = _words(rng, 50, 3)
    rows = rng.integers(0, 50, size=(9, n_hashes)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_and_rows(_t(arena), _t(rows)).numpy().view(np.uint32),
        np.asarray(jax_ops.gather_and_rows(jnp.asarray(arena),
                                           jnp.asarray(rows))))
    D = 11
    refs = rng.integers(0, D, size=50).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_and_rows_comp(_t(arena[:D]), _t(refs), _t(rows)).numpy()
        .view(np.uint32),
        np.asarray(jax_ops.gather_and_rows_comp(
            jnp.asarray(arena[:D]), jnp.asarray(refs), jnp.asarray(rows))))


def test_chunk_wrappers_check_their_inputs():
    arena = torch.zeros((6, 4), dtype=torch.int32)
    refs = torch.zeros(10, dtype=torch.int32)
    idx = torch.zeros((2, 3, 5), dtype=torch.int32)
    acc = torch.zeros((2, 3, 8, 32), dtype=torch.int32)
    multi, comp, dedup = (k.chunk_lookup_score_multi,
                          k.chunk_lookup_score_multi_compressed,
                          k.chunk_dedup_score)
    assert multi(arena, idx, idx, acc).shape == acc.shape
    assert comp(arena, refs, idx, idx, acc).shape == acc.shape
    assert dedup(arena, idx, idx, acc).shape == acc.shape
    with pytest.raises(TypeError, match="int32"):
        multi(arena, idx, idx, acc.to(torch.int64))
    with pytest.raises(ValueError, match="dimensions"):
        multi(arena, idx[0], idx[0], acc)
    with pytest.raises(ValueError, match="acc shape"):
        multi(arena, idx, idx, acc[:, :2].contiguous())
    with pytest.raises(ValueError, match="acc shape"):
        multi(arena, idx, idx, acc[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="acc shape"):
        dedup(arena, idx, idx, torch.zeros((2, 3, 8, 31), dtype=torch.int32))
    with pytest.raises(IndexError):
        multi(arena, idx + 6, idx, acc)
    with pytest.raises(IndexError):
        comp(arena, refs, idx + 10, idx, acc)
    with pytest.raises(IndexError):
        dedup(arena, idx - 1, idx, acc)
    with pytest.raises(ValueError, match="contiguous"):
        dedup(arena, idx, idx, acc.transpose(0, 1))
    with pytest.raises(ValueError, match="different devices"):
        multi(arena, idx, idx, acc.to("meta"))


def test_chunk_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(k.launches)
    _, rows, idx, mask, acc = _inputs(2, 2, 6, 3, 20, 4)
    refs = _t(np.arange(20, dtype=np.int32) % 7)
    for checked in (False, True):
        k.chunk_lookup_score_multi(_t(rows), _t(idx), _t(mask), _t(acc),
                                   range_checked=checked)
        k.chunk_lookup_score_multi_compressed(
            _t(rows[:7]), refs, _t(idx), _t(mask), _t(acc),
            range_checked=checked)
        k.chunk_dedup_score(_t(rows), _t(idx), _t(mask), _t(acc),
                            range_checked=checked)
    assert k.launches == before
    for name in ("chunk_lookup_score_multi",
                 "chunk_lookup_score_multi_compressed", "chunk_dedup_score"):
        assert name in k.launches


def test_chunk_kernels_in_the_source():
    src = _build.SOURCE.read_text()
    # the three chunk kernels run the split body, launched with a cluster
    for kernel in ("chunk_lookup_kernel", "chunk_lookup_comp_kernel",
                   "chunk_dedup_kernel"):
        assert f"\n{kernel}(" in src
        assert f"launch_split({kernel}" in src
        assert f"{kernel}<<<" not in src
    for symbol in ("cobs_chunk_lookup", "cobs_chunk_lookup_comp",
                   "cobs_chunk_dedup"):
        assert symbol in _build._SIGNATURES
        assert f'extern "C" int {symbol}(' in src
