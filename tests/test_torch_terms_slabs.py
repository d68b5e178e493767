"""The fused-decode, dedup and chunk scoring wrappers on more than 65,535
terms, against the JAX package, on the CPU.

On the card all six take a long query in one launch (their kernels split
the term axis and flush full counter planes; ``test_torch_launch_contract.py``
checks the launches). Here each wrapper (its plain version) must equal the
JAX ``repro.kernels.ref`` oracle at L = 65,536, where one cell's count of
document 0 reaches 65,536 and so needs a 17th counter plane. Every
comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jax_ref

from repro_torch.kernels import bitslice_score as k

torch.set_num_threads(2)

L_LONG = 65_536
WRAPPERS = ["lookup_score_blocks_compressed", "lookup_score_multi_compressed",
            "dedup_score", "chunk_lookup_score_multi",
            "chunk_lookup_score_multi_compressed", "chunk_dedup_score"]


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _inputs(L: int, W: int, seed: int):
    """Rows [R, W] with document 0's bit set in every row, a rowdict pair
    over them, and idx / mask [1, 2, L]: cell 0 counts every term, cell 1
    a random half."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2 ** 32, size=(97, W), dtype=np.uint32)
    rows[:, 0] |= np.uint32(1)
    refs = rng.integers(0, 97, size=300).astype(np.int32)
    idx = rng.integers(0, 300, size=(1, 2, L)).astype(np.int32)
    mask = np.ones((1, 2, L), np.int32)
    mask[0, 1] = rng.integers(0, 2, size=L)
    return rows, refs, idx, mask


def _multi_ref(rows: np.ndarray, idx: np.ndarray, mask: np.ndarray
               ) -> np.ndarray:
    Q, nb, _ = idx.shape
    out = jax_ref.bitslice_lookup_score_multi_ref(
        jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(mask))
    return np.asarray(out).reshape(Q, nb, rows.shape[1], 32)


@pytest.mark.parametrize("name", WRAPPERS)
def test_long_wrapper_equals_reference(name):
    W = 1 + WRAPPERS.index(name) % 2
    rows, refs, idx, mask = _inputs(L_LONG, W, WRAPPERS.index(name))
    expanded = rows[refs]                       # the tile refs decodes to
    acc = np.random.default_rng(5).integers(0, 1000, size=(1, 2, 8, 32)
                                            ).astype(np.int32)
    fn = getattr(k, name)
    if name == "lookup_score_blocks_compressed":
        got = fn(_t(rows), _t(refs), _t(idx[0]), _t(mask[0]))
        want = np.asarray(jax_ref.bitslice_lookup_score_blocks_ref(
            jnp.asarray(expanded), jnp.asarray(idx[0]), jnp.asarray(mask[0])
        )).reshape(2, W, 32)
    elif name == "lookup_score_multi_compressed":
        got = fn(_t(rows), _t(refs), _t(idx), _t(mask))
        want = _multi_ref(expanded, idx, mask)
    elif name == "dedup_score":
        # uniq holds the expanded tile's rows, indir points into it
        got = fn(_t(expanded), _t(idx), _t(mask))
        want = np.asarray(jax_ref.bitslice_lookup_score_dedup_ref(
            jnp.asarray(rows), jnp.asarray(refs), jnp.asarray(idx),
            jnp.asarray(mask))).reshape(1, 2, W, 32)
    else:
        if name == "chunk_lookup_score_multi":
            got = fn(_t(expanded), _t(idx), _t(mask), _t(acc))
        elif name == "chunk_dedup_score":
            got = fn(_t(expanded), _t(idx), _t(mask), _t(acc))
        else:
            got = fn(_t(rows), _t(refs), _t(idx), _t(mask), _t(acc))
        want = acc.copy()
        want[:, :, :W] += _multi_ref(expanded, idx, mask)
    assert want.max() > 65_535                  # past 16 counter planes
    np.testing.assert_array_equal(got.numpy(), want)
