"""Public scoring operations, the counterparts of ``repro.kernels.ops``.

They keep the JAX wrappers' output shapes and (block, word, bit) slot
order. ``method='ref'`` runs the plain oracle of ``ref.py``; the other
methods go through the kernel wrappers in ``bitslice_score.py``, which take
any word count W, so no padding to a word block is needed (the JAX wrappers
pad W and slice back; the output is the same).
"""
from __future__ import annotations

import torch

from . import bitslice_score as _k
from . import ref as _ref

METHODS = ("ref", "unpack", "vertical", "lookup")


def bitslice_score(rows: torch.Tensor, method: str = "vertical"
                   ) -> torch.Tensor:
    """Score ADD step: int32 [L, W] masked rows -> int32 [W * 32]; a
    leading batch axis [B, L, W] gives [B, W * 32]. Zero rows add zero."""
    if method == "ref":
        return _ref.bitslice_score_ref(rows)
    if method == "unpack":
        out = _k.unpack_score(rows)
    elif method == "vertical":
        out = _k.vertical_score(rows)
    else:
        raise ValueError(f"unknown method {method!r}; one of "
                         "('ref', 'unpack', 'vertical')")
    return out.reshape(*rows.shape[:-2], -1)


def bitslice_lookup_score(arena: torch.Tensor, rows_idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Fused gather + score from the arena: rows_idx, mask int32 [L]
    -> int32 [W * 32]."""
    return _k.lookup_score(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_blocks(arena: torch.Tensor, rows_idx: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Multi-block fused gather + score: rows_idx, mask int32 [nb, L]
    -> int32 [nb * W * 32] in (block, word, bit) slot order."""
    return _k.lookup_score_blocks(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_multi(arena: torch.Tensor, rows_idx: torch.Tensor,
                                mask: torch.Tensor, grid_order: str = "wq"
                                ) -> torch.Tensor:
    """Multi-query fused gather + score: rows_idx, mask int32 [Q, nb, L]
    -> int32 [Q, nb * W * 32], each query in (block, word, bit) slot order.
    ``grid_order`` is accepted as the autotuner's key and validated."""
    out = _k.lookup_score_multi(arena, rows_idx, mask, grid_order=grid_order)
    return out.reshape(rows_idx.shape[0], -1)


def bitslice_lookup_score_blocks_comp(dict_rows: torch.Tensor,
                                      refs: torch.Tensor,
                                      rows_idx: torch.Tensor,
                                      mask: torch.Tensor) -> torch.Tensor:
    """``bitslice_lookup_score_blocks`` over a rowdict pair (dict [D, W],
    refs [R]): rows_idx, mask int32 [nb, L] -> int32 [nb * W * 32]."""
    return _k.lookup_score_blocks_compressed(dict_rows, refs, rows_idx,
                                             mask).reshape(-1)


def bitslice_lookup_score_multi_comp(dict_rows: torch.Tensor,
                                     refs: torch.Tensor,
                                     rows_idx: torch.Tensor,
                                     mask: torch.Tensor,
                                     grid_order: str = "wq") -> torch.Tensor:
    """``bitslice_lookup_score_multi`` over a rowdict pair: rows_idx, mask
    int32 [Q, nb, L] -> int32 [Q, nb * W * 32]."""
    out = _k.lookup_score_multi_compressed(dict_rows, refs, rows_idx, mask,
                                           grid_order=grid_order)
    return out.reshape(rows_idx.shape[0], -1)


def and_rows(rows: torch.Tensor) -> torch.Tensor:
    """AND over the k hash rows: int32 [L, k, W] -> [L, W]."""
    return _ref.and_rows_ref(rows)
