"""Plain PyTorch oracles, the counterparts of ``repro.kernels.ref``.

Inputs are int32 tensors carrying uint32 bit patterns; ``>>`` on int32 is
arithmetic, but ``(x >> b) & 1`` is still bit b. Outputs are int32 counts
with the same shapes and slot order as the JAX oracles, so tests compare
them exactly.
"""
from __future__ import annotations

import torch


def _bits(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., W] -> int32 [..., W, 32], bit b of each word (LSB first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (words[..., None] >> shifts) & 1


def bitslice_score_ref(rows: torch.Tensor) -> torch.Tensor:
    """Score ADD step: int32 [L, W] rows -> int32 [W * 32] per-document
    counts in word-major, LSB-first order. A leading batch axis [B, L, W]
    gives [B, W * 32]."""
    counts = _bits(rows).sum(dim=-3, dtype=torch.int32)
    return counts.reshape(*rows.shape[:-2], rows.shape[-1] * 32)


def _masked_counts(arena: torch.Tensor, rows_idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Sum over the term axis (the last of rows_idx) of the gathered rows'
    bits, terms with mask 0 dropped -> int32 [..., W, 32]."""
    bits = _bits(arena[rows_idx.long()]) * mask[..., None, None]
    return bits.sum(dim=-3, dtype=torch.int32)


def bitslice_lookup_score_ref(arena: torch.Tensor, rows_idx: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Fused GATHER + ADD: arena [R, W], rows_idx [L], mask [L]
    -> int32 [W * 32]."""
    return _masked_counts(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_blocks_ref(arena: torch.Tensor,
                                     rows_idx: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Multi-block: rows_idx, mask [nb, L] -> int32 [nb * W * 32] in
    (block, word, bit) order."""
    return _masked_counts(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_multi_ref(arena: torch.Tensor,
                                    rows_idx: torch.Tensor,
                                    mask: torch.Tensor) -> torch.Tensor:
    """Multi-query: rows_idx, mask [Q, nb, L] -> int32 [Q, nb * W * 32],
    each query in (block, word, bit) slot order."""
    return _masked_counts(arena, rows_idx, mask).reshape(rows_idx.shape[0],
                                                         -1)


def bitslice_lookup_score_blocks_comp_ref(dict_rows: torch.Tensor,
                                          refs: torch.Tensor,
                                          rows_idx: torch.Tensor,
                                          mask: torch.Tensor) -> torch.Tensor:
    """Multi-block over a rowdict pair: the raw oracle on the expanded
    tile ``dict_rows[refs]`` -> int32 [nb * W * 32]."""
    return bitslice_lookup_score_blocks_ref(dict_rows[refs.long()],
                                            rows_idx, mask)


def bitslice_lookup_score_multi_comp_ref(dict_rows: torch.Tensor,
                                         refs: torch.Tensor,
                                         rows_idx: torch.Tensor,
                                         mask: torch.Tensor) -> torch.Tensor:
    """Multi-query over a rowdict pair: the raw oracle on the expanded
    tile ``dict_rows[refs]`` -> int32 [Q, nb * W * 32]."""
    return bitslice_lookup_score_multi_ref(dict_rows[refs.long()],
                                           rows_idx, mask)


def and_rows_ref(rows: torch.Tensor) -> torch.Tensor:
    """AND step over the k hash functions: [L, k, W] -> [L, W]."""
    out = rows[:, 0]
    for i in range(1, rows.shape[1]):
        out = out & rows[:, i]
    return out
