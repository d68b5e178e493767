"""Term hashing for the signature index: a murmur3-style 32-bit mix over the
packed (lo, hi) words, bit-identical to ``repro.core.hashing``.

The word convention. ``torch.uint32`` has no ``>>``, ``<<``, ``+`` or ``%``
on the CPU, so the port carries uint32 values as ``torch.int32`` bit
patterns:

* ``*``, ``+``, ``^``, ``&``, ``|`` and ``<<`` on int32 wrap mod 2^32 and
  give the uint32 result's bits;
* ``>>`` on int32 is arithmetic, so a logical right shift by r is
  ``(x >> r) & ((1 << (32 - r)) - 1)``;
* a modulo by a width goes through ``x.to(torch.int64) & 0xFFFFFFFF``
  (``as_unsigned``).

At the numpy border use ``.view(np.uint32)`` and ``.view(np.int32)``.
"""
from __future__ import annotations

import numpy as np
import torch

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_SEED_MIX = 0x2545F491
_ADD = 0xE6546B64


def _i32(c: int) -> int:
    """The int32 bit pattern of a uint32 constant, as a Python int."""
    return int(np.uint32(c).view(np.int32))


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 32 - r)


def as_unsigned(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _mix(h: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    k = _rotl(word * _i32(_C1), 15) * _i32(_C2)
    return _rotl(h ^ k, 13) * 5 + _i32(_ADD)


def hash_terms(terms: torch.Tensor, n_hashes: int) -> torch.Tensor:
    """Hash packed terms int32 [..., 2] (uint32 lo/hi bit patterns) with
    seeds 0..n_hashes-1 -> int32 [..., n_hashes], the uint32 hashes' bits.

    Range reduction to a filter width happens later by modulo (the paper's
    'one hash function with a larger output range, then modulo').
    """
    if terms.dtype != torch.int32:
        raise TypeError(f"terms must be int32 bit patterns, got {terms.dtype}")
    lo = terms[..., 0:1]
    hi = terms[..., 1:2]
    seeds = torch.arange(n_hashes, dtype=torch.int32, device=terms.device)
    seeds = seeds.reshape((1,) * (terms.dim() - 1) + (n_hashes,))
    h = (seeds * _i32(_GOLD)) ^ _i32(_SEED_MIX)
    h = _mix(h, lo)
    h = _mix(h, hi)
    h = h ^ 8  # 8 bytes mixed
    # fmix32 finalizer
    h = h ^ lsr(h, 16)
    h = h * _i32(_F1)
    h = h ^ lsr(h, 13)
    h = h * _i32(_F2)
    return h ^ lsr(h, 16)


def _rotl_np(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def hash_terms_np(terms: np.ndarray, n_hashes: int) -> np.ndarray:
    """Host-side numpy mirror of ``hash_terms`` on uint32 values
    -> uint32 [..., n_hashes]."""
    terms = np.asarray(terms, dtype=np.uint32)
    lo = terms[..., 0:1]
    hi = terms[..., 1:2]
    seeds = np.arange(n_hashes, dtype=np.uint32).reshape(
        (1,) * (terms.ndim - 1) + (n_hashes,))
    u = np.uint32
    with np.errstate(over="ignore"):
        h = (seeds * u(_GOLD)) ^ u(_SEED_MIX)
        for word in (lo, hi):
            k = _rotl_np(word * u(_C1), 15) * u(_C2)
            h = _rotl_np(h ^ k, 13) * u(5) + u(_ADD)
        h = h ^ u(8)
        h = h ^ (h >> u(16))
        h = h * u(_F1)
        h = h ^ (h >> u(13))
        h = h * u(_F2)
        return h ^ (h >> u(16))
