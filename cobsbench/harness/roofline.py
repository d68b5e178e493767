"""The scoring work of a batch and the card's peaks: the benchmark's own
count of what a scoring dispatch has to move, whatever kernel does it.

Scoring a batch of queries against an index of ``n_blocks`` blocks of
``doc_words`` 32-bit words a row needs, at the least:

* bytes: each arena row that a valid (query, term, hash, block) cell
  addresses, read once (a row two cells share counts once); each query's
  packed terms (8 bytes a term) read once; each live query's count for
  every document (4 bytes a document) written once;
* operations: one addition for each document bit of each row that a cell
  reads (32 a word).

Its bound is the larger of bytes over the card's memory bandwidth and
operations over its integer peak. The peaks are the published ones of
the card's data sheet, dense, at its full power limit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import frozen

# name as torch.cuda.get_device_name() gives it -> published peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int8_ops_per_s": 1.979e15},
}


def distinct_rows(batch_terms: list[np.ndarray], row_offset: np.ndarray,
                  widths: np.ndarray, n_hashes: int,
                  device: torch.device) -> int:
    """Arena rows a batch addresses, each counted once."""
    t = torch.from_numpy(np.concatenate(batch_terms).astype(np.int64)
                         ).to(device)
    off = torch.from_numpy(row_offset.astype(np.int64)).to(device)
    w = torch.from_numpy(widths.astype(np.int64)).to(device)
    rows = [(frozen.hash_torch(t[:, 0], t[:, 1], j)[:, None] % w + off)
            .reshape(-1) for j in range(n_hashes)]
    return int(torch.unique(torch.cat(rows)).numel())


def batch_work(n_terms: list[int], rows: int, n_blocks: int,
               n_hashes: int, doc_words: int, n_docs: int
               ) -> tuple[int, int]:
    """(bytes, operations) of one scoring dispatch that reads ``rows``
    distinct arena rows."""
    nbytes = (rows * doc_words * 4 + 8 * int(sum(n_terms))
              + 4 * n_docs * len(n_terms))
    cells = int(sum(n_terms)) * n_blocks * n_hashes
    return nbytes, cells * doc_words * 32


def bound_s(nbytes: int, ops: int, device_name: str) -> float | None:
    peaks = PEAKS.get(device_name)
    if peaks is None:
        return None
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["int8_ops_per_s"])
