"""Minimal FASTA reader and writer (the paper's document input format), a
copy of ``repro.data.fasta``.

Each FASTA record becomes one read; a multi-record file is one document
whose reads are k-merized independently, as in COBS' DNA input mode.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import dna


def read_fasta(path: str | Path) -> list[np.ndarray]:
    """The reads of one FASTA document as 2-bit code arrays."""
    reads: list[np.ndarray] = []
    cur: list[str] = []
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            if cur:
                reads.append(dna.encode_dna("".join(cur)))
                cur = []
        else:
            cur.append(line.strip())
    if cur:
        reads.append(dna.encode_dna("".join(cur)))
    return reads


def write_fasta(path: str | Path, reads: list[np.ndarray],
                name_prefix: str = "read") -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">{name_prefix}{i}\n{dna.decode_dna(r)}\n")
