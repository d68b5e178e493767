"""COBS index presets mirroring the paper's experimental parameters."""
from repro_torch.core import IndexParams


def paper_default() -> IndexParams:
    """Section 3: k-mer 31, one hash, FPR 0.3, canonicalization off (the
    pre-processed McCortex inputs are already canonical)."""
    return IndexParams(n_hashes=1, fpr=0.3, kmer=31, canonical=False)


def small_test() -> IndexParams:
    """CI-scale: shorter k-mers so smaller synthetic docs have enough
    distinct terms."""
    return IndexParams(n_hashes=1, fpr=0.3, kmer=15, canonical=False)


PAPER_BLOCK_DOCS = 1024   # B for the 100k-document compact index (section 3)
