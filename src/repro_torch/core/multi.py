"""Multi-index query frontend (paper section 4: 'our current COBS
implementation also already supports querying of multiple index files, such
that a frontend may select different datasets or categories').

Each sub-index keeps its own parameters and engine, a ``QueryEngine`` on
the frontend's device; results merge into one ranked list over a global
document namespace (dataset, local_id). Attaching or detaching a dataset
never touches the other indexes.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..device import resolve_device
from .index import BitSlicedIndex
from .query import QueryEngine


@dataclass
class MultiHit:
    dataset: str
    doc_id: int
    score: int
    n_terms: int


class MultiIndexEngine:
    """Datasets by name, each searched by a ``QueryEngine(index, method,
    device)``; ``device=None`` means the CUDA card."""

    def __init__(self, method: str = "vertical", device=None):
        self._engines: dict[str, QueryEngine] = {}
        self.method = method
        self.device = resolve_device(device)

    def attach(self, name: str, index: BitSlicedIndex) -> None:
        if name in self._engines:
            raise KeyError(f"dataset {name!r} already attached")
        self._engines[name] = QueryEngine(index, method=self.method,
                                          device=self.device)

    def detach(self, name: str) -> None:
        del self._engines[name]

    @property
    def datasets(self) -> tuple[str, ...]:
        return tuple(self._engines)

    def search(self, pattern, threshold: float = 0.8,
               datasets: tuple[str, ...] | None = None) -> list[MultiHit]:
        """Query the selected (default: all) datasets, merged and ranked by
        score over the query's term count, ties broken by (dataset,
        doc_id). k-mer lengths may differ per dataset (each engine packs
        its own terms)."""
        hits: list[MultiHit] = []
        for name in (datasets if datasets is not None else self.datasets):
            r = self._engines[name].search(pattern, threshold=threshold)
            hits.extend(MultiHit(name, int(d), int(s), r.n_terms)
                        for d, s in zip(r.doc_ids, r.scores))
        hits.sort(key=lambda h: (-h.score / max(h.n_terms, 1),
                                 h.dataset, h.doc_id))
        return hits
