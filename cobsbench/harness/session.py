"""What the entries share: the set-up of a cell, the measured window (and
its trace), the program's counters, and the record a run leaves for the
metric readers and the check."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from . import build as _build
from . import corpus as _corpus
from . import devtrace, roofline
from .reference import Answer
from .traffic import Queries


@dataclasses.dataclass
class Context:
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                 # time.monotonic() at process start
    log: Callable[[str], None]
    setup_s: float | None = None
    _corpus: _corpus.Corpus | None = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def threshold(self) -> float:
        return float(self.mix["threshold"])

    def corpus(self) -> _corpus.Corpus:
        if self._corpus is None:
            self._corpus = _corpus.make_corpus(
                self.cfg["corpus"], int(self.cfg["index"]["kmer"]), self.seed)
        return self._corpus

    def build_index(self):
        t = time.monotonic()
        index = _build.build_dense(self.cfg, self.corpus(), self.device)
        if self.on_card:
            torch.cuda.synchronize()
        self.log(f"index: {index.n_docs} documents, {index.n_blocks} blocks, "
                 f"{index.total_rows} rows, {index.size_bytes()} bytes, "
                 f"built in "
                 f"{time.monotonic() - t:.1f} s")
        return index

    def server(self, index):
        from repro_torch.serve import QueryServer, ServerConfig
        return QueryServer(index, ServerConfig(**self.cfg.get("server", {})),
                           device=self.device)

    def setup_done(self) -> None:
        self.setup_s = time.monotonic() - self.t_process


@dataclasses.dataclass
class Run:
    """What a window leaves for the metric readers and the check."""
    window_s: float
    queries: Queries                  # the window's pool
    n_requests: int                   # requests sent in the window
    answers: dict                     # request index -> Answer (status OK)
    e2e: dict                         # end-to-end metric -> value
    counters: dict                    # the program's counters, window only
    on_card: bool
    device_name: str
    trace: devtrace.Trace | None = None
    roofline: dict | None = None      # {"bound_s": ..., "batches": ...}
    info: dict = dataclasses.field(default_factory=dict)


def answer_of(result) -> Answer:
    return Answer(np.asarray(result.doc_ids, dtype=np.int64),
                  np.asarray(result.scores, dtype=np.int64),
                  int(result.n_terms), int(result.threshold))


class Recorder:
    """Around a ``QueryServer`` in a traced run: a host span for each call
    into its scoring and submission, and the terms of every batch it
    scores while the window is open (for the scoring work's bound)."""

    def __init__(self, server, enabled: bool):
        self.active = False
        self.batches: list[list[np.ndarray]] = []
        if not enabled:
            return
        from torch.profiler import record_function
        score, submit = server.score_batch, server.submit

        def score_batch(batch):
            with record_function("cobsbench.score_batch"):
                if self.active:
                    self.batches.append([r.terms for r in batch.requests])
                return score(batch)

        def submit_(*a, **kw):
            with record_function("cobsbench.submit"):
                return submit(*a, **kw)

        server.score_batch = score_batch
        server.submit = submit_


class Window:
    """The measured window: a profiler over it in a traced run, with the
    benchmark's window span inside."""

    def __init__(self, ctx: Context, recorder: Recorder):
        self.ctx = ctx
        self.recorder = recorder
        self.trace: devtrace.Trace | None = None

    @contextlib.contextmanager
    def open(self):
        if not self.ctx.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.ctx.on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW_SPAN):
                self.recorder.active = True
                try:
                    yield
                finally:
                    self.recorder.active = False
        self.trace = devtrace.from_profiler(prof)


def program_counters(server) -> dict:
    """The program's own counters over the window (the server's metrics
    were reset when the window opened)."""
    m = server.metrics
    moved = m.registry.get("kernel_bytes_moved_total")
    wait = m.registry.get("serve_wait_seconds")
    return {
        "batches": m.n_batches,
        "batched_requests": m.batched_requests,
        "served": m.served,
        "wait_p50_s": (wait.percentile(50) if wait is not None and len(wait)
                       else None),
        "bytes_moved": (sum(c.value for _, c in moved.children())
                        if moved is not None else 0),
        "row_bytes": int(server.index.storage.shape[1]) * 4,
        "methods": dict(m.method_counts),
    }


def roofline_of(batches: list, index, device: torch.device,
                device_name: str) -> dict | None:
    """The summed bound of the scoring work of ``batches``."""
    lay = index.layout
    n_hashes = index.params.n_hashes
    total = 0.0
    for terms in batches:
        rows = roofline.distinct_rows(terms, lay.row_offset, lay.block_width,
                                      n_hashes, device)
        nbytes, ops = roofline.batch_work(
            [t.shape[0] for t in terms], rows, lay.n_blocks, n_hashes,
            lay.doc_words, lay.n_docs)
        b = roofline.bound_s(nbytes, ops, device_name)
        if b is None:
            return None
        total += b
    return {"bound_s": total, "batches": len(batches)}


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
