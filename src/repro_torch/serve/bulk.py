"""Offline bulk-query lane: shard-major streaming scans.

The interactive lane is query-major — every micro-batch visits every
shard, so a Q-query workload split into Q/B micro-batches restages each
tile up to Q/B times through a bounded ``DeviceTileCache``. The bulk
lane inverts the loop for deadline-free jobs (decontamination scans,
eval-set sweeps): ``core.query.run_shard_major`` stages each shard tile
onto the device ONCE (raw or dict form, the next shard prefetched while the
current one scores), streams the ENTIRE query set against it in
query-chunks, and accumulates per-(query, block) running counts with
the same rarest-first ordering and threshold early-exit the pruned
executor uses. The headline number is arena bytes staged per query: one
staging amortized over Q queries instead of Q/B stagings.

Scheduling: a ``BulkLane`` attached to a ``ServingLoop`` runs jobs on
its own thread, one shard at a time and WITHOUT the loop's backend
lock — the shared ``DeviceTileCache`` is internally locked and staged
tiles are immutable, so interactive batches keep scoring concurrently
while a shard sweeps (they contend only for the device, not a lock).
Between shards the lane polls ``MicroBatcher.next_due_at()`` (plus the
loop's in-flight batch count) and stops claiming shards whenever
interactive work is due — the p99-protection contract. Every completed
shard is a checkpoint:
``(next_shard, slots, required)`` round-trips through ``BulkJob.
checkpoint()`` / ``submit(resume=...)``, so an interrupted sweep resumes
without rescoring finished shards.

Threshold jobs can instead reuse ``run_paged_pruned`` per shard
(``pruned=True``): the branch-and-bound executor host-gathers only the
touched rows, so highly selective scans (decontamination at high
coverage thresholds) may never stage a tile at all — yield points and
checkpoints work identically.

Without a loop the lane is synchronous: ``submit()`` queues and
``drain()`` executes inline — the property-test entry point.

This is ``repro.serve.bulk`` for the PyTorch port: the same scheduling,
job and checkpoint format (a checkpoint written by either package resumes
in the other), over the port's ``run_shard_major`` and
``run_paged_pruned``. The lane thread launches its kernels on the current
stream of the tile cache's device, the stream the loop's workers launch
on, so the card runs a sweep's kernels and interactive batches in the
order they were launched.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..core.query import (BulkStats, PruneStats, SearchResult,
                          compile_pattern, coverage_cutoff,
                          order_terms_rarest, pad_term_batch,
                          run_paged_pruned, run_shard_major, select_hits,
                          select_top_k)

# Dense shared padding for a bulk set: the sublane quantum, not the
# interactive lane's jit-bucket ``term_pad`` — one sweep compiles one
# shape anyway, so the only cost of padding is masked kernel work.
BULK_TERM_QUANTUM = 8


class BulkStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class BulkJob:
    """One bulk query set sweeping the store.

    ``slots`` / ``required`` / ``next_shard`` are the live sweep state
    (global slot scores accumulate shard by shard) and double as the
    checkpoint. Queries are sorted by term count before the sweep
    (``perm``) so slabs stay length-homogeneous and short-query slabs
    exit their chunk loop early; ``results`` is mapped back to
    submission order at finalize."""

    job_id: int
    terms: np.ndarray               # uint32 [Q, L, 2], sorted by length
    n_valid: np.ndarray             # int32 [Q], sorted
    perm: np.ndarray                # int64 [Q]: sorted pos -> orig index
    threshold: float
    top_k: int
    pruned: bool = False            # per-shard run_paged_pruned instead
    tag: str = ""
    status: BulkStatus = BulkStatus.QUEUED
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    shards_total: int = 0
    next_shard: int = 0
    slots: Optional[np.ndarray] = None      # int32 [Q, n_slots]
    required: Optional[np.ndarray] = None   # int64 [Q], tightens (top-k)
    topk: Optional[np.ndarray] = None       # int32 [Q]
    order: Optional[np.ndarray] = None      # rarest-first term order
    stats: BulkStats = dataclasses.field(default_factory=BulkStats)
    prune: PruneStats = dataclasses.field(default_factory=PruneStats)
    results: Optional[list] = None          # SearchResult per query
    error: str = ""
    checkpoint_path: Optional[str] = None
    on_done: Optional[Callable] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    trace: Optional[object] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def n_queries(self) -> int:
        return int(self.terms.shape[0])

    @property
    def shards_done(self) -> int:
        return int(self.next_shard)

    @property
    def progress(self) -> float:
        if not self.shards_total:
            return 0.0
        return self.next_shard / self.shards_total

    @property
    def staged_bytes(self) -> int:
        return self.stats.bytes_staged

    @property
    def staged_bytes_per_query(self) -> float:
        q = self.n_queries
        return self.stats.bytes_staged / q if q else 0.0

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def checkpoint(self) -> dict:
        """Resumable sweep state after the last completed shard."""
        return {
            "next_shard": int(self.next_shard),
            "slots": None if self.slots is None else self.slots.copy(),
            "required": (None if self.required is None
                         else self.required.copy()),
        }

    def save(self, path) -> None:
        np.savez_compressed(
            path, next_shard=np.int64(self.next_shard),
            slots=self.slots if self.slots is not None
            else np.zeros((0, 0), np.int32),
            required=self.required if self.required is not None
            else np.zeros(0, np.int64))

    @staticmethod
    def load(path) -> dict:
        with np.load(path) as z:
            return {"next_shard": int(z["next_shard"]),
                    "slots": z["slots"], "required": z["required"]}


class BulkLane:
    """Scheduler for shard-major bulk sweeps over a serving backend.

    ``backend`` is a ``QueryServer`` or multi-host ``Frontend`` (the
    sweep walks each shard's primary worker's tile cache); ``loop`` an
    optional ``ServingLoop`` — with one, ``start()`` spawns the bulk
    thread: sweeps run concurrently with interactive scoring (the tile
    cache is internally locked) and the lane yields between shards when
    interactive work is due. Without one the lane is synchronous:
    ``drain()`` runs queued jobs inline."""

    def __init__(self, backend, loop=None, *, chunk_terms: int = 32,
                 query_chunk: Optional[int] = None,
                 word_block: Optional[int] = None,
                 yield_poll_s: float = 0.002,
                 headroom_s: float = 0.0):
        self.backend = backend
        self.loop = loop
        self.chunk_terms = int(chunk_terms)
        self.query_chunk = query_chunk
        self.word_block = (word_block if word_block is not None else
                           getattr(getattr(backend, "config", None),
                                   "word_block", None))
        self.yield_poll_s = float(yield_poll_s)
        self.headroom_s = float(headroom_s)
        self.clock = getattr(backend, "clock", time.monotonic)
        self._queue: deque = deque()
        self._jobs: dict[int, BulkJob] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        if loop is not None:
            loop.bulk_lane = self

    # -- backend topology ---------------------------------------------------
    def _params(self):
        be = self.backend
        if hasattr(be, "workers"):
            return next(iter(be.workers.values())).params
        return be.index.params

    def _layout(self):
        be = self.backend
        if hasattr(be, "workers"):
            return next(iter(be.workers.values())).layout
        return be.index.layout

    def _targets(self) -> tuple[list, list]:
        """(caches, plans) in global shard order — the sweep schedule.

        Multi-host: each shard is swept on its primary worker's tiles
        (first live replica when the primary is down); block ranges are
        global, so every worker's slots land at global columns."""
        be = self.backend
        if not hasattr(be, "workers"):
            plans = be.planner.shard_plans
            return [be.tiles] * len(plans), list(plans)
        caches, plans = [], []
        n_shards = be.placement.n_shards
        for g in range(n_shards):
            w = None
            for node in [be.placement.owner(g)] + be.placement.replicas(g):
                cand = be.workers.get(node)
                if cand is not None and cand.holds(g) and not cand.failed:
                    w = cand
                    break
            if w is None:
                raise RuntimeError(f"shard {g} has no live replica")
            caches.append(w.tiles)
            plans.append(w.plans[w._local[g]])
        return caches, plans

    # -- submission ---------------------------------------------------------
    def submit(self, patterns=None, *, term_sets=None,
               threshold: Optional[float] = None, top_k: int = 0,
               pruned: bool = False, tag: str = "",
               resume: Optional[dict] = None,
               checkpoint_path=None,
               on_done: Optional[Callable] = None) -> BulkJob:
        """Queue a bulk job. ``patterns`` (DNA strings / code arrays) or
        pre-compiled ``term_sets``; threshold XOR top_k per job. With a
        running lane thread the job starts when the queue reaches it;
        otherwise call ``drain()``. ``resume`` is a ``checkpoint()``
        dict (or ``BulkJob.load(path)``) from a prior partial sweep."""
        params = self._params()
        if term_sets is None:
            term_sets = [compile_pattern(p, params) for p in patterns]
        if threshold is None:
            threshold = float(getattr(getattr(self.backend, "config", None),
                                      "default_threshold", 0.5))
        buf, ells = pad_term_batch(term_sets, BULK_TERM_QUANTUM)
        ells = np.asarray(ells, dtype=np.int32)
        # Length-sorted sweep order: slabs stay dense (short-query slabs
        # break out of the term-chunk loop early) — adaptive batching's
        # histogram idea applied to the bulk set.
        perm = np.argsort(ells, kind="stable")
        buf, ells = buf[perm], ells[perm]
        Q = int(buf.shape[0])
        if top_k > 0:
            required = np.zeros(Q, dtype=np.int64)
            topk = np.full(Q, int(top_k), dtype=np.int32)
        else:
            required = np.array(
                [coverage_cutoff(threshold, int(e)) for e in ells],
                dtype=np.int64)
            topk = np.zeros(Q, dtype=np.int32)
        if pruned and top_k > 0:
            raise ValueError("pruned bulk mode serves threshold scans; "
                             "top-k jobs use the shard-major executor")
        with self._lock:
            job = BulkJob(job_id=self._next_id, terms=buf, n_valid=ells,
                          perm=perm, threshold=float(threshold),
                          top_k=int(top_k), pruned=bool(pruned), tag=tag,
                          required=required, topk=topk,
                          checkpoint_path=checkpoint_path,
                          on_done=on_done, submitted_at=self.clock())
            self._next_id += 1
            if resume is not None:
                job.next_shard = int(resume["next_shard"])
                if resume.get("slots") is not None and \
                        np.asarray(resume["slots"]).size:
                    job.slots = np.array(resume["slots"], dtype=np.int32)
                if resume.get("required") is not None and \
                        np.asarray(resume["required"]).size:
                    job.required = np.array(resume["required"],
                                            dtype=np.int64)
            self._jobs[job.job_id] = job
            self._queue.append(job)
        self._wake.set()
        return job

    def get(self, job_id: int) -> Optional[BulkJob]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[BulkJob]:
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, job_id: int) -> bool:
        """Cancel a queued job (running jobs finish their sweep)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.status is not BulkStatus.QUEUED:
                return False
            job.status = BulkStatus.CANCELLED
            try:
                self._queue.remove(job)
            except ValueError:
                pass
        self._metrics().record_bulk_job("cancelled", queries=job.n_queries)
        job.done.set()
        return True

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "BulkLane":
        if self._thread is None:
            self._stopped = False
            self._thread = threading.Thread(target=self._run,
                                            name="bulk-lane", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        """Halt the lane thread. A mid-sweep job stays checkpointed at
        its last completed shard and returns to the queue head."""
        self._stopped = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
            self._thread = None

    def drain(self) -> None:
        """Run every queued job to completion inline (synchronous mode —
        also valid with a loop stopped or not yet started)."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                job = self._queue.popleft()
            if job.status is BulkStatus.QUEUED:
                self._execute(job, preemptible=False)

    # -- scheduling ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped:
            with self._lock:
                job = self._queue.popleft() if self._queue else None
            if job is None:
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            if job.status is not BulkStatus.QUEUED:
                continue
            self._execute(job, preemptible=True)
            if self._stopped and job.status is BulkStatus.RUNNING:
                # checkpointed mid-sweep: back to the queue for a restart
                job.status = BulkStatus.QUEUED
                with self._lock:
                    self._queue.appendleft(job)

    def _interactive_clear(self) -> bool:
        loop = self.loop
        if loop is None:
            return True
        if loop._inflight > 0 or not loop._batchq.empty():
            return False
        due = self.backend.batcher.next_due_at()
        return due is None or (due - self.clock()) > self.headroom_s

    def _metrics(self):
        return self.backend.metrics

    # -- execution ----------------------------------------------------------
    def _execute(self, job: BulkJob, *, preemptible: bool) -> None:
        try:
            caches, plans = self._targets()
            job.shards_total = len(plans)
            job.status = BulkStatus.RUNNING
            job.started_at = self.clock()
            tracer = getattr(self.backend, "tracer", None)
            if tracer is not None and job.trace is None:
                job.trace = tracer.begin(job.job_id)
            if job.order is None and plans:
                own = [sp for ca, sp in zip(caches, plans)
                       if ca is caches[0]]
                job.order = order_terms_rarest(
                    caches[0].storage, own, job.terms, job.n_valid,
                    n_hashes=self._params().n_hashes)
            yielded = False
            while job.next_shard < job.shards_total:
                if self._stopped and preemptible:
                    return                      # checkpointed; requeued
                if preemptible and not self._interactive_clear():
                    if not yielded:
                        yielded = True
                        self._metrics().record_bulk_yield()
                    time.sleep(self.yield_poll_s)
                    continue
                yielded = False
                self._step(job, caches, plans)
            self._finalize(job)
        except Exception as e:               # pragma: no cover - defensive
            job.status = BulkStatus.FAILED
            job.error = f"{type(e).__name__}: {e}"
            job.finished_at = self.clock()
            self._metrics().record_bulk_job("failed",
                                            queries=job.n_queries)
            tracer = getattr(self.backend, "tracer", None)
            if tracer is not None:
                tracer.finish(job.trace)
            job.done.set()
            if job.on_done is not None:
                job.on_done(job)

    def _step(self, job: BulkJob, caches: list, plans: list) -> None:
        """Sweep exactly one shard — the yield granularity. The step runs
        WITHOUT the loop's backend lock: the ``DeviceTileCache`` is
        internally locked and staged tiles are immutable device arrays,
        so interactive batches score concurrently instead of queueing
        behind a whole shard sweep; the lane merely stops claiming new
        shards while interactive work is due."""
        t0 = time.perf_counter()
        staged0 = job.stats.bytes_staged
        si = job.next_shard
        if job.pruned:
            self._step_pruned(job, caches[si], plans[si])
            job.next_shard = si + 1
        else:
            job.slots, job.next_shard, job.required = run_shard_major(
                caches, plans, job.terms, job.n_valid, job.required,
                job.topk, n_hashes=self._params().n_hashes,
                chunk_terms=self.chunk_terms,
                query_chunk=self.query_chunk,
                word_block=self.word_block, order=job.order,
                stats=job.stats, start_shard=si, out=job.slots,
                should_yield=lambda: True)
        dt = time.perf_counter() - t0
        staged = job.stats.bytes_staged - staged0
        self._metrics().record_bulk_shard(staged_bytes=staged, seconds=dt)
        if job.trace is not None:
            now = self.clock()
            job.trace.add("bulk_shard", now - dt, now,
                          tags={"shard": si, "staged_bytes": staged,
                                "job": job.job_id})
        if job.checkpoint_path:
            job.save(job.checkpoint_path)

    def _step_pruned(self, job: BulkJob, cache, sp) -> None:
        """Satellite reuse: one shard of a threshold scan through the
        branch-and-bound executor — host row gathers instead of a tile
        staging wherever the bound holds, device-promoted past the
        gather break-even. Bit-identical by ``run_paged_pruned``'s own
        contract."""
        W = int(cache.storage.shape[1])
        if job.slots is None:
            _, plans = self._targets()
            ncols = max(p.block_end for p in plans) * W * 32
            job.slots = np.zeros((job.n_queries, ncols), dtype=np.int32)
        b0 = cache.raw_bytes_staged + cache.comp_bytes_staged
        ps = PruneStats()
        scores = run_paged_pruned(
            cache, [sp], job.terms, job.n_valid, job.required, job.topk,
            n_hashes=self._params().n_hashes, chunk_terms=self.chunk_terms,
            word_block=self.word_block, order=job.order, stats=ps)
        moved = (cache.raw_bytes_staged + cache.comp_bytes_staged) - b0
        if moved:
            job.stats.tiles_staged += 1
            job.stats.bytes_staged += moved
        job.stats.shards_swept += 1
        job.stats.kernel_dispatches += ps.kernel_dispatches
        job.stats.blocks_total += ps.blocks_total
        job.stats.blocks_pruned += ps.blocks_pruned
        job.prune.merge(ps)
        m = self._metrics()
        if hasattr(m, "record_prune"):
            m.record_prune(blocks_total=ps.blocks_total,
                           blocks_pruned=ps.blocks_pruned,
                           tiles_skipped=ps.shard_visits_skipped,
                           bytes_saved=cache.storage.shard_nbytes(sp.shard)
                           - ps.bytes_read)
        col0 = sp.block_start * W * 32
        job.slots[:, col0:col0 + scores.shape[1]] = scores

    def _finalize(self, job: BulkJob) -> None:
        layout = self._layout()
        host_slot = np.asarray(layout.doc_slot)
        inv = np.empty_like(job.perm)
        inv[job.perm] = np.arange(job.perm.shape[0])
        results: list[SearchResult] = []
        for i in range(job.n_queries):
            p = int(inv[i])                  # sorted position of query i
            sc = job.slots[p][host_slot] if job.slots is not None else \
                np.zeros(layout.n_docs, dtype=np.int32)
            ell = int(job.n_valid[p])
            if job.top_k > 0:
                results.append(select_top_k(sc, ell, job.top_k))
            else:
                results.append(select_hits(sc, ell, job.threshold))
        job.results = results
        job.status = BulkStatus.DONE
        job.finished_at = self.clock()
        self._metrics().record_bulk_job("done", queries=job.n_queries)
        tracer = getattr(self.backend, "tracer", None)
        if tracer is not None:
            tracer.finish(job.trace)
        job.done.set()
        if job.on_done is not None:
            job.on_done(job)
