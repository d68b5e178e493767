"""Index-serving launcher of the port: drive the repro_torch.serve
query-serving subsystem (micro-batcher + planner + caches) under generated
load and report latency/throughput. Every flag, default, report line and
exit path is the JAX package's (``repro.launch.serve``), plus ``--device``:
the CUDA card by default, ``--device cpu`` to run on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 256 \\
        --queries 200
    PYTHONPATH=src python -m repro_torch.launch.serve --mode open --qps 500
    PYTHONPATH=src python -m repro_torch.launch.serve --store-format v2 \\
        --index-dir /tmp/store --hosts 3 --replication 2 --fail-host host1
    PYTHONPATH=src python -m repro_torch.launch.serve --store-format v2 \\
        --index-dir /tmp/store --autotune      # tune-then-serve; measured
                                               # configs persist in
                                               # /tmp/store/tuning-torch.json
    PYTHONPATH=src python -m repro_torch.launch.serve --listen 7070
                                               # network mode: TCP wire
                                               # protocol, active loop
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --n-docs 48 --queries 16               # on the CPU (plain kernels)

``--listen PORT`` swaps load generation for real serving: the chosen
backend (QueryServer, or the sharded Frontend with --hosts) is wrapped
in a ServingLoop (dispatcher + scoring workers) behind the binary wire
protocol — concurrent clients coalesce into shared micro-batches, queue
overflow answers 429-style REJECTED, Ctrl-C drains and exits. Query it
with ``repro_torch.serve.NetClient`` (or the JAX package's: the wire is
the same) or ``benchmarks/serving.py --listen``.
A ``BulkLane`` is attached to the loop, so clients can submit whole
query sets over the wire (``NetClient.bulk`` / the BULK frame); they
sweep shard-major in interactive idle time.

``--bulk FILE`` submits the patterns in FILE (one per line) through the
offline bulk lane: in --listen mode the job runs alongside network
traffic, otherwise it runs inline after the load-generation report —
either way the summary prints arena bytes staged per query, the bulk
lane's headline number. ``--bulk-checkpoint PATH`` makes every finished
shard resumable across runs.

Two load models:

* ``closed`` — a fixed window of in-flight queries: submit ``--concurrency``
  at a time, drain, repeat. Measures the system's capacity (best-case
  batching).
* ``open``   — Poisson arrivals at ``--qps`` on the wall clock: submit at
  each arrival instant, ``step`` the server in between so flush timers
  fire. Measures latency under a fixed offered load, queueing included.

``--hosts N`` switches from the single-host QueryServer to the sharded
data plane: the v2 store's manifest rows are HRW-placed over N in-process
fake hosts (``--replication`` replicas each), every host opens a sub-store
of only its shards (a ShardWorker), and a Frontend scatters micro-batches
with hedged dispatch (``--hedge-after-ms``) and gathers the final top-k.
``--fail-host`` marks hosts down before the measured run to demo replica
failover.

Real multi-PROCESS serving splits those fake hosts into process roles over
the v4 wire protocol (``repro_torch.launch.cluster.WorkerCluster`` starts
the workers):

* ``--worker NAME`` — run this process as ONE ShardWorker behind its own
  WorkerServer. The logical node list (``--worker-nodes n0,n1,n2``) plus
  the store manifest determine the HRW placement deterministically, so
  every process computes the same shard->node map without coordination;
  ``--worker-port`` picks the bind port (0 = OS-assigned) and
  ``--port-file PATH`` atomically publishes "host port" once bound —
  the launcher/tests discover OS-assigned ports from it.
  ``--straggle-ms`` injects a per-dispatch straggler tail (cancellation-
  aware) for hedging demos/benches.
* ``--workers n0=host:port,n1=@portfile,...`` — run this process as the
  frontend: dial every worker through the reconnecting channel pool
  (``repro_torch.serve.rpc.WorkerPool``) and scatter every shard dispatch
  as a real RPC with wall-clock hedging and CANCEL-on-win. Combine with
  ``--listen`` for the TCP front door, or without it to drive the
  generated load through the RPC plane.

    # terminal 1..3: three workers on localhost (OS-assigned ports)
    python -m repro_torch.launch.serve --store-format v2 \\
        --index-dir /tmp/store --worker host0 \\
        --worker-nodes host0,host1,host2 \\
        --port-file /tmp/w0.port          # likewise host1, host2
    # terminal 4: the frontend, dialing the port files
    python -m repro_torch.launch.serve --store-format v2 \\
        --index-dir /tmp/store \\
        --workers host0=@/tmp/w0.port,host1=@/tmp/w1.port,host2=@/tmp/w2.port \\
        --listen 7070

Results are validated against the ground-truth origin labels of the
synthetic query set, and the report includes the planner's kernel mix and
cache hit rate alongside p50/p99 (plus per-worker latency, hedge-fire
rate, and failover counts in multi-host mode).

Workers of one fleet, the frontend and a single-host server all run on
``--device``; workers started as processes on one card each open a CUDA
context of their own.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..core import IndexParams, build_compact, load_index, save_index
from ..data import make_corpus, make_queries
from ..device import resolve_device
from ..serve import (Frontend, FrontendConfig, QueryServer, ServerConfig,
                     ShardWorker, Status)


def build_or_load(args):
    corpus = make_corpus(args.n_docs, k=15, mean_length=2000, sigma=1.0,
                         seed=0)
    params = IndexParams(n_hashes=1, fpr=0.3, kmer=15)
    index = None
    if args.index_dir:
        try:
            index = load_index(args.index_dir, device=args.device)
            print(f"loaded index from {args.index_dir} "
                  f"({index.storage.n_shards} shard(s))")
        except FileNotFoundError:
            pass
    if index is None:
        t0 = time.time()
        if args.store_format == "v2" and args.index_dir:
            # out-of-core path: stream shards to disk, serve via mmap
            from ..index import build_compact_streaming
            index, stats = build_compact_streaming(
                corpus.doc_terms, args.index_dir, params, block_docs=64,
                device=args.device)
            print(f"streamed v2 store: {index.n_docs} docs, "
                  f"{stats.n_shards} shards, peak build host "
                  f"{stats.peak_block_bytes / 2**20:.2f} MiB "
                  f"in {time.time()-t0:.1f}s")
        else:
            # (store_format is necessarily v1 here: v2 + index_dir took the
            # streaming branch, and v2 without index_dir errors at parse)
            index = build_compact(corpus.doc_terms, params, block_docs=64,
                                  device=args.device)
            print(f"built compact index: {index.n_docs} docs, "
                  f"{index.size_bytes() / 2**20:.1f} MiB "
                  f"in {time.time()-t0:.1f}s")
            if args.index_dir:
                save_index(index, args.index_dir)
    return corpus, index


def make_workload(corpus, n_queries: int, seed: int = 100):
    """Mixed-length query stream of EXACTLY n_queries (short queries
    exercise the planner's unpack path, long ones the fused/vertical
    paths)."""
    queries, origin = [], []
    lengths = (40, 80, 160, 320)
    for i, length in enumerate(lengths):
        count = n_queries // len(lengths) + (i < n_queries % len(lengths))
        if count == 0:
            continue
        q, o = make_queries(corpus, n_pos=count - count // 2,
                            n_neg=count // 2, length=length,
                            seed=seed + i)
        queries.extend(q)
        origin.extend(o)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(queries))
    return [queries[i] for i in perm], [origin[i] for i in perm]


def run_closed(server: QueryServer, queries, threshold: float,
               concurrency: int) -> list[int]:
    ids = []
    for i in range(0, len(queries), concurrency):
        for q in queries[i: i + concurrency]:
            ids.append(server.submit(q, threshold=threshold))
        server.drain()
    return ids


def run_open(server: QueryServer, queries, threshold: float, qps: float
             ) -> list[int]:
    rng = np.random.default_rng(0)
    gaps = rng.exponential(1.0 / qps, size=len(queries))
    arrival = server.clock() + np.cumsum(gaps)
    ids = []
    for q, t_arr in zip(queries, arrival):
        while server.clock() < t_arr:
            server.step()                     # let flush timers fire
            remaining = t_arr - server.clock()
            if remaining > 0:
                time.sleep(min(remaining, 1e-4))
        ids.append(server.submit(q, threshold=threshold))
        server.step()
    server.drain()
    return ids


def make_multihost_frontend(store_dir, *, hosts: int, replication: int,
                            max_batch: int, max_wait_s: float,
                            hedge_after_s: float, hedge_auto: bool = False,
                            tile_cache_bytes=None, word_block=None,
                            scatter_threads: int = 4,
                            fail_hosts=(), latency_models=None,
                            tracing: bool = True,
                            trace_slow_ms: float = 0.0,
                            trace_log=None, pruned: bool = False,
                            prune_chunk: int = 32,
                            prune_min_rate=None,
                            adaptive_buckets: bool = False,
                            device=None) -> Frontend:
    """Sharded data plane over in-process fake hosts: HRW-place the v2
    manifest rows, open each host's sub-store, wire the hedging frontend
    (per-shard dispatches overlap through ``scatter_threads`` in
    wall-clock mode), and optionally mark hosts down (their shards fail
    over to replicas). Every worker runs on ``device`` (None = the CUDA
    card)."""
    from ..index import ShardPlacement

    nodes = [f"host{i}" for i in range(hosts)]
    placement = ShardPlacement.for_store(store_dir, nodes,
                                         replication=min(replication, hosts))
    held = placement.replica_assignment()
    workers = {n: ShardWorker(n, store_dir, held[n],
                              tile_cache_bytes=tile_cache_bytes,
                              word_block=word_block, pruned=pruned,
                              prune_chunk=prune_chunk,
                              prune_min_rate=prune_min_rate,
                              device=device)
               for n in nodes if held[n]}
    frontend = Frontend(workers, placement, FrontendConfig(
        max_batch=max_batch, max_wait_s=max_wait_s,
        hedge_after_s=hedge_after_s, hedge_auto=hedge_auto,
        scatter_threads=scatter_threads, tracing=tracing,
        trace_slow_ms=trace_slow_ms, trace_log=trace_log,
        pruned=pruned, prune_chunk=prune_chunk,
        adaptive_buckets=adaptive_buckets),
        latency_models=latency_models)
    for n in fail_hosts:
        frontend.fail_worker(n)
    if not placement.is_covered():
        raise SystemExit("placement lost coverage: too many failed hosts "
                         "for the replication factor")
    return frontend


def run_worker(args) -> None:
    """Process role: serve ONE placement node's shard replicas over the
    v4 wire protocol until interrupted (see module docstring). The node
    list + store manifest pin the HRW placement, so this process opens
    exactly the shards the frontend will route to it — no coordination
    beyond agreeing on ``--worker-nodes`` and ``--replication``."""
    from ..index import ShardPlacement
    from ..serve.net import PROTO_VERSION
    from ..serve.rpc import WorkerServer

    if not os.path.exists(os.path.join(args.index_dir, "manifest.json")):
        raise SystemExit(
            f"--worker needs an existing v2 store at {args.index_dir}; "
            "build it first (any non-worker run with --store-format v2 "
            "--index-dir builds one)")
    nodes = (args.worker_nodes.split(",") if args.worker_nodes
             else [f"host{i}" for i in range(args.hosts)])
    if args.worker not in nodes:
        raise SystemExit(f"--worker {args.worker} is not in the node list "
                         f"{nodes} (pass --worker-nodes, identically on "
                         "every process)")
    placement = ShardPlacement.for_store(
        args.index_dir, nodes, replication=min(args.replication, len(nodes)))
    held = placement.replica_assignment()[args.worker]
    if not held:
        raise SystemExit(f"node {args.worker} holds no shards under this "
                         f"placement ({len(nodes)} nodes x "
                         f"{placement.n_shards} shards); nothing to serve")
    tile_bytes = (None if args.tile_cache_mib is None
                  else int(args.tile_cache_mib * 2**20))
    worker = ShardWorker(args.worker, args.index_dir, held,
                         tile_cache_bytes=tile_bytes,
                         word_block=args.word_block, pruned=args.prune,
                         prune_chunk=args.prune_chunk,
                         prune_min_rate=args.prune_min_rate,
                         device=args.device)
    srv = WorkerServer(worker, host=args.listen_host,
                       port=args.worker_port,
                       straggle_s=args.straggle_ms / 1e3).start()
    host, port = srv.address
    if args.port_file:
        # atomic publish so a waiter never reads a torn file
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host} {port}\n")
        os.replace(tmp, args.port_file)
    print(f"worker {args.worker}: {len(held)} shard(s) {sorted(held)} "
          f"on {host}:{port} (wire v{PROTO_VERSION})", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    srv.close()


def _read_port_file(path: str, timeout_s: float) -> tuple[str, int]:
    """Wait for a worker's --port-file and return (host, port)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                parts = f.read().split()
            if len(parts) == 2:
                return parts[0], int(parts[1])
        except (FileNotFoundError, ValueError):
            pass
        time.sleep(0.05)
    raise SystemExit(f"timed out after {timeout_s:.0f}s waiting for "
                     f"worker port file {path}")


def parse_worker_spec(spec: str, timeout_s: float = 30.0
                      ) -> dict[str, tuple[str, int]]:
    """--workers value -> {node: (host, port)}. Entries are comma-
    separated ``node=host:port``, or ``node=@portfile`` to read (and wait
    for) the --port-file a worker process publishes."""
    out: dict[str, tuple[str, int]] = {}
    for part in spec.split(","):
        name, eq, addr = part.strip().partition("=")
        if not (eq and name and addr):
            raise SystemExit(f"--workers entry {part!r}: expected "
                             "node=host:port or node=@portfile")
        if addr.startswith("@"):
            out[name] = _read_port_file(addr[1:], timeout_s)
        else:
            host, _, port = addr.rpartition(":")
            try:
                out[name] = (host or "127.0.0.1", int(port))
            except ValueError:
                raise SystemExit(
                    f"--workers entry {part!r}: bad port") from None
    return out


def make_rpc_frontend(store_dir, worker_addrs, *, replication: int,
                      max_batch: int, max_wait_s: float,
                      hedge_after_s: float, hedge_auto: bool = False,
                      scatter_threads: int = 4, tracing: bool = True,
                      trace_slow_ms: float = 0.0, trace_log=None,
                      pruned: bool = False, prune_chunk: int = 32,
                      adaptive_buckets: bool = False,
                      connect_timeout_s: float = 15.0):
    """Networked data plane: dial every worker process through the
    reconnecting channel pool and scatter per-shard dispatches as real
    RPCs — wall-clock hedged backups, CANCEL-on-win, replica failover."""
    from ..index import ShardPlacement
    from ..serve.rpc import RpcFrontend, WorkerPool

    nodes = list(worker_addrs)
    placement = ShardPlacement.for_store(
        store_dir, nodes, replication=min(replication, len(nodes)))
    pool = WorkerPool(worker_addrs)
    try:
        pool.wait_connected(timeout_s=connect_timeout_s)
    except TimeoutError as e:
        pool.close()
        raise SystemExit(str(e)) from None
    frontend = RpcFrontend(pool, placement, FrontendConfig(
        max_batch=max_batch, max_wait_s=max_wait_s,
        hedge_after_s=hedge_after_s, hedge_auto=hedge_auto,
        scatter_threads=scatter_threads, tracing=tracing,
        trace_slow_ms=trace_slow_ms, trace_log=trace_log,
        pruned=pruned, prune_chunk=prune_chunk,
        adaptive_buckets=adaptive_buckets))
    gaps = frontend.verify_placement()
    if gaps:
        print(f"warning: workers missing placement shards: {gaps} "
              "(check --worker-nodes / --replication match on every "
              "process)")
    return frontend


def load_bulk_patterns(path) -> list:
    """One query pattern per line; blank lines and # comments skipped."""
    patterns = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                patterns.append(line)
    if not patterns:
        raise SystemExit(f"--bulk {path}: no patterns")
    return patterns


def submit_bulk_file(lane, args, on_done=None):
    """Queue the --bulk FILE job (resuming from --bulk-checkpoint when
    the file already exists)."""
    resume = None
    if args.bulk_checkpoint and os.path.exists(args.bulk_checkpoint):
        from ..serve import BulkJob
        resume = BulkJob.load(args.bulk_checkpoint)
        print(f"resuming bulk sweep at shard {resume['next_shard']} "
              f"from {args.bulk_checkpoint}")
    threshold = (args.bulk_threshold if args.bulk_threshold is not None
                 else args.threshold)
    return lane.submit(load_bulk_patterns(args.bulk),
                       threshold=None if args.bulk_topk else threshold,
                       top_k=args.bulk_topk,
                       pruned=args.prune and not args.bulk_topk,
                       tag=os.path.basename(args.bulk), resume=resume,
                       checkpoint_path=args.bulk_checkpoint,
                       on_done=on_done)


def report_bulk(job) -> None:
    st = job.stats
    line = (f"bulk[{job.tag}] {job.status.value}: {job.n_queries} queries"
            f" x {st.shards_swept} shard sweeps in "
            f"{job.finished_at - job.started_at:.2f}s; staged "
            f"{st.bytes_staged / 2**20:.2f} MiB total = "
            f"{job.staged_bytes_per_query:.0f} B/query "
            f"({st.kernel_dispatches} dispatches)")
    if st.blocks_total:
        line += f"; prune rate {st.prune_rate:.0%}"
    if job.error:
        line += f"; error: {job.error}"
    print(line)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--queries", type=int, default=160)
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--mode", default="closed", choices=["closed", "open"])
    ap.add_argument("--concurrency", type=int, default=32,
                    help="closed-loop in-flight window")
    ap.add_argument("--qps", type=float, default=200.0,
                    help="open-loop offered load")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--index-dir", default=None,
                    help="load/save the index here")
    ap.add_argument("--store-format", default="v1", choices=["v1", "v2"],
                    help="on-disk format when building with --index-dir: "
                         "v2 streams shards and serves out-of-core (mmap)")
    ap.add_argument("--tile-cache-mib", type=float, default=None,
                    help="HBM budget for shard tiles when serving a "
                         "sharded (v2) index; default unbounded (per host "
                         "in multi-host mode)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="> 1 serves the v2 store through N in-process "
                         "fake hosts (ShardWorker + Frontend)")
    ap.add_argument("--replication", type=int, default=2,
                    help="replicas per shard in multi-host mode")
    ap.add_argument("--hedge-after-ms", default="50",
                    help="backup-request deadline per shard dispatch (ms),"
                         " or 'auto' to derive it from the observed "
                         "per-worker latency histogram p95 (adapts as "
                         "traffic flows). In-process dispatch is "
                         "synchronous, so wall-clock runs apply failover "
                         "only; backup requests fire in the simulated-"
                         "latency benches (benchmarks/serving.py "
                         "run_multihost)")
    ap.add_argument("--fail-host", action="append", default=[],
                    help="mark a host down before the run (repeatable), "
                         "e.g. --fail-host host1")
    ap.add_argument("--word-block", type=int, default=None,
                    help="kernel tile width for every scoring dispatch; "
                         "default: the autotuner's measured choice (with "
                         "--autotune / a tuning cache) else the kernel "
                         "default")
    ap.add_argument("--autotune", action="store_true",
                    help="measure kernel configs per batch shape on "
                         "demand and drive the planner from measured "
                         "costs; entries persist in the tuning cache "
                         "(tuning-torch.json beside a v2 store's "
                         "manifest). "
                         "Single-host mode only")
    ap.add_argument("--tuning-cache", default=None,
                    help="explicit tuning-cache path; default: "
                         "<index-dir>/tuning-torch.json for v2 stores, "
                         "in-memory otherwise")
    ap.add_argument("--dedup-min-rate", type=float, default=0.5,
                    help="minimum batch row-dedup rate before the "
                         "unique-row scoring path replaces the fused "
                         "multi-query kernel; negative disables dedup "
                         "(a tuner-measured break-even overrides this). "
                         "Single-host mode only")
    ap.add_argument("--prune", action="store_true",
                    help="threshold-driven pruned scoring: execute terms "
                         "rarest-first in chunks and early-exit blocks "
                         "whose bound cannot reach the coverage cutoff, "
                         "skipping their tile I/O, staging and kernel "
                         "work. The planner still gates per batch on the "
                         "tuned/heuristic break-even; results stay "
                         "bit-identical. STATS show blocks pruned / tiles "
                         "skipped / bytes saved")
    ap.add_argument("--prune-chunk", type=int, default=32,
                    help="terms per chunk for --prune (smaller = earlier "
                         "exit, more dispatches)")
    ap.add_argument("--prune-min-rate", type=float, default=None,
                    help="minimum predicted block-prune rate before a "
                         "batch dispatches pruned (default 0.5; a "
                         "tuner-measured break-even overrides this)")
    ap.add_argument("--adaptive-buckets", action="store_true",
                    help="fit micro-batch bucket edges to the observed "
                         "term-length histogram instead of the fixed "
                         "term_pad grid (denser batches when query "
                         "lengths cluster between grid lines)")
    ap.add_argument("--bulk", default=None, metavar="FILE",
                    help="sweep the query patterns in FILE (one per "
                         "line, # comments) through the offline bulk "
                         "lane — shard-major, each tile staged once for "
                         "the whole set. Runs alongside network traffic "
                         "in --listen mode, inline after the load report "
                         "otherwise")
    ap.add_argument("--bulk-threshold", type=float, default=None,
                    help="coverage threshold for the --bulk job "
                         "(default: --threshold)")
    ap.add_argument("--bulk-topk", type=int, default=0,
                    help="top-k mode for the --bulk job (0 = threshold)")
    ap.add_argument("--bulk-checkpoint", default=None, metavar="PATH",
                    help="checkpoint the --bulk sweep here after every "
                         "shard; an existing file resumes the sweep")
    ap.add_argument("--scatter-threads", type=int, default=4,
                    help="multi-host concurrent scatter pool size "
                         "(<= 1 = sequential per-shard dispatch)")
    ap.add_argument("--worker", default=None, metavar="NAME",
                    help="process role: serve placement node NAME's shard "
                         "replicas over the v4 wire protocol "
                         "(WorkerServer) instead of generating load. "
                         "Needs an existing v2 store; pair with "
                         "--worker-nodes / --worker-port / --port-file")
    ap.add_argument("--worker-nodes", default=None, metavar="N0,N1,...",
                    help="full logical node list for the HRW placement; "
                         "must be identical on every worker and the "
                         "frontend (default: host0..host{--hosts-1})")
    ap.add_argument("--worker-port", type=int, default=0, metavar="PORT",
                    help="bind port for --worker (0 = OS-assigned; "
                         "published via --port-file)")
    ap.add_argument("--port-file", default=None, metavar="PATH",
                    help="--worker writes 'host port' here (atomically) "
                         "once bound — launchers/tests read it to "
                         "discover OS-assigned ports")
    ap.add_argument("--straggle-ms", type=float, default=0.0,
                    help="--worker only: sleep this long before every "
                         "dispatch (cancellation-aware) — an injected "
                         "straggler for hedging demos and benches")
    ap.add_argument("--workers", default=None,
                    metavar="N0=HOST:PORT,N1=@PORTFILE,...",
                    help="process role: frontend over the RPC data plane "
                         "— dial these worker processes through the "
                         "reconnecting channel pool and scatter every "
                         "shard dispatch as a real hedged RPC. "
                         "@portfile entries wait for a --port-file. "
                         "Combine with --listen for the TCP front door")
    ap.add_argument("--connect-timeout", type=float, default=15.0,
                    help="seconds to wait for --workers port files and "
                         "first connections")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve over TCP instead of generating load: "
                         "active ServingLoop + wire protocol on this "
                         "port (0 = ephemeral). Query with "
                         "repro_torch.serve.NetClient or "
                         "benchmarks/serving.py --listen. Ctrl-C drains "
                         "in-flight batches and exits")
    ap.add_argument("--listen-host", default="127.0.0.1",
                    help="bind address for --listen")
    ap.add_argument("--loop-workers", type=int, default=1,
                    help="scoring worker threads in the serving loop "
                         "(--listen mode)")
    ap.add_argument("--stats-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="in --listen mode, dump the Prometheus text "
                         "exposition of the whole metrics registry every "
                         "SECONDS (besides the one-line snapshot report); "
                         "SIGUSR1 dumps it on demand either way")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable request tracing (spans, trace ids on "
                         "the wire, the slow-query log)")
    ap.add_argument("--trace-slow-ms", type=float, default=0.0,
                    help="emit finished traces slower than this to the "
                         "slow-query event log (0 = off)")
    ap.add_argument("--trace-log", default=None, metavar="PATH",
                    help="append slow-query trace events as JSONL here "
                         "(replay with benchmarks/trace_report.py)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the index, every server, worker "
                         "and bulk lane (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.hedge_after_ms == "auto":
        hedge_after_ms, hedge_auto = 50.0, True
    else:
        try:
            hedge_after_ms, hedge_auto = float(args.hedge_after_ms), False
        except ValueError:
            ap.error("--hedge-after-ms takes a number of ms or 'auto'")
    if args.mode == "open" and args.qps <= 0:
        ap.error("--qps must be > 0 in open-loop mode")
    if args.store_format == "v2" and not args.index_dir:
        ap.error("--store-format v2 requires --index-dir (the store is "
                 "the on-disk shard directory)")
    if args.concurrency < 1:
        ap.error("--concurrency must be >= 1")
    if args.hosts > 1 and not (args.store_format == "v2" and args.index_dir):
        ap.error("--hosts > 1 requires --store-format v2 --index-dir (the "
                 "shard files are the placement unit)")
    if args.worker and args.workers:
        ap.error("--worker and --workers are mutually exclusive process "
                 "roles")
    if (args.worker or args.workers) and not (args.store_format == "v2"
                                              and args.index_dir):
        ap.error("--worker/--workers require --store-format v2 "
                 "--index-dir (the shard files are the placement unit)")
    if args.worker:
        run_worker(args)
        return

    corpus, index = build_or_load(args)
    tile_bytes = (None if args.tile_cache_mib is None
                  else int(args.tile_cache_mib * 2**20))
    tuning_cache = args.tuning_cache
    if tuning_cache is None and args.store_format == "v2" and args.index_dir:
        from ..core.store import tuning_path
        tuning_cache = str(tuning_path(args.index_dir))
    if args.workers:
        server = make_rpc_frontend(
            args.index_dir,
            parse_worker_spec(args.workers, args.connect_timeout),
            replication=args.replication, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3,
            hedge_after_s=hedge_after_ms / 1e3, hedge_auto=hedge_auto,
            scatter_threads=args.scatter_threads,
            tracing=not args.no_trace, trace_slow_ms=args.trace_slow_ms,
            trace_log=args.trace_log, pruned=args.prune,
            prune_chunk=args.prune_chunk,
            adaptive_buckets=args.adaptive_buckets,
            connect_timeout_s=args.connect_timeout)
        print(f"rpc frontend: {len(server.placement.nodes)} worker "
              f"process(es), replication "
              f"{min(args.replication, len(server.placement.nodes))}, "
              f"{server.placement.n_shards} shards, hedge_after="
              f"{hedge_after_ms}ms")
    elif args.hosts > 1:
        if args.autotune or args.tuning_cache or args.dedup_min_rate != 0.5:
            print("note: --autotune/--tuning-cache/--dedup-min-rate apply "
                  "to the single-host QueryServer only; the multi-host "
                  "ShardWorkers take --word-block but keep heuristic "
                  "kernel choice (see ROADMAP open items)")
        server = make_multihost_frontend(
            args.index_dir, hosts=args.hosts, replication=args.replication,
            max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
            hedge_after_s=hedge_after_ms / 1e3, hedge_auto=hedge_auto,
            tile_cache_bytes=tile_bytes, word_block=args.word_block,
            scatter_threads=args.scatter_threads,
            fail_hosts=args.fail_host, tracing=not args.no_trace,
            trace_slow_ms=args.trace_slow_ms, trace_log=args.trace_log,
            pruned=args.prune, prune_chunk=args.prune_chunk,
            prune_min_rate=args.prune_min_rate,
            adaptive_buckets=args.adaptive_buckets, device=args.device)
        down = sorted(set(server.placement.nodes)
                      - set(server.placement.live_nodes))
        print(f"multi-host frontend: {args.hosts} hosts, "
              f"replication {min(args.replication, args.hosts)}, "
              f"{server.placement.n_shards} shards, down={down or 'none'}")
    else:
        server = QueryServer(index, ServerConfig(
            max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
            tile_cache_bytes=tile_bytes, word_block=args.word_block,
            dedup_min_rate=(None if args.dedup_min_rate < 0
                            else args.dedup_min_rate),
            autotune=args.autotune,
            tuning_cache=tuning_cache if args.autotune or args.tuning_cache
            else None,
            pruned=args.prune, prune_chunk=args.prune_chunk,
            prune_min_rate=args.prune_min_rate,
            tracing=not args.no_trace, trace_slow_ms=args.trace_slow_ms,
            trace_log=args.trace_log,
            adaptive_buckets=args.adaptive_buckets), device=args.device)
        if args.autotune:
            print(f"autotune on: cache="
                  f"{tuning_cache or 'in-memory'}")
    if args.listen is not None:
        # network serving mode: no local load generation — stand up the
        # active loop + wire protocol and serve until interrupted.
        import signal

        from ..obs.export import render_prometheus
        from ..serve import BulkLane, NetServer, ServingLoop
        from ..serve.net import PROTO_VERSION
        loop = ServingLoop(server, workers=args.loop_workers)
        # offline lane: BULK wire frames (and --bulk FILE) sweep in the
        # interactive lane's idle time, one shard per lock acquisition
        lane = BulkLane(server, loop).start()
        net = NetServer(loop, host=args.listen_host,
                        port=args.listen).start()
        host, port = net.address
        if args.bulk:
            job = submit_bulk_file(lane, args, on_done=report_bulk)
            print(f"bulk job {job.job_id} queued: {job.n_queries} "
                  f"queries from {args.bulk}")

        def dump_registry(*_sig) -> None:
            # registry metrics lock individually, so this is safe from
            # the signal handler / monitor thread while workers record
            print(render_prometheus(server.metrics.registry), end="")

        if hasattr(signal, "SIGUSR1"):
            signal.signal(signal.SIGUSR1, dump_registry)
            print("SIGUSR1 dumps the metrics registry "
                  f"(kill -USR1 {os.getpid()})")
        print(f"serving on {host}:{port} (wire protocol "
              f"v{PROTO_VERSION}; query with repro_torch.serve.NetClient, "
              f"or drive load with python -m benchmarks.serving --listen "
              f"--connect {host}:{port})", flush=True)
        interval = args.stats_interval or 10.0
        try:
            while True:
                time.sleep(interval)
                # snapshot under the loop lock: workers are appending to
                # the metric deques while this thread reads them
                print(loop.metrics_snapshot().report())
                if args.stats_interval:
                    dump_registry()
        except KeyboardInterrupt:
            print("draining in-flight batches ...")
        net.close(drain=True)
        print(server.metrics.snapshot().report())
        if args.workers:
            server.close()           # drop the worker channel pool
        return

    queries, origin = make_workload(corpus, args.queries)

    if args.mode == "closed":
        runner = lambda: run_closed(server, queries, args.threshold,
                                    args.concurrency)
    else:
        runner = lambda: run_open(server, queries, args.threshold, args.qps)

    if not args.no_warmup:
        # Replay the measured routine once so every (bucket, batch-shape)
        # jit entry the timed run hits is already compiled — closed-loop
        # batching is deterministic, so the shape sets match exactly.
        runner()
        server.pop_responses()
        server.reset_metrics(clear_caches=True)

    t0 = time.perf_counter()
    ids = runner()
    wall = time.perf_counter() - t0

    responses = server.pop_responses()
    correct = total = 0
    for rid, o in zip(ids, origin):
        r = responses.get(rid)
        if r is None or r.status != Status.OK:
            continue
        hit_ids = set(r.result.doc_ids.tolist())
        correct += (o in hit_ids) if o >= 0 else (len(hit_ids) == 0)
        total += 1
    snap = server.metrics.snapshot()
    print(f"mode={args.mode} served {snap.served} queries in {wall:.2f}s "
          f"-> {snap.served / wall:.0f} qps")
    print(snap.report())
    visits = server.metrics.registry.get("serve_shard_visits_total")
    if visits is not None:
        # the port's row-gather route of paged batches
        v = {labels[0]: c.value for labels, c in visits.children()}
        rows = server.metrics.registry.get("serve_tile_rows_gathered_total")
        print(f"shard visits[resident={v.get('resident', 0)} "
              f"gathered={v.get('gathered', 0)} "
              f"staged={v.get('staged', 0)}] rows gathered={rows.value}")
    print(f"accuracy vs ground truth: {correct}/{total}")

    if args.bulk:
        # inline sweep: same lane, synchronous drain — the report's
        # B/query line is the staged-bytes win over the interactive path
        from ..serve import BulkLane
        lane = BulkLane(server)
        job = submit_bulk_file(lane, args)
        lane.drain()
        report_bulk(job)

    if args.workers:
        server.close()               # drop the worker channel pool


if __name__ == "__main__":
    main()
