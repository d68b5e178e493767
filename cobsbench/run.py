"""Run one cell of the benchmark once.

    python3 cobsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's index on the card from the
seed, warms the cell's traffic up, measures for ``--seconds``, checks a
sample of the answers against the plain reference, and prints one JSON
line as the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
     "card", "info", "compared"}

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (read from a profiler trace of the window and from the
program's counters). The numbers compared, each with its limit, are the
last lines of standard error and the last key of the result.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside the benchmark, or if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
# every build and kernel cache of the program stays inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(CHECKOUT / "build" / "torch_extensions"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_REQUESTS = 512     # answers checked against the reference
SHARED_DOCS = 64          # documents checked for every sampled answer


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the process must not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else None


def check(run, ctx):
    import numpy as np
    from cobsbench.harness import frozen, reference, traffic
    corp = ctx.corpus()
    sample = reference.sample_requests(sorted(run.answers), run.n_requests,
                                       ctx.seed, SAMPLE_REQUESTS)
    k = int(ctx.cfg["index"]["kmer"])
    pool = traffic.pool_index(np.arange(run.n_requests), len(run.queries))
    terms = {q: frozen.query_terms(run.queries.seqs[pool[q]], k)
             for q in sample}
    ref = reference.Reference(corp, ctx.cfg["index"], ctx.device)
    shared = reference.shared_docs(corp, ctx.seed, SHARED_DOCS)
    return reference.judge(sample, run.answers, terms, run.queries.src[pool],
                           shared, ctx.threshold, ref)


def main(argv=None, *, spec=None, device: str | None = None,
         out=None, err=None) -> int:
    """``spec`` and ``device`` are for tests: another set of spec files, and
    a device that skips the look for a card."""
    out = out or sys.stdout
    err = err or sys.stderr
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"[cobsbench {time.monotonic() - T_PROCESS:7.1f}s] {msg}",
              file=err, flush=True)

    from cobsbench.harness import session
    from cobsbench.harness.spec import Spec
    sp = spec or Spec()
    wl = sp.workload(args.workload)
    cell = sp.cell(args.workload)

    import torch
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA card: this benchmark measures the card")
            return 2
        if torch.cuda.device_count() < int(wl["chips"]):
            log(f"{args.workload} asks for {wl['chips']} cards, "
                f"{torch.cuda.device_count()} present")
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not beside the benchmark: {e}")
        return 3

    entry = sp.entry(cell["entry"])
    ctx = session.Context(cell=args.workload, cfg=sp.config(cell["config"]),
                          mix=sp.mix(cell["traffic"]), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=dev, t_process=T_PROCESS, log=log)
    run = entry.run(ctx)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    metrics = {}
    if args.trace:
        for m in sp.metrics_of(args.workload, "per_layer"):
            v = sp.metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=ctx.setup_s)
        for m in sp.metrics_of(args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    log(f"window closed: {len(run.answers)} of {run.n_requests} "
        f"requests answered; checking against the reference")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.monotonic()
    verdict = check(run, ctx)
    log(f"checked {verdict.checked_requests} requests, "
        f"{verdict.checked_pairs} (request, document) pairs in "
        f"{time.monotonic() - t:.1f} s")
    for b in verdict.first:
        log(f"mismatch (request, document, answer, reference): {b}")

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4

    unanswered = run.n_requests - len(run.answers)
    compared = {"mismatches": {"value": verdict.mismatches, "limit": 0},
                "unanswered": {"value": unanswered, "limit": 0}}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": run.device_name,
                  "count": int(wl["chips"]) if dev.type == "cuda" else 0,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in compared.values()),
              "attempted": run.n_requests, "failed": unanswered,
              "metrics": metrics, "device": device_rec}
    if args.trace and run.trace is not None and dev.type == "cuda":
        from cobsbench.harness import devtrace
        device_rec["busy_s"] = devtrace.busy_s(run.trace)
        device_rec["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": devtrace.top_device_ops(run.trace),
                               "idle_gaps": devtrace.top_idle_gaps(run.trace)}
    result["card"] = power_limit() if dev.type == "cuda" else None
    result["info"] = dict(run.info, setup_s=ctx.setup_s, e2e=run.e2e,
                          methods=run.counters.get("methods"),
                          checked_requests=verdict.checked_requests,
                          checked_pairs=verdict.checked_pairs)
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} = {c['value']} (limit {c['limit']})",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
