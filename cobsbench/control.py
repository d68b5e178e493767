"""The control of the comparison that decides ``correct``: the reference in
the program's place with the configuration's guarantee of exact counts
broken (each query scored on 7/8 of its terms, the count scaled up), at a
cell's own size. It has to come out as not correct on every seed. Not
part of a benchmark run.

    python3 cobsbench/control.py --workload dense.reads --requests 5000 \
        --seeds 11,12,13

For each seed: the cell's corpus and the window's queries (``--requests``
of them, as many as a run answers, round the pool as a run goes), the control's
answers for the sample a run checks, and the comparison's numbers. Prints
one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]


def control_verdict(cfg: dict, mix: dict, seed: int, n_requests: int,
                    device):
    """The comparison's verdict on the control's answers for one seed."""
    import numpy as np
    from cobsbench import run as bench_run
    from cobsbench.harness import corpus, frozen, reference, traffic
    corp = corpus.make_corpus(cfg["corpus"], int(cfg["index"]["kmer"]),
                              seed)
    q = traffic.make_queries(mix, corp, seed, traffic.WINDOW,
                             traffic.pool(mix, traffic.WINDOW))
    pool = traffic.pool_index(np.arange(n_requests), len(q))
    sample = reference.sample_requests(list(range(n_requests)), n_requests,
                                       seed, bench_run.SAMPLE_REQUESTS)
    k = int(cfg["index"]["kmer"])
    terms = {i: frozen.query_terms(q.seqs[pool[i]], k) for i in sample}
    ref = reference.Reference(corp, cfg["index"], device)
    shared = reference.shared_docs(corp, seed, bench_run.SHARED_DOCS)
    thr = float(mix["threshold"])
    src = q.src[pool]
    answers = reference.control_answers(sample, terms, src, shared, thr, ref)
    return reference.judge(sample, answers, terms, src, shared, thr, ref)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=5000)
    args = ap.parse_args()
    import torch
    from cobsbench.harness.spec import Spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sp = Spec()
    cell = sp.cell(args.workload)
    cfg, mix = sp.config(cell["config"]), sp.mix(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        v = control_verdict(cfg, mix, seed, args.requests,
                            torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mismatches": v.mismatches,
                          "checked_requests": v.checked_requests,
                          "checked_pairs": v.checked_pairs,
                          "seconds": time.monotonic() - t,
                          "first": [list(map(str, b)) for b in v.first]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
