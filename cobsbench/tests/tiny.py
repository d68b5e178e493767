"""A tiny copy of the benchmark's spec files, for runs on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from cobsbench.harness.spec import BENCH_DIR, CHECKOUT, Spec

TINY_CORPUS = {"n_docs": 80, "collection_docs": 240, "cards": 3, "card": 1,
               "mean_terms": 3000, "sigma": 0.5, "min_terms": 1200,
               "max_terms": 9000}


def _dump(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Spec:
    """The benchmark's entries, metrics and cells over tiny configurations
    and short mixes, under ``tmp``."""
    shutil.copytree(BENCH_DIR / "entries", tmp / "entries")
    shutil.copytree(BENCH_DIR / "metrics", tmp / "metrics")
    shutil.copytree(BENCH_DIR / "workloads", tmp / "workloads")
    cfg = json.loads((BENCH_DIR / "configs" / "cobs-paper-3card.json")
                     .read_text())
    cfg["corpus"] = dict(TINY_CORPUS)
    cfg["index"]["block_docs"] = 32
    _dump(tmp / "configs" / "cobs-paper-3card.json", cfg)
    reads = json.loads((BENCH_DIR / "traffic" / "reads.json").read_text())
    reads.update(pool=8192, chunk=8, warmup_s=0.2)
    _dump(tmp / "traffic" / "reads.json", reads)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    return TinySpec(tmp, bench)


class TinySpec(Spec):
    def set_pool(self, n: int) -> None:
        """Every mix's pool made ``n`` queries."""
        for path in (self.root / "traffic").glob("*.json"):
            mix = json.loads(path.read_text())
            _dump(path, dict(mix, pool=n))
