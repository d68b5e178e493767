"""The command as the driver runs it, and a cell added as files alone."""
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from cobsbench import run as bench_run
from cobsbench.harness.spec import BENCH_DIR, CHECKOUT

ARGS = ["--workload", "dense.reads", "--seed", "2147483659", "--seconds",
        "1", "--trace", "0"]


def test_without_a_card_it_exits_non_zero_and_prints_no_result(
        monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    assert bench_run.main(ARGS, out=out, err=err) == 2
    assert out.getvalue() == ""
    assert "no CUDA card" in err.getvalue()


def test_a_checkout_of_the_benchmark_alone_exits_non_zero(tmp_path):
    """Only BENCHMARK.json and the files under paths: no program, no run."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "cobsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for code in (
            # as the driver runs it (here: no card, so it stops there)
            None,
            # past the look for a card: the program is not there
            "import sys; sys.path.insert(0, '.'); from cobsbench import run; "
            f"sys.exit(run.main({ARGS!r}, device='cpu'))"):
        cmd = ([sys.executable, "cobsbench/run.py", *ARGS] if code is None
               else [sys.executable, "-c", code])
        p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                           timeout=300, env=env)
        assert p.returncode != 0, p.stderr[-2000:]
        assert p.stdout.strip() == ""
    assert "the program is not beside the benchmark" in p.stderr


def test_a_cell_added_as_files_alone_is_run(tiny):
    """A new configuration, mix and cell, as new files and new entries in
    BENCHMARK.json; no file of the harness changes."""
    cfg = json.loads((tiny.root / "configs" / "cobs-paper-3card.json")
                     .read_text())
    cfg.update(name="tiny-two-hash")
    cfg["index"]["n_hashes"] = 2
    (tiny.root / "configs" / "tiny-two-hash.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.root / "traffic" / "reads.json").read_text())
    mix.update(length={"kind": "fixed", "bp": 100}, threshold=0.6)
    (tiny.root / "traffic" / "short.json").write_text(json.dumps(mix))
    cell = {"config": "tiny-two-hash", "traffic": "short",
            "entry": "inproc_closed", "chips": 1, "why": "a new cell"}
    (tiny.root / "workloads" / "two.short.json").write_text(json.dumps(cell))
    tiny.bench["workloads"].append(dict(cell, name="two.short"))
    del tiny.bench["workloads"][-1]["entry"]
    for m in tiny.bench["end_to_end"] + tiny.bench["per_layer"]:
        if "dense.reads" in m.get("workloads", []):
            m["workloads"].append("two.short")
    for trace in ("0", "1"):
        out, err = io.StringIO(), io.StringIO()
        rc = bench_run.main(["--workload", "two.short", "--seed", "7",
                             "--seconds", "1", "--trace", trace],
                            spec=tiny, device="cpu", out=out, err=err)
        assert rc == 0, err.getvalue()[-2000:]
        res = json.loads(out.getvalue().splitlines()[-1])
        assert res["correct"] is True
        want = ({"setup_s", "queries_per_s"} if trace == "0" else
                {"serve.batch_mean.reads", "engine.rows_per_query.reads"})
        assert set(res["metrics"]) == want


@pytest.mark.card
def test_the_control_fails_on_the_card(card):
    """The control at a small size on the card (the chip run at the cells'
    own sizes is ``cobsbench/control.py``)."""
    from cobsbench.control import control_verdict
    from cobsbench.tests.tiny import TINY_CORPUS
    cfg = {"index": {"kmer": 31, "n_hashes": 1, "fpr": 0.3,
                     "canonical": False, "block_docs": 32},
           "corpus": dict(TINY_CORPUS)}
    mix = {"chunk": 8, "pool": 256,
           "length": {"kind": "fixed", "bp": 150}, "from_doc_share": 0.5,
           "substitution_rate": 0.005, "threshold": 0.8}
    for seed in (11, 12, 13):
        assert control_verdict(cfg, mix, seed, 256, card).mismatches > 0
