"""The comparison that decides ``correct``: the reference agrees with the
program on a tiny index on the CPU, the control fails it, and whole runs
of the harness over a program broken underneath come out not correct."""
import ast
import io
import json
from pathlib import Path

import pytest
import torch

from cobsbench import run as bench_run
from cobsbench.harness import build, corpus, frozen, reference, traffic
from cobsbench.harness.spec import BENCH_DIR
from cobsbench.tests.tiny import TINY_CORPUS

SEED = 2_147_483_659          # above 2**31, as the driver's seeds are
CPU = torch.device("cpu")


def _cfg(block_docs=32):
    return {"index": {"kmer": 31, "n_hashes": 1, "fpr": 0.3,
                      "canonical": False, "block_docs": block_docs},
            "corpus": dict(TINY_CORPUS)}


def test_reference_equals_the_program_on_a_tiny_index(tmp_path):
    from repro_torch.core.query import QueryEngine
    cfg = _cfg()
    corp = corpus.make_corpus(cfg["corpus"], 31, SEED)
    index = build.build_dense(cfg, corp, CPU, piece_terms=1024)
    mix = {"chunk": 8, "pool": 40,
           "length": {"kind": "fixed", "bp": 150}, "from_doc_share": 0.5,
           "substitution_rate": 0.005, "threshold": 0.0}
    q = traffic.make_queries(mix, corp, SEED, traffic.WINDOW, 40)
    eng = QueryEngine(index, "lookup", device="cpu")
    ref = reference.Reference(corp, cfg["index"], CPU)
    terms = {i: frozen.query_terms(s, 31) for i, s in enumerate(q.seqs)}
    docs = {d: list(range(40)) for d in range(corp.n_docs)}
    want = ref.scores(docs, {i: ref.query_hashes(t)
                             for i, t in terms.items()})
    for i in range(40):
        res = eng.search(q.seqs[i], 0.0)
        got = dict(zip(res.doc_ids.tolist(), res.scores.tolist()))
        assert got == {d: want[(i, d)] for d in range(corp.n_docs)
                       if want[(i, d)] >= 1}
        if q.src[i] >= 0:       # a cut read scores high in its source
            assert want[(i, int(q.src[i]))] >= 0.5 * terms[i].shape[0]


def test_the_control_fails_the_comparison():
    cfg = _cfg()
    mix = {"chunk": 8, "pool": 300,
           "length": {"kind": "fixed", "bp": 150}, "from_doc_share": 0.5,
           "substitution_rate": 0.005, "threshold": 0.8}
    from cobsbench.control import control_verdict
    for seed in (SEED, SEED + 1, SEED + 2):
        v = control_verdict(cfg, mix, seed, 300, CPU)
        assert v.checked_requests == 300
        assert v.mismatches > 0


def _run(spec, workload, *, seconds="1.5", trace="0"):
    out, err = io.StringIO(), io.StringIO()
    rc = bench_run.main(["--workload", workload, "--seed", str(SEED),
                         "--seconds", seconds, "--trace", trace],
                        spec=spec, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    lines = err.getvalue().splitlines()
    assert lines[-2].startswith("compared mismatches")
    assert lines[-1].startswith("compared unanswered")
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("workload", ["dense.reads"])
@pytest.mark.parametrize("pool", [None, 8], ids=["pool", "small_pool"])
def test_a_sound_run_is_correct(tiny, workload, pool):
    """A whole run; with a pool of 8, every run goes round it many times
    and the check follows each request to the query it sent."""
    if pool is not None:
        tiny.set_pool(pool)
    res = _run(tiny, workload)
    assert res["correct"] is True
    if pool is not None:
        assert res["attempted"] > 4 * pool
    assert list(res)[-1] == "compared"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "queries_per_s"}
    assert res["device"]["platform"] == "cpu"


def _alter_answer(monkeypatch):
    """An answer altered where it is produced: the server reports each
    hit's count one lower."""
    from repro_torch.core import query
    from repro_torch.serve import server
    real = query.select_hits

    def wrong(scores, n_terms, threshold):
        r = real(scores, n_terms, threshold)
        r.scores = r.scores - 1
        return r
    monkeypatch.setattr(server, "select_hits", wrong)


def _drop_half_the_batch(monkeypatch):
    """Half of each batch left out: the scores of the second half of a
    batch's queries are zeroed before selection."""
    from repro_torch.serve.server import QueryServer
    real = QueryServer._select

    def half(scores, n_terms, threshold, top_k, _n=[0]):
        _n[0] += 1
        return real(scores * (_n[0] % 2), n_terms, threshold, top_k)
    monkeypatch.setattr(QueryServer, "_select", staticmethod(half))


@pytest.mark.parametrize("workload,fault", [
    ("dense.reads", _alter_answer), ("dense.reads", _drop_half_the_batch)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_program_is_not_correct(tiny, monkeypatch, workload, fault):
    """The harness's whole run, past its look for a card, over the timed
    path broken underneath."""
    fault(monkeypatch)
    res = _run(tiny, workload)
    assert res["correct"] is False
    assert res["compared"]["mismatches"]["value"] > 0


# -- imports -----------------------------------------------------------------

def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not bad


@pytest.mark.parametrize("name", ["reference", "frozen", "corpus"])
def test_the_reference_imports_nothing_of_the_program(name):
    path = BENCH_DIR / "harness" / f"{name}.py"
    assert "repro_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "dataclasses", "math", "numpy",
                              "torch", "statistics"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torchx", object())
    assert "repro" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in bench_run.forbidden_modules()
