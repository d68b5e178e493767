"""The paged cell on the CPU: ``entries/paged_closed.py`` over a tiny copy
of ``cobs-paper-paged`` (three shards; the configuration's share of the
store holds two tiles), judged by ``harness/reference.py``, with its
readers; and its clean exit on a program without the row-gather route."""
import dataclasses
import io
import json
import tempfile

import pytest

from cobsbench import run as bench_run
from cobsbench.harness import build, corpus, devtrace, session
from cobsbench.harness.spec import BENCH_DIR, Spec

ARGS = ["--workload", "paged.reads", "--seed", "2147483659", "--seconds",
        "1"]
READERS = ("tiles.staged_bytes_per_query.paged",
           "tiles.gather_us_per_query.paged", "score_roofline.reads")
# the dense cell's readers of the server's own counters, which read the
# paged cell too
COUNTER_READERS = ("serve.batch_mean.reads", "engine.rows_per_query.reads")


@pytest.fixture
def paged(tiny):
    """The tiny spec with ``cobs-paper-paged`` over the tiny corpus, with
    the configuration's own ``server`` settings."""
    real = json.loads((BENCH_DIR / "configs" / "cobs-paper-paged.json")
                      .read_text())
    tiny_3card = tiny.config("cobs-paper-3card")
    cfg = dict(real, index=tiny_3card["index"], corpus=tiny_3card["corpus"])
    layout, _ = build.plan(cfg, corpus.make_corpus(cfg["corpus"], 31, 1))
    (tiny.root / "configs" / "cobs-paper-paged.json").write_text(
        json.dumps(cfg))
    return tiny, layout


def test_the_paged_cell_runs_and_is_judged_correct(paged, tmp_path,
                                                   monkeypatch):
    spec, layout = paged
    assert layout.n_blocks == 3
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lines = {}
    for trace in ("0", "1"):
        out, err = io.StringIO(), io.StringIO()
        rc = bench_run.main(ARGS + ["--trace", trace], spec=spec,
                            device="cpu", out=out, err=err)
        assert rc == 0, err.getvalue()[-2000:]
        lines[trace] = json.loads(out.getvalue().splitlines()[-1])
        assert lines[trace]["correct"] is True
        assert lines[trace]["compared"]["mismatches"]["value"] == 0
        assert "tile cache: 2 of 3 tiles" in err.getvalue()
    assert set(lines["0"]["metrics"]) == {"setup_s", "queries_per_s"}
    # no card: no trace or roofline; the counters' readers read numbers
    got = lines["1"]["metrics"]
    assert set(got) == set(READERS[:2] + COUNTER_READERS)
    assert all(got[m]["value"] > 0 for m in READERS[:2] + COUNTER_READERS)
    info = lines["1"]["info"]
    visits = info["shard_visits"]
    assert visits["gathered"] > 0 and visits["resident"] == 2 * visits[
        "gathered"] and not visits.get("staged")
    assert info["tile_evictions"] == 0 and info["tile_faults"] == 0
    assert not list(tmp_path.glob("cobsbench-store-*"))   # deleted


def test_the_readers_read_a_paged_run():
    """The three readers over a hand-made record: 2 requests, 1,000 bytes
    staged and 3,000 gathered, 0.5 ms of gathers, a bound of 2 us over 4
    us of scoring kernels."""
    tr = devtrace.Trace(window=(0, 10_000), device=[
        devtrace.Event("dedup_kernel", 0, 3_000),
        devtrace.Event("lookup_kernel", 5_000, 6_000),
        devtrace.Event("select_kernel", 6_000, 9_000)], host=[])
    run = session.Run(window_s=1e-5, queries=None, n_requests=2, answers={},
                      e2e={}, counters={"served": 2,
                                        "tile_raw_bytes_staged": 1_000,
                                        "tile_gathered_bytes": 3_000,
                                        "tile_gather_s": 5e-4},
                      on_card=True, device_name="test", trace=tr,
                      roofline={"bound_s": 2e-6, "batches": 1})
    got = [Spec().metric(m).read(run) for m in READERS]
    assert got == [pytest.approx(2_000), pytest.approx(250),
                   pytest.approx(50)]
    parent = dataclasses.replace(run, counters={"served": 2,
                                                 "tile_raw_bytes_staged": 9})
    assert [Spec().metric(m).read(parent) for m in READERS[:2]] == \
        [None, None]


def test_a_program_without_the_route_stops_before_set_up(paged,
                                                         monkeypatch):
    spec, _ = paged
    from repro_torch.serve import QueryServer
    monkeypatch.delattr(QueryServer, "warm_tiles")
    monkeypatch.setattr(build, "plan", lambda *a: pytest.fail("built"))
    out, err = io.StringIO(), io.StringIO()
    with pytest.raises(SystemExit) as e:
        bench_run.main(ARGS + ["--trace", "0"], spec=spec, device="cpu",
                       out=out, err=err)
    assert e.value.code == 3 and out.getvalue() == ""
    assert "no row-gather route" in err.getvalue()
    assert "QueryServer.warm_tiles" in err.getvalue()
