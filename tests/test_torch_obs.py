"""The port's host-only copies of the observability plane and the serving
metrics against the JAX package's originals, on the CPU.

``repro_torch.obs`` (registry, trace, events, profile, export) and
``repro_torch.serve.metrics`` are copies that import neither ``jax`` nor
``repro``. The same record calls on both sides must give the same values,
snapshots, Prometheus text, JSONL events and traces. Every comparison is
exact; unix timestamps, which both sides take from the wall clock, are
dropped before comparing events.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs import events as jevents
from repro.obs import export as jexport
from repro.serve import metrics as jmetrics
from repro.serve import request as jrequest

from repro_torch import obs as tobs
from repro_torch.obs import events as tevents
from repro_torch.obs import export as texport
from repro_torch.serve import metrics as tmetrics
from repro_torch.serve import request as trequest

SIDES = [(jobs, jexport, jmetrics), (tobs, texport, tmetrics)]


def _drive_registry(obs, seed):
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    c = reg.counter("served_total", "requests served")
    g = reg.gauge("conns", "open connections")
    fam = reg.counter("by_method_total", "dispatches", labels=("method",))
    hist = reg.histogram("wait_s", "queue wait", window=16)
    lab = reg.histogram("kernel_s", labels=("method", "bucket"), window=8)
    for i in range(int(rng.integers(20, 60))):
        c.inc(int(rng.integers(0, 4)))
        g.set(int(rng.integers(0, 9)))
        g.inc(-1)
        fam.labels(["lookup", "dedup", 'we"ird\nname'][i % 3]).inc()
        hist.observe(float(rng.exponential(0.01)))
        lab.labels(["lookup", "dedup"][i % 2], 64 * (1 + i % 3)).observe(
            float(rng.random()))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_prometheus_text_equal(seed):
    jreg, treg = (_drive_registry(side[0], seed) for side in SIDES)
    jtext = jexport.render_prometheus(jreg)
    ttext = texport.render_prometheus(treg)
    assert ttext == jtext
    assert texport.parse_prometheus(ttext) == jexport.parse_prometheus(jtext)
    for name in ("served_total", "conns"):
        assert treg.get(name).value == jreg.get(name).value
    th, jh = treg.get("wait_s"), jreg.get("wait_s")
    assert (th.count, th.sum, len(th)) == (jh.count, jh.sum, len(jh))
    np.testing.assert_array_equal(th.values(), jh.values())
    for p in (50, 90, 99, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert treg.get("conns").max == jreg.get("conns").max


def test_registry_rejects_kind_and_label_skew_alike():
    for obs, _, _ in SIDES:
        reg = obs.MetricsRegistry()
        reg.counter("reqs_total")
        with pytest.raises(ValueError):
            reg.gauge("reqs_total")
        with pytest.raises(ValueError):
            reg.counter("reqs_total", labels=("method",))
        fam = reg.counter("tiles_total", labels=("shard", "event"))
        with pytest.raises(ValueError):
            fam.labels("only-one")


def _without_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_event_log_jsonl_equal(tmp_path):
    outs = []
    for i, (obs, _, _) in enumerate(SIDES):
        path = tmp_path / f"events{i}.jsonl"
        with obs.EventLog(path, ring=4) as log:
            for j in range(6):
                log.emit("slow_query", {"trace_id": j, "ms": j * 1.5})
            log.emit("other", {"x": [1, 2]})
        outs.append((log.emitted, _without_ts(log.tail(kind="slow_query")),
                     _without_ts(log.tail(2)), path))
    (jn, jtail, jlast, jpath), (tn, ttail, tlast, tpath) = outs
    assert (tn, ttail, tlast) == (jn, jtail, jlast)
    assert _without_ts(tevents.read_jsonl(tpath)) == \
        _without_ts(jevents.read_jsonl(jpath))
    with open(tpath, "a") as fh:                   # a torn trailing line
        fh.write('{"kind": "slow_q')
    assert len(tevents.read_jsonl(tpath)) == 7


def _drive_tracer(obs, slow_ms):
    sink = obs.EventLog(None)
    now = [100.0]
    tracer = obs.Tracer(ring=4, slow_ms=slow_ms, sink=sink,
                        clock=lambda: now[0])
    traces = []
    for i in range(6):
        t = tracer.begin(i, trace_id=(1000 + i) if i % 2 else None)
        t.add("queue_wait", now[0], now[0] + 0.001 * i)
        t.add("kernel_score", now[0] + 0.001 * i, now[0] + 0.03 * i,
              {"method": "dedup", "bucket": 64})
        t.add("kernel_score", now[0] + 0.03 * i, now[0] + 0.031 * i)
        now[0] += 0.031 * i
        tracer.finish(t)
        tracer.finish(t)                           # idempotent
        traces.append(t)
    return tracer, sink, traces


@pytest.mark.parametrize("slow_ms", [0.0, 50.0, 120.0])
def test_tracer_traces_and_slow_sink_equal(slow_ms):
    (jt, jsink, jtr), (tt, tsink, ttr) = (_drive_tracer(side[0], slow_ms)
                                          for side in SIDES)
    assert (tt.finished_count, tt.slow_count) == (jt.finished_count,
                                                 jt.slow_count)
    for a, b in zip(ttr, jtr):
        assert a.stage_totals() == b.stage_totals()
        da, db = a.to_json(), b.to_json()
        if a.trace_id >= 1000:                     # wire-minted ids
            assert a.trace_id == b.trace_id
        da.pop("trace_id")
        db.pop("trace_id")
        assert da == db
    assert [e["duration_ms"] for e in tsink.tail(kind="slow_query")] == \
        [e["duration_ms"] for e in jsink.tail(kind="slow_query")]
    off = tobs.Tracer(enabled=False)
    assert off.begin(1) is None


def test_profiler_records_and_registry_equal():
    outs = []
    for obs, export, _ in SIDES:
        reg = obs.MetricsRegistry()
        prof = obs.KernelProfiler(reg, None)
        for i in range(5):
            prof.record(method=["lookup", "dedup"][i % 2], bucket=64,
                        batch=8, seconds=0.001 * (i + 1), word_block=8,
                        bytes_moved=i * 4096, shard=i % 2)
        obs.KernelProfiler(reg, None, enabled=False).record(
            method="lookup", bucket=64, batch=8, seconds=1.0)
        outs.append((prof.count, prof.records(), prof.records(2),
                     export.render_prometheus(reg)))
    assert outs[1] == outs[0]
    from repro.obs.profile import gather_bytes as jgather
    from repro_torch.obs.profile import gather_bytes as tgather
    assert tgather(17, 33) == jgather(17, 33)


def _drive_metrics(mod, seed):
    rng = np.random.default_rng(seed)
    m = mod.ServingMetrics()
    for i in range(int(rng.integers(30, 80))):
        m.record_request(wait_s=float(rng.exponential(0.002)),
                         service_s=float(rng.exponential(0.01)),
                         cached=bool(i % 5 == 0))
        m.record_batch(int(rng.integers(1, 33)), float(rng.random()),
                       ["lookup", "dedup", "unpack", "dedup_c"][i % 4])
        m.set_queue_depth(int(rng.integers(0, 40)))
        m.record_shard_tile(i % 3, ["fault", "hit", "eviction"][i % 3])
        if i % 4 == 0:
            m.record_tiles(hits=i, faults=i % 3, resident=2, prefetched=1,
                           prefetch_hits=i % 2)
            m.record_arena_bytes(raw=4096 * i, comp=512 * i)
            m.record_prune(blocks_total=8, blocks_pruned=i % 8,
                           tiles_skipped=i % 2, bytes_saved=1024 * i)
            m.record_decode(0.0001 * i)
        if i % 7 == 0:
            m.record_rejected()
            m.record_dropped()
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_serving_metrics_snapshot_and_text_equal(seed):
    jm, tm = (_drive_metrics(side[2], seed) for side in SIDES)
    js, ts = jm.snapshot(), tm.snapshot()
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.report() == js.report()
    assert texport.render_prometheus(tm.registry) == \
        jexport.render_prometheus(jm.registry)
    for p in (50, 99):
        assert tm.percentile_ms(p) == jm.percentile_ms(p)
    assert tm.method_counts == jm.method_counts
    assert tm.shard_tile_counts("fault") == jm.shard_tile_counts("fault")
    for name in ("served", "rejected", "dropped", "cache_hits", "n_batches",
                 "page_faults", "arena_raw_bytes", "arena_comp_bytes",
                 "pruned_blocks", "pruned_bytes_saved", "max_queue_depth"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_request_envelopes_equal():
    jf = [f.name for f in dataclasses.fields(jrequest.QueryResponse)]
    tf = [f.name for f in dataclasses.fields(trequest.QueryResponse)]
    assert tf == jf
    assert [s.value for s in trequest.Status] == \
        [s.value for s in jrequest.Status]
    r = trequest.QueryRequest(3, np.zeros((2, 2), np.uint32), 2, 0.8,
                              submitted_at=1.0, deadline=1.5)
    assert r.expired(1.6) and not r.expired(1.4) and r.trace_id == 0
    assert json.dumps(trequest.Status.DROPPED) == \
        json.dumps(jrequest.Status.DROPPED)
