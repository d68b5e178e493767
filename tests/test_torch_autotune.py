"""The port's kernel autotuner against ``repro.kernels.autotune``, on the
CPU.

* the host-only parts (constants, ``tuning_key``, ``TunedEntry``,
  ``TuningCache``, ``_pad_unique``) equal the JAX ones, and a cache file
  written by either package loads in the other, with the same fallbacks
  for a file of another version or a corrupt one;
* the synthetic fixtures (``_tune_arena``, ``_tune_dict``,
  ``_batch_fixture``) make the JAX draws, uint32 words as int32 bit
  patterns;
* ``_tune`` returns the JAX ``_tune``'s ``TunedEntry`` for every method
  when both tuners' ``_measure_*`` are replaced by the same fake timings,
  which reach each sentinel (0.0, 2.0, None) and the inside of both
  break-even fits (the JAX tuner times its six knob candidates, the port
  one; under equal times both keep the first);
* ``entry``'s live preference and threshold graft, ``observe``'s
  promotion, the ``.cr`` key of a rowdict store, persist and reopen with
  zero tunes, a read-only tuner never measuring;
* a real tune of each method on the CPU (the kernels' plain versions) at
  a tiny size, checked for fields in range only: which method is faster on
  the CPU says nothing of the card.

No JAX kernel runs here: the JAX tuner is only ever given fake timings.
Every comparison is exact.
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import bitslice_score as jk

from repro_torch.core import IndexParams, build_compact, load_index_v2
from repro_torch.core.store import tuning_path
from repro_torch.index import build_compact_streaming
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import bitslice_score as tk
from repro_torch.kernels import ops

torch.set_num_threads(2)

CPU = "cpu"


def port_tuner(*args, **kw):
    return tat.KernelTuner(*args, device=CPU, **kw)


def as_jax(e: tat.TunedEntry) -> jat.TunedEntry:
    return jat.TunedEntry(**dataclasses.asdict(e))


# --------------------------------------------------------------------------
# Host-only parts
# --------------------------------------------------------------------------

def test_constants_equal_reference():
    for name in ("CACHE_VERSION", "DEFAULT_WORD_BLOCKS",
                 "DEFAULT_TERM_BLOCKS", "TUNABLE_METHODS", "LIVE_PREFIX",
                 "PRUNE_TUNE_CHUNK"):
        assert getattr(tat, name) == getattr(jat, name), name
    assert tat.DEFAULT_TERM_BLOCK == jk.DEFAULT_TERM_BLOCK
    assert tk.GRID_ORDERS == jk.GRID_ORDERS
    # the knobs the port records: the first of each JAX candidate tuple
    assert (tat.WORD_BLOCK, tat.TERM_BLOCK, tat.GRID_ORDER) == (
        jat.DEFAULT_WORD_BLOCKS[0], jat.DEFAULT_TERM_BLOCKS[0],
        jk.GRID_ORDERS[0])
    for n in list(range(0, 70)) + [1000, 1024, 1025, 8191, 8193]:
        assert tat._pad_unique(n) == jat._pad_unique(n), n


@pytest.mark.parametrize("method", ["lookup", "lookup_c", "lookup_p",
                                    "vertical", "unpack"])
def test_tuning_key_over_a_grid(method):
    for rows in (64, 3_807_232):
        for w in (1, 4, 32):
            for kk in (1, 3):
                for nb in (1, 2, 17):
                    for bucket, batch in ((64, 1), (128, 32), (320, 4)):
                        args = (rows, w, kk, nb, method, bucket, batch)
                        assert tat.tuning_key(*args) == \
                            jat.tuning_key(*args)


ENTRIES = {
    "r1.w4.k1.b2.lookup.L64.Q4": tat.TunedEntry(
        "lookup", 128, 8, "qw", 123.4, dedup_threshold=0.4),
    "r1.w4.k1.b2.vertical.L64.Q4": tat.TunedEntry(
        "vertical", 64, 16, "wq", 56.7),
    "r1.w4.k1.b2.lookup_p.L64.Q4": tat.TunedEntry(
        "lookup_p", 64, 32, "wq", 9.5, dedup_threshold=2.0),
    "live.r1.w4.k1.b2.lookup.L64.Q4": tat.TunedEntry(
        "lookup", 256, 8, "wq", 1e-3, observed=True),
}


def test_tuned_entry_json_equal_reference():
    for e in ENTRIES.values():
        j = as_jax(e)
        assert e.to_json() == j.to_json()
        assert tat.TunedEntry.from_json(j.to_json()) == e
        assert dataclasses.asdict(jat.TunedEntry.from_json(e.to_json())) \
            == dataclasses.asdict(e)
    # absent optional fields read the same on both sides
    bare = {"method": "unpack", "word_block": "64", "term_block": 8.0,
            "grid_order": "wq", "cost_us": 3}
    assert dataclasses.asdict(tat.TunedEntry.from_json(bare)) == \
        dataclasses.asdict(jat.TunedEntry.from_json(bare))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_file_loads_in_the_other_package(tmp_path, writer):
    paths = {side: tmp_path / side / "tuning.json" for side in ("port",
                                                                 "jax")}
    tc, jc = tat.TuningCache(paths["port"]), jat.TuningCache(paths["jax"])
    for key, e in ENTRIES.items():
        tc.put(key, e)
        jc.put(key, as_jax(e))
    tc.save()
    jc.save()
    # the same entries make the same bytes
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    if writer == "port":
        back = jat.TuningCache(paths["port"])
        got = {k: dataclasses.asdict(e) for k, e in back.entries.items()}
    else:
        back = tat.TuningCache(paths["jax"])
        got = {k: dataclasses.asdict(e) for k, e in back.entries.items()}
    assert not back.invalid
    assert got == {k: dataclasses.asdict(e) for k, e in ENTRIES.items()}
    assert back.get("r1.w4.k1.b2.lookup.L64.Q4").dedup_threshold == 0.4
    assert back.get("missing") is None
    assert (back.hits, back.misses) == (1, 1)


@pytest.mark.parametrize("payload", [
    json.dumps({"version": 999, "entries": {}}),
    "{not json",
    json.dumps([1, 2, 3]),
    json.dumps({"version": 1}),
    json.dumps({"version": 1, "entries": {"k": {"method": "lookup"}}}),
    json.dumps({"version": 1, "entries": {"k": {
        "method": "lookup", "word_block": "x", "term_block": 8,
        "grid_order": "wq", "cost_us": 1.0}}}),
])
def test_unreadable_cache_falls_back_empty_alike(tmp_path, payload):
    path = tmp_path / "tuning.json"
    path.write_text(payload)
    tc, jc = tat.TuningCache(path), jat.TuningCache(path)
    assert (tc.invalid, len(tc)) == (jc.invalid, len(jc)) == (True, 0)
    assert tc.get("anything") is None and tc.misses == 1
    # the next save rewrites the file in the current format
    tc.put("k", ENTRIES["r1.w4.k1.b2.vertical.L64.Q4"])
    tc.save()
    again = jat.TuningCache(path)
    assert not again.invalid and list(again.entries) == ["k"]


def test_memory_cache_saves_nothing(tmp_path):
    c = tat.TuningCache()
    c.put("k", ENTRIES["r1.w4.k1.b2.vertical.L64.Q4"])
    c.save()
    assert c.path is None and len(c) == 1


# --------------------------------------------------------------------------
# Synthetic fixtures
# --------------------------------------------------------------------------

GEOMETRIES = {
    # (n_rows, W, n_hashes, n_blocks, tuner keywords)
    "capped": (100_000, 4, 1, 3, dict(comp_ratio=3.2)),
    "short arena": (40, 3, 1, 2, dict(max_tune_rows=2048, comp_ratio=1.1)),
    "tiny cap, seed": (5000, 32, 2, 9, dict(max_tune_rows=64,
                                            max_tune_blocks=2, seed=5)),
    "no ratio": (3000, 1, 1, 1, dict(max_tune_rows=500)),
}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_fixtures_equal_reference(geom):
    rows, w, kk, nb, kw = GEOMETRIES[geom]
    jt = jat.KernelTuner(rows, w, kk, nb, **kw)
    tt = port_tuner(rows, w, kk, nb, **kw)
    ja = np.asarray(jt._tune_arena()).view(np.int32)
    np.testing.assert_array_equal(tt._tune_arena().numpy(), ja)
    assert tt._tune_arena().dtype == torch.int32
    for got, want in zip(tt._tune_dict(), jt._tune_dict()):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).view(np.int32))
    R = ja.shape[0]
    for bucket, batch in ((64, 1), (64, 4), (128, 32), (192, 2)):
        n = batch * max(1, min(nb, jt.max_tune_blocks)) * bucket
        for n_unique in (None, n, R, max(8, n // 10), 8):
            for got, want in zip(tt._batch_fixture(bucket, batch, n_unique),
                                 jt._batch_fixture(bucket, batch, n_unique)):
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# _tune under equal fake timings
# --------------------------------------------------------------------------

# Fake seconds per measurement, per scenario. "dedup" gives (seconds,
# padded unique rows) of the near-disjoint and the ~90%-shared fixtures.
FUSED_SCENARIOS = {
    # u_lo >= u_hi: the fixtures cannot be told apart
    "indistinguishable": dict(fused=50e-6, dedup=((40e-6, 256),
                                                  (30e-6, 256)), host=5e-6),
    # the shared fixture plus its planning loses: 2.0
    "never": dict(fused=50e-6, dedup=((80e-6, 512), (46e-6, 64)),
                  host=5e-6),
    # the disjoint fixture plus its planning wins: 0.0
    "always": dict(fused=50e-6, dedup=((40e-6, 512), (20e-6, 64)),
                   host=10e-6),
    # inside the fit
    "interior": dict(fused=50e-6, dedup=((70e-6, 512), (20e-6, 64)),
                     host=5e-6),
    "interior, costly plan": dict(fused=61e-6, dedup=((90e-6, 1024),
                                                      (10e-6, 128)),
                                  host=30e-6),
}
PRUNE_SCENARIOS = {
    "pruned always": dict(chunk=10e-6, fused=100e-6),     # full <= fused
    "pruned never": dict(chunk=10e-6, fused=8e-6),        # fused <= c0
    "pruned interior": dict(chunk=10e-6, fused=25e-6),
    "pruned interior, late": dict(chunk=7e-6, fused=9e-6),
}


def fake(tuner, sc: dict) -> list:
    """Replace the tuner's measurements with ``sc``'s timings; returns the
    list the fakes append each call to."""
    calls = []

    def fused(bucket, batch, wb, go):
        calls.append(("fused", wb, go))
        return sc.get("fused", 1e-3)

    def dedup(bucket, batch, wb, n_unique, compressed=False):
        n = batch * max(1, min(tuner.n_blocks, tuner.max_tune_blocks)) \
            * bucket
        calls.append(("dedup", n_unique, compressed))
        return sc["dedup"][0 if n_unique == n else 1]

    def add(method, bucket, batch, wb, tb):
        calls.append(("add", method, wb, tb))
        return sc.get(method, sc.get("fused", 1e-3) * 1.5)

    tuner._measure_fused = fused
    tuner._measure_fused_c = fused
    tuner._measure_dedup = dedup
    tuner._measure_plan_host = lambda bucket, batch: sc.get("host", 0.0)
    tuner._measure_add = add
    tuner._measure_chunk = lambda bucket, batch, wb, chunk: sc["chunk"]
    return calls


def tune_both(kk, method, bucket, batch, sc):
    jt = jat.KernelTuner(50_000, 4, kk, 3, comp_ratio=2.5)
    tt = port_tuner(50_000, 4, kk, 3, comp_ratio=2.5)
    fake(jt, sc)
    calls = fake(tt, sc)
    got, want = tt._tune(method, bucket, batch), jt._tune(method, bucket,
                                                          batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tt.tunes == jt.tunes == 1
    return got, calls


@pytest.mark.parametrize("scenario", list(FUSED_SCENARIOS))
@pytest.mark.parametrize("method", ["lookup", "lookup_c"])
def test_tune_fused_equals_reference(method, scenario):
    want_thr = {"indistinguishable": None, "never": 2.0, "always": 0.0}
    for bucket, batch in ((64, 4), (128, 32)):
        e, calls = tune_both(1, method, bucket, batch,
                             FUSED_SCENARIOS[scenario])
        if scenario in want_thr:
            assert e.dedup_threshold == want_thr[scenario]
        else:
            assert 0.0 < e.dedup_threshold < 1.0
        # one measurement of the fused kernel, at the first candidates
        assert calls[0] == ("fused", 64, "wq")
        assert [c[0] for c in calls].count("fused") == 1
        assert all(c[2] == (method == "lookup_c") for c in calls
                   if c[0] == "dedup")


@pytest.mark.parametrize("kk", [1, 2])
@pytest.mark.parametrize("scenario", list(PRUNE_SCENARIOS))
def test_tune_pruned_equals_reference(scenario, kk):
    want_thr = {"pruned always": 0.0, "pruned never": 2.0}
    for bucket, batch in ((64, 4), (320, 32), (16, 2)):
        sc = dict(PRUNE_SCENARIOS[scenario])
        sc["vertical"] = sc["fused"]
        e, calls = tune_both(kk, "lookup_p", bucket, batch, sc)
        assert e.term_block == min(tat.PRUNE_TUNE_CHUNK, bucket)
        if scenario in want_thr:
            assert e.dedup_threshold == want_thr[scenario]
        elif bucket == 320:                      # ten chunks
            assert 0.0 < e.dedup_threshold < 1.0
        # k=1 prices the fused lookup, k>1 the vertical gather path
        assert [c[0] for c in calls] == (["fused"] if kk == 1 else ["add"])


@pytest.mark.parametrize("method", ["vertical", "unpack"])
def test_tune_add_equals_reference(method):
    for kk in (1, 3):
        e, calls = tune_both(kk, method, 96, 8, {method: 33e-6})
        assert e.cost_us == pytest.approx(33.0)
        assert calls == [("add", method, 64, 8)]


# --------------------------------------------------------------------------
# entry, observe and keys
# --------------------------------------------------------------------------

def both_tuners(**kw):
    jt = jat.KernelTuner(50_000, 4, 1, 3, jat.TuningCache(), **kw)
    tt = port_tuner(50_000, 4, 1, 3, tat.TuningCache(), **kw)
    return jt, tt


def put_both(jt, tt, key, e: tat.TunedEntry):
    tt.cache.put(key, e)
    jt.cache.put(key, as_jax(e))


def asdict_or_none(e):
    return None if e is None else dataclasses.asdict(e)


@pytest.mark.parametrize("prefer", [True, False])
def test_entry_live_preference_and_graft_equal_reference(prefer):
    jt, tt = both_tuners(enabled=False, comp_ratio=1.6)
    for t in (jt, tt):
        t.prefer_observed = prefer
    key = tt.key("lookup", 64, 4)
    assert key == jt.key("lookup", 64, 4)
    put_both(jt, tt, key, tat.TunedEntry("lookup", 64, 8, "wq", 90.0,
                                         dedup_threshold=0.3))
    put_both(jt, tt, tat.LIVE_PREFIX + key,
             tat.TunedEntry("lookup", 128, 8, "qw", 40.0, observed=True))
    # a live entry with a threshold of its own keeps it
    vkey = tt.key("lookup_c", 64, 4)
    assert vkey.endswith(".cr1.60")
    put_both(jt, tt, vkey, tat.TunedEntry("lookup_c", 64, 8, "wq", 80.0,
                                          dedup_threshold=0.6))
    put_both(jt, tt, tat.LIVE_PREFIX + vkey,
             tat.TunedEntry("lookup_c", 64, 8, "wq", 70.0,
                            dedup_threshold=0.1, observed=True))
    # a live entry alone (no synthetic one) under a read-only tuner
    put_both(jt, tt, tat.LIVE_PREFIX + tt.key("unpack", 64, 4),
             tat.TunedEntry("unpack", 64, 8, "wq", 20.0, observed=True))
    for m in ("lookup", "lookup_c", "unpack", "vertical"):
        assert asdict_or_none(tt.entry(m, 64, 4)) == \
            asdict_or_none(jt.entry(m, 64, 4)), m
    costs = tt.costs(64, 4)
    assert {m: dataclasses.asdict(e) for m, e in costs.items()} \
        == {m: dataclasses.asdict(e) for m, e in jt.costs(64, 4).items()}
    assert (tt.cache.hits, tt.cache.misses) == (jt.cache.hits,
                                                jt.cache.misses)
    assert tt.tunes == jt.tunes == 0
    if prefer:
        assert costs["lookup"].observed
        assert costs["lookup"].dedup_threshold == 0.3       # grafted
        assert costs["lookup_c"].dedup_threshold == 0.1     # its own
        assert costs["unpack"].cost_us == 20.0
    else:
        assert not costs["lookup"].observed
        assert costs["lookup"].cost_us == 90.0
        assert "unpack" not in costs


def test_live_entry_suppresses_a_tune_alike():
    jt, tt = both_tuners(enabled=True)
    for t in (jt, tt):
        key = t.key("vertical", 128, 32)
        t.cache.put(tat.LIVE_PREFIX + key, (
            tat if t is tt else jat).TunedEntry("vertical", 64, 8, "wq",
                                                12.0, observed=True))
        assert t.entry("vertical", 128, 32).cost_us == 12.0
        assert t.tunes == 0


def test_observe_promotes_live_entries_alike(tmp_path):
    jt = jat.KernelTuner(50_000, 4, 1, 3,
                         jat.TuningCache(tmp_path / "j.json"), enabled=False)
    tt = port_tuner(50_000, 4, 1, 3, tat.TuningCache(tmp_path / "t.json"),
                    enabled=False)
    rng = np.random.default_rng(3)
    for i in range(40):
        method = ["lookup", "vertical", "dedup", "lookup_c", "lookup_p"][i % 5]
        kw = dict(word_block=int(rng.choice([64, 128])),
                  term_block=int(rng.choice([0, 16])),
                  grid_order=str(rng.choice(["wq", "qw"])))
        secs = float(rng.exponential(1e-4))
        for t in (jt, tt):
            t.live_min_samples = 3
            t.observe(method, 64, 4, secs, **kw)
        assert tt.observations == jt.observations
        assert {k: dataclasses.asdict(e) for k, e in tt.cache.entries.items()} \
            == {k: dataclasses.asdict(e) for k, e in jt.cache.entries.items()}
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert any(k.startswith(tat.LIVE_PREFIX) for k in tt.cache.entries)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory, small_corpus):
    """A dense k=1 index, a raw store and a rowdict store, on the CPU."""
    root = tmp_path_factory.mktemp("tune")
    p1 = IndexParams(1, 0.3, 15)
    dense = build_compact(small_corpus.doc_terms, p1, block_docs=32,
                          row_align=64, device=CPU)
    raw, _ = build_compact_streaming(small_corpus.doc_terms, root / "raw",
                                     p1, block_docs=32, device=CPU)
    docs = [small_corpus.doc_terms[i % 6] for i in range(48)]
    comp, _ = build_compact_streaming(docs, root / "comp",
                                      IndexParams(1, 0.03, 15),
                                      block_docs=128, codec="rowdict",
                                      device=CPU)
    assert comp.storage.dict_ratio() is not None
    return {"dense": dense, "raw": load_index_v2(root / "raw", device=CPU),
            "comp": load_index_v2(root / "comp", device=CPU),
            "comp path": root / "comp"}


def test_keys_of_real_indexes_equal_reference(indexes):
    from repro.core.store import load_index_v2 as jax_load_v2
    tt = tat.KernelTuner.for_index(indexes["comp"], enabled=False)
    jt = jat.KernelTuner.for_index(jax_load_v2(indexes["comp path"]),
                                   enabled=False)
    assert tt.device == torch.device(CPU)
    assert tt.comp_ratio == jt.comp_ratio
    for m in ("lookup", "lookup_c", "lookup_p", "vertical", "unpack"):
        assert tt.key(m, 128, 32) == jt.key(m, 128, 32)
    assert tt.key("lookup_c", 128, 32).endswith(f".cr{tt.comp_ratio:.2f}")
    assert ".cr" not in tt.key("lookup", 128, 32)
    # a raw index has no dict: lookup_c is never tuned nor returned
    raw = tat.KernelTuner.for_index(indexes["raw"], repeats=1,
                                    max_tune_rows=64, max_tune_blocks=1)
    assert raw.comp_ratio is None
    assert raw.entry("lookup_c", 64, 4) is None and raw.tunes == 0
    assert tuning_path(indexes["comp path"]).name == "tuning-torch.json"
    assert tuning_path(indexes["comp path"]).parent == indexes["comp path"]


TINY = dict(repeats=1, max_tune_rows=64, max_tune_blocks=1)


def test_persist_and_reopen_without_retuning(indexes, tmp_path):
    idx = indexes["dense"]
    path = tuning_path(tmp_path)
    tuner = tat.KernelTuner.for_index(idx, tat.TuningCache(path), **TINY)
    e = tuner.entry("lookup", 64, 4)
    assert e is not None and tuner.tunes == 1 and path.exists()
    assert tuner.entry("lookup", 64, 4) == e and tuner.tunes == 1
    again = tat.KernelTuner.for_index(idx, tat.TuningCache(path))
    assert again.entry("lookup", 64, 4) == e
    assert again.tunes == 0 and again.cache.hits == 1
    # the JAX package reads the port's file
    assert dataclasses.asdict(jat.TuningCache(path).get(tuner.key(
        "lookup", 64, 4))) == dataclasses.asdict(e)
    off = tat.KernelTuner.for_index(idx, enabled=False)
    assert off.costs(64, 4) == {} and off.tunes == 0
    assert off.entry("lookup_p", 64, 4) is None


def test_two_hash_index_has_no_fused_entries():
    t = port_tuner(5000, 4, 2, 3, **TINY)
    assert t.entry("lookup", 64, 4) is None
    assert t.entry("lookup_c", 64, 4) is None
    assert t.tunes == 0


# --------------------------------------------------------------------------
# Real tunes on the CPU: fields in range, never a choice timing decides
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method,kk", [("lookup", 1), ("lookup_c", 1),
                                       ("vertical", 1), ("unpack", 1),
                                       ("lookup_p", 1), ("lookup_p", 2),
                                       ("vertical", 2)])
def test_real_tune_on_the_cpu_gives_fields_in_range(method, kk):
    before = dict(tk.launches)
    t = port_tuner(5000, 4, kk, 3, comp_ratio=2.0, **TINY)
    bucket, batch = 96, 4
    e = t.entry(method, bucket, batch)
    assert t.tunes == 1 and t.cache.entries[t.key(method, bucket, batch)] == e
    assert e.method == method and not e.observed
    assert e.word_block == tat.DEFAULT_WORD_BLOCKS[0]
    assert e.grid_order == "wq"
    assert np.isfinite(e.cost_us) and e.cost_us > 0
    if method == "lookup_p":
        assert e.term_block == tat.PRUNE_TUNE_CHUNK
    else:
        assert e.term_block == tat.DEFAULT_TERM_BLOCK
    if method in ("lookup", "lookup_c", "lookup_p"):
        thr = e.dedup_threshold
        assert thr is None or thr == 2.0 or 0.0 <= thr <= 1.0
    else:
        assert e.dedup_threshold is None
    assert tk.launches == before          # plain versions only


def test_a_failing_kernel_raises_out_of_entry(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(ops, "bitslice_lookup_score_multi", broken)
    t = port_tuner(5000, 4, 1, 3, **TINY)
    with pytest.raises(RuntimeError, match="failed to launch"):
        t.entry("lookup", 64, 4)
    assert len(t.cache) == 0


@pytest.mark.parametrize("kw", [dict(repeats=0), dict(max_tune_rows=0),
                                dict(max_tune_blocks=0)])
def test_constructor_validates_every_knob(kw):
    with pytest.raises(ValueError):
        port_tuner(5000, 4, 1, 3, **kw)


# The JAX constructor's arguments that the port takes: all but the three
# knob-candidate tuples, which the port's kernels have no use for.
JAX_ARGS = [name for name in inspect.signature(
    jat.KernelTuner.__init__).parameters
    if name not in ("self", "word_blocks", "term_blocks", "grid_orders")]


@pytest.mark.parametrize("name", JAX_ARGS)
def test_constructor_takes_the_reference_argument(name):
    want = inspect.signature(jat.KernelTuner.__init__).parameters[name]
    got = inspect.signature(tat.KernelTuner.__init__).parameters[name]
    assert (got.kind, got.default) == (want.kind, want.default)
