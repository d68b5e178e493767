"""The port's single-host QueryServer against the JAX QueryServer, on the
CPU.

Both servers take the same requests on the same manual clock (only the
test advances it, so both flush the same micro-batches) over the same
indexes: a dense compact index (48 documents, k = 15, blocks of 32), its
raw v2 store of one block a shard, a rowdict store of a replicated
collection (blocks of 128) and a two-hash index. Every response must be
equal (result, status, method, batch size, cached flag, trace stages), and
so must the planner's ``dispatch_counts``, the profiler's records and the
metrics snapshot. The JAX server pads its tiles to a common height and the
port's does not, so the JAX side gets an unpadded ``DeviceTileCache`` here,
which makes the staged-byte counters comparable. The port's planner must
also make the JAX planner's choice over a grid of (bucket, batch,
threshold). Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import build_compact as jax_build_compact
from repro.core.store import load_index_v2 as jax_load_v2
from repro.core.store import save_index_v2 as jax_save_v2
from repro.data import make_corpus, make_queries
from repro.index import build_compact_streaming as jax_streaming
from repro.serve import QueryServer as JaxServer
from repro.serve import ServerConfig as JaxConfig
from repro.serve.planner import QueryPlanner as JaxPlanner

from repro_torch.core import index_from_numpy, load_index_v2
from repro_torch.serve import QueryServer, ServerConfig, Status
from repro_torch.serve.planner import QueryPlanner

torch.set_num_threads(2)

CPU = "cpu"


def carry(jax_index):
    lay = jax_index.layout
    return index_from_numpy(np.asarray(jax_index.storage.full_host()),
                            lay.row_offset, lay.block_width, lay.doc_slot,
                            lay.doc_n_terms, lay.block_docs, lay.n_docs,
                            jax_index.params.to_json(), device=CPU)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """kind -> (JAX index, port index), the corpus and the replicated
    collection's corpus."""
    root = tmp_path_factory.mktemp("serve")
    c = make_corpus(48, k=15, mean_length=400, sigma=1.0, seed=7)
    p1 = JaxParams(n_hashes=1, fpr=0.3, kmer=15)
    dense = jax_build_compact(c.doc_terms, p1, block_docs=32, row_align=64)
    jax_save_v2(dense, root / "raw", blocks_per_shard=1)
    two = jax_build_compact(c.doc_terms, JaxParams(n_hashes=2, fpr=0.3,
                                                   kmer=15),
                            block_docs=32, row_align=64)
    rc = make_corpus(24, k=15, mean_length=160, min_length=120, seed=3)
    comp, _ = jax_streaming([rc.doc_terms[i % 24] for i in range(144)],
                            root / "comp", JaxParams(1, 0.03, 15),
                            block_docs=128, blocks_per_shard=1,
                            codec="rowdict")
    out = {"dense": (dense, carry(dense)),
           "raw": (jax_load_v2(root / "raw"),
                   load_index_v2(root / "raw", device=CPU)),
           "comp": (comp, load_index_v2(root / "comp", device=CPU)),
           "k=2": (two, carry(two))}
    assert out["raw"][1].storage.n_shards > 1
    st = out["comp"][1].storage
    assert all(st.shard_codec(s) == "rowdict" for s in range(st.n_shards))
    assert st.dict_ratio() >= 1.25
    return c, rc, out


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _servers(world, kind, cfg: dict):
    jidx, tidx = world[2][kind]
    jclk, tclk = Clock(), Clock()
    js = JaxServer(jidx, JaxConfig(**cfg), clock=jclk)
    # the port's cache does not pad tiles: give the JAX server the same
    js.tiles = JaxCache(jidx.storage,
                        capacity_bytes=cfg.get("tile_cache_bytes"))
    js.tiles.observer = js._on_tile_event
    ts = QueryServer(tidx, ServerConfig(**cfg), clock=tclk, device=CPU)
    return (js, jclk), (ts, tclk)


def _summary(resp):
    r = resp.result
    return (resp.status.value, resp.method, resp.batch_size, resp.cached,
            None if r is None else (tuple(r.doc_ids.tolist()),
                                    tuple(r.scores.tolist()), r.n_terms,
                                    r.threshold),
            tuple(resp.stages or ()))


def _drive(server, clock, script):
    """Run a script of ("submit", pattern, kwargs) / ("tick", dt) /
    ("step",) / ("drain",) on one server; returns the request ids and the
    summarised responses in order of request id."""
    ids, responses = [], {}
    for op in script:
        if op[0] == "submit":
            ids.append(server.submit(op[1], **op[2]))
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "step":
            server.step()
        else:
            server.drain()
        responses.update(server.pop_responses())
    return ids, {rid: _summary(r) for rid, r in sorted(responses.items())}


def _profile(server):
    return [{k: v for k, v in rec.items() if k != "seconds"}
            for rec in server.profiler.records()]


def assert_same_serving(world, kind, cfg, script):
    (js, jclk), (ts, tclk) = _servers(world, kind, cfg)
    jids, jresp = _drive(js, jclk, script)
    tids, tresp = _drive(ts, tclk, script)
    assert tids == jids
    assert tresp == jresp
    assert dict(ts.planner.dispatch_counts) == dict(js.planner.dispatch_counts)
    assert _profile(ts) == _profile(js)
    assert dataclasses.asdict(ts.metrics.snapshot()) == \
        dataclasses.asdict(js.metrics.snapshot())
    for f in ("hits", "faults", "prefetched", "prefetch_hits",
              "raw_bytes_staged", "comp_bytes_staged"):
        assert getattr(ts.tiles, f) == getattr(js.tiles, f), f
    return ts, tresp


def _reads(docs, n_windows, per_window, length=120, stride=17):
    """Overlapping reads: ``per_window`` reads of ``length`` bases at
    ``stride`` offsets from each of the first ``n_windows`` documents."""
    out = []
    for d in docs[:n_windows]:
        out += [d[s:s + length] for s in range(0, stride * per_window, stride)
                if s + length <= len(d)]
    return out


def _mix(c, seed=19):
    qs, _ = make_queries(c, n_pos=4, n_neg=2, length=120, seed=seed)
    return qs + qs[:3]


def submit_all(patterns, **kw):
    return [("submit", p, kw) for p in patterns] + [("drain",)]


# --------------------------------------------------------------------------
# Batch paths: dedup on, off and gated, dense / paged / compressed
# --------------------------------------------------------------------------

NO_CACHE = dict(result_cache=0, row_cache=0)
DEDUP_CASES = {
    "always": dict(NO_CACHE, dedup_min_rate=0.0),
    "off": dict(NO_CACHE, dedup_min_rate=None),
    "default": dict(NO_CACHE),
    "gate 0.99": dict(NO_CACHE, dedup_min_rate=0.99),
}


@pytest.mark.parametrize("case", list(DEDUP_CASES))
@pytest.mark.parametrize("kind", ["dense", "raw"])
def test_batches_equal_reference(world, kind, case):
    c = world[0]
    script = (submit_all(_mix(c))
              + submit_all(_reads(c.documents, 2, 8)))
    ts, resp = assert_same_serving(world, kind, DEDUP_CASES[case], script)
    counts = ts.planner.dispatch_counts
    if case == "always":
        assert counts["dedup"] > 0 and "lookup" not in counts
    elif case in ("off", "gate 0.99"):
        assert "dedup" not in counts and counts["lookup"] > 0
    else:
        # overlapping reads clear the default rate of 0.5
        assert counts["dedup"] > 0
    assert all(r[0] == Status.OK.value for r in resp.values())


@pytest.mark.parametrize("case", ["always", "default", "off"])
def test_compressed_batches_equal_reference(world, case):
    rc = world[1]
    cfg = dict(DEDUP_CASES[case], compressed=True)
    script = (submit_all([d[10:130] for d in rc.documents[:6]])
              + submit_all(_reads(rc.documents, 2, 6)))
    ts, _ = assert_same_serving(world, "comp", cfg, script)
    counts = ts.planner.dispatch_counts
    if case == "off":
        assert "dedup_c" not in counts and counts["lookup_c"] > 0
    else:
        assert counts["dedup_c"] > 0
    assert ts.tiles.raw_bytes_staged == 0 and ts.tiles.comp_bytes_staged


def test_bounded_tile_cache_equals_reference(world):
    c = world[0]
    st = world[2]["raw"][1].storage
    cap = max(st.shard_nbytes(s) for s in range(st.n_shards))
    script = submit_all(_reads(c.documents, 3, 6)) + submit_all(_mix(c, 7))
    ts, _ = assert_same_serving(
        world, "raw", dict(NO_CACHE, tile_cache_bytes=cap), script)
    assert ts.tiles.faults > st.n_shards


def test_two_hash_index_equals_reference(world):
    c = world[0]
    script = (submit_all(_mix(c))
              + [("submit", c.documents[2][:200], {"top_k": 5}),
                 ("drain",)])
    ts, _ = assert_same_serving(world, "k=2", dict(NO_CACHE), script)
    assert set(ts.planner.dispatch_counts) <= {"unpack", "vertical"}


# --------------------------------------------------------------------------
# Fast paths, top-k, timers and backpressure
# --------------------------------------------------------------------------

def test_top_k_and_result_cache_equal_reference(world):
    c = world[0]
    qs = _mix(c)
    script = (submit_all(qs[:4], top_k=10)
              + submit_all(qs[:4], top_k=10)           # result-cache hits
              + submit_all(qs[:4], threshold=0.5)
              + submit_all(qs[:2], threshold=0.5))
    _, resp = assert_same_serving(world, "dense", {}, script)
    assert sum(r[1] == "cache" for r in resp.values()) == 6


def test_point_queries_and_row_cache_equal_reference(world):
    c = world[0]
    singles = [d[:15] for d in c.documents[:5]]          # one 15-mer each
    script = (submit_all(singles) + submit_all(singles[:3], top_k=3)
              + submit_all(singles[:2], threshold=1.0))
    for kind in ("dense", "raw"):
        _, resp = assert_same_serving(world, kind, dict(result_cache=0),
                                      script)
        methods = [r[1] for r in resp.values()]
        assert set(methods) == {"row_cache"}
        assert sum(r[3] for r in resp.values()) == 5      # row hits


def test_empty_queries_equal_reference(world):
    script = submit_all(["ACGT", ""] + [world[0].documents[0][:80]])
    assert_same_serving(world, "dense", {}, script)


def test_timers_deadlines_and_partial_flushes_equal_reference(world):
    c = world[0]
    qs = _mix(c)
    script = []
    for i, p in enumerate(qs + _reads(c.documents, 1, 6)):
        kw = {"deadline": 100.0 + 0.0005 * i} if i % 4 == 3 else {}
        script += [("submit", p, kw), ("tick", 0.0007), ("step",)]
    script += [("tick", 0.01), ("step",), ("drain",)]
    _, resp = assert_same_serving(
        world, "dense", dict(NO_CACHE, max_batch=4, max_wait_s=0.002),
        script)
    statuses = {r[0] for r in resp.values()}
    assert Status.DROPPED.value in statuses and Status.OK.value in statuses


def test_backpressure_equals_reference(world):
    c = world[0]
    script = submit_all(_mix(c)[:6] + _reads(c.documents, 1, 4))
    _, resp = assert_same_serving(world, "dense",
                                  dict(NO_CACHE, max_queued=3), script)
    assert sum(r[0] == Status.REJECTED.value for r in resp.values()) > 0


@pytest.mark.parametrize("kind", ["raw", "dense"])
def test_pruned_serving_equals_reference(world, kind):
    c = world[0]
    script = (submit_all(_mix(c), threshold=0.9)
              + submit_all(_reads(c.documents, 1, 4), threshold=0.9)
              + submit_all(_mix(c)[:3], top_k=4))
    ts, _ = assert_same_serving(
        world, kind, dict(NO_CACHE, pruned=True, prune_chunk=16,
                          prune_min_rate=0.1), script)
    assert ts.planner.dispatch_counts["lookup_p"] > 0


def test_reset_metrics_equals_reference(world):
    c = world[0]
    (js, jclk), (ts, tclk) = _servers(world, "dense", {})
    for server, clock in ((js, jclk), (ts, tclk)):
        _drive(server, clock, submit_all(_mix(c)))
        server.reset_metrics(clear_caches=True)
    script = submit_all(_mix(c))
    assert _drive(ts, tclk, script) == _drive(js, jclk, script)
    assert dict(ts.planner.dispatch_counts) == dict(js.planner.dispatch_counts)
    assert dataclasses.asdict(ts.metrics.snapshot()) == \
        dataclasses.asdict(js.metrics.snapshot())


# --------------------------------------------------------------------------
# The planner and the parts that are not ported
# --------------------------------------------------------------------------

PLANNER_CASES = {
    "default": {},
    "no dedup": dict(dedup_min_rate=None),
    "dedup 1.0": dict(dedup_min_rate=1.0),
    "dedup 0.2, word_block 32": dict(dedup_min_rate=0.2, word_block=32),
    "compressed": dict(compressed=True),
    "pruned": dict(pruned=True, prune_chunk=32),
    "pruned 0.9": dict(pruned=True, prune_chunk=64, prune_min_rate=0.9),
}


@pytest.mark.parametrize("case", list(PLANNER_CASES))
@pytest.mark.parametrize("kind", ["dense", "raw", "comp", "k=2"])
def test_planner_equals_reference_over_a_grid(world, kind, case):
    jidx, tidx = world[2][kind]
    kw = PLANNER_CASES[case]
    jp, tp = JaxPlanner(jidx, **kw), QueryPlanner(tidx, **kw)
    assert (tp.density, tp.dict_ratio, tp.compressed_enabled) == \
        (jp.density, jp.dict_ratio, jp.compressed_enabled)
    for bucket in (64, 96, 128, 192, 320):
        for batch in (1, 2, 4, 32):
            for thr in (None, 0.3, 0.8, 0.95, 1.0):
                got = tp.plan(bucket, batch, threshold=thr)
                want = jp.plan(bucket, batch, threshold=thr)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (bucket, batch, thr)


def test_tuner_and_autotune_raise(world):
    tidx = world[2]["dense"][1]
    with pytest.raises(NotImplementedError, match="A12"):
        QueryPlanner(tidx, tuner=object())
    for cfg in (ServerConfig(autotune=True),
                ServerConfig(tuning_cache="tuning.json")):
        with pytest.raises(NotImplementedError, match="A12"):
            QueryServer(tidx, cfg, device=CPU)
    jf = [f.name for f in dataclasses.fields(JaxConfig)]
    tf = [f.name for f in dataclasses.fields(ServerConfig)]
    assert tf == jf
    assert dataclasses.asdict(ServerConfig()) == \
        dataclasses.asdict(JaxConfig())


def test_server_refuses_an_index_on_another_device(world):
    tidx = world[2]["dense"][1]
    with pytest.raises(ValueError, match="lives on"):
        QueryServer(tidx, device="meta")
