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
threshold), untuned and with both planners reading the same seeded tuning
entries; and a server tuned on the CPU, reopened read-only from its cache
file, must serve as the JAX server reading that file does. Every
comparison is exact.
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
from repro.kernels import autotune as jat
from repro.serve import QueryServer as JaxServer
from repro.serve import ServerConfig as JaxConfig
from repro.serve.planner import QueryPlanner as JaxPlanner

from repro_torch.core import index_from_numpy, load_index_v2
from repro_torch.core import query as query_mod
from repro_torch.core.query import compile_pattern, select_hits
from repro_torch.core.store import tuning_path
from repro_torch.kernels import autotune as tat
from repro_torch.serve import QueryServer, ServerConfig, Status
from repro_torch.serve import server as server_mod
from repro_torch.serve.batcher import MicroBatch
from repro_torch.serve.request import QueryRequest
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
    """kind -> (JAX index, port index), the corpus, the replicated
    collection's corpus and the directory holding the stores."""
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
    comp1, _ = jax_streaming([rc.doc_terms[i % 24] for i in range(144)],
                             root / "comp dense", JaxParams(1, 0.03, 15),
                             block_docs=128, blocks_per_shard=2,
                             codec="rowdict")
    out = {"dense": (dense, carry(dense)),
           "raw": (jax_load_v2(root / "raw"),
                   load_index_v2(root / "raw", device=CPU)),
           "comp": (comp, load_index_v2(root / "comp", device=CPU)),
           "comp dense": (comp1, load_index_v2(root / "comp dense",
                                               device=CPU)),
           "k=2": (two, carry(two))}
    assert out["raw"][1].storage.n_shards > 1
    st = out["comp"][1].storage
    assert all(st.shard_codec(s) == "rowdict" for s in range(st.n_shards))
    assert st.dict_ratio() >= 1.25
    st = out["comp dense"][1].storage
    assert st.n_shards == 1 and st.shard_codec(0) == "rowdict"
    assert st.dict_ratio() >= 1.25
    return c, rc, out, root


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


def assert_same_serving(world, kind, cfg, script, prepare=None):
    """Both servers over ``kind`` with ``cfg`` run ``script`` and must agree
    on everything; ``prepare(js, ts)`` runs first, when given."""
    (js, jclk), (ts, tclk) = _servers(world, kind, cfg)
    if prepare is not None:
        prepare(js, ts)
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
    plans = _dedup_plan_counts(ts)
    if case == "always":
        assert counts["dedup"] > 0 and "lookup" not in counts
    elif case in ("off", "gate 0.99"):
        assert "dedup" not in counts and counts["lookup"] > 0
    else:
        # overlapping reads clear the default rate of 0.5
        assert counts["dedup"] > 0
    # the gate builds a plan for the batches that take the dedup pair
    # alone, and skips it for the others
    if case == "off":
        assert plans == {}
    else:
        assert plans.get("built", 0) == _dedup_batches(ts)
        assert (plans.get("skipped", 0) > 0) == (case != "always")
    assert all(r[0] == Status.OK.value for r in resp.values())


def _dedup_batches(server) -> int:
    """Batches scored by the dedup pair (one profiler record each)."""
    return sum(r["method"] in ("dedup", "dedup_c")
               for r in server.profiler.records())


def _dedup_plan_counts(server) -> dict:
    """{outcome: batches} of ``serve_dedup_plan_total``."""
    fam = server.metrics.registry.get("serve_dedup_plan_total")
    return ({} if fam is None else
            {labels[0]: c.value for labels, c in fam.children()})


@pytest.mark.parametrize("case", ["below", "above"])
def test_dedup_gate_builds_the_plan_only_past_the_gate(world, monkeypatch,
                                                       case):
    """A dense batch of reads from many documents stays below the gate
    of 0.5 without a plan; a batch of overlapping reads of one document
    clears it and builds the plan once, in the shard loop over the dense
    store's one shard. Both count their outcome."""
    c = world[0]
    tidx = world[2]["dense"][1]
    calls = []
    real = query_mod.plan_dedup_batch

    def plan(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(query_mod, "plan_dedup_batch", plan)
    ts = QueryServer(tidx, ServerConfig(**NO_CACHE), clock=Clock(),
                     device=CPU)
    pats = (_mix(c)[:8] if case == "below"
            else _reads(c.documents, 1, 8))
    terms = [compile_pattern(p, tidx.params) for p in pats]
    reqs = [QueryRequest(i, t, t.shape[0], 0.8, submitted_at=100.0,
                         bucket=128) for i, t in enumerate(terms)]
    ts.score_batch(MicroBatch(128, reqs, seq=1))
    got = ts.pop_responses()
    want = QueryServer(tidx, ServerConfig(**NO_CACHE, dedup_min_rate=None),
                       clock=Clock(), device=CPU)
    want.score_batch(MicroBatch(128, reqs, seq=1))
    for rid, r in want.pop_responses().items():
        assert (got[rid].result.doc_ids.tobytes(),
                got[rid].result.scores.tobytes()) == \
            (r.result.doc_ids.tobytes(), r.result.scores.tobytes())
    if case == "below":
        assert calls == [] and _dedup_plan_counts(ts) == {"skipped": 1}
        assert {r.method for r in got.values()} == {"lookup"}
    else:
        assert len(calls) == 1 and _dedup_plan_counts(ts) == {"built": 1}
        assert {r.method for r in got.values()} == {"dedup"}


# case -> (store, dedup case): the paged rowdict store, or the rowdict
# store of one shard, the shard loop's one-shard case
COMP_CASES = {**{c: ("comp", c) for c in ("always", "default", "off")},
              **{f"dense {c}": ("comp dense", c) for c in ("always", "off")}}


@pytest.mark.parametrize("case", list(COMP_CASES))
def test_compressed_batches_equal_reference(world, case):
    rc = world[1]
    kind, case = COMP_CASES[case]
    cfg = dict(DEDUP_CASES[case], compressed=True)
    script = (submit_all([d[10:130] for d in rc.documents[:6]])
              + submit_all(_reads(rc.documents, 2, 6)))
    ts, _ = assert_same_serving(world, kind, cfg, script)
    counts = ts.planner.dispatch_counts
    if case == "off":
        assert "dedup_c" not in counts and counts["lookup_c"] > 0
        assert _dedup_plan_counts(ts) == {}
    else:
        assert counts["dedup_c"] > 0
        assert _dedup_plan_counts(ts).get("built") == _dedup_batches(ts)
    assert ts.tiles.raw_bytes_staged == 0 and ts.tiles.comp_bytes_staged


def test_bounded_tile_cache_equals_reference(world):
    """A cache of one tile: the JAX server restages every shard a batch;
    the port's stages the first tile once and reads each batch's rows of
    the other shards from the store (the row-gather route). The answers,
    dispatches and profiler records are the JAX server's."""
    c = world[0]
    st = world[2]["raw"][1].storage
    cap = max(st.shard_nbytes(s) for s in range(st.n_shards))
    script = submit_all(_reads(c.documents, 3, 6)) + submit_all(_mix(c, 7))
    (js, jclk), (ts, tclk) = _servers(
        world, "raw", dict(NO_CACHE, tile_cache_bytes=cap))
    jids, jresp = _drive(js, jclk, script)
    tids, tresp = _drive(ts, tclk, script)
    assert tids == jids and tresp.keys() == jresp.keys()
    for rid, r in tresp.items():
        # the traces differ only in the tile stagings ("tile_fetch")
        stages = [tuple(x for x in resp[5] if x != "tile_fetch")
                  for resp in (r, jresp[rid])]
        assert r[:5] == jresp[rid][:5] and stages[0] == stages[1]
    assert dict(ts.planner.dispatch_counts) == dict(js.planner.dispatch_counts)
    assert _profile(ts) == _profile(js)
    assert js.tiles.faults > st.n_shards
    assert (ts.tiles.faults, ts.tiles.evictions) == (1, 0)
    v = ts.tile_gathers.visits
    assert v["staged"] == 1 and v["gathered"] == (st.n_shards - 1) * (
        v["resident"] + 1) and ts.tile_gathers.rows_gathered > 0


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
# Selection: on the index's device for dense threshold batches (the port's
# own path; JAX selects every batch on the host), else on the host
# --------------------------------------------------------------------------

def _select_counts(server) -> dict:
    """{"card": n, <host reason>: n} from the server's registry."""
    reg = server.metrics.registry
    card = reg.get("serve_select_card_total")
    host = reg.get("serve_select_host_total")
    out = {"card": card.value} if card is not None else {}
    if host is not None:
        out.update({labels[0]: c.value for labels, c in host.children()})
    return out


# name -> (queries in the batch, threshold, scores drawn from [lo, hi) as
# shares of each query's n_terms)
RANDOM_SELECT = {
    "ties": (4, 0.8, (0.7, 1.01)),
    "none above": (3, 1.0, (0.0, 0.99)),
    "Q = 3": (3, 0.5, (0.3, 1.01)),
    "Q = 5": (5, 0.7, (0.5, 1.01)),
    "Q = 1": (1, 0.6, (0.3, 1.01)),
}


@pytest.mark.parametrize("case", list(RANDOM_SELECT))
def test_card_selection_equals_select_hits_on_random_scores(world, case):
    """A dense batch's scores replaced by a random matrix with many ties
    (the planner's score fns stubbed): every response equals select_hits
    on that matrix's rows in document order, byte for byte, and every
    request counts as selected on the device."""
    Q, thr, (lo, hi) = RANDOM_SELECT[case]
    c = world[0]
    tidx = world[2]["dense"][1]
    lay = tidx.layout
    width = lay.n_blocks * lay.doc_words * 32
    patterns = [d[:120] for d in c.documents[:Q]]
    ells = [compile_pattern(p, tidx.params).shape[0] for p in patterns]
    rng = np.random.default_rng(Q + len(case))
    q_pad = 1 if Q == 1 else 1 << (Q - 1).bit_length()
    scores = np.zeros((q_pad, width), np.int32)
    for i, e in enumerate(ells):
        scores[i] = rng.integers(int(lo * e), int(hi * e) + 1, size=width)
    ts = QueryServer(tidx, ServerConfig(**NO_CACHE, dedup_min_rate=None),
                     clock=Clock(), device=CPU)
    ts.planner.score_fns = lambda plan, kind: ({
        "batch": lambda arena, offs, widths, terms, n_valid:
            torch.from_numpy(scores[: terms.shape[0]]),
        "single": lambda arena, offs, widths, terms, n_valid:
            torch.from_numpy(scores[0])}[kind], None)
    ids = [ts.submit(p, threshold=thr) for p in patterns]
    ts.drain()
    got = ts.pop_responses()
    for i, rid in enumerate(ids):
        want = select_hits(scores[i][np.asarray(lay.doc_slot)], ells[i], thr)
        r = got[rid].result
        assert got[rid].batch_size == Q
        assert (r.n_terms, r.threshold) == (want.n_terms, want.threshold)
        for a, b in ((r.doc_ids, want.doc_ids), (r.scores, want.scores)):
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
    assert _select_counts(ts) == {"card": Q}
    hits = sum(got[rid].result.doc_ids.size for rid in ids)
    assert hits == 0 if case == "none above" else hits > 0
    if case == "ties":
        s0 = got[ids[0]].result.scores
        assert (np.diff(s0) == 0).any()


def test_a_batched_request_without_terms_selects_nothing(world):
    """``submit`` answers a query without terms at once; scored in a
    batch beside others (as ``score_batch`` takes any micro-batch), it
    gets the cutoff no score reaches and ``select_hits``'s empty result,
    and the others their own."""
    c = world[0]
    tidx = world[2]["dense"][1]
    ts = QueryServer(tidx, ServerConfig(**NO_CACHE), clock=Clock(),
                     device=CPU)
    terms = [compile_pattern(d[:120], tidx.params) for d in c.documents[:2]]
    terms.insert(1, np.zeros((0, 2), np.uint32))
    reqs = [QueryRequest(i, t, t.shape[0], 0.8, submitted_at=100.0,
                         bucket=128) for i, t in enumerate(terms)]
    ts.score_batch(MicroBatch(128, reqs, seq=1))
    got = ts.pop_responses()
    empty = select_hits(np.zeros(0, np.int32), 0, 0.8)
    r = got[1].result
    assert (r.doc_ids.tobytes(), r.scores.tobytes(), r.n_terms,
            r.threshold) == (empty.doc_ids.tobytes(), empty.scores.tobytes(),
                             0, 0)
    assert got[0].result.doc_ids.size and got[2].result.doc_ids.size
    assert _select_counts(ts) == {"card": 3}


def test_overflowing_hit_lists_take_the_host_path(world, monkeypatch):
    """With room for one hit a request, every request with more copies
    its own score row: the answers stay the JAX server's."""
    monkeypatch.setattr(server_mod, "SELECT_CAP", 1)
    c = world[0]
    script = (submit_all(_mix(c), threshold=0.3)
              + submit_all(_reads(c.documents, 2, 6), threshold=0.3))
    ts, resp = assert_same_serving(world, "dense", dict(NO_CACHE), script)
    counts = _select_counts(ts)
    many = sum(len(r[4][0]) > 1 for r in resp.values())
    assert many > 0 and counts["overflow"] == many
    assert counts["card"] + counts["overflow"] == len(resp)


@pytest.mark.parametrize("case", ["top_k", "paged", "pruned", "point"])
def test_host_selections_are_counted_with_unchanged_answers(world, case):
    c = world[0]
    qs = _mix(c)
    kind, cfg = "dense", dict(NO_CACHE)
    if case == "top_k":
        script = (submit_all(qs[:4], top_k=5)
                  + submit_all(qs[4:7], threshold=0.8))
        want = {"top_k": 4, "card": 3}
    elif case == "paged":
        # a paged batch's scores are selected on the device since the
        # row-gather route: no host selection is left to count
        kind, script = "raw", submit_all(qs)
        want = {"card": len(qs)}
    elif case == "pruned":
        cfg = dict(NO_CACHE, pruned=True, prune_chunk=16, prune_min_rate=0.1)
        script = submit_all(qs, threshold=0.9)
        want = None
    else:
        cfg = dict(result_cache=0)
        script = submit_all([d[:15] for d in c.documents[:5]])
        want = {"point": 5}
    ts, resp = assert_same_serving(world, kind, cfg, script)
    counts = _select_counts(ts)
    if want is None:
        assert counts["pruned"] == ts.planner.dispatch_counts["lookup_p"] > 0
        assert sum(counts.values()) == len(resp)
    else:
        assert counts == want
    assert all(r[0] == Status.OK.value for r in resp.values())


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


# shapes of the grid that get entries; the others miss (heuristics apply)
TUNED_SHAPES = ((64, 2), (96, 1), (128, 32), (128, 4), (192, 4), (320, 32),
                (320, 1))


def seeded_tuners(jidx, tidx, seed):
    """Read-only JAX and port tuners over equal seeded caches: entries for
    every tunable method and lookup_p at TUNED_SHAPES (some left out),
    dedup thresholds 0.25, 2.0, None and 0.6, prune break-evens 0.0, 0.4,
    2.0 and None, and one live entry."""
    jt = jat.KernelTuner.for_index(jidx, jat.TuningCache(), enabled=False)
    tt = tat.KernelTuner.for_index(tidx, tat.TuningCache(), enabled=False)
    rng = np.random.default_rng(seed)
    dedup = (0.25, 2.0, None, 0.6)
    prune = (0.0, 0.4, 2.0, None)

    def put(key, e):
        tt.cache.put(key, e)
        jt.cache.put(key, jat.TunedEntry(**dataclasses.asdict(e)))

    for bucket, batch in TUNED_SHAPES:
        for m in tat.TUNABLE_METHODS + ("lookup_p",):
            if rng.random() < 0.15:
                continue
            key = tt.key(m, bucket, batch)
            assert key == jt.key(m, bucket, batch)
            thr = (dedup[rng.integers(4)] if m in ("lookup", "lookup_c")
                   else prune[rng.integers(4)] if m == "lookup_p" else None)
            put(key, tat.TunedEntry(
                m, int(rng.choice([64, 128, 256])),
                int(rng.choice([16, 32, 64] if m == "lookup_p" else [8, 16])),
                str(rng.choice(["wq", "qw"])), float(rng.uniform(5, 100)),
                dedup_threshold=thr))
    live = tt.key("lookup", 128, 32)
    put(tat.LIVE_PREFIX + live, tat.TunedEntry("lookup", 128, 8, "qw", 1.0,
                                               observed=True))
    return jt, tt


@pytest.mark.parametrize("tuned", [False, True], ids=["untuned", "tuned"])
@pytest.mark.parametrize("case", list(PLANNER_CASES))
@pytest.mark.parametrize("kind", ["dense", "raw", "comp", "k=2"])
def test_planner_equals_reference_over_a_grid(world, kind, case, tuned):
    jidx, tidx = world[2][kind]
    kw = PLANNER_CASES[case]
    jt = tt = None
    if tuned:
        jt, tt = seeded_tuners(jidx, tidx, seed=len(kind) * 7 + len(case))
    jp = JaxPlanner(jidx, tuner=jt, **kw)
    tp = QueryPlanner(tidx, tuner=tt, **kw)
    assert (tp.density, tp.dict_ratio, tp.compressed_enabled) == \
        (jp.density, jp.dict_ratio, jp.compressed_enabled)
    for bucket in (64, 96, 128, 192, 320):
        for batch in (1, 2, 4, 32):
            for thr in (None, 0.3, 0.8, 0.95, 1.0):
                got = tp.plan(bucket, batch, threshold=thr)
                want = jp.plan(bucket, batch, threshold=thr)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (bucket, batch, thr)
    if tuned:
        assert tt.tunes == jt.tunes == 0
        assert (tt.cache.hits, tt.cache.misses) == (jt.cache.hits,
                                                    jt.cache.misses)
        assert tt.cache.hits > 0


def test_server_config_fields_equal_reference(world):
    jf = [f.name for f in dataclasses.fields(JaxConfig)]
    tf = [f.name for f in dataclasses.fields(ServerConfig)]
    assert tf == jf
    assert dataclasses.asdict(ServerConfig()) == \
        dataclasses.asdict(JaxConfig())
    tidx = world[2]["dense"][1]
    assert QueryServer(tidx, device=CPU).tuner is None
    for cfg, enabled in ((ServerConfig(autotune=True), True),
                         (ServerConfig(tuning_cache="unused.json"), False)):
        server = QueryServer(tidx, cfg, device=CPU)
        assert server.tuner.enabled is enabled
        assert server.planner.tuner is server.profiler.tuner is server.tuner
        assert server.tuner.device == torch.device(CPU)


@pytest.mark.parametrize("kind", ["dense", "comp"])
def test_tuned_server_serves_measured_config(world, kind, tmp_path):
    """Tune once on the CPU into a cache file, then reopen read-only: the
    port's server and the JAX server, both reading that file, plan alike
    and answer alike without tuning, and their results equal the untuned
    server's. Live costs are kept from steering (prefer_observed off)."""
    c, rc, root = world[0], world[1], world[3]
    jidx, tidx = world[2][kind]
    # the tuning server gets an index of its own: a store keeps the tiles
    # it decodes, and the servers compared below must find them cold alike
    own = (load_index_v2(root / "comp", device=CPU) if kind == "comp"
           else carry(jidx))
    if kind == "comp":
        script = (submit_all([d[10:130] for d in rc.documents[:6]])
                  + submit_all(_reads(rc.documents, 2, 6)))
    else:
        script = submit_all(_mix(c)) + submit_all(_reads(c.documents, 2, 8))
    cfg = dict(NO_CACHE, compressed=kind == "comp")
    path = tuning_path(tmp_path)
    clock = Clock()
    s1 = QueryServer(own, ServerConfig(**cfg, autotune=True,
                                        tuning_cache=str(path)),
                     clock=clock, device=CPU)
    s1.tuner.repeats = 1
    s1.tuner.max_tune_rows = 64
    s1.tuner.max_tune_blocks = 1
    s1.tuner.prefer_observed = False
    _, tuned = _drive(s1, clock, script)
    assert s1.tuner.tunes > 0 and path.exists()

    def read_only(js, ts):
        for t in (js.tuner, ts.tuner):
            assert not t.enabled
            t.prefer_observed = False

    ts, reopened = assert_same_serving(
        world, kind, dict(cfg, tuning_cache=str(path)), script,
        prepare=read_only)
    assert ts.tuner.tunes == 0 and ts.tuner.cache.hits > 0
    untuned = QueryServer(tidx, ServerConfig(**cfg), clock=Clock(),
                          device=CPU)
    _, base = _drive(untuned, Clock(), script)
    for got in (tuned, reopened):
        assert {rid: r[4] for rid, r in got.items()} == \
            {rid: r[4] for rid, r in base.items()}
    assert all(r[0] == Status.OK.value for r in reopened.values())


def test_server_refuses_an_index_on_another_device(world):
    tidx = world[2]["dense"][1]
    with pytest.raises(ValueError, match="lives on"):
        QueryServer(tidx, device="meta")
