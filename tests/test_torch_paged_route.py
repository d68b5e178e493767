"""The row-gather route of the port's paged serving path, on the CPU.

A seeded compact index (blocks of 32 documents) is written block by block
with ``ShardStoreWriter`` into a store of one block a shard and served out
of core, through a tile cache that holds none, some or all of the tiles.
Every answer must equal the resident ``QueryServer``'s over the same
documents and a plain scorer written here in plain ``torch``: it rebuilds
each document's Bloom filter from the document's terms (a murmur3 mix of
its own, the index's seeds) and counts the query terms whose k bits are
all set. Besides: a batch over more shards than the cache holds evicts
nothing and reads exactly the unique rows of the shards that are not
resident, a route stages the shards whose rows cost a tile, and faults
reuse the staging buffers. The grouped launch (every resident raw shard of
a k = 1 lookup dispatch in one launch over a block table): its slot scores
equal the JAX engine's over the same store, in both forms and with padded
queries, its table follows the tile cache's residency, refuses a block
whose rows pass its tile, and the server counts the shards it scored."""
import gc
import math
import weakref

import numpy as np
import pytest
import torch

from repro.core import QueryEngine as JaxEngine
from repro.core import store as jax_store

from repro_torch.core import IndexParams, build_compact, load_index_v2
from repro_torch.core import query as q
from repro_torch.core.arena import DeviceTileCache
from repro_torch.core.query import RowGatherRoute, compile_pattern
from repro_torch.core.store import ShardStoreWriter
from repro_torch.data import make_corpus
from repro_torch.kernels import bitslice_score as kb
from repro_torch.kernels import ops
from repro_torch.serve import QueryServer, ServerConfig

torch.set_num_threads(2)

CPU = "cpu"
K = 15
NO_CACHE = dict(result_cache=0, row_cache=0)
M32 = 0xFFFFFFFF


# -- the plain scorer ---------------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def plain_hash(terms: np.ndarray, seed: int) -> torch.Tensor:
    """murmur3's mix of a packed term's two words and its fmix32, in int64
    arithmetic masked to 32 bits: uint32 [n, 2] -> int64 [n]."""
    t = torch.from_numpy(np.asarray(terms, dtype=np.uint32).astype(np.int64))
    h = torch.full((t.shape[0],), ((seed * 0x9E3779B9) & M32) ^ 0x2545F491,
                   dtype=torch.int64)
    for word in (t[:, 0], t[:, 1]):
        k = (_rotl((word * 0xCC9E2D51) & M32, 15) * 0x1B873593) & M32
        h = (_rotl(h ^ k, 13) * 5 + 0xE6546B64) & M32
    h = h ^ 8
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def plain_filters(doc_terms, layout, n_hashes: int) -> list:
    """Each document's Bloom filter, bool [its block's width]."""
    out = []
    for d, terms in enumerate(doc_terms):
        w = int(layout.block_width[int(layout.doc_slot[d])
                                   // layout.block_docs])
        bits = torch.zeros(w, dtype=torch.bool)
        for j in range(n_hashes):
            bits[plain_hash(terms, j) % w] = True
        out.append(bits)
    return out


def plain_scores(filters, n_hashes: int, query: np.ndarray) -> np.ndarray:
    """Each document's count of the query's terms whose filter bits are
    all set: int64 [n_docs]."""
    hashes = [plain_hash(query, j) for j in range(n_hashes)]
    out = np.zeros(len(filters), dtype=np.int64)
    for d, bits in enumerate(filters):
        hit = torch.ones(query.shape[0], dtype=torch.bool)
        for h in hashes:
            hit &= bits[h % bits.shape[0]]
        out[d] = int(hit.sum())
    return out


def plain_answer(scores: np.ndarray, n_terms: int, threshold: float,
                 top_k: int = 0):
    """(doc ids, scores) best first, ties by ascending id."""
    order = sorted(range(scores.shape[0]), key=lambda d: (-scores[d], d))
    if top_k:
        keep = order[:top_k]
    else:
        cut = max(1, math.ceil(threshold * n_terms))
        keep = [d for d in order if scores[d] >= cut]
    return keep, [int(scores[d]) for d in keep]


# -- the stores ----------------------------------------------------------------

def _write_store(index, path):
    arena = index.storage.full_host()
    w = ShardStoreWriter(path, index.layout, index.params, blocks_per_shard=1)
    for s in range(w.n_shards):
        r0, r1 = w.row_starts[s], w.row_starts[s + 1]
        w.write_shard(s, np.ascontiguousarray(arena[r0:r1]))
    w.finalize()
    return load_index_v2(path, device=CPU)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """n_hashes -> (corpus, resident index, paged index over its store,
    the documents' plain filters); "root" -> the stores' directory."""
    root = tmp_path_factory.mktemp("paged-route")
    c = make_corpus(160, k=K, mean_length=1500, sigma=0.5, seed=11)
    out = {"root": root}
    for k in (1, 2):
        dense = build_compact(c.doc_terms, IndexParams(n_hashes=k, fpr=0.3,
                                                       kmer=K),
                              block_docs=32, device=CPU)
        paged = _write_store(dense, root / f"k{k}")
        assert paged.storage.n_shards == dense.layout.n_blocks == 5
        out[k] = (c, dense, paged,
                  plain_filters(c.doc_terms, paged.layout, k))
    return out


@pytest.fixture(scope="module")
def jax_paged(world):
    """The JAX package's index over the k = 1 store's files."""
    return jax_store.load_index_v2(world["root"] / "k1")


def _cap(storage, share: str):
    """The tile budget for a resident share: none, the first two of the
    five tiles, or every tile (unbounded)."""
    sizes = [storage.shard_nbytes(s) for s in range(storage.n_shards)]
    return {"none": 0, "some": sizes[0] + sizes[1], "all": None}[share]


def _patterns(c, rng):
    """Overlapping reads of one document (a batch the planner sends to
    the dedup pair), reads of many documents with substitutions, random
    reads, a longer read and a single short one (code arrays)."""
    docs = [d for d in c.documents if d.shape[0] >= 200]
    overlapping = [docs[0][s:s + 60] for s in range(0, 120, 15)]
    out = []
    for d in docs[1:40:3]:
        r = d[20:90].copy()
        for p in rng.choice(r.shape[0], size=2, replace=False):
            r[p] = (r[p] + 1) % 4
        out.append(r)
    out += [rng.integers(0, 4, size=70, dtype=np.uint8) for _ in range(3)]
    return [overlapping, out, [docs[1][:200]]]


def _serve(server, groups, threshold, top_k_every=0):
    """Each group of patterns submitted, then drained; [(result, top_k)]
    in order."""
    out = []
    for patterns in groups:
        ids = []
        for i, p in enumerate(patterns):
            tk = 3 if top_k_every and i % top_k_every == 4 else None
            ids.append((server.submit(p, threshold=threshold, top_k=tk), tk))
        server.drain()
        got = server.pop_responses()
        out += [(got[rid].result, tk) for rid, tk in ids]
    return out


CASES = [(share, k, thr) for share in ("none", "some", "all")
         for k in (1, 2) for thr in (0.5, 0.9)]


@pytest.mark.parametrize("share,k,thr", CASES,
                         ids=[f"{s}-k{k}-{t}" for s, k, t in CASES])
def test_paged_answers_equal_resident_and_plain(world, share, k, thr):
    c, dense, paged, filters = world[k]
    rng = np.random.default_rng(len(share) * 10 + k)
    pats = _patterns(c, rng)
    cfg = dict(NO_CACHE, tile_cache_bytes=_cap(paged.storage, share))
    ps = QueryServer(paged, ServerConfig(**cfg), device=CPU)
    ps.warm_tiles()
    rs = QueryServer(dense, ServerConfig(**NO_CACHE), device=CPU)
    resident = {"none": 0, "some": 2, "all": 5}[share]
    assert len(ps.tiles) == resident
    got = _serve(ps, pats, thr, top_k_every=5)
    want = _serve(rs, pats, thr, top_k_every=5)
    for (g, tk), (w, _), p in zip(got, want, sum(pats, [])):
        for a, b in ((g.doc_ids, w.doc_ids), (g.scores, w.scores)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)
        q = compile_pattern(p, paged.params)
        ids, scores = plain_answer(
            plain_scores(filters, k, q), q.shape[0], thr,
            tk or 0)
        assert g.doc_ids.tolist() == ids and g.scores.tolist() == scores
    v = ps.tile_gathers.visits
    n_dispatch = sum(v.values()) // 5
    assert v["resident"] == resident * n_dispatch
    assert v["gathered"] == (5 - resident) * n_dispatch
    assert v["staged"] == 0 and ps.tiles.evictions == 0
    assert (ps.tile_gathers.rows_gathered > 0) == (resident < 5)
    methods = set(ps.planner.dispatch_counts)
    assert methods == set(rs.planner.dispatch_counts)
    if k == 1:
        assert {"dedup", "lookup"} <= methods
    reg = ps.metrics.registry
    assert reg.get("serve_select_card_total").value + \
        reg.get("serve_select_host_total").labels("top_k").value == \
        len(sum(pats, []))
    assert reg.get("serve_tile_rows_gathered_total").value == \
        ps.tile_gathers.rows_gathered
    assert reg.get("serve_tile_gathered_bytes_total").value == \
        ps.tile_gathers.rows_gathered * paged.storage.shape[1] * 4
    assert reg.get("serve_tile_gather_seconds").sum == pytest.approx(
        ps.tile_gathers.gather_s)


def test_a_scan_past_the_cache_evicts_nothing_and_reads_unique_rows(world):
    """A cache of one tile, warmed: one batch over the five shards reads
    from the store, on the host, the batch's unique rows of the other four
    (counted here from the plain hash), stages and evicts nothing."""
    c, _, paged, _ = world[1]
    st, lay = paged.storage, paged.layout
    cap = st.shard_nbytes(0)
    ps = QueryServer(paged, ServerConfig(**NO_CACHE, tile_cache_bytes=cap,
                                         max_batch=16, dedup_min_rate=None),
                     device=CPU)
    assert ps.warm_tiles() == [0]
    assert ps.tiles.resident_shards == (0,)
    faults = ps.tiles.faults
    pats = [d[:70] for d in c.documents[:16]]
    _serve(ps, [pats], 0.8)
    assert ps.metrics.n_batches == 1
    rows = set()
    for p in pats:
        h = plain_hash(compile_pattern(p, paged.params), 0).numpy()
        for b in range(1, lay.n_blocks):
            rows |= set((h % int(lay.block_width[b])
                         + int(lay.row_offset[b])).tolist())
    assert ps.tile_gathers.rows_gathered == len(rows)
    assert ps.tile_gathers.bytes_gathered == len(rows) * st.shape[1] * 4
    assert ps.tile_gathers.visits == {"resident": 1, "gathered": 4,
                                      "staged": 0}
    assert ps.tiles.faults == faults and ps.tiles.evictions == 0
    visits = ps.metrics.registry.get("serve_shard_visits_total")
    assert {lab[0]: ch.value for lab, ch in visits.children()} == \
        {"resident": 1, "gathered": 4, "staged": 0}


def test_two_faults_reuse_one_staging_buffer(world):
    """The tallest tile first, then three others: the two staging buffers
    are allocated once each and taken in turn, so the first and the third
    fault reuse one buffer's memory, and each tile equals its shard."""
    _, _, paged, _ = world[1]
    st = paged.storage
    order = sorted(range(st.n_shards), key=st.shard_nbytes, reverse=True)
    cache = DeviceTileCache(st, capacity_bytes=None)
    tiles, ptrs = [], []
    for s in order[:4]:
        tiles.append(cache.get(s))
        ptrs.append(cache._staging[1 - cache._turn].data_ptr())
    assert cache.faults == 4 and cache.staging_allocs == 2
    assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]
    for s, t in zip(order[:4], tiles):
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      st.shard_host(s))


@pytest.mark.parametrize("promote", ["never", "some", "all"])
@pytest.mark.parametrize("share", ["none", "some"])
@pytest.mark.parametrize("k", [1, 2])
def test_a_route_stages_the_shards_whose_rows_cost_a_tile(world, k, share,
                                                          promote):
    """A route plans the unique row sets of the shards it does not hold
    (counted here from the plain hash) and stages a shard whose rows
    cost ``promote_ratio`` of its tile, gathering the rest: no shard,
    some or all staged. Its gathered plan holds exactly the kept shards'
    rows, and its stats count their reads."""
    c, _, paged, _ = world[k]
    st, lay = paged.storage, paged.layout
    pats = _patterns(c, np.random.default_rng(k))[1]
    terms = [compile_pattern(p, paged.params) for p in pats]
    buf = np.zeros((16, 128, 2), np.uint32)
    n_valid = np.zeros(16, np.int32)
    for i, t in enumerate(terms):
        buf[i, :t.shape[0]] = t
        n_valid[i] = t.shape[0]
    ps = QueryServer(paged, ServerConfig(
        **NO_CACHE, tile_cache_bytes=_cap(st, share)), device=CPU)
    ps.warm_tiles()
    hashes = [np.stack([plain_hash(t, j).numpy() for j in range(k)], axis=1)
              for t in terms]
    W = int(st.shape[1])
    sets, ratio_of = {}, {}
    for s in range(st.n_shards):          # one block a shard
        if ps.tiles.resident(s):
            continue
        w, r0 = int(lay.block_width[s]), int(lay.row_offset[s])
        sets[s] = sorted({tuple(int(x) % w + r0 for x in row)
                          for h in hashes for row in h})
        ratio_of[s] = len(sets[s]) * k * W * 4 / st.shard_nbytes(s)
    ratios = sorted(ratio_of.values())
    ratio = {"never": 2.0, "all": 0.0,
             "some": (ratios[0] + ratios[-1]) / 2}[promote]
    route = RowGatherRoute(ps.tiles, ps.planner.shard_plans, buf, n_valid,
                           n_hashes=k, promote_ratio=ratio)
    want = ["resident" if s not in sets else
            "staged" if ratio_of[s] >= ratio else "gathered"
            for s in range(st.n_shards)]
    assert route.routes == want
    staged, kept = want.count("staged"), [s for s in sets
                                          if want[s] == "gathered"]
    assert {"never": staged == 0, "some": 0 < staged < len(sets),
            "all": staged == len(sets)}[promote]
    if not kept:
        assert route._plan == ([], None)
        return
    idx, dp = route._plan
    assert [route.plans[i].shard for i in idx] == kept
    rows = sum((sets[s] for s in kept), [])
    live = dp.uniq_rows[:dp.n_unique].reshape(dp.n_unique, k)
    assert live.tolist() == [list(r) for r in rows]
    route.scatter(None)
    assert route.stats.rows_gathered == len(rows) * k
    assert route.stats.bytes_gathered == len(rows) * k * W * 4


# -- the grouped launch ----------------------------------------------------------

def _read_batch(c, q_pad: int):
    """Reads of the corpus as a padded batch: terms uint32 [q_pad, 128, 2]
    and n_valid [q_pad], the rows past the reads padding (n_valid 0)."""
    pats = [d[30:110] for d in c.documents[:q_pad - 3]]
    buf = np.zeros((q_pad, 128, 2), np.uint32)
    n_valid = np.zeros(q_pad, np.int32)
    for i, p in enumerate(pats):
        t = compile_pattern(p, IndexParams(1, 0.3, K))
        buf[i, :t.shape[0]] = t
        n_valid[i] = t.shape[0]
    return buf, n_valid


class _CountedTable(kb.BlockTable):
    built = 0

    def __init__(self, *args, **kw):
        type(self).built += 1
        super().__init__(*args, **kw)


def _dispatch(ps, buf, n_valid, single: bool):
    """One k = 1 lookup dispatch of the server's shard loop over the batch
    (the one-request form: its first query alone), with its row-gather
    route; returns (document scores [Q, n_docs], the route)."""
    plan = ps.planner.plan(buf.shape[1], 1 if single else buf.shape[0])
    assert plan.method == "lookup" and plan.paged
    fn, _ = ps.planner.score_fns(plan, "single" if single else "batch")
    dev_terms = q._to_device(buf[0] if single else buf, ps.index.device)
    nv = int(n_valid[0]) if single else torch.from_numpy(n_valid)
    route = RowGatherRoute(ps.tiles, ps.planner.shard_plans,
                           buf[:1] if single else buf,
                           n_valid[:1] if single else n_valid,
                           single=single)
    out = q.score_shards(
        ps.tiles, ps.planner.shard_plans, fn, None,
        lambda i, rows: (*ps._addressing[i], dev_terms, nv),
        route=route, grouped=True)
    slots = out.reshape(1 if single else buf.shape[0], -1).numpy()
    return slots[:, np.asarray(ps.index.layout.doc_slot)], route


@pytest.mark.parametrize("form", ["batch", "single"])
@pytest.mark.parametrize("share", ["some", "all"])
def test_grouped_dispatch_equals_jax_engine(world, jax_paged, share, form):
    """Resident shards in one grouped launch, the others gathered: the
    dispatch's scores equal the JAX engine's over the store's files, for
    a batch with padded queries and for one request."""
    c, _, paged, _ = world[1]
    ps = QueryServer(paged, ServerConfig(
        **NO_CACHE, tile_cache_bytes=_cap(paged.storage, share)), device=CPU)
    ps.warm_tiles()
    buf, n_valid = _read_batch(c, 16)
    single = form == "single"
    got, route = _dispatch(ps, buf, n_valid, single)
    want = JaxEngine(jax_paged, method="lookup").score_terms_batch(
        buf[:1] if single else buf, n_valid[:1] if single else n_valid)
    np.testing.assert_array_equal(got, np.asarray(want))
    resident = {"some": 2, "all": 5}[share]
    assert route.stats.visits["resident"] == route.stats.grouped == resident
    assert (got[n_valid[:got.shape[0]] == 0] == 0).all()


def test_block_table_follows_residency(world, jax_paged, monkeypatch):
    """The table is built once while residency stays, and anew after an
    eviction and after a tile is staged; the scores stay the JAX
    engine's."""
    c, _, paged, _ = world[1]
    st = paged.storage
    monkeypatch.setattr(ops, "BlockTable", _CountedTable)
    monkeypatch.setattr(_CountedTable, "built", 0)
    ps = QueryServer(paged, ServerConfig(
        **NO_CACHE, tile_cache_bytes=_cap(st, "some")), device=CPU)
    ps.warm_tiles()
    buf, n_valid = _read_batch(c, 8)
    want = np.asarray(JaxEngine(jax_paged, method="lookup")
                      .score_terms_batch(buf, n_valid))
    for _ in range(2):
        got, _ = _dispatch(ps, buf, n_valid, single=False)
        np.testing.assert_array_equal(got, want)
    assert _CountedTable.built == 1
    before = set(ps.tiles.resident_shards)
    other = next(s for s in range(st.n_shards) if s not in before)
    ps.tiles.get(other)                   # stages it and evicts
    evictions = ps.tiles.evictions
    assert evictions > 0
    got, route = _dispatch(ps, buf, n_valid, single=False)
    np.testing.assert_array_equal(got, want)
    assert _CountedTable.built == 2
    assert route.stats.grouped == len(ps.tiles) == route.stats.visits[
        "resident"]
    # room for every tile: one staged here, the route stages the rest in
    # its dispatch, scored one by one beside the grouped launch
    ps.tiles.capacity_bytes = None
    ps.tiles.prefetch(next(s for s in range(st.n_shards)
                           if not ps.tiles.resident(s)))
    resident = len(ps.tiles)
    got, route = _dispatch(ps, buf, n_valid, single=False)
    np.testing.assert_array_equal(got, want)
    assert _CountedTable.built == 3 and ps.tiles.evictions == evictions
    assert route.stats.grouped == resident == route.stats.visits["resident"]
    assert route.stats.visits["staged"] == st.n_shards - resident > 0
    got, route = _dispatch(ps, buf, n_valid, single=False)
    np.testing.assert_array_equal(got, want)
    assert _CountedTable.built == 4 and route.stats.grouped == st.n_shards


def test_evicted_tiles_are_released(world):
    """The block table keeps no tile: a tile the cache evicts is freed once
    the dispatch that got it is done, while the one-request form, which
    grouped those tiles first, stays idle and batches stage and evict."""
    c, _, paged, _ = world[1]
    st = paged.storage
    ps = QueryServer(paged, ServerConfig(
        **NO_CACHE, tile_cache_bytes=_cap(st, "some")), device=CPU)
    ps.warm_tiles()
    buf, n_valid = _read_batch(c, 8)
    _, route = _dispatch(ps, buf, n_valid, single=True)
    assert route.stats.grouped == len(ps.tiles) > 0
    first = {s: weakref.ref(ps.tiles.get(s))
             for s in ps.tiles.resident_shards}
    for s in range(st.n_shards):
        if not ps.tiles.resident(s):
            ps.tiles.get(s)                   # stages it and evicts
        _, route = _dispatch(ps, buf, n_valid, single=False)
        assert route.stats.grouped > 0
    gone = [s for s in first if not ps.tiles.resident(s)]
    assert gone and ps.tiles.evictions >= len(gone)
    gc.collect()
    assert [s for s in gone if first[s]() is not None] == []


@pytest.mark.parametrize("row_offset,width", [(0, 0), (-1, 4), (3, 30),
                                              (0, 31)])
def test_block_table_refuses_rows_past_its_tile(row_offset, width):
    """A block whose rows [offset, offset + width) do not lie in its tile
    (of 30 rows) is refused when the table is built."""
    tile = torch.zeros((30, 2), dtype=torch.int32)
    ok = kb.BlockTable([tile, tile], [0, 10], [10, 20], [1, 0], 2)
    assert len(ok) == 2
    with pytest.raises(IndexError, match="outside its tile's 30 rows"):
        kb.BlockTable([tile, tile], [0, row_offset], [10, width], [0, 1], 2)


@pytest.mark.parametrize("share", ["some", "all"])
def test_grouped_shards_counted(world, share):
    """Every resident visit of a lookup dispatch is scored in its grouped
    launch: ``serve_grouped_shards_total`` equals the resident visits."""
    c, _, paged, _ = world[1]
    ps = QueryServer(paged, ServerConfig(
        **NO_CACHE, tile_cache_bytes=_cap(paged.storage, share),
        dedup_min_rate=None), device=CPU)
    ps.warm_tiles()
    pats = _patterns(c, np.random.default_rng(5))
    _serve(ps, pats, 0.8)
    assert set(ps.planner.dispatch_counts) == {"lookup"}
    reg = ps.metrics.registry
    visits = {lab[0]: ch.value for lab, ch in
              reg.get("serve_shard_visits_total").children()}
    grouped = reg.get("serve_grouped_shards_total").value
    assert grouped == visits["resident"] == ps.tile_gathers.grouped > 0
    assert visits["resident"] == {"some": 2, "all": 5}[share] * \
        ps.metrics.n_batches
