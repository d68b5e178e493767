"""The benchmark's own arithmetic: traffic from the seed, the trace's
union, the scoring work's bytes, and the frozen copies against the
program's originals."""
import numpy as np
import pytest
import torch

from cobsbench.harness import corpus, devtrace, frozen, roofline, traffic
from cobsbench.tests.tiny import TINY_CORPUS

READS = {"chunk": 8, "pool": 64,
         "length": {"kind": "fixed", "bp": 150}, "from_doc_share": 0.5,
         "substitution_rate": 0.005, "threshold": 0.8, "warmup_s": 0.1}
GENES = dict(READS, length={"kind": "loguniform", "min_bp": 200,
                            "max_bp": 1000})
SEED = 3_000_000_017


def _corp(seed=SEED):
    return corpus.make_corpus(TINY_CORPUS, 31, seed)


# -- traffic -----------------------------------------------------------------

@pytest.mark.parametrize("mix", [READS, GENES], ids=["reads", "genes"])
def test_traffic_reproducible_from_seed(mix):
    a = traffic.make_queries(mix, _corp(), SEED, traffic.WINDOW, 64)
    b = traffic.make_queries(mix, _corp(), SEED, traffic.WINDOW, 64)
    assert a.seqs == b.seqs
    np.testing.assert_array_equal(a.src, b.src)
    c = traffic.make_queries(mix, _corp(SEED + 1), SEED + 1, traffic.WINDOW,
                             64)
    assert a.seqs != c.seqs
    w = traffic.make_queries(mix, _corp(), SEED, traffic.WARMUP, 64)
    assert not set(a.seqs) & set(w.seqs)


@pytest.mark.parametrize("mix", [READS, GENES], ids=["reads", "genes"])
def test_every_seed_sends_the_same_work(mix):
    runs = [traffic.make_queries(mix, _corp(s), s, traffic.WINDOW, 64)
            for s in (1, 2**31 + 5)]
    for f in (lambda q: sorted(q.length.tolist()),
              lambda q: int((q.src >= 0).sum())):
        assert f(runs[0]) == f(runs[1])


def test_the_pool_goes_round():
    assert traffic.pool(READS, traffic.WINDOW) == 64
    assert traffic.pool(READS, traffic.WARMUP) == 8
    np.testing.assert_array_equal(
        traffic.pool_index(np.arange(10), 4), [0, 1, 2, 3, 0, 1, 2, 3, 0, 1])


class _InstantLoop:
    """A fake ``ServingLoop`` that answers each request as it comes."""

    def __init__(self):
        self.sent = []

    def submit(self, terms, threshold, on_done):
        from types import SimpleNamespace
        self.sent.append(terms)
        on_done(SimpleNamespace(status="OK", result=None))


def test_the_in_process_loop_runs_past_its_pool(monkeypatch):
    from repro_torch.core import query
    from cobsbench.entries import inproc_closed
    monkeypatch.setattr(query, "compile_pattern", lambda seq, params: seq)
    loop = _InstantLoop()
    q = traffic.make_queries(READS, _corp(), SEED, traffic.WINDOW, 16)
    got, _, sent = inproc_closed._chunks(loop, q, 0.8, 8, 0.2, None)
    assert sent > 10 * len(q) and len(got) == sent
    assert loop.sent == [q.seqs[i % 16] for i in range(sent)]


def test_cut_queries_come_from_their_document():
    corp = _corp()
    mix = dict(READS, substitution_rate=0.0)
    q = traffic.make_queries(mix, corp, SEED, traffic.WINDOW, 32)
    for i in np.nonzero(q.src >= 0)[0]:
        doc = corpus.bases_np(corp.key, corp.gid[[q.src[i]]], [q.pos[i]],
                              150)[0]
        assert q.seqs[i] == bytes(frozen.BASES[c] for c in doc).decode()


def test_sizes_the_same_for_every_seed():
    a, b = _corp(1), _corp(99)
    assert sorted(a.n_terms) == sorted(b.n_terms)
    assert not np.array_equal(a.n_terms, b.n_terms)
    assert a.key != b.key


# -- the device's busy time ---------------------------------------------------

def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert devtrace.merge(iv) == [(0, 15), (20, 30)]
    assert devtrace.busy_ns(iv, 0, 50) == 25
    assert devtrace.busy_ns(iv, 8, 22) == 9
    assert devtrace.gaps(iv, 0, 50) == [(15, 20), (30, 50)]
    assert devtrace.gaps([], 3, 7) == [(3, 7)]


def test_trace_reductions():
    E = devtrace.Event
    tr = devtrace.Trace(window=(100, 200), device=[
        E("lookup_kernel(unsigned int const*)", 90, 120),
        E("Memcpy DtoH", 110, 130), E("elementwise", 150, 160),
        E("(anonymous namespace)::lookup_kernel(int)", 190, 250)],
        host=[E("cobsbench.score_batch", 130, 150),
              E("aten::copy_", 132, 138)])
    assert tr.window_s == pytest.approx(100e-9)
    assert devtrace.busy_s(tr) == pytest.approx(50e-9)
    assert devtrace.score_kernel_s(tr) == pytest.approx(30e-9)
    gaps = devtrace.top_idle_gaps(tr)
    assert gaps[0] == ["host (no span open)", pytest.approx(30e-9)]
    assert gaps[1] == ["cobsbench.score_batch", pytest.approx(20e-9)]
    ops = dict((n, s) for n, s in devtrace.top_device_ops(tr))
    assert ops["Memcpy DtoH"] == pytest.approx(20e-9)


# -- the scoring work's bound -------------------------------------------------

def test_batch_work_counts_each_byte_once():
    nbytes, ops = roofline.batch_work([120, 100], rows=7000, n_blocks=34,
                                      n_hashes=1, doc_words=32, n_docs=34134)
    assert nbytes == 7000 * 32 * 4 + 8 * 220 + 4 * 34134 * 2
    assert ops == 220 * 34 * 32 * 32
    b = roofline.bound_s(nbytes, ops, "NVIDIA H100 80GB HBM3")
    assert b == pytest.approx(nbytes / 3.35e12)
    assert roofline.bound_s(nbytes, ops, "some other card") is None


def test_distinct_rows_counts_shared_rows_once():
    t = np.array([[1, 2], [3, 4], [1, 2]], dtype=np.uint32)
    off = np.array([0, 1000], dtype=np.int32)
    w = np.array([1000, 512], dtype=np.int32)
    rows = roofline.distinct_rows([t, t[:1]], off, w, 1, torch.device("cpu"))
    assert rows == 4


# -- the frozen copies against the program ------------------------------------

def test_frozen_hash_and_kmers_equal_the_programs():
    from repro_torch.core import dna, hashing
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 500).astype(np.uint8)
    seq = "".join("ACGT"[c] for c in codes)
    ours = frozen.query_terms(seq, 31)
    np.testing.assert_array_equal(
        ours, dna.unique_terms(dna.pack_kmers(dna.encode_dna(seq), 31)))
    for k in (1, 2):
        np.testing.assert_array_equal(frozen.hash_np(ours, k),
                                      hashing.hash_terms_np(ours, k))
        t = torch.from_numpy(ours.astype(np.int64))
        got = torch.stack([frozen.hash_torch(t[:, 0], t[:, 1], j)
                           for j in range(k)], 1).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, hashing.hash_terms_np(ours, k))


def test_frozen_layout_and_cutoff_equal_the_programs():
    from repro_torch.core.index import IndexParams, plan_compact_layout
    from repro_torch.core.query import coverage_cutoff
    counts = _corp().n_terms
    layout, order = plan_compact_layout(counts, IndexParams(), 32)
    block_of, widths = frozen.compact_blocks(counts, 0.3, 1, 32)
    np.testing.assert_array_equal(widths, layout.block_width)
    np.testing.assert_array_equal(block_of, layout.doc_slot // 32)
    for t, n in ((0.8, 120), (0.8, 1), (0.95, 9971), (0.5, 3)):
        assert frozen.coverage_cutoff(t, n) == coverage_cutoff(t, n)


def test_device_kmers_equal_the_packed_bases():
    corp = _corp()
    gid = torch.tensor(corp.gid[:3], dtype=torch.int64)
    lo, hi = corpus.kmers_torch(corp.key, gid, 32, 200, 31)
    for c in range(3):
        b = corpus.bases_np(corp.key, corp.gid[[c]], [32], 230)[0]
        want = frozen.pack_kmers(b, 31)
        np.testing.assert_array_equal(lo[c].numpy(), want[:, 0])
        np.testing.assert_array_equal(hi[c].numpy(), want[:, 1])
    v = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1])
    np.testing.assert_array_equal(
        corpus.as_int32_bits(v).numpy().view(np.uint32), v.numpy())
