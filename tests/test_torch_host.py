"""The port's host helpers against the JAX package, on the CPU.

``repro_torch.core.theory``, ``core.dna``, ``data.synthetic.mutate`` and
``data.fasta`` are copies of the JAX package's numpy code (the port never
imports ``repro``), so every result must be equal: floats bit for bit,
arrays element for element, FASTA files byte for byte in both directions.
The three packages ``repro_torch.core``, ``.data`` and ``.index`` export
what ``repro.core``, ``.data`` and ``.index`` export.
"""
import numpy as np
import pytest

import repro.core
import repro.data
import repro.index
from repro.core import dna as jax_dna
from repro.core import theory as jax_theory
from repro.data import fasta as jax_fasta
from repro.data import synthetic as jax_synth

import repro_torch.core
import repro_torch.data
import repro_torch.index
from repro_torch.core import dna, theory
from repro_torch.data import fasta, synthetic

W = (1, 7, 64, 1000, 4096)
K = (1, 2, 3, 7)
V = (0, 1, 10, 100, 5000)
ELL = (0, 1, 5, 20, 50, 100, 400)
P = (0.0, 1e-6, 0.05, 0.3, 0.5, 0.99, 1.0)
THETA = (0.0, 0.3, 0.5, 0.6, 0.8, 1.0)


def _same_float(a, b):
    assert type(a) is type(b)
    assert np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)


@pytest.mark.parametrize("w", W)
def test_filter_theory_equal(w):
    for k in K:
        for v in V:
            _same_float(theory.bloom_fpr(w, k, v),
                        jax_theory.bloom_fpr(w, k, v))
            _same_float(theory.fill_rate(w, k, v),
                        jax_theory.fill_rate(w, k, v))
        assert theory.optimal_k(w, k * 13) == jax_theory.optimal_k(w, k * 13)
    assert theory.optimal_k(w, 0) == jax_theory.optimal_k(w, 0) == 1
    for v in V:
        for fpr in (0.01, 0.3, 0.9):
            for k in K:
                assert (theory.bloom_size(v, fpr, k)
                        == jax_theory.bloom_size(v, fpr, k))


@pytest.mark.parametrize("ell", ELL)
def test_query_theory_equal(ell):
    for p in P:
        if 0.0 < p < 1.0 and ell > 0:
            np.testing.assert_array_equal(
                theory._log_binom_pmf_cumsum(ell, p),
                jax_theory._log_binom_pmf_cumsum(ell, p))
        for th in THETA:
            _same_float(theory.query_fpr(ell, p, th),
                        jax_theory.query_fpr(ell, p, th))
            if p < 1.0:
                _same_float(theory.query_fpr_chernoff(ell, p, th),
                            jax_theory.query_fpr_chernoff(ell, p, th))
            _same_float(
                theory.expected_false_positive_docs(10**6, ell, p, th),
                jax_theory.expected_false_positive_docs(10**6, ell, p, th))


def test_theory_edge_cases_equal():
    """The edge cases of ``tests/test_theory.py``, in both packages."""
    for mod in (theory, jax_theory):
        assert mod.bloom_fpr(100, 1, 0) == 0.0
        assert mod.query_fpr(0, 0.3, 0.5) == 0.0
        assert mod.query_fpr(10, 0.0, 0.5) == 0.0
        assert mod.query_fpr(10, 1.0, 0.5) == 1.0
        assert mod.bloom_size(0, 0.3, 1) == 1
        assert mod.optimal_k(1000, 100) == 7
        assert mod.query_fpr_chernoff(20, 0.5, 0.3) == 1.0
        for bad in (0.0, 1.0, 1.5, -0.1):
            with pytest.raises(ValueError):
                mod.bloom_size(10, bad, 1)


@pytest.mark.parametrize("seed", range(4))
def test_decode_inverts_encode(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=int(rng.integers(0, 300)),
                         dtype=np.uint8)
    s = dna.decode_dna(codes)
    assert s == jax_dna.decode_dna(codes)
    np.testing.assert_array_equal(dna.encode_dna(s), codes)
    np.testing.assert_array_equal(dna.encode_dna(s.lower() + "NNRY"), codes)
    assert dna.decode_dna(jax_dna.encode_dna(s)) == s


@pytest.mark.parametrize("q", range(1, 9))
def test_pack_qgrams_bytes_equal(q):
    rng = np.random.default_rng(q)
    text = b"the quick brown fox jumps over the lazy dog " * 3
    for data in (text, bytes(rng.integers(0, 256, 97, dtype=np.uint8)),
                 text[:q], text[:q - 1], b""):
        got = dna.pack_qgrams_bytes(data, q)
        want = jax_dna.pack_qgrams_bytes(data, q)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_pack_qgrams_bytes_refuses_alike():
    for q in (0, 9):
        for mod in (dna, jax_dna):
            with pytest.raises(ValueError):
                mod.pack_qgrams_bytes(b"abcdefghij", q)


@pytest.mark.parametrize("rate", [0.0, 0.03, 0.5])
def test_mutate_makes_the_same_draws(rate):
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    g = synthetic.random_genome(a, 1000)
    np.testing.assert_array_equal(g, jax_synth.random_genome(b, 1000))
    for _ in range(3):
        got, want = synthetic.mutate(a, g, rate), jax_synth.mutate(b, g, rate)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert int((got != g).sum()) == int(len(g) * rate)
    # the generators stayed in step
    assert a.integers(0, 2**32) == b.integers(0, 2**32)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fasta_across_packages(tmp_path, writer):
    rng = np.random.default_rng(3)
    reads = [synthetic.random_genome(rng, n) for n in (1, 50, 80, 333)]
    w, r = (fasta, jax_fasta) if writer == "torch" else (jax_fasta, fasta)
    w.write_fasta(tmp_path / "a.fa", reads, name_prefix="s")
    r.write_fasta(tmp_path / "b.fa", reads, name_prefix="s")
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()
    back, jax_back = r.read_fasta(tmp_path / "a.fa"), \
        w.read_fasta(tmp_path / "a.fa")
    assert len(back) == len(jax_back) == len(reads)
    for x, y, z in zip(reads, back, jax_back):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_fasta_multiline_records_equal(tmp_path):
    text = ">r0 first\nACGT\nacgtN\n\n>r1\nGG\nTT\n>empty\n>r3\nA\n"
    (tmp_path / "m.fa").write_text(text)
    got = fasta.read_fasta(tmp_path / "m.fa")
    want = jax_fasta.read_fasta(tmp_path / "m.fa")
    assert len(got) == len(want) == 3
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# the names JAX exports that belong to the LM substrate (ROADMAP A17)
A17 = set()
# what the port exports beyond JAX: ``index_from_numpy``, which carries a
# JAX index's arrays across into the port (the JAX package needs no such
# bridge)
PORT_ONLY = {"core": {"index_from_numpy"}, "data": set(), "index": set()}


@pytest.mark.parametrize("pkg", ["core", "data", "index"])
def test_exports_equal_jax(pkg):
    port = getattr(repro_torch, pkg)
    ref = getattr(repro, pkg)
    assert set(port.__all__) - PORT_ONLY[pkg] == set(ref.__all__) - A17
    for name in port.__all__:
        assert hasattr(port, name), name
    assert repro_torch.data.mutate is synthetic.mutate
    assert repro_torch.data.read_fasta is fasta.read_fasta
