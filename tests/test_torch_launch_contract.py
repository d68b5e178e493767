"""What the scoring wrappers that take long queries, and the two gathers,
hand the kernel library, on the CPU.

With the CUDA check and the launcher stubbed, each wrapper is called on
CPU tensors at L = 70,144 and its calls into the library are recorded:
the fused-decode lookups, the three chunk wrappers, ``dedup_score`` and
``unpack_score`` run kernels that take a cluster size, one launch for any
L at the cluster size the entry point picks (``CLUSTER_AUTO``); the two
gathers one launch each for a flat [U] list and for [U, k] row sets.
``_build.split_info`` must refuse a kernel that is not a split kernel
before it touches the library, and the source must launch each split
kernel through its cluster launcher, ``dedup_kernel`` alone with
programmatic stream serialization, and both gathers through the one
gather body. No kernel runs here: this checks the Python side of the
launch contract and the source's text only. Two threads launching at once
(a serving loop's worker and a bulk lane's) must lose no count, and must
build the kernel library once.
"""
import re
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bitslice_score as k

L = 70_144
W, WP, CELLS = 4, 8, 2
SPLIT = {"lookup_score_blocks_compressed": "cobs_lookup_comp",
         "lookup_score_multi_compressed": "cobs_lookup_comp",
         "chunk_lookup_score_multi": "cobs_chunk_lookup",
         "chunk_lookup_score_multi_compressed": "cobs_chunk_lookup_comp",
         "chunk_dedup_score": "cobs_chunk_dedup",
         "dedup_score": "cobs_dedup_score", "unpack_score": "cobs_unpack"}
# the gathers: (wrapper, k of the row sets or None for a flat [U] list)
GATHERS = {"gather_rows": ("gather_rows", None),
           "gather_rows_k3": ("gather_rows", 3),
           "gather_rows_compressed": ("gather_rows_compressed", None),
           "gather_rows_compressed_k3": ("gather_rows_compressed", 3)}
GATHER_SYMBOLS = {"gather_rows": "cobs_gather_rows",
                  "gather_rows_compressed": "cobs_gather_rows_comp"}
U = 37


def _call(name: str) -> None:
    """``name`` on CPU tensors of CELLS cells and L terms over W words (W
    padded to WP in the running counts)."""
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(-2 ** 31, 2 ** 31, (9, W), generator=g,
                         dtype=torch.int64).to(torch.int32)
    refs = torch.randint(0, 9, (30,), generator=g, dtype=torch.int32)
    idx = torch.randint(0, 30, (CELLS, 1, L), generator=g, dtype=torch.int32)
    mask = torch.ones((CELLS, 1, L), dtype=torch.int32)
    acc = torch.zeros((CELLS, 1, WP, 32), dtype=torch.int32)
    if name in GATHERS:
        wrapper, sets = GATHERS[name]
        uniq_idx = torch.randint(0, 30, (U,) if sets is None else (U, sets),
                                 generator=g, dtype=torch.int32)
        if wrapper == "gather_rows":
            k.gather_rows(rows, uniq_idx % 9)
        else:
            k.gather_rows_compressed(rows, refs, uniq_idx)
        return
    fn = getattr(k, name)
    if name == "lookup_score_blocks_compressed":
        fn(rows, refs, idx[:, 0].contiguous(), mask[:, 0].contiguous())
    elif name == "lookup_score_multi_compressed":
        fn(rows, refs, idx, mask)
    elif name == "dedup_score":
        fn(rows, idx % 9, mask)
    elif name == "unpack_score":
        fn(torch.randint(-2 ** 31, 2 ** 31, (CELLS, L, W), generator=g,
                         dtype=torch.int64).to(torch.int32))
    elif name == "chunk_lookup_score_multi_compressed":
        fn(rows, refs, idx, mask, acc)
    else:
        fn(rows, idx % 9, mask, acc)


@pytest.mark.parametrize("name", sorted(SPLIT) + sorted(GATHERS))
def test_long_query_launches(monkeypatch, name):
    calls = []
    monkeypatch.setattr(k, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(k, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda symbol, *args: calls.append((symbol, args)))
    before = dict(k.launches)
    _call(name)
    if name in GATHERS:
        # one launch for any U and k: (U, k, W, device, stream)
        wrapper, sets = GATHERS[name]
        tail = 5
        want = [(GATHER_SYMBOLS[wrapper], (U, sets or 1, W, 0, 0))]
    else:
        wrapper = name
        chunk = name.startswith("chunk_")
        # each call ends (cells, L, W[, Wp], cluster, device, stream)
        tail = 7 if chunk else 6
        want = [(SPLIT[name], (CELLS, L, W) + ((WP,) if chunk else ())
                 + (k.CLUSTER_AUTO, 0, 0))]
    assert [(symbol, args[-tail:]) for symbol, args in calls] == want
    assert k.launches[wrapper] - before[wrapper] == len(want)
    for symbol, args in calls:
        assert len(args) == len(_build._SIGNATURES[symbol])


@pytest.mark.parametrize("kernel", ["gather_comp", "gather", "Lookup"])
def test_split_info_refuses_other_kernels(monkeypatch, kernel):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "library", refuse)
    with pytest.raises(ValueError, match="unknown split kernel"):
        _build.split_info(kernel, 1, 1, 1, 0, 0)
    # the split kernels are the ones whose entry points take a cluster size
    assert set(_build.SPLIT_KERNELS.values()) == {
        "cobs_vertical", "cobs_lookup", "cobs_lookup_comp",
        "cobs_chunk_lookup", "cobs_chunk_lookup_comp", "cobs_chunk_dedup",
        "cobs_dedup_score", "cobs_unpack"}


# each split kernel and the launcher that launches it with a cluster size
# (dedup_kernel's also with programmatic stream serialization), and each
# gather kernel and the launcher that picks its vector width
SPLIT_SOURCE = {"vertical_kernel": "launch_split",
                "lookup_kernel": "launch_split",
                "lookup_comp_kernel": "launch_split",
                "chunk_lookup_kernel": "launch_split",
                "chunk_lookup_comp_kernel": "launch_split",
                "chunk_dedup_kernel": "launch_split",
                "dedup_kernel": "launch_split<true>",
                "unpack_kernel": "launch_clustered",
                "gather_kernel": "launch_gather<false>",
                "gather_comp_kernel": "launch_gather<true>"}


@pytest.mark.parametrize("kernel", sorted(SPLIT_SOURCE))
def test_split_kernels_in_the_source(kernel):
    src = _build.SOURCE.read_text()
    launcher = SPLIT_SOURCE[kernel]
    if kernel.startswith("gather"):
        assert re.search(rf"return {launcher}\(", src)
        # one instantiation a vector width (16, 8, 4 bytes), launched from
        # the one launcher, and a single gather body under both kernels
        for vec in (4, 2, 1):
            assert len(re.findall(rf"\b{kernel}<{vec}><<<", src)) == 1
        assert src.count("void gather_body(") == 1
        assert "gather_body<false, kVec>" in src
        assert "gather_body<true, kVec>" in src
        body = src.split("void gather_body(", 1)[1].split("\n}\n", 1)[0]
        for piece in ("__shfl_sync", "Vec::band", "grid_dependents_launch()",
                      "x[kGatherInFlight][kGatherRows]"):
            assert piece in body
        return
    assert re.search(rf"{re.escape(launcher)}\(\s*{kernel},", src)
    assert not re.search(rf"\b{kernel}<<<", src)   # never a plain launch
    # programmatic stream serialization: dedup_kernel's launch alone, and
    # only its split_body instantiation waits for the kernel before it
    programmatic = bool(re.search(rf"<true>\(\s*{kernel},", src))
    assert programmatic == (kernel == "dedup_kernel")
    assert src.count("cudaLaunchAttributeProgrammaticStreamSerialization") \
        == 1
    assert src.count("grid_dependency_wait();") == 1
    assert "if constexpr (kSrc == kUniq) grid_dependency_wait();" in src
    body = src.split(f"\n{kernel}(", 1)[1].split("\n}\n", 1)[0]
    if kernel == "dedup_kernel":
        assert "split_body<kUniq, false>" in body
    if kernel != "unpack_kernel":
        assert "split_body<" in body
    else:
        # a warp per word, a lane per bit, kUnroll loads in flight, summed
        # in shared memory
        for piece in ("lane = threadIdx.x & 31", "v[kUnroll]",
                      "s_red[kUnpackWarps * 32]", "(v[u] >> lane) & 1u"):
            assert piece in body


# --------------------------------------------------------------------------
# Launches from more than one host thread (a serving loop's worker and a
# bulk lane's): every launch counted, the library built once
# --------------------------------------------------------------------------

def test_launch_counts_add_up_across_threads(monkeypatch):
    """More threads than cores call a wrapper through its launch path
    (CUDA check and launcher stubbed) under a very short switch interval;
    the count is exactly the number of launches."""
    monkeypatch.setattr(k, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(k, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "launch", lambda symbol, *args: None)
    rows = torch.zeros((9, W), dtype=torch.int32)
    uniq = torch.zeros(4, dtype=torch.int32)
    n, n_threads = 300, 16
    before = dict(k.launches)

    def work():
        for _ in range(n):
            k.gather_rows(rows, uniq, range_checked=True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert k.launches["gather_rows"] - before["gather_rows"] == n_threads * n
    assert all(k.launches[m] == before[m] for m in k.launches
               if m != "gather_rows")


def test_library_builds_once_across_threads(monkeypatch):
    """Threads that ask for the kernel library at once wait for one build
    (the build and the loader stubbed)."""
    builds = []

    def slow_build():
        builds.append(1)
        time.sleep(0.05)
        return "libcobs_kernels-stub.so", ""

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build._load.cache_clear()
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            _build.library())) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 4
        assert all(lib is got[0] for lib in got)
        assert got[0].cobs_gather_rows.restype is _build.ctypes.c_int
    finally:
        _build._load.cache_clear()
