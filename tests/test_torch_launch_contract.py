"""What the scoring wrappers that take long queries hand the kernel
library, on the CPU.

With the CUDA check and the launcher stubbed, each wrapper is called on
CPU tensors at L = 70,144 and its calls into the library are recorded:
the fused-decode lookups, the three chunk wrappers, ``dedup_score`` and
``unpack_score`` run kernels that take a cluster size, one launch for any
L at the cluster size the entry point picks (``CLUSTER_AUTO``).
``_build.split_info`` must refuse a kernel that is not a split kernel
before it touches the library, and the source must launch each split
kernel through its cluster launcher. No kernel runs here: this checks the
Python side of the launch contract only.
"""
import re

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


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_long_query_launches(monkeypatch, name):
    calls = []
    monkeypatch.setattr(k, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(k, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda symbol, *args: calls.append((symbol, args)))
    before = dict(k.launches)
    _call(name)
    chunk = name.startswith("chunk_")
    # each call ends (cells, L, W[, Wp], cluster, device, stream)
    tail = 7 if chunk else 6
    want = [(SPLIT[name], (CELLS, L, W) + ((WP,) if chunk else ())
             + (k.CLUSTER_AUTO, 0, 0))]
    assert [(symbol, args[-tail:]) for symbol, args in calls] == want
    assert k.launches[name] - before[name] == len(want)
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
SPLIT_SOURCE = {"vertical_kernel": "launch_split",
                "lookup_kernel": "launch_split",
                "lookup_comp_kernel": "launch_split",
                "chunk_lookup_kernel": "launch_split",
                "chunk_lookup_comp_kernel": "launch_split",
                "chunk_dedup_kernel": "launch_split",
                "dedup_kernel": "launch_split",
                "unpack_kernel": "launch_clustered"}


@pytest.mark.parametrize("kernel", sorted(SPLIT_SOURCE))
def test_split_kernels_in_the_source(kernel):
    src = _build.SOURCE.read_text()
    assert re.search(rf"{SPLIT_SOURCE[kernel]}\(\s*{kernel},", src)
    assert not re.search(rf"\b{kernel}<<<", src)   # never a plain launch
    body = src.split(f"\n{kernel}(", 1)[1].split("\n}\n", 1)[0]
    if kernel != "unpack_kernel":
        assert "split_body<" in body
    else:
        # a warp per word, a lane per bit, kUnroll loads in flight, summed
        # in shared memory
        for piece in ("lane = threadIdx.x & 31", "v[kUnroll]",
                      "s_red[kUnpackWarps * 32]", "(v[u] >> lane) & 1u"):
            assert piece in body
