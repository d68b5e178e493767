"""Build and load the CUDA kernels: ``nvcc`` into a plain-C shared library
bound with ``ctypes``.

The library is built at first use from ``csrc/bitslice_score.cu`` into
``build/kernels/`` at the repository root (listed in ``.gitignore``). Its
file name carries a hash of the source, so an edited source builds anew
and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitslice_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rows, out, B, L, W, cluster (0 = the entry point's choice), device,
    # stream
    "cobs_unpack": (_P, _P, _I, _I, _I, _I, _I, _P),
    "cobs_vertical": (_P, _P, _I, _I, _I, _I, _I, _P),
    # arena, idx, mask, out, cells, L, W, cluster, device, stream
    "cobs_lookup": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dict, refs, idx, mask, out, cells, L, W, cluster, device, stream
    "cobs_lookup_comp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # table, entries, terms, n_valid (or null), out, Q, blocks, L, W,
    # cluster, device, stream
    "cobs_lookup_grouped": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # kernel name (one of SPLIT_KERNELS), cells, L, W, Wp, cluster, device,
    # int[9] out
    "cobs_split_info": (ctypes.c_char_p, _I, _I, _I, _I, _I, _I, _P),
    # arena, idx, mask, acc, out, cells, L, W, Wp, cluster, device, stream
    "cobs_chunk_lookup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # uniq, indir, mask, acc, out, cells, L, W, Wp, cluster, device, stream
    "cobs_chunk_dedup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # dict, refs, idx, mask, acc, out, cells, L, W, Wp, cluster, device,
    # stream
    "cobs_chunk_lookup_comp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P),
    # arena, uniq_idx, out, U, k, W, device, stream
    "cobs_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    # dict, refs, uniq_idx, out, U, k, W, device, stream
    "cobs_gather_rows_comp": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # uniq, indir, mask, out, cells, L, W, cluster, device, stream
    "cobs_dedup_score": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # scores, doc_slot, cut, out, Q, ld, n_docs, cap, device, stream
    "cobs_select_hits": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcobs_kernels-{digest}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet. Returns the
    library's path and nvcc's report (empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


# threads that launch first (a serving loop's worker, a bulk lane) wait
# for one build instead of each running nvcc
_library_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _library_lock:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cobs_error_string.argtypes = [ctypes.c_int]
    lib.cobs_error_string.restype = ctypes.c_char_p
    return lib


# the kernels that take a cluster size, as cobs_split_info names them, and
# their entry points
SPLIT_KERNELS = {"vertical": "cobs_vertical", "lookup": "cobs_lookup",
                 "lookup_comp": "cobs_lookup_comp",
                 "chunk_lookup": "cobs_chunk_lookup",
                 "chunk_lookup_comp": "cobs_chunk_lookup_comp",
                 "chunk_dedup": "cobs_chunk_dedup",
                 "dedup": "cobs_dedup_score", "unpack": "cobs_unpack"}
SPLIT_INFO = ("blocks", "threads", "cluster", "word_tile", "slices",
              "planes", "static_smem_bytes", "registers", "max_cluster")


def split_info(kernel: str, cells: int, L: int, W: int, cluster: int,
               device: int, *, Wp: int | None = None) -> dict[str, int]:
    """How split kernel ``kernel`` (one of SPLIT_KERNELS) launches at this
    shape (``Wp``: a chunk kernel's running-count words, default W): its
    grid, block and cluster shape, word tile, term slices, counter planes
    (0 for ``unpack``, which has none), and the kernel's static shared
    memory and registers."""
    if kernel not in SPLIT_KERNELS:
        raise ValueError(f"unknown split kernel {kernel!r}; one of "
                         f"{tuple(SPLIT_KERNELS)}")
    lib = library()
    info = (ctypes.c_int * len(SPLIT_INFO))()
    err = lib.cobs_split_info(kernel.encode(), cells, L, W,
                              W if Wp is None else Wp, cluster, device,
                              ctypes.addressof(info))
    if err != 0:
        msg = lib.cobs_error_string(err).decode()
        raise RuntimeError(f"cobs_split_info: CUDA error {err} ({msg})")
    return dict(zip(SPLIT_INFO, info))


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if the launch was refused."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.cobs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
