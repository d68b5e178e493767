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
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitslice_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rows, out, B, L, W, device, stream
    "cobs_unpack": (_P, _P, _I, _I, _I, _I, _P),
    # rows, out, B, L, W, n_planes, device, stream
    "cobs_vertical": (_P, _P, _I, _I, _I, _I, _I, _P),
    # arena, idx, mask, out, cells, L, W, n_planes, device, stream
    "cobs_lookup": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dict, refs, idx, mask, out, cells, L, W, n_planes, device, stream
    "cobs_lookup_comp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # arena (uniq), idx (indir), mask, acc, out, cells, L, W, Wp,
    # n_planes, device, stream
    "cobs_chunk_lookup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "cobs_chunk_dedup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # dict, refs, idx, mask, acc, out, cells, L, W, Wp, n_planes, device,
    # stream
    "cobs_chunk_lookup_comp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P),
    # arena, uniq_idx, out, U, k, W, device, stream
    "cobs_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    # dict, refs, uniq_idx, out, U, k, W, device, stream
    "cobs_gather_rows_comp": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # uniq, indir, mask, out, cells, L, W, n_planes, device, stream
    "cobs_dedup_score": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
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


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cobs_error_string.argtypes = [ctypes.c_int]
    lib.cobs_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if the launch was refused."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.cobs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
