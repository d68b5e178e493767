"""The PyTorch port stands alone and never falls back to the CPU.

* importing ``repro_torch`` loads neither ``jax`` nor ``repro``, and no
  source file of the port (nor ``chip_smoke.py``) imports them;
* ``device=None`` means the CUDA card: without one, every entry point
  raises instead of running on the CPU;
* a CPU tensor, passed on purpose, takes the plain path;
* ``chip_smoke.py`` refuses to run without CUDA or outside a checkout.

The comparisons below are exact (``np.testing.assert_array_equal``).
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.core import (HostArena, IndexParams, QueryEngine,
                              build_classic, build_compact, index_from_numpy)
from repro_torch.kernels import _build
from repro_torch.kernels import bitslice_score as k
from repro_torch.serve import QueryServer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 21


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = [np.arange(40, dtype=np.uint32).reshape(20, 2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_compact(docs, IndexParams(1, 0.3, 15))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_classic(docs, IndexParams(1, 0.3, 15))
    with pytest.raises(RuntimeError, match="CUDA"):
        HostArena(np.zeros((512, 1), np.uint32))
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_numpy(np.zeros((512, 1), np.uint32), [0], [512], [0],
                         [20], 32, 1, IndexParams(1, 0.3, 15).to_json())
    index = build_compact(docs, IndexParams(1, 0.3, 15), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(index)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(index, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryServer(index)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryServer(index, device=None)


@pytest.mark.parametrize("method", ["ref", "unpack", "vertical", "lookup"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, small_corpus, method):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = dict(k.launches)
    params = IndexParams(1, 0.3, 15)
    index = build_compact(small_corpus.doc_terms, params, block_docs=32,
                          row_align=64, device="cpu")
    engine = QueryEngine(index, method=method, device="cpu")
    query = small_corpus.documents[3][:60]
    hits = engine.search(query, 1.0)
    assert 3 in set(hits.doc_ids.tolist())
    batch = engine.search_batch([query, query[:30]], 1.0)
    np.testing.assert_array_equal(batch[0].doc_ids, hits.doc_ids)
    assert k.launches == before


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    """No result line without CUDA; none outside a checkout."""
    script = ROOT / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(script, alone)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                          env={"PATH": os.environ.get("PATH", "")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
