"""The PyTorch port stands alone and never falls back to the CPU.

* importing ``repro_torch`` loads neither ``jax`` nor ``repro``, and no
  source file of the port (nor ``chip_smoke.py`` or
  ``tools/split_probe.py``) imports them;
* ``device=None`` means the CUDA card: without one, every entry point
  raises instead of running on the CPU;
* a CPU tensor, passed on purpose, takes the plain path;
* ``chip_smoke.py`` refuses to run without CUDA or outside a checkout;
* the dry-run CLI and ``make_cell`` run on "meta" alone: no CUDA, no
  tensor elsewhere, neither ``jax`` nor ``repro``.

The comparisons below are exact (``np.testing.assert_array_equal``).
"""
import ast
import json
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
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.serve import QueryServer, ServerConfig

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
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "split_probe.py"],
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


def test_shard_worker_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                             tmp_path):
    """A ShardWorker resolves ``device=None`` to the card: without CUDA it
    raises, so no fleet falls back to the CPU; only ``device="cpu"``
    builds one there."""
    from repro_torch.index import ShardPlacement, build_compact_streaming
    from repro_torch.serve import Frontend, ShardWorker
    docs = [np.arange(i, i + 60, dtype=np.uint32).reshape(30, 2)
            for i in range(0, 600, 60)]
    store = tmp_path / "v2"
    build_compact_streaming(docs, store, IndexParams(1, 0.3, 15),
                            block_docs=32, row_align=64, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardWorker("w", store, [0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardWorker("w", store, [0], device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardWorker("w", store, [0], device="cuda")
    worker = ShardWorker("w", store, [0], device="cpu")
    assert worker.device == torch.device("cpu")
    assert worker.tiles.device == torch.device("cpu")
    place = ShardPlacement.for_store(store, ["w"], replication=1)
    fe = Frontend({"w": worker}, place)
    assert fe.workers["w"] is worker


def test_tuner_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelTuner(4096, 4, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelTuner(4096, 4, 1, 2, device=None)
    # a tuner of a CPU index, or one asked for the CPU, stays there
    docs = [np.arange(40, dtype=np.uint32).reshape(20, 2)]
    index = build_compact(docs, IndexParams(1, 0.3, 15), device="cpu")
    assert KernelTuner.for_index(index).device == torch.device("cpu")
    assert KernelTuner(4096, 4, 1, 2, device="cpu").device.type == "cpu"
    server = QueryServer(index, ServerConfig(autotune=True), device="cpu")
    assert server.tuner.device == torch.device("cpu")


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


def test_launchers_and_mesh_index_default_to_cuda(monkeypatch, tmp_path,
                                                 capsys):
    """The serving CLI, the worker cluster, the mesh, ``DistributedIndex``
    and ``MultiIndexEngine`` resolve ``device=None`` to the card: without
    CUDA each raises (the CLI exits with its usage error) before it builds
    or starts anything."""
    from repro_torch.core import MultiIndexEngine
    from repro_torch.index import DistributedIndex
    from repro_torch.launch import serve
    from repro_torch.launch.cluster import WorkerCluster
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    docs = [np.arange(40, dtype=np.uint32).reshape(20, 2)]
    index = build_compact(docs, IndexParams(1, 0.3, 15), device="cpu")
    cpu_mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedIndex(index, cpu_mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedIndex(index, cpu_mesh, device=None)
    assert DistributedIndex(index, cpu_mesh,
                            device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiIndexEngine()
    assert MultiIndexEngine(device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerCluster(str(tmp_path), ["w0"])
    assert WorkerCluster(str(tmp_path), ["w0"], device="cpu",
                         run_dir=str(tmp_path)).device.type == "cpu"
    for argv in (["--n-docs", "8"], ["--n-docs", "8", "--device", "cuda"],
                 ["--worker", "w0", "--store-format", "v2",
                  "--index-dir", str(tmp_path)]):
        with pytest.raises(SystemExit) as exc:
            serve.main(argv)
        assert exc.value.code == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """``Model``, ``build_model``, ``params_from_numpy`` and
    ``greedy_generate`` resolve ``device=None`` to the card: without CUDA
    each raises; a model for the card is never run on the CPU."""
    from repro_torch.configs import get
    from repro_torch.models import Model, build_model, params_from_numpy
    from repro_torch.serve import greedy_generate
    cfg = get("xlstm-125m", smoke=True)
    model = Model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    numpy_tree = _numpy_tree(params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Model(cfg), lambda: Model(cfg, None),
                 lambda: build_model(cfg),
                 lambda: params_from_numpy(numpy_tree, cfg=cfg),
                 lambda: params_from_numpy(numpy_tree, "cuda", cfg=cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    prompt = np.zeros((1, 4), np.int32)
    assert greedy_generate(model, params, prompt, 2, 8).shape == (1, 6)
    model.device = torch.device("cuda")          # a model for the card
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy_generate(model, params, prompt, 2, 8)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_dryrun_and_make_cell_stay_on_meta():
    """The dry-run CLI (every arch, shape and mesh at full width) and
    ``make_cell`` on the production meshes import neither ``jax`` nor
    ``repro``, never initialise CUDA and leave no tensor off "meta": the
    dry-run is the one entry point that runs nothing on any device."""
    code = (
        "import contextlib, gc, io, json, sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun, specs\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = dryrun.main([])\n"
        "cells = [specs.make_cell(a, s, make_production_mesh(\n"
        "             multi_pod=mp, device='meta'))\n"
        "         for mp in (False, True) for a in configs.list_archs()\n"
        "         for s in specs.SHAPES\n"
        "         if specs.cell_supported(configs.get(a), s)[0]]\n"
        "off = [str(t.device) for t in gc.get_objects()\n"
        "       if isinstance(t, torch.Tensor) and t.device.type != 'meta']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'rc': rc, 'cells': len(cells), 'off': off,\n"
        "                  'bad': bad, 'cuda': torch.cuda.is_initialized(),\n"
        "                  'last': out.getvalue().strip().splitlines()[-1]}))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"rc": 0, "cells": 64, "off": [], "bad": [], "cuda": False,
                   "last": "== dry-run done: 66 ok, 16 skipped, 0 errors =="}


def test_make_cell_needs_no_cuda(monkeypatch):
    """A "meta" mesh builds cells without CUDA; a mesh for the card raises
    without it, as every other entry point does."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    cell = specs.make_cell("qwen3-4b", "train_4k", mesh, smoke=True)
    assert cell.model.device.type == "meta"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))
