"""The port's analytic dry-run (``repro_torch.launch.dryrun``) on the CPU.

* ``run_cell`` on every (arch x shape) smoke cell and both production
  meshes ("meta"): 32 ``ok`` and 8 ``skipped`` (JAX's reasons) a mesh;
  each ``ok`` record's per-device argument and donated bytes equal a sum
  computed here from JAX's own cell on a duck-typed mesh of the same
  shape (each leaf's bytes over the product of the mesh axes JAX's spec
  names), its roofline ``analysis.analyze``'s, its keys JAX's less the
  compiler's;
* each smoke cell's abstract outputs against ``jax.eval_shape`` of JAX's
  step on its (1, 1) mesh, leaf by leaf, and the output bytes their sum;
* ``run_cobs_cell``: 122,021,478,400 index bytes, 476,646,400 a device on
  16x16 and 238,323,200 on 2x16x16 (JAX's formula, computed here with
  ``repro.core.theory``), the slices ``cobs_padding`` gives, and the
  collective terms by hand;
* ``main``: JAX's flags, the JSONL records and summary line, exit 0 (1 when
  a cell errs), CUDA never initialised;
* the collective model against JAX's compiled collectives on a (2, 2)
  mesh of 4 forced host devices (``tests/torch_dryrun_collectives_check.py``
  in a subprocess): every smoke cell within ``TOL`` of JAX's count but
  the cells ``analysis.COLL_LOWER_BOUND`` names, the COBS step equal.

Every comparison but the collective bound is of integers, so exact.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from _torch_dryrun_common import (CELLS, MULTI, SINGLE, jax_smoke_cell,
                                  jax_smoke_cell_on, leaves)

from repro import configs as jax_configs
from repro.core import theory as jax_theory
from repro.launch import specs as jspecs

from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import make_cell

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ("single-pod-16x16", SINGLE,
                     make_production_mesh(device="meta")),
          "multi": ("multi-pod-2x16x16", MULTI,
                    make_production_mesh(multi_pod=True, device="meta"))}
META_11 = make_mesh((1, 1), ("data", "model"), device="meta")
OK_KEYS = {"arch", "shape", "mesh", "chips", "status", "build_s", "memory",
           "roofline", "coll_terms", "params", "active_params"}


def jax_bytes(args, shardings, mesh) -> int:
    """Per-device bytes of JAX's abstract ``args`` under ``shardings``."""
    arg_leaves = jax.tree.leaves(args)
    spec_leaves = jax.tree.leaves(shardings,
                                  is_leaf=lambda x: hasattr(x, "spec"))
    assert len(arg_leaves) == len(spec_leaves)
    total = 0
    for a, sh in zip(arg_leaves, spec_leaves):
        axes = [x for part in sh.spec if part is not None
                for x in ((part,) if isinstance(part, str) else part)]
        div = math.prod(mesh.shape[x] for x in axes)
        n = math.prod(a.shape) * a.dtype.itemsize
        assert n % div == 0
        total += n // div
    return total


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_bytes_equal_jax_specs(arch, shape, mesh):
    name, fake, meta = MESHES[mesh]
    rec = dryrun.run_cell(arch, shape, meta, name, smoke=True)
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, name)
    assert rec["chips"] == math.prod(fake.shape.values())
    ok, why = jspecs.cell_supported(jax_configs.get(arch, smoke=True), shape)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == why
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == OK_KEYS
    want = jax_smoke_cell_on(fake, arch, shape)
    mem = rec["memory"]
    per_arg = [jax_bytes(a, s, fake) for a, s in zip(want.args,
                                                     want.in_shardings)]
    assert mem["argument_bytes"] == per_arg
    assert mem["argument_size_in_bytes"] == sum(per_arg)
    assert mem["alias_size_in_bytes"] == sum(per_arg[i]
                                             for i in want.donate_argnums)
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "argument_bytes"}
    cfg = jax_configs.get(arch, smoke=True)
    assert (rec["params"], rec["active_params"]) == \
        (cfg.param_count(), cfg.active_param_count())
    cell = make_cell(arch, shape, meta, smoke=True)
    terms = dryrun.lm_collectives(cell, meta)
    assert rec["coll_terms"] == terms
    low = (arch, shape) in analysis.COLL_LOWER_BOUND
    assert rec["roofline"] == analysis.analyze(
        cell.cfg, cell.shape, rec["chips"], analysis.by_kind(terms),
        coll_lower_bound=low).as_dict()
    assert ("t_collective_min_s" in rec["roofline"]) == low
    assert ("t_collective_s" in rec["roofline"]) == (not low)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_outputs_equal_jax_eval_shape(arch, shape):
    if not jspecs.cell_supported(jax_configs.get(arch, smoke=True),
                                 shape)[0]:
        with pytest.raises(ValueError):
            make_cell(arch, shape, META_11, smoke=True)
        return
    want = jax_smoke_cell(arch, shape)
    outs = jax.eval_shape(want.step_fn, *want.args)
    cell = make_cell(arch, shape, META_11, smoke=True)
    assert leaves(cell.outs) == leaves(outs)
    mem = analysis.memory_from_specs(cell.args, cell.in_shardings, cell.outs,
                                     cell.out_specs, META_11,
                                     cell.donate_argnums)
    assert mem["output_size_in_bytes"] == sum(
        math.prod(x.shape) * x.dtype.itemsize for x in jax.tree.leaves(outs))


def jax_cobs_index_bytes(n_docs, n_terms, rows_shards, doc_shards):
    """JAX's ``run_cobs_cell`` arithmetic, for the expected numbers."""
    n_blocks = n_docs // 1024
    w = (jax_theory.bloom_size(n_terms, 0.3, 1) + 511) // 512 * 512
    rows = (n_blocks * w + rows_shards - 1) // rows_shards * rows_shards
    words = (32 + doc_shards - 1) // doc_shards * doc_shards
    return rows * words * 4


@pytest.mark.parametrize("mesh,per_chip,doc_shards", [
    ("single", 476_646_400, 16), ("multi", 238_323_200, 32)])
def test_cobs_cell_bytes(mesh, per_chip, doc_shards):
    name, fake, meta = MESHES[mesh]
    rec = dryrun.run_cobs_cell(meta, name)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == \
        ("cobs-index", "query_b64", name)
    assert rec["index_bytes_total"] == 122_021_478_400 == \
        jax_cobs_index_bytes(102_400, 3_400_000, 16, doc_shards)
    assert rec["index_bytes_per_chip"] == per_chip
    pad = dryrun.cobs_padding(dryrun.cobs_arena_shape()[1:], fake.shape)
    assert pad["slice_bytes"] == per_chip and pad["n_slices"] == \
        rec["chips"]
    assert rec["memory"]["argument_bytes"][0] == per_chip
    wl = 32 // doc_shards
    n_local = 100 * wl * 32
    assert rec["coll_terms"] == {
        "score_psum": {"all-reduce": 2 * 64 * n_local * 4},
        "topk_gather": {"all-gather": 2 * 64 * doc_shards * 32 * 4}}
    assert rec["coll_bytes_per_chip"] == sum(rec["coll_breakdown"].values())
    W = 100 * wl
    assert rec["bytes_per_chip"] == 64 * 1024 * W * 4 + 64 * W * 32 * 4
    assert rec["flops_per_chip"] == 64 * 2 * 11 * (1024 * W + W * 32)
    # the unpack body's operations; int16 scores halve the psum and scores
    rec = dryrun.run_cobs_cell(meta, name, score_method="unpack",
                               score_dtype=torch.int16)
    assert rec["flops_per_chip"] == 64 * 2 * 1024 * W * 32
    assert rec["coll_terms"]["score_psum"] == {
        "all-reduce": 2 * 64 * n_local * 2}
    assert rec["bytes_per_chip"] == 64 * 1024 * W * 4 + 64 * W * 32 * 2
    assert rec["index_bytes_per_chip"] == per_chip


def test_cobs_padding_pads_as_distributed_index():
    """Words to a multiple of the doc shards, rows of the row stripes."""
    pad = dryrun.cobs_padding((1001, 3), {"pod": 2, "data": 2, "model": 2})
    assert (pad["rows_padded"], pad["words_padded"]) == (1002, 4)
    assert pad["slice_shape"] == (501, 1) and pad["n_slices"] == 8
    pad = dryrun.cobs_padding((10, 5), {"data": 4, "model": 3})
    assert pad["doc_axes"] == ("data",) and pad["n_row_shards"] == 3
    assert (pad["rows_padded"], pad["words_padded"]) == (12, 8)
    assert pad["slice_shape"] == (4, 2) and pad["slice_bytes"] == 32


def test_main_smoke_writes_records(tmp_path, capsys):
    out = tmp_path / "dr" / "dryrun.jsonl"
    assert dryrun.main(["--smoke", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2 * 41
    for name in ("single-pod-16x16", "multi-pod-2x16x16"):
        mine = [r for r in recs if r["mesh"] == name]
        assert mine[0]["arch"] == "cobs-index"
        assert [r["status"] for r in mine].count("ok") == 33
        assert [r["status"] for r in mine].count("skipped") == 8
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith(
        "== dry-run done: 66 ok, 16 skipped, 0 errors ==")
    assert "[single-pod-16x16] cobs-index x query_b64: ok index/chip=0.44GiB" \
        in printed
    assert "[multi-pod-2x16x16] xlstm-125m x long_500k: ok t_comp=" \
        in printed
    assert not torch.cuda.is_initialized()


def test_main_flags_and_error_exit(tmp_path, monkeypatch, capsys):
    assert dryrun.main(["--arch", "cobs", "--mesh", "multi"]) == 0
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k",
                        "--mesh", "single"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("[multi-pod-2x16x16] cobs-index") for line in
               lines)
    assert any(line.startswith("[single-pod-16x16] qwen2.5-3b x train_4k: "
                               "ok") for line in lines)
    assert not any("single-pod-16x16] cobs" in line for line in lines)

    def broken(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "make_cell", broken)
    assert dryrun.main(["--arch", "xlstm-125m", "--mesh", "single",
                        "--smoke"]) == 1
    printed = capsys.readouterr().out
    assert "xlstm-125m x train_4k: error RuntimeError: boom" in printed
    assert "0 ok, 0 skipped, 4 errors" in printed


# JAX's count of a cell on XLA-CPU lies between the model's at the
# compute dtype and at fp32 (XLA-CPU reduces bf16 in fp32; JAX's parser
# halves only the promoted all-reduces it can see); beyond that, XLA's
# resharding (all-to-all, collective-permute) and its choice of all-reduce
# for reduce-scatter, which the model leaves out, get 25%.
TOL = 0.25
# Cells that drop out of the bound when one term is left out of the model.
TEETH = {"qwen3-4b x train_4k": "tp_allreduce",
         "qwen3-4b x decode_32k": "fsdp_gather",
         "qwen3-moe-30b-a3b x train_4k": "moe_dispatch",
         "llama4-scout-17b-a16e x prefill_32k": "moe_dispatch",
         "whisper-large-v3 x train_4k": "grad_reduce",
         "recurrentgemma-2b x train_4k": "tp_allreduce"}


def in_bound(r: dict, drop: str | None = None) -> bool:
    total = sum(r["jax"].values())
    nat = sum(sum(v.values()) for k, v in r["port_terms"].items()
              if k != drop)
    f32 = sum(sum(v.values()) for k, v in r["port_terms_f32"].items()
              if k != drop)
    return nat <= (1 + TOL) * total and f32 >= (1 - TOL) * total


def test_collective_model_beside_jax_compiled():
    """Every smoke cell's modelled collectives within the bound of JAX's
    compiled ones but the cells ``analysis.COLL_LOWER_BOUND`` names, which
    fall short of it (so their records give a lower bound); the COBS step's
    equal to JAX's by kind; and the bound has teeth (``TEETH``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" /
                             "torch_dryrun_collectives_check.py")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    lm = {k: r for k, r in out.items() if not k.startswith("cobs-index")}
    assert len(lm) == len([c for c in CELLS if jspecs.cell_supported(
        jax_configs.get(c[0], smoke=True), c[1])[0]]) == 32
    short = {tuple(k.split(" x ")) for k, r in lm.items()
             if not in_bound(r)}
    assert short == analysis.COLL_LOWER_BOUND
    for arch, shape in short:
        r = lm[f"{arch} x {shape}"]
        assert r["ratio_f32"] < 1 - TOL, (arch, shape, r["ratio_f32"])
    for cell, term in TEETH.items():
        assert in_bound(lm[cell]) and not in_bound(lm[cell], drop=term), \
            (cell, term)
    cobs = {k: r for k, r in out.items() if k.startswith("cobs-index")}
    assert len(cobs) == 4
    for cell, r in cobs.items():
        assert r["port"] == r["jax"] and r["ratio"] == 1.0, cell
        assert set(r["jax"]) == {"all-reduce", "all-gather"}, cell
