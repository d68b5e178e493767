"""Multi-pod dry-run, analytic: the JAX package's ``launch/dryrun.py`` without
a compiler.

For every (architecture x input shape) cell and each production mesh
(single pod 16x16 = 256 devices; two pods 2x16x16 = 512), built on the
"meta" device so that nothing is allocated and no device is touched:

    cell = make_cell(arch, shape, make_production_mesh(device="meta"))
    memory_from_specs(...)       # per-device argument and output bytes
    analyze(...)                 # FLOPs, bytes, collectives: the roofline

JAX lowers and compiles each cell on forced host devices and reads XLA's
``memory_analysis``, ``cost_analysis`` and the optimized HLO. PyTorch has
no SPMD lowering, so every number here comes from the resolved specs and
``launch/analytic.py``; what runs a step is ``chip_smoke.py [dryrun:*]``,
on the card. Results stream to a JSONL file with JAX's keys where their
meaning holds. Dropped, as no compiler runs: ``lower_s`` and ``compile_s``
(``build_s`` times the cell's construction instead), ``memory``'s
``temp_size_in_bytes`` and ``generated_code_size_in_bytes``, and the
roofline's ``hlo_flops_raw`` and ``hlo_bytes_raw``. Added:
``memory.argument_bytes`` (each argument's share) and ``coll_terms`` (the
collective model's bytes by term, ``analysis.lm_collective_terms``).
Without ``temp_size_in_bytes`` a cell's memory is its arguments and
outputs only: a lower bound of what a device holds, and no answer to
whether the cell fits. Where the collective model is short
(``analysis.COLL_LOWER_BOUND``), the roofline gives
``t_collective_min_s`` and ``bottleneck_at_min`` in place of
``t_collective_s`` and ``bottleneck``.

Also runs the COBS index cell: the sharded query step at the paper's
scale (documents over ("pod", "data"), Bloom rows over "model"), its arena
a meta tensor.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--smoke]
        [--arch A|all|cobs] [--shape S|all] [--mesh single|multi|both]
        [--out results.jsonl]

Exits 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from .. import configs
from ..core import theory
from ..train.optim import tree_map
from . import analysis
from .mesh import make_production_mesh
from .sharding import NamedSharding, replicated
from .specs import SHAPES, cell_supported, make_cell


def lm_collectives(cell, mesh) -> dict[str, dict[str, int]]:
    """``analysis.lm_collective_terms`` of a cell."""
    params, param_sh = cell.args[0], cell.in_shardings[0]
    if cell.shape.mode == "train":
        params, param_sh = params.params, param_sh.params
    batch_sh = (cell.in_shardings[2] if cell.shape.mode == "decode"
                else cell.in_shardings[1]["tokens"])
    return analysis.lm_collective_terms(
        cell.cfg, cell.shape.mode, cell.shape.seq_len,
        cell.shape.global_batch, mesh, params, cell.param_axes,
        tree_map(lambda s: s.spec, param_sh), batch_sh.spec)


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             smoke: bool = False) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh.devices.size}
    cfg = configs.get(arch, smoke=smoke)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        cell = make_cell(arch, shape_name, mesh, smoke=smoke)
        mem = analysis.memory_from_specs(
            cell.args, cell.in_shardings, cell.outs, cell.out_specs, mesh,
            cell.donate_argnums)
        terms = lm_collectives(cell, mesh)
        roof = analysis.analyze(
            cell.cfg, cell.shape, chips=mesh.devices.size,
            coll=analysis.by_kind(terms),
            coll_lower_bound=(arch, shape_name) in analysis.COLL_LOWER_BOUND)
        rec.update(status="ok", build_s=round(time.time() - t0, 3),
                   memory=mem, roofline=roof.as_dict(), coll_terms=terms,
                   params=cell.cfg.param_count(),
                   active_params=cell.cfg.active_param_count())
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def cobs_arena_shape(n_docs: int = 102_400, n_terms_avg: int = 3_400_000
                     ) -> tuple[int, int, int]:
    """(n_blocks, arena rows, arena words) of the paper-scale compact index
    JAX's dry-run lowers: 1,024-document blocks, each of ``bloom_size``
    rows (FPR 0.3, one hash) rounded up to 512 (a uniform-average
    staircase), 32 words wide."""
    n_blocks = n_docs // 1024
    w = theory.bloom_size(n_terms_avg, 0.3, 1)
    w = (w + 511) // 512 * 512
    return n_blocks, n_blocks * w, 1024 // 32


def cobs_padding(arena_shape: tuple[int, int], mesh_shape: dict) -> dict:
    """How ``DistributedIndex`` (JAX's and the port's) pads and slices an
    arena of ``arena_shape`` (rows, words) on a mesh of ``mesh_shape``
    (axis -> size), documents over the mesh's ("pod", "data") and rows
    over "model": word columns padded to a multiple of the doc shards,
    rows to a multiple of the row stripes; each (doc shard, row stripe)
    slice [row_stripe, words_local] of uint32 words."""
    doc_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    n_doc_shards = math.prod(mesh_shape[a] for a in doc_axes)
    n_row_shards = mesh_shape["model"]
    rows, words = arena_shape
    rows_padded = (rows + n_row_shards - 1) // n_row_shards * n_row_shards
    words_padded = (words + n_doc_shards - 1) // n_doc_shards * n_doc_shards
    row_stripe = rows_padded // n_row_shards
    words_local = words_padded // n_doc_shards
    return {"doc_axes": doc_axes, "n_doc_shards": n_doc_shards,
            "n_row_shards": n_row_shards, "rows_padded": rows_padded,
            "words_padded": words_padded, "row_stripe": row_stripe,
            "words_local": words_local,
            "slice_shape": (row_stripe, words_local),
            "slice_bytes": row_stripe * words_local * 4,
            "n_slices": n_doc_shards * n_row_shards}


def run_cobs_cell(mesh, mesh_name: str, n_docs: int = 102_400,
                  n_terms_avg: int = 3_400_000, batch_queries: int = 64,
                  ell: int = 1024, score_method: str = "vertical",
                  score_dtype=None) -> dict:
    """The sharded COBS query step at paper scale (100k documents, 3.4M avg
    31-mers) without allocating the index: the arena is a meta tensor,
    documents shard over ("pod", "data"), rows over "model", and the step
    returns each query's top 32, as JAX's does.

    ``bytes_per_chip`` counts each input read once and each output written
    once, as PERF.md counts a kernel's bytes: for each query and block, the
    ell rows (Wl words each) the shard body gathers from its stripe (each
    term's row index clipped into it), and the [Q, nb * Wl * 32] scores.
    ``flops_per_chip`` counts the scoring kernel's integer operations a
    query over W = nb * Wl words, as PERF.md does: 2 * planes(ell) *
    (ell * W + W * 32) for the counter bodies ("vertical", "lookup"),
    2 * ell * W * 32 for "unpack"."""
    rec = {"arch": "cobs-index", "shape": f"query_b{batch_queries}",
           "mesh": mesh_name, "chips": mesh.devices.size}
    t0 = time.time()
    try:
        score_dtype = score_dtype or torch.int32
        n_blocks, rows, words = cobs_arena_shape(n_docs, n_terms_avg)
        pad = cobs_padding((rows, words), mesh.shape)
        doc = pad["doc_axes"] if len(pad["doc_axes"]) > 1 \
            else pad["doc_axes"][0]

        def meta(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        rep = replicated(mesh)
        args = (meta(pad["rows_padded"], pad["words_padded"]),
                meta(n_blocks), meta(n_blocks),
                meta(batch_queries, ell, 2), meta(batch_queries))
        arg_sh = (NamedSharding(mesh, ("model", doc)), rep, rep, rep, rep)
        k = min(32, n_blocks * pad["words_local"] * 32)
        outs = (meta(batch_queries, k), meta(batch_queries, k))
        mem = analysis.memory_from_specs(args, arg_sh, outs, (rep, rep),
                                         mesh)
        Q, W = batch_queries, n_blocks * pad["words_local"]
        score_bytes = torch.empty((), dtype=score_dtype).element_size()
        terms = analysis.cobs_collective_terms(
            Q, n_blocks, pad["words_local"], pad["n_doc_shards"],
            pad["n_row_shards"], 32, score_bytes)
        coll = analysis.by_kind(terms)
        ops = (2 * ell * W * 32 if score_method == "unpack" else
               2 * max(1, ell.bit_length()) * (ell * W + W * 32))
        index_bytes = pad["rows_padded"] * pad["words_padded"] * 4
        rec.update(status="ok", build_s=round(time.time() - t0, 3),
                   memory=mem, score_method=score_method,
                   index_bytes_total=index_bytes,
                   index_bytes_per_chip=index_bytes // mesh.devices.size,
                   flops_per_chip=float(Q * ops),
                   bytes_per_chip=float(Q * ell * W * 4
                                        + Q * W * 32 * score_bytes),
                   coll_breakdown=coll, coll_terms=terms,
                   coll_bytes_per_chip=float(sum(coll.values())))
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (analytic)")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all' or 'cobs'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs/shapes (CI)")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single-pod-16x16",
                       make_production_mesh(device="meta")))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi-pod-2x16x16",
                       make_production_mesh(multi_pod=True, device="meta")))

    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    out_path = Path(args.out) if args.out else None
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)

    failures = 0
    records = []
    for mesh_name, mesh in meshes:
        if args.arch in ("all", "cobs"):
            rec = run_cobs_cell(mesh, mesh_name)
            records.append(rec)
            _emit(rec, out_path)
            failures += rec["status"] == "error"
        if args.arch == "cobs":
            continue
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh, mesh_name,
                               smoke=args.smoke)
                records.append(rec)
                _emit(rec, out_path)
                failures += rec["status"] == "error"

    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    print(f"\n== dry-run done: {ok} ok, {sk} skipped, {failures} errors ==")
    return 1 if failures else 0


def _emit(rec: dict, out_path: Path | None) -> None:
    status = rec["status"]
    extra = ""
    if status == "ok" and "roofline" in rec:
        r = rec["roofline"]
        if "t_collective_s" in r:
            coll = f"t_coll={r['t_collective_s']:.3e}s -> {r['bottleneck']}"
        else:
            coll = (f"t_coll>={r['t_collective_min_s']:.3e}s -> "
                    f"{r['bottleneck_at_min']} or collective")
        extra = (f" t_comp={r['t_compute_s']:.3e}s "
                 f"t_mem={r['t_memory_s']:.3e}s {coll}")
    elif status == "ok":
        extra = f" index/chip={rec.get('index_bytes_per_chip', 0)/2**30:.2f}GiB"
    elif status == "error":
        extra = " " + rec.get("error", "")
    elif status == "skipped":
        extra = " " + rec.get("reason", "")
    print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status}{extra}",
          flush=True)
    if out_path:
        with out_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    sys.exit(main())
