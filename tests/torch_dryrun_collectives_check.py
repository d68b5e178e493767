"""The port's collective model against JAX's compiled collectives, for
``tests/test_torch_dryrun.py`` (which runs this file in a subprocess: the
rest of the suite must see one device).

On a (data 2, model 2) mesh of 4 forced host devices, JAX lowers and
compiles every supported smoke cell as its dry-run does, and
``repro.launch.analysis.collective_bytes`` reads the optimized HLO; the
port's ``launch.dryrun.lm_collectives`` gives its model's bytes for the
same cell on a "meta" mesh of the same shape, once at the cell's compute
dtype and once with every activation at fp32 (XLA-CPU reduces bf16 in
fp32, and JAX's parser halves only the promoted all-reduces it can see, so
JAX's count lies between the two). The COBS query step is compared the
same way: JAX's ``run_cobs_cell`` and the port's at a small index, on the
(2, 2) mesh and on (pod 2, data 1, model 2).

Prints one JSON object: for each cell, JAX's bytes a device by kind, the
port's (``port``, ``port_f32``, and the same by term), and the ratios of
the totals (port / JAX).

    PYTHONPATH=src python tests/torch_dryrun_collectives_check.py
"""
import dataclasses
import json
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

assert len(jax.devices()) == 4, jax.devices()

from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.launch.specs import make_cell as jax_cell  # noqa: E402
from repro.models.partition import partitioning  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import SHAPES, cell_supported, make_cell  # noqa

COBS = dict(n_docs=4096, n_terms_avg=10_000, batch_queries=8, ell=64)
COBS_MESHES = (((2, 2), ("data", "model")),
               ((2, 1, 2), ("pod", "data", "model")))


def jax_collectives(arch: str, shape: str, mesh) -> dict:
    cell = jax_cell(arch, shape, mesh, smoke=True)
    with mesh, partitioning(mesh, jshd.act_rules_for(mesh)):
        compiled = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate_argnums
                           ).lower(*cell.args).compile()
    return janalysis.collective_bytes(compiled.as_text())


def entry(want: dict, terms: dict, terms_f32: dict) -> dict:
    got, got32 = analysis.by_kind(terms), analysis.by_kind(terms_f32)
    total = max(1, sum(want.values()))
    return {"jax": want, "port": got, "port_f32": got32,
            "port_terms": terms, "port_terms_f32": terms_f32,
            "ratio": sum(got.values()) / total,
            "ratio_f32": sum(got32.values()) / total}


def main() -> None:
    jmesh = jax_mesh((2, 2), ("data", "model"))
    tmesh = make_mesh((2, 2), ("data", "model"), device="meta")
    out = {}
    for arch in configs.list_archs():
        for shape in SHAPES:
            if not cell_supported(configs.get(arch, smoke=True), shape)[0]:
                continue
            cell = make_cell(arch, shape, tmesh, smoke=True)
            wide = dataclasses.replace(cell, cfg=dataclasses.replace(
                cell.cfg, compute_dtype="float32"))
            out[f"{arch} x {shape}"] = entry(
                jax_collectives(arch, shape, jmesh),
                dryrun.lm_collectives(cell, tmesh),
                dryrun.lm_collectives(wide, tmesh))
    for shape, names in COBS_MESHES:
        name = "x".join(map(str, shape))
        for method in ("vertical", "unpack"):
            want = jdryrun.run_cobs_cell(jax_mesh(shape, names), name,
                                         score_method=method, **COBS)
            got = dryrun.run_cobs_cell(make_mesh(shape, names,
                                                 device="meta"), name,
                                       score_method=method, **COBS)
            assert want["status"] == got["status"] == "ok", (want, got)
            out[f"cobs-index {method} on {name}"] = entry(
                want["coll_breakdown"], got["coll_terms"], got["coll_terms"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
