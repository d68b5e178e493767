"""The port's dry-run cells (``repro_torch.launch.specs``) against the JAX
package's (``repro.launch.specs``), on the CPU, exactly:

* ``SHAPES``, ``_smoke_scale`` and ``cell_supported`` of every (arch x
  shape) pair, smoke and full configs: the 32 supported cells and the 8
  documented skips;
* each supported smoke cell on a (1, 1) mesh against JAX's ``make_cell``
  on ``make_mesh((1, 1), ...)``: every argument leaf's path, shape and
  dtype, every in-sharding's spec equal to ``tuple(jax spec)``, the
  out-shardings JAX names, and ``donate_argnums``;
* at full width on the production meshes (16x16 and 2x16x16; duck-typed on
  the JAX side, "meta" on the port's), every argument leaf and spec equal
  to JAX's rule engine on JAX's ``eval_shape`` trees;
* a full-width ``llama4-scout-17b-a16e`` train cell built in seconds with
  every tensor on "meta" (nothing allocated).
"""
import time

import pytest
import torch
from _torch_dryrun_common import (CELLS, MULTI, SHAPE_NAMES, SINGLE,
                                  jax_full_specs, jax_smoke_cell, leaves,
                                  spec_leaves, specs)

from repro import configs as jax_configs
from repro.launch import specs as jspecs

from repro_torch import configs
from repro_torch.launch import specs as tspecs
from repro_torch.launch.analysis import flatten
from repro_torch.launch.mesh import make_mesh, make_production_mesh

META_11 = make_mesh((1, 1), ("data", "model"), device="meta")
PRODUCTION = {"single": (SINGLE, make_production_mesh(device="meta")),
              "multi": (MULTI, make_production_mesh(multi_pod=True,
                                                    device="meta"))}


def test_shapes_equal():
    assert tuple(tspecs.SHAPES) == tuple(jspecs.SHAPES) == SHAPE_NAMES
    for name, s in tspecs.SHAPES.items():
        assert dataclass_tuple(s) == dataclass_tuple(jspecs.SHAPES[name])
        assert dataclass_tuple(tspecs._smoke_scale(s)) == dataclass_tuple(
            jspecs._smoke_scale(jspecs.SHAPES[name]))


def dataclass_tuple(s):
    return (s.name, s.seq_len, s.global_batch, s.mode)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_supported_equal(arch, shape):
    for smoke in (False, True):
        assert tspecs.cell_supported(configs.get(arch, smoke=smoke), shape) \
            == jspecs.cell_supported(jax_configs.get(arch, smoke=smoke),
                                     shape)


def test_supported_count_32_of_40():
    ok = [tspecs.cell_supported(configs.get(a), s)[0] for a, s in CELLS]
    assert len(ok) == 40 and sum(ok) == 32
    runners = sorted(a for a in configs.list_archs()
                     if tspecs.cell_supported(configs.get(a),
                                              "long_500k")[0])
    assert runners == ["recurrentgemma-2b", "xlstm-125m"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_equals_jax(arch, shape):
    if not tspecs.cell_supported(configs.get(arch, smoke=True), shape)[0]:
        with pytest.raises(ValueError):
            tspecs.make_cell(arch, shape, META_11, smoke=True)
        with pytest.raises(ValueError):
            jax_smoke_cell(arch, shape)
        return
    cell = tspecs.make_cell(arch, shape, META_11, smoke=True)
    want = jax_smoke_cell(arch, shape)
    assert dataclass_tuple(cell.shape) == dataclass_tuple(want.shape)
    assert leaves(cell.args) == leaves(want.args)
    assert specs(cell.in_shardings) == specs(want.in_shardings)
    assert specs(cell.out_shardings) == specs(want.out_shardings)
    assert cell.donate_argnums == want.donate_argnums
    assert all(t.device.type == "meta" for _, t in flatten(cell.args))
    assert cell.model.device.type == "meta"


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_full_cell_specs_equal_jax(arch, shape, mesh):
    fake, meta = PRODUCTION[mesh]
    if not tspecs.cell_supported(configs.get(arch), shape)[0]:
        with pytest.raises(ValueError):
            tspecs.make_cell(arch, shape, meta)
        return
    cell = tspecs.make_cell(arch, shape, meta)
    args, in_specs, donate = jax_full_specs(arch, shape, fake)
    assert leaves(cell.args) == leaves(args)
    assert specs(cell.in_shardings) == spec_leaves(in_specs)
    assert cell.donate_argnums == donate


def test_full_llama4_cell_is_fast_and_allocates_nothing():
    """109 G parameters (fp32 state about 1.3 TB) as meta tensors."""
    t0 = time.perf_counter()
    cell = tspecs.make_cell("llama4-scout-17b-a16e", "train_4k",
                            PRODUCTION["single"][1])
    took = time.perf_counter() - t0
    leaves_ = flatten(cell.args) + flatten(cell.outs)
    assert all(t.device.type == "meta" for _, t in leaves_)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in flatten(cell.args[0]))
    assert state_bytes > 1e12
    assert took < 30, f"{took:.1f} s"
    assert not torch.cuda.is_initialized()


def test_a_card_mesh_keeps_arguments_on_meta():
    """A mesh of another device puts the model (and so the step) there;
    the arguments stay abstract."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    cell = tspecs.make_cell("xlstm-125m", "decode_32k", mesh, smoke=True)
    assert cell.model.device.type == "cpu"
    assert all(t.device.type == "meta" for _, t in flatten(cell.args))
    assert leaves(cell.args) == leaves(
        tspecs.make_cell("xlstm-125m", "decode_32k", META_11,
                         smoke=True).args)
