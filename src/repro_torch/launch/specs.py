"""Input specifications for every (architecture x shape) dry-run cell, as the
JAX package's ``launch/specs.py``.

Meta tensors stand in for JAX's ``ShapeDtypeStruct``s: shapes and dtypes,
no storage. Each cell bundles the step function (``train_step`` /
``prefill_step`` / ``decode_step``), its abstract arguments, the in- and
out-shardings the rule engine (``launch/sharding.py``) resolves on the
mesh, and the abstract outputs the dry-run's memory model counts.

The model (and so the step function) lives on the mesh's device: "meta"
for the dry-run, which then allocates nothing, or the card, where a caller
makes the arguments real and runs the step. The arguments are always on
"meta".

The train state is built directly where JAX takes ``jax.eval_shape`` of
``make_init_state``: a ``torch.Generator`` cannot exist on "meta". It is
``Model.abstract_params()``, fp32 ``mu`` and ``nu`` of the same shapes,
int32 ``step`` and ``count``, and JAX's uint32 [2] ``rng`` (which the
port's step keeps on the host).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import configs
from ..models import build_model
from ..models.config import ModelConfig
from ..models.transformer import Model
from ..serve.step import make_decode_step, make_prefill_step
from ..train.optim import AdamWConfig, tree_map
from ..train.step import TrainState, make_train_step
from . import sharding as shd


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention;
    decode shapes need a decoder."""
    s = SHAPES[shape_name]
    if s.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (DESIGN.md)"
    if s.mode == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch: no decode step"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _smoke_scale(s: ShapeSpec) -> ShapeSpec:
    """Reduced copy of a shape for CPU smoke compiles."""
    return ShapeSpec(s.name, min(s.seq_len, 64), min(s.global_batch, 8),
                     s.mode)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    model: Model
    step_fn: Callable
    args: tuple                    # abstract args (meta tensors)
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    outs: Any = None               # abstract outputs (meta tensors)
    out_specs: Any = None          # their shardings (every leaf resolved)
    param_axes: Any = None         # logical axes of the params tree


def _batch_specs(cfg: ModelConfig, mesh, B: int, S: int):
    bsh = shd.batch_sharding(mesh, B)
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    shard = {"tokens": bsh, "labels": bsh}
    if cfg.n_enc_layers:
        batch["enc_feats"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                   torch.float32)
        shard["enc_feats"] = bsh
    return batch, shard


def _logits(cfg: ModelConfig, mesh, B: int):
    """The serving steps' [B, 1, V] fp32 logits and their sharding: batch
    over the batch axes, vocab over "model" where they divide."""
    logits = _meta((B, 1, cfg.vocab), torch.float32)
    return logits, shd.NamedSharding(mesh, shd.spec_for(
        ("batch", "seq", "vocab"), tuple(logits.shape), mesh))


def _metrics(cfg: ModelConfig, mesh):
    """The train step's metrics: fp32 scalars, replicated."""
    names = ["loss", "ce", "accuracy", "grad_norm", "lr"]
    if cfg.moe is not None:
        names += ["moe_aux", "moe_z"]
    return ({n: _meta((), torch.float32) for n in names},
            {n: shd.replicated(mesh) for n in names})


def make_cell(arch: str, shape_name: str, mesh,
              smoke: bool = False) -> Cell:
    cfg = configs.get(arch, smoke=smoke)
    s = SHAPES[shape_name]
    if smoke:
        s = _smoke_scale(s)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    model = build_model(cfg, mesh.devices.flat[0])
    abstract = model if model.device.type == "meta" \
        else build_model(cfg, "meta")
    param_shapes, param_axes = abstract.abstract_params()
    param_sh = shd.tree_shardings(param_axes, param_shapes, mesh)
    rep = shd.replicated(mesh)

    B, S = s.global_batch, s.seq_len

    if s.mode == "train":
        opt = AdamWConfig()

        def moments():
            return tree_map(lambda p: torch.empty_like(p,
                                                        dtype=torch.float32),
                             param_shapes)

        state_shape = TrainState(
            step=_meta((), torch.int32), params=param_shapes,
            opt_state={"mu": moments(), "nu": moments(),
                       "count": _meta((), torch.int32)},
            rng=_meta((2,), torch.uint32))
        state_sh = state_shape._replace(
            step=rep, params=param_sh,
            opt_state={"mu": param_sh, "nu": param_sh, "count": rep},
            rng=rep)
        batch, batch_sh = _batch_specs(cfg, mesh, B, S)
        step = make_train_step(model, opt)
        metrics, metrics_sh = _metrics(cfg, mesh)
        return Cell(arch, s, cfg, model, step,
                    (state_shape, batch), (state_sh, batch_sh),
                    (state_sh, None), donate_argnums=(0,),
                    outs=(state_shape, metrics),
                    out_specs=(state_sh, metrics_sh), param_axes=param_axes)

    cache_shape = abstract.init_cache(B, S)
    cache_sh = _cache_shardings(model, mesh, cache_shape)
    logits, logits_sh = _logits(cfg, mesh, B)
    if s.mode == "prefill":
        batch, batch_sh = _batch_specs(cfg, mesh, B, S)
        batch.pop("labels")
        batch_sh.pop("labels")
        step = make_prefill_step(model, cache_len=S)
        return Cell(arch, s, cfg, model, step,
                    (param_shapes, batch), (param_sh, batch_sh),
                    (None, cache_sh), outs=(logits, cache_shape),
                    out_specs=(logits_sh, cache_sh), param_axes=param_axes)

    # decode: one new token against a seq_len cache
    tokens = _meta((B, 1), torch.int32)
    pos = _meta((), torch.int32)
    bsh = shd.batch_sharding(mesh, B)
    step = make_decode_step(model)
    return Cell(arch, s, cfg, model, step,
                (param_shapes, cache_shape, tokens, pos),
                (param_sh, cache_sh, bsh, rep),
                (None, cache_sh), donate_argnums=(1,),
                outs=(logits, cache_shape), out_specs=(logits_sh, cache_sh),
                param_axes=param_axes)


def _cache_shardings(model: Model, mesh, cache_shape):
    return shd.tree_shardings(model.cache_axes(), cache_shape, mesh,
                              rules=shd.CACHE_RULES)
