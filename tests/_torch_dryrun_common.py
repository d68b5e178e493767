"""Shared by the dry-run tests (``tests/test_torch_specs.py``,
``tests/test_torch_dryrun.py``): JAX's cells, leaf by leaf, beside the
port's.

* ``jax_smoke_cell``: JAX's own ``make_cell(smoke=True)`` on a (1, 1) mesh
  of its one CPU device, and ``jax_smoke_cell_on`` on a duck-typed mesh
  (JAX's ``NamedSharding`` replaced by a probe that keeps the spec);
* ``jax_full_specs``: JAX's rule engine (``repro.launch.sharding``) on
  JAX's ``eval_shape`` trees at full width, on a duck-typed production mesh
  (as ``tests/test_torch_sharding.py``), assembled as JAX's ``make_cell``
  assembles them. The abstract trees do not depend on the mesh and are
  built once a cell.

Leaves are compared as (path, shape, dtype name) and specs as tuples, so
every comparison is exact.
"""
import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from repro import configs as jax_configs
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import build_model as jax_build
from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_init_state as jax_init_state

from repro_torch.launch.analysis import flatten

ARCHS = jax_configs.list_archs()
SHAPE_NAMES = tuple(jspecs.SHAPES)
CELLS = [(a, s) for a in ARCHS for s in SHAPE_NAMES]


class FakeMesh:
    """Duck-typed mesh for pure rule-resolution tests."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


def leaves(tree) -> list[tuple[str, tuple, str]]:
    """(path, shape, dtype name) of each leaf (a meta tensor or a
    ``ShapeDtypeStruct``)."""
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten(tree)]


def specs(tree) -> list[tuple[str, tuple]]:
    """(path, spec tuple) of each sharding leaf (either package's)."""
    return [(p, tuple(s.spec)) for p, s in flatten(tree)]


@functools.lru_cache(maxsize=None)
def jax_smoke_cell(arch: str, shape: str):
    return jspecs.make_cell(arch, shape, jax_mesh((1, 1), ("data", "model")),
                            smoke=True)


@functools.lru_cache(maxsize=None)
def _jax_trees(arch: str, shape: str):
    cfg = jax_configs.get(arch)
    s = jspecs.SHAPES[shape]
    model = jax_build(cfg)
    pshapes, paxes = model.abstract_params()
    B, S = s.global_batch, s.seq_len
    if s.mode == "train":
        extra = jax.eval_shape(jax_init_state(model, JaxAdamW()),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        extra = jax.eval_shape(lambda: model.init_cache(B, S))
    return cfg, model, pshapes, paxes, extra


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(tuple(shape), jnp.dtype(dtype))


def jax_full_specs(arch: str, shape: str, mesh):
    """(args, in-spec tuples, donate_argnums) of JAX's full-width cell on
    the duck-typed ``mesh``, as JAX's ``make_cell`` builds them."""
    cfg, model, pshapes, paxes, extra = _jax_trees(arch, shape)
    s = jspecs.SHAPES[shape]
    B, S = s.global_batch, s.seq_len
    param = jshd.tree_specs(paxes, pshapes, mesh)
    rep = PartitionSpec()
    bspec = batch_spec(mesh, B)

    def batch(labels: bool):
        b = {"tokens": _sds((B, S), jnp.int32)}
        if labels:
            b["labels"] = _sds((B, S), jnp.int32)
        if cfg.n_enc_layers:
            b["enc_feats"] = _sds((B, cfg.enc_seq, cfg.d_model), jnp.float32)
        return b, {k: bspec for k in b}

    if s.mode == "train":
        state_sp = extra._replace(
            step=rep, params=param,
            opt_state={"mu": param, "nu": param, "count": rep}, rng=rep)
        b, bsp = batch(True)
        return (extra, b), (state_sp, bsp), (0,)
    cache_sp = jshd.tree_specs(model.cache_axes(), extra, mesh,
                               jshd.CACHE_RULES)
    if s.mode == "prefill":
        b, bsp = batch(False)
        return (pshapes, b), (param, bsp), ()
    return ((pshapes, extra, _sds((B, 1), jnp.int32), _sds((), jnp.int32)),
            (param, cache_sp, bspec, rep), (1,))


class _Probe:
    """Stands in for JAX's ``NamedSharding``, which wants a real mesh: it
    keeps the spec."""
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _on_fake_mesh(fn, *args, **kw):
    orig = jshd.NamedSharding
    jshd.NamedSharding = _Probe
    try:
        return fn(*args, **kw)
    finally:
        jshd.NamedSharding = orig


def batch_spec(mesh, batch_size: int) -> PartitionSpec:
    """JAX's ``batch_sharding`` spec on a duck-typed mesh."""
    return _on_fake_mesh(jshd.batch_sharding, mesh, batch_size).spec


def jax_smoke_cell_on(mesh, arch: str, shape: str):
    """JAX's ``make_cell(smoke=True)`` on a duck-typed mesh."""
    return _on_fake_mesh(jspecs.make_cell, arch, shape, mesh, smoke=True)


def spec_leaves(tree) -> list[tuple[str, tuple]]:
    """(path, spec tuple) of a tree whose leaves are ``PartitionSpec``s (a
    tuple subclass)."""
    return [(p, tuple(x)) for p, x in flatten(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]
