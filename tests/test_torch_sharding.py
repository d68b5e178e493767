"""The port's sharding rule engine (``repro_torch.launch.sharding``) and
``models.partition.hint`` against the JAX package's, on the CPU, exactly:
the cases of ``tests/test_sharding.py``, then every arch's ``full()``
parameters and decode caches resolved on the production meshes (16x16 and
2x16x16, duck-typed) with PARAM_RULES and CACHE_RULES, each spec equal to
``tuple(jax spec)``.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jax_configs
from repro.launch import sharding as jshd
from repro.models import build_model as jax_build
from repro.models.partition import resolve_spec as jax_resolve_spec

from repro_torch import configs
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, partition

ARCHS = jax_configs.list_archs()


class FakeMesh:
    """Duck-typed mesh for pure rule-resolution tests."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
SINGLE = FakeMesh({"data": 16, "model": 16})


@pytest.mark.parametrize("axes,shape,mesh,rules,want", [
    (("vocab", "embed"), (256000, 2560), MESH, None, P("model", "data")),
    # phi4: 24 heads don't divide 16 -> heads dim unsharded
    (("embed", "heads", "head_dim"), (3072, 24, 128), MESH, None, P("data")),
    # both dims want "model": only the first gets it
    (("ff", "vocab"), (8192, 256000), MESH, None, P("model")),
    (("batch", "seq"), (256, 4096), MESH, None, P(("pod", "data"))),
    (("batch", "kv_seq"), (1, 524288), MESH, None, P()),
    # kv=8 doesn't divide 16 -> cache shards head_dim instead
    (("batch", "kv_seq", "kv", "head_dim"), (128, 32768, 8, 128), MESH,
     "cache", P(("pod", "data"), None, None, "model")),
    (("embed", "kv", "head_dim"), (3072, 8, 128), MESH, None, P("data")),
    (("batch",), (256,), SINGLE, None, P("data")),
    ((None, "embed"), (8192, 64), MESH, None, P(None, "data")),
])
def test_spec_for_equal(axes, shape, mesh, rules, want):
    rules_t = shd.CACHE_RULES if rules == "cache" else None
    rules_j = jshd.CACHE_RULES if rules == "cache" else None
    got = shd.spec_for(axes, shape, mesh, rules_t)
    assert got == tuple(want)
    assert got == tuple(jshd.spec_for(axes, shape, mesh, rules_j))


def test_rule_tables_equal():
    assert shd.PARAM_RULES == jshd.PARAM_RULES
    assert shd.CACHE_RULES == jshd.CACHE_RULES
    assert shd.ACT_RULES == jshd.ACT_RULES


@pytest.mark.parametrize("mesh", [FakeMesh({"data": 4}), SINGLE, MESH,
                                  FakeMesh({"model": 2})])
def test_act_rules_for_equal(mesh):
    got = shd.act_rules_for(mesh)
    assert got == jshd.act_rules_for(mesh)
    if "model" not in mesh.axis_names:
        assert got["ff"] is None
    assert got["embed"] is None


@pytest.mark.parametrize("batch", [1, 8, 32, 256])
@pytest.mark.parametrize("mesh", [FakeMesh({"data": 4}), SINGLE, MESH,
                                  FakeMesh({"model": 2})])
def test_batch_sharding_equal(mesh, batch):
    got = shd.batch_sharding(mesh, batch)

    class Probe:        # JAX's NamedSharding wants a real mesh: read spec
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec

    orig = jshd.NamedSharding
    jshd.NamedSharding = Probe
    try:
        want = jshd.batch_sharding(mesh, batch)
    finally:
        jshd.NamedSharding = orig
    assert got.mesh is mesh and got.spec == tuple(want.spec)


def test_resolve_spec_rank_mismatch_returns_empty():
    assert partition.resolve_spec(("batch", "seq", "embed"), (8, 16), MESH,
                                  {"batch": ("data",)}) == ()
    assert tuple(jax_resolve_spec(("batch", "seq", "embed"), (8, 16), MESH,
                                  {"batch": ("data",)})) == ()


def test_real_mesh_tree_shardings():
    """Size-1 axes shard nothing; the tree keeps its keys."""
    mesh = make_mesh((1,), ("data",), device="cpu")
    axes = {"w": ("embed", "ff"), "b": ("ff",), "n": {"s": ()}}
    shapes = {"w": torch.empty(64, 128, device="meta"),
              "b": torch.empty(128, device="meta"),
              "n": {"s": torch.empty((), device="meta")}}
    sh = shd.tree_shardings(axes, shapes, mesh)
    assert sh["w"] == shd.NamedSharding(mesh, ())
    assert sh["b"].spec == () and sh["n"]["s"].spec == ()
    assert shd.replicated(mesh) == shd.NamedSharding(mesh, ())
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    sh = shd.tree_shardings(axes, shapes, mesh2)
    assert sh["w"].spec == ("data", "model") and sh["b"].spec == ("model",)


def _jax_specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_specs_equal(arch, multi_pod):
    """Every parameter and decode-cache leaf of the full config (batch 128,
    cache 32,768) on the production mesh: the port's spec equals JAX's."""
    mesh = MESH if multi_pod else SINGLE
    jm = jax_build(jax_configs.get(arch))
    model = Model(configs.get(arch), device="meta")
    jshapes, jaxes = jm.abstract_params()
    shapes, axes = model.abstract_params()
    assert axes == jax.tree.map(lambda a: a, jaxes,
                                is_leaf=lambda x: isinstance(x, tuple))
    want = _jax_specs(jshd.tree_specs(jaxes, jshapes, mesh))
    assert shd.tree_specs(axes, shapes, mesh) == want
    if not model.cfg.has_decoder:
        return
    jcache = jax.eval_shape(lambda: jm.init_cache(128, 32768))
    cache = model.init_cache(128, 32768)
    want = _jax_specs(jshd.tree_specs(jm.cache_axes(), jcache, mesh,
                                      jshd.CACHE_RULES))
    got = shd.tree_specs(model.cache_axes(), cache, mesh, shd.CACHE_RULES)
    assert got == want


def test_hint_resolves_under_a_context():
    """``hint`` returns its input; under a context it resolves the spec as
    JAX does, so a rule naming an axis the mesh lacks raises alike."""
    x = torch.zeros(4, 6)
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    with partition.partitioning(mesh, shd.act_rules_for(mesh)):
        assert partition.hint(x, "batch", "ff") is x
    with partition.partitioning(mesh, {"batch": ("pod",)}):
        with pytest.raises(KeyError):
            partition.hint(x, "batch", None)
    with pytest.raises(KeyError):
        jax_resolve_spec(("batch", None), (4, 6), SINGLE, {"batch": ("pod",)})
