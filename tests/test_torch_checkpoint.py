"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the cases
of ``tests/test_checkpoint.py`` on the port, and checkpoints written by one
package and read by the other, both ways, exactly.

The cross-package cases save a ``TrainState`` after 2 train steps of a
smoke config in each package and compare the manifests (leaf names, keys,
shapes, dtypes, hashes) and the arrays byte for byte; a tree with a
bfloat16 leaf (JAX's ml_dtypes bfloat16, the port's ``torch.bfloat16``)
crosses both ways with its bytes and its ``"bfloat16"`` manifest dtype.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.checkpoint.store import _leaf_paths as jax_leaf_paths
from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_train_step as jax_make_train_step

from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointManager,
                                    latest_step, load_pytree, save_pytree)
from repro_torch.checkpoint.store import _leaf_paths as port_leaf_paths
from repro_torch.train import AdamWConfig, make_train_step

from _torch_train_common import OPT, both, make_batch

torch.set_num_threads(2)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
            "nested": {"b": torch.arange(5), "c": torch.tensor(3.0)},
            "list": [torch.ones(2, 2), torch.zeros(3)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_tree_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    t2 = load_pytree(t, tmp_path / "ck")
    _assert_tree_equal(t, t2)
    assert list(t2) == list(t) and isinstance(t2["list"], list)


def test_corruption_detected(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    man = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    man["leaves"][0]["hash"] = "0" * 32
    (tmp_path / "ck" / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(IOError):
        load_pytree(t, tmp_path / "ck")


def test_shape_mismatch_detected(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    bad = dict(t)
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        load_pytree(bad, tmp_path / "ck")


def test_atomic_no_partial_state(tmp_path):
    """A leftover .tmp dir (simulated crash) must not shadow a good save."""
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep_last=2)
    mgr.save(0, t)
    (tmp_path / "step_1.tmp").mkdir()          # crashed writer
    assert latest_step(tmp_path) == 0
    restored, step = mgr.restore(t)
    assert step == 0
    _assert_tree_equal(t, restored)


def test_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    restored, step = mgr.restore(_tree())
    assert step == 4
    _assert_tree_equal(_tree(4), restored)


def test_async_checkpointer(tmp_path):
    mgr = CheckpointManager(tmp_path)
    ac = AsyncCheckpointer(mgr)
    t = _tree(1)
    ac.save(7, t)
    ac.wait()
    restored, step = mgr.restore(t)
    assert step == 7
    _assert_tree_equal(t, restored)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_async_snapshot_isolated_from_mutation(tmp_path, kind):
    """The async writer persists the state AT save() time even if the
    caller mutates the buffers at once (what an in-place step does)."""
    mgr = CheckpointManager(tmp_path)
    ac = AsyncCheckpointer(mgr)
    arr = np.ones((1000, 100), np.float32)
    leaf = arr if kind == "numpy" else torch.from_numpy(arr)
    ac.save(0, {"w": leaf})
    arr *= 0.0                                  # mutate after save
    ac.wait()
    template = {"w": np.zeros_like(arr) if kind == "numpy"
                else torch.zeros(1000, 100)}
    restored, _ = mgr.restore(template)
    assert float(restored["w"].mean()) == 1.0


def test_async_error_raised_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    ac = AsyncCheckpointer(mgr)
    mgr.root = tmp_path / "file"
    mgr.root.write_text("not a directory")
    ac.save(0, _tree())
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                                   # raised once


# -- across packages -------------------------------------------------------

def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


@pytest.fixture(scope="module")
def states():
    """A TrainState after 2 steps of qwen3-moe smoke (fp32 compute) in
    each package, from the same JAX state."""
    jm, st, model, state = both("qwen3-moe-30b-a3b", "float32")
    batch = make_batch(model.cfg)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamW(**OPT)))
    tstep = make_train_step(model, AdamWConfig(**OPT))
    for _ in range(2):
        st, _ = jstep(st, batch)
        state, _ = tstep(state, batch)
    return st, state


def test_train_state_names_equal(tmp_path, states):
    st, state = states
    jax_save(st, tmp_path / "jax")
    save_pytree(state, tmp_path / "port")
    mj, mt = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert mj["format"] == mt["format"] == "repro-ckpt-v1"
    strip = lambda m: [(x["name"], x["key"], x["shape"], x["dtype"])
                       for x in m["leaves"]]
    assert strip(mt) == strip(mj)
    names = [x["name"] for x in mt["leaves"]]
    assert names[0] == ".step" and names[-1] == ".rng"
    assert ".opt_state/count" in names
    assert any(n.startswith(".opt_state/mu/segments/") for n in names)
    by = {x["name"]: x for x in mt["leaves"]}
    assert by[".rng"]["dtype"] == "uint32" and by[".step"]["dtype"] == "int32"
    # the integer leaves (step, count, rng) are equal, so are their hashes
    for x, y in zip(mj["leaves"], mt["leaves"]):
        if x["dtype"] in ("int32", "uint32"):
            assert x["hash"] == y["hash"], x["name"]


def test_jax_writes_port_reads(tmp_path, states):
    st, state = states
    JaxManager(tmp_path).save(1, st)
    got, step = CheckpointManager(tmp_path).restore(state)
    assert step == 1 and type(got) is type(state)
    want, _ = jax_leaf_paths(st)
    have = port_leaf_paths(got)
    assert [n for n, _ in have] == [n for n, _ in want]
    for (name, g), (_, w) in zip(have, want):
        assert isinstance(g, torch.Tensor), name
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w)


def test_port_writes_jax_reads(tmp_path, states):
    st, state = states
    CheckpointManager(tmp_path).save(3, state)
    got, step = JaxManager(tmp_path).restore(st)
    assert step == 3
    have, _ = jax_leaf_paths(got)
    want = port_leaf_paths(state)
    assert [n for n, _ in have] == [n for n, _ in want]
    for (name, g), (_, w) in zip(have, want):
        g, w = np.asarray(g), w.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w)
    # JAX saving what it read writes the port's manifest: same hashes
    jax_save(got, tmp_path / "again")
    assert _manifest(tmp_path / "again")["leaves"] == \
        _manifest(tmp_path / "step_3")["leaves"]


def test_bfloat16_leaf_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "n": jnp.arange(4)}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "n": torch.arange(4, dtype=torch.int32)}
    jax_save(jtree, tmp_path / "jax")
    save_pytree(ttree, tmp_path / "port")
    mj, mt = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert mj["leaves"] == mt["leaves"]        # names, dtypes and hashes
    assert [x["dtype"] for x in mt["leaves"]] == ["int32", "bfloat16"]
    with np.load(tmp_path / "port" / "arrays.npz") as z:
        assert z["a1"].dtype == np.dtype("V2")
    got = load_pytree(ttree, tmp_path / "jax")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], ttree["w"])
    back = jax_load(jtree, tmp_path / "port")
    np.testing.assert_array_equal(
        np.asarray(back["w"]).view(np.uint16),
        np.asarray(jtree["w"]).view(np.uint16))
