"""The port's ``moe_apply_local`` (per-data-shard capacity, each mesh
position running its own experts) against the JAX package's ``shard_map``
version, on the CPU.

* a (data 1, model 1) mesh in process: outputs, aux losses and the grads of
  every weight equal JAX's at fp32 (``rtol = atol = 1e-5``; measured at
  most 3e-7);
* a (data 2, model 2) mesh: JAX runs in a subprocess with 4 forced host
  devices (``tests/torch_moe_local_check.py``, as ``tests/test_distributed.py``
  runs ``distributed_check.py``); the port on a (2, 2) mesh of the CPU
  equals it at fp32 (``1e-5``). The capacity factor (0.5) drops picks at
  both the per-shard capacity (4 slots for 16 tokens) and the global one
  (8 for 32), so the result differs from the global-capacity dispatch.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import moe as jmoe
from repro.models import partition as jpart
from repro.models.config import ModelConfig as JaxConfig
from repro.models.config import MoEConfig as JaxMoE

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import partition as tpart
from repro_torch.models.config import ModelConfig, MoEConfig

torch.set_num_threads(2)

_SCRIPT = Path(__file__).parent / "torch_moe_local_check.py"
_SRC = str(Path(__file__).parent.parent / "src")
TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=32, vocab=128, block_pattern=(("moe", 1),),
          compute_dtype="float32")
MOE = dict(n_experts=4, top_k=2, d_ff_expert=32, shared_expert=True,
           capacity_factor=0.5, dispatch="local")
CFG = ModelConfig(**KW, moe=MoEConfig(**MOE))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_one_position_equals_jax_with_grads():
    jcfg = JaxConfig(**KW, moe=JaxMoE(**MOE))
    pj, _ = jpart.split_meta(jmoe.moe_init(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(0).normal(size=(2, 12, 64)).astype(np.float32)
    jm = jax_mesh((1, 1), ("data", "model"))

    def loss(p, x):
        out, aux = jmoe.moe_apply_local(p, jcfg, x, jm)
        return (out ** 2).mean() + aux["moe_aux"] + aux["moe_z"], (out, aux)

    with jm:
        (_, (oj, aj)), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            pj, jnp.asarray(x))
    pt = jax.tree.map(lambda a: _t(a).requires_grad_(True), pj)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    ot, at = tmoe.moe_apply_local(pt, CFG, torch.from_numpy(x), mesh)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), **TOL)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(at[k].detach()), float(aj[k]),
                                   **TOL)
    total = (ot ** 2).mean() + at["moe_aux"] + at["moe_z"]
    total.backward()
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        leaf = pt
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe") / "jax_2x2.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(_SCRIPT), str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n" \
                                 f"{proc.stderr}"
    assert "MOE-LOCAL-OK" in proc.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _params(z):
    p = {k[2:]: torch.from_numpy(v) for k, v in z.items()
         if k.startswith("p_")}
    p["shared"] = {k[7:]: torch.from_numpy(v) for k, v in z.items()
                   if k.startswith("shared_")}
    return p


def test_two_by_two_mesh_equals_jax(jax_2x2):
    p, x = _params(jax_2x2), torch.from_numpy(jax_2x2["x"])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with tpart.partitioning(mesh, {"experts": "model"}):
        out, aux = tmoe.moe_apply(p, CFG, x)          # takes the local path
    np.testing.assert_allclose(out.numpy(), jax_2x2["out"], **TOL)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(aux[k]), float(jax_2x2[k]), **TOL)
    # per-shard capacity shows: one data shard (global capacity) differs
    one, _ = tmoe.moe_apply_local(
        p, CFG, x, make_mesh((1, 2), ("data", "model"), device="cpu"))
    assert not np.allclose(one.numpy(), jax_2x2["out"], **TOL)


def test_positions_and_their_devices(jax_2x2, monkeypatch):
    """Data shard s and model position m run on ``mesh.devices`` at (s, m)
    (row-major over ("pod", "data"), other axes at 0), each with its
    ``n_experts / model`` experts; a batch that does not split raises."""
    p, x = _params(jax_2x2), torch.from_numpy(jax_2x2["x"])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    seen = []
    body = tmoe._local_body

    def recorded(cfg, xb, router, wi, wg, wo, m):
        seen.append((m, tuple(wi.shape), xb.shape[0]))
        return body(cfg, xb, router, wi, wg, wo, m)

    monkeypatch.setattr(tmoe, "_local_body", recorded)
    out, _ = tmoe.moe_apply_local(p, CFG, x, mesh)
    assert seen == [(m, (2, 64, 32), 2) for s in range(2) for m in range(2)]
    np.testing.assert_allclose(out.numpy(), jax_2x2["out"], **TOL)
    with pytest.raises(ValueError, match="data shards"):
        tmoe.moe_apply_local(p, CFG, x[:3], mesh)

    class Named:                   # a mesh whose devices are their names
        axis_names = ("pod", "data", "model", "x")
        shape = {"pod": 2, "data": 3, "model": 2, "x": 2}
        devices = np.array([f"{a}{b}{c}{d}" for a in range(2)
                            for b in range(3) for c in range(2)
                            for d in range(2)], dtype=object) \
            .reshape(2, 3, 2, 2)

    dp = ("pod", "data")
    for s in range(6):
        for m in range(2):
            pod, data = divmod(s, 3)
            assert tmoe._position(Named, dp, s, m) == f"{pod}{data}{m}0"
