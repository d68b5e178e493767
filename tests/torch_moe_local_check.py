"""JAX's ``moe_apply_local`` on a (data 2, model 2) mesh of 4 forced host
devices, for ``tests/test_torch_moe_local.py`` (which runs this file in a
subprocess: the rest of the suite must see one device). Writes the config's
parameters, the input and JAX's outputs to the .npz path it is given.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

assert len(jax.devices()) == 4, jax.devices()

from repro.launch.mesh import make_mesh
from repro.models import moe, partition
from repro.models.config import ModelConfig, MoEConfig

# the test's config: capacity factor 0.5 drops picks at both capacities
KW = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=32, vocab=128, block_pattern=(("moe", 1),),
          compute_dtype="float32")
MOE = dict(n_experts=4, top_k=2, d_ff_expert=32, shared_expert=True,
           capacity_factor=0.5, dispatch="local")

cfg = ModelConfig(**KW, moe=MoEConfig(**MOE))
params, _ = partition.split_meta(moe.moe_init(jax.random.PRNGKey(3), cfg))
x = np.random.default_rng(8).normal(size=(4, 8, 64)).astype(np.float32)
mesh = make_mesh((2, 2), ("data", "model"))
with mesh:
    out, aux = jax.jit(lambda p, x: moe.moe_apply_local(p, cfg, x, mesh))(
        params, jnp.asarray(x))
np.savez(sys.argv[1], x=x, out=np.asarray(out),
         moe_aux=np.asarray(aux["moe_aux"]), moe_z=np.asarray(aux["moe_z"]),
         **{f"p_{k}": np.asarray(v) for k, v in params.items()
            if k != "shared"},
         **{f"shared_{k}": np.asarray(v) for k, v in params["shared"].items()})
print("MOE-LOCAL-OK")
