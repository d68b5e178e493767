"""The port's LM layers, MoE, RG-LRU and xLSTM blocks against the JAX
package's, on the CPU.

Inputs are numpy draws from a seed; parameters are JAX's, carried across
as numpy. Tolerances: fp32 outputs ``rtol = atol = 1e-4`` (two libraries'
fp32 reductions differ in order, nothing more); outputs at the configs'
bf16 ``2e-2`` (the bound of ``tests/test_archs_smoke.py``); the blockwise
attention against JAX's direct form ``1e-5`` (``tests/test_attention.py``'s
bound); integers (masks, MoE expert picks, capacity slots and drops,
partition specs) exactly.

* ``rope``, ``rmsnorm``, ``dense``, ``causal_mask``, ``mlp_apply`` (gated
  and GELU) and ``attention`` (masked, unmasked, MQA);
* ``chunked_attention`` over ``tests/test_attention.py``'s sweep (causal,
  window, window with block skipping, prime sizes, bidirectional cross,
  MQA) against JAX's direct ``attention``;
* ``moe_apply`` at a capacity that drops picks, and its local dispatch
  under a mesh with a "model" axis;
* ``rglru_apply``, ``mlstm_apply`` and ``slstm_apply`` against JAX's, and
  their parallel forms against their own step-by-step decode;
* ``resolve_spec``, ``split_meta`` and ``hint``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import partition as jpart
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.models.config import ModelConfig as JaxConfig
from repro.models.config import MoEConfig as JaxMoE
from repro.launch.mesh import make_mesh as jax_mesh

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import partition as tpart
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm
from repro_torch.models.config import ModelConfig, MoEConfig

torch.set_num_threads(2)

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
KW = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=64, vocab=128)
CFG = ModelConfig(**KW)
JCFG = JaxConfig(**KW)
F32 = dict(compute_dtype="float32")


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _t(tree):
    """A JAX (or numpy) tree of arrays -> the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(np.array(a.astype(np.float32)
                                     if a.dtype.name == "bfloat16" else a))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _init(fn, *args, seed=0, **kw):
    """JAX's init of a layer -> (jax values, torch values)."""
    values, _ = jpart.split_meta(fn(jax.random.PRNGKey(seed), *args, **kw))
    return values, _t(values)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- norms, rope, dense, masks, MLPs -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rmsnorm_dense(dtype):
    x = _x(2, 7, 4, 16)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    tol = FP32 if dtype == "float32" else BF16
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for theta in (10_000.0, 1_000_000.0):
        _close(tl.rope(xt, torch.from_numpy(pos.copy()), theta),
               jl.rope(xj, jnp.asarray(pos), theta), tol)
    scale = _x(16, seed=1)
    for eps in (1e-6, 1e-5):
        _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, xt, eps),
               jl.rmsnorm({"scale": jnp.asarray(scale)}, xj, eps), tol)
    pj, pt = _init(jl.dense_init, 16, 24, ("embed", "ff"), bias=True)
    pj["b"] = jnp.asarray(_x(24, seed=2))
    pt["b"] = torch.from_numpy(_x(24, seed=2))
    _close(tl.dense(pt, xt, dtype), jl.dense(pj, xj, dtype), tol)
    assert tl.dense(pt, xt, dtype).dtype == getattr(torch, dtype)


def test_causal_mask_exact():
    rng = np.random.default_rng(3)
    pq = rng.integers(0, 40, (2, 9)).astype(np.int32)
    pk = rng.integers(-1, 40, (2, 13)).astype(np.int32)
    valid = rng.random((2, 13)) < 0.8
    for window in (None, 5):
        for kv_valid in (None, valid):
            want = jl.causal_mask(jnp.asarray(pq), jnp.asarray(pk), window,
                                  None if kv_valid is None
                                  else jnp.asarray(kv_valid))
            got = tl.causal_mask(torch.from_numpy(pq), torch.from_numpy(pk),
                                 window, None if kv_valid is None
                                 else torch.from_numpy(kv_valid))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(gated, dtype):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    jcfg = dataclasses.replace(JCFG, compute_dtype=dtype)
    pj, pt = _init(jl.mlp_init, jcfg, gated=gated)
    # unit-RMS inputs, as the MLP sees them after rmsnorm: outputs stay
    # within a few units, where one bf16 step is under the tolerance
    x = _x(2, 5, 64, seed=4)
    _close(tl.mlp_apply(pt, cfg, torch.from_numpy(x)),
           jl.mlp_apply(pj, jcfg, jnp.asarray(x)),
           FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("n_kv", [2, 1])
def test_attention_equal(n_kv):
    q, k, v = _x(2, 9, 4, 16, seed=5), _x(2, 11, n_kv, 16, seed=6), \
        _x(2, 11, n_kv, 16, seed=7)
    pos_q = np.broadcast_to(np.arange(2, 11, dtype=np.int32), (2, 9))
    pos_k = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    for window in (None, 4, "none"):
        if window == "none":
            mj = mt = None
        else:
            mj = jl.causal_mask(jnp.asarray(pos_q), jnp.asarray(pos_k), window)
            mt = torch.from_numpy(np.array(mj))
        want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            JCFG, mask=mj)
        got = tl.attention(*map(torch.from_numpy, (q, k, v)), CFG, mask=mt)
        _close(got, want, FP32)


# -- blockwise attention against JAX's direct form -----------------------------

def _qkv(B, S, T, H=4, n_kv=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, n_kv, hd)).astype(np.float32),
            rng.normal(size=(B, T, n_kv, hd)).astype(np.float32))


@pytest.mark.parametrize("S,window,bq,bk,n_kv", [
    (300, None, 64, 96, 2),     # causal, unaligned blocks
    (300, 64, 64, 96, 2),       # window without skipping (nw >= nk)
    (700, 48, 64, 96, 2),       # window WITH block skipping
    (257, 100, 32, 64, 2),      # prime-ish sizes -> padding paths
    (200, None, 64, 64, 1),     # MQA group expansion
])
def test_chunked_equals_jax_direct_causal(S, window, bq, bk, n_kv):
    q, k, v = _qkv(2, S, S, n_kv=n_kv, seed=S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JCFG,
                        mask=jl.causal_mask(jnp.asarray(pos),
                                            jnp.asarray(pos), window))
    pt = torch.from_numpy(pos)
    got = tl.chunked_attention(*map(torch.from_numpy, (q, k, v)), CFG,
                               positions_q=pt, positions_kv=pt, causal=True,
                               window=window, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_chunked_bidirectional_cross_equals_jax_direct():
    """Encoder/cross attention: q and kv lengths differ, no causality."""
    q, k, v = _qkv(2, 150, 400, seed=7)
    pq = torch.arange(150, dtype=torch.int32)[None].expand(2, 150)
    pk = torch.arange(400, dtype=torch.int32)[None].expand(2, 400)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JCFG,
                        mask=None)
    got = tl.chunked_attention(*map(torch.from_numpy, (q, k, v)), CFG,
                               positions_q=pq, positions_kv=pk, causal=False,
                               window=None, bq=64, bk=96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_chunked_equals_jax_chunked_window_not_causal():
    """A window without causality reads every kv block, as JAX's does."""
    q, k, v = _qkv(1, 130, 390, seed=11)
    pq = np.broadcast_to(np.arange(130, dtype=np.int32), (1, 130)).copy()
    pk = np.broadcast_to(np.arange(390, dtype=np.int32), (1, 390)).copy()
    want = jl.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JCFG,
        positions_q=jnp.asarray(pq), positions_kv=jnp.asarray(pk),
        causal=False, window=40, bq=32, bk=64)
    got = tl.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), CFG,
        positions_q=torch.from_numpy(pq), positions_kv=torch.from_numpy(pk),
        causal=False, window=40, bq=32, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# -- MoE -------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,shared", [(2, False), (1, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_with_drops(top_k, shared, dtype):
    """A capacity of 4 slots an expert for 24 tokens: picks are dropped."""
    moe = dict(n_experts=4, top_k=top_k, d_ff_expert=32, shared_expert=shared,
               capacity_factor=0.5)
    kw = dict(KW, d_ff=32, block_pattern=(("moe", 1),), compute_dtype=dtype)
    cfg = ModelConfig(**kw, moe=MoEConfig(**moe))
    jcfg = JaxConfig(**kw, moe=JaxMoE(**moe))
    pj, pt = _init(jmoe.moe_init, jcfg, seed=3)
    x = _x(2, 12, 64, seed=8)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out_j, aux_j = jax.jit(jmoe.moe_apply, static_argnums=1)(pj, jcfg, xj)
    out_t, aux_t = tmoe.moe_apply(pt, cfg, xt)
    tol = FP32 if dtype == "float32" else BF16
    _close(out_t, out_j, tol)
    for key in ("moe_aux", "moe_z"):
        _close(aux_t[key], aux_j[key], tol)
    # the routing, as moe.py computes it: picks, capacity slots, drops
    xf = xj.reshape(24, 64).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ pj["router"].astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(gate_idx, 4, dtype=jnp.int32)
    flat = onehot.reshape(24 * top_k, 4)
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(
        24, top_k)
    cap = jmoe._capacity(24, jcfg.moe)
    _, _, _, idx_t, pos_t, keep_t = tmoe.route(pt, cfg, xt.reshape(24, 64))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(pos < cap))
    assert not keep_t.all()                     # the capacity drops picks


def test_moe_top_k_keeps_lower_index_on_ties():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k``."""
    moe = MoEConfig(n_experts=8, top_k=3, d_ff_expert=8)
    cfg = ModelConfig(**dict(KW, block_pattern=(("moe", 1),)), moe=moe)
    p = {"router": torch.zeros(64, 8)}
    _, _, _, idx, _, _ = tmoe.route(p, cfg, torch.ones(5, 64))
    want = jax.lax.top_k(jnp.full((5, 8), 0.125), 3)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_moe_local_dispatch_waits_for_sharding():
    """(Named when the local dispatch waited for ``launch/sharding.py``; it
    now runs.) ``dispatch="local"``: without a context ``moe_apply`` takes
    the einsum path, under a (data 1, model 2) mesh the local one, which
    equals JAX's ``moe_apply_local`` on a (1, 1) mesh at fp32 (one data
    shard: the same capacity; the model split only partitions experts)."""
    moe = dict(n_experts=4, top_k=1, d_ff_expert=8, dispatch="local")
    kw = dict(KW, block_pattern=(("moe", 1),), **F32)
    cfg = ModelConfig(**kw, moe=MoEConfig(**moe))
    jcfg = JaxConfig(**kw, moe=JaxMoE(**moe))
    pj, pt = _init(jmoe.moe_init, jcfg, seed=4)
    x = _x(1, 4, 64, seed=2)
    out_e, _ = tmoe.moe_apply(pt, cfg, torch.from_numpy(x))   # no context
    want_e, _ = jax.jit(jmoe.moe_apply_einsum, static_argnums=1)(
        pj, jcfg, jnp.asarray(x))
    _close(out_e, want_e, FP32)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with tpart.partitioning(mesh, {"experts": "model"}):
        out_t, aux_t = tmoe.moe_apply(pt, cfg, torch.from_numpy(x))
    jm = jax_mesh((1, 1), ("data", "model"))
    with jm:
        out_j, aux_j = jax.jit(lambda p, x: jmoe.moe_apply_local(
            p, jcfg, x, jm))(pj, jnp.asarray(x))
    _close(out_t, out_j, FP32)
    for key in ("moe_aux", "moe_z"):
        _close(aux_t[key], aux_j[key], FP32)


# -- recurrent blocks: against JAX, and parallel against stepwise ----------------

RECURRENT = {
    "rglru": (jrglru.rglru_init, jrglru.rglru_apply, trglru.rglru_apply),
    "mlstm": (jxlstm.mlstm_init, jxlstm.mlstm_apply, txlstm.mlstm_apply),
    "slstm": (jxlstm.slstm_init, jxlstm.slstm_apply, txlstm.slstm_apply),
}


@pytest.mark.parametrize("kind", list(RECURRENT))
def test_recurrent_block_parallel_equals_jax_and_stepwise(kind):
    init, japply, tapply = RECURRENT[kind]
    cfg = dataclasses.replace(CFG, **F32)
    jcfg = dataclasses.replace(JCFG, **F32)
    pj, pt = _init(init, jcfg, seed=5)
    x = _x(2, 10, 64, seed=9)
    out_j, st_j = jax.jit(japply, static_argnums=1)(pj, jcfg, jnp.asarray(x))
    out_t, st_t = tapply(pt, cfg, torch.from_numpy(x))
    _close(out_t, out_j, FP32)
    assert set(st_t) == set(st_j)
    for key in st_j:
        _close(st_t[key], st_j[key], FP32)
    # prefill 6 tokens in parallel, then 4 steps: equal the parallel pass
    _, st = tapply(pt, cfg, torch.from_numpy(x[:, :6]))
    for t in range(6, 10):
        step, st = tapply(pt, cfg, torch.from_numpy(x[:, t:t + 1]), state=st)
        _close(step[:, 0], out_t[:, t], FP32)
    for key in st_t:
        _close(st[key], st_t[key], FP32)


def test_affine_scan_equals_sequential():
    rng = np.random.default_rng(12)
    for S in (1, 2, 5, 16, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3)))
        b = torch.from_numpy(rng.normal(size=(2, S, 3)))
        _, h = trglru.affine_scan(a, b)
        want, prev = [], torch.zeros(2, 3, dtype=torch.float64)
        for t in range(S):
            prev = a[:, t] * prev + b[:, t]
            want.append(prev)
        np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(),
                                   rtol=1e-12, atol=1e-12)


# -- partitioning ------------------------------------------------------------------

def test_resolve_spec_equal():
    jm = jax_mesh((1, 1), ("data", "model"))
    tm = make_mesh((1, 1), ("data", "model"), device="cpu")

    class Sized:                # JAX's rules read only mesh.shape
        def __init__(self, shape):
            self.shape = shape

    rules = {"embed": "data", "heads": "model", "kv": "model",
             "ff": ("data", "model"), "vocab": None, "batch": "data"}
    cases = [(("embed", "heads", "head_dim"), (64, 4, 16)),
             (("embed", "kv", "head_dim"), (64, 3, 16)),
             (("ff", "embed"), (64, 32)), (("vocab", "embed"), (512, 64)),
             (("batch", "seq", "embed"), None),
             (("embed", "embed"), (64, 64)), (("embed",), (64, 2))]
    for shape in ({"data": 2, "model": 4}, {"data": 1, "model": 1}):
        for axes, dims in cases:
            want = jpart.resolve_spec(axes, dims, Sized(shape), rules)
            got = tpart.resolve_spec(axes, dims, Sized(shape), rules)
            assert got == tuple(want), (axes, dims, shape)
    assert tpart.resolve_spec(("embed",), (64,), tm, rules) == \
        tuple(jpart.resolve_spec(("embed",), (64,), jm, rules))


def test_split_meta_and_hint():
    tree = {"a": tpart.ParamMeta(torch.zeros(2, 3), ("x", None)),
            "b": {"c": tpart.ParamMeta(torch.ones(4), ("y",))}}
    values, axes = tpart.split_meta(tree)
    assert axes == {"a": ("x", None), "b": {"c": ("y",)}}
    assert values["b"]["c"] is tree["b"]["c"].value
    x = torch.randn(2, 3)
    assert tpart.hint(x, "batch", None) is x
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with tpart.partitioning(mesh, {"batch": "data"}):
        assert tpart.current() == (mesh, {"batch": "data"})
        assert tpart.hint(x, "batch", None) is x
    assert tpart.current() is None
