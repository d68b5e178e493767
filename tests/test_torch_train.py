"""The port's ``train/`` (AdamW, the schedule, ``loss_fn``, remat,
``TrainState``) against the JAX package's, on the CPU, and the loss and
grads of half the archs' ``smoke()`` configs (the other half in
``tests/test_torch_train_grads.py``; 4-step trajectories in
``tests/test_torch_train_steps.py``).

JAX's state (``make_init_state`` at ``PRNGKey(1)``) is carried into the
port with ``state_from_numpy``; batches are numpy draws from a seed.
Tolerances:

* ``cosine_schedule`` ``rtol = 1e-6`` (fp32 ``cos`` of two libraries);
* ``adamw_update`` on equal numpy inputs ``rtol = atol = 1e-6`` (fp32, the
  same arithmetic leaf by leaf; ``add_``/``addcmul_`` may fuse a multiply);
* loss and grads as ``tests/_torch_train_common.py`` states (fp32: loss
  1e-5, each grad leaf 1e-4 of its largest |JAX grad|; bf16: loss 5e-2,
  grads 0.15 of it, MoE rows cut at a router near tie);
* step counters, init trees and ``rng`` (JAX's threefry ``fold_in``)
  exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.train import AdamWConfig as JaxAdamW
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import cosine_schedule as jax_cosine
from repro.train import loss_fn as jax_loss_fn

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, loss_fn, make_init_state,
                               state_from_numpy)
from repro_torch.train.optim import tree_leaves, tree_map
from repro_torch.train.prng import fold_in, prng_key

from _torch_train_common import (ARCHS, DTYPES, LOSS_TOL, OPT,
                                 check_loss_and_grads, configs_at,
                                 jax_state, make_batch, port_grads)

torch.set_num_threads(2)


# -- schedule and optimizer ---------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 10), (100, 50)])
def test_cosine_schedule_equal(warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total,
              min_lr_ratio=0.1)
    steps = range(0, total + 20)
    want = [float(jax_cosine(JaxAdamW(**kw), jnp.asarray(s, jnp.int32)))
            for s in steps]
    got = [float(cosine_schedule(AdamWConfig(**kw),
                                 torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if warmup == 10:
        assert got[0] == 0.0 and got[10] == pytest.approx(1e-3)
        assert got[100] == pytest.approx(1e-4)


def test_adamw_init_tree_equal():
    jcfg, cfg = configs_at("granite-3-8b", "float32")
    jparams, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    params, _ = build_model(cfg, "cpu").init(torch.Generator()
                                             .manual_seed(0))
    want, got = jax_adamw_init(jparams), adamw_init(params)
    assert set(got) == set(want) == {"mu", "nu", "count"}
    for key in ("mu", "nu"):
        flat_w = jax.tree_util.tree_flatten_with_path(want[key])[0]
        flat_g = tree_leaves(got[key])
        assert len(flat_w) == len(flat_g)
        for (_, w), g in zip(flat_w, flat_g):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            assert not g.any()
    assert got["count"].dtype == torch.int32 and got["count"].shape == ()


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": (3, 4, 4), "scale": (5,), "b": (7,)}
    draw = lambda: {k: rng.normal(size=s).astype(np.float32)
                    for k, s in shapes.items()}
    params, grads = draw(), draw()
    state = {"mu": draw(), "nu": {k: np.abs(v) for k, v in draw().items()},
             "count": np.int32(3)}
    return params, grads, state


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_equal(inplace, clip):
    """One update from nonzero moments at count 3, clipping (grad_clip 1)
    or not (100), weight decay on the 2-D and 3-D leaves only."""
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=20,
              grad_clip=clip)
    params, grads, state = _opt_inputs()
    want_p, want_s, want_m = jax_adamw_update(
        JaxAdamW(**kw), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, params))
    tp, tg, ts = _torch(params), _torch(grads), _torch(state)
    got_p, got_s, got_m = adamw_update(AdamWConfig(**kw), tg, ts, tp,
                                       inplace=inplace)
    assert (got_p["w"] is tp["w"]) == inplace
    assert (got_s["mu"]["w"] is ts["mu"]["w"]) == inplace
    if not inplace:                       # the inputs are left as they were
        np.testing.assert_array_equal(tp["w"].numpy(), params["w"])
        np.testing.assert_array_equal(tg["w"].numpy(), grads["w"])
        assert int(ts["count"]) == 3
    tol = dict(rtol=1e-6, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], **tol)
        np.testing.assert_allclose(got_s["mu"][k].numpy(), want_s["mu"][k],
                                   **tol)
        np.testing.assert_allclose(got_s["nu"][k].numpy(), want_s["nu"][k],
                                   **tol)
    assert int(got_s["count"]) == int(want_s["count"]) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-6)


def test_adamw_decay_skips_1d_params():
    cfg = AdamWConfig(lr=1e-2, weight_decay=1.0, warmup_steps=0,
                      total_steps=10)
    params = {"w": torch.ones(4, 4), "scale": torch.ones(4)}
    zeros = tree_map(torch.zeros_like, params)
    new, _, _ = adamw_update(cfg, zeros, adamw_init(params), params)
    assert float(new["w"].mean()) < 1.0          # decayed
    assert float(new["scale"].mean()) == 1.0     # not decayed (zero grad)


def test_grad_clip_bounds_update():
    kw = dict(lr=1e-3, grad_clip=1.0, weight_decay=0.0, warmup_steps=0,
              total_steps=10)
    params = {"w": torch.zeros(8)}
    huge = {"w": torch.full((8,), 1e6)}
    new, _, m = adamw_update(AdamWConfig(**kw), huge, adamw_init(params),
                             params)
    assert float(m["grad_norm"]) == pytest.approx(1e6 * np.sqrt(8),
                                                  rel=1e-5)
    jnew, _, jm = jax_adamw_update(
        JaxAdamW(**kw), {"w": jnp.full((8,), 1e6)},
        jax_adamw_init({"w": jnp.zeros((8,))}), {"w": jnp.zeros((8,))})
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)


# -- loss and grads ----------------------------------------------------------

def test_loss_fn_masked_labels_equal():
    jcfg, cfg = configs_at("phi4-mini-3.8b", "float32")
    jm, model = jax_build(jcfg), build_model(cfg, "cpu")
    st = jax_state(jm)
    params = state_from_numpy(jax.tree.map(np.asarray, st), "cpu",
                              cfg=cfg).params
    b = make_batch(cfg, S=8, seed=1)
    masked = dict(b, labels=b["labels"].copy())
    masked["labels"][:, :4] = -1
    results = []
    for batch in (b, masked):
        lj, mj = jax.jit(lambda p: jax_loss_fn(jm, p, batch))(st.params)
        lt, mt = loss_fn(model, params, batch)
        assert set(mt) == set(mj)
        for k in mj:
            assert abs(float(mt[k]) - float(mj[k])) <= LOSS_TOL["float32"], k
        results.append(float(lt))
    assert results[0] != results[1] and np.isfinite(results[1])
    all_masked = dict(b, labels=np.full_like(b["labels"], -1))
    lt, mt = loss_fn(model, params, all_masked)
    assert float(mt["ce"]) == 0.0 and float(mt["accuracy"]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS[::2])
def test_loss_and_grads_equal(arch, dtype):
    check_loss_and_grads(arch, dtype)


def test_remat_recomputes_blocks_with_equal_grads(monkeypatch):
    """remat="full" runs each block again in the backward pass (the block
    calls double) and gives bit-equal grads; the stacked leaves are unbound
    once a segment (no per-layer select of a stacked leaf)."""
    from repro_torch.models import transformer
    cfg = configs.get("qwen3-4b", smoke=True)
    model = build_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg)
    calls = {"n": 0}
    block = transformer.block_apply

    def counted(*a, **kw):
        calls["n"] += 1
        return block(*a, **kw)

    monkeypatch.setattr(transformer, "block_apply", counted)
    grads = {}
    for remat in ("full", "none"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        calls["n"] = 0
        loss, _, grads[remat] = port_grads(model, params, batch)
        assert calls["n"] == cfg.n_layers * (2 if remat == "full" else 1)
        if remat == "none":
            names, seen, todo = set(), set(), [loss.grad_fn]
            while todo:
                fn = todo.pop()
                if fn is None or fn in seen:
                    continue
                seen.add(fn)
                names.add(type(fn).__name__)
                todo.extend(f for f, _ in fn.next_functions)
            assert "UnbindBackward0" in names
            assert "SelectBackward0" not in names
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)
    with torch.no_grad():                 # no grad: the plain blocks
        calls["n"] = 0
        model.cfg = cfg
        model.forward_train(params, batch["tokens"])
        assert calls["n"] == cfg.n_layers


# -- state -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2 ** 31 - 1])
def test_fold_in_equal(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng_key(seed), np.asarray(key))
    for data in (0, 1, 17, 2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(key, data))
        got = fold_in(prng_key(seed), data)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fold_in(prng_key(0), 17),
                                  [2763999920, 494843597])


@pytest.mark.parametrize("seed", [0, 1])
def test_init_state_tree_and_rng_equal(seed):
    jcfg, cfg = configs_at("qwen3-moe-30b-a3b", "bfloat16")
    want = jax_state(jax_build(jcfg), seed)
    got = make_init_state(build_model(cfg, "cpu"), AdamWConfig(**OPT))(
        torch.Generator().manual_seed(seed))
    assert type(got).__name__ == "TrainState"
    assert got._fields == want._fields
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    assert got.rng.dtype == torch.uint32
    np.testing.assert_array_equal(got.rng.numpy(), np.asarray(want.rng))
    flat_w = jax.tree_util.tree_flatten_with_path(want.opt_state)[0]
    flat_g = tree_leaves({"count": got.opt_state["count"],
                          "mu": got.opt_state["mu"],
                          "nu": got.opt_state["nu"]})
    for (path, w), g in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path


def test_state_from_numpy_rejects_a_wrong_tree():
    jcfg, cfg = configs_at("xlstm-125m", "float32")
    st = jax.tree.map(np.asarray, jax_state(jax_build(jcfg)))
    state = state_from_numpy(st, "cpu", cfg=cfg)
    np.testing.assert_array_equal(state.rng.numpy(), st.rng)
    assert int(state.opt_state["count"]) == 0
    with pytest.raises(ValueError, match="count, mu and nu"):
        state_from_numpy(st._replace(opt_state={"mu": st.opt_state["mu"]}),
                         "cpu", cfg=cfg)
    with pytest.raises(ValueError, match="rng"):
        state_from_numpy(st._replace(rng=st.rng.astype(np.int32)), "cpu",
                         cfg=cfg)
    with pytest.raises(ValueError, match="step"):
        state_from_numpy(st._replace(step=np.zeros(2, np.int32)), "cpu",
                         cfg=cfg)
    mu = dict(st.opt_state["mu"])
    mu["embed"] = {}
    with pytest.raises(ValueError, match="missing keys"):
        state_from_numpy(st._replace(opt_state=dict(st.opt_state, mu=mu)),
                         "cpu", cfg=cfg)


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, cfg = configs_at("xlstm-125m", "float32")
    st = jax.tree.map(np.asarray, jax_state(jax_build(jcfg)))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(st, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_init_state(build_model(cfg), AdamWConfig())
    state = state_from_numpy(st, "cpu", cfg=cfg)
    assert state.step.device == torch.device("cpu")
