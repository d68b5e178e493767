"""The port's ``Model`` against the JAX package's, for every arch's
``smoke()`` config, on the CPU.

JAX's parameters (``init`` at ``PRNGKey(0)``) are carried into the port
with ``params_from_numpy``. For each arch, at fp32 compute (through
``dataclasses.replace``) and at the config's own bf16:

* ``forward_train`` logits and aux losses, with ``enc_feats`` for whisper
  and ``vis_embeds`` for the two vision archs;
* ``prefill`` of 10 tokens into a cache of 16: logits and every cache leaf;
* two ``decode_step``s after it: logits and every cache leaf.

Tolerances: fp32 ``rtol = atol = 1e-4``; integer leaves (cache ``pos``,
ring ``kpos``) exact. bf16 ``rtol = atol = 5e-2``, the bound
``tests/test_archs_smoke.py`` puts between JAX's own bf16 decode and
forward: two libraries round bf16 at other points (XLA on the CPU keeps
fused intermediates in fp32), and both land about equally far from the
fp32 function while differing from each other by more than 2e-2 on
several archs. At bf16 a MoE
router whose top-k margin is under ``TIE`` (bf16 noise in the router's
inputs) may pick another expert in each package, so each batch row is
compared only before its first such token (caches: those positions; a
decode step: rows with none up to it). The routes themselves are exact at
fp32 here and in ``tests/test_torch_lm_layers.py``.

Also, exactly: ``init``'s tree, shapes, dtypes and logical axes equal
JAX's (the values are the port's own draws), ``abstract_params``
allocates nothing and matches ``init``, the cache axes equal, and
``params_from_numpy`` rejects a wrong tree. A recurrentgemma whose window
(4) is shorter than its cache wraps its ring cache over two decode steps
equal to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import build_model as jax_build

from repro_torch import configs
from repro_torch.models import Model, build_model, params_from_numpy
from repro_torch.models import moe as torch_moe

torch.set_num_threads(2)

ARCHS = jax_configs.list_archs()
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, S, CACHE = 2, 12, 16
TIE = 5e-3          # a bf16 router margin under this may flip an expert
CPU = "cpu"


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _snap(tree):
    return {k: v.clone() for k, v in _flat(tree).items()}


def assert_tree_close(got: dict, want, tol, cut=None):
    """Every leaf of ``want`` (a JAX tree) against the port's flat dict;
    ``cut[b]`` limits row b's positions (axis 2 of a stacked K/V)."""
    want = _flat(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = _np(got[path]), _np(w)
        assert g.shape == w.shape, path
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif cut is None or g.ndim < 3:
            np.testing.assert_allclose(g, w, err_msg=path, **tol)
        else:
            for b, n in enumerate(cut):
                np.testing.assert_allclose(g[:, b, :n], w[:, b, :n],
                                           err_msg=path, **tol)


class Ties:
    """Where a bf16 router margin under ``TIE`` may have flipped an expert:
    a tie before the last MoE layer reaches every later position of its
    row through attention (``cut[b]``, the first such position); one in
    the last MoE layer reaches only its own token's output (``lone[b]``)."""

    def __init__(self):
        self.cut, self.lone = [S] * B, [set() for _ in range(B)]

    def add(self, row: int, pos: int, last_layer: bool) -> None:
        if last_layer:
            self.lone[row].add(pos)
        else:
            self.cut[row] = min(self.cut[row], pos)

    def ok(self, row: int, pos: int) -> bool:
        """Whether the logits of (row, pos) are comparable."""
        return pos < self.cut[row] and pos not in self.lone[row]

    def positions(self, row: int, n: int) -> list:
        return [p for p in range(n) if self.ok(row, p)]


def _configs(arch, dtype):
    jcfg = jax_configs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    if dtype != jcfg.compute_dtype:
        jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return jcfg, cfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
           if cfg.n_enc_layers else None)
    vis = (rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32)
           if cfg.frontend == "vision" else None)
    return toks, enc, vis


def _jax_run(jm, params, toks, enc, vis):
    def run(p, toks, enc, vis):
        full = jm.forward_train(p, toks, enc_feats=enc, vis_embeds=vis)
        lp, c0 = jm.prefill(p, toks[:, :S - 2], CACHE, enc_feats=enc)
        l1, c1 = jm.decode_step(p, c0, toks[:, S - 2:S - 1],
                                jnp.asarray(S - 2, jnp.int32))
        l2, c2 = jm.decode_step(p, c1, toks[:, S - 1:S],
                                jnp.asarray(S - 1, jnp.int32))
        return full, (lp, c0), (l1, c1), (l2, c2)
    return jax.block_until_ready(jax.jit(run)(params, toks, enc, vis))


def _port_run(model, params, toks, enc, vis, tie=None):
    """The port's forward, prefill and two decodes, and the ``Ties`` of
    router margins under ``tie`` (none when ``tie`` is None)."""
    margins, phase = [], {"at": 0, "calls": 0}
    route = torch_moe.route

    def recorded(p, cfg, xt):
        out = route(p, cfg, xt)
        probs = out[1].sort(dim=-1, descending=True).values
        k = cfg.moe.top_k
        margins.append((phase["at"], phase["calls"],
                        probs[:, k - 1] - probs[:, k]))
        phase["calls"] += 1
        return out

    torch_moe.route = recorded
    try:
        full = model.forward_train(params, toks, enc_feats=enc,
                                   vis_embeds=vis)
        phase["calls"] = 0
        lp, c = model.prefill(params, toks[:, :S - 2], CACHE, enc_feats=enc)
        out = [full, (lp, _snap(c))]
        for t in (S - 2, S - 1):
            phase.update(at=t, calls=0)
            lg, c = model.decode_step(params, c, toks[:, t:t + 1], t)
            out.append((lg, _snap(c)))
    finally:
        torch_moe.route = route
    ties = Ties()
    n_moe = sum(n for kind, n in model.cfg.block_pattern if kind == "moe")
    for offset, layer, m in margins:   # B rows of tokens from ``offset`` on
        n = m.numel() // B
        for i in (m < tie).nonzero().flatten().tolist() if tie else ():
            row, pos = divmod(i, n)
            ties.add(row, offset + pos, layer == n_moe - 1)
    return out, ties


@pytest.fixture(scope="module")
def runs():
    """(arch, dtype) -> {"jax": outputs, "torch": outputs}, computed once."""
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            jcfg, cfg = _configs(arch, dtype)
            jm = jax_build(jcfg)
            jparams, _ = jm.init(jax.random.PRNGKey(0))
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       CPU, cfg=cfg)
            ins = _inputs(cfg)
            memo[(arch, dtype)] = {
                "jax": _jax_run(jm, jparams, *ins),
                "torch": _port_run(build_model(cfg, CPU), params, *ins,
                                   tie=TIE if dtype == "bfloat16" else None)}
        return memo[(arch, dtype)]
    return get


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_equal(runs, arch, dtype):
    r = runs(arch, dtype)
    (lj, aux_j), ((lt, aux_t), ties) = r["jax"][0], (r["torch"][0][0],
                                                     r["torch"][1])
    assert lt.dtype == torch.float32 and lt.shape == (B, S, lt.shape[2])
    for b in range(B):
        keep = ties.positions(b, S)
        np.testing.assert_allclose(_np(lt)[b, keep], _np(lj)[b, keep],
                                   **TOL[dtype])
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(_np(aux_t[k]), _np(aux_j[k]), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_equal(runs, arch, dtype):
    r = runs(arch, dtype)
    (lj, cj), ((lt, ct), ties) = r["jax"][1], (r["torch"][0][1],
                                               r["torch"][1])
    for b in range(B):
        keep = ties.positions(b, S - 2)
        np.testing.assert_allclose(_np(lt)[b, keep], _np(lj)[b, keep],
                                   **TOL[dtype])
    assert_tree_close(ct, cj, TOL[dtype], ties.cut)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_two_decode_steps_equal(runs, arch, dtype):
    r = runs(arch, dtype)
    (out, ties), compared = r["torch"], 0
    for t, (lj, cj), (lt, ct) in zip((S - 2, S - 1), r["jax"][2:], out[2:]):
        assert lt.shape == (B, 1, lt.shape[2])
        rows = [b for b in range(B) if ties.ok(b, t)]
        np.testing.assert_allclose(_np(lt)[rows], _np(lj)[rows], **TOL[dtype])
        assert_tree_close(ct, cj, TOL[dtype], ties.cut)
        compared += len(rows)
    assert compared > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_axes_equal(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    jparams, jaxes = jax_build(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    params, axes = model.init(torch.Generator().manual_seed(0))
    want, got = _flat(jparams), _flat(params)
    assert set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype)
        assert got[path].device.type == "cpu"
    is_axes = lambda x: isinstance(x, tuple)                      # noqa: E731
    assert axes == jax.tree.map(lambda a: a, jaxes, is_leaf=is_axes)
    # the draws: JAX's distributions, not JAX's values
    tok = got["/embed/tok"]
    assert abs(float(tok.std()) - 0.02) < 0.002
    assert torch.equal(got["/final_norm/scale"],
                       torch.ones(cfg.d_model))
    # the same generator state draws the same tree
    again, _ = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(_flat(again).values(), got.values()))
    jm = jax_build(jcfg)
    assert model.cache_axes() == jax.tree.map(
        lambda a: a, jm.cache_axes(), is_leaf=is_axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_allocate_nothing(arch):
    _, cfg = _configs(arch, "bfloat16")
    model = build_model(cfg, CPU)
    values, axes = model.abstract_params()
    real, real_axes = model.init(torch.Generator().manual_seed(1))
    assert axes == real_axes
    flat, flat_real = _flat(values), _flat(real)
    assert set(flat) == set(flat_real)
    for path, v in flat.items():
        assert v.device.type == "meta", path
        assert v.shape == flat_real[path].shape
        assert v.dtype == flat_real[path].dtype
    # a full config's shapes, with nothing allocated
    full = build_model(configs.get(arch), CPU).abstract_params()[0]
    n = sum(v.numel() for v in _flat(full).values())
    assert n > 50e6
    assert all(v.device.type == "meta" for v in _flat(full).values())


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg = configs.get("qwen3-4b", smoke=True)
    model = build_model(cfg, CPU)
    good, _ = model.init(torch.Generator().manual_seed(0))
    tree = jax.tree.map(lambda t: t.numpy(), good)
    params = params_from_numpy(tree, CPU, cfg=cfg)
    assert all(torch.equal(a, b) for a, b in
               zip(_flat(params).values(), _flat(good).values()))

    def edited(fn):
        t = jax.tree.map(lambda a: a, tree)
        fn(t)
        return t

    seg = "seg0_attn"
    bad = {
        "missing": edited(lambda t: t["segments"][seg]["attn"].pop("wq")),
        "extra": edited(lambda t: t["segments"][seg]["attn"].update(
            wz=np.zeros(3, np.float32))),
        "shape": edited(lambda t: t["embed"].update(
            tok=np.zeros((cfg.vocab + 1, cfg.d_model), np.float32))),
        "dtype": edited(lambda t: t["final_norm"].update(
            scale=np.ones(cfg.d_model, np.float64))),
        "not a dict": edited(lambda t: t.update(segments=np.zeros(2))),
    }
    for what, t in bad.items():
        with pytest.raises(ValueError):
            params_from_numpy(t, CPU, cfg=cfg)


def test_ring_cache_wraps_equal():
    """recurrentgemma with a window of 4 under a cache of 16: the local
    layers' ring holds 4 slots; a prefill of 10 writes its last 4, and two
    decode steps wrap around it, at fp32."""
    jcfg, cfg = _configs("recurrentgemma-2b", "float32")
    jcfg = dataclasses.replace(jcfg, window=4)
    cfg = dataclasses.replace(cfg, window=4)
    jm, model = jax_build(jcfg), build_model(cfg, CPU)
    jparams, _ = jm.init(jax.random.PRNGKey(4))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU,
                               cfg=cfg)
    toks, _, _ = _inputs(cfg)
    want = _jax_run(jm, jparams, toks, None, None)
    got, _ = _port_run(model, params, toks, None, None)
    ring = got[1][1]["/seg0_griffin/b3/attn/kpos"]
    assert ring.shape == (1, B, 4)
    for (lj, cj), (lt, ct) in zip(want[1:], got[1:]):
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL["float32"])
        assert_tree_close(ct, cj, TOL["float32"])
    np.testing.assert_array_equal(
        got[3][1]["/seg0_griffin/b3/attn/kpos"][0, 0].numpy(),
        [8, 9, 10, 11])                         # slots 0, 1 overwritten


def test_model_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("xlstm-125m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert Model(cfg, "cpu").device == torch.device("cpu")
