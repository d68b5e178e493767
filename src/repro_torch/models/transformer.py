"""Model assembly: block dispatch, layer segments, and the functional Model
API (init / forward_train / prefill / decode_step), as the JAX package's
``models/transformer.py``.

Layer stacks are grouped into (kind, count) segments (cfg.block_pattern);
each segment's parameters are stacked along a leading "layers" axis, with
JAX's tree and keys, and the segment runs as a loop over that axis (JAX's
``lax.scan``). Caches are stacked the same way.

A segment's stacked parameters are unbound into its layers once (their
grads are one ``stack`` in the backward pass). Under autograd,
``cfg.remat == "full"`` checkpoints each block as JAX's ``jax.checkpoint``
does (``train/step.py`` takes the grads).

Caches are updated in place: ``prefill`` fills the caches it allocates,
and ``decode_step`` writes the caller's cache tensors (each attention
layer's new K/V slot, each recurrent block's state) and returns them. The
values equal JAX's returned caches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from . import layers, moe as moe_mod, rglru, xlstm
from .config import ModelConfig
from .layers import Draws, dtype_of
from .partition import ParamMeta, is_meta, split_meta


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts with equal keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack_meta(metas: list):
    """Stack per-layer ParamMeta trees along a leading 'layers' axis."""
    if is_meta(metas[0]):
        return ParamMeta(torch.stack([m.value for m in metas]),
                         ("layers",) + tuple(metas[0].axes))
    return {k: _stack_meta([m[k] for m in metas]) for k in metas[0]}


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(draws: Draws, cfg: ModelConfig, kind: str):
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    if kind == "griffin":     # composite: rglru, rglru, local attention
        return {"b1": block_init(draws, cfg, "rglru"),
                "b2": block_init(draws, cfg, "rglru"),
                "b3": block_init(draws, cfg, "local")}
    if kind == "xunit":       # composite: mlstm, slstm
        return {"b1": block_init(draws, cfg, "mlstm"),
                "b2": block_init(draws, cfg, "slstm")}
    p = {"ln1": layers.rmsnorm_init(draws, d, dt)}
    if kind in ("attn", "local", "enc", "moe"):
        p["attn"] = layers.attn_init(draws, cfg)
        p["ln2"] = layers.rmsnorm_init(draws, d, dt)
        if kind == "moe":
            p["moe"] = moe_mod.moe_init(draws, cfg)
        elif cfg.d_ff:
            p["mlp"] = layers.mlp_init(draws, cfg, gated=cfg.gated_mlp)
    elif kind == "xdec":
        p["attn"] = layers.attn_init(draws, cfg)
        p["lnx"] = layers.rmsnorm_init(draws, d, dt)
        p["xattn"] = layers.attn_init(draws, cfg, cross=True)
        p["ln2"] = layers.rmsnorm_init(draws, d, dt)
        if cfg.d_ff:
            p["mlp"] = layers.mlp_init(draws, cfg, gated=cfg.gated_mlp)
    elif kind == "rglru":
        p["rec"] = rglru.rglru_init(draws, cfg)
        p["ln2"] = layers.rmsnorm_init(draws, d, dt)
        if cfg.d_ff:
            p["mlp"] = layers.mlp_init(draws, cfg)
    elif kind == "mlstm":
        p["core"] = xlstm.mlstm_init(draws, cfg)
    elif kind == "slstm":
        p["core"] = xlstm.slstm_init(draws, cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


_COMPOSITE = {"griffin": ("rglru", "rglru", "local"),
              "xunit": ("mlstm", "slstm")}


def block_apply(p, cfg: ModelConfig, kind: str, x, positions, *,
                cache=None, enc_out=None):
    """Returns (x, new_cache, aux) — aux is a dict of scalar extra losses."""
    aux = {}
    if kind in _COMPOSITE:
        new_cache = {} if cache is not None else None
        for i, sub in enumerate(_COMPOSITE[kind]):
            key = f"b{i + 1}"
            sub_c = None if cache is None else cache[key]
            x, c2, a = block_apply(p[key], cfg, sub, x, positions,
                                   cache=sub_c, enc_out=enc_out)
            for k, v in a.items():
                aux[k] = aux.get(k, 0.0) + v
            if new_cache is not None:
                new_cache[key] = c2
        return x, new_cache, aux
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "local", "enc", "moe"):
        attn_cache = None if cache is None else cache.get("attn")
        a, new_attn = layers.attn_apply(p["attn"], cfg, h, positions,
                                        kind=kind, cache=attn_cache)
        x = x + a
        h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            mo, aux = moe_mod.moe_apply(p["moe"], cfg, h2)
            x = x + mo
        elif "mlp" in p:
            x = x + layers.mlp_apply(p["mlp"], cfg, h2)
        new_cache = None if new_attn is None else {"attn": new_attn}
    elif kind == "xdec":
        attn_cache = None if cache is None else cache.get("attn")
        a, new_attn = layers.attn_apply(p["attn"], cfg, h, positions,
                                        kind="attn", cache=attn_cache)
        x = x + a
        hx = layers.rmsnorm(p["lnx"], x, cfg.norm_eps)
        if cache is not None and "ck" in cache and x.shape[1] == 1:
            ckv = (cache["ck"], cache["cv"])      # decode: cached cross-K/V
        else:
            ckv = layers.cross_kv_project(p["xattn"], cfg, enc_out)
        xa, _ = layers.attn_apply(p["xattn"], cfg, hx, positions,
                                  cross_kv=ckv)
        x = x + xa
        h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "mlp" in p:
            x = x + layers.mlp_apply(p["mlp"], cfg, h2)
        new_cache = None if new_attn is None else \
            {"attn": new_attn, "ck": ckv[0], "cv": ckv[1]}
    elif kind in ("rglru", "mlstm", "slstm"):
        # recurrent kinds: S > 1 runs the parallel form (which also yields
        # the exact final state for prefill); S == 1 is the O(1) decode step.
        prefill = x.shape[1] > 1
        key = "rec" if kind == "rglru" else "core"
        st = None if (cache is None or prefill) else cache[key]
        apply = {"rglru": rglru.rglru_apply, "mlstm": xlstm.mlstm_apply,
                 "slstm": xlstm.slstm_apply}[kind]
        r, new_st = apply(p[key], cfg, h, state=st)
        x = x + r
        if kind == "rglru":
            h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
            if "mlp" in p:
                x = x + layers.mlp_apply(p["mlp"], cfg, h2)
        new_cache = None if cache is None else {key: new_st}
    else:
        raise ValueError(kind)
    return x, new_cache, aux


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     enc_len: int = 0, device="cpu"):
    """Zero cache tree for one block of the given kind."""
    if kind in _COMPOSITE:
        return {f"b{i + 1}": block_cache_init(cfg, sub, batch, cache_len,
                                              enc_len, device)
                for i, sub in enumerate(_COMPOSITE[kind])}
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    dt = dtype_of(cfg.compute_dtype)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    pos = zeros(dtype=torch.int32)
    if kind == "local":
        wc = min(cache_len, cfg.window)      # ring buffer: O(window) memory
        return {"attn": {
            "k": zeros(batch, wc, hkv, hd), "v": zeros(batch, wc, hkv, hd),
            "kpos": torch.full((batch, wc), -1, dtype=torch.int32,
                               device=device),
            "pos": pos}}
    if kind in ("attn", "moe"):
        return {"attn": {"k": zeros(batch, cache_len, hkv, hd),
                         "v": zeros(batch, cache_len, hkv, hd), "pos": pos}}
    if kind == "xdec":
        return {"attn": {"k": zeros(batch, cache_len, hkv, hd),
                         "v": zeros(batch, cache_len, hkv, hd), "pos": pos},
                "ck": zeros(batch, enc_len, hkv, hd),
                "cv": zeros(batch, enc_len, hkv, hd)}
    if kind == "rglru":
        return {"rec": rglru.rglru_state_init(cfg, batch, device=device)}
    if kind == "mlstm":
        return {"core": xlstm.mlstm_state_init(cfg, batch, device=device)}
    if kind == "slstm":
        return {"core": xlstm.slstm_state_init(cfg, batch, device=device)}
    raise ValueError(kind)


def block_cache_axes(cfg: ModelConfig, kind: str):
    """Logical-axes tree mirroring block_cache_init (for the sharding rule
    engine)."""
    if kind in _COMPOSITE:
        return {f"b{i + 1}": block_cache_axes(cfg, sub)
                for i, sub in enumerate(_COMPOSITE[kind])}
    kv4 = ("batch", "kv_seq", "kv", "head_dim")
    if kind == "local":
        return {"attn": {"k": kv4, "v": kv4, "kpos": ("batch", "kv_seq"),
                         "pos": ()}}
    if kind in ("attn", "moe"):
        return {"attn": {"k": kv4, "v": kv4, "pos": ()}}
    if kind == "xdec":
        return {"attn": {"k": kv4, "v": kv4, "pos": ()},
                "ck": ("batch", "enc_seq", "kv", "head_dim"),
                "cv": ("batch", "enc_seq", "kv", "head_dim")}
    if kind == "rglru":
        return {"rec": {"h": ("batch", "rec"), "conv": ("batch", None, "rec")}}
    if kind == "mlstm":
        return {"core": {"C": ("batch", "heads", None, None),
                         "n": ("batch", "heads", None),
                         "m": ("batch", "heads")}}
    if kind == "slstm":
        return {"core": {k: ("batch", "heads", None)
                         for k in ("h", "c", "n", "m")}}
    raise ValueError(kind)


def _layer(tree, i: int):
    """Layer i of a stacked tree: views into the stacked tensors."""
    return _tree_map(lambda t: t[i], tree)


def _unstack(tree, count: int) -> list:
    """The ``count`` layers of a stacked tree, one ``torch.unbind`` a leaf.
    Under autograd an unbind's backward is one ``stack`` of the layers'
    grads, where ``t[i]`` a layer would add ``count`` zero-filled grads of
    the whole stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(count)]
    return torch.unbind(tree, 0)


def _block(remat: bool):
    """``block_apply``, or (``remat``, under autograd) a checkpointed
    ``block_apply`` whose activations are recomputed in the backward pass
    (JAX's ``jax.checkpoint`` with ``nothing_saveable``)."""
    if not (remat and torch.is_grad_enabled()):
        return block_apply

    def checkpointed(*args, **kw):
        # the forward draws nothing: no RNG state to keep
        return torch.utils.checkpoint.checkpoint(
            block_apply, *args, use_reentrant=False,
            preserve_rng_state=False, **kw)
    return checkpointed


def _store_layer(stacked: dict, views: dict, new: dict, i: int) -> None:
    """Write layer i's new cache into the stacked cache tree: a leaf that
    is the view itself was written in place already; another is copied
    into its slot, or (a cross-attention K/V of another length) replaces
    the stacked leaf."""
    for k, leaf in new.items():
        if isinstance(leaf, dict):
            _store_layer(stacked[k], views[k], leaf, i)
        elif leaf is not views[k]:
            if stacked[k].shape[1:] != leaf.shape:
                stacked[k] = leaf.new_zeros((stacked[k].shape[0],)
                                            + tuple(leaf.shape))
            stacked[k][i].copy_(leaf)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclass
class Model:
    """The functional model API. ``device=None`` means the CUDA card and
    raises without one; tests pass ``device="cpu"``."""
    cfg: ModelConfig
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _on(self, x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=self.device)

    # -- parameters ---------------------------------------------------------
    def init_meta(self, generator: torch.Generator | None = None, *,
                  device=None):
        """ParamMeta tree: normals drawn from ``generator`` (on its own
        device, then moved to the model's), shapes, dtypes and logical axes
        as JAX's ``init_meta``. ``device="meta"`` allocates nothing."""
        cfg = self.cfg
        draws = Draws(generator, self.device if device is None else device)
        dt = dtype_of(cfg.param_dtype)
        p = {"embed": layers.embed_init(draws, cfg),
             "final_norm": layers.rmsnorm_init(draws, cfg.d_model, dt),
             "lm_head": layers.logits_init(draws, cfg)}
        if cfg.n_enc_layers:
            enc = [block_init(draws, cfg, "enc")
                   for _ in range(cfg.n_enc_layers)]
            p["encoder"] = _stack_meta(enc)
            p["enc_norm"] = layers.rmsnorm_init(draws, cfg.d_model, dt)
        segs = {}
        for si, (kind, count) in enumerate(cfg.block_pattern):
            ms = [block_init(draws, cfg, kind) for _ in range(count)]
            segs[f"seg{si}_{kind}"] = _stack_meta(ms)
            del ms
        p["segments"] = segs
        return p

    def init(self, generator: torch.Generator | None = None):
        """-> (params tree, logical axes tree). The values are drawn from
        ``generator`` with JAX's distributions; they are not JAX's values
        (carry those across with ``params_from_numpy``)."""
        return split_meta(self.init_meta(generator))

    def abstract_params(self):
        """Shape/axes-only init on the "meta" device (never allocates)."""
        return split_meta(self.init_meta(None, device="meta"))

    # -- forward (training / scoring) ----------------------------------------
    def forward_train(self, params, tokens, *, enc_feats=None,
                      vis_embeds=None):
        """tokens int [B, S] -> (logits fp32 [B, S, V], aux dict). With
        ``cfg.remat == "full"`` and grad enabled, each block is checkpointed
        (its activations recomputed in the backward pass); the values do
        not change."""
        cfg = self.cfg
        tokens = self._on(tokens)
        B, S = tokens.shape
        positions = self._positions(B, S)
        x = layers.embed_apply(params["embed"], cfg, tokens, positions)
        if vis_embeds is not None:  # vision stub: patch embeds replace prefix
            vis = self._on(vis_embeds).to(x.dtype)[:, :S]
            x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
        enc_out = None
        if cfg.n_enc_layers:
            enc_out = self._encode(params, enc_feats)
        aux_total = {}
        x = self._run_segments(params, x, positions, enc_out=enc_out,
                               aux_out=aux_total)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = layers.logits_apply(params["lm_head"], params["embed"], cfg, x)
        return logits, aux_total

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32,
                            device=self.device)[None].expand(B, S)

    def _encode(self, params, enc_feats):
        cfg = self.cfg
        enc_feats = self._on(enc_feats)
        B, T, _ = enc_feats.shape
        pos = self._positions(B, T)
        x = enc_feats.to(dtype_of(cfg.compute_dtype))
        if cfg.learned_pos:
            x = x + params["embed"]["pos"][pos].to(x.dtype)
        block = _block(cfg.remat == "full")
        for p_i in _unstack(params["encoder"], cfg.n_enc_layers):
            x, _, _ = block(p_i, cfg, "enc", x, pos)
        return layers.rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    def _run_segments(self, params, x, positions, *, enc_out=None,
                      caches=None, aux_out=None):
        cfg = self.cfg
        block = _block(cfg.remat == "full")
        for si, (kind, count) in enumerate(cfg.block_pattern):
            name = f"seg{si}_{kind}"
            auxs = {}
            for i, p_i in enumerate(_unstack(params["segments"][name],
                                             count)):
                if caches is None:
                    x, _, aux = block(p_i, cfg, kind, x, positions,
                                      enc_out=enc_out)
                    for k, v in aux.items():
                        auxs.setdefault(k, []).append(v)
                else:
                    c_i = _layer(caches[name], i)
                    x, c2, _ = block_apply(p_i, cfg, kind, x, positions,
                                           cache=c_i, enc_out=enc_out)
                    _store_layer(caches[name], c_i, c2, i)
            if aux_out is not None:
                for k, vs in auxs.items():
                    aux_out[k] = aux_out.get(k, 0.0) + torch.stack(vs).sum()
        if caches is not None:
            return x, caches
        return x

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   enc_len: int | None = None):
        cfg = self.cfg
        enc_len = enc_len if enc_len is not None else cfg.enc_seq
        caches = {}
        for si, (kind, count) in enumerate(cfg.block_pattern):
            one = block_cache_init(cfg, kind, batch, cache_len, enc_len,
                                   self.device)
            caches[f"seg{si}_{kind}"] = _tree_map(
                lambda a: a.expand((count,) + a.shape).clone(), one)
        return caches

    def cache_axes(self):
        """Logical axes for init_cache's tree (leading 'layers' dim)."""
        axes = {}
        for si, (kind, count) in enumerate(self.cfg.block_pattern):
            axes[f"seg{si}_{kind}"] = _tree_map(
                lambda a: ("layers",) + a, block_cache_axes(self.cfg, kind))
        return axes

    def decode_step(self, params, caches, tokens, pos):
        """One token: tokens [B, 1], pos an int or int32 [] (same position
        across the batch). Writes the caller's ``caches`` in place and
        returns (logits [B, 1, V], caches)."""
        cfg = self.cfg
        tokens = self._on(tokens)
        B = tokens.shape[0]
        if isinstance(pos, torch.Tensor):
            pos = pos.to(device=self.device, dtype=torch.int32)
        else:
            pos = torch.full((), int(pos), dtype=torch.int32,
                             device=self.device)
        positions = pos.reshape(1, 1).expand(B, 1)
        x = layers.embed_apply(params["embed"], cfg, tokens, positions)
        # keep every layer's attn cache pos in sync with the global pos
        self._set_cache_pos(caches, pos)
        x, caches = self._run_segments(params, x, positions, caches=caches)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = layers.logits_apply(params["lm_head"], params["embed"], cfg, x)
        return logits, caches

    def _set_cache_pos(self, caches, pos):
        """A segment whose cache has an "attn" entry at its top (not a
        composite's) gets ``pos`` in every layer, as JAX's does."""
        for seg in caches.values():
            if isinstance(seg, dict) and "attn" in seg:
                seg["attn"]["pos"].copy_(pos.expand_as(seg["attn"]["pos"]))
        return caches

    def prefill(self, params, tokens, cache_len: int, *, enc_feats=None):
        """Parallel prefill: one forward pass that both produces logits and
        fills every block's cache/state exactly (attention K/V written in
        parallel; recurrent blocks return their closed-form final state).
        Returns (logits [B, S, V], caches positioned at S)."""
        cfg = self.cfg
        tokens = self._on(tokens)
        B, S = tokens.shape
        caches = self.init_cache(B, cache_len)
        positions = self._positions(B, S)
        x = layers.embed_apply(params["embed"], cfg, tokens, positions)
        enc_out = self._encode(params, enc_feats) if cfg.n_enc_layers else None
        x, new_caches = self._run_segments(params, x, positions,
                                           enc_out=enc_out, caches=caches)
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = layers.logits_apply(params["lm_head"], params["embed"], cfg, x)
        return logits, new_caches


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree, device=None, *, cfg: ModelConfig):
    """JAX's ``model.init(...)[0]``, passed through ``np.asarray`` leaf by
    leaf, -> the port's parameter tree on ``device`` (None = the card).
    Raises ``ValueError`` on a missing or extra key and on a shape or dtype
    other than the port's ``Model(cfg)`` holds."""
    dev = resolve_device(device)
    want, _ = Model(cfg, device="meta").abstract_params()

    def convert(path, node, ref):
        if isinstance(ref, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or '<root>'}: expected a dict")
            missing = sorted(set(ref) - set(node))
            extra = sorted(set(node) - set(ref))
            if missing or extra:
                raise ValueError(f"{path or '<root>'}: missing keys "
                                 f"{missing}, extra keys {extra}")
            return {k: convert(f"{path}/{k}" if path else k, node[k], ref[k])
                    for k in ref}
        t = _from_numpy(np.asarray(node))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(ref.shape)}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{path}: dtype {t.dtype}, expected {ref.dtype}")
        return t.to(dev)

    return convert("", tree, want)
