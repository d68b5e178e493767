"""Serving steps of the LM substrate: prefill (parallel forward filling
caches) and decode (one token against a cache_len cache); greedy_generate
stitches them into a host loop. As the JAX package's ``serve/step.py``,
without ``jax.jit``: each step runs eagerly on the model's device.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.transformer import Model


def make_prefill_step(model: Model, cache_len: int, last_only: bool = True):
    def prefill_step(params, batch):
        """batch: {"tokens": [B, S], optional "enc_feats"} ->
        (logits, caches). last_only=True returns [B, 1, V]: serving only
        needs the next-token distribution."""
        logits, caches = model.prefill(params, batch["tokens"], cache_len,
                                       enc_feats=batch.get("enc_feats"))
        if last_only:
            logits = logits[:, -1:, :]
        return logits, caches
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, caches, tokens, pos):
        """tokens [B, 1], pos int32 [] -> (logits [B, 1, V], caches). The
        caller's caches are written in place."""
        return model.decode_step(params, caches, tokens, pos)
    return decode_step


@torch.no_grad()
def greedy_generate(model: Model, params, prompt, n_new: int,
                    cache_len: int, *, enc_feats=None):
    """Greedy decoding loop: returns the [B, S + n_new] token matrix on
    the model's device (None there means the card: without CUDA this
    raises)."""
    prompt = torch.as_tensor(prompt, device=resolve_device(model.device))
    S = prompt.shape[1]
    prefill = make_prefill_step(model, cache_len, last_only=False)
    decode = make_decode_step(model)
    logits, caches = prefill(params, {"tokens": prompt,
                                      "enc_feats": enc_feats})
    tokens = [prompt]
    last = logits[:, -1:].argmax(-1).to(prompt.dtype)
    for i in range(n_new):
        tokens.append(last)
        if i == n_new - 1:
            break
        logits, caches = decode(params, caches, last, S + i)
        last = logits[:, -1:].argmax(-1).to(prompt.dtype)
    return torch.cat(tokens, dim=1)
